// Pillar segment-max canvas (kernel K2 of the port).
//
// Replaces: gencomm_tpu/ops/pillar_pallas.py `_kernel` / `striped_pillar_canvas`
// (the TPU kernel that one-hot-matmuls stripe-padded row chunks on the MXU).
//
// What it computes: canvas[a, cell, c] = max(0, max over rows r of agent a
// with gid[r] == cell of rows[r, c]), bf16 in and out. Rows arrive sorted by
// gid within each agent (the host decorator's contract); gids above
// ncell - 1 (invalid rows, whose features are zero) are clamped to ncell - 1,
// which keeps the order sorted and makes those rows no-ops for the max.
//
// What bounds it on Hopper: bytes. Per flagship frame it reads ~7.7 MB of
// rows and writes a 33.5 MB canvas, with no arithmetic to speak of.
//
// Design: the canvas is zeroed with one memset. Then one warp owns a chunk
// of CHUNK consecutive rows and walks it once; each lane keeps the running
// max of two channels (bf16x2 loads, so a warp reads a 128-byte row segment
// per step). The chunk splits into pieces at run heads (gid or agent
// changes). A piece that is a whole run -- it starts at a run head and the
// run ends inside the chunk -- is written with a plain store: that cell has
// no other writer. A piece of a run that crosses a chunk boundary is merged
// with a compare-and-swap max on 32-bit bf16 pairs, skipped when it would
// not raise the stored value (so the long run of zeroed invalid rows at the
// end of each agent writes nothing). The max of bf16 values taken in float
// is exact, so the result is bit-equal to the plain scatter. An earlier
// version walked each run with a single warp, which serialized the invalid
// tail (thousands of rows) and took ~100x its bound.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;  // rows per warp

__device__ __forceinline__ int clamp_gid(int g, int ncell) {
    return g < 0 ? 0 : (g >= ncell ? ncell - 1 : g);
}

__device__ __forceinline__ void atomic_max_bf16x2(__nv_bfloat162* addr,
                                                  float m0, float m1) {
    unsigned int* word = reinterpret_cast<unsigned int*>(addr);
    unsigned int old = *reinterpret_cast<volatile unsigned int*>(word);
    while (true) {
        __nv_bfloat162 cur = *reinterpret_cast<__nv_bfloat162*>(&old);
        const float2 c = __bfloat1622float2(cur);
        const float n0 = fmaxf(c.x, m0), n1 = fmaxf(c.y, m1);
        if (n0 == c.x && n1 == c.y) return;  // nothing to raise
        __nv_bfloat162 nv = __floats2bfloat162_rn(n0, n1);
        const unsigned int assumed = old;
        old = atomicCAS(word, assumed, *reinterpret_cast<unsigned int*>(&nv));
        if (old == assumed) return;
    }
}

__global__ void pillar_canvas_kernel(const __nv_bfloat16* __restrict__ rows,
                                     const int32_t* __restrict__ gids,
                                     __nv_bfloat16* __restrict__ out,
                                     int64_t n_rows, int64_t rows_per_agent,
                                     int ncell, int channels) {
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t begin = warp * CHUNK;
    if (begin >= n_rows) return;
    const int64_t end = min(begin + CHUNK, n_rows);
    const int pairs = channels >> 1;

    // one pass per group of 32 channel pairs (one for 64 channels)
    for (int cp = lane; cp - lane < pairs; cp += 32) {
        const bool active = cp < pairs;
        int64_t r = begin;
        while (r < end) {
            const int64_t agent = r / rows_per_agent;
            const int64_t agent_end = (agent + 1) * rows_per_agent;
            const int g = clamp_gid(gids[r], ncell);
            const bool head = (r == agent * rows_per_agent) ||
                              clamp_gid(gids[r - 1], ncell) != g;
            // piece: rows r .. p-1 of this run inside the chunk
            int64_t p = r + 1;
            const int64_t stop = min(end, agent_end);
            while (p < stop && clamp_gid(gids[p], ncell) == g) ++p;
            const bool run_ends = p == agent_end || p == n_rows ||
                                  clamp_gid(gids[p], ncell) != g;
            if (active) {
                float m0 = 0.0f, m1 = 0.0f;
                for (int64_t q = r; q < p; ++q) {
                    const float2 v = __bfloat1622float2(
                        reinterpret_cast<const __nv_bfloat162*>(rows + q * channels)[cp]);
                    m0 = fmaxf(m0, v.x);
                    m1 = fmaxf(m1, v.y);
                }
                __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
                    out + (agent * ncell + g) * channels) + cp;
                if (head && run_ends) {
                    *dst = __floats2bfloat162_rn(m0, m1);
                } else {
                    atomic_max_bf16x2(dst, m0, m1);
                }
            }
            r = p;
        }
    }
}

}  // namespace

extern "C" int pillar_canvas_bf16(const void* rows, const void* gids, void* out,
                                  long long n_rows, long long rows_per_agent,
                                  int n_agents, int ncell, int channels,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t canvas_bytes =
        (size_t)n_agents * (size_t)ncell * (size_t)channels * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(out, 0, canvas_bytes, s);
    if (err != cudaSuccess) return (int)err;
    if (n_rows > 0) {
        const int threads = 256;
        const long long warps = (n_rows + CHUNK - 1) / CHUNK;
        const long long blocks = (warps * 32 + threads - 1) / threads;
        pillar_canvas_kernel<<<(unsigned)blocks, threads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(rows),
            static_cast<const int32_t*>(gids),
            static_cast<__nv_bfloat16*>(out), n_rows, rows_per_agent, ncell,
            channels);
    }
    return (int)cudaGetLastError();
}

// Pillar segment-max canvas, backward for the rows (kernel K2b of the port).
//
// Replaces: the VJP that JAX derives for the training canvas,
// `canvas.at[flat_gids].max(rows)` on a zero bf16 canvas
// (gencomm_tpu/models/encoders/point_pillar.py:188-189; training never takes
// the Pallas canvas of ops/pillar_pallas.py), i.e. XLA autodiff through
// jax._src.lax.slicing._scatter_extremal_jvp.
//
// What it computes, for row r of cell (agent, gid) and channel c, with
// m = canvas[cell, c] (the forward's max) and g = gout[cell, c]:
//   tied   = rows[r, c] == m
//   n      = number of tied rows of the cell, plus 1 when m == 0 (the zero
//            canvas init also holds the max); counted in bf16 as JAX counts
//            it, where 256 + 1 rounds back to 256, so n = min(n, 256)
//   drows[r, c] = bf16(g * (tied ? bf16(1 / n) : 0))   (so -0 where g < 0)
// Bit-exact against the plain version: the count is exact, 1/n is rounded
// once to fp32 and once to bf16, and the product of two bf16 values is exact
// in fp32 before its one rounding to bf16.
//
// What bounds it on Hopper: bytes. It reads the rows and writes their
// gradient (2 x 15.4 MB at the flagship training step, 4 agent slots of
// 30,000 rows x 64 channels), plus the max and cotangent of each occupied
// cell (128 bytes each); the arithmetic is a compare and a multiply.
//
// Design: the rows are sorted by gid within each agent (K2's contract). As
// in K2, one warp owns a chunk of CHUNK consecutive rows, each lane a bf16
// channel pair, and the chunk splits into pieces at run heads. A piece that
// is a whole run counts its ties and writes its rows at once (no atomics).
// A run that crosses a chunk boundary -- chiefly the long run of zeroed
// invalid rows at the end of each agent -- is counted piecewise: each piece
// adds its count into the slot of the chunk that holds the run's head
// (found by binary search), and a second kernel, walking the same pieces,
// writes those rows from the finished count. Every row is written once, by
// one of the two kernels.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;  // rows per warp; the wrapper sizes the slots by it

__device__ __forceinline__ int clamp_gid(int g, int ncell) {
    return g < 0 ? 0 : (g >= ncell ? ncell - 1 : g);
}

// first row of [lo, hi) whose clamped gid is g (gids sorted within [lo, hi))
__device__ __forceinline__ int64_t run_head(const int32_t* __restrict__ gids,
                                            int64_t lo, int64_t hi, int g,
                                            int ncell) {
    while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (clamp_gid(gids[mid], ncell) < g) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ float share(float count, float max_value) {
    // JAX: select(retained, 1 / (n + 1), 1 / n) in bf16, n saturating at 256
    float n = count + (max_value == 0.0f ? 1.0f : 0.0f);
    n = fminf(n, 256.0f);
    return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(1.0f, n)));
}

__device__ __forceinline__ void write_rows(const __nv_bfloat16* __restrict__ rows,
                                           __nv_bfloat16* __restrict__ drows,
                                           int64_t r, int64_t p, int cp,
                                           int channels, float2 m, float2 g,
                                           float n0, float n1) {
    const float s0 = share(n0, m.x), s1 = share(n1, m.y);
    // tied rows get g * share; the others g * 0, a zero with g's sign
    const float t0 = __fmul_rn(g.x, s0), t1 = __fmul_rn(g.y, s1);
    const float z0 = __fmul_rn(g.x, 0.0f), z1 = __fmul_rn(g.y, 0.0f);
    for (int64_t q = r; q < p; ++q) {
        const float2 v = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(rows + q * channels)[cp]);
        reinterpret_cast<__nv_bfloat162*>(drows + q * channels)[cp] =
            __floats2bfloat162_rn(v.x == m.x ? t0 : z0, v.y == m.y ? t1 : z1);
    }
}

// FINISH = false: count every piece; write whole runs; add split runs'
// counts into their slots. FINISH = true: write the pieces of split runs.
template <bool FINISH>
__global__ void pillar_canvas_bwd_kernel(const __nv_bfloat16* __restrict__ rows,
                                         const int32_t* __restrict__ gids,
                                         const __nv_bfloat16* __restrict__ canvas,
                                         const __nv_bfloat16* __restrict__ gout,
                                         __nv_bfloat16* __restrict__ drows,
                                         int* __restrict__ counts,
                                         int64_t n_rows, int64_t rows_per_agent,
                                         int ncell, int channels) {
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t begin = warp * CHUNK;
    if (begin >= n_rows) return;
    const int64_t end = min(begin + CHUNK, n_rows);
    const int pairs = channels >> 1;

    for (int cp = lane; cp - lane < pairs; cp += 32) {
        const bool active = cp < pairs;
        int64_t r = begin;
        while (r < end) {
            const int64_t agent = r / rows_per_agent;
            const int64_t agent_start = agent * rows_per_agent;
            const int64_t agent_end = agent_start + rows_per_agent;
            const int g = clamp_gid(gids[r], ncell);
            const bool head = r == agent_start ||
                              clamp_gid(gids[r - 1], ncell) != g;
            int64_t p = r + 1;
            const int64_t stop = min(end, agent_end);
            while (p < stop && clamp_gid(gids[p], ncell) == g) ++p;
            const bool run_ends = p == agent_end || p == n_rows ||
                                  clamp_gid(gids[p], ncell) != g;
            const bool whole = head && run_ends;
            if (active && (!FINISH || !whole)) {
                const int64_t cell = (agent * ncell + g) * channels;
                const float2 m = __bfloat1622float2(
                    reinterpret_cast<const __nv_bfloat162*>(canvas + cell)[cp]);
                const float2 gv = __bfloat1622float2(
                    reinterpret_cast<const __nv_bfloat162*>(gout + cell)[cp]);
                if (!FINISH) {
                    int n0 = 0, n1 = 0;
                    for (int64_t q = r; q < p; ++q) {
                        const float2 v = __bfloat1622float2(
                            reinterpret_cast<const __nv_bfloat162*>(rows + q * channels)[cp]);
                        n0 += v.x == m.x;
                        n1 += v.y == m.y;
                    }
                    if (whole) {
                        write_rows(rows, drows, r, p, cp, channels, m, gv,
                                   (float)n0, (float)n1);
                    } else {
                        const int64_t slot =
                            (head ? r : run_head(gids, agent_start, r, g, ncell)) / CHUNK;
                        if (n0) atomicAdd(counts + slot * channels + 2 * cp, n0);
                        if (n1) atomicAdd(counts + slot * channels + 2 * cp + 1, n1);
                    }
                } else {
                    const int64_t slot =
                        (head ? r : run_head(gids, agent_start, r, g, ncell)) / CHUNK;
                    write_rows(rows, drows, r, p, cp, channels, m, gv,
                               (float)counts[slot * channels + 2 * cp],
                               (float)counts[slot * channels + 2 * cp + 1]);
                }
            }
            r = p;
        }
    }
}

}  // namespace

extern "C" int pillar_canvas_bwd_bf16(const void* rows, const void* gids,
                                      const void* canvas, const void* gout,
                                      void* drows, void* counts,
                                      long long n_rows, long long rows_per_agent,
                                      int ncell, int channels, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_rows <= 0) return (int)cudaGetLastError();
    const long long chunks = (n_rows + CHUNK - 1) / CHUNK;
    cudaError_t err = cudaMemsetAsync(counts, 0, (size_t)chunks * channels * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    const long long blocks = (chunks * 32 + threads - 1) / threads;
    const auto* r = static_cast<const __nv_bfloat16*>(rows);
    const auto* gi = static_cast<const int32_t*>(gids);
    const auto* cv = static_cast<const __nv_bfloat16*>(canvas);
    const auto* go = static_cast<const __nv_bfloat16*>(gout);
    auto* dr = static_cast<__nv_bfloat16*>(drows);
    auto* cn = static_cast<int*>(counts);
    pillar_canvas_bwd_kernel<false><<<(unsigned)blocks, threads, 0, s>>>(
        r, gi, cv, go, dr, cn, n_rows, rows_per_agent, ncell, channels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pillar_canvas_bwd_kernel<true><<<(unsigned)blocks, threads, 0, s>>>(
        r, gi, cv, go, dr, cn, n_rows, rows_per_agent, ncell, channels);
    return (int)cudaGetLastError();
}

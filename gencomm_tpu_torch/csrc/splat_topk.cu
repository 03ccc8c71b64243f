// Top-K categorical-depth splat onto a flat BEV canvas (kernel K4 of the port).
//
// Replaces: gencomm_tpu/ops/splat_pallas.py `_splat_kernel`, driven by
// `_splat_fwd_impl` / `splat_topk` (the TPU kernel that multiplies a (T, R)
// one-hot cell-membership matrix with stripe-padded update rows on the MXU).
//
// What it computes: canvas[c, :] = sum over the (pixel p, depth k) pairs with
// ids[p, k] == c of dvals[p, k] * feats[p, :], fp32. With bf16_rows each
// product dvals * feats is rounded to bf16 (round to nearest even) before the
// fp32 sum. Cells that receive nothing are 0.
//
// What the wrapper prepares (index work only): `sids`, the flat (M = P * K)
// ids sorted ascending with every dropped id replaced by num_cells, so the
// dropped rows are the tail of the order, and `order`, the flat row index
// r = p * K + k of each sorted position (a stable sort, so equal ids keep
// their row order). Everything else happens here: the gather of
// feats[r / K], the product, the rounding, the sum over a cell's rows and
// the zeroing of empty cells.
//
// What bounds it on Hopper: bytes. At the camera model's eval shapes it reads
// 12.6 MB of features and 3 x 0.8 MB of weights and indices and writes a
// 67 MB canvas; the 50 MFLOP of products are nothing beside that.
//
// Design: the canvas is zeroed with one memset. The first kernel gives each
// warp a chunk of CHUNK consecutive sorted rows; lane l owns channels
// 4l .. 4l+3 (one float4 of a 128-channel row, so a warp reads one 512-byte
// feature row per step) and sums the rows of each run of equal ids in sorted
// order. A run that lies inside the chunk is stored straight to its cell,
// which has no other writer. A run that crosses a chunk boundary is cut into
// pieces: the piece that holds the run's head goes to `trail[chunk]`, every
// later piece to `lead[chunk]`. The second kernel gives each chunk whose last
// run continues one warp that adds trail[chunk] and the lead pieces of the
// following chunks, in chunk order, and stores the cell. So every cell is
// summed in one fixed order and the result is the same on every run; long runs
// (the cells just in front of a camera collect hundreds of rows) are spread
// over many warps, and the tail of dropped rows is skipped, not summed.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;  // sorted rows per warp
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// acc += w * f without contraction into an FMA: the plain version multiplies,
// rounds, then adds
template <bool BF16>
__device__ __forceinline__ void add_row(float4& acc, float w, const float4 f) {
    float x = __fmul_rn(w, f.x), y = __fmul_rn(w, f.y);
    float z = __fmul_rn(w, f.z), t = __fmul_rn(w, f.w);
    if (BF16) {
        x = round_bf16(x); y = round_bf16(y);
        z = round_bf16(z); t = round_bf16(t);
    }
    acc.x = __fadd_rn(acc.x, x); acc.y = __fadd_rn(acc.y, y);
    acc.z = __fadd_rn(acc.z, z); acc.w = __fadd_rn(acc.w, t);
}

template <bool BF16>
__global__ void splat_pieces_kernel(const float* __restrict__ dvals,
                                    const float* __restrict__ feats,
                                    const int32_t* __restrict__ sids,
                                    const int32_t* __restrict__ order,
                                    float* __restrict__ canvas,
                                    float* __restrict__ lead,
                                    float* __restrict__ trail,
                                    int64_t m, int k, int channels,
                                    int num_cells) {
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t begin = warp * CHUNK;
    if (begin >= m) return;
    const int n = (int)min((int64_t)CHUNK, m - begin);

    // lane j holds row j of the chunk: its cell, its flat row and its weight
    int my_id = num_cells, my_row = 0;
    float my_w = 0.0f;
    if (lane < n) {
        my_id = sids[begin + lane];
        my_row = order[begin + lane];
        if (my_id != num_cells) my_w = dvals[my_row];
    }
    if (__shfl_sync(FULL, my_id, 0) == num_cells) return;  // all dropped
    const int prev_id = begin > 0 ? sids[begin - 1] : -1;
    const int next_id = begin + n < m ? sids[begin + n] : -1;

    const int vec = channels >> 2;
    const float4* feats4 = reinterpret_cast<const float4*>(feats);
    for (int c4 = lane; c4 - lane < vec; c4 += 32) {
        const bool active = c4 < vec;
        int j = 0;
        while (j < n) {
            const int g = __shfl_sync(FULL, my_id, j);
            if (g == num_cells) break;  // the dropped tail
            const int start = j;
            float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            do {
                const int row = __shfl_sync(FULL, my_row, j);
                const float w = __shfl_sync(FULL, my_w, j);
                if (active) {
                    add_row<BF16>(acc, w,
                                  feats4[(int64_t)(row / k) * vec + c4]);
                }
                ++j;
            } while (j < n && __shfl_sync(FULL, my_id, j) == g);
            const bool head = start > 0 || prev_id != g;
            const bool ends = j < n || next_id != g;
            if (active) {
                float* dst = head && ends ? canvas + (int64_t)g * channels
                           : (head ? trail : lead) + warp * channels;
                reinterpret_cast<float4*>(dst)[c4] = acc;
            }
        }
    }
}

__global__ void splat_merge_kernel(const int32_t* __restrict__ sids,
                                   float* __restrict__ canvas,
                                   const float* __restrict__ lead,
                                   const float* __restrict__ trail,
                                   int64_t m, int channels, int num_cells) {
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t begin = warp * CHUNK;
    const int64_t end = begin + CHUNK;
    if (end >= m) return;  // no later chunk for a run to continue into
    const int g = sids[end - 1];
    if (g == num_cells || sids[end] != g) return;  // dropped, or it ends here
    // the run's head lies in an earlier chunk: that chunk's warp merges it
    if (begin > 0 && sids[begin] == g && sids[begin - 1] == g) return;

    const int vec = channels >> 2;
    const float4* lead4 = reinterpret_cast<const float4*>(lead);
    for (int c4 = lane; c4 < vec; c4 += 32) {
        float4 acc = reinterpret_cast<const float4*>(trail)[warp * vec + c4];
        for (int64_t c2 = warp + 1; c2 * CHUNK < m && sids[c2 * CHUNK] == g;
             ++c2) {
            const float4 v = lead4[c2 * vec + c4];
            acc.x = __fadd_rn(acc.x, v.x); acc.y = __fadd_rn(acc.y, v.y);
            acc.z = __fadd_rn(acc.z, v.z); acc.w = __fadd_rn(acc.w, v.w);
        }
        reinterpret_cast<float4*>(canvas + (int64_t)g * channels)[c4] = acc;
    }
}

}  // namespace

// dvals (M,), feats (P, channels), sids / order (M,), canvas (num_cells,
// channels), lead / trail (ceil(M / 32), channels) scratch; channels % 4 == 0.
extern "C" int splat_topk_f32(const void* dvals, const void* feats,
                              const void* sids, const void* order,
                              void* canvas, void* lead, void* trail,
                              long long m, int k, int channels, int num_cells,
                              int bf16_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err = cudaMemsetAsync(
        canvas, 0, (size_t)num_cells * (size_t)channels * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    if (m > 0) {
        const int threads = 256;
        const long long warps = (m + CHUNK - 1) / CHUNK;
        const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
        const float* d = static_cast<const float*>(dvals);
        const float* f = static_cast<const float*>(feats);
        const int32_t* si = static_cast<const int32_t*>(sids);
        const int32_t* od = static_cast<const int32_t*>(order);
        float* cv = static_cast<float*>(canvas);
        float* ld = static_cast<float*>(lead);
        float* tr = static_cast<float*>(trail);
        if (bf16_rows) {
            splat_pieces_kernel<true><<<blocks, threads, 0, s>>>(
                d, f, si, od, cv, ld, tr, m, k, channels, num_cells);
        } else {
            splat_pieces_kernel<false><<<blocks, threads, 0, s>>>(
                d, f, si, od, cv, ld, tr, m, k, channels, num_cells);
        }
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        splat_merge_kernel<<<blocks, threads, 0, s>>>(si, cv, ld, tr, m,
                                                      channels, num_cells);
    }
    return (int)cudaGetLastError();
}

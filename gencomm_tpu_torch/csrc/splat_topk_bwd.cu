// Backward of the top-K depth splat (kernel K4b of the port).
//
// Replaces: the gather VJP of gencomm_tpu/ops/splat_pallas.py `_splat_bwd`
// (there plain XLA gathers and einsums; the TPU kernel has no backward
// kernel of its own).
//
// What it computes, from the canvas cotangent g (num_cells, C):
//   d_dvals[p, k] = feats[p, :] . g[ids[p, k], :]
//   d_feats[p, :] = sum over k of dvals[p, k] * g[ids[p, k], :]
// with a dropped id (outside [0, num_cells)) contributing 0. The ids get no
// gradient, and the forward's optional bf16 rounding of the rows is ignored
// (straight-through), as in the JAX VJP.
//
// What bounds it on Hopper: bytes. It reads the K cotangent rows of every
// pixel (the rows of the touched cells once from device memory, again from
// L2 where pixels share a cell), the features, weights and ids once, and
// writes both gradients once.
//
// Design: one warp per pixel, no atomics, so the result is the same on every
// run. Lane l owns channels 4l .. 4l+3 (one float4 of a row of at most 128
// channels, the width every configuration of the model uses), held in
// registers; for each k the warp gathers one cotangent row, reduces the dot
// product with shuffles and adds the weighted row into the pixel's feature
// gradient.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CHANNELS = 128;  // one float4 per lane
constexpr unsigned FULL = 0xffffffffu;

__global__ void splat_topk_bwd_kernel(const float* __restrict__ dvals,
                                      const float* __restrict__ feats,
                                      const int32_t* __restrict__ ids,
                                      const float* __restrict__ gout,
                                      float* __restrict__ d_dvals,
                                      float* __restrict__ d_feats,
                                      int64_t p, int k, int channels,
                                      int num_cells) {
    const int64_t pix = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (pix >= p) return;
    const int vec = channels >> 2;
    const bool active = lane < vec;
    const float4* gout4 = reinterpret_cast<const float4*>(gout);

    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float4 f = active
        ? reinterpret_cast<const float4*>(feats)[pix * vec + lane] : zero;
    float4 acc = zero;
    for (int kk = 0; kk < k; ++kk) {
        const int id = ids[pix * k + kk];
        const float w = dvals[pix * k + kk];
        float dot = 0.0f;
        if (active && (unsigned)id < (unsigned)num_cells) {
            const float4 g = gout4[(int64_t)id * vec + lane];
            dot = f.x * g.x + f.y * g.y + f.z * g.z + f.w * g.w;
            acc.x += w * g.x; acc.y += w * g.y;
            acc.z += w * g.z; acc.w += w * g.w;
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1) dot += __shfl_xor_sync(FULL, dot, s);
        if (lane == 0) d_dvals[pix * k + kk] = dot;
    }
    if (active) reinterpret_cast<float4*>(d_feats)[pix * vec + lane] = acc;
}

}  // namespace

// dvals / ids / d_dvals (P, K), feats / d_feats (P, channels), gout
// (num_cells, channels); channels % 4 == 0 and channels <= 128.
extern "C" int splat_topk_bwd_f32(const void* dvals, const void* feats,
                                  const void* ids, const void* gout,
                                  void* d_dvals, void* d_feats, long long p,
                                  int k, int channels, int num_cells,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (channels % 4 != 0 || channels > MAX_CHANNELS)
        return (int)cudaErrorInvalidValue;
    if (p > 0) {
        const int threads = 256;
        const unsigned blocks = (unsigned)((p * 32 + threads - 1) / threads);
        splat_topk_bwd_kernel<<<blocks, threads, 0, s>>>(
            static_cast<const float*>(dvals), static_cast<const float*>(feats),
            static_cast<const int32_t*>(ids), static_cast<const float*>(gout),
            static_cast<float*>(d_dvals), static_cast<float*>(d_feats), p, k,
            channels, num_cells);
    }
    return (int)cudaGetLastError();
}

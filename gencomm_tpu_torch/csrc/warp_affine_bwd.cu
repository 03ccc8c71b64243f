// Exact bilinear affine BEV warp, NHWC, backward for the source (kernel K3b
// of the port).
//
// Replaces: the VJP of gencomm_tpu/ops/warp_pallas.py `warp_affine_mxu`
// (l.122-132), which differentiates the gather formulation of
// gencomm_tpu/ops/warp.py with XLA autodiff (a scatter-add); the JAX
// training path warps with that gather directly. theta gets no gradient.
//
// What it computes: dsrc[n, iy, ix, :] = sum over output pixels (yo, xo) and
// their in-map corners (iy, ix) of w * g[n, yo, xo, :], with the same
// sampling coordinates and bilinear weights as the forward (K3).
//
// What bounds it on Hopper: bytes. At the flagship training step (N=4,
// 64 x 128 x 128, fp32) it reads a 16.8 MB cotangent and writes a 16.8 MB
// gradient; a few FMAs per value.
//
// Design: dsrc is zeroed with one memset. One thread per (output pixel,
// 4-channel vector) recomputes the coordinate exactly as K3 does (the
// non-contracting intrinsics, so the corner weights are bit-equal to the
// forward's and to the plain version's) and adds w * g into the 4 corners
// with atomics (float4 atomics on sm_90: one per corner and vector).
// Neighbouring threads hold neighbouring channels of one pixel, so each
// corner's atomics cover one contiguous row segment. The order of the
// atomic sums varies from run to run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<4> { using T = float4; };
template <>
struct Vec<1> { using T = float; };

__device__ __forceinline__ void add_scaled(float4* dst, float w, float4 v) {
    atomicAdd(dst, make_float4(w * v.x, w * v.y, w * v.z, w * v.w));
}
__device__ __forceinline__ void add_scaled(float* dst, float w, float v) {
    atomicAdd(dst, w * v);
}

template <int VEC>
__global__ void warp_affine_bwd_kernel(const float* __restrict__ g,
                                       const float* __restrict__ theta,
                                       float* __restrict__ dsrc, int n, int h,
                                       int w, int channels) {
    using T = typename Vec<VEC>::T;
    const int nvec = channels / VEC;
    const int64_t total = (int64_t)n * h * w * nvec;
    const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int cv = (int)(idx % nvec);
    const int64_t pix = idx / nvec;
    const int xo = (int)(pix % w);
    const int yo = (int)((pix / w) % h);
    const int b = (int)(pix / ((int64_t)w * h));

    // the coordinate, rounded step by step exactly as in K3
    const float* th = theta + b * 6;
    const float fw = (float)w, fh = (float)h;
    const float gx = __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * xo, 1.0f), fw), 1.0f);
    const float gy = __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * yo, 1.0f), fh), 1.0f);
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(th[0], gx), __fmul_rn(th[1], gy)), th[2]);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(th[3], gx), __fmul_rn(th[4], gy)), th[5]);
    const float x = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(sx, 1.0f), fw), 2.0f), 0.5f);
    const float y = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(sy, 1.0f), fh), 2.0f), 0.5f);

    const float x0 = floorf(x), y0 = floorf(y);
    const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
    const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
    const int ix0 = (int)x0, iy0 = (int)y0;

    const T gv = reinterpret_cast<const T*>(g)[idx];
    T* base = reinterpret_cast<T*>(dsrc) + (int64_t)b * h * w * nvec + cv;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int ix = ix0 + (k & 1);
        const int iy = iy0 + (k >> 1);
        if (ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1) continue;
        const float wt = __fmul_rn((k & 1) ? wx1 : wx0, (k >> 1) ? wy1 : wy0);
        add_scaled(base + ((int64_t)iy * w + ix) * nvec, wt, gv);
    }
}

}  // namespace

extern "C" int warp_affine_bwd_f32(const void* g, const void* theta, void* dsrc,
                                   int n, int h, int w, int channels,
                                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t bytes = (size_t)n * h * w * channels * sizeof(float);
    cudaError_t err = cudaMemsetAsync(dsrc, 0, bytes, s);
    if (err != cudaSuccess) return (int)err;
    const int threads = 256;
    if (channels % 4 == 0) {
        const long long total = (long long)n * h * w * (channels / 4);
        if (total > 0)
            warp_affine_bwd_kernel<4><<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
                static_cast<const float*>(g), static_cast<const float*>(theta),
                static_cast<float*>(dsrc), n, h, w, channels);
    } else {
        const long long total = (long long)n * h * w * channels;
        if (total > 0)
            warp_affine_bwd_kernel<1><<<(unsigned)((total + threads - 1) / threads), threads, 0, s>>>(
                static_cast<const float*>(g), static_cast<const float*>(theta),
                static_cast<float*>(dsrc), n, h, w, channels);
    }
    return (int)cudaGetLastError();
}

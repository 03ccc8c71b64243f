// Exact bilinear affine BEV warp, NHWC, forward (kernel K3 of the port).
//
// Replaces: gencomm_tpu/ops/warp_pallas.py `_warp_kernel` /
// `warp_affine_mxu` (the TPU kernel that builds one-hot triangle-weight
// matrices and contracts them on the MXU because the TPU has no fast gather).
//
// What it computes: torch `affine_grid` (align_corners=False) followed by
// bilinear sampling with zero padding, output H x W equal to the input's.
// out[n, yo, xo, :] = sum over the 4 corners of w * src[n, iy, ix, :].
//
// What bounds it on Hopper: bytes. At the flagship (N=2, 64 x 128 x 128,
// fp32) it reads 8.4 MB and writes 8.4 MB; the arithmetic per output value
// is a handful of FMAs.
//
// Design: Hopper gathers well, so no one-hot matrices. One thread per
// (output pixel, 4-channel vector): it computes the source coordinate from
// theta in fp32 (never rounded to a pixel), reads the 4 corners as float4
// (neighbouring threads read neighbouring channels, so every corner read is
// a coalesced row segment) and blends them. The coordinate arithmetic uses
// the non-contracting intrinsics so that it rounds exactly like the plain
// PyTorch version beside it.
//
// bf16 instantiation (`warp_affine_bf16`, for `half`): the TPU kernel takes
// a bf16 map and returns bf16 with fp32 accumulation (warp_pallas.py:71-82).
// The same coordinate chain, bit for bit; a thread loads 8 bf16 channels of
// a corner as one 16-byte vector, blends them in fp32 and rounds once to
// bf16. Bound by bytes: half of the fp32 kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// the storage type of VEC channels of element type E, and their fp32 blend
template <typename E, int VEC>
struct Vec;
template <>
struct Vec<float, 4> {
    using T = float4;
    using Acc = float4;
};
template <>
struct Vec<float, 1> {
    using T = float;
    using Acc = float;
};
template <>
struct Vec<__nv_bfloat16, 8> {
    using T = uint4;  // 8 bf16
    struct Acc { float v[8]; };
};
template <>
struct Vec<__nv_bfloat16, 1> {
    using T = __nv_bfloat16;
    using Acc = float;
};

__device__ __forceinline__ float4 axpy(float w, float4 v, float4 acc) {
    acc.x += w * v.x; acc.y += w * v.y; acc.z += w * v.z; acc.w += w * v.w;
    return acc;
}
__device__ __forceinline__ float axpy(float w, float v, float acc) {
    return acc + w * v;
}
__device__ __forceinline__ float axpy(float w, __nv_bfloat16 v, float acc) {
    return acc + w * __bfloat162float(v);
}
template <typename A>
__device__ __forceinline__ A axpy(float w, uint4 v, A acc) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p[i]);
        acc.v[2 * i] += w * f.x;
        acc.v[2 * i + 1] += w * f.y;
    }
    return acc;
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ Vec<__nv_bfloat16, 8>::Acc
zero<Vec<__nv_bfloat16, 8>::Acc>() {
    return {};
}

// the fp32 blend rounded once to bf16
__device__ __forceinline__ __nv_bfloat16 to_bf16(float a) {
    return __float2bfloat16_rn(a);
}
__device__ __forceinline__ uint4 to_bf16(const Vec<__nv_bfloat16, 8>::Acc& a) {
    uint4 r;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = __floats2bfloat162_rn(a.v[2 * i], a.v[2 * i + 1]);
    return r;
}

template <typename E, int VEC>
__global__ void warp_affine_kernel(const E* __restrict__ src,
                                   const float* __restrict__ theta,
                                   E* __restrict__ out, int n, int h, int w,
                                   int channels) {
    using T = typename Vec<E, VEC>::T;
    using Acc = typename Vec<E, VEC>::Acc;
    const int nvec = channels / VEC;
    const int64_t total = (int64_t)n * h * w * nvec;
    const int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (idx >= total) return;
    const int cv = (int)(idx % nvec);
    const int64_t pix = idx / nvec;
    const int xo = (int)(pix % w);
    const int yo = (int)((pix / w) % h);
    const int b = (int)(pix / ((int64_t)w * h));

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

    const T* base = reinterpret_cast<const T*>(src) + (int64_t)b * h * w * nvec + cv;
    Acc acc = zero<Acc>();
    // corner order (x0,y0), (x1,y0), (x0,y1), (x1,y1), as in the plain version
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int ix = ix0 + (k & 1);
        const int iy = iy0 + (k >> 1);
        if (ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1) continue;
        const float wt = __fmul_rn((k & 1) ? wx1 : wx0, (k >> 1) ? wy1 : wy0);
        acc = axpy(wt, base[((int64_t)iy * w + ix) * nvec], acc);
    }
    if constexpr (sizeof(E) == 4)
        reinterpret_cast<T*>(out)[idx] = acc;
    else
        reinterpret_cast<T*>(out)[idx] = to_bf16(acc);
}

template <typename E, int VEC>
void launch(const void* src, const void* theta, void* out, int n, int h, int w,
            int channels, cudaStream_t s) {
    const int threads = 256;
    const long long total = (long long)n * h * w * (channels / VEC);
    if (total > 0)
        warp_affine_kernel<E, VEC><<<(unsigned)((total + threads - 1) / threads), threads,
                                     0, s>>>(static_cast<const E*>(src),
                                             static_cast<const float*>(theta),
                                             static_cast<E*>(out), n, h, w, channels);
}

// 16-byte vectors need 16-byte aligned rows
bool aligned16(const void* a, const void* b) {
    return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

}  // namespace

extern "C" int warp_affine_f32(const void* src, const void* theta, void* out,
                               int n, int h, int w, int channels, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (channels % 4 == 0 && aligned16(src, out))
        launch<float, 4>(src, theta, out, n, h, w, channels, s);
    else
        launch<float, 1>(src, theta, out, n, h, w, channels, s);
    return (int)cudaGetLastError();
}

extern "C" int warp_affine_bf16(const void* src, const void* theta, void* out,
                                int n, int h, int w, int channels, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (channels % 8 == 0 && aligned16(src, out))
        launch<__nv_bfloat16, 8>(src, theta, out, n, h, w, channels, s);
    else
        launch<__nv_bfloat16, 1>(src, theta, out, n, h, w, channels, s);
    return (int)cudaGetLastError();
}

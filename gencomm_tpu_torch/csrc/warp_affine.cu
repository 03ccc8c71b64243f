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
// The same coordinate chain and blend, bit for bit, rounded once to bf16;
// bound by bytes, half of the fp32 kernel's. With 8-channel vectors it runs
// the row kernel (`warp_affine_bf16_rows_kernel`): a block per run of 16
// output pixels of a row (no index divisions), the chain once a pixel,
// shuffled to the pixel's eight lanes, each of which has its four corners'
// 16-byte loads of up to two vectors in flight at once. The one-thread-a-
// vector kernel ran the chain and five 64-bit divisions per vector, with
// four loads in flight a thread.

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

// the source coordinate of output pixel (xo, yo) under theta (6 floats):
// its floor corner and bilinear factors, in the plain version's rounding
struct Sample {
    int ix0, iy0;
    float wx0, wx1, wy0, wy1;
    // the weight of corner k: (x0,y0), (x1,y0), (x0,y1), (x1,y1)
    __device__ __forceinline__ float weight(int k) const {
        return __fmul_rn((k & 1) ? wx1 : wx0, (k >> 1) ? wy1 : wy0);
    }
};

__device__ __forceinline__ Sample sample_at(const float* __restrict__ th, int xo, int yo,
                                            int w, int h) {
    const float fw = (float)w, fh = (float)h;
    const float gx = __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * xo, 1.0f), fw), 1.0f);
    const float gy = __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * yo, 1.0f), fh), 1.0f);
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(th[0], gx), __fmul_rn(th[1], gy)), th[2]);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(th[3], gx), __fmul_rn(th[4], gy)), th[5]);
    const float x = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(sx, 1.0f), fw), 2.0f), 0.5f);
    const float y = __fsub_rn(__fdiv_rn(__fmul_rn(__fadd_rn(sy, 1.0f), fh), 2.0f), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    Sample sm;
    sm.wx1 = __fsub_rn(x, x0);
    sm.wy1 = __fsub_rn(y, y0);
    sm.wx0 = __fsub_rn(1.0f, sm.wx1);
    sm.wy0 = __fsub_rn(1.0f, sm.wy1);
    sm.ix0 = (int)x0;
    sm.iy0 = (int)y0;
    return sm;
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

    const Sample sm = sample_at(theta + b * 6, xo, yo, w, h);
    const T* base = reinterpret_cast<const T*>(src) + (int64_t)b * h * w * nvec + cv;
    Acc acc = zero<Acc>();
    // corner order (x0,y0), (x1,y0), (x0,y1), (x1,y1), as in the plain version
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int ix = sm.ix0 + (k & 1);
        const int iy = sm.iy0 + (k >> 1);
        if (ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1) continue;
        acc = axpy(sm.weight(k), base[((int64_t)iy * w + ix) * nvec], acc);
    }
    if constexpr (sizeof(E) == 4)
        reinterpret_cast<T*>(out)[idx] = acc;
    else
        reinterpret_cast<T*>(out)[idx] = to_bf16(acc);
}

// bf16 maps with 8-channel vectors: the row kernel. blockIdx.z is the
// image, blockIdx.y the output row and blockIdx.x a run of R_PIX pixels of
// it, so no index needs a division. A warp owns 4 pixels: lanes 0-3 run the
// coordinate chain of one pixel each (once a pixel) and shuffle it to the
// pixel's R_TPP lanes; a lane then holds up to R_VEC vectors of its pixel
// (lane t: vectors t, t + 8, ...), all four corners' loads in flight at
// once (8 at 128 channels). The blend and its order are the general
// kernel's, so the bits are too.
constexpr int R_PIX = 16;   // output pixels a block
constexpr int R_TPP = 8;    // lanes a pixel
constexpr int R_VEC = 2;    // vectors a lane holds at once
constexpr int R_THREADS = R_PIX * R_TPP;

__global__ void __launch_bounds__(R_THREADS)
warp_affine_bf16_rows_kernel(const __nv_bfloat16* __restrict__ src,
                             const float* __restrict__ theta,
                             __nv_bfloat16* __restrict__ out, int h, int w, int nvec) {
    using V = Vec<__nv_bfloat16, 8>;
    const int b = blockIdx.z, yo = blockIdx.y;
    const int lane = threadIdx.x & 31;
    const int x_warp = blockIdx.x * R_PIX + (threadIdx.x >> 5) * (32 / R_TPP);
    Sample sm{};
    if (lane < 32 / R_TPP && x_warp + lane < w)
        sm = sample_at(theta + b * 6, x_warp + lane, yo, w, h);
    const int from = lane / R_TPP;
    sm.ix0 = __shfl_sync(0xffffffffu, sm.ix0, from);
    sm.iy0 = __shfl_sync(0xffffffffu, sm.iy0, from);
    sm.wx0 = __shfl_sync(0xffffffffu, sm.wx0, from);
    sm.wx1 = __shfl_sync(0xffffffffu, sm.wx1, from);
    sm.wy0 = __shfl_sync(0xffffffffu, sm.wy0, from);
    sm.wy1 = __shfl_sync(0xffffffffu, sm.wy1, from);
    const int xo = x_warp + from;
    if (xo >= w) return;
    const int t = lane % R_TPP;
    const uint4* base = reinterpret_cast<const uint4*>(src) + (int64_t)b * h * w * nvec;
    uint4* dst = reinterpret_cast<uint4*>(out) + ((int64_t)(b * h + yo) * w + xo) * nvec;
    bool inside[4];
    const uint4* corner[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int ix = sm.ix0 + (k & 1), iy = sm.iy0 + (k >> 1);
        inside[k] = !(ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1);
        corner[k] = base + ((int64_t)iy * w + ix) * nvec;
    }
    for (int v0 = t; v0 < nvec; v0 += R_TPP * R_VEC) {
        uint4 val[4][R_VEC];
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
            for (int j = 0; j < R_VEC; ++j) {
                const int cv = v0 + j * R_TPP;
                if (inside[k] && cv < nvec) val[k][j] = __ldg(corner[k] + cv);
            }
#pragma unroll
        for (int j = 0; j < R_VEC; ++j) {
            const int cv = v0 + j * R_TPP;
            if (cv >= nvec) break;
            V::Acc acc = zero<V::Acc>();
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (inside[k]) acc = axpy(sm.weight(k), val[k][j], acc);
            dst[cv] = to_bf16(acc);
        }
    }
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
    if (channels % 8 == 0 && aligned16(src, out)) {
        if (n > 0 && h > 0 && w > 0)
            warp_affine_bf16_rows_kernel<<<dim3((unsigned)((w + R_PIX - 1) / R_PIX),
                                                (unsigned)h, (unsigned)n),
                                           R_THREADS, 0, s>>>(
                static_cast<const __nv_bfloat16*>(src), static_cast<const float*>(theta),
                static_cast<__nv_bfloat16*>(out), h, w, channels / 8);
    } else
        launch<__nv_bfloat16, 1>(src, theta, out, n, h, w, channels, s);
    return (int)cudaGetLastError();
}

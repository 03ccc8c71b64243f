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
// What bounds it on Hopper: bytes on wide maps. At the flagship (N=2,
// 64 x 128 x 128, fp32) it reads 8.4 MB and writes 8.4 MB; the arithmetic
// per output value is a handful of FMAs. A one-channel map (the HEAL
// pyramid's occupancy scores, V2VNet's map of ones) is 16-256 KB: the
// launch and one thread's chain of dependent steps bound it.
//
// Design: Hopper gathers well, so no one-hot matrices. One kernel,
// `warp_affine_rows_kernel` (and bf16's `rows` route, below), on a row
// grid: blockIdx.z is the image,
// blockIdx.y the output row, blockIdx.x a run of output pixels of it, so
// no index needs a division. A pixel owns 2^k lanes of a warp (k from the
// width); lanes of each warp run the coordinate chain (`sample_at`) of one
// pixel each, theta read by each of them (a broadcast load; through shared
// memory behind a barrier it was slower on an H100), and shuffle it to the
// pixel's lanes; a lane then holds up to RV vectors of its pixel (lane t:
// vectors t, t + lanes, ...) with all four corners' loads in flight at
// once. The coordinate
// arithmetic uses the non-contracting intrinsics so that it rounds exactly
// like the plain PyTorch version beside it. Three routes, chosen by the C
// entries from the width and the alignment (ops/warp.py:forward_route
// mirrors the rule):
//  * `rows`: 16-byte vectors (4 fp32 or 8 bf16 channels), C a multiple of
//    the vector and both maps 16-byte aligned; the lanes a pixel sized from
//    C (`plan_for`: 64 channels 8 lanes of 2 vectors, 128 16 of 2, 256 16
//    of 4 in fp32).
//  * `pixel`: one thread a pixel, every channel blended from its one
//    `Sample`, for the maps of at most 4 channels that `rows` does not take
//    (the one-channel maps; any alignment).
//  * `scalar`: single channels over 2 to 32 lanes a pixel, for wider maps
//    that `rows` does not take (C % 4 != 0, or a view off 16 bytes).
// Every route takes the same chain, corner order (x0,y0), (x1,y0), (x0,y1),
// (x1,y1) and blend per channel, so all give the same bits, and those of
// the port's first kernel (a thread a 4-channel vector).
//
// The pair entry (`warp_affine_pair_f32`) warps a second map under the same
// theta in the same launch: the HEAL pyramid's level feature and its
// one-channel occupancy score. The feature takes its route as above; the
// score is warped a lane a pixel by the lanes that ran the pixels' chains
// (one warp a block where a block holds at most 32 pixels), so its loads
// and stores cover up to 32 neighbouring pixels an instruction as on its
// own pixel route; its first channel's corner loads are issued before the
// feature's. A lane of each pixel's group instead (4 pixels a warp
// instruction at 64 channels) made the pair slower than the two launches
// at 128 x 256 on an H100. The score's bits are those of its own launch.
//
// bf16 instantiation (`warp_affine_bf16`, for `half`): the TPU kernel takes
// a bf16 map and returns bf16 with fp32 accumulation (warp_pallas.py:71-82).
// The same coordinate chain and blend, bit for bit, rounded once to bf16;
// bound by bytes, half of the fp32 kernel's. Its `rows` route is its own
// row kernel, `warp_affine_bf16_rows_kernel` (8-channel vectors, 8 lanes
// of 2 at 128 channels, the chains on 4 lanes a warp), kept apart: the
// shared kernel on bf16 rows was 4-5% slower on an H100; its `pixel` and
// `scalar` routes are the shared kernel's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;             // threads a block, at most

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

template <typename T>
__device__ __forceinline__ T load(const T* p) { return __ldg(p); }
template <>
__device__ __forceinline__ __nv_bfloat16 load(const __nv_bfloat16* p) { return *p; }

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

__device__ __forceinline__ Sample sample_at(const float* th, int xo, int yo, int w, int h) {
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

// the four corners of a sample: in the map or not, and each one's pixel
struct Corners {
    bool inside[4];
    int64_t at[4];
    __device__ __forceinline__ Corners(const Sample& sm, int64_t image, int h, int w) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
            const int ix = sm.ix0 + (k & 1), iy = sm.iy0 + (k >> 1);
            inside[k] = !(ix < 0 || ix > w - 1 || iy < 0 || iy > h - 1);
            at[k] = image + (int64_t)iy * w + ix;
        }
    }
};

// Every route. E: the element type; VEC: channels a load (4 / 8 on `rows`,
// 1 on `pixel` and `scalar`); nvec = C / VEC; a pixel owns 2^lanes_log2
// lanes, each holding up to RV of its vectors at once. PAIR: also the fp32
// map src_b (cb channels) into out_b, a lane a pixel.
template <typename E, int VEC, int RV, bool PAIR>
__global__ void __launch_bounds__(THREADS)
warp_affine_rows_kernel(const E* __restrict__ src, const float* __restrict__ theta,
                        E* __restrict__ out, int h, int w, int nvec, int lanes_log2,
                        const float* __restrict__ src_b, float* __restrict__ out_b,
                        int cb) {
    using T = typename Vec<E, VEC>::T;
    using Acc = typename Vec<E, VEC>::Acc;
    const int b = blockIdx.z, yo = blockIdx.y;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int per_warp = 32 >> lanes_log2;           // pixels a warp
    const int per_block = blockDim.x >> lanes_log2;  // pixels a block
    const int x_block = blockIdx.x * per_block;
    // The coordinate chains: with at most 32 pixels a block, lane l of every
    // warp works out that of the block's pixel l (all lanes of a warp issue
    // together, so this costs a warp no more than its own pixels' would);
    // else lane l of warp v that of pixel v * per_warp + l.
    const int first = per_block <= 32 ? 0 : warp * per_warp;
    const int chains = per_block <= 32 ? per_block : per_warp;
    const int xs = x_block + first + lane;
    const int64_t image = (int64_t)b * h * w;
    Sample own{};
    if (lane < chains && xs < w) own = sample_at(theta + b * 6, xs, yo, w, h);
    // PAIR: the lanes with a chain of their own (warp 0's if the block has at
    // most 32 pixels) warp src_b at that pixel, the first channel's corner
    // loads issued before the wide map's
    const bool scorer = PAIR && lane < chains && xs < w && (per_block > 32 || warp == 0);
    float sval[4];
    if constexpr (PAIR) {
        if (scorer) {
            const Corners cn(own, image, h, w);
#pragma unroll
            for (int k = 0; k < 4; ++k)
                if (cn.inside[k]) sval[k] = __ldg(src_b + cn.at[k] * cb);
        }
    }
    const int from = warp * per_warp + (lane >> lanes_log2) - first;
    Sample sm = own;
    if (lanes_log2 > 0) {
        sm.ix0 = __shfl_sync(0xffffffffu, own.ix0, from);
        sm.iy0 = __shfl_sync(0xffffffffu, own.iy0, from);
        sm.wx0 = __shfl_sync(0xffffffffu, own.wx0, from);
        sm.wx1 = __shfl_sync(0xffffffffu, own.wx1, from);
        sm.wy0 = __shfl_sync(0xffffffffu, own.wy0, from);
        sm.wy1 = __shfl_sync(0xffffffffu, own.wy1, from);
    }
    const int xo = x_block + warp * per_warp + (lane >> lanes_log2);
    if (xo < w) {
        const int lanes = 1 << lanes_log2;
        const int t = lane & (lanes - 1);
        const Corners cn(sm, image, h, w);
        const T* base = reinterpret_cast<const T*>(src);
        T* dst = reinterpret_cast<T*>(out) + (image + (int64_t)yo * w + xo) * nvec;
        for (int v0 = t; v0 < nvec; v0 += lanes * RV) {
            T val[4][RV];
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
                for (int j = 0; j < RV; ++j) {
                    const int cv = v0 + j * lanes;
                    if (cn.inside[k] && cv < nvec) val[k][j] = load(base + cn.at[k] * nvec + cv);
                }
#pragma unroll
            for (int j = 0; j < RV; ++j) {
                const int cv = v0 + j * lanes;
                if (cv >= nvec) break;
                Acc acc = zero<Acc>();
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (cn.inside[k]) acc = axpy(sm.weight(k), val[k][j], acc);
                if constexpr (sizeof(E) == 4)
                    dst[cv] = acc;
                else
                    dst[cv] = to_bf16(acc);
            }
        }
    }
    if constexpr (PAIR) {
        if (scorer) {
            const Corners cn(own, image, h, w);
            float* dst_b = out_b + (image + (int64_t)yo * w + xs) * cb;
            for (int c = 0; c < cb; ++c) {
                if (c > 0)
#pragma unroll
                    for (int k = 0; k < 4; ++k)
                        if (cn.inside[k]) sval[k] = __ldg(src_b + cn.at[k] * cb + c);
                float acc = 0.f;
#pragma unroll
                for (int k = 0; k < 4; ++k)
                    if (cn.inside[k]) acc = axpy(own.weight(k), sval[k], acc);
                dst_b[c] = acc;
            }
        }
    }
}

// bf16 maps with 8-channel vectors: the row kernel. blockIdx.z is the
// image, blockIdx.y the output row and blockIdx.x a run of R_PIX pixels of
// it, so no index needs a division. A warp owns 4 pixels: lanes 0-3 run the
// coordinate chain of one pixel each (once a pixel) and shuffle it to the
// pixel's R_TPP lanes; a lane then holds up to R_VEC vectors of its pixel
// (lane t: vectors t, t + 8, ...), all four corners' loads in flight at
// once (8 at 128 channels). The blend and its order are the shared
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

int log2_ceil(long long x) {
    int l = 0;
    while ((1LL << l) < x) ++l;
    return l;
}

// 16-byte vectors need 16-byte aligned rows
bool aligned16(const void* a, const void* b) {
    return (((uintptr_t)a | (uintptr_t)b) & 15) == 0;
}

// a launch's lanes a pixel (log 2), vectors a lane at once and channels a
// load (1: `pixel` with one lane, else `scalar`)
struct Plan {
    int lanes_log2, rv, vec;
};

// The lanes a pixel aim at 2 vectors a lane on `rows` (8 lanes at 64 fp32
// channels, 16 at 128), at most 16 lanes (256 channels: 16 lanes of 4
// vectors, which beat 32 of 2 in the pair launch on an H100), and at 4
// channels a lane off `rows`, at most 32 lanes; one lane is the `pixel`
// route (C <= 4: 2 lanes of 3 beat a thread a pixel at 5 and 6 channels on
// an H100). bf16 `rows` is the row kernel (8 lanes of 2 vectors).
template <typename E>
Plan plan_for(int channels, bool aligned) {
    constexpr int vec = (int)(16 / sizeof(E));
    const bool rows = channels % vec == 0 && aligned;
    const int n = rows ? channels / vec : channels;  // vectors or channels
    const int per_lane = rows ? 2 : 4, most = rows ? 4 : 5;
    int l = log2_ceil((n + per_lane - 1) / per_lane);
    l = l < most ? l : most;
    const int rv = (n + (1 << l) - 1) >> l;
    return {l, rv < 4 ? rv : 4, rows ? vec : 1};
}

template <typename E, int VEC, bool PAIR>
void launch_plan(const Plan& p, const void* src, const float* theta, void* out, int n,
                 int h, int w, int channels, const float* src_b, float* out_b, int cb,
                 cudaStream_t s) {
    const long long lanes = (long long)w << p.lanes_log2;
    const int threads = lanes >= THREADS ? THREADS : (int)((lanes + 31) / 32 * 32);
    const int per_block = threads >> p.lanes_log2;
    const dim3 grid((unsigned)((w + per_block - 1) / per_block), (unsigned)h, (unsigned)n);
    const E* a = static_cast<const E*>(src);
    E* o = static_cast<E*>(out);
    const int nvec = channels / VEC;
#define K3_LAUNCH(RV)                                                              \
    warp_affine_rows_kernel<E, VEC, RV, PAIR><<<grid, threads, 0, s>>>(            \
        a, theta, o, h, w, nvec, p.lanes_log2, src_b, out_b, cb)
    switch (p.rv) {
        case 1: K3_LAUNCH(1); break;
        case 2: K3_LAUNCH(2); break;
        case 3: K3_LAUNCH(3); break;
        default: K3_LAUNCH(4); break;
    }
#undef K3_LAUNCH
}

// N and H at most 65,535 (the grid's z and y limits)
template <typename E, bool PAIR>
int warp(const void* src, const void* theta, void* out, int n, int h, int w, int channels,
         const void* src_b, void* out_b, int cb, cudaStream_t s) {
    if (n > 65535 || h > 65535) return (int)cudaErrorInvalidValue;
    if (n <= 0 || h <= 0 || w <= 0 || channels <= 0) return (int)cudaGetLastError();
    const Plan p = plan_for<E>(channels, aligned16(src, out));
    const E* a = static_cast<const E*>(src);
    E* o = static_cast<E*>(out);
    const float* th = static_cast<const float*>(theta);
    const float* sb = static_cast<const float*>(src_b);
    float* ob = static_cast<float*>(out_b);
    if (p.vec == 1)
        launch_plan<E, 1, PAIR>(p, a, th, o, n, h, w, channels, sb, ob, cb, s);
    else if constexpr (sizeof(E) == 4)
        launch_plan<E, 4, PAIR>(p, a, th, o, n, h, w, channels, sb, ob, cb, s);
    else
        warp_affine_bf16_rows_kernel<<<dim3((unsigned)((w + R_PIX - 1) / R_PIX), (unsigned)h,
                                            (unsigned)n),
                                       R_THREADS, 0, s>>>(a, th, o, h, w, channels / 8);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int warp_affine_f32(const void* src, const void* theta, void* out,
                               int n, int h, int w, int channels, void* stream) {
    return warp<float, false>(src, theta, out, n, h, w, channels, nullptr, nullptr, 0,
                              static_cast<cudaStream_t>(stream));
}

extern "C" int warp_affine_bf16(const void* src, const void* theta, void* out,
                                int n, int h, int w, int channels, void* stream) {
    return warp<__nv_bfloat16, false>(src, theta, out, n, h, w, channels, nullptr,
                                      nullptr, 0, static_cast<cudaStream_t>(stream));
}

// two fp32 maps of one N x H x W under one theta: src_a (C_a >= 1 channels,
// on the route warp_affine_f32 would take) and src_b (C_b >= 1 channels,
// any alignment), in one launch. Every entry takes N and H <= 65,535 (the
// grid's limits) and returns cudaErrorInvalidValue above them.
extern "C" int warp_affine_pair_f32(const void* src_a, const void* src_b, const void* theta,
                                    void* out_a, void* out_b, int n, int h, int w,
                                    int c_a, int c_b, void* stream) {
    if (c_a <= 0 || c_b <= 0) return (int)cudaErrorInvalidValue;
    return warp<float, true>(src_a, theta, out_a, n, h, w, c_a, src_b, out_b, c_b,
                             static_cast<cudaStream_t>(stream));
}

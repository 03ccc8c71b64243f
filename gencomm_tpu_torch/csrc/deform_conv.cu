// Deformable 3x3 convolution forward, stride 1, pad 1, NHWC fp32
// (kernel K1 of the port).
//
// Replaces: gencomm_tpu/ops/deform_pallas.py `_deform_kernel` /
// `deform_conv3x3_mxu` (the TPU kernel that turns each tap's bilinear
// sampling into a banded one-hot matrix on the MXU, because the TPU has no
// fast gather).
//
// What it computes: out[p, o] = sum over taps k and input channels c of
// sample(x, p + tap_k + offset[p, k])[c] * weight[k, c, o], with bilinear
// sampling and zero padding outside the map (torchvision DeformConv2d
// semantics; offsets in (dy, dx)-per-tap layout, already clamped by the
// caller). The bias is added by the caller.
//
// What bounds it on Hopper: operations. At the flagship (2 x 64 x 128
// pixels, 128 -> 64 channels) one call is 2 * 16384 * 1152 * 64 = 2.4 GFLOP
// over ~15 MB, i.e. ~160 FLOP per byte: above the fp32 ridge point of the
// card, so the contraction samples (px, 9 Cin) x W (9 Cin, Cout), not the
// gather, is the limit. On the fp32 pipes that product cannot go below
// 0.036 ms; the first version of this kernel (a 4 x 4 register tile fed by
// 5 shared loads per 16 FMAs, one buffer, two barriers per chunk) took
// 5-9x that.
//
// Design, two routes chosen by the caller from the channel counts:
//  * route 1, Cin a multiple of 32 and Cout = 64 (every model of the repo):
//    the product runs on the tensor cores as 3xTF32 (deform_common.cuh:
//    both operands split into tf32 hi + lo, three mma.sync.m16n8k8 products,
//    fp32 accumulators), which keeps fp32-level results; a single TF32 or
//    bf16 product would not hold the 1e-4 tolerance at depth 1152. A block
//    of 8 warps owns 64 pixels x 64 output channels (warp tile 32 x 16). It
//    computes the corner addresses and bilinear weights of its pixels for
//    all 9 taps once, then walks the 9 Cin / 32 chunks of the contraction
//    through a two-deep ring: while the warps multiply chunk i out of
//    shared memory, the weight slice of chunk i + 1 arrives by cp.async and
//    the corner rows of chunk i + 1 are in flight as 16-byte loads into
//    registers (8 lanes read one corner's 32 channels, so a warp reads four
//    whole 128-byte lines); they are blended and stored after the
//    products, so one barrier per chunk suffices. Rows are padded (36 and
//    72 floats) so that every fragment load is free of bank conflicts. Each
//    chunk's products are summed from zero and added to the running sums
//    with rounded fp32 adds, because the tensor core truncates when it adds
//    into an accumulator. 107 registers and 55 KB of shared memory give two
//    blocks an SM, and one block's sampling overlaps the other's products.
//    What holds it now is instruction dispatch: per mma one shared load and
//    two split operations; the rate used is the tensor cores' TF32 rate
//    (three products per fp32 product), the bound reported beside the
//    kernel stays the fp32 one.
//  * route 0, any other channel counts: the first version's kernel (fp32
//    FMAs on a 4 x 4 register tile), kept as the general route.
// Both take any B, H, W; pixels are tiled in flat order, 64 to a block.
//
// bf16 instantiation (`deform_conv3x3_bf16`, for `half`): the TPU kernel
// takes a bf16 map and returns bf16 with fp32 accumulation
// (deform_pallas.py:88); offsets and weights stay fp32. Both routes are
// templates on x's and out's element type. On route 1 a thread loads one
// pixel's corner rows 8 bf16 channels at a time (16-byte loads, four corners
// in flight), blends them in fp32 and stores fp32 samples, so the 3xTF32
// product is the fp32 kernel's; the sums are rounded once to bf16 at the
// store. The result is the fp32 kernel's on the widened map, rounded once.
// (One bf16 mma.sync.m16n8k16 pass on bf16-rounded samples and weights, the
// TPU's default MXU precision, would issue a sixth of the products; K1 is
// far under 1% of a frame, so the exact design was kept.)

#include <cuda_bf16.h>

#include "deform_common.cuh"

namespace {

using deform::TapGeom;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- route 0: general, fp32 FMAs -----------------------------------------
constexpr int TP = 64;       // output pixels per block
constexpr int TC = 64;       // output channels per block
constexpr int KC = 32;       // input channels per chunk
constexpr int THREADS = 256;

// corner addresses and weights for every (tap, pixel) of a 64-pixel tile
__device__ __forceinline__ void tile_geometry(const float* __restrict__ offsets,
                                              int64_t p0, int64_t npix, int h, int w,
                                              int* s_idx, float* s_wt) {
    for (int e = threadIdx.x; e < 9 * TP; e += THREADS) {
        const int k = e / TP, p = e % TP;
        const int64_t pg = p0 + p;
        if (pg < npix) {
            const TapGeom t = deform::tap_geometry(offsets, pg, k, h, w);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                s_idx[e * 4 + q] = t.idx[q];
                s_wt[e * 4 + q] = deform::corner_weight(t, q);
            }
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                s_idx[e * 4 + q] = -1;
                s_wt[e * 4 + q] = 0.f;
            }
        }
    }
}

template <typename TX>
__global__ void __launch_bounds__(THREADS)
deform_conv3x3_kernel(const TX* __restrict__ x, const float* __restrict__ offsets,
                      const float* __restrict__ weight, TX* __restrict__ out,
                      int b, int h, int w, int cin, int cout) {
    __shared__ int s_idx[9 * TP * 4];
    __shared__ float s_wt[9 * TP * 4];
    __shared__ float s_samp[KC][TP + 1];
    __shared__ __align__(16) float s_w[KC][TC];

    const int tid = threadIdx.x;
    const int64_t npix = (int64_t)b * h * w;
    const int64_t p0 = (int64_t)blockIdx.x * TP;
    const int o0 = blockIdx.y * TC;

    tile_geometry(offsets, p0, npix, h, w, s_idx, s_wt);

    const int tx = tid % 16;  // output channels tx*4 .. tx*4+3
    const int ty = tid / 16;  // output pixels  ty*4 .. ty*4+3
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    __syncthreads();
    for (int k = 0; k < 9; ++k) {
        for (int c0 = 0; c0 < cin; c0 += KC) {
            // sample a TP x KC tile: channel-fastest so corner reads coalesce
            for (int e = tid; e < TP * KC; e += THREADS) {
                const int c = e % KC, p = e / KC;
                const int ch = c0 + c;
                float v = 0.f;
                if (ch < cin) {
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int id = s_idx[(k * TP + p) * 4 + q];
                        if (id >= 0)
                            v += to_float(x[(int64_t)id * cin + ch]) *
                                 s_wt[(k * TP + p) * 4 + q];
                    }
                }
                s_samp[c][p] = v;
            }
            // stage weight[k, c0:c0+KC, o0:o0+TC]
            for (int e = tid; e < KC * TC; e += THREADS) {
                const int o = e % TC, c = e / TC;
                const int ch = c0 + c, oc = o0 + o;
                s_w[c][o] = (ch < cin && oc < cout)
                                ? weight[((int64_t)k * cin + ch) * cout + oc]
                                : 0.f;
            }
            __syncthreads();
#pragma unroll 8
            for (int c = 0; c < KC; ++c) {
                float a[4];
#pragma unroll
                for (int i = 0; i < 4; ++i) a[i] = s_samp[c][ty * 4 + i];
                const float4 bv = *reinterpret_cast<const float4*>(&s_w[c][tx * 4]);
                const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
            }
            __syncthreads();
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int64_t pg = p0 + ty * 4 + i;
        if (pg >= npix) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int oc = o0 + tx * 4 + j;
            if (oc < cout) store1(out + pg * cout + oc, acc[i][j]);
        }
    }
}

// ---- route 1: Cin % 32 == 0, Cout == 64, 3xTF32 on the tensor cores -------
// A block of 8 warps (2 x 4) owns 64 pixels x 64 output channels; a warp
// MI = 2 fragments of 16 pixels x 16 channels. (Tiles of 32 pixels, MI = 1,
// were tried for the shapes with fewer tiles than SMs and were not faster.)
constexpr int MI = 2;
constexpr int M_N = 64;           // output channels
constexpr int M_AS = KC + 4;      // padded row of the sampled tile [pixel][channel]
constexpr int M_BS = M_N + 8;     // padded row of the weight slice [channel][out]

constexpr size_t M_SMEM = (size_t)9 * TP * 4 * (sizeof(int) + sizeof(float)) +
                          (size_t)2 * (TP * M_AS + KC * M_BS) * sizeof(float);

// 32 consecutive rows of the (9 Cin, 64) weight matrix, from row `row0`
__device__ __forceinline__ void stage_weight(const float* __restrict__ weight, int row0,
                                             float* sB) {
    const float* src = weight + (int64_t)row0 * M_N;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        const int piece = threadIdx.x + j * THREADS;  // 512 pieces of 16 bytes
        const int row = piece / 16, c4 = piece % 16;
        deform::cp_async16(sB + row * M_BS + c4 * 4, src + row * M_N + c4 * 4);
    }
}

// a thread's share of a chunk's corner rows, loaded into registers and left
// in flight, then blended with the bilinear weights into fp32 samples
template <typename TX>
struct CornerRows;

// fp32 x: pixels sp and sp + 32, four channels from sc, all four corners
template <>
struct CornerRows<float> {
    float4 v[MI][4];
    int sp, sc;
    __device__ explicit CornerRows(int tid) : sp(tid >> 3), sc((tid & 7) * 4) {}

    __device__ __forceinline__ void load(const float* __restrict__ x, const int* s_idx,
                                         int k, int c0, int cin) {
#pragma unroll
        for (int j = 0; j < MI; ++j) {
            const int4 id =
                *reinterpret_cast<const int4*>(s_idx + (k * TP + sp + j * 32) * 4);
            const int ids[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
            for (int q = 0; q < 4; ++q)
                v[j][q] = ids[q] >= 0 ? deform::ldg4(x + (int64_t)ids[q] * cin + c0 + sc)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }

    __device__ __forceinline__ void store(const float* s_wt, int k, float* sA) const {
#pragma unroll
        for (int j = 0; j < MI; ++j) {
            const int p = sp + j * 32;
            const float4 wt = *reinterpret_cast<const float4*>(s_wt + (k * TP + p) * 4);
            const float wq[4] = {wt.x, wt.y, wt.z, wt.w};
            float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                s.x = fmaf(v[j][q].x, wq[q], s.x);
                s.y = fmaf(v[j][q].y, wq[q], s.y);
                s.z = fmaf(v[j][q].z, wq[q], s.z);
                s.w = fmaf(v[j][q].w, wq[q], s.w);
            }
            *reinterpret_cast<float4*>(sA + p * M_AS + sc) = s;
        }
    }
};

// bf16 x: pixel sp, eight channels from sc, one 16-byte load a corner; the
// blend is the fp32 one on the widened values, in the same order
template <>
struct CornerRows<__nv_bfloat16> {
    uint4 v[4];
    int sp, sc;
    __device__ explicit CornerRows(int tid) : sp(tid >> 2), sc((tid & 3) * 8) {}

    __device__ __forceinline__ void load(const __nv_bfloat16* __restrict__ x,
                                         const int* s_idx, int k, int c0, int cin) {
        const int4 id = *reinterpret_cast<const int4*>(s_idx + (k * TP + sp) * 4);
        const int ids[4] = {id.x, id.y, id.z, id.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
            v[q] = ids[q] >= 0 ? __ldg(reinterpret_cast<const uint4*>(
                                     x + (int64_t)ids[q] * cin + c0 + sc))
                               : make_uint4(0u, 0u, 0u, 0u);
    }

    __device__ __forceinline__ void store(const float* s_wt, int k, float* sA) const {
        const float4 wt = *reinterpret_cast<const float4*>(s_wt + (k * TP + sp) * 4);
        const float wq[4] = {wt.x, wt.y, wt.z, wt.w};
        float s[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) s[i] = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const __nv_bfloat162* pv = reinterpret_cast<const __nv_bfloat162*>(&v[q]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float2 f = __bfloat1622float2(pv[i]);
                s[2 * i] = fmaf(f.x, wq[q], s[2 * i]);
                s[2 * i + 1] = fmaf(f.y, wq[q], s[2 * i + 1]);
            }
        }
        float* dst = sA + sp * M_AS + sc;
        *reinterpret_cast<float4*>(dst) = make_float4(s[0], s[1], s[2], s[3]);
        *reinterpret_cast<float4*>(dst + 4) = make_float4(s[4], s[5], s[6], s[7]);
    }
};

template <typename TX>
__global__ void __launch_bounds__(THREADS, 2)
deform_conv3x3_mma_kernel(const TX* __restrict__ x, const float* __restrict__ offsets,
                          const float* __restrict__ weight, TX* __restrict__ out,
                          int b, int h, int w, int cin) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    int* s_idx = reinterpret_cast<int*>(smem_raw);              // [9][TP][4]
    float* s_wt = reinterpret_cast<float*>(s_idx + 9 * TP * 4); // [9][TP][4]
    float* sA = s_wt + 9 * TP * 4;                              // [2][TP][M_AS]
    float* sB = sA + 2 * TP * M_AS;                             // [2][KC][M_BS]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int64_t npix = (int64_t)b * h * w;
    const int64_t p0 = (int64_t)blockIdx.x * TP;
    const int nchunks = 9 * (cin / KC);
    const int wm = (warp & 1) * 16 * MI;  // the warp's pixels wm .. wm + 31
    const int wn = (warp >> 1) * 16;      // and output channels wn .. wn + 15

    tile_geometry(offsets, p0, npix, h, w, s_idx, s_wt);
    __syncthreads();

    // chunk i is tap i % 9 of channel slice i / 9: the nine taps of a slice
    // follow each other, and neighbouring taps and pixels share a corner
    // row's 128-byte line (it made no difference to the time that was seen)
    CornerRows<TX> rows(tid);
    stage_weight(weight, 0, sB);
    rows.load(x, s_idx, 0, 0, cin);
    rows.store(s_wt, 0, sA);
    deform::cp_async_wait_all();
    __syncthreads();

    float acc[MI][2][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0.f;

    for (int i = 0; i < nchunks; ++i) {
        const int cur = i & 1;
        const bool more = i + 1 < nchunks;
        const int kn = (i + 1) % 9, cn = ((i + 1) / 9) * KC;
        if (more) {
            stage_weight(weight, kn * cin + cn, sB + (cur ^ 1) * KC * M_BS);
            rows.load(x, s_idx, kn, cn, cin);
        }
        const float* A = sA + cur * TP * M_AS + wm * M_AS;
        const float* B = sB + cur * KC * M_BS + wn;
        // the chunk's products are summed from zero and added to the running
        // sums with a rounded fp32 add: the tensor cores truncate when they
        // add to an accumulator, and a chain of 432 such adds would drift
        float part[MI][2][4];
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int r = 0; r < 4; ++r) part[mi][ni][r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KC; kk += 8) {
            uint32_t ahi[MI][4], alo[MI][4], bhi[2][2], blo[2][2];
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
                const float* a = A + (mi * 16 + g) * M_AS + kk + t;
                deform::split_tf32(a[0], ahi[mi][0], alo[mi][0]);
                deform::split_tf32(a[8 * M_AS], ahi[mi][1], alo[mi][1]);
                deform::split_tf32(a[4], ahi[mi][2], alo[mi][2]);
                deform::split_tf32(a[8 * M_AS + 4], ahi[mi][3], alo[mi][3]);
            }
#pragma unroll
            for (int ni = 0; ni < 2; ++ni) {
                const float* bp = B + (kk + t) * M_BS + ni * 8 + g;
                deform::split_tf32(bp[0], bhi[ni][0], blo[ni][0]);
                deform::split_tf32(bp[4 * M_BS], bhi[ni][1], blo[ni][1]);
            }
            deform::mma_3xtf32(part, ahi, alo, bhi, blo);
        }
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
#pragma unroll
            for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                for (int r = 0; r < 4; ++r) acc[mi][ni][r] += part[mi][ni][r];
        if (more) {
            rows.store(s_wt, kn, sA + (cur ^ 1) * TP * M_AS);
            deform::cp_async_wait_all();
        }
        __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
        const int64_t row = p0 + wm + mi * 16 + g;
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
            const int col = wn + ni * 8 + 2 * t;
            if (row < npix) store2(out + row * M_N + col, acc[mi][ni][0], acc[mi][ni][1]);
            if (row + 8 < npix)
                store2(out + (row + 8) * M_N + col, acc[mi][ni][2], acc[mi][ni][3]);
        }
    }
}

template <typename TX>
int launch(const void* x, const void* offsets, const void* weight, void* out, int b,
           int h, int w, int cin, int cout, int route, cudaStream_t s) {
    const long long npix = (long long)b * h * w;
    if (npix <= 0 || cout <= 0) return (int)cudaGetLastError();
    const auto* xt = static_cast<const TX*>(x);
    const auto* of = static_cast<const float*>(offsets);
    const auto* wf = static_cast<const float*>(weight);
    auto* ot = static_cast<TX*>(out);
    const unsigned tiles = (unsigned)((npix + TP - 1) / TP);
    if (route == 1) {
        if (cin <= 0 || cin % KC != 0 || cout != M_N) return (int)cudaErrorInvalidValue;
        static bool configured = false;  // more than 48 KB of shared memory: opt in once
        if (!configured) {
            cudaError_t err = cudaFuncSetAttribute(
                deform_conv3x3_mma_kernel<TX>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)M_SMEM);
            if (err != cudaSuccess) return (int)err;
            configured = true;
        }
        deform_conv3x3_mma_kernel<TX><<<tiles, THREADS, M_SMEM, s>>>(xt, of, wf, ot, b, h,
                                                                     w, cin);
    } else if (route == 0) {
        dim3 grid(tiles, (unsigned)((cout + TC - 1) / TC));
        deform_conv3x3_kernel<TX><<<grid, THREADS, 0, s>>>(xt, of, wf, ot, b, h, w, cin,
                                                           cout);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace

// route 0: the general kernel; route 1: the tensor-core kernel, which takes
// Cin % 32 == 0 and Cout == 64 only (and, for 16-byte loads, a 16-byte
// aligned x)
extern "C" int deform_conv3x3_f32(const void* x, const void* offsets,
                                  const void* weight, void* out, int b, int h,
                                  int w, int cin, int cout, int route,
                                  void* stream) {
    return launch<float>(x, offsets, weight, out, b, h, w, cin, cout, route,
                         static_cast<cudaStream_t>(stream));
}

// the same with x and out in bf16 (offsets and weight fp32)
extern "C" int deform_conv3x3_bf16(const void* x, const void* offsets,
                                   const void* weight, void* out, int b, int h,
                                   int w, int cin, int cout, int route,
                                   void* stream) {
    return launch<__nv_bfloat16>(x, offsets, weight, out, b, h, w, cin, cout, route,
                                 static_cast<cudaStream_t>(stream));
}

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
// (deform_pallas.py:88); offsets and weights stay fp32, and the output is
// the fp32 contraction of the fp32 samples, rounded once. Route 0 is the
// general kernel on the widened values. Route 1 on a bf16 map is a kernel of
// its own (`band::`), bound at this card's bf16 rate (2.4 GFLOP in 0.0024
// ms at the lidar eval shape): the product runs on the bf16 tensor cores
// (wgmma) as three products of operands split once into bf16 hi + lo,
// which keeps fp32-level results where one bf16 pass would not, and the
// corner rows are blended out of a band of the map staged once a 32-channel
// slice in shared memory. Its sums are taken in another order than the
// fp32 kernel's, so an output may land one bf16 step from the fp32 kernel's
// rounded one.

#include <cuda_bf16.h>

#include "deform_common.cuh"

// K1_PART selects a partial build of the bf16 map's route 1 (`band::`), for
// timing its parts apart (scripts/bench_deform_torch.py --parts): 0 the
// kernel, 1 the product only (no corner row is read or blended), 2 the
// sampling only (no products; one sample per stage is kept live in the
// output)
#ifndef K1_PART
#define K1_PART 0
#endif

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

// ---- route 1 on a bf16 map: the band kernel --------------------------------
// A block owns an 8 x 8 tile of output pixels x 64 output channels, and its
// 16 warps are split by role:
//  * eight sampler warps. The tile anchors a band of the map, rows y0 - 5 ..
//    y0 + 13 and columns x0 - 5 .. x0 + 13: the four corners of every sample
//    a tap takes with offsets within +-4 (MAX_OFFSET + 1 pixels). For each
//    32-channel slice the band (19 x 19 pixels x 32 bf16, 5.6x the tile's
//    own bytes; zeros outside the map, so a corner there needs no test)
//    arrives in shared memory by cp.async once, for all nine taps, into one
//    of two buffers, so the next slice's band is in flight during the whole
//    slice before it. Samples whose corners leave the band (offsets beyond
//    +-4) read them from the map in global memory instead, so any offsets
//    take this kernel. For a chunk (tap k, slice s) a sampler thread blends
//    8 channels of one pixel from its four corners in fp32 (the fp32
//    kernel's order) and splits each sample once into bf16 hi = rn(s) and
//    lo = rn(s - hi); the tap geometry is worked out once a tile;
//  * four weight warps split the chunks' 32 x 64 fp32 weight slices the same
//    way (16-byte loads, two stages ahead in registers);
//  * one consumer warpgroup takes hi*hi + hi*lo + lo*hi on the tensor cores
//    with wgmma.m64n64k16 (both operands in shared memory): a stage's twelve
//    products summed from zero, then added to the running sums with rounded
//    fp32 adds (the tensor cores truncate when they add into an
//    accumulator).
// A stage holds two chunks; the roles meet at a ring of three stages
// through named barriers (full: the writers arrive, the consumers wait;
// empty: the reverse). hi + lo holds 16 significant bits of an fp32 value;
// the dropped lo*lo and the rounding of lo are ~2^-16 of a product.
// What holds it (PERF.md, PR 9): the writers. The consumer alone takes a
// third of the time; the samplers' gather and split and the weight
// staging, all through the shared-memory pipe, set the rest. One block an
// SM (166 KB of shared memory), so 256 tiles run in two waves.
namespace band {
constexpr int TY = 8, TX = 8;          // the tile, TY * TX == TP pixels
constexpr int REACH = 5;               // 1 (tap) + MAX_OFFSET
constexpr int BH = TY + 2 * REACH + 1;  // 19 band rows: floor corners and the next
constexpr int BW = TX + 2 * REACH + 1;  // 19 band columns
constexpr int BAND_ELEMS = BH * BW * KC;
// the operands of a k32 chunk, in wgmma's K-major layout without swizzle:
// core matrices of 8 rows x 8 bf16 (128 contiguous bytes), row block r8 and
// column block k8 at r8 * SBO + k8 * LBO bytes. A's k8 blocks lie 160 B
// apart, so that the four 16-byte pieces a row gets from its four sampler
// threads fall in eight distinct bank groups with the next row's
constexpr int A_LBO = 160, A_SBO = 4 * A_LBO;
// B's row blocks lie 528 B (33 x 16) apart, so that the quarter warp that
// stores rows n = 4 i + m (i = 0 .. 7) of one k8 block hits eight distinct
// bank groups
constexpr int B_LBO = 128, B_SBO = 4 * B_LBO + 16;
constexpr int A_ELEMS = 8 * A_SBO / 2, B_ELEMS = 8 * B_SBO / 2;  // 64 rows x 32
// a stage holds UNITS chunks: A hi, A lo of each, then B hi, B lo of each
constexpr int UNITS = 2;
constexpr int STAGE_ELEMS = UNITS * 2 * (A_ELEMS + B_ELEMS);
constexpr int STAGES = 3;
constexpr int CONSUMERS = 128;         // one warpgroup, the products
constexpr int SAMPLERS = 256;          // 8 warps
constexpr int WEIGHTERS = 128;         // 4 warps
constexpr int BLOCK = CONSUMERS + SAMPLERS + WEIGHTERS;
static_assert(SAMPLERS == 4 * TP && WEIGHTERS == UNITS * 64, "one task a thread");
constexpr size_t SMEM = (size_t)9 * TP * sizeof(int4) +
                        (size_t)(2 * BAND_ELEMS + STAGES * STAGE_ELEMS) * 2;
// named barriers (0 is __syncthreads): stage s full 1 + s, empty 1 + STAGES
// + s; the samplers among themselves
constexpr int BAR_FULL = 1, BAR_EMPTY = 1 + STAGES, BAR_SAMPLERS = 1 + 2 * STAGES;

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// what this thread wrote to shared memory, seen by the tensor cores' reads
__device__ __forceinline__ void fence_to_async() {
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// element offset of (row, k) in an operand; k a multiple of 8
template <int LBO, int SBO>
__device__ __forceinline__ int op_at(int row, int k) {
    return ((row >> 3) * SBO + (k >> 3) * LBO) / 2 + (row & 7) * 8;
}

// the wgmma descriptor of a K-major operand without swizzle
template <int LBO, int SBO>
__device__ __forceinline__ uint64_t op_desc(const __nv_bfloat16* p) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(LBO >> 4) << 16) |
           ((uint64_t)(SBO >> 4) << 32);
}

// d (64 x 64, the warpgroup's accumulators) = (ScaleD ? d : 0) + a * b
template <int ScaleD>
__device__ __forceinline__ void wgmma(float (&d)[32], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(ScaleD));
}

// keeps the compiler from moving reads or writes of d across the wgmma
// fences, commits and waits (they name no register)
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// two fp32 values split into bf16 hi (rounded to nearest) and lo (the
// exact remainder, rounded to nearest)
__device__ __forceinline__ void split2(float a, float b, __nv_bfloat162& hi,
                                       __nv_bfloat162& lo) {
    hi = __floats2bfloat162_rn(a, b);
    const float2 h = __bfloat1622float2(hi);
    lo = __floats2bfloat162_rn(__fsub_rn(a, h.x), __fsub_rn(b, h.y));
}

struct Tile {
    int b, y0, x0;  // the image and the first row and column of the tile
    // flat pixel of tile pixel p, or -1 past the map's edge
    __device__ __forceinline__ int64_t pixel(int p, int h, int w) const {
        const int y = y0 + p / TX, x = x0 + p % TX;
        return (y < h && x < w) ? ((int64_t)b * h + y) * w + x : -1;
    }
};

// the entry of every (tap, pixel) of the tile, by sampler st: {code, the
// floor corner (y0, x0) packed, wy1, wx1}. code >= 0: the band pixel of
// corner (y0, x0), all four corners in the band (those outside the map read
// its zeros); -1: a pixel past the map's edge; -2: the corners are read
// from the map in global memory (offsets beyond +-4). A thread's offsets are
// all loaded before the first is used.
constexpr int CODE_ROUNDS = (9 * TP + SAMPLERS - 1) / SAMPLERS;

__device__ __forceinline__ void tile_codes(const float* __restrict__ offsets, Tile tl, int h,
                                           int w, int st, int4* s_entry) {
    float2 d[CODE_ROUNDS];
#pragma unroll
    for (int j = 0; j < CODE_ROUNDS; ++j) {
        const int e = st + j * SAMPLERS, k = e / TP;
        const int64_t pg = e < 9 * TP ? tl.pixel(e % TP, h, w) : -1;
        d[j] = pg >= 0 ? *reinterpret_cast<const float2*>(offsets + pg * 18 + 2 * k)
                       : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < CODE_ROUNDS; ++j) {
        const int e = st + j * SAMPLERS;
        if (e >= 9 * TP) break;
        const int k = e / TP, p = e % TP;
        const int y = tl.y0 + p / TX, x = tl.x0 + p % TX;
        if (y >= h || x >= w) {
            s_entry[e] = make_int4(-1, 0, 0, 0);
            continue;
        }
        const TapGeom t = deform::tap_geometry_pix(d[j].x, d[j].y, tl.b, y, x, k, h, w);
        const int r = t.iy0 - (tl.y0 - REACH), c = t.ix0 - (tl.x0 - REACH);
        const int code = (r >= 0 && r < BH - 1 && c >= 0 && c < BW - 1) ? r * BW + c : -2;
        // a floor corner far outside the map only matters as "outside"
        const int iy = min(max(t.iy0, -2), h), ix = min(max(t.ix0, -2), w);
        s_entry[e] = make_int4(code, (int)(((unsigned)iy << 16) | (ix & 0xffff)),
                               __float_as_int(t.wy1),
                               __float_as_int(t.wx1));
    }
}

// the band's channels c0 .. c0 + 31, by cp.async (16 bytes a piece), one
// commit group; pixels outside the map are filled with zeros
__device__ __forceinline__ void stage_band(const __nv_bfloat16* __restrict__ x, Tile tl,
                                           int h, int w, int cin, int c0, int st,
                                           __nv_bfloat16* s_band) {
    for (int e = st; e < BH * BW * 4; e += SAMPLERS) {
        const int pix = e >> 2, piece = e & 3;
        const int r = pix / BW, c = pix - r * BW;
        const int y = tl.y0 - REACH + r, xx = tl.x0 - REACH + c;
        const bool inside = y >= 0 && y < h && xx >= 0 && xx < w;
        const __nv_bfloat16* src =
            inside ? x + (((int64_t)tl.b * h + y) * w + xx) * cin + c0 + piece * 8 : x;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                         smem_addr(s_band + pix * KC + piece * 8)),
                     "l"(src), "r"(inside ? 16 : 0));
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// sampler st: the samples of tile pixel st / 4, channels (st % 4) * 8 ..
// + 7, of chunk (tap k, slice from c0), blended in fp32 (corner weights as
// deform::corner_weight rounds them) and stored split
__device__ __forceinline__ void sample_chunk(const __nv_bfloat16* __restrict__ x, Tile tl,
                                             int h, int w, int cin, int c0,
                                             const int4* s_entry, int k, int st,
                                             const __nv_bfloat16* s_band,
                                             __nv_bfloat16* sAhi, __nv_bfloat16* sAlo) {
    const int p = st >> 2, sc = (st & 3) * 8;
    const int4 en = s_entry[k * TP + p];
    const float wy1 = __int_as_float(en.z), wx1 = __int_as_float(en.w);
    const float wy0 = __fsub_rn(1.0f, wy1), wx0 = __fsub_rn(1.0f, wx1);
    const float wq[4] = {__fmul_rn(wy0, wx0), __fmul_rn(wy0, wx1), __fmul_rn(wy1, wx0),
                         __fmul_rn(wy1, wx1)};
    uint4 v[4];
    if (en.x >= 0) {
        const __nv_bfloat16* c = s_band + en.x * KC + sc;
        v[0] = *reinterpret_cast<const uint4*>(c);
        v[1] = *reinterpret_cast<const uint4*>(c + KC);
        v[2] = *reinterpret_cast<const uint4*>(c + BW * KC);
        v[3] = *reinterpret_cast<const uint4*>(c + (BW + 1) * KC);
    } else {
        const int iy0 = en.y >> 16, ix0 = (int)(short)(en.y & 0xffff);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int iy = iy0 + (q >> 1), ix = ix0 + (q & 1);
            v[q] = (en.x == -2 && iy >= 0 && iy < h && ix >= 0 && ix < w)
                       ? __ldg(reinterpret_cast<const uint4*>(
                             x + (((int64_t)tl.b * h + iy) * w + ix) * cin + c0 + sc))
                       : make_uint4(0u, 0u, 0u, 0u);
        }
    }
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
    __nv_bfloat162 hi[4], lo[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split2(s[2 * i], s[2 * i + 1], hi[i], lo[i]);
    const int at = op_at<A_LBO, A_SBO>(p, sc);
    *reinterpret_cast<uint4*>(sAhi + at) = *reinterpret_cast<const uint4*>(hi);
    *reinterpret_cast<uint4*>(sAlo + at) = *reinterpret_cast<const uint4*>(lo);
}

// the first row of chunk i's weight slice: chunk i is tap i % 9 of the
// 32-channel slice i / 9
__device__ __forceinline__ int chunk_row(int i, int cin) {
    return (i % 9) * cin + (i / 9) * KC;
}

// weight thread wt's share of a stage's weight slices: chunk j * UNITS + wt
// / 64 of the stage, output channels 4 (wt % 16) .. + 3 at the 8 rows from
// 8 ((wt / 16) % 4) of the chunk's 32 rows of the (9 Cin, 64) fp32 matrix
// (eight 16-byte loads), stored as four of B's K-major rows (8 consecutive
// k of one output channel)
struct WeightStage {
    float4 v[8];
    __device__ __forceinline__ void load(const float* __restrict__ weight, int j, int nchunks,
                                         int cin, int wt) {
        const int c = j * UNITS + (wt >> 6);
        if (c >= nchunks) return;
        const float* src = weight + (int64_t)(chunk_row(c, cin) + ((wt >> 4) & 3) * 8) * M_N +
                           (wt & 15) * 4;
#pragma unroll
        for (int i = 0; i < 8; ++i) v[i] = deform::ldg4(src + i * M_N);
    }
    __device__ __forceinline__ void store(int j, int nchunks, int wt,
                                          __nv_bfloat16* s_b) const {
        const int u = wt >> 6;
        if (j * UNITS + u >= nchunks) return;
        __nv_bfloat16* b = s_b + u * 2 * B_ELEMS;
        const int k0 = ((wt >> 4) & 3) * 8, n0 = (wt & 15) * 4;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            float col[8];
#pragma unroll
            for (int i = 0; i < 8; ++i)
                col[i] = m == 0 ? v[i].x : m == 1 ? v[i].y : m == 2 ? v[i].z : v[i].w;
            __nv_bfloat162 hi[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) split2(col[2 * i], col[2 * i + 1], hi[i], lo[i]);
            const int at = op_at<B_LBO, B_SBO>(n0 + m, k0);
            *reinterpret_cast<uint4*>(b + at) = *reinterpret_cast<const uint4*>(hi);
            *reinterpret_cast<uint4*>(b + B_ELEMS + at) = *reinterpret_cast<const uint4*>(lo);
        }
    }
};

__device__ __forceinline__ void sampler(const __nv_bfloat16* __restrict__ x,
                                        const float* __restrict__ offsets, Tile tl, int h,
                                        int w, int cin, int4* s_entry,
                                        __nv_bfloat16* s_band, __nv_bfloat16* s_stage) {
    const int st = threadIdx.x - CONSUMERS;
    const int slices = cin / KC, nchunks = 9 * slices;
#if K1_PART != 1
    // the first two slices' bands, then the codes
    stage_band(x, tl, h, w, cin, 0, st, s_band);
    if (slices > 1) stage_band(x, tl, h, w, cin, KC, st, s_band + BAND_ELEMS);
    tile_codes(offsets, tl, h, w, st, s_entry);
#endif
    for (int j = 0; j * UNITS < nchunks; ++j) {
        const int sg = j % STAGES;
        if (j >= STAGES) bar_sync(BAR_EMPTY + sg, BLOCK);
#if K1_PART != 1
        __nv_bfloat16* stage = s_stage + sg * STAGE_ELEMS;
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            const int c = j * UNITS + u, k = c % 9, slice = c / 9;
            if (c >= nchunks) break;
            if (k == 0) {
                // this slice's band has landed for every sampler (the next
                // slice's may still be in flight), and the codes are written
                if (slice + 1 < slices) cp_async_wait<1>();
                else cp_async_wait<0>();
                bar_sync(BAR_SAMPLERS, SAMPLERS);
            }
            sample_chunk(x, tl, h, w, cin, slice * KC, s_entry, k, st,
                         s_band + (slice & 1) * BAND_ELEMS, stage + u * 2 * A_ELEMS,
                         stage + u * 2 * A_ELEMS + A_ELEMS);
            // the slice's last chunk is sampled: once every sampler is past
            // it, its band buffer takes the slice after next
            if (k == 8 && slice + 2 < slices) {
                bar_sync(BAR_SAMPLERS, SAMPLERS);
                stage_band(x, tl, h, w, cin, (slice + 2) * KC, st,
                           s_band + (slice & 1) * BAND_ELEMS);
            }
        }
        fence_to_async();
#endif
        bar_arrive(BAR_FULL + sg, BLOCK);
    }
}

__device__ __forceinline__ void weighter(const float* __restrict__ weight, int cin,
                                         __nv_bfloat16* s_stage) {
    const int wt = threadIdx.x - CONSUMERS - SAMPLERS;
    const int nchunks = 9 * (cin / KC), nstages = (nchunks + UNITS - 1) / UNITS;
    // stage j's slices are in w0 for even j, w1 for odd, read two stages ahead
    WeightStage w0, w1;
    w0.load(weight, 0, nchunks, cin, wt);
    if (nstages > 1) w1.load(weight, 1, nchunks, cin, wt);
    auto stage_weights = [&](int j, WeightStage& ws) {
        const int sg = j % STAGES;
        if (j >= STAGES) bar_sync(BAR_EMPTY + sg, BLOCK);
        ws.store(j, nchunks, wt, s_stage + sg * STAGE_ELEMS + UNITS * 2 * A_ELEMS);
        fence_to_async();
        bar_arrive(BAR_FULL + sg, BLOCK);
        if (j + 2 < nstages) ws.load(weight, j + 2, nchunks, cin, wt);
    };
    for (int j = 0; j < nstages; j += 2) {
        stage_weights(j, w0);
        if (j + 1 < nstages) stage_weights(j + 1, w1);
    }
}

__device__ __forceinline__ void consumer(__nv_bfloat16* __restrict__ out, Tile tl, int h,
                                         int w, int nchunks, const __nv_bfloat16* s_stage) {
    float acc[32], part[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    for (int j = 0; j * UNITS < nchunks; ++j) {
        const int sg = j % STAGES;
        const __nv_bfloat16* st = s_stage + sg * STAGE_ELEMS;
        bar_sync(BAR_FULL + sg, BLOCK);
        pin(part);
        wgmma_fence();
#if K1_PART == 2
        part[0] = __bfloat162float(st[threadIdx.x]);
#else
        // each chunk's six products, the small terms first; the stage's sum
        // starts from zero. A k16 step reads two core-matrix columns of each
        // operand
        const uint64_t ak = (2 * A_LBO) >> 4, bk = (2 * B_LBO) >> 4;  // descriptor units
#pragma unroll
        for (int u = 0; u < UNITS; ++u) {
            if (j * UNITS + u >= nchunks) break;
            const __nv_bfloat16* A = st + u * 2 * A_ELEMS;
            const __nv_bfloat16* B = st + UNITS * 2 * A_ELEMS + u * 2 * B_ELEMS;
            const uint64_t ahi = op_desc<A_LBO, A_SBO>(A), alo = op_desc<A_LBO, A_SBO>(A + A_ELEMS);
            const uint64_t bhi = op_desc<B_LBO, B_SBO>(B), blo = op_desc<B_LBO, B_SBO>(B + B_ELEMS);
            if (u == 0) wgmma<0>(part, alo, bhi);
            else wgmma<1>(part, alo, bhi);
            wgmma<1>(part, ahi, blo);
            wgmma<1>(part, ahi, bhi);
            wgmma<1>(part, alo + ak, bhi + bk);
            wgmma<1>(part, ahi + ak, blo + bk);
            wgmma<1>(part, ahi + ak, bhi + bk);
        }
#endif
        wgmma_commit();
        wgmma_wait<0>();
        pin(part);
        // the stage is read: hand it back, unless no writer waits for it
        if ((j + STAGES) * UNITS < nchunks) bar_arrive(BAR_EMPTY + sg, BLOCK);
        // added with rounded fp32 adds: the tensor cores truncate when they
        // add into an accumulator
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += part[i];
    }

    // warp v holds tile rows 16 v + g and 16 v + g + 8; register 4 n + r is
    // output channel 8 n + 2 t + (r & 1) of the row (r < 2 ? g : g + 8)
    const int lane = threadIdx.x & 31, v = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int64_t pg = tl.pixel(16 * v + g + 8 * half, h, w);
        if (pg < 0) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n)
            store2(out + pg * M_N + 8 * n + 2 * t, acc[4 * n + 2 * half],
                   acc[4 * n + 2 * half + 1]);
    }
}

__global__ void __launch_bounds__(BLOCK, 1)
deform_conv3x3_band_kernel(const __nv_bfloat16* __restrict__ x,
                           const float* __restrict__ offsets,
                           const float* __restrict__ weight,
                           __nv_bfloat16* __restrict__ out, int h, int w, int cin) {
    extern __shared__ __align__(128) unsigned char smem_raw[];
    int4* s_entry = reinterpret_cast<int4*>(smem_raw);                  // [9][TP]
    auto* s_stage = reinterpret_cast<__nv_bfloat16*>(s_entry + 9 * TP);  // [STAGES][A, A, B, B]
    __nv_bfloat16* s_band = s_stage + STAGES * STAGE_ELEMS;             // [2][BH * BW][KC]

    // blockIdx.x: the tile column, blockIdx.y: the tile row, blockIdx.z: the image
    const Tile tl{(int)blockIdx.z, (int)blockIdx.y * TY, (int)blockIdx.x * TX};
    const int nchunks = 9 * (cin / KC);
    if (threadIdx.x < CONSUMERS)
        consumer(out, tl, h, w, nchunks, s_stage);
    else if (threadIdx.x < CONSUMERS + SAMPLERS)
        sampler(x, offsets, tl, h, w, cin, s_entry, s_band, s_stage);
    else
        weighter(weight, cin, s_stage);
}

}  // namespace band

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
        if constexpr (sizeof(TX) == 2) {
            if (!configured) {
                cudaError_t err = cudaFuncSetAttribute(
                    band::deform_conv3x3_band_kernel,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)band::SMEM);
                if (err != cudaSuccess) return (int)err;
                configured = true;
            }
            const dim3 grid((unsigned)((w + band::TX - 1) / band::TX),
                            (unsigned)((h + band::TY - 1) / band::TY), (unsigned)b);
            band::deform_conv3x3_band_kernel<<<grid, band::BLOCK, band::SMEM, s>>>(
                xt, of, wf, ot, h, w, cin);
        } else {
            if (!configured) {
                cudaError_t err = cudaFuncSetAttribute(
                    deform_conv3x3_mma_kernel<TX>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, (int)M_SMEM);
                if (err != cudaSuccess) return (int)err;
                configured = true;
            }
            deform_conv3x3_mma_kernel<TX><<<tiles, THREADS, M_SMEM, s>>>(xt, of, wf, ot, b,
                                                                         h, w, cin);
        }
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

// Deformable 3x3 convolution backward, stride 1, pad 1, NHWC fp32
// (kernel K1b of the port).
//
// Replaces: gencomm_tpu/ops/deform_pallas.py `_deform_bwd_kernel` /
// `_deform_bwd_impl` (the TPU kernel behind `deform_conv3x3_mxu`'s
// custom_vjp, which rebuilds each tap's banded one-hot sampling matrix on
// the MXU and contracts it four ways).
//
// What it computes, for the forward out[p] = sum_k sample_k(p) W_k with
// sample_k(p) = sum over the 4 corners q of w_q x[corner_q] (zero outside
// the map), and the cotangent g (pixels x Cout):
//   u_k(p)       = g(p) W_k^T                                  (Cin wide)
//   dx[corner_q] += w_q u_k(p)                                 (scatter)
//   doff_y(p, k) = sum_q s_y(q) wx_q <u_k(p), x[corner_q]>,  s_y = -1 at
//                  floor(y), +1 at floor(y) + 1 (the two-corner floor
//                  convention: one-sided at exact integers, and the
//                  floor(y) + 1 corner counts wherever it lies in the map,
//                  even at weight 0); doff_x likewise with wy_q
//   dW_k         = sum_p sample_k(p)^T g(p)
// The offsets are used as given (pre-clamped by the caller, not re-clipped):
// a corner may lie anywhere in the map, and every in-map corner is added.
//
// The input gradient is a sum over the (pixel, tap, corner) terms that land
// on each input pixel, which the first two versions added by float4 atomics
// in an order that changed from run to run. Here no sum is taken by atomics:
// the pass writes each term's factors, and K4's kernels (csrc/splat_topk.cu,
// ops/splat.py) take the sum in one fixed order. With record r = p * 9 + k,
//   rows[r]      = u_k(p)                                     (Cin wide)
//   ids[r][q]    = the flat pixel of corner q, -1 outside the map
//   weights[r][q] = w_q(p, k)
// dx = splat_topk(weights, rows, ids, B H W) is exactly the scatter above:
// K4 sorts the 4 x 9 x B H W records by corner pixel (a counting sort, each
// pixel's records in ascending flat record order) and sums each pixel's
// weighted rows in that order, so dx has the same bits on every run. It
// holds for any offsets, since a corner anywhere in the map is one more
// record and a corner outside it a dropped one.
//
// What bounds it on Hopper: operations in this pass, bytes in the sum. At the
// flagship training step (4 x 64 x 128 pixels, 128 -> 64 channels) the two
// products (u and dW) are 2 x 2 x 32768 x 1152 x 64 = 9.7 GFLOP, the sampling
// and the offset dot products another ~0.8 GFLOP, over ~47 MB of inputs and
// outputs: ~0.16 ms at 67 TFLOP/s. The records add 151 MB of rows written
// here and read by the sum (each row once for each of its in-map corners),
// ~0.2 ms of memory traffic that the atomic versions did not have: the
// price of a fixed order.
//
// Design, two routes chosen by the caller from the channel counts:
//  * route 1, Cin a multiple of 32 and Cout = 64 (every model of the repo):
//    one fused pass, then one small reduction. Both products run on the
//    tensor cores as 3xTF32 (deform_common.cuh; fp32-level results, fp32
//    accumulators). A block of 8 warps owns one 32-channel slice of Cin
//    and one row of three taps, whose W_k slices it keeps in shared
//    memory, and walks 64-pixel tiles in a fixed stride (a persistent
//    grid, three blocks an SM: 80 registers, 64 KB of shared memory). Per
//    tile it stages g once, and per tap it forms u (64 x 32) = g W_k^T with
//    mma.sync into shared memory, and then reads every corner exactly once:
//    8 lanes hold a pixel's 32 channels as float4, so a warp handles four
//    pixels and reads whole 128-byte lines; from the one read come the two
//    offset dot products (reduced over the 8 lanes by shuffles and stored
//    per channel slice) and the bilinear sample, which goes to shared
//    memory as the 64 x 32 operand of dW_k += sample^T g; the same lanes
//    store the u row's slice, and the blocks of the first channel slice
//    store the corner records. The next tap's offsets are fetched while the
//    corners are read and its corner records are written behind the
//    barrier, so two barriers a tap suffice. The dW accumulators of the
//    block's three taps (24 registers a thread) stay in registers across
//    all its tiles, so one partial per block is written; the reduction
//    kernel adds the partials, and the channel slices of doff, in a fixed
//    order. Splitting the taps over blocks is what keeps the accumulators
//    small: one block for all nine taps needed 72 and spilled. Rows in
//    shared memory are padded, and the pixel order inside the dW product's
//    depth is permuted, so that all fragment loads are free of bank
//    conflicts.
//  * route 0, any other channel counts (scalar loads where Cin % 4 != 0):
//    the first version, three launches: an input pass (32 pixels a block,
//    u by fp32 FMAs and stored as rows padded with zeros to a multiple of 4
//    channels, the corner records, one warp per pixel for the offset
//    gradients), a weight pass (a block per tap, 32 x 64 slice of dW and
//    pixel range, sampling as K1's general route does) and a fixed-order
//    sum of the weight pass's partials.

#include "deform_common.cuh"

namespace {

using deform::TapGeom;
using deform::tap_geometry;

// ---- route 0: general, fp32 FMAs ------------------------------------------
constexpr int THREADS = 256;
constexpr int TP = 32;      // output pixels per block, input pass
constexpr int PG = 16;      // pixels per thread in u = g W_k^T
constexpr int DW_PB = 64;   // pixels per tile, weight pass
constexpr int DW_CB = 32;   // input channels per block, weight pass
constexpr int DW_OB = 64;   // output channels per block, weight pass

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
    using T = float4;
    static __device__ __forceinline__ float dot(float4 a, float4 b) {
        return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
};
template <>
struct Vec<1> {
    using T = float;
    static __device__ __forceinline__ float dot(float a, float b) { return a * b; }
};

__host__ __device__ constexpr size_t input_pass_smem(int cin, int cout) {
    return (size_t)(TP * cout + TP * cin + cout * (cin + 1)) * sizeof(float) +
           (size_t)9 * TP * 4 * (sizeof(int) + sizeof(float));
}

// the corner records of (pixel pg, tap k): flat corner pixels (-1 outside
// the map) and their bilinear weights
__device__ __forceinline__ void store_records(const TapGeom& t, int64_t pg, int k,
                                              int* __restrict__ corner_ids,
                                              float* __restrict__ corner_w) {
    const int64_t r = pg * 9 + k;
    *reinterpret_cast<int4*>(corner_ids + r * 4) =
        make_int4(t.idx[0], t.idx[1], t.idx[2], t.idx[3]);
    *reinterpret_cast<float4*>(corner_w + r * 4) =
        make_float4(deform::corner_weight(t, 0), deform::corner_weight(t, 1),
                    deform::corner_weight(t, 2), deform::corner_weight(t, 3));
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
deform_bwd_input_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                        const float* __restrict__ weight, const float* __restrict__ g,
                        float* __restrict__ u_rows, int* __restrict__ corner_ids,
                        float* __restrict__ corner_w, float* __restrict__ doff, int b,
                        int h, int w, int cin, int cout, int cpad) {
    using V = Vec<VEC>;
    using T = typename V::T;
    extern __shared__ __align__(16) float smem[];
    const int ws = cin + 1;                  // padded row of W_k^T
    float* sG = smem;                        // [TP][cout]
    float* sU = sG + TP * cout;              // [TP][cin]
    float* sW = sU + TP * cin;               // [cout][cin + 1]
    int* sIdx = reinterpret_cast<int*>(sW + cout * ws);          // [9][TP][4]
    float* sF = reinterpret_cast<float*>(sIdx + 9 * TP * 4);     // [9][TP][wy0 wy1 wx0 wx1]

    const int tid = threadIdx.x;
    const int64_t npix = (int64_t)b * h * w;
    const int64_t p0 = (int64_t)blockIdx.x * TP;

    for (int e = tid; e < 9 * TP; e += THREADS) {
        const int k = e / TP, p = e % TP;
        const int64_t pg = p0 + p;
        TapGeom t;
        if (pg < npix) {
            t = tap_geometry(offsets, pg, k, h, w);
            store_records(t, pg, k, corner_ids, corner_w);
        } else {
            t.idx[0] = t.idx[1] = t.idx[2] = t.idx[3] = -1;
            t.wy0 = t.wy1 = t.wx0 = t.wx1 = 0.f;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) sIdx[e * 4 + q] = t.idx[q];
        sF[e * 4 + 0] = t.wy0;
        sF[e * 4 + 1] = t.wy1;
        sF[e * 4 + 2] = t.wx0;
        sF[e * 4 + 3] = t.wx1;
    }
    for (int e = tid; e < TP * cout; e += THREADS) {
        const int64_t pg = p0 + e / cout;
        sG[e] = pg < npix ? g[pg * cout + e % cout] : 0.f;
    }

    const int lane = tid & 31, warp = tid >> 5;
    for (int k = 0; k < 9; ++k) {
        __syncthreads();  // the previous tap's readers of sW / sU are done
        for (int e = tid; e < cin * cout; e += THREADS) {
            const int c = e / cout, o = e % cout;
            sW[o * ws + c] = weight[((int64_t)k * cin + c) * cout + o];
        }
        __syncthreads();
        // u = g W_k^T: thread -> (channel c, group of PG pixels)
        for (int e = tid; e < cin * (TP / PG); e += THREADS) {
            const int c = e % cin, grp = e / cin;
            float acc[PG];
#pragma unroll
            for (int i = 0; i < PG; ++i) acc[i] = 0.f;
            for (int o = 0; o < cout; ++o) {
                const float wv = sW[o * ws + c];
#pragma unroll
                for (int i = 0; i < PG; ++i)
                    acc[i] = fmaf(sG[(grp * PG + i) * cout + o], wv, acc[i]);
            }
#pragma unroll
            for (int i = 0; i < PG; ++i) sU[(grp * PG + i) * cin + c] = acc[i];
        }
        __syncthreads();
        // the tap's u rows, padded with zeros to cpad channels
        for (int e = tid; e < TP * cpad; e += THREADS) {
            const int p = e / cpad, c = e % cpad;
            const int64_t pg = p0 + p;
            if (pg < npix) u_rows[(pg * 9 + k) * cpad + c] = c < cin ? sU[p * cin + c] : 0.f;
        }
        // one warp per pixel: the offset gradients
        for (int p = warp; p < TP; p += THREADS / 32) {
            const int64_t pg = p0 + p;
            if (pg >= npix) continue;
            const int* id = sIdx + (k * TP + p) * 4;
            const float* f = sF + (k * TP + p) * 4;
            const float wy[2] = {f[0], f[1]}, wx[2] = {f[2], f[3]};
            float py = 0.f, px = 0.f;
            for (int cv = lane; cv < cin / VEC; cv += 32) {
                const T u = *reinterpret_cast<const T*>(sU + p * cin + cv * VEC);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (id[q] < 0) continue;
                    const int qy = q >> 1, qx = q & 1;
                    const T v = *reinterpret_cast<const T*>(x + (int64_t)id[q] * cin + cv * VEC);
                    const float d = V::dot(u, v);
                    py += (qy ? wx[qx] : -wx[qx]) * d;
                    px += (qx ? wy[qy] : -wy[qy]) * d;
                }
            }
#pragma unroll
            for (int s = 16; s > 0; s >>= 1) {
                py += __shfl_xor_sync(0xffffffffu, py, s);
                px += __shfl_xor_sync(0xffffffffu, px, s);
            }
            if (lane == 0) {
                doff[pg * 18 + 2 * k] = py;
                doff[pg * 18 + 2 * k + 1] = px;
            }
        }
    }
}

__global__ void __launch_bounds__(THREADS)
deform_bwd_weight_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                         const float* __restrict__ g, float* __restrict__ partial,
                         int b, int h, int w, int cin, int cout,
                         long long pix_per_split) {
    __shared__ int s_idx[DW_PB][4];
    __shared__ float s_wt[DW_PB][4];
    __shared__ float s_samp[DW_PB][DW_CB + 1];
    __shared__ __align__(16) float s_g[DW_PB][DW_OB];

    const int tid = threadIdx.x;
    const int cblocks = (cin + DW_CB - 1) / DW_CB;
    const int oblocks = (cout + DW_OB - 1) / DW_OB;
    int bx = blockIdx.x;
    const int ob = bx % oblocks;
    bx /= oblocks;
    const int cb = bx % cblocks;
    const int k = bx / cblocks;
    const int c0 = cb * DW_CB, o0 = ob * DW_OB;
    const int64_t npix = (int64_t)b * h * w;
    const int64_t pbeg = (int64_t)blockIdx.y * pix_per_split;
    const int64_t pend = min(npix, pbeg + (int64_t)pix_per_split);

    const int tc = tid / 8;        // input channel c0 + tc
    const int to = (tid % 8) * 8;  // output channels o0 + to .. + 7
    float acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = 0.f;

    for (int64_t pc = pbeg; pc < pend; pc += DW_PB) {
        for (int p = tid; p < DW_PB; p += THREADS) {
            const int64_t pg = pc + p;
            if (pg < pend) {
                const TapGeom t = tap_geometry(offsets, pg, k, h, w);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    s_idx[p][q] = t.idx[q];
                    s_wt[p][q] = t.idx[q] >= 0
                        ? __fmul_rn((q >> 1) ? t.wy1 : t.wy0, (q & 1) ? t.wx1 : t.wx0)
                        : 0.f;
                }
            } else {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    s_idx[p][q] = -1;
                    s_wt[p][q] = 0.f;
                }
            }
        }
        __syncthreads();
        for (int e = tid; e < DW_PB * DW_CB; e += THREADS) {
            const int c = e % DW_CB, p = e / DW_CB;
            const int ch = c0 + c;
            float v = 0.f;
            if (ch < cin) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int id = s_idx[p][q];
                    if (id >= 0) v += x[(int64_t)id * cin + ch] * s_wt[p][q];
                }
            }
            s_samp[p][c] = v;
        }
        for (int e = tid; e < DW_PB * DW_OB; e += THREADS) {
            const int o = e % DW_OB, p = e / DW_OB;
            const int64_t pg = pc + p;
            const int oc = o0 + o;
            s_g[p][o] = (pg < pend && oc < cout) ? g[pg * cout + oc] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int p = 0; p < DW_PB; ++p) {
            const float s = s_samp[p][tc];
            const float4 a = *reinterpret_cast<const float4*>(&s_g[p][to]);
            const float4 c = *reinterpret_cast<const float4*>(&s_g[p][to + 4]);
            acc[0] = fmaf(s, a.x, acc[0]);
            acc[1] = fmaf(s, a.y, acc[1]);
            acc[2] = fmaf(s, a.z, acc[2]);
            acc[3] = fmaf(s, a.w, acc[3]);
            acc[4] = fmaf(s, c.x, acc[4]);
            acc[5] = fmaf(s, c.y, acc[5]);
            acc[6] = fmaf(s, c.z, acc[6]);
            acc[7] = fmaf(s, c.w, acc[7]);
        }
        __syncthreads();
    }

    const int ch = c0 + tc;
    if (ch >= cin) return;
    float* dst = partial + (int64_t)blockIdx.y * 9 * cin * cout +
                 ((int64_t)k * cin + ch) * cout;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int oc = o0 + to + j;
        if (oc < cout) dst[oc] = acc[j];
    }
}

__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, long long n, int nsplit) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i >= n) return;
    float s = 0.f;
    for (int j = 0; j < nsplit; ++j) s += partial[(long long)j * n + i];
    out[i] = s;
}

template <int VEC>
cudaError_t launch_input_pass(const float* x, const float* off, const float* wt,
                              const float* g, float* u_rows, int* corner_ids,
                              float* corner_w, float* doff, int b, int h, int w,
                              int cin, int cout, int cpad, cudaStream_t s) {
    const size_t smem = input_pass_smem(cin, cout);
    cudaError_t err = cudaFuncSetAttribute(deform_bwd_input_kernel<VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const long long npix = (long long)b * h * w;
    deform_bwd_input_kernel<VEC><<<(unsigned)((npix + TP - 1) / TP), THREADS, smem, s>>>(
        x, off, wt, g, u_rows, corner_ids, corner_w, doff, b, h, w, cin, cout, cpad);
    return cudaGetLastError();
}

// ---- route 1: Cin % 32 == 0, Cout == 64, fused, 3xTF32 --------------------
constexpr int F_P = 64;         // pixels per tile
constexpr int F_CC = 32;        // input channels per block
constexpr int F_N = 64;         // output channels
constexpr int F_TAPS = 3;       // taps per block: one row of the 3 x 3 window
constexpr int F_GS = F_N + 4;   // padded row of g [pixel][out] and W_k [channel][out]
constexpr int F_US = F_CC + 4;  // padded row of u and the samples [pixel][channel]
constexpr size_t F_SMEM =
    (size_t)(F_TAPS * F_CC * F_GS + F_P * F_GS + 2 * F_P * F_US + 2 * F_P * 4) *
    sizeof(float);

// threads 0 .. 63 own one pixel of the tile each: its offset of tap k ...
__device__ __forceinline__ void load_tap_offset(const float* __restrict__ offsets,
                                                int64_t p0, int64_t npix, int k, float& dy,
                                                float& dxo) {
    const int64_t pg = p0 + threadIdx.x;
    if (threadIdx.x < F_P && pg < npix) {
        const float2 o = __ldg(reinterpret_cast<const float2*>(offsets + pg * 18 + 2 * k));
        dy = o.x;
        dxo = o.y;
    }
}

// ... and its corner record (flat corner pixels, -1 outside; wy0 wy1 wx0 wx1),
// which the blocks of the first channel slice also store for the input
// gradient's sum
__device__ __forceinline__ void store_tap_geometry(float dy, float dxo, int64_t p0,
                                                   int64_t npix, int k, int h, int w,
                                                   int* sIdx, float* sF, bool records,
                                                   int* __restrict__ corner_ids,
                                                   float* __restrict__ corner_w) {
    if (threadIdx.x >= F_P) return;
    const int64_t pg = p0 + threadIdx.x;
    int4 id = make_int4(-1, -1, -1, -1);
    float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
    if (pg < npix) {
        const TapGeom tg = deform::tap_geometry_at(dy, dxo, pg, k, h, w);
        id = make_int4(tg.idx[0], tg.idx[1], tg.idx[2], tg.idx[3]);
        f = make_float4(tg.wy0, tg.wy1, tg.wx0, tg.wx1);
        if (records) store_records(tg, pg, k, corner_ids, corner_w);
    }
    *reinterpret_cast<int4*>(sIdx + threadIdx.x * 4) = id;
    *reinterpret_cast<float4*>(sF + threadIdx.x * 4) = f;
}

// One step of depth 8 of a 16 x 16 warp tile: the A fragment from rows
// `a`, `a + a_row8` (8 rows on) and depth slots `a`, `a + a_k4`; the B
// fragments of the two 8-wide column tiles from `bp`, `bp + b_n8`, depth
// slots `bp`, `bp + b_k4`.
__device__ __forceinline__ void warp_step(float (&d)[1][2][4], const float* a, int a_row8,
                                          int a_k4, const float* bp, int b_n8, int b_k4) {
    uint32_t ahi[1][4], alo[1][4], bhi[2][2], blo[2][2];
    deform::split_tf32(a[0], ahi[0][0], alo[0][0]);
    deform::split_tf32(a[a_row8], ahi[0][1], alo[0][1]);
    deform::split_tf32(a[a_k4], ahi[0][2], alo[0][2]);
    deform::split_tf32(a[a_row8 + a_k4], ahi[0][3], alo[0][3]);
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
        deform::split_tf32(bp[ni * b_n8], bhi[ni][0], blo[ni][0]);
        deform::split_tf32(bp[ni * b_n8 + b_k4], bhi[ni][1], blo[ni][1]);
    }
    deform::mma_3xtf32(d, ahi, alo, bhi, blo);
}

__global__ void __launch_bounds__(THREADS, 3)
deform_bwd_fused_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                        const float* __restrict__ weight, const float* __restrict__ g,
                        float* __restrict__ u_rows, int* __restrict__ corner_ids,
                        float* __restrict__ corner_w, float* __restrict__ doff_part,
                        float* __restrict__ dw_part, int b, int h, int w, int cin,
                        int ngroups) {
    extern __shared__ __align__(16) float fsm[];
    float* sW = fsm;                        // [3 taps][32 channels][F_GS]
    float* sG = sW + F_TAPS * F_CC * F_GS;  // [64 pixels][F_GS]
    float* sU = sG + F_P * F_GS;            // [64 pixels][F_US]
    float* sS = sU + F_P * F_US;            // [64 pixels][F_US]
    int* sIdx = reinterpret_cast<int*>(sS + F_P * F_US);      // [64][4 corners]
    float* sF = reinterpret_cast<float*>(sIdx + F_P * 4);     // [64][wy0 wy1 wx0 wx1]

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int gq = lane >> 2, t = lane & 3;
    const int cchunks = cin / F_CC;
    const int chunk = blockIdx.x % cchunks;
    const int k0 = (blockIdx.x / cchunks) % 3 * F_TAPS;
    const int group = blockIdx.x / (cchunks * 3);
    const int cbase = chunk * F_CC;
    const bool records = chunk == 0;
    const int64_t npix = (int64_t)b * h * w;
    const int64_t ntiles = (npix + F_P - 1) / F_P;
    // u product: warp tile 16 pixels x 16 channels; dW product: 16 channels x 16 outputs
    const int um = (warp & 3) * 16, un = (warp >> 2) * 16;
    const int dm = (warp & 1) * 16, dn = (warp >> 1) * 16;
    const int cp = lane >> 3, cc = (lane & 7) * 4;  // corner phase: pixel of 4, channels

    // W_k[cbase : cbase + 32, :] of the block's three taps, once
#pragma unroll
    for (int j = 0; j < 2 * F_TAPS; ++j) {
        const int piece = tid + j * THREADS;  // 3 x 512 pieces of 16 bytes
        const int row = piece / 16, c4 = piece % 16;  // row = tap * 32 + channel
        *reinterpret_cast<float4*>(sW + row * F_GS + c4 * 4) = deform::ldg4(
            weight + ((int64_t)(k0 + row / F_CC) * cin + cbase + row % F_CC) * F_N + c4 * 4);
    }

    float acc[F_TAPS][2][4];
#pragma unroll
    for (int j = 0; j < F_TAPS; ++j)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc[j][ni][r] = 0.f;

    for (int64_t tile = group; tile < ntiles; tile += ngroups) {
        const int64_t p0 = tile * F_P;
        __syncthreads();  // the previous tile's dW product has read sG and sS
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int piece = tid + j * THREADS;  // 1024 pieces of 16 bytes
            const int row = piece / 16, c4 = piece % 16;
            const int64_t pg = p0 + row;
            *reinterpret_cast<float4*>(sG + row * F_GS + c4 * 4) =
                pg < npix ? deform::ldg4(g + pg * F_N + c4 * 4)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        {
            float dy = 0.f, dxo = 0.f;
            load_tap_offset(offsets, p0, npix, k0, dy, dxo);
            store_tap_geometry(dy, dxo, p0, npix, k0, h, w, sIdx, sF, records,
                               corner_ids, corner_w);
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < F_TAPS; ++j) {
            const int k = k0 + j;
            // u (64 x 32) = g (64 x 64) W_k^T, even and odd depth steps apart
            {
                float u[2][1][2][4];
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                        for (int r = 0; r < 4; ++r) u[e][0][ni][r] = 0.f;
#pragma unroll
                for (int kk = 0; kk < F_N; kk += 8)
                    warp_step(u[(kk >> 3) & 1], sG + (um + gq) * F_GS + kk + t, 8 * F_GS, 4,
                              sW + (j * F_CC + un + gq) * F_GS + kk + t, 8 * F_GS, 4);
#pragma unroll
                for (int ni = 0; ni < 2; ++ni) {
                    float* dst = sU + (um + gq) * F_US + un + ni * 8 + 2 * t;
                    *reinterpret_cast<float2*>(dst) =
                        make_float2(u[0][0][ni][0] + u[1][0][ni][0],
                                    u[0][0][ni][1] + u[1][0][ni][1]);
                    *reinterpret_cast<float2*>(dst + 8 * F_US) =
                        make_float2(u[0][0][ni][2] + u[1][0][ni][2],
                                    u[0][0][ni][3] + u[1][0][ni][3]);
                }
            }
            __syncthreads();  // sU is whole

            // the next tap's offsets start their way now
            float dyn = 0.f, dxn = 0.f;
            if (j + 1 < F_TAPS) load_tap_offset(offsets, p0, npix, k + 1, dyn, dxn);

            // every corner once: offset gradients and the sample; the u row
#pragma unroll
            for (int r = 0; r < 2; ++r) {
                const int p = r * 32 + warp * 4 + cp;
                const int64_t pg = p0 + p;
                const int4 id4 = *reinterpret_cast<const int4*>(sIdx + p * 4);
                const float4 f = *reinterpret_cast<const float4*>(sF + p * 4);
                const float4 u4 = *reinterpret_cast<const float4*>(sU + p * F_US + cc);
                const int ids[4] = {id4.x, id4.y, id4.z, id4.w};
                const float wy[2] = {f.x, f.y}, wx[2] = {f.z, f.w};
                float4 v[4];
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    v[q] = ids[q] >= 0
                               ? deform::ldg4(x + (int64_t)ids[q] * cin + cbase + cc)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
                float py = 0.f, px = 0.f;
                float4 smp = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (ids[q] < 0) continue;
                    const int qy = q >> 1, qx = q & 1;
                    const float d = u4.x * v[q].x + u4.y * v[q].y + u4.z * v[q].z +
                                    u4.w * v[q].w;
                    py += (qy ? wx[qx] : -wx[qx]) * d;
                    px += (qx ? wy[qy] : -wy[qy]) * d;
                    const float wt = __fmul_rn(wy[qy], wx[qx]);
                    smp.x = fmaf(wt, v[q].x, smp.x);
                    smp.y = fmaf(wt, v[q].y, smp.y);
                    smp.z = fmaf(wt, v[q].z, smp.z);
                    smp.w = fmaf(wt, v[q].w, smp.w);
                }
#pragma unroll
                for (int s = 4; s > 0; s >>= 1) {
                    py += __shfl_xor_sync(0xffffffffu, py, s);
                    px += __shfl_xor_sync(0xffffffffu, px, s);
                }
                if (pg < npix) {
                    *reinterpret_cast<float4*>(u_rows + (pg * 9 + k) * cin + cbase + cc) = u4;
                    if ((lane & 7) == 0) {
                        float* dst = doff_part + ((int64_t)chunk * npix + pg) * 18 + 2 * k;
                        dst[0] = py;
                        dst[1] = px;
                    }
                }
                *reinterpret_cast<float4*>(sS + p * F_US + cc) = smp;
            }
            __syncthreads();  // sS is whole; sIdx, sF and sU are free
            if (j + 1 < F_TAPS)
                store_tap_geometry(dyn, dxn, p0, npix, k + 1, h, w, sIdx, sF, records,
                                   corner_ids, corner_w);

            // dW_k (32 x 64) += samples^T (32 x 64 pixels) g (64 pixels x 64);
            // depth slot t of a step is pixel 2t, slot t + 4 pixel 2t + 1. The
            // tile's product is summed from zero and added with rounded adds.
            // The next tap's u product follows with no barrier between.
            {
                float part[2][1][2][4];
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                        for (int r = 0; r < 4; ++r) part[e][0][ni][r] = 0.f;
#pragma unroll
                for (int kk = 0; kk < F_P; kk += 8)
                    warp_step(part[(kk >> 3) & 1], sS + (kk + 2 * t) * F_US + dm + gq, 8, F_US,
                              sG + (kk + 2 * t) * F_GS + dn + gq, 8, F_GS);
#pragma unroll
                for (int ni = 0; ni < 2; ++ni)
#pragma unroll
                    for (int r = 0; r < 4; ++r)
                        acc[j][ni][r] += part[0][0][ni][r] + part[1][0][ni][r];
            }
        }
    }

    // this block's partial of dW[k0 : k0 + 3, cbase : cbase + 32, :]
#pragma unroll
    for (int j = 0; j < F_TAPS; ++j)
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
            float* dst = dw_part + ((int64_t)group * 9 + k0 + j) * cin * F_N +
                         (int64_t)(cbase + dm + gq) * F_N + dn + ni * 8 + 2 * t;
            *reinterpret_cast<float2*>(dst) = make_float2(acc[j][ni][0], acc[j][ni][1]);
            *reinterpret_cast<float2*>(dst + 8 * F_N) =
                make_float2(acc[j][ni][2], acc[j][ni][3]);
        }
}

// dW = the blocks' partials, doff = the channel slices' partials, each added
// in index order
__global__ void fused_reduce_kernel(const float* __restrict__ dw_part,
                                    float* __restrict__ dweight, long long nw, int ngroups,
                                    const float* __restrict__ doff_part,
                                    float* __restrict__ doff, long long noff, int cchunks) {
    const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < nw) {
        float s = 0.f;
        for (int j = 0; j < ngroups; ++j) s += dw_part[(long long)j * nw + i];
        dweight[i] = s;
    } else if (i - nw < noff) {
        const long long e = i - nw;
        float s = 0.f;
        for (int j = 0; j < cchunks; ++j) s += doff_part[(long long)j * noff + e];
        doff[e] = s;
    }
}

}  // namespace

// Writes the input gradient's records (u_rows: B H W 9 x cpad floats, cpad
// = Cin on route 1 and Cin rounded up to a multiple of 4 on route 0, the pad
// zeros; corner_ids and corner_w: B H W 9 x 4), doff and dweight; dx is
// splat_topk(corner_w, u_rows, corner_ids, B H W), taken by the caller.
// route 0: `scratch` holds nsplit x 9 Cin Cout floats (the weight pass's
// partials). route 1 (Cin % 32 == 0, Cout == 64): nsplit is the number of
// pixel-tile groups (blocks = groups x Cin / 32 x 3 tap rows) and `scratch`
// holds nsplit x 9 Cin Cout + (Cin / 32) x B H W x 18 floats.
extern "C" int deform_conv3x3_bwd_f32(const void* x, const void* offsets,
                                      const void* weight, const void* g,
                                      void* u_rows, void* corner_w, void* corner_ids,
                                      void* doff, void* dweight, void* scratch, int b,
                                      int h, int w, int cin, int cout, int cpad,
                                      int nsplit, int route, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long npix = (long long)b * h * w;
    const long long nw = 9LL * cin * cout;
    cudaError_t err;
    if (npix == 0 || nw == 0) {
        err = cudaMemsetAsync(doff, 0, (size_t)npix * 18 * sizeof(float), s);
        if (err != cudaSuccess) return (int)err;
        err = cudaMemsetAsync(u_rows, 0, (size_t)npix * 9 * cpad * sizeof(float), s);
        if (err != cudaSuccess) return (int)err;
        err = cudaMemsetAsync(corner_ids, 0xff, (size_t)npix * 36 * sizeof(int), s);
        if (err != cudaSuccess) return (int)err;
        return (int)cudaMemsetAsync(dweight, 0, (size_t)nw * sizeof(float), s);
    }
    if (nsplit < 1) return (int)cudaErrorInvalidValue;
    const auto* xf = static_cast<const float*>(x);
    const auto* of = static_cast<const float*>(offsets);
    const auto* wf = static_cast<const float*>(weight);
    const auto* gf = static_cast<const float*>(g);
    auto* uf = static_cast<float*>(u_rows);
    auto* cw = static_cast<float*>(corner_w);
    auto* ci = static_cast<int*>(corner_ids);
    if (route == 1) {
        if (cin % F_CC != 0 || cout != F_N || cpad != cin) return (int)cudaErrorInvalidValue;
        const int cchunks = cin / F_CC;
        float* dw_part = static_cast<float*>(scratch);
        float* doff_part = dw_part + (long long)nsplit * nw;
        static bool configured = false;  // more than 48 KB of shared memory: opt in once
        if (!configured) {
            err = cudaFuncSetAttribute(deform_bwd_fused_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)F_SMEM);
            if (err != cudaSuccess) return (int)err;
            configured = true;
        }
        deform_bwd_fused_kernel<<<(unsigned)(nsplit * cchunks * 3), THREADS, F_SMEM, s>>>(
            xf, of, wf, gf, uf, ci, cw, doff_part, dw_part, b, h, w, cin, nsplit);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        const long long noff = npix * 18, n = nw + noff;
        fused_reduce_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(
            dw_part, static_cast<float*>(dweight), nw, nsplit, doff_part,
            static_cast<float*>(doff), noff, cchunks);
        return (int)cudaGetLastError();
    }
    if (route != 0 || cpad < cin || cpad % 4 != 0 ||
        input_pass_smem(cin, cout) > 227 * 1024) {
        return (int)cudaErrorInvalidValue;
    }
    err = cin % 4 == 0
              ? launch_input_pass<4>(xf, of, wf, gf, uf, ci, cw, static_cast<float*>(doff),
                                     b, h, w, cin, cout, cpad, s)
              : launch_input_pass<1>(xf, of, wf, gf, uf, ci, cw, static_cast<float*>(doff),
                                     b, h, w, cin, cout, cpad, s);
    if (err != cudaSuccess) return (int)err;

    const long long per_split = (npix + nsplit - 1) / nsplit;
    const int cblocks = (cin + DW_CB - 1) / DW_CB;
    const int oblocks = (cout + DW_OB - 1) / DW_OB;
    dim3 grid((unsigned)(9 * cblocks * oblocks), (unsigned)nsplit);
    deform_bwd_weight_kernel<<<grid, THREADS, 0, s>>>(
        xf, of, gf, static_cast<float*>(scratch), b, h, w, cin, cout, per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    sum_splits_kernel<<<(unsigned)((nw + THREADS - 1) / THREADS), THREADS, 0, s>>>(
        static_cast<const float*>(scratch), static_cast<float*>(dweight), nw, nsplit);
    return (int)cudaGetLastError();
}

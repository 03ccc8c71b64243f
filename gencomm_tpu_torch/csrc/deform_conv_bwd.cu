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
// The offsets are used as given (pre-clamped by the caller, not re-clipped).
//
// What bounds it on Hopper: operations. At the flagship training step
// (4 x 64 x 128 pixels, 128 -> 64 channels) the two products (u and dW) are
// 2 x 2 x 32768 x 1152 x 64 = 9.7 GFLOP, the sampling and the offset dot
// products another ~0.8 GFLOP, over ~47 MB: ~220 FLOP per byte, above the
// fp32 ridge point, so the products are the limit (~0.16 ms at 67 TFLOP/s).
//
// Design, three launches after one memset of dx:
//  1. input pass: a block owns 32 output pixels. It precomputes their 4
//     corner addresses and bilinear factors for all 9 taps, then per tap
//     stages W_k transposed in shared memory (rows padded by one float so
//     both the transposing writes and the reads are conflict-free), forms u
//     for its 32 pixels (each thread 16 pixels x 1 channel, fp32 FMAs), and
//     walks its pixels one warp each: lanes hold 4 consecutive channels, read
//     each in-map corner's row (coalesced), accumulate the two offset dot
//     products (a warp reduction per pixel and tap, written by a plain
//     store), and add w_q u into dx with float4 atomics (Hopper's vector
//     atomics; the order of the sums varies between runs).
//  2. weight pass: a block owns one tap, 32 input x 64 output channels of
//     dW and a contiguous range of pixels; it samples 64-pixel tiles of its
//     channels (as K1 does), stages the matching g tile and accumulates
//     sample^T g in registers (8 outputs a thread), then writes its partial.
//  3. the partials are summed per element in a fixed order, so dW is the
//     same from run to run.
// Tensor cores are left to a later change: this version keeps full fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TP = 32;      // output pixels per block, input pass
constexpr int PG = 16;      // pixels per thread in u = g W_k^T
constexpr int DW_PB = 64;   // pixels per tile, weight pass
constexpr int DW_CB = 32;   // input channels per block, weight pass
constexpr int DW_OB = 64;   // output channels per block, weight pass

struct TapGeom {
    int idx[4];  // flat pixel of corners (y0,x0), (y0,x1), (y1,x0), (y1,x1); -1 outside
    float wy0, wy1, wx0, wx1;
};

// the sampling position of tap k at pixel pg, rounded as K1 and the plain
// version round it
__device__ __forceinline__ TapGeom tap_geometry(const float* __restrict__ offsets,
                                                int64_t pg, int k, int h, int w) {
    TapGeom t;
    const int64_t hw = (int64_t)h * w;
    const int bi = (int)(pg / hw);
    const int rem = (int)(pg % hw);
    const int hi = rem / w, wi = rem % w;
    const float dy = offsets[pg * 18 + 2 * k];
    const float dx = offsets[pg * 18 + 2 * k + 1];
    const float y = __fadd_rn((float)(hi + k / 3 - 1), dy);
    const float x = __fadd_rn((float)(wi + k % 3 - 1), dx);
    const float y0 = floorf(y), x0 = floorf(x);
    t.wy1 = __fsub_rn(y, y0);
    t.wx1 = __fsub_rn(x, x0);
    t.wy0 = __fsub_rn(1.0f, t.wy1);
    t.wx0 = __fsub_rn(1.0f, t.wx1);
    const int iy0 = (int)y0, ix0 = (int)x0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int iy = iy0 + (q >> 1), ix = ix0 + (q & 1);
        t.idx[q] = (iy >= 0 && iy <= h - 1 && ix >= 0 && ix <= w - 1)
                       ? (bi * h + iy) * w + ix
                       : -1;
    }
    return t;
}

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
    using T = float4;
    static __device__ __forceinline__ float dot(float4 a, float4 b) {
        return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
    }
    static __device__ __forceinline__ void add_scaled(float* dst, float s, float4 u) {
        atomicAdd(reinterpret_cast<float4*>(dst),
                  make_float4(s * u.x, s * u.y, s * u.z, s * u.w));
    }
};
template <>
struct Vec<1> {
    using T = float;
    static __device__ __forceinline__ float dot(float a, float b) { return a * b; }
    static __device__ __forceinline__ void add_scaled(float* dst, float s, float u) {
        atomicAdd(dst, s * u);
    }
};

__host__ __device__ constexpr size_t input_pass_smem(int cin, int cout) {
    return (size_t)(TP * cout + TP * cin + cout * (cin + 1)) * sizeof(float) +
           (size_t)9 * TP * 4 * (sizeof(int) + sizeof(float));
}

template <int VEC>
__global__ void __launch_bounds__(THREADS)
deform_bwd_input_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                        const float* __restrict__ weight, const float* __restrict__ g,
                        float* __restrict__ dx, float* __restrict__ doff, int b,
                        int h, int w, int cin, int cout) {
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
        // one warp per pixel: offset gradients and the dx scatter
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
                    V::add_scaled(dx + (int64_t)id[q] * cin + cv * VEC,
                                  __fmul_rn(wy[qy], wx[qx]), u);
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
                              const float* g, float* dx, float* doff, int b,
                              int h, int w, int cin, int cout, cudaStream_t s) {
    const size_t smem = input_pass_smem(cin, cout);
    cudaError_t err = cudaFuncSetAttribute(deform_bwd_input_kernel<VEC>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const long long npix = (long long)b * h * w;
    deform_bwd_input_kernel<VEC><<<(unsigned)((npix + TP - 1) / TP), THREADS, smem, s>>>(
        x, off, wt, g, dx, doff, b, h, w, cin, cout);
    return cudaGetLastError();
}

}  // namespace

extern "C" int deform_conv3x3_bwd_f32(const void* x, const void* offsets,
                                      const void* weight, const void* g,
                                      void* dx, void* doff, void* dweight,
                                      void* scratch, int b, int h, int w,
                                      int cin, int cout, int nsplit,
                                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long npix = (long long)b * h * w;
    const long long nw = 9LL * cin * cout;
    cudaError_t err = cudaMemsetAsync(dx, 0, (size_t)npix * cin * sizeof(float), s);
    if (err != cudaSuccess) return (int)err;
    if (npix == 0 || nw == 0) {
        return (int)cudaMemsetAsync(dweight, 0, (size_t)nw * sizeof(float), s);
    }
    if (input_pass_smem(cin, cout) > 227 * 1024 || nsplit < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const auto* xf = static_cast<const float*>(x);
    const auto* of = static_cast<const float*>(offsets);
    const auto* wf = static_cast<const float*>(weight);
    const auto* gf = static_cast<const float*>(g);
    err = cin % 4 == 0
              ? launch_input_pass<4>(xf, of, wf, gf, static_cast<float*>(dx),
                                     static_cast<float*>(doff), b, h, w, cin, cout, s)
              : launch_input_pass<1>(xf, of, wf, gf, static_cast<float*>(dx),
                                     static_cast<float*>(doff), b, h, w, cin, cout, s);
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

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
// card, so the contraction, not the gather, is the limit.
//
// Design: no one-hot matrices; the corners are read directly. A block owns
// a tile of 64 output pixels x 64 output channels (256 threads, a 4 x 4
// register tile each). At the start it computes, for each of its pixels and
// each of the 9 taps, the 4 corner addresses (or -1 outside the map) and
// bilinear weights into shared memory. It then walks (tap, 32-channel chunk)
// pairs: the threads sample a 64 x 32 tile of the 9*Cin-wide sampled row
// (consecutive threads read consecutive channels of a corner, so the reads
// are coalesced), stage the matching 32 x 64 slice of the weight, and run a
// fp32 FMA loop over the chunk. Tensor cores (mma / wgmma on TF32 or bf16)
// are left to a later change: this version keeps full fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TP = 64;       // output pixels per block
constexpr int TC = 64;       // output channels per block
constexpr int KC = 32;       // input channels per chunk
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
deform_conv3x3_kernel(const float* __restrict__ x, const float* __restrict__ offsets,
                      const float* __restrict__ weight, float* __restrict__ out,
                      int b, int h, int w, int cin, int cout) {
    __shared__ int s_idx[9][TP][4];
    __shared__ float s_wt[9][TP][4];
    __shared__ float s_samp[KC][TP + 1];
    __shared__ __align__(16) float s_w[KC][TC];

    const int tid = threadIdx.x;
    const int64_t npix = (int64_t)b * h * w;
    const int64_t p0 = (int64_t)blockIdx.x * TP;
    const int o0 = blockIdx.y * TC;

    // corner addresses and weights for every (tap, pixel) of the tile
    for (int e = tid; e < 9 * TP; e += THREADS) {
        const int k = e / TP, p = e % TP;
        const int64_t pg = p0 + p;
        int idx[4] = {-1, -1, -1, -1};
        float wt[4] = {0.f, 0.f, 0.f, 0.f};
        if (pg < npix) {
            const int bi = (int)(pg / ((int64_t)h * w));
            const int hw = (int)(pg % ((int64_t)h * w));
            const int hi = hw / w, wi = hw % w;
            const float dy = offsets[pg * 18 + 2 * k];
            const float dx = offsets[pg * 18 + 2 * k + 1];
            const float y = __fadd_rn((float)(hi + k / 3 - 1), dy);
            const float xx = __fadd_rn((float)(wi + k % 3 - 1), dx);
            const float y0 = floorf(y), x0 = floorf(xx);
            const float wy1 = __fsub_rn(y, y0), wx1 = __fsub_rn(xx, x0);
            const float wy0 = __fsub_rn(1.0f, wy1), wx0 = __fsub_rn(1.0f, wx1);
            const int iy0 = (int)y0, ix0 = (int)x0;
            // corner order (y0,x0), (y0,x1), (y1,x0), (y1,x1), as in the plain version
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int iy = iy0 + (c >> 1), ix = ix0 + (c & 1);
                if (iy >= 0 && iy <= h - 1 && ix >= 0 && ix <= w - 1) {
                    idx[c] = ((bi * h + iy) * w + ix);
                    wt[c] = __fmul_rn((c >> 1) ? wy1 : wy0, (c & 1) ? wx1 : wx0);
                }
            }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            s_idx[k][p][c] = idx[c];
            s_wt[k][p][c] = wt[c];
        }
    }

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
                        const int id = s_idx[k][p][q];
                        if (id >= 0) v += x[(int64_t)id * cin + ch] * s_wt[k][p][q];
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
            if (oc < cout) out[pg * cout + oc] = acc[i][j];
        }
    }
}

}  // namespace

extern "C" int deform_conv3x3_f32(const void* x, const void* offsets,
                                  const void* weight, void* out, int b, int h,
                                  int w, int cin, int cout, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long npix = (long long)b * h * w;
    if (npix > 0 && cout > 0) {
        dim3 grid((unsigned)((npix + TP - 1) / TP), (unsigned)((cout + TC - 1) / TC));
        deform_conv3x3_kernel<<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(offsets),
            static_cast<const float*>(weight), static_cast<float*>(out), b, h,
            w, cin, cout);
    }
    return (int)cudaGetLastError();
}

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
// Design: a gather, not a scatter. Each source pixel (n, iy, ix) collects
// its own sum, so dsrc is written once with coalesced stores: no memset, no
// atomics, the same bits on every run. The output pixels that can touch
// (ix, iy) are those whose sample point (x, y) lies in [ix-1, ix+1) x
// [iy-1, iy+1). In pixel space (x + 0.5, y + 0.5) = M (xo + 0.5, yo + 0.5)
// + c with M = [[t0, t1 w/h], [t3 h/w, t4]], so the candidates are the
// integer points of the box that bounds the square's preimage under M,
// widened by a margin that covers the rounding of the coordinate chain and
// clipped to the map (`source_window`; `ops/warp.py:_source_window` is its
// PyTorch mirror). M^-1 and the margins are worked out once a block per
// sample, in double (`sample_box`); a singular M takes the whole map, so
// any theta is right and only a rigid one (every theta the system builds:
// 6-16 candidates) is fast. Each candidate is tested by recomputing (x, y)
// exactly as K3 does (`corner_weight`: the same non-contracting
// intrinsics), kept only if floor(x) is ix-1 or ix and floor(y) is iy-1 or
// iy, with that corner's weight; an over-wide window costs time, never
// correctness. Each channel's sum is fmaf over the kept candidates in
// raster order, from 0, on either route, so the two routes give the same
// bits. Two routes, chosen by the caller (ops/warp.py:backward_route):
//  * `warp` (wide maps): one warp owns four neighbouring source pixels: a
//    group of 8 lanes tests 8 of its pixel's candidates at a time, then the
//    whole warp sums each pixel's kept candidates, every lane holding one
//    4-channel vector (C % 4 == 0) or one channel of the four pixels' rows,
//    with two loads of each pixel in flight (eight a lane); one or two
//    pixels a warp were slower on an H100.
//  * `pixel` (narrow maps, C <= PIXEL_MAX_CHANNELS): one thread owns one
//    source pixel, walks its own window in raster order and keeps its C
//    sums in registers, one store a channel; a block works out the
//    sampling coordinate of every output column and row once, into shared
//    memory, so a candidate costs no division. On a one-channel map the warp
//    route keeps one lane in 32 busy and pays two shuffles a kept
//    candidate, and its window search costs what a 128-channel map's does;
//    here every lane works and nothing crosses lanes. A one-channel map is
//    a few hundred KB, so the launch and the coordinate arithmetic, not
//    the bytes, bound this route.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int VEC>
struct Vec;
template <>
struct Vec<4> { using T = float4; };
template <>
struct Vec<1> { using T = float; };

__device__ __forceinline__ float4 fma_vec(float w, float4 v, float4 acc) {
    acc.x = fmaf(w, v.x, acc.x); acc.y = fmaf(w, v.y, acc.y);
    acc.z = fmaf(w, v.z, acc.z); acc.w = fmaf(w, v.w, acc.w);
    return acc;
}
__device__ __forceinline__ float fma_vec(float w, float v, float acc) {
    return fmaf(w, v, acc);
}
template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float4 zero<float4>() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

struct Window { int x0, x1, y0, y1; };  // inclusive output-pixel ranges

// What the window of every source pixel of one sample shares: M^-1, the
// offset c and the half-widths of the preimage box, margins included.
struct SampleBox { double i00, i01, i10, i11, c0, c1, eu, ev; bool full; };

__device__ SampleBox sample_box(const float* th, int h, int w) {
    const double t0 = th[0], t1 = th[1], t2 = th[2];
    const double t3 = th[3], t4 = th[4], t5 = th[5];
    const double fw = w, fh = h, aspect = fw / fh;
    const double m00 = t0, m01 = t1 * aspect, m10 = t3 / aspect, m11 = t4;
    SampleBox box;
    box.c0 = 0.5 * fw * (t2 + 1.0 - t0 - t1);
    box.c1 = 0.5 * fh * (t5 + 1.0 - t3 - t4);
    const double det = m00 * m11 - m01 * m10;
    box.full = !(fabs(det) > 0.0);
    const double inv = 1.0 / (box.full ? 1.0 : det);
    box.i00 = m11 * inv; box.i01 = -m01 * inv;
    box.i10 = -m10 * inv; box.i11 = m00 * inv;
    // the rounding of the fp32 coordinate chain, in source pixels (a wide
    // bound), carried back through M^-1
    const double delta = 1e-4 * (1.0 + fw * (fabs(t0) + fabs(t1) + fabs(t2) + 1.0)
                                 + fh * (fabs(t3) + fabs(t4) + fabs(t5) + 1.0));
    box.eu = (fabs(box.i00) + fabs(box.i01)) * (1.0 + delta) + 1e-3;
    box.ev = (fabs(box.i10) + fabs(box.i11)) * (1.0 + delta) + 1e-3;
    return box;
}

// The output pixels whose sample point can fall in [ix-1, ix+1) x
// [iy-1, iy+1), as a box in (xo, yo) clipped to the map.
__device__ Window source_window(const SampleBox& box, int h, int w, int ix,
                                int iy) {
    const Window full{0, w - 1, 0, h - 1};
    if (box.full) return full;
    const double fw = w, fh = h;
    const double xc = ix + 0.5 - box.c0, yc = iy + 0.5 - box.c1;
    const double uc = box.i00 * xc + box.i01 * yc - 0.5;
    const double vc = box.i10 * xc + box.i11 * yc - 0.5;
    const double lo_x = ceil(uc - box.eu), hi_x = floor(uc + box.eu);
    const double lo_y = ceil(vc - box.ev), hi_y = floor(vc + box.ev);
    if (!(isfinite(lo_x) && isfinite(hi_x) && isfinite(lo_y) && isfinite(hi_y)))
        return full;
    // a first index past the map or a last one before it: an empty box
    Window win;
    win.x0 = (int)fmin(fmax(lo_x, 0.0), fw);
    win.x1 = (int)fmax(fmin(hi_x, fw - 1.0), -1.0);
    win.y0 = (int)fmin(fmax(lo_y, 0.0), fh);
    win.y1 = (int)fmax(fmin(hi_y, fh - 1.0), -1.0);
    return win;
}

// The sampling coordinate of output column (or row) o on a map of `size`
// pixels, rounded step by step exactly as in K3
__device__ __forceinline__ float grid_coord(int o, float size) {
    return __fsub_rn(__fdiv_rn(__fadd_rn(2.0f * o, 1.0f), size), 1.0f);
}

// Whether source pixel (ix, iy) is a corner of the sample of the output
// pixel at grid coordinates (gx, gy), and that corner's bilinear weight:
// K3's coordinate chain, rounded step by step as there
__device__ __forceinline__ bool corner_weight(const float* th, float gx, float gy,
                                              float fw, float fh, int ix, int iy,
                                              float& wt) {
    const float sx = __fadd_rn(__fadd_rn(__fmul_rn(th[0], gx), __fmul_rn(th[1], gy)), th[2]);
    const float sy = __fadd_rn(__fadd_rn(__fmul_rn(th[3], gx), __fmul_rn(th[4], gy)), th[5]);
    // K3 divides by 2: a multiply by 0.5 gives the same bits
    const float x = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(sx, 1.0f), fw), 0.5f), 0.5f);
    const float y = __fsub_rn(__fmul_rn(__fmul_rn(__fadd_rn(sy, 1.0f), fh), 0.5f), 0.5f);
    const float x0 = floorf(x), y0 = floorf(y);
    const int kx = ix - (int)x0, ky = iy - (int)y0;
    if (!((kx == 0 || kx == 1) && (ky == 0 || ky == 1))) return false;
    const float wx1 = __fsub_rn(x, x0), wy1 = __fsub_rn(y, y0);
    const float wx0 = __fsub_rn(1.0f, wx1), wy0 = __fsub_rn(1.0f, wy1);
    wt = __fmul_rn(kx ? wx1 : wx0, ky ? wy1 : wy0);
    return true;
}

constexpr int PER_WARP = 4;                     // source pixels a warp
constexpr int GROUP = 32 / PER_WARP;            // lanes that test one pixel's candidates
constexpr int THREADS = 256;
constexpr int PIXELS = THREADS / 32 * PER_WARP;  // source pixels a block
constexpr int IN_FLIGHT = 2;                    // loads a pixel per step

template <int VEC>
__global__ void __launch_bounds__(THREADS, 6)  // <= 40 registers
warp_affine_bwd_kernel(const float* __restrict__ g,
                       const float* __restrict__ theta,
                       float* __restrict__ dsrc, int n, int h, int w,
                       int channels) {
    using T = typename Vec<VEC>::T;
    // the samples of this block's pixels (at most PIXELS), once a block
    __shared__ SampleBox boxes[PIXELS];
    const int lane = threadIdx.x & 31;
    const int64_t hw = (int64_t)h * w, total = (int64_t)n * hw;
    const int64_t first = (int64_t)blockIdx.x * PIXELS;
    const int b0 = (int)(first / hw);
    if (threadIdx.x < PIXELS) {
        const int64_t last = min(first + PIXELS, total) - 1;
        if (b0 + (int)threadIdx.x <= (int)(last / hw))
            boxes[threadIdx.x] = sample_box(theta + (b0 + threadIdx.x) * 6, h, w);
    }
    __syncthreads();
    // the warp's PER_WARP pixels; lane group `grp` tests pixel grp's candidates
    const int64_t wpix = first + (threadIdx.x >> 5) * PER_WARP;
    if (wpix >= total) return;  // whole warps leave together
    const int grp = lane / GROUP, gl = lane % GROUP;
    const int64_t pix = wpix + grp;
    const bool real = pix < total;
    const int ix = real ? (int)(pix % w) : 0;
    const int iy = real ? (int)((pix / w) % h) : 0;
    const int b = real ? (int)(pix / hw) : b0;
    Window win{0, -1, 0, -1};
    if (real) win = source_window(boxes[b - b0], h, w, ix, iy);
    const int bw = win.x1 - win.x0 + 1;
    const int ncand = (bw > 0 && win.y1 >= win.y0) ? bw * (win.y1 - win.y0 + 1) : 0;
    const int most = __reduce_max_sync(0xffffffffu, ncand);
    const float* th = theta + b * 6;
    const int nvec = channels / VEC;
    const float fw = (float)w, fh = (float)h;
    const T* gp[PER_WARP];
#pragma unroll
    for (int p = 0; p < PER_WARP; ++p)
        gp[p] = reinterpret_cast<const T*>(g)
              + (int64_t)__shfl_sync(0xffffffffu, b, p * GROUP) * hw * nvec;
    const unsigned group_bits = GROUP == 32 ? 0xffffffffu : (1u << GROUP) - 1u;

    for (int cv0 = 0; cv0 < nvec; cv0 += 32) {
        const int cv = cv0 + lane;
        T acc[PER_WARP];
#pragma unroll
        for (int p = 0; p < PER_WARP; ++p) acc[p] = zero<T>();
        for (int base = 0; base < most; base += GROUP) {
            // lane gl of group grp tests candidate base + gl, in raster order
            const int k = base + gl;
            bool member = false;
            float wt = 0.f;
            int opix = 0;
            if (k < ncand) {
                const int xo = win.x0 + k % bw, yo = win.y0 + k / bw;
                if (corner_weight(th, grid_coord(xo, fw), grid_coord(yo, fh), fw, fh,
                                  ix, iy, wt)) {
                    member = true;
                    opix = yo * w + xo;
                }
            }
            const unsigned ballot = __ballot_sync(0xffffffffu, member);
            unsigned mask[PER_WARP];
            bool any = false;
#pragma unroll
            for (int p = 0; p < PER_WARP; ++p) {
                mask[p] = (ballot >> (p * GROUP)) & group_bits;
                any |= mask[p] != 0u;
            }
            // each pixel's kept candidates in raster order, IN_FLIGHT loads a
            // pixel at a time
            while (any) {
                float wk[PER_WARP][IN_FLIGHT];
                int src[PER_WARP][IN_FLIGHT];
                T v[PER_WARP][IN_FLIGHT];
                any = false;
#pragma unroll
                for (int p = 0; p < PER_WARP; ++p) {
#pragma unroll
                    for (int j = 0; j < IN_FLIGHT; ++j) {
                        const int l = mask[p] ? __ffs(mask[p]) - 1 + p * GROUP : 0;
                        wk[p][j] = __shfl_sync(0xffffffffu, wt, l);
                        src[p][j] = __shfl_sync(0xffffffffu, opix, l);
                        if (!mask[p]) src[p][j] = -1;
                        mask[p] &= mask[p] - 1;
                    }
                    any |= mask[p] != 0u;
                }
#pragma unroll
                for (int p = 0; p < PER_WARP; ++p)
#pragma unroll
                    for (int j = 0; j < IN_FLIGHT; ++j)
                        v[p][j] = (src[p][j] >= 0 && cv < nvec)
                                      ? gp[p][(int64_t)src[p][j] * nvec + cv] : zero<T>();
#pragma unroll
                for (int p = 0; p < PER_WARP; ++p)
#pragma unroll
                    for (int j = 0; j < IN_FLIGHT; ++j)
                        if (src[p][j] >= 0) acc[p] = fma_vec(wk[p][j], v[p][j], acc[p]);
            }
        }
        if (cv < nvec) {
#pragma unroll
            for (int p = 0; p < PER_WARP; ++p)
                if (wpix + p < total)
                    reinterpret_cast<T*>(dsrc)[(wpix + p) * nvec + cv] = acc[p];
        }
    }
}

constexpr int PIXEL_THREADS = 256;      // source pixels a block, one a thread
constexpr int PIXEL_MAX_CHANNELS = 8;  // the widest map the pixel route takes
// the sampling coordinates of every output column and row, worked out
// once a block into shared memory, for maps with w + h up to this
constexpr int COORD_TABLE = 4096;

template <int C>
__global__ void __launch_bounds__(PIXEL_THREADS)
warp_affine_bwd_pixel_kernel(const float* __restrict__ g,
                             const float* __restrict__ theta,
                             float* __restrict__ dsrc, int n, int h, int w) {
    // the samples of this block's pixels (at most PIXEL_THREADS), once a
    // block, and grid_coord of each output column (then row)
    __shared__ SampleBox boxes[PIXEL_THREADS];
    __shared__ float coords[COORD_TABLE];
    const int64_t hw = (int64_t)h * w, total = (int64_t)n * hw;
    const int64_t first = (int64_t)blockIdx.x * PIXEL_THREADS;
    const int b0 = (int)(first / hw);
    const int64_t last = min(first + PIXEL_THREADS, total) - 1;
    if (b0 + (int)threadIdx.x <= (int)(last / hw))
        boxes[threadIdx.x] = sample_box(theta + (b0 + threadIdx.x) * 6, h, w);
    const float fw = (float)w, fh = (float)h;
    const bool table = w + h <= COORD_TABLE;
    if (table)
        for (int i = threadIdx.x; i < w + h; i += PIXEL_THREADS)
            coords[i] = i < w ? grid_coord(i, fw) : grid_coord(i - w, fh);
    __syncthreads();
    const int64_t pix = first + threadIdx.x;
    if (pix >= total) return;
    const int ix = (int)(pix % w), iy = (int)((pix / w) % h), b = (int)(pix / hw);
    const Window win = source_window(boxes[b - b0], h, w, ix, iy);
    float th[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) th[i] = theta[b * 6 + i];
    const float* gp = g + (int64_t)b * hw * C;
    float acc[C];
#pragma unroll
    for (int c = 0; c < C; ++c) acc[c] = 0.f;
    for (int yo = win.y0; yo <= win.y1; ++yo) {
        const float gy = table ? coords[w + yo] : grid_coord(yo, fh);
        for (int xo = win.x0; xo <= win.x1; ++xo) {
            const float gx = table ? coords[xo] : grid_coord(xo, fw);
            float wt;
            if (corner_weight(th, gx, gy, fw, fh, ix, iy, wt)) {
                const float* v = gp + ((int64_t)yo * w + xo) * C;
#pragma unroll
                for (int c = 0; c < C; ++c) acc[c] = fmaf(wt, v[c], acc[c]);
            }
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) dsrc[pix * C + c] = acc[c];
}

template <int C>
void launch_pixel(const void* g, const void* theta, void* dsrc, int n, int h,
                  int w, long long pixels, cudaStream_t s) {
    const unsigned blocks = (unsigned)((pixels + PIXEL_THREADS - 1) / PIXEL_THREADS);
    warp_affine_bwd_pixel_kernel<C><<<blocks, PIXEL_THREADS, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(theta),
        static_cast<float*>(dsrc), n, h, w);
}

}  // namespace

// route 0: `warp`, any channel count; route 1: `pixel`, at most
// PIXEL_MAX_CHANNELS channels (ops/warp.py mirrors both)
extern "C" int warp_affine_bwd_f32(const void* g, const void* theta, void* dsrc,
                                   int n, int h, int w, int channels, int route,
                                   void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const long long pixels = (long long)n * h * w;
    if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
    if (route == 1 && channels > PIXEL_MAX_CHANNELS) return (int)cudaErrorInvalidValue;
    if (pixels <= 0 || channels <= 0) return (int)cudaGetLastError();
    if (route == 1) {
        switch (channels) {
            case 1: launch_pixel<1>(g, theta, dsrc, n, h, w, pixels, s); break;
            case 2: launch_pixel<2>(g, theta, dsrc, n, h, w, pixels, s); break;
            case 3: launch_pixel<3>(g, theta, dsrc, n, h, w, pixels, s); break;
            case 4: launch_pixel<4>(g, theta, dsrc, n, h, w, pixels, s); break;
            case 5: launch_pixel<5>(g, theta, dsrc, n, h, w, pixels, s); break;
            case 6: launch_pixel<6>(g, theta, dsrc, n, h, w, pixels, s); break;
            case 7: launch_pixel<7>(g, theta, dsrc, n, h, w, pixels, s); break;
            default: launch_pixel<8>(g, theta, dsrc, n, h, w, pixels, s); break;
        }
        return (int)cudaGetLastError();
    }
    const unsigned blocks = (unsigned)((pixels + PIXELS - 1) / PIXELS);
    if (channels % 4 == 0)
        warp_affine_bwd_kernel<4><<<blocks, THREADS, 0, s>>>(
            static_cast<const float*>(g), static_cast<const float*>(theta),
            static_cast<float*>(dsrc), n, h, w, channels);
    else
        warp_affine_bwd_kernel<1><<<blocks, THREADS, 0, s>>>(
            static_cast<const float*>(g), static_cast<const float*>(theta),
            static_cast<float*>(dsrc), n, h, w, channels);
    return (int)cudaGetLastError();
}

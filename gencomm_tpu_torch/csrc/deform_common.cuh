// Shared by the deformable-conv kernels K1 (deform_conv.cu) and K1b
// (deform_conv_bwd.cu): the sampling position of a tap, rounded in one
// place so that forward, backward, the plain PyTorch version and the JAX
// package all land on the same corner at a cell boundary, and the
// tensor-core product both kernels use for their contractions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace deform {

struct TapGeom {
    int idx[4];  // flat pixel of corners (y0,x0), (y0,x1), (y1,x0), (y1,x1); -1 outside
    float wy0, wy1, wx0, wx1;
};

// the sampling position of tap k at pixel pg for the offset (dy, dx):
// y = (row + tap_y) + dy and x = (col + tap_x) + dx in round-to-nearest fp32
// with no FMA contraction, the fractions by exact subtraction
__device__ __forceinline__ TapGeom tap_geometry_at(float dy, float dx, int64_t pg, int k,
                                                   int h, int w) {
    TapGeom t;
    const int64_t hw = (int64_t)h * w;
    int bi, rem;
    if (pg <= 0x7fffffff && hw <= 0x7fffffff) {  // 32-bit division is several times cheaper
        bi = (int)((unsigned)pg / (unsigned)hw);
        rem = (int)((unsigned)pg - (unsigned)bi * (unsigned)hw);
    } else {
        bi = (int)(pg / hw);
        rem = (int)(pg % hw);
    }
    const int hi = rem / w, wi = rem - hi * w;
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

__device__ __forceinline__ TapGeom tap_geometry(const float* __restrict__ offsets,
                                                int64_t pg, int k, int h, int w) {
    return tap_geometry_at(offsets[pg * 18 + 2 * k], offsets[pg * 18 + 2 * k + 1], pg, k,
                           h, w);
}

// bilinear weight of corner q (0 where the corner lies outside the map)
__device__ __forceinline__ float corner_weight(const TapGeom& t, int q) {
    return t.idx[q] >= 0
               ? __fmul_rn((q >> 1) ? t.wy1 : t.wy0, (q & 1) ? t.wx1 : t.wx0)
               : 0.f;
}

// ---- 3xTF32: an fp32 product on the tensor cores --------------------------
// a = hi + lo with hi = a cut to tf32 (sign, exponent, 10 mantissa bits) and
// lo = a - hi, which is exact in fp32 and of which the tensor core again
// reads the top 19 bits. a*b is taken as lo*hi + hi*lo + hi*hi in fp32
// accumulators; what is dropped (lo*lo and the cut of lo) is below 2^-19 of
// the product, so the result stays at fp32 level where a single TF32 product
// would keep 10 mantissa bits. The split is two full-rate operations an
// element: both kernels are bound by instruction dispatch, and rounding hi and
// lo to nearest (`cvt.rna.tf32.f32`, a quarter-rate instruction, or an
// integer add before the cut) cost more time for errors that measured the
// same.

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
    hi = __float_as_uint(v) & 0xffffe000u;
    lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}

// d (16 x 8) += a (16 x 8, row-major fragment) * b (8 x 8, column fragment).
// Lane l holds, with g = l / 4 and t = l % 4:
//   a[0] = A[g][t], a[1] = A[g + 8][t], a[2] = A[g][t + 4], a[3] = A[g + 8][t + 4]
//   b[0] = B[t][g], b[1] = B[t + 4][g]
//   d[0] = D[g][2t], d[1] = D[g][2t + 1], d[2] = D[g + 8][2t], d[3] = D[g + 8][2t + 1]
// The tensor core truncates when it adds into d, so long sums are taken in
// short pieces from zero that are then added with rounded fp32 adds.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
    asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the three products of NT independent tiles d[i] += a[i / NB] * b[i % NB],
// emitted term by term so that successive mma never wait for each other
template <int NA, int NB>
__device__ __forceinline__ void mma_3xtf32(float (&d)[NA][NB][4],
                                           const uint32_t (&ahi)[NA][4],
                                           const uint32_t (&alo)[NA][4],
                                           const uint32_t (&bhi)[NB][2],
                                           const uint32_t (&blo)[NB][2]) {
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(d[i][j], alo[i], bhi[j]);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(d[i][j], ahi[i], blo[j]);
#pragma unroll
    for (int i = 0; i < NA; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j) mma_tf32(d[i][j], ahi[i], bhi[j]);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ float4 ldg4(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
}

}  // namespace deform

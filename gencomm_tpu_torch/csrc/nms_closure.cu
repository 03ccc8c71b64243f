// Greedy keep-set of the rotated NMS, on the device (kernel N1 of the port).
//
// Replaces: the `lax.while_loop` of gencomm_tpu/ops/nms.py:54-67 (the JAX
// package loops on the device; it is not a Pallas kernel). The port's plain
// version, ops/nms.py:nms_closure_plain, loops in Python and reads a device
// flag on the host every round, which a CUDA graph cannot capture.
//
// What it computes: given the (K, K) overlap matrix of the score-sorted boxes
// (overlap[j][i]: box j scores higher than box i and their IoU exceeds the
// threshold) and the sorted valid mask, the keep mask of sequential greedy
// NMS: box i is kept iff it is valid and no kept box j < i overlaps it. That
// is the keep-set of the plain version's round-parallel closure
// (gencomm_tpu/ops/nms.py:41-53 argues why), so the two masks are equal bit
// for bit.
//
// What bounds it on Hopper: neither bytes nor operations but the chain of
// decisions: box i can be decided only after every kept box before it. The
// least work is one read of the upper triangle of each kept box's row.
//
// Design: one launch, one block of 1024 threads.
//  1. Pack: the valid mask into bit words; then all threads turn the upper
//     triangle of each valid box's row of the byte matrix into bits, 16
//     columns a thread from one 16-byte load (words below the diagonal are
//     stored as 0 without a load), into shared memory when the K x
//     ceil(K/32) words fit in SMEM_MASK_BYTES (K <= 1280), else into the
//     caller's global scratch.
//  2. Walk, warp 0, a 32-box word at a time: the "removed" bit set lives in
//     registers (word w on lane w % 32, at most WORDS_PER_LANE words a
//     lane), seeded with the invalid boxes. The boxes of word w depend on
//     each other only through their own bits of word w: each lane loads one
//     box's word-w bits, and the warp decides the word's boxes in order by
//     find-first-set and one shuffle per kept box. Then the kept boxes' rows
//     are ORed into the later words, eight rows' loads in flight at once. So
//     the chain of memory round trips is one per word plus one per eight
//     kept boxes, not one per kept box; no barrier, no host round trip.
//  3. The keep bytes are written from the kept bit set.
// K is at most MAX_K = 4096 (four words a lane); the wrapper refuses more.
// ops/nms.py mirrors MAX_K and SMEM_MASK_BYTES (NMS_MAX_K, SMEM_MASK_BYTES).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WORDS_PER_LANE = 4;
constexpr int MAX_K = 32 * 32 * WORDS_PER_LANE;  // 4096
// the packed rows stay in shared memory up to this size
constexpr int SMEM_MASK_BYTES = 200 * 1024;
constexpr int MAX_WORDS = MAX_K / 32;
constexpr int BATCH = 8;  // kept rows whose loads the walk puts in flight together

__device__ __forceinline__ uint32_t pick(const uint32_t (&r)[WORDS_PER_LANE], int k) {
    uint32_t v = r[0];
#pragma unroll
    for (int s = 1; s < WORDS_PER_LANE; ++s)
        if (k == s) v = r[s];
    return v;
}

// 16 columns [c0, c0 + 16) of row `row` as 16 bits (bit b = column c0 + b)
__device__ __forceinline__ uint32_t pack16(const uint8_t* __restrict__ overlap,
                                           int k, int row, int c0, bool vec) {
    const uint8_t* p = overlap + (int64_t)row * k + c0;
    uint32_t bits = 0;
    if (vec && c0 + 16 <= k) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const uint32_t q[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b)
                bits |= (uint32_t)(((q[a] >> (8 * b)) & 0xffu) != 0) << (4 * a + b);
    } else {
        for (int b = 0; b < 16 && c0 + b < k; ++b)
            bits |= (uint32_t)(p[b] != 0) << b;
    }
    return bits;
}

__global__ void __launch_bounds__(THREADS)
nms_closure_kernel(const uint8_t* __restrict__ overlap, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, uint32_t* __restrict__ scratch, int k) {
    extern __shared__ uint32_t smem[];
    const int words = (k + 31) / 32;
    uint32_t* vwords = smem;  // words of the valid mask
    uint32_t* mask = scratch != nullptr ? scratch : smem + MAX_WORDS;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

    // 1. pack: the valid mask into words, then half-words (16 columns each)
    // of every valid box's row, stored as uint16 so that half 2w is the low
    // half of word w (little-endian). An invalid box is never kept, so its
    // row is never read and is not packed.
    for (int w = warp; w < words; w += THREADS / 32) {
        const int j = 32 * w + lane;
        const uint32_t bits = __ballot_sync(0xffffffffu, j < k && valid[j] != 0);
        if (lane == 0) vwords[w] = bits;
    }
    __syncthreads();
    const bool vec = (k % 16) == 0 && ((uintptr_t)overlap & 15) == 0;
    const int halves = 2 * words;
    const int items = k * halves;  // at most 4096 * 256
    uint16_t* mask16 = reinterpret_cast<uint16_t*>(mask);
#pragma unroll 4
    for (int q = tid; q < items; q += THREADS) {
        const int row = q / halves, h = q % halves;
        if (!((vwords[row >> 5] >> (row & 31)) & 1u)) continue;
        const int c0 = 16 * h;
        // columns <= row never matter (overlap[j][i] needs j < i), and a
        // half past the last column is padding
        const uint32_t bits = (c0 + 15 <= row || c0 >= k) ? 0u
                                                          : pack16(overlap, k, row, c0, vec);
        mask16[q] = (uint16_t)bits;
    }
    __syncthreads();
    if (warp != 0) return;

    // 2. walk, warp 0: removed[s] is word lane + 32 s of the removed set
    uint32_t removed[WORDS_PER_LANE], kept[WORDS_PER_LANE];
#pragma unroll
    for (int s = 0; s < WORDS_PER_LANE; ++s) {
        const int w = lane + 32 * s;
        uint32_t r = 0xffffffffu;
        if (w < words) {
            r = ~vwords[w];
            const int tail = k - 32 * w;  // boxes past K count as removed
            if (tail < 32) r |= 0xffffffffu << tail;
        }
        removed[s] = r;
        kept[s] = 0u;
    }
    for (int w = 0; w < words; ++w) {
        const int owner = w & 31, slot = w >> 5;
        uint32_t word = __shfl_sync(0xffffffffu, pick(removed, slot), owner);
        if (word == 0xffffffffu) continue;
        // the 32 boxes of word w, decided in order from their bits of word
        // w: lane b holds valid box 32 w + b's row bits there
        const bool packed = (vwords[w] >> lane) & 1u;
        const uint32_t local = packed ? mask[(int64_t)(32 * w + lane) * words + w] : 0u;
        uint32_t kw = 0u;
        while (word != 0xffffffffu) {
            const int b = __ffs(~word) - 1;
            kw |= 1u << b;
            word |= (1u << b) | __shfl_sync(0xffffffffu, local, b);
        }
        if (lane == owner) {
#pragma unroll
            for (int s = 0; s < WORDS_PER_LANE; ++s)
                if (s == slot) kept[s] = kw;
        }
        // the kept boxes' rows into the later words, BATCH rows at a time
        // with all their loads in flight
        for (uint32_t left = kw; left != 0u;) {
            int rows[BATCH];
#pragma unroll
            for (int t = 0; t < BATCH; ++t) {
                rows[t] = left != 0u ? 32 * w + __ffs(left) - 1 : -1;
                left &= left - 1u;
            }
            uint32_t v[BATCH][WORDS_PER_LANE];
#pragma unroll
            for (int t = 0; t < BATCH; ++t)
#pragma unroll
                for (int s = 0; s < WORDS_PER_LANE; ++s) {
                    const int ww = lane + 32 * s;
                    v[t][s] = (rows[t] >= 0 && ww > w && ww < words)
                                  ? mask[(int64_t)rows[t] * words + ww] : 0u;
                }
#pragma unroll
            for (int t = 0; t < BATCH; ++t)
#pragma unroll
                for (int s = 0; s < WORDS_PER_LANE; ++s) removed[s] |= v[t][s];
        }
    }

    // 3. keep bytes from the kept bits
#pragma unroll
    for (int s = 0; s < WORDS_PER_LANE; ++s) {
        const int w = lane + 32 * s;
        if (w < words)
            for (int b = 0; b < 32 && 32 * w + b < k; ++b)
                keep[32 * w + b] = (uint8_t)((kept[s] >> b) & 1u);
    }
}

}  // namespace

// overlap (k, k) bool, valid (k,) bool, keep (k,) bool out; scratch: NULL,
// or k * ceil(k / 32) uint32 words when they exceed SMEM_MASK_BYTES
extern "C" int nms_closure(const void* overlap, const void* valid, void* keep,
                           void* scratch, int k, void* stream) {
    if (k <= 0) return (int)cudaGetLastError();
    if (k > MAX_K) return (int)cudaErrorInvalidValue;
    const int words = (k + 31) / 32;
    const size_t mask_bytes = (size_t)k * words * 4;
    if (scratch == nullptr && mask_bytes > (size_t)SMEM_MASK_BYTES)
        return (int)cudaErrorInvalidValue;
    const size_t smem = MAX_WORDS * 4 + (scratch == nullptr ? mask_bytes : 0);
    static bool configured = false;  // more than 48 KB of shared memory: opt in once
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(nms_closure_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               MAX_WORDS * 4 + SMEM_MASK_BYTES);
        if (err != cudaSuccess) return (int)err;
        configured = true;
    }
    nms_closure_kernel<<<1, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(overlap), static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), static_cast<uint32_t*>(scratch), k);
    return (int)cudaGetLastError();
}

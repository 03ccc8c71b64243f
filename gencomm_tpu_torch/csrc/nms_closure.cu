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
// for bit. Any K up to 262,112 (ops/nms.py): nothing is held per box in
// registers.
//
// What bounds it on Hopper: neither bytes nor operations but the chain of
// decisions: box i can be decided only after every kept box before it. The
// least work is one read of the upper triangle of each kept box's row.
//
// Design: one cooperative launch, no host read, one block walks.
//  1. Pack a 32 x 32 tile of the byte matrix a warp (the tiles on and
//     right of the diagonal, W (W + 1) / 2 of them, W = ceil(K / 32)),
//     TILES_IN_FLIGHT tiles' loads in flight at once, twice: as rows (R:
//     row r of 32-box word u keeps its bit words u .. W-1, the 32 rows of
//     word u one run of 32 (W - u) words) and, by a shuffle transpose, as
//     columns (T: for 32-box word u, the word of each box i >= 32 u whose
//     bit a says that box 32 u + a overlaps it, one run of 32 (W - u)
//     words). Each is 64 W (W + 1) bytes, not K^2. A tile whose row word
//     or column word holds no valid box is skipped. The tiles are spread
//     over one block an SM, which write the caller's global scratch. The
//     launch is cooperative (every block resident at once), so a grid
//     barrier ends the packing: then block 0 walks and the others leave.
//     The barrier's state is the launch's own, so calls that overlap (two
//     streams, two graphs) share nothing.
//  2. Storage, by K: while T fits in TRIANGLE_SMEM_BYTES (W <= 57, K <=
//     1,824) the walking block copies it into its shared memory (route
//     `smem`); above, its decider reads T from the L2 (route `l2`, loads
//     that bypass L1). The workers read R from the L2 on both routes.
//  3. Walk, a 32-box word at a time, by warps that hand words over through
//     64-bit slots in shared memory (a value and its flag or count in one
//     store: no fence, no barrier). Warp 0 decides word w, lane b for box
//     i = 32 w + b, which holds its columns of words w - LOOKAHEAD .. w,
//     loaded PREFETCH words ahead (one coalesced load each). The kept
//     words of the last LOOKAHEAD words are in registers, so the boxes
//     they remove are one ballot; the workers' slots give the older ones.
//     Then rounds keep every undecided box that no undecided box overlaps
//     and drop what they overlap, two ballots a round, so a word costs its
//     longest in-word suppression chain, not its kept boxes. The other
//     warps own the removed words, SPLIT warps for each 32 of them (word v
//     on lane v % 32), each warp every SPLIT-th decided word u <= v -
//     LOOKAHEAD - 1: its lanes load word v of all 32 rows of word u before
//     u is decided (coalesced across lanes), OR in the kept ones when it
//     is, and publish the OR with their progress. No memory round trip
//     stands between two decisions, and warp 0 waits only when the workers
//     are LOOKAHEAD words behind.
//  4. The keep bytes are written from the kept words.
// ops/nms.py mirrors TRIANGLE_SMEM_BYTES (`storage_route`) and the scratch
// size (`scratch_words`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
// the warps that walk beside the decider: those off its scheduler
constexpr int WORKERS = THREADS / 32 / 4 * 3;
constexpr int LOOKAHEAD = 3;  // words the decider's registers cover
constexpr int PREFETCH = 3;                // words the decider loads ahead
constexpr int SPLIT_MAX = 4;               // workers a 32 removed words
constexpr int TILES_IN_FLIGHT = 4;         // tiles a packing warp loads at once
// the walking block copies the packed columns into its shared memory up
// to this size (route smem)
constexpr int TRIANGLE_SMEM_BYTES = 210 * 1024;
// dynamic shared memory a block opts into (the card's 227 KB less 1 KB
// for the static variables)
constexpr int SMEM_LIMIT = 227 * 1024 - 1024;
constexpr unsigned FULL = 0xffffffffu;

// offset of the run of 32-box word u (32 (W - u) words) in R and in T
__host__ __device__ __forceinline__ int64_t run_offset(int u, int words) {
    const int64_t g = u;
    return 32 * (g * words - g * (g - 1) / 2);
}

// workers for each 32 removed words
__host__ __device__ __forceinline__ int splits(int words) {
    const int nblk = (words + 31) / 32;
    const int s = WORKERS / nblk;
    return s < 1 ? 1 : (s > SPLIT_MAX ? SPLIT_MAX : s);
}

// 4 bytes as 4 bits (bit b: byte b is not 0): each byte's "not 0" into its
// top bit, then the four top bits gathered by one multiply
__device__ __forceinline__ uint32_t bits4(uint32_t q) {
    const uint32_t m = (((q & 0x7f7f7f7fu) + 0x7f7f7f7fu) | q) & 0x80808080u;
    return (m * 0x00204081u) >> 28;
}

// 16 bytes as 16 bits
__device__ __forceinline__ uint32_t bits16(uint4 v) {
    return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
}

// The 32 x 32 bit matrix whose row a is lane a's word, transposed: lane b
// gets column b (bit a = bit b of row a). Five swaps of off-diagonal
// blocks, a shuffle each
__device__ __forceinline__ uint32_t transpose32(uint32_t x, int lane) {
    const uint32_t masks[5] = {0x0000ffffu, 0x00ff00ffu, 0x0f0f0f0fu, 0x33333333u,
                               0x55555555u};
#pragma unroll
    for (int s = 0; s < 5; ++s) {
        const int j = 16 >> s;
        const uint32_t m = masks[s];
        const uint32_t p = __shfl_xor_sync(FULL, x, j);
        x = (lane & j) ? (x & ~m) | ((p >> j) & m) : (x & m) | ((p & m) << j);
    }
    return x;
}

// One lane's row of a tile: the 32 bytes of row r at columns [c0, c0 + 32),
// loaded as two 16-byte vectors where they can be (`fast`)
struct TileRow {
    uint4 lo, hi;
    bool fast, live;
};

// `live`: row r is a valid box's (an invalid box is never kept, so its row
// stays 0)
__device__ __forceinline__ TileRow load_tile_row(const uint8_t* __restrict__ overlap,
                                                 int k, int r, int c0, bool live,
                                                 bool vec) {
    TileRow t;
    t.live = live;
    t.fast = live && vec && c0 + 32 <= k;
    if (t.fast) {
        const uint4* p = reinterpret_cast<const uint4*>(overlap + (int64_t)r * k + c0);
        t.lo = __ldg(p);
        t.hi = __ldg(p + 1);
    }
    return t;
}

__device__ __forceinline__ uint32_t tile_row_bits(const TileRow& t,
                                                  const uint8_t* __restrict__ overlap,
                                                  int k, int r, int c0) {
    if (t.fast) return bits16(t.lo) | bits16(t.hi) << 16;
    uint32_t bits = 0;
    if (t.live) {
        const uint8_t* p = overlap + (int64_t)r * k + c0;
        for (int b = 0; b < 32 && c0 + b < k; ++b) bits |= (uint32_t)(p[b] != 0) << b;
    }
    return bits;
}

template <bool SMEM>
__device__ __forceinline__ uint32_t load_word(const uint32_t* p) {
    if (SMEM) return *p;
    return __ldcg(p);
}

// The decider's view of the columns: for each d = 0 .. LOOKAHEAD, the
// offset of box 32 w + lane's column of word w - d (that of word 0 while
// w - d < 0), kept as w advances from 0 (run_offset(u + 1) - run_offset(u)
// = 32 (W - u)): no multiply a word
struct ColCursor {
    int ofs[LOOKAHEAD + 1];
    int w = 0;

    __device__ __forceinline__ explicit ColCursor(int lane) {
#pragma unroll
        for (int d = 0; d <= LOOKAHEAD; ++d) ofs[d] = 32 * d + lane;
    }

    // the columns of word w (0 before the first word and past the last),
    // then on to word w + 1
    template <bool SMEM>
    __device__ __forceinline__ void load_next(const uint32_t* cols, int words,
                                              uint32_t (&col)[LOOKAHEAD + 1]) {
#pragma unroll
        for (int d = 0; d <= LOOKAHEAD; ++d) {
            const int u = w - d;
            col[d] = (w < words && u >= 0) ? load_word<SMEM>(cols + ofs[d]) : 0u;
            if (u >= 0) ofs[d] += 32 * (words - u);
        }
        ++w;
    }
};

// word v of the 32 rows of word u, all loads in flight
__device__ __forceinline__ void load_rows(const uint32_t* rows, int words, int u,
                                          int v, uint32_t (&row)[32]) {
    const uint32_t* p = rows + run_offset(u, words) + (v - u);
    const int64_t stride = words - u;
#pragma unroll
    for (int t = 0; t < 32; ++t) row[t] = __ldcg(p + t * stride);
}

__device__ __forceinline__ uint64_t slot(uint32_t value, uint32_t tag) {
    return (uint64_t)tag << 32 | value;
}

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
nms_closure_kernel(const uint8_t* __restrict__ overlap, const uint8_t* __restrict__ valid,
                   uint8_t* __restrict__ keep, uint32_t* __restrict__ scratch, int k) {
    extern __shared__ uint64_t smem[];
    const int words = (k + 31) / 32;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t run_words = 16 * (int64_t)words * (words + 1);
    const int split = splits(words);
    // the walk's state, in 64-bit slots: kept[w] = (kept bits of word w, 1
    // once decided); removed[p][v] = (the bits of word v that worker p of
    // its 32 ORed in, the word up to which it applied every decided word of
    // its share); then the valid boxes' words and, on route smem, the
    // columns
    uint64_t* kept = smem;
    uint64_t* removed = kept + words;
    uint32_t* vwords = reinterpret_cast<uint32_t*>(removed + (size_t)split * words);
    uint32_t* rows = scratch;
    uint32_t* cols = scratch + run_words;
    // every block: the valid boxes' words, and the walk's state (worker p
    // starts having applied its words below p, none; worker 0's share
    // starts as the invalid boxes and the boxes past K)
    for (int w = warp; w < words; w += THREADS / 32) {
        const int j = 32 * w + lane;
        const uint32_t bits = __ballot_sync(FULL, j < k && valid[j] != 0);
        if (lane < split) removed[(size_t)lane * words + w] = slot(lane == 0 ? ~bits : 0u, lane);
        if (lane == 0) {
            kept[w] = 0u;
            vwords[w] = bits;
        }
    }
    __syncthreads();

    // 1. pack: warp item q is the tile of row word u = q / W, column word
    // v = q % W; TILES_IN_FLIGHT items a step, their loads in flight
    // together. A tile left of the diagonal is skipped, and so is one whose
    // row word or column word holds no valid box: a walk never reads it
    // unmasked
    const bool vec = (k % 16) == 0 && ((uintptr_t)overlap & 15) == 0;
    const uint32_t tiles = (uint32_t)words * words;
    const uint32_t stride = gridDim.x * (THREADS / 32);
    for (uint32_t q0 = blockIdx.x * (THREADS / 32) + warp; q0 < tiles;
         q0 += TILES_IN_FLIGHT * stride) {
        int u[TILES_IN_FLIGHT], v[TILES_IN_FLIGHT];
        bool on[TILES_IN_FLIGHT];
        TileRow t[TILES_IN_FLIGHT];
#pragma unroll
        for (int h = 0; h < TILES_IN_FLIGHT; ++h) {
            const uint32_t q = q0 + h * stride;
            u[h] = (int)(q / (uint32_t)words);
            v[h] = (int)(q % (uint32_t)words);
            on[h] = q < tiles && v[h] >= u[h] && vwords[u[h]] != 0u && vwords[v[h]] != 0u;
            t[h] = on[h] ? load_tile_row(overlap, k, 32 * u[h] + lane, 32 * v[h],
                                         (vwords[u[h]] >> lane) & 1u, vec)
                         : TileRow{};
        }
#pragma unroll
        for (int h = 0; h < TILES_IN_FLIGHT; ++h) {
            if (!on[h]) continue;  // the same for every lane of the warp
            uint32_t bits = tile_row_bits(t[h], overlap, k, 32 * u[h] + lane, 32 * v[h]);
            // columns <= row never matter (overlap[j][i] needs j < i)
            if (v[h] == u[h]) bits &= lane == 31 ? 0u : FULL << (lane + 1);
            rows[run_offset(u[h], words) + (int64_t)lane * (words - u[h]) + (v[h] - u[h])] = bits;
            cols[run_offset(u[h], words) + 32 * (int64_t)(v[h] - u[h]) + lane] =
                transpose32(bits, lane);
        }
    }
    // every block has packed (the barrier orders their writes before the
    // walk's reads); block 0 walks
    cooperative_groups::this_grid().sync();
    if (blockIdx.x != 0) return;
    if (SMEM) {
        uint32_t* copy = vwords + words;
        copy += (4 - ((uintptr_t)copy >> 2 & 3)) & 3;  // 16-byte aligned
        const uint4* src4 = reinterpret_cast<const uint4*>(cols);
        uint4* dst4 = reinterpret_cast<uint4*>(copy);
        for (int64_t i = tid; i < run_words / 4; i += THREADS) dst4[i] = __ldcg(src4 + i);
        cols = copy;
        __syncthreads();
    }
    volatile uint64_t* kept_v = kept;
    volatile uint64_t* removed_v = removed;

    if (warp == 0) {
        // 3a. the decider: prev[d] is the kept word of word w - 1 - d;
        // col[s] holds the columns of the words w = s (mod PREFETCH + 1),
        // loaded PREFETCH words ahead into the buffer just read, so no
        // register moves wait on a load in flight
        uint32_t prev[LOOKAHEAD];
#pragma unroll
        for (int d = 0; d < LOOKAHEAD; ++d) prev[d] = 0u;
        uint32_t col[PREFETCH + 1][LOOKAHEAD + 1];
        ColCursor cursor(lane);
#pragma unroll
        for (int s = 0; s <= PREFETCH; ++s) cursor.load_next<SMEM>(cols, words, col[s]);
        for (int w0 = 0; w0 < words; w0 += PREFETCH + 1) {
#pragma unroll
            for (int s = 0; s <= PREFETCH; ++s) {
                const int w = w0 + s;
                if (w >= words) break;
                uint32_t kw = 0u;
                // a word without a valid box keeps none: no wait, no round
                const uint32_t vw = vwords[w];
                if (vw != 0u) {
                    // the workers have applied every word u <= w -
                    // LOOKAHEAD - 1 of their shares
                    uint32_t rem;
                    bool ready;
                    do {
                        rem = 0u;
                        ready = true;
#pragma unroll
                        for (int p = 0; p < SPLIT_MAX; ++p) {
                            if (p < split) {
                                const uint64_t x = removed_v[(size_t)p * words + w];
                                ready &= (int)(x >> 32) >= w - LOOKAHEAD;
                                rem |= (uint32_t)x;
                            }
                        }
                    } while (!ready);
                    // the last LOOKAHEAD words' kept boxes that overlap this
                    // lane's box
                    bool hit = false;
#pragma unroll
                    for (int d = 1; d <= LOOKAHEAD; ++d) hit |= (col[s][d] & prev[d - 1]) != 0u;
                    uint32_t und = vw & ~(rem | __ballot_sync(FULL, hit));
                    const uint32_t in = col[s][0];  // the boxes of this word that overlap it
                    while (und != 0u) {
                        const bool mine = (und >> lane) & 1u;
                        const uint32_t now = __ballot_sync(FULL, mine && (in & und) == 0u);
                        kw |= now;
                        const uint32_t drop = __ballot_sync(FULL, mine && (in & now) != 0u);
                        und &= ~(now | drop);
                    }
                }
                kept_v[w] = slot(kw, 1u);  // every lane, the same value
#pragma unroll
                for (int d = LOOKAHEAD - 1; d > 0; --d) prev[d] = prev[d - 1];
                prev[0] = kw;
                cursor.load_next<SMEM>(cols, words, col[s]);
            }
        }
    } else {
        // 3b. the workers, the warps that share no scheduler with warp 0
        // (warp % 4 != 0), so that their spinning takes none of its issue
        // slots: worker i < groups * split is part i % split of the 32
        // removed words i / split, then of those `groups` further on, ...
        const int i = warp % 4 == 0 ? WORKERS : warp - 1 - warp / 4;
        const int part = i % split, groups = WORKERS / split;
        const int nblk = (words + 31) / 32;
        for (int blk = i / split; i < groups * split && blk < nblk; blk += groups) {
            const int v = 32 * blk + lane;
            const bool mine = v < words;
            const int last_u = min(32 * blk + 31, words - 1) - LOOKAHEAD - 1;
            uint64_t* out = removed + (size_t)part * words + v;
            uint32_t acc = mine ? (uint32_t)removed_v[(size_t)part * words + v] : 0u;
            uint32_t row[32];
            int u = part;
            // a lane needs word u only where v > u + LOOKAHEAD
            if (u <= last_u && mine && v > u + LOOKAHEAD) load_rows(rows, words, u, v, row);
            for (; u <= last_u; u += split) {
                // lane 0's reading of word u's slot, for every lane
                uint64_t x = __shfl_sync(FULL, kept_v[u], 0);
                while ((x >> 32) == 0u) x = __shfl_sync(FULL, kept_v[u], 0);
                const uint32_t kw = (uint32_t)x;
                if (mine && v > u + LOOKAHEAD) {
#pragma unroll
                    for (int t = 0; t < 32; ++t)
                        if ((kw >> t) & 1u) acc |= row[t];
                }
                const int nu = u + split;
                if (nu <= last_u && mine && v > nu + LOOKAHEAD) load_rows(rows, words, nu, v, row);
                // every word of this share below u + split is applied
                if (mine) *reinterpret_cast<volatile uint64_t*>(out) = slot(acc, (uint32_t)nu);
            }
            if (mine) *reinterpret_cast<volatile uint64_t*>(out) = slot(acc, (uint32_t)words);
        }
    }
    __syncthreads();

    // 4. keep bytes from the kept words
    for (int i = tid; i < k; i += THREADS)
        keep[i] = (uint8_t)(((uint32_t)kept[i >> 5] >> (i & 31)) & 1u);
}

// dynamic shared memory of the walking block on either route
size_t walk_smem(int words, bool on_chip) {
    const size_t state = 8 * (size_t)words * (1 + splits(words)) + 4 * (size_t)words;
    return state + (on_chip ? 64 * (size_t)words * (words + 1) + 16 : 0);
}

}  // namespace

// overlap (k, k) bool, valid (k,) bool, keep (k,) bool out; scratch:
// 32 * W * (W + 1) uint32 words, W = ceil(k / 32) (ops/nms.py:scratch_words)
extern "C" int nms_closure(const void* overlap, const void* valid, void* keep,
                           void* scratch, int k, void* stream) {
    if (k <= 0) return (int)cudaGetLastError();
    const int words = (k + 31) / 32;
    const bool on_chip = 64 * (int64_t)words * (words + 1) <= TRIANGLE_SMEM_BYTES;
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = walk_smem(words, on_chip);
    // the scratch indexes below 2^31 words up to K = 262,112 (a 68.7 GB
    // overlap matrix), and the walk's state fits a block up to there
    if (smem > (size_t)SMEM_LIMIT || 32 * (int64_t)words * (words + 1) > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    static int sms = 0;
    if (sms == 0) {  // once: the SM count and the shared-memory opt-in
        int dev = 0;
        cudaError_t err = cudaGetDevice(&dev);
        if (err == cudaSuccess)
            err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(nms_closure_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(nms_closure_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
        if (err != cudaSuccess) {
            sms = 0;
            return (int)err;
        }
    }
    // the packing pass over the whole card, a tile a warp, at most one block
    // an SM: all resident, as the cooperative launch requires
    const int64_t tiles = (int64_t)words * words;
    const int64_t want = (tiles + THREADS / 32 - 1) / (THREADS / 32);
    const int blocks = (int)(want < sms ? want : sms);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint8_t* o = static_cast<const uint8_t*>(overlap);
    const uint8_t* va = static_cast<const uint8_t*>(valid);
    uint8_t* kp = static_cast<uint8_t*>(keep);
    uint32_t* sc = static_cast<uint32_t*>(scratch);
    cudaLaunchAttribute coop[1];
    coop[0].id = cudaLaunchAttributeCooperative;
    coop[0].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = s;
    cfg.attrs = coop;
    cfg.numAttrs = 1;
    return (int)cudaLaunchKernelEx(
        &cfg, on_chip ? nms_closure_kernel<true> : nms_closure_kernel<false>, o, va, kp,
        sc, k);
}

// Pillar segment-max canvas, backward for the rows (kernel K2b of the port).
//
// Replaces: the VJP that JAX derives for the training canvas,
// `canvas.at[flat_gids].max(rows)` on a zero bf16 canvas
// (gencomm_tpu/models/encoders/point_pillar.py:188-189; training never takes
// the Pallas canvas of ops/pillar_pallas.py), i.e. XLA autodiff through
// jax._src.lax.slicing._scatter_extremal_jvp.
//
// What it computes, for row r of cell (agent, gid) and channel c, with
// m = canvas[cell, c] (the forward's max) and g = gout[cell, c]:
//   tied   = rows[r, c] == m
//   n      = number of tied rows of the cell, plus 1 when m == 0 (the zero
//            canvas init also holds the max); counted in bf16 as JAX counts
//            it, where 256 + 1 rounds back to 256, so n = min(n, 256)
//   drows[r, c] = bf16(g * (tied ? bf16(1 / n) : 0))   (so -0 where g < 0)
// Bit-exact against the plain version: the count is exact, 1/n is rounded
// once to fp32 and once to bf16, and the product of two bf16 values is exact
// in fp32 before its one rounding to bf16.
//
// What bounds it on Hopper: bytes. It reads the rows and writes their
// gradient (2 x 15.4 MB at the flagship training step, 4 agent slots of
// 30,000 rows x 64 channels), plus the max and cotangent of each occupied
// cell (128 bytes each, 81,000 cells there: a run is 1.5 rows on average);
// the arithmetic is a compare and a multiply. The grid is under one wave of
// the card, so what counts is the number of independent loads a thread has
// in flight.
//
// Design, two routes chosen by the caller from the channel count. The rows
// are sorted by gid within each agent (K2's contract), so a cell's rows are
// one run.
//  * route 1, 64 channels (every model of the repo). A warp owns a chunk of
//    32 rows and reads each once: 8 lanes x 16 bytes span a 128-byte row, so
//    one load instruction brings four rows and eight independent ones the
//    whole chunk; lane (s, c) holds rows 8s .. 8s+7, channels 8c .. 8c+7.
//    The chunk's gids are loaded once, lane j holding row j's cell; run heads
//    are a ballot over the lanes, and a row's run a bit mask cut from it.
//    Each row's max and cotangent are 16-byte loads that depend on nothing
//    but the gids. The tie flags of a lane's 64 values are two 64-bit words;
//    transposed and exchanged over the four row groups by shuffles they give
//    every lane, per channel, a 32-bit mask of the chunk's tied rows, and a
//    run's tie count is the population count of that mask under the run's
//    mask. No row is read a second time for the write.
//    Runs that cross a chunk boundary: a run that touches two chunks and
//    fills neither ("short", nearly all of them) is finished by both warps
//    on their own, each reading the few rows of the neighbour chunk that
//    belong to the run. Anything longer -- chiefly the run of zeroed invalid
//    rows at the end of an agent, thousands of rows -- is counted piecewise:
//    each piece adds its counts into the slot of the chunk that holds the
//    run's head (found by a 32-way search over the sorted gids, one load per
//    step), marks its chunk, and the second launch writes those rows from
//    the finished counts. Warps of unmarked chunks leave the second launch
//    after one load.
//  * route 0, any even channel count: the first version's kernel (a lane per
//    bf16 channel pair, one row per step, the run structure from each lane's
//    own loads, a binary search for the head), kept as the general route.
// Every row is written once, by one of the two launches.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;  // rows per warp; the wrapper sizes the slots by it
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_gid(int g, int ncell) {
    return g < 0 ? 0 : (g >= ncell ? ncell - 1 : g);
}

__device__ __forceinline__ float share(float count, float max_value) {
    // JAX: select(retained, 1 / (n + 1), 1 / n) in bf16, n saturating at 256
    float n = count + (max_value == 0.0f ? 1.0f : 0.0f);
    n = fminf(n, 256.0f);
    return __bfloat162float(__float2bfloat16_rn(__fdiv_rn(1.0f, n)));
}

// ---- route 0: general, a lane per channel pair -----------------------------

// first row of [lo, hi) whose clamped gid is g (gids sorted within [lo, hi))
__device__ __forceinline__ int64_t run_head(const int32_t* __restrict__ gids,
                                            int64_t lo, int64_t hi, int g,
                                            int ncell) {
    while (lo < hi) {
        const int64_t mid = lo + (hi - lo) / 2;
        if (clamp_gid(gids[mid], ncell) < g) lo = mid + 1; else hi = mid;
    }
    return lo;
}

__device__ __forceinline__ void write_rows(const __nv_bfloat16* __restrict__ rows,
                                           __nv_bfloat16* __restrict__ drows,
                                           int64_t r, int64_t p, int cp,
                                           int channels, float2 m, float2 g,
                                           float n0, float n1) {
    const float s0 = share(n0, m.x), s1 = share(n1, m.y);
    // tied rows get g * share; the others g * 0, a zero with g's sign
    const float t0 = __fmul_rn(g.x, s0), t1 = __fmul_rn(g.y, s1);
    const float z0 = __fmul_rn(g.x, 0.0f), z1 = __fmul_rn(g.y, 0.0f);
    for (int64_t q = r; q < p; ++q) {
        const float2 v = __bfloat1622float2(
            reinterpret_cast<const __nv_bfloat162*>(rows + q * channels)[cp]);
        reinterpret_cast<__nv_bfloat162*>(drows + q * channels)[cp] =
            __floats2bfloat162_rn(v.x == m.x ? t0 : z0, v.y == m.y ? t1 : z1);
    }
}

// FINISH = false: count every piece; write whole runs; add split runs'
// counts into their slots. FINISH = true: write the pieces of split runs.
template <bool FINISH>
__global__ void pillar_canvas_bwd_kernel(const __nv_bfloat16* __restrict__ rows,
                                         const int32_t* __restrict__ gids,
                                         const __nv_bfloat16* __restrict__ canvas,
                                         const __nv_bfloat16* __restrict__ gout,
                                         __nv_bfloat16* __restrict__ drows,
                                         int* __restrict__ counts,
                                         int64_t n_rows, int64_t rows_per_agent,
                                         int ncell, int channels) {
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t begin = warp * CHUNK;
    if (begin >= n_rows) return;
    const int64_t end = min(begin + CHUNK, n_rows);
    const int pairs = channels >> 1;

    for (int cp = lane; cp - lane < pairs; cp += 32) {
        const bool active = cp < pairs;
        int64_t r = begin;
        while (r < end) {
            const int64_t agent = r / rows_per_agent;
            const int64_t agent_start = agent * rows_per_agent;
            const int64_t agent_end = agent_start + rows_per_agent;
            const int g = clamp_gid(gids[r], ncell);
            const bool head = r == agent_start ||
                              clamp_gid(gids[r - 1], ncell) != g;
            int64_t p = r + 1;
            const int64_t stop = min(end, agent_end);
            while (p < stop && clamp_gid(gids[p], ncell) == g) ++p;
            const bool run_ends = p == agent_end || p == n_rows ||
                                  clamp_gid(gids[p], ncell) != g;
            const bool whole = head && run_ends;
            if (active && (!FINISH || !whole)) {
                const int64_t cell = (agent * ncell + g) * channels;
                const float2 m = __bfloat1622float2(
                    reinterpret_cast<const __nv_bfloat162*>(canvas + cell)[cp]);
                const float2 gv = __bfloat1622float2(
                    reinterpret_cast<const __nv_bfloat162*>(gout + cell)[cp]);
                if (!FINISH) {
                    int n0 = 0, n1 = 0;
                    for (int64_t q = r; q < p; ++q) {
                        const float2 v = __bfloat1622float2(
                            reinterpret_cast<const __nv_bfloat162*>(rows + q * channels)[cp]);
                        n0 += v.x == m.x;
                        n1 += v.y == m.y;
                    }
                    if (whole) {
                        write_rows(rows, drows, r, p, cp, channels, m, gv,
                                   (float)n0, (float)n1);
                    } else {
                        const int64_t slot =
                            (head ? r : run_head(gids, agent_start, r, g, ncell)) / CHUNK;
                        if (n0) atomicAdd(counts + slot * channels + 2 * cp, n0);
                        if (n1) atomicAdd(counts + slot * channels + 2 * cp + 1, n1);
                    }
                } else {
                    const int64_t slot =
                        (head ? r : run_head(gids, agent_start, r, g, ncell)) / CHUNK;
                    write_rows(rows, drows, r, p, cp, channels, m, gv,
                               (float)counts[slot * channels + 2 * cp],
                               (float)counts[slot * channels + 2 * cp + 1]);
                }
            }
            r = p;
        }
    }
}

// ---- route 1: 64 channels, a chunk's 32 rows in registers ------------------
// Rows and cells are indexed by int here: 2^31 rows or cells of 64 bf16
// channels would be 275 GB.
constexpr int C64 = 64;    // channels: 8 lanes x 8 bf16 (16 bytes) span a row
constexpr int SLOTS = 8;   // rows a lane holds: rows 8s .. 8s+7 of the chunk
constexpr int LONG_FIRST = 1, LONG_LAST = 2;  // a chunk's mark for launch two
constexpr int COUNT_LIMIT = 256;  // where the bf16 tie count stops
constexpr int THREADS_FIRST = 256, THREADS_SECOND = 64;

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
}

// bit c: channel c of a equals channel c of b, compared as numbers (two
// channels a compare; +0 equals -0 and a NaN nothing)
__device__ __forceinline__ unsigned equal_bits(const uint4& a, const uint4& b) {
    const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
    unsigned bits = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const unsigned w = __heq2_mask(pa[q], pb[q]) & 0x00010001u;
        bits |= ((w | w >> 15) & 3u) << (2 * q);
    }
    return bits;
}

__device__ __forceinline__ unsigned zero_bits(const uint4& a) {
    return equal_bits(a, make_uint4(0u, 0u, 0u, 0u));
}

// the 8 x 8 bit matrix (byte r, bit c) transposed
__device__ __forceinline__ uint64_t transpose8(uint64_t x) {
    uint64_t t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AAull;
    x = x ^ t ^ (t << 7);
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCCull;
    x = x ^ t ^ (t << 14);
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0ull;
    return x ^ t ^ (t << 28);
}

// the population count of every byte, in that byte
__device__ __forceinline__ uint64_t byte_popc(uint64_t x) {
    x = x - ((x >> 1) & 0x5555555555555555ull);
    x = (x & 0x3333333333333333ull) + ((x >> 2) & 0x3333333333333333ull);
    return (x + (x >> 4)) & 0x0f0f0f0f0f0f0f0full;
}

// bits [a, b) of the run that holds row j, from the chunk's run heads
__device__ __forceinline__ unsigned run_mask(unsigned heads, int j, int n_here) {
    const unsigned upto = (2u << j) - 1u;  // bits 0 .. j
    const int a = 31 - __clz(heads & upto);
    const unsigned above = heads & ~upto;
    const int b = above ? __ffs(above) - 1 : n_here;
    return (b >= 32 ? FULL : (1u << b) - 1u) & ~((1u << a) - 1u);
}

struct Rows64 {
    const __nv_bfloat16* rows;
    const int32_t* gids;
    int n_rows, rows_per_agent, ncell;

    // agent * ncell + clamped gid of a row: its canvas cell; -1 off the rows
    __device__ __forceinline__ int cell(int row) const {
        if (row < 0 || row >= n_rows) return -1;
        return (int)((unsigned)row / (unsigned)rows_per_agent) * ncell +
               clamp_gid(gids[row], ncell);
    }

    // Per channel of this lane, one to a byte: how many of the rows `from`
    // .. `to` - 1 of the chunk at `chunk_begin` tie with the maxima `m`.
    __device__ __forceinline__ uint64_t neighbour_ties(int chunk_begin, int from,
                                                       int to, const uint4& m,
                                                       int s, int cg) const {
        uint64_t by_slot = 0;
#pragma unroll
        for (int i = 0; i < SLOTS; ++i) {
            const int j = 8 * s + i;
            if (j >= from && j < to) {
                const uint4 v = load16(rows + (int64_t)(chunk_begin + j) * C64 + cg * 8);
                by_slot |= (uint64_t)equal_bits(v, m) << (8 * i);
            }
        }
        uint64_t c = byte_popc(transpose8(by_slot));
        c += __shfl_xor_sync(FULL, c, 8);
        return c + __shfl_xor_sync(FULL, c, 16);
    }

    // first row of the run of gid `g` that ends at row `last` (which has
    // gid g), not before `lo`; the gids in [lo, last] ascend. Every lane
    // probes one row a step, so three steps cover 30,000 rows.
    __device__ __forceinline__ int run_head32(int lo, int last, int g,
                                              int lane) const {
        int hi = last;  // the head lies in [lo, hi]
        while (lo < hi) {
            const int step = (hi - lo) / 32 + 1;
            const int64_t p = lo + (int64_t)lane * step;
            const bool at_or_after = p >= hi || clamp_gid(gids[p], ncell) >= g;
            const unsigned found = __ballot_sync(FULL, at_or_after);
            if (!found) {
                lo += 31 * step + 1;
            } else {
                const int f = __ffs(found) - 1;
                hi = min(lo + f * step, hi);
                if (f > 0) lo += (f - 1) * step + 1;
            }
        }
        return lo;
    }
};

// The 8 gradient values of one row's channels 8c .. 8c+7. `shares[n]` is
// share() of n ties, n >= 1; a value that does not tie never reads its share.
__device__ __forceinline__ uint4 row_gradient(const uint4& gv, unsigned tied,
                                              unsigned zero, const int count[8],
                                              const float* shares) {
    const __nv_bfloat162* pg = reinterpret_cast<const __nv_bfloat162*>(&gv);
    uint4 out;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float2 g = __bfloat1622float2(pg[q]);
        float v[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int ch = 2 * q + h;
            const int n = count[ch] + (int)((zero >> ch) & 1u);
            const float s = shares[min(n, COUNT_LIMIT)];
            v[h] = __fmul_rn(h ? g.y : g.x, (tied >> ch) & 1u ? s : 0.0f);
        }
        po[q] = __floats2bfloat162_rn(v[0], v[1]);
    }
    return out;
}

// FINISH = false: every row whose run lies in the chunk or is short; long
// pieces add their counts to their slots and mark the chunk.
// FINISH = true: the rows of the long pieces of marked chunks.
template <bool FINISH>
__global__ void __launch_bounds__(THREADS_FIRST)
canvas_bwd_rows64_kernel(const __nv_bfloat16* __restrict__ rows,
                         const int32_t* __restrict__ gids,
                         const __nv_bfloat16* __restrict__ canvas,
                         const __nv_bfloat16* __restrict__ gout,
                         __nv_bfloat16* __restrict__ drows,
                         int* __restrict__ counts, int2* __restrict__ marks,
                         int n_rows, int rows_per_agent, int ncell) {
    // share() of every count up to the limit, once a block
    __shared__ float shares[COUNT_LIMIT + 1];
    for (int t = threadIdx.x; t <= COUNT_LIMIT; t += blockDim.x)
        shares[t] = share((float)t, 1.0f);
    __syncthreads();

    const int warp = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5);
    const int lane = threadIdx.x & 31;
    const int64_t begin64 = (int64_t)warp * CHUNK;
    if (begin64 >= n_rows) return;
    const int begin = (int)begin64;
    int2 mark = make_int2(0, 0);  // x: LONG_FIRST | LONG_LAST, y: the lead slot
    if (FINISH) {
        mark = marks[warp];
        if (mark.x == 0) return;
    }
    const Rows64 in{rows, gids, n_rows, rows_per_agent, ncell};
    const int n_here = min(CHUNK, n_rows - begin);
    const unsigned valid = n_here == 32 ? FULL : (1u << n_here) - 1u;
    // lane (s, cg) works on rows 8s .. 8s+7, channels 8cg .. 8cg+7
    const int s = lane >> 3, cg = lane & 7;

    // the cells of the chunk and of its two neighbours, lane j holding row j's
    const int my_cell = lane < n_here ? in.cell(begin + lane) : -1;
    const int before_cell = FINISH ? -1 : in.cell(begin - CHUNK + lane);
    const int after_cell = FINISH ? -1 : in.cell(begin + CHUNK + lane);

    // heads: bit j, row j starts a run within the chunk
    const int left_cell = __shfl_up_sync(FULL, my_cell, 1);
    const unsigned heads = __ballot_sync(
        FULL, lane < n_here && (lane == 0 || left_cell != my_cell));
    const unsigned first_run = run_mask(heads, 0, n_here);
    const unsigned last_run = run_mask(heads, n_here - 1, n_here);
    const bool single = heads == 1u;  // the chunk's rows are one run
    const int cell_first = __shfl_sync(FULL, my_cell, 0);
    const int cell_last = __shfl_sync(FULL, my_cell, n_here - 1);

    // what the runs at the chunk's two ends are: inside it, short, or long
    bool short_first = false, short_last = false;
    uint64_t first_extra = 0, last_extra = 0;  // ties in the neighbour chunk
    if (!FINISH) {
        const bool from_before = __shfl_sync(FULL, before_cell, 31) == cell_first;
        const bool goes_on = n_here == 32 &&
                             __shfl_sync(FULL, after_cell, 0) == cell_last;
        const unsigned before_other = __ballot_sync(FULL, before_cell != cell_first);
        const unsigned after_other = __ballot_sync(FULL, after_cell != cell_last);
        const bool not_filled = !single || n_here < 32;
        // short: the run touches two chunks and fills neither
        short_first = from_before && not_filled && before_other;
        short_last = goes_on && not_filled && after_other;
        if (short_first)
            first_extra = in.neighbour_ties(
                begin - CHUNK, 32 - __clz(before_other), 32,
                load16(canvas + (int64_t)cell_first * C64 + cg * 8), s, cg);
        if (short_last)
            last_extra = in.neighbour_ties(
                begin + CHUNK, 0, __ffs(after_other) - 1,
                load16(canvas + (int64_t)cell_last * C64 + cg * 8), s, cg);
        mark.x = (from_before && !short_first ? LONG_FIRST : 0) |
                 (goes_on && !short_last ? LONG_LAST : 0);
    }
    const unsigned long_rows = (mark.x & LONG_FIRST ? first_run : 0u) |
                               (mark.x & LONG_LAST ? last_run : 0u);
    const unsigned mine = (FINISH ? long_rows : ~long_rows) & valid;
    const unsigned read = FINISH ? mine : valid;

    // each row against its cell's max: the tie and zero-max flags, byte i of
    // a word for row 8s + i, bit c for channel 8cg + c. Two rows a step in
    // the first launch, where the many warps of an SM together keep enough
    // loads in flight and few registers a thread keep them many; all eight
    // at once in the second, which has few warps at work.
    uint64_t tied = 0, zero = 0;
#pragma unroll (FINISH ? SLOTS : 2)
    for (int i = 0; i < SLOTS; ++i) {
        const int j = 8 * s + i;
        const int cell = __shfl_sync(FULL, my_cell, j);
        if ((read >> j) & 1u) {
            const uint4 r = load16(rows + (int64_t)(begin + j) * C64 + cg * 8);
            const uint4 m = load16(canvas + (int64_t)cell * C64 + cg * 8);
            tied |= (uint64_t)equal_bits(r, m) << (8 * i);
            zero |= (uint64_t)zero_bits(m) << (8 * i);
        }
    }

    unsigned by_channel[8];  // FINISH = false: per channel, the tied rows
    int first_count[8], last_count[8];  // FINISH = true: the long runs' counts
    if (!FINISH) {
        // transposed, byte c holds channel c's ties over this lane's 8 rows;
        // the four row groups' bytes side by side are the chunk's 32 rows
        const uint64_t t = transpose8(tied);
        unsigned lo[4], hi[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            lo[q] = __shfl_sync(FULL, (unsigned)t, 8 * q + cg);
            hi[q] = __shfl_sync(FULL, (unsigned)(t >> 32), 8 * q + cg);
        }
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {
            const unsigned sel = ch | (4 + ch) << 4;
            by_channel[ch] = (__byte_perm(lo[0], lo[1], sel) & 0xffffu) |
                             __byte_perm(lo[2], lo[3], sel) << 16;
            by_channel[4 + ch] = (__byte_perm(hi[0], hi[1], sel) & 0xffffu) |
                                 __byte_perm(hi[2], hi[3], sel) << 16;
        }
        // long pieces: their counts into the slot of the run's head
        if (mark.x & LONG_FIRST) {
            const int agent_start = begin / rows_per_agent * rows_per_agent;
            mark.y = in.run_head32(agent_start, begin - 1,
                                   clamp_gid(gids[begin], ncell), lane) / CHUNK;
            if (s == 0) {
#pragma unroll
                for (int ch = 0; ch < 8; ++ch) {
                    const int c = __popc(by_channel[ch] & first_run);
                    if (c) atomicAdd(counts + (int64_t)mark.y * C64 + cg * 8 + ch, c);
                }
            }
        }
        if ((mark.x & LONG_LAST) && !(single && (mark.x & LONG_FIRST)) && s == 0) {
#pragma unroll
            for (int ch = 0; ch < 8; ++ch) {
                const int c = __popc(by_channel[ch] & last_run);
                if (c) atomicAdd(counts + (int64_t)warp * C64 + cg * 8 + ch, c);
            }
        }
        if (lane == 0) marks[warp] = mark;
    } else {
        // a single run that came from before and goes on has one slot
        const int last_slot = single && (mark.x & LONG_FIRST) ? mark.y : warp;
#pragma unroll
        for (int ch = 0; ch < 8; ++ch) {
            first_count[ch] = mark.x & LONG_FIRST
                ? counts[(int64_t)mark.y * C64 + cg * 8 + ch] : 0;
            last_count[ch] = mark.x & LONG_LAST
                ? counts[(int64_t)last_slot * C64 + cg * 8 + ch] : 0;
        }
    }

#pragma unroll (FINISH ? SLOTS : 2)
    for (int i = 0; i < SLOTS; ++i) {
        const int j = 8 * s + i;
        const int cell = __shfl_sync(FULL, my_cell, j);
        if (!((mine >> j) & 1u)) continue;
        const uint4 g = load16(gout + (int64_t)cell * C64 + cg * 8);
        int count[8];
        if (!FINISH) {
            const unsigned run = run_mask(heads, j, n_here);
            const uint64_t extra =
                (short_first && (run & 1u) ? first_extra : 0) +
                (short_last && ((run >> (n_here - 1)) & 1u) ? last_extra : 0);
#pragma unroll
            for (int ch = 0; ch < 8; ++ch)
                count[ch] = __popc(by_channel[ch] & run) +
                            (int)((extra >> (8 * ch)) & 0xff);
        } else {
            const bool in_first = (mark.x & LONG_FIRST) && ((first_run >> j) & 1u);
#pragma unroll
            for (int ch = 0; ch < 8; ++ch)
                count[ch] = in_first ? first_count[ch] : last_count[ch];
        }
        const uint4 out = row_gradient(g, (unsigned)(tied >> (8 * i)) & 0xffu,
                                       (unsigned)(zero >> (8 * i)) & 0xffu, count,
                                       shares);
        *reinterpret_cast<uint4*>(drows + (int64_t)(begin + j) * C64 + cg * 8) = out;
    }
}

}  // namespace

// rows, drows (n_rows, channels) bf16; gids (n_rows,) int32 sorted within each
// agent's rows_per_agent rows; canvas, gout (n_rows / rows_per_agent, ncell,
// channels) bf16. scratch, ints: ceil(n_rows / 32) x channels count slots,
// and for route 1 two more ints a chunk (its mark). route 0: the general
// kernel, an even channel count; route 1: 64 channels, rows and cells within
// int.
extern "C" int pillar_canvas_bwd_bf16(const void* rows, const void* gids,
                                      const void* canvas, const void* gout,
                                      void* drows, void* scratch,
                                      long long n_rows, long long rows_per_agent,
                                      int ncell, int channels, int route,
                                      void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_rows <= 0) return (int)cudaGetLastError();
    if (route != 0 && route != 1) return (int)cudaErrorInvalidValue;
    const long long chunks = (n_rows + CHUNK - 1) / CHUNK;
    cudaError_t err = cudaMemsetAsync(scratch, 0, (size_t)chunks * channels * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    const auto* r = static_cast<const __nv_bfloat16*>(rows);
    const auto* gi = static_cast<const int32_t*>(gids);
    const auto* cv = static_cast<const __nv_bfloat16*>(canvas);
    const auto* go = static_cast<const __nv_bfloat16*>(gout);
    auto* dr = static_cast<__nv_bfloat16*>(drows);
    auto* cn = static_cast<int*>(scratch);
    if (route == 1) {
        const long long cells = n_rows / rows_per_agent * ncell;
        if (channels != C64 || n_rows > INT32_MAX || cells > INT32_MAX)
            return (int)cudaErrorInvalidValue;
        int2* marks = reinterpret_cast<int2*>(cn + chunks * C64);
        const int n = (int)n_rows, per_agent = (int)rows_per_agent;
        canvas_bwd_rows64_kernel<false>
            <<<(unsigned)((chunks * 32 + THREADS_FIRST - 1) / THREADS_FIRST),
               THREADS_FIRST, 0, s>>>(r, gi, cv, go, dr, cn, marks, n, per_agent,
                                      ncell);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        // small blocks: the marked chunks lie together and should spread
        canvas_bwd_rows64_kernel<true>
            <<<(unsigned)((chunks * 32 + THREADS_SECOND - 1) / THREADS_SECOND),
               THREADS_SECOND, 0, s>>>(r, gi, cv, go, dr, cn, marks, n, per_agent,
                                       ncell);
        return (int)cudaGetLastError();
    }
    const int threads = 256;
    const unsigned blocks = (unsigned)((chunks * 32 + threads - 1) / threads);
    pillar_canvas_bwd_kernel<false><<<blocks, threads, 0, s>>>(
        r, gi, cv, go, dr, cn, n_rows, rows_per_agent, ncell, channels);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pillar_canvas_bwd_kernel<true><<<blocks, threads, 0, s>>>(
        r, gi, cv, go, dr, cn, n_rows, rows_per_agent, ncell, channels);
    return (int)cudaGetLastError();
}

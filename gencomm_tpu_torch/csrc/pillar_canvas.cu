// Pillar segment-max canvas (kernel K2 of the port).
//
// Replaces: gencomm_tpu/ops/pillar_pallas.py `_kernel` / `striped_pillar_canvas`
// (the TPU kernel that one-hot-matmuls stripe-padded row chunks on the MXU).
//
// What it computes: canvas[a, cell, c] = max(0, max over rows r of agent a
// with clamp(gid[r]) == cell of rows[r, c]), bf16 in and out. Rows arrive
// sorted by gid within each agent (the host decorator's contract); gids are
// clamped to [0, ncell - 1], which keeps the order sorted (the invalid rows,
// ids >= ncell with zero features, all fall into cell ncell - 1).
//
// What bounds it on Hopper: bytes. Per flagship frame it reads ~7.7 MB of
// rows and writes a 33.5 MB canvas, with no arithmetic to speak of.
//
// Design: the canvas is zeroed with one memset (it writes at the copy
// engine's full rate; a one-launch design that wrote every cell once from
// tiles in shared memory was slower, see csrc/variants/pillar_canvas_tiles).
// Then one launch folds the rows: a warp owns CHUNK consecutive rows, a team
// of TEAM lanes owns ROWS of them, and each lane issues the 16-byte loads of
// its channel vector in all ROWS rows at once, together with the warp's
// coalesced load of its rows' gids, so a warp keeps 4 KB of rows in flight
// (the first version walked its chunk one row and one gid at a time). Run
// heads and run ends come from two ballots over the cell keys (agent *
// ncell + clamped gid) of each row and its neighbours. Each team folds its
// rows in order, taking the max in float (exact for bf16, so any order
// gives the same bits). A run that lies whole in the team's rows is written
// with a plain store as it ends: that cell has no other writer. Only a
// team's first and last pieces can belong to runs that other teams share;
// their maxima are kept and merged after the walk with compare-and-swap on
// 32-bit bf16 pairs: one 16-byte read of the cell from L2, then a CAS for
// each word the piece raises, all in flight together, so the warp waits for
// two round trips there and not for a chain of them per piece and word
// (that chain made a version that merged each piece as it ended no faster
// than the first version). A piece whose max is +0 writes and reads
// nothing, since the memset left its cell +0: the thousands of zeroed
// invalid rows at the end of an agent touch no canvas word. Channel counts
// that are not a multiple of 8, or unaligned pointers, take 4-byte (bf16
// pair) vectors instead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;              // rows per warp
constexpr int TEAM = 8;                // lanes per row
constexpr int ROWS = CHUNK * TEAM / 32;  // consecutive rows per team
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int clamp_gid(int g, int ncell) {
    return g < 0 ? 0 : (g >= ncell ? ncell - 1 : g);
}

// max(a, v) that keeps a on a tie, so a -0.0 row leaves a +0 canvas +0 (as
// the plain version's scatter max does) and a NaN row is ignored
__device__ __forceinline__ float max_keep_zero(float a, float v) {
    return v > a ? v : a;
}

__device__ __forceinline__ float2 unpack(unsigned int w) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

__device__ __forceinline__ unsigned int pack(float a, float b) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const unsigned int*>(&h);
}

// WORDS 32-bit words (bf16 pairs) of a row's channel vector; ``Cached``
// loads through L1, else from L2 (a canvas word other warps may have raised)
template <int WORDS, bool Cached>
__device__ __forceinline__ void load_words(const unsigned int* p,
                                           unsigned int (&w)[WORDS]) {
    if constexpr (WORDS == 4) {
        const uint4* q = reinterpret_cast<const uint4*>(p);
        const uint4 v = Cached ? __ldg(q) : __ldcg(q);
        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
        w[0] = Cached ? __ldg(p) : __ldcg(p);
    }
}

template <int WORDS>
__device__ __forceinline__ void store_words(unsigned int* p,
                                            const float (&m)[2 * WORDS]) {
    if constexpr (WORDS == 4) {
        *reinterpret_cast<uint4*>(p) = make_uint4(
            pack(m[0], m[1]), pack(m[2], m[3]), pack(m[4], m[5]), pack(m[6], m[7]));
    } else {
        *p = pack(m[0], m[1]);
    }
}

// canvas words at p = max(canvas words, m) word by word, by compare-and-swap
// from the words ``cur`` read before; every CAS of a round is in flight at
// once, and a word another writer changed meanwhile is tried again
template <int WORDS>
__device__ __forceinline__ void raise_words(unsigned int* p,
                                            const float (&m)[2 * WORDS],
                                            unsigned int (&cur)[WORDS]) {
    bool pending = true;
    while (pending) {
        unsigned int want[WORDS];
        bool need[WORDS];
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
            const float2 c = unpack(cur[k]);
            const float n0 = max_keep_zero(c.x, m[2 * k]);
            const float n1 = max_keep_zero(c.y, m[2 * k + 1]);
            need[k] = n0 != c.x || n1 != c.y;
            want[k] = pack(n0, n1);
        }
        unsigned int seen[WORDS];
#pragma unroll
        for (int k = 0; k < WORDS; ++k)
            seen[k] = need[k] ? atomicCAS(p + k, cur[k], want[k]) : cur[k];
        pending = false;
#pragma unroll
        for (int k = 0; k < WORDS; ++k) {
            const bool lost = need[k] && seen[k] != cur[k];
            pending |= lost;
            cur[k] = need[k] && !lost ? want[k] : seen[k];
        }
    }
}

// the cell key of row r over all agents (-1 past either end of the rows)
__device__ __forceinline__ int64_t cell_key(const int32_t* gids, int64_t r,
                                            int64_t n_rows,
                                            int64_t rows_per_agent, int ncell) {
    if (r < 0 || r >= n_rows) return -1;
    return (r / rows_per_agent) * ncell + clamp_gid(gids[r], ncell);
}

// a piece of a run that other teams share: its cell and its max so far
template <int WORDS>
struct Piece {
    int64_t key;
    float m[2 * WORDS];
};

template <int WORDS>
__global__ void __launch_bounds__(THREADS)
pillar_canvas_kernel(const unsigned int* __restrict__ rows,
                     const int32_t* __restrict__ gids,
                     unsigned int* __restrict__ out, int64_t n_rows,
                     int64_t rows_per_agent, int ncell, int channels) {
    const int lane = threadIdx.x & 31;
    const int64_t base =
        ((blockIdx.x * (int64_t)THREADS + threadIdx.x) >> 5) * CHUNK;
    if (base >= n_rows) return;  // whole warps leave together
    const int first = (lane / TEAM) * ROWS, tl = lane % TEAM;
    const int valid = (int)min((int64_t)CHUNK, n_rows - base);
    const int nw = channels >> 1, nvec = nw / WORDS;

    // this lane's rows of its first channel vector, in flight with the gids
    unsigned int w[ROWS][WORDS];
    auto load_rows = [&](int vi) {
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            if (vi < nvec && first + j < valid) {
                load_words<WORDS, true>(rows + (base + first + j) * nw + vi * WORDS, w[j]);
            } else {
#pragma unroll
                for (int k = 0; k < WORDS; ++k) w[j][k] = 0u;
            }
        }
    };
    load_rows(tl);

    // run heads and run ends of the chunk's rows, as bit masks by lane
    const int64_t key = cell_key(gids, base + lane, n_rows, rows_per_agent, ncell);
    int64_t prev = __shfl_up_sync(FULL, key, 1);
    int64_t next = __shfl_down_sync(FULL, key, 1);
    if (lane == 0) prev = cell_key(gids, base - 1, n_rows, rows_per_agent, ncell);
    if (lane == CHUNK - 1)
        next = cell_key(gids, base + CHUNK, n_rows, rows_per_agent, ncell);
    const unsigned heads = __ballot_sync(FULL, prev != key);
    const unsigned tails = __ballot_sync(FULL, next != key);
    int64_t keys[ROWS];
#pragma unroll
    for (int j = 0; j < ROWS; ++j) keys[j] = __shfl_sync(FULL, key, first + j);

    for (int vi = tl; vi < nvec; vi += TEAM) {
        if (vi != tl) load_rows(vi);  // rows wider than TEAM vectors
        float m[2 * WORDS];
#pragma unroll
        for (int k = 0; k < 2 * WORDS; ++k) m[k] = 0.0f;
        // the team's first and last pieces when they are not whole runs
        Piece<WORDS> shared_first, shared_last;
        shared_first.key = shared_last.key = -1;
        bool piece_head = (heads >> first) & 1u, at_first = true;
#pragma unroll
        for (int j = 0; j < ROWS; ++j) {
            const int i = first + j;
            if (i < valid) {
#pragma unroll
                for (int k = 0; k < WORDS; ++k) {
                    const float2 v = unpack(w[j][k]);
                    m[2 * k] = max_keep_zero(m[2 * k], v.x);
                    m[2 * k + 1] = max_keep_zero(m[2 * k + 1], v.y);
                }
                const bool piece_ends = j == ROWS - 1 || i + 1 == valid ||
                                        ((heads >> (i + 1)) & 1u);
                if (piece_ends) {
                    // a max of +0 leaves the zeroed cell as it is
                    bool raises = false;
#pragma unroll
                    for (int k = 0; k < 2 * WORDS; ++k) raises |= m[k] > 0.0f;
                    if (raises && piece_head && ((tails >> i) & 1u)) {
                        store_words<WORDS>(out + keys[j] * nw + vi * WORDS, m);
                    } else if (raises && at_first) {
                        shared_first.key = keys[j];
#pragma unroll
                        for (int k = 0; k < 2 * WORDS; ++k) shared_first.m[k] = m[k];
                    } else if (raises) {
                        shared_last.key = keys[j];
#pragma unroll
                        for (int k = 0; k < 2 * WORDS; ++k) shared_last.m[k] = m[k];
                    }
#pragma unroll
                    for (int k = 0; k < 2 * WORDS; ++k) m[k] = 0.0f;
                    piece_head = true;  // the next piece starts at a run head
                    at_first = false;
                }
            }
        }
        // merge the shared pieces: both reads in flight, then both rounds of CAS
        unsigned int cur_first[WORDS], cur_last[WORDS];
        unsigned int* dst_first = out + max(shared_first.key, (int64_t)0) * nw + vi * WORDS;
        unsigned int* dst_last = out + max(shared_last.key, (int64_t)0) * nw + vi * WORDS;
        if (shared_first.key >= 0) load_words<WORDS, false>(dst_first, cur_first);
        if (shared_last.key >= 0) load_words<WORDS, false>(dst_last, cur_last);
        if (shared_first.key >= 0) raise_words<WORDS>(dst_first, shared_first.m, cur_first);
        if (shared_last.key >= 0) raise_words<WORDS>(dst_last, shared_last.m, cur_last);
    }
}

}  // namespace

extern "C" int pillar_canvas_bf16(const void* rows, const void* gids, void* out,
                                  long long n_rows, long long rows_per_agent,
                                  int n_agents, int ncell, int channels,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const size_t canvas_bytes =
        (size_t)n_agents * (size_t)ncell * (size_t)channels * sizeof(__nv_bfloat16);
    cudaError_t err = cudaMemsetAsync(out, 0, canvas_bytes, s);
    if (err != cudaSuccess) return (int)err;
    if (n_rows > 0) {
        const long long warps = (n_rows + CHUNK - 1) / CHUNK;
        const unsigned blocks = (unsigned)((warps * 32 + THREADS - 1) / THREADS);
        const bool wide = channels % 8 == 0 &&
                          ((uintptr_t)rows | (uintptr_t)out) % 16 == 0;
        const auto* r = static_cast<const unsigned int*>(rows);
        const auto* g = static_cast<const int32_t*>(gids);
        auto* o = static_cast<unsigned int*>(out);
        if (wide)
            pillar_canvas_kernel<4><<<blocks, THREADS, 0, s>>>(
                r, g, o, n_rows, rows_per_agent, ncell, channels);
        else
            pillar_canvas_kernel<1><<<blocks, THREADS, 0, s>>>(
                r, g, o, n_rows, rows_per_agent, ncell, channels);
    }
    return (int)cudaGetLastError();
}

// Top-K categorical-depth splat onto a flat BEV canvas (kernel K4 of the port).
//
// Replaces: gencomm_tpu/ops/splat_pallas.py `_splat_kernel`, driven by
// `_splat_fwd_impl` / `splat_topk` (the TPU kernel that multiplies a (T, R)
// one-hot cell-membership matrix with stripe-padded update rows on the MXU),
// and the `jnp.argsort` that prepares its rows.
//
// What it computes: canvas[c, :] = sum over the (pixel p, depth k) pairs with
// ids[p, k] == c of dvals[p, k] * feats[p, :], fp32. With bf16_rows each
// product dvals * feats is rounded to bf16 (round to nearest even) before the
// fp32 sum. Cells that receive nothing are 0. An id outside [0, num_cells)
// drops its row.
//
// What bounds it on Hopper: bytes. At the camera model's eval shapes it reads
// 12.6 MB of features and 3 x 0.8 MB of weights and indices and writes a
// 67 MB canvas, of which the rows land in a few thousand cells; the 50 MFLOP
// of products are nothing beside that. Almost all of the bound is the canvas
// written once.
//
// Design: everything from the raw ids on happens here, in launches that
// follow each other on the caller's stream with no host work between them.
//   1. A counting sort by cell, since ids are bounded by num_cells:
//      `splat_count_kernel` builds the histogram of the cells with int
//      atomics (a 0.5-1 MB table that lives in the L2) and keeps each row's
//      arrival number; `splat_scan_kernel` scans the num_cells + 1 counters
//      in tiles of 1024 (an exclusive scan inside each tile, the tiles' sums
//      scanned by the block that finishes last);
//      `splat_place_kernel` puts each flat row r = p * K + k, with its id, at
//      its cell's offset plus its arrival number. Dropped rows are counted
//      into no cell and are not read again.
//   2. Arrival numbers come from atomics, so the rows of a cell stand in an
//      order that changes from launch to launch. Each cell's segment is put
//      into ascending flat row, the order of a stable sort by cell, so the
//      sum order within a cell is fixed: the same bits on every launch.
//      A segment of at most LONG_SEGMENT rows is ranked by
//      `splat_order_kernel`: one thread per placed row counts the rows of
//      its segment that are smaller (the lanes of a warp mostly share a
//      segment, so these loads are broadcasts) and writes the row to that
//      rank. That is quadratic in the segment's length, which is a few
//      dozen rows at the camera model's shapes but has no bound in general:
//      K1b's input gradient (csrc/deform_conv_bwd.cu) sums its records
//      here, and offsets that pull every tap towards one pixel give that
//      pixel thousands of records, or all of them. So the order kernel
//      lists the longer segments, and `splat_long_sort_kernel` sorts each
//      with one block: a bitonic network of O(n log^2 n) comparators, in
//      shared memory up to SORT_SHARED rows and in place in the order array
//      beyond.
//   3. The canvas is written once. Zeros go only to the cells whose counter
//      is 0, as 16-byte streaming stores, and occupied cells are stored by
//      the sum alone; there is no memset of the canvas. The zeros are the
//      one pass bound by the card's memory rate, and the scan, the
//      placement, the ordering and the merge wait on memory latency, so the
//      zeros are dealt out to those four kernels as extra blocks (`ZeroJob`)
//      that run beside each kernel's own.
//   4. The sum: `splat_pieces_kernel` gives each warp a chunk of CHUNK
//      consecutive sorted rows; lane l owns channels 4l .. 4l+3 (one float4
//      of a 128-channel row, so a warp reads one 512-byte feature row per
//      step, IN_FLIGHT rows in flight: two, since more registers a thread
//      cost more in resident warps than they gain) and sums the rows of each
//      run of equal ids in sorted order. A run that lies inside the chunk is stored straight
//      to its cell, which has no other writer. A run that crosses a chunk
//      boundary is cut into pieces: the piece that holds the run's head goes
//      to `trail[chunk]`, every later piece to `lead[chunk]`.
//      `splat_merge_kernel` gives each chunk whose last run continues one
//      warp that finds how far the run reaches (32 chunks a step, by a
//      vote), adds trail[chunk] and the lead pieces of the following chunks,
//      in chunk order, and stores the cell. Long runs (the cells just
//      in front of a camera collect hundreds of rows) are thus spread over
//      many warps, and every cell is summed in one fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;    // sorted rows per warp
constexpr int TILE = 1024;   // counters per block of the scan
constexpr int THREADS = 256;
constexpr int ZERO_VECS = 4 * THREADS;  // float4 slots a zeroing block covers
constexpr int IN_FLIGHT = 2;  // independent 16-byte loads a lane of the sum keeps in flight
constexpr int LONG_SEGMENT = 256;     // longer segments are sorted by a block
constexpr int SORT_SHARED = 8192;     // rows a block sorts in shared memory
constexpr int SORT_THREADS = 512;     // threads a block of the long-segment sort
constexpr unsigned SORT_BLOCKS = 1024;  // the long-segment sort's largest grid
constexpr unsigned FULL = 0xffffffffu;

// The int scratch, in ints (ops/splat.py:forward_scratch sizes it alike):
// counts (num_cells + 1), ticket (1), the number of long segments (1), local
// offsets (num_cells + 1), tile offsets (tiles + 1), arrival (m; after the
// placement, the list of long segments), placed (m), order (m), sorted ids
// (m).
struct Scratch {
    int* counts; int* ticket; int* nlong; int* local; int* tiles; int* arrival;
    int* placed; int* order; int* sids;
    int n_tiles;
};

inline Scratch carve(int* base, long long m, int num_cells) {
    Scratch s;
    const long long n = (long long)num_cells + 1;
    s.n_tiles = (int)((n + TILE - 1) / TILE);
    s.counts = base;
    s.ticket = s.counts + n;
    s.nlong = s.ticket + 1;
    s.local = s.nlong + 1;
    s.tiles = s.local + n;
    s.arrival = s.tiles + s.n_tiles + 1;
    s.placed = s.arrival + m;
    s.order = s.placed + m;
    s.sids = s.order + m;
    return s;
}

__device__ __forceinline__ float round_bf16(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
}

// acc += w * f without contraction into an FMA: the plain version multiplies,
// rounds, then adds
template <bool BF16>
__device__ __forceinline__ void add_row(float4& acc, float w, const float4 f) {
    float x = __fmul_rn(w, f.x), y = __fmul_rn(w, f.y);
    float z = __fmul_rn(w, f.z), t = __fmul_rn(w, f.w);
    if (BF16) {
        x = round_bf16(x); y = round_bf16(y);
        z = round_bf16(z); t = round_bf16(t);
    }
    acc.x = __fadd_rn(acc.x, x); acc.y = __fadd_rn(acc.y, y);
    acc.z = __fadd_rn(acc.z, z); acc.w = __fadd_rn(acc.w, t);
}

// ---- 3. zeros to the empty cells, carried by the other kernels --------------
// A share of the canvas, in float4 slots [first, end): the blocks a kernel is
// given beyond its own work store zeros to the cells of that share whose
// counter is 0, 16 bytes a thread, ZERO_VECS slots a block.
struct ZeroJob {
    const int* counts;
    float4* canvas;
    int64_t first, end;
    int vec;  // float4 slots a cell

    __device__ __forceinline__ void run(unsigned block) const {
        // one 64-bit division a thread, the four slots' cells by 32-bit ones
        const int64_t block_first = first + (int64_t)block * ZERO_VECS;
        const int64_t first_cell = block_first / vec;
        const unsigned rem =
            (unsigned)(block_first - first_cell * vec) + threadIdx.x;
        bool empty[4];
        for (int i = 0; i < 4; ++i) {
            const int64_t cell = first_cell + (rem + i * THREADS) / (unsigned)vec;
            empty[i] = block_first + threadIdx.x + i * THREADS < end &&
                       counts[cell] == 0;
        }
        for (int i = 0; i < 4; ++i)
            if (empty[i])
                __stcs(canvas + block_first + threadIdx.x + i * THREADS,
                       make_float4(0.0f, 0.0f, 0.0f, 0.0f));
    }
};

// ---- 1. counting sort by cell ----------------------------------------------
__global__ void splat_count_kernel(const int32_t* __restrict__ ids,
                                   int* __restrict__ counts,
                                   int* __restrict__ arrival, int64_t m,
                                   int num_cells) {
    const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (r >= m) return;
    const int id = ids[r];
    if (id >= 0 && id < num_cells) arrival[r] = atomicAdd(counts + id, 1);
}

// local[i] = sum of counts[tile start .. i), tiles[t] = sum of the tiles
// before t, tiles[n_tiles] = the number of rows kept
__global__ void splat_scan_kernel(const int* __restrict__ counts,
                                  int* __restrict__ local,
                                  int* __restrict__ tiles,
                                  int* __restrict__ ticket, int64_t n,
                                  int n_tiles, ZeroJob zeros) {
    if (blockIdx.x >= n_tiles) return zeros.run(blockIdx.x - n_tiles);
    __shared__ int warp_sums[THREADS / 32];
    __shared__ int carry;
    __shared__ bool last;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t first = (int64_t)blockIdx.x * TILE + threadIdx.x * 4;
    int v[4], sum = 0;
    for (int i = 0; i < 4; ++i) {
        v[i] = first + i < n ? counts[first + i] : 0;
        sum += v[i];
    }
    int incl = sum;  // inclusive scan of the threads' sums over the warp
    for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = incl - sum;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    for (int i = 0; i < 4; ++i) {
        if (first + i < n) local[first + i] = before;
        before += v[i];
    }
    if (threadIdx.x == THREADS - 1) {
        tiles[blockIdx.x] = before;  // this tile's sum, scanned below
        __threadfence();
        last = atomicAdd(ticket, 1) == n_tiles - 1;
    }
    __syncthreads();
    if (!last) return;
    // the block that finishes last scans the tiles' sums, THREADS at a time
    __threadfence();
    if (threadIdx.x == 0) carry = 0;
    __syncthreads();
    for (int base = 0; base < n_tiles; base += THREADS) {
        const int t = base + threadIdx.x;
        const int x = t < n_tiles ? __ldcg(tiles + t) : 0;
        int inc = x;
        for (int d = 1; d < 32; d <<= 1) {
            const int up = __shfl_up_sync(FULL, inc, d);
            if (lane >= d) inc += up;
        }
        if (lane == 31) warp_sums[warp] = inc;
        __syncthreads();
        int pre = carry + inc - x;
        for (int w = 0; w < warp; ++w) pre += warp_sums[w];
        if (t < n_tiles) tiles[t] = pre;
        __syncthreads();
        if (threadIdx.x == THREADS - 1) carry = pre + x;
        __syncthreads();
    }
    if (threadIdx.x == 0) tiles[n_tiles] = carry;
}

__device__ __forceinline__ int cell_offset(const int* __restrict__ local,
                                           const int* __restrict__ tiles,
                                           int cell) {
    return local[cell] + tiles[cell / TILE];
}

// puts each kept row at its cell's offset plus its arrival number; the sorted
// ids are final here, since a segment holds one id
__global__ void splat_place_kernel(const int32_t* __restrict__ ids,
                                   const int* __restrict__ local,
                                   const int* __restrict__ tiles,
                                   const int* __restrict__ arrival,
                                   int* __restrict__ placed,
                                   int* __restrict__ sids, int64_t m,
                                   int num_cells, unsigned row_blocks,
                                   ZeroJob zeros) {
    if (blockIdx.x >= row_blocks) return zeros.run(blockIdx.x - row_blocks);
    const int64_t r = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (r >= m) return;
    const int id = ids[r];
    if (id >= 0 && id < num_cells) {
        const int at = cell_offset(local, tiles, id) + arrival[r];
        placed[at] = (int)r;
        sids[at] = id;
    }
}

// ---- 2. each cell's segment into ascending flat row -------------------------
// a segment of at most LONG_SEGMENT rows by rank counts; a longer one is put
// on the list `longs` (its id, once) for splat_long_sort_kernel
__global__ void splat_order_kernel(const int32_t* __restrict__ sids,
                                   const int* __restrict__ counts,
                                   const int* __restrict__ local,
                                   const int* __restrict__ tiles,
                                   const int* __restrict__ placed,
                                   int* __restrict__ order,
                                   int* __restrict__ nlong,
                                   int* __restrict__ longs, int n_tiles,
                                   unsigned row_blocks, ZeroJob zeros) {
    if (blockIdx.x >= row_blocks) return zeros.run(blockIdx.x - row_blocks);
    const int64_t q = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (q >= tiles[n_tiles]) return;
    const int row = placed[q];
    const int id = sids[q];
    const int start = cell_offset(local, tiles, id);
    const int n = counts[id];
    if (n > LONG_SEGMENT) {
        if (q == start) longs[atomicAdd(nlong, 1)] = id;
        return;
    }
    int rank = 0;
    for (int j = 0; j < n; ++j) rank += placed[start + j] < row;
    order[start + rank] = row;
}

// sorts a[0, n) ascending in place with the block's threads: the bitonic
// network in its all-ascending form (each merge starts by comparing mirrored
// halves), where a comparator always puts the smaller value first. Padded to
// a power of two with +inf at n and beyond, such a network never moves the
// padding, so the comparators that reach past n are skipped. The keys (flat
// rows) are distinct. Ends with the block synchronised.
__device__ void block_bitonic_sort(int* a, unsigned n) {
    unsigned long long p2 = 1;
    while (p2 < n) p2 <<= 1;
    for (unsigned long long k = 2; k <= p2; k <<= 1) {
        for (unsigned j = (unsigned)(k >> 1); j > 0; j >>= 1) {
            for (unsigned t = threadIdx.x; t < p2 / 2; t += blockDim.x) {
                const unsigned i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
                const unsigned o =
                    2 * (unsigned long long)j == k ? i ^ (unsigned)(k - 1) : i + j;
                if (o < n) {
                    const int x = a[i], y = a[o];
                    if (y < x) { a[i] = y; a[o] = x; }
                }
            }
            __syncthreads();
        }
    }
}

// the segments longer than LONG_SEGMENT, one block each (grid-stride over the
// list): the placed rows into ascending order
__global__ void splat_long_sort_kernel(const int* __restrict__ counts,
                                       const int* __restrict__ local,
                                       const int* __restrict__ tiles,
                                       const int* __restrict__ placed,
                                       int* __restrict__ order,
                                       const int* __restrict__ nlong,
                                       const int* __restrict__ longs) {
    __shared__ int rows[SORT_SHARED];
    const int count = *nlong;
    for (int s = blockIdx.x; s < count; s += gridDim.x) {
        const int id = longs[s];
        const int start = cell_offset(local, tiles, id);
        const int n = counts[id];
        int* a = n <= SORT_SHARED ? rows : order + start;
        for (int t = threadIdx.x; t < n; t += blockDim.x) a[t] = placed[start + t];
        __syncthreads();
        block_bitonic_sort(a, (unsigned)n);
        if (n <= SORT_SHARED)
            for (int t = threadIdx.x; t < n; t += blockDim.x) order[start + t] = rows[t];
        __syncthreads();
    }
}

// ---- 4. the sum --------------------------------------------------------------
template <bool BF16>
__global__ void splat_pieces_kernel(const float* __restrict__ dvals,
                                    const float* __restrict__ feats,
                                    const int32_t* __restrict__ sids,
                                    const int32_t* __restrict__ order,
                                    const int* __restrict__ kept,
                                    float* __restrict__ canvas,
                                    float* __restrict__ lead,
                                    float* __restrict__ trail,
                                    int k, int channels) {
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t m = *kept;  // the rows that were not dropped
    const int64_t begin = warp * CHUNK;
    if (begin >= m) return;
    const int n = (int)min((int64_t)CHUNK, m - begin);

    // lane j holds row j of the chunk: its cell, its pixel and its weight
    int my_id = -1, my_pixel = 0;
    float my_w = 0.0f;
    if (lane < n) {
        my_id = sids[begin + lane];
        const int row = order[begin + lane];
        my_pixel = row / k;
        my_w = dvals[row];
    }
    const int prev_id = begin > 0 ? sids[begin - 1] : -1;
    const int next_id = begin + n < m ? sids[begin + n] : -1;
    const int left_id = __shfl_up_sync(FULL, my_id, 1);
    // bit j: row j is the first of its run within the chunk
    const unsigned heads =
        __ballot_sync(FULL, lane < n && (lane == 0 || left_id != my_id));

    const int vec = channels >> 2;
    const float4* feats4 = reinterpret_cast<const float4*>(feats);
    for (int c4 = lane; c4 - lane < vec; c4 += 32) {
        const bool active = c4 < vec;
        const float4* col = feats4 + (active ? c4 : 0);
        int j = 0;
        while (j < n) {
            const int g = __shfl_sync(FULL, my_id, j);
            const int start = j;
            const unsigned later = j + 1 < 32 ? heads >> (j + 1) : 0u;
            const int stop = later ? j + __ffs(later) : n;
            float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            for (; j + IN_FLIGHT <= stop; j += IN_FLIGHT) {
                float4 f[IN_FLIGHT];
                float w[IN_FLIGHT];
#pragma unroll
                for (int i = 0; i < IN_FLIGHT; ++i) {
                    const int px = __shfl_sync(FULL, my_pixel, j + i);
                    w[i] = __shfl_sync(FULL, my_w, j + i);
                    f[i] = col[(int64_t)px * vec];
                }
                if (active) {
#pragma unroll
                    for (int i = 0; i < IN_FLIGHT; ++i)
                        add_row<BF16>(acc, w[i], f[i]);
                }
            }
            for (; j < stop; ++j) {
                const int px = __shfl_sync(FULL, my_pixel, j);
                const float w = __shfl_sync(FULL, my_w, j);
                const float4 f = col[(int64_t)px * vec];
                if (active) add_row<BF16>(acc, w, f);
            }
            const bool head = start > 0 || prev_id != g;
            const bool ends = j < n || next_id != g;
            if (active) {
                float* dst = head && ends ? canvas + (int64_t)g * channels
                           : (head ? trail : lead) + warp * channels;
                reinterpret_cast<float4*>(dst)[c4] = acc;
            }
        }
    }
}

__global__ void splat_merge_kernel(const int32_t* __restrict__ sids,
                                   const int* __restrict__ kept,
                                   float* __restrict__ canvas,
                                   const float* __restrict__ lead,
                                   const float* __restrict__ trail,
                                   int channels, unsigned chunk_blocks,
                                   ZeroJob zeros) {
    if (blockIdx.x >= chunk_blocks) return zeros.run(blockIdx.x - chunk_blocks);
    const int64_t warp = (blockIdx.x * (int64_t)blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    const int64_t m = *kept;
    const int64_t begin = warp * CHUNK;
    const int64_t end = begin + CHUNK;
    if (end >= m) return;  // no later chunk for a run to continue into
    const int g = sids[end - 1];
    if (sids[end] != g) return;  // the last run ends here
    // the run's head lies in an earlier chunk: that chunk's warp merges it
    if (begin > 0 && sids[begin] == g && sids[begin - 1] == g) return;

    // how many of the following chunks begin with a piece of this run: the
    // lanes look at 32 chunks a step
    int64_t reach = 0;
    for (;;) {
        const int64_t c2 = warp + 1 + reach + lane;
        const unsigned on = __ballot_sync(
            FULL, c2 * CHUNK < m && sids[c2 * CHUNK] == g);
        const int n = on == FULL ? 32 : __ffs(~on) - 1;
        reach += n;
        if (n < 32) break;
    }
    const int vec = channels >> 2;
    const float4* lead4 = reinterpret_cast<const float4*>(lead);
    for (int c4 = lane; c4 < vec; c4 += 32) {
        float4 acc = reinterpret_cast<const float4*>(trail)[warp * vec + c4];
        for (int64_t b = 0; b < reach; b += IN_FLIGHT) {  // added in chunk order
            float4 v[IN_FLIGHT];
            for (int i = 0; i < IN_FLIGHT; ++i)
                if (b + i < reach) v[i] = lead4[(warp + 1 + b + i) * vec + c4];
            for (int i = 0; i < IN_FLIGHT; ++i) {
                if (b + i >= reach) break;
                acc.x = __fadd_rn(acc.x, v[i].x); acc.y = __fadd_rn(acc.y, v[i].y);
                acc.z = __fadd_rn(acc.z, v[i].z); acc.w = __fadd_rn(acc.w, v[i].w);
            }
        }
        reinterpret_cast<float4*>(canvas + (int64_t)g * channels)[c4] = acc;
    }
}

}  // namespace

// dvals (M,), feats (P, channels), ids (M,) raw cell ids, canvas (num_cells,
// channels); ints: the int scratch laid out as `carve` says; pieces: float
// scratch of 2 x ceil(M / 32) x channels; channels % 4 == 0. After the call
// the scratch holds the number of kept rows, their order and sorted ids.
extern "C" int splat_topk_f32(const void* dvals, const void* feats,
                              const void* ids, void* canvas, void* ints,
                              void* pieces, long long m, int k, int channels,
                              int num_cells, int bf16_rows, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (num_cells <= 0 || channels <= 0) return (int)cudaGetLastError();
    const Scratch sc = carve(static_cast<int*>(ints), m, num_cells);
    const long long n = (long long)num_cells + 1;
    const int vec = channels >> 2;
    const float* d = static_cast<const float*>(dvals);
    const float* f = static_cast<const float*>(feats);
    const int32_t* id = static_cast<const int32_t*>(ids);
    float* cv = static_cast<float*>(canvas);

    // The zeros are split over the kernels that wait on memory latency and
    // leave the card's bandwidth idle (eighths: scan 1, place 1, order 3,
    // merge 3; all to the scan when there are no rows).
    const unsigned row_blocks = (unsigned)((m + THREADS - 1) / THREADS);
    const long long zero_blocks =
        ((long long)num_cells * vec + ZERO_VECS - 1) / ZERO_VECS;
    const int eighths[5] = {0, 1, 2, 5, 8};
    ZeroJob jobs[4];
    unsigned job_blocks[4];
    for (int i = 0; i < 4; ++i) {
        const long long b0 = row_blocks ? zero_blocks * eighths[i] / 8 : 0;
        const long long b1 = row_blocks ? zero_blocks * eighths[i + 1] / 8
                                        : (i == 0 ? zero_blocks : 0);
        jobs[i] = ZeroJob{sc.counts, reinterpret_cast<float4*>(cv), b0 * ZERO_VECS,
                          (long long)num_cells * vec, vec};
        if (b1 * ZERO_VECS < jobs[i].end) jobs[i].end = b1 * ZERO_VECS;
        job_blocks[i] = (unsigned)(b1 - b0);
    }

    // counts, the ticket and the number of long segments start at 0
    cudaError_t err = cudaMemsetAsync(sc.counts, 0, (size_t)(n + 2) * sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    if (row_blocks) {
        splat_count_kernel<<<row_blocks, THREADS, 0, s>>>(id, sc.counts, sc.arrival,
                                                          m, num_cells);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    splat_scan_kernel<<<sc.n_tiles + job_blocks[0], THREADS, 0, s>>>(
        sc.counts, sc.local, sc.tiles, sc.ticket, n, sc.n_tiles, jobs[0]);
    err = cudaGetLastError();
    if (err != cudaSuccess || !row_blocks) return (int)err;
    splat_place_kernel<<<row_blocks + job_blocks[1], THREADS, 0, s>>>(
        id, sc.local, sc.tiles, sc.arrival, sc.placed, sc.sids, m, num_cells,
        row_blocks, jobs[1]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    splat_order_kernel<<<row_blocks + job_blocks[2], THREADS, 0, s>>>(
        sc.sids, sc.counts, sc.local, sc.tiles, sc.placed, sc.order, sc.nlong,
        sc.arrival, sc.n_tiles, row_blocks, jobs[2]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long most_long = m / (LONG_SEGMENT + 1);  // long segments at most
    if (most_long > 0) {
        const unsigned sort_blocks =
            most_long < SORT_BLOCKS ? (unsigned)most_long : SORT_BLOCKS;
        splat_long_sort_kernel<<<sort_blocks, SORT_THREADS, 0, s>>>(
            sc.counts, sc.local, sc.tiles, sc.placed, sc.order, sc.nlong, sc.arrival);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }

    const long long chunks = (m + CHUNK - 1) / CHUNK;
    const unsigned blocks = (unsigned)((chunks * 32 + THREADS - 1) / THREADS);
    const int* kept = sc.tiles + sc.n_tiles;
    float* ld = static_cast<float*>(pieces);
    float* tr = ld + chunks * channels;
    if (bf16_rows) {
        splat_pieces_kernel<true><<<blocks, THREADS, 0, s>>>(
            d, f, sc.sids, sc.order, kept, cv, ld, tr, k, channels);
    } else {
        splat_pieces_kernel<false><<<blocks, THREADS, 0, s>>>(
            d, f, sc.sids, sc.order, kept, cv, ld, tr, k, channels);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    splat_merge_kernel<<<blocks + job_blocks[3], THREADS, 0, s>>>(
        sc.sids, kept, cv, ld, tr, channels, blocks, jobs[3]);
    return (int)cudaGetLastError();
}

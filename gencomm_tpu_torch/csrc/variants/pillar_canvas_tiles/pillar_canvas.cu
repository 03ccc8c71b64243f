// Pillar segment-max canvas (kernel K2 of the port): a redesign that lost.
//
// Not built by the package. It has the C interface of
// gencomm_tpu_torch/csrc/pillar_canvas.cu and is timed beside it with
//     python3 scripts/bench_splat_canvas_torch.py --cases K2 \
//         --variant tiles=gencomm_tpu_torch/csrc/variants/pillar_canvas_tiles
// On an NVIDIA H100 it is slower than the package's memset plus row-chunk
// kernel at the lidar eval and train-step shapes (PERF.md, PR 6, has the
// times): every block's chain of dependent steps (the 32-way row-range
// search, a cluster barrier, the row loads and their flush, a second
// barrier) runs before its tile can be written, and four blocks an SM do
// not hide it.
//
// Replaces: gencomm_tpu/ops/pillar_pallas.py `_kernel` / `striped_pillar_canvas`
// (the TPU kernel that one-hot-matmuls stripe-padded row chunks on the MXU).
//
// What it computes: canvas[a, cell, c] = max(0, max over rows r of agent a
// with clamp(gid[r]) == cell of rows[r, c]), bf16 in and out. Rows arrive
// sorted by gid within each agent (the host decorator's contract); gids are
// clamped to [0, ncell - 1], which keeps them sorted (the invalid rows, ids
// >= ncell with zero features, all fall into cell ncell - 1).
//
// What bounds it on Hopper: bytes. Per flagship frame it reads ~7.7 MB of
// rows and writes a 33.5 MB canvas, with no arithmetic to speak of.
//
// Design: every canvas byte is written once, by one launch: no memset, no
// global atomics. A block owns a tile of TILE cells of one agent, kept in
// shared memory as bf16, zeroed there and written out whole with coalesced
// stores. Eight blocks form a thread-block cluster that covers 8 x TILE
// consecutive cells; each finds the cluster's row range [lower_bound(c0),
// lower_bound(c0 + 8 TILE)) in the agent's sorted gids by a 32-way warp
// search, and takes one eighth of those rows, whichever tiles they fall in.
// So the long invalid tail of an agent (up to ~11,000 rows of cell
// ncell - 1, 1.4 MB) is read by eight SMs, not one; the clusters that hold
// the agents' last cells are launched first. A team of 8 lanes reads a row
// as 16-byte vectors (4 rows per warp step, 8 rows in flight per lane) and
// keeps the running max of a run of equal cells in registers; at the run's
// end it stores the max into the owning block's shared tile (through
// distributed shared memory) with a plain store when the run lies wholly in
// the team's 32-row segment, or with a compare-and-swap max when the run
// crosses a segment boundary. Two cluster barriers order zeroing, folding
// and writing. The max is taken on the bf16 bit patterns as signed 16-bit
// integers (`__vmaxs2`) starting from +0: for the non-negative values that
// is the float max, and every negative value, -0.0 included, loses to +0,
// as with the fmaxf(0.0f, v) of the first version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CLUSTER = 8;   // blocks a cluster
constexpr int THREADS = 256;
constexpr int TEAM = 8;      // lanes a row
constexpr int SEG = 8;       // rows a team walks in one segment
constexpr int BATCH = 8;     // rows in flight per team
constexpr int MAX_TILE = 256; // cells a block

__device__ __forceinline__ int clamp_gid(int g, int ncell) {
    return g < 0 ? 0 : (g >= ncell ? ncell - 1 : g);
}

// first row in [0, n) whose clamped gid is >= key (n if none), one warp
__device__ int lower_bound_warp(const int32_t* gids, int64_t n, int key,
                                int ncell, int lane) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        const int64_t len = hi - lo;
        const int64_t p = lo + len * (lane + 1) / 32;  // lane 31 -> hi
        const bool ge = lane == 31 || p >= hi || clamp_gid(gids[p], ncell) >= key;
        const int j = __ffs(__ballot_sync(0xffffffffu, ge)) - 1;
        const int64_t pj = __shfl_sync(0xffffffffu, p, j);
        const int64_t before = __shfl_sync(0xffffffffu, p, j > 0 ? j - 1 : 0);
        if (j < 31) hi = pj;
        lo = j > 0 ? before + 1 : lo;
    }
    return (int)lo;
}

template <int VEC>
struct Unit;
template <>
struct Unit<8> { using T = uint4; };
template <>
struct Unit<2> { using T = uint32_t; };

__device__ __forceinline__ uint4 vmax(uint4 a, uint4 b) {
    return make_uint4(__vmaxs2(a.x, b.x), __vmaxs2(a.y, b.y),
                      __vmaxs2(a.z, b.z), __vmaxs2(a.w, b.w));
}
__device__ __forceinline__ uint32_t vmax(uint32_t a, uint32_t b) {
    return __vmaxs2(a, b);
}
template <typename T> __device__ __forceinline__ T zero_unit();
template <> __device__ __forceinline__ uint4 zero_unit<uint4>() {
    return make_uint4(0u, 0u, 0u, 0u);
}
template <> __device__ __forceinline__ uint32_t zero_unit<uint32_t>() { return 0u; }

// max of v into *p, whose value was read as `old`
__device__ __forceinline__ void cas_max(uint32_t* p, uint32_t v, uint32_t old) {
    while (true) {
        const uint32_t nv = __vmaxs2(old, v);
        if (nv == old) return;
        const uint32_t prev = atomicCAS(p, old, nv);
        if (prev == old) return;
        old = prev;
    }
}
__device__ __forceinline__ void merge_unit(uint4* p, uint4 v) {
    const uint4 old = *p;  // one read; a stale word only costs a CAS retry
    uint32_t* w = reinterpret_cast<uint32_t*>(p);
    cas_max(w, v.x, old.x); cas_max(w + 1, v.y, old.y);
    cas_max(w + 2, v.z, old.z); cas_max(w + 3, v.w, old.w);
}
__device__ __forceinline__ void merge_unit(uint32_t* p, uint32_t v) { cas_max(p, v, *p); }
__device__ __forceinline__ bool is_zero(uint4 v) { return (v.x | v.y | v.z | v.w) == 0u; }
__device__ __forceinline__ bool is_zero(uint32_t v) { return v == 0u; }

template <int VEC>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
pillar_canvas_kernel(const uint16_t* __restrict__ rows,
                     const int32_t* __restrict__ gids,
                     uint16_t* __restrict__ out, int64_t rows_per_agent,
                     int n_agents, int ncell, int channels, int tile,
                     int clusters_per_agent) {
    using T = typename Unit<VEC>::T;
    extern __shared__ __align__(16) uint16_t smem[];  // tile x channels bf16
    __shared__ int range[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

    // the agents' last clusters first: they hold the invalid tails
    const int cid = blockIdx.x / CLUSTER;
    const int agent = cid % n_agents;
    const int ccell = (clusters_per_agent - 1 - cid / n_agents) * CLUSTER * tile;
    const int c0 = ccell + rank * tile;  // this block's first cell
    const int32_t* ag = gids + agent * rows_per_agent;
    const uint16_t* ar = rows + agent * rows_per_agent * channels;

    if (warp < 2)
        range[warp] = lower_bound_warp(ag, rows_per_agent,
                                       ccell + warp * CLUSTER * tile, ncell, lane);
    const int tile_words = tile * channels / 2;
    uint32_t* sw = reinterpret_cast<uint32_t*>(smem);
    for (int i = threadIdx.x; i < tile_words; i += THREADS) sw[i] = 0u;
    cluster.sync();

    // this block's eighth of the cluster's rows, in segments of SEG rows
    const int64_t r_lo = range[0], r_n = range[1] - r_lo;
    const int64_t s0 = r_lo + r_n * rank / CLUSTER;
    const int64_t s1 = r_lo + r_n * (rank + 1) / CLUSTER;
    const int nvec = channels / VEC;
    const int team = threadIdx.x / TEAM, tl = threadIdx.x % TEAM;
    const unsigned tmask = 0xffu << ((team % 4) * TEAM);
    constexpr int TEAMS = THREADS / TEAM;
    for (int64_t a = s0 + (int64_t)team * SEG; a < s1; a += (int64_t)TEAMS * SEG) {
        const int64_t b = min(a + SEG, s1);
        const int prev = a > 0 ? clamp_gid(ag[a - 1], ncell) : -1;
        const int next = b < rows_per_agent ? clamp_gid(ag[b], ncell) : -1;
        for (int u0 = 0; u0 < nvec; u0 += TEAM) {
            const int u = u0 + tl;
            const bool active = u < nvec;
            int cur = -1;
            bool head = false;
            T acc = zero_unit<T>();
            auto flush = [&](bool whole) {
                // the tile starts at +0: a max of +0 changes nothing
                if (cur < 0 || !active || is_zero(acc)) return;
                const int local = cur - ccell;
                uint16_t* tile_base = cluster.map_shared_rank(smem, local / tile);
                T* dst = reinterpret_cast<T*>(
                    tile_base + (int64_t)(local % tile) * channels) + u;
                if (head && whole) *dst = acc;
                else merge_unit(dst, acc);
            };
            for (int64_t r0 = a; r0 < b; r0 += BATCH) {
                const int nb = (int)min((int64_t)BATCH, b - r0);
                const int my_g = tl < nb ? clamp_gid(ag[r0 + tl], ncell) : 0;
                T v[BATCH];
#pragma unroll
                for (int i = 0; i < BATCH; ++i)
                    v[i] = (i < nb && active)
                        ? reinterpret_cast<const T*>(ar + (r0 + i) * channels)[u]
                        : zero_unit<T>();
#pragma unroll
                for (int i = 0; i < BATCH; ++i) {
                    const int g = __shfl_sync(tmask, my_g, (team % 4) * TEAM + i);
                    if (i >= nb) break;
                    if (g != cur) {
                        flush(true);  // the run ended inside the segment
                        head = (r0 + i == a) ? g != prev : true;
                        cur = g;
                        acc = zero_unit<T>();
                    }
                    acc = vmax(acc, v[i]);
                }
            }
            flush(next != cur);
        }
    }
    cluster.sync();

    // the tile, zeros included, written once
    const int cells = max(0, min(tile, ncell - c0));
    uint16_t* dst = out + ((int64_t)agent * ncell + c0) * channels;
    if (channels % 8 == 0) {
        const int n16 = cells * channels / 8;
        for (int i = threadIdx.x; i < n16; i += THREADS)
            reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(smem)[i];
    } else {
        const int n4 = cells * channels / 2;
        for (int i = threadIdx.x; i < n4; i += THREADS)
            reinterpret_cast<uint32_t*>(dst)[i] = sw[i];
    }
}

}  // namespace

extern "C" int pillar_canvas_bf16(const void* rows, const void* gids, void* out,
                                  long long n_rows, long long rows_per_agent,
                                  int n_agents, int ncell, int channels,
                                  void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (n_agents <= 0 || ncell <= 0 || channels <= 0) return (int)cudaSuccess;
    if (channels % 2 || n_rows != rows_per_agent * n_agents)
        return (int)cudaErrorInvalidValue;
    // cells a block: MAX_TILE, fewer for wide rows (48 KB of shared memory)
    const int tile = max(1, min(MAX_TILE, (48 << 10) / (2 * channels)));
    const size_t smem = (size_t)tile * channels * 2;
    if (smem > (48 << 10)) return (int)cudaErrorInvalidValue;
    const int clusters_per_agent = (ncell + CLUSTER * tile - 1) / (CLUSTER * tile);
    const unsigned blocks = (unsigned)clusters_per_agent * n_agents * CLUSTER;
    if (channels % 8 == 0)
        pillar_canvas_kernel<8><<<blocks, THREADS, smem, s>>>(
            static_cast<const uint16_t*>(rows), static_cast<const int32_t*>(gids),
            static_cast<uint16_t*>(out), rows_per_agent, n_agents, ncell,
            channels, tile, clusters_per_agent);
    else
        pillar_canvas_kernel<2><<<blocks, THREADS, smem, s>>>(
            static_cast<const uint16_t*>(rows), static_cast<const int32_t*>(gids),
            static_cast<uint16_t*>(out), rows_per_agent, n_agents, ncell,
            channels, tile, clusters_per_agent);
    return (int)cudaGetLastError();
}

// Native pillar/voxel generator for the host data path.
//
// Role parity: the reference voxelizes on CPU inside the DataLoader via
// spconv's VoxelGeneratorV2 / Point2VoxelCPU3d
// (opencood/data_utils/pre_processor/sp_voxel_preprocessor.py:22-60):
// points -> fixed-capacity voxel lists (max_voxels, max_points_per_voxel, D)
// + integer coords + per-voxel counts, first-come order, points beyond the
// per-voxel cap dropped.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// Single pass over the points with a dense int32 cell->slot table; the
// table is caller-provided scratch so repeated calls do not reallocate.
//
// Build: g++ -O3 -march=native -shared -fPIC voxelizer.cpp -o libvoxelizer.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

extern "C" {

// Returns the number of voxels written (<= max_voxels).
// points:        (n_points, point_dim) float32, xyz in the first 3 dims
// pc_range:      (6,) [xmin, ymin, zmin, xmax, ymax, zmax]
// voxel_size:    (3,)
// scratch_table: (nx * ny * nz,) int32, must be filled with -1 by the
//                caller on first use; reset happens inside using the
//                emitted coords (O(#voxels), not O(#cells)).
// out_voxels:    (max_voxels, max_points, point_dim) float32 (zero-filled
//                here for used slots only — pass a reused buffer)
// out_coords:    (max_voxels, 3) int32 as (iz, iy, ix)  [spconv zyx order]
// out_counts:    (max_voxels,) int32
int32_t voxelize(const float* points, int64_t n_points, int32_t point_dim,
                 const float* pc_range, const float* voxel_size,
                 int32_t max_voxels, int32_t max_points,
                 int32_t* scratch_table,
                 float* out_voxels, int32_t* out_coords,
                 int32_t* out_counts) {
    const float x0 = pc_range[0], y0 = pc_range[1], z0 = pc_range[2];
    const float x1 = pc_range[3], y1 = pc_range[4], z1 = pc_range[5];
    const float inv_vx = 1.0f / voxel_size[0];
    const float inv_vy = 1.0f / voxel_size[1];
    const float inv_vz = 1.0f / voxel_size[2];
    const int64_t nx = (int64_t)std::lround((x1 - x0) * inv_vx);
    const int64_t ny = (int64_t)std::lround((y1 - y0) * inv_vy);
    const int64_t nz = (int64_t)std::lround((z1 - z0) * inv_vz);

    int32_t n_voxels = 0;
    for (int64_t p = 0; p < n_points; ++p) {
        const float* pt = points + p * point_dim;
        const float x = pt[0], y = pt[1], z = pt[2];
        if (x < x0 || x >= x1 || y < y0 || y >= y1 || z < z0 || z >= z1)
            continue;
        int64_t ix = (int64_t)((x - x0) * inv_vx);
        int64_t iy = (int64_t)((y - y0) * inv_vy);
        int64_t iz = (int64_t)((z - z0) * inv_vz);
        if (ix >= nx) ix = nx - 1;
        if (iy >= ny) iy = ny - 1;
        if (iz >= nz) iz = nz - 1;
        const int64_t cell = (iz * ny + iy) * nx + ix;
        int32_t slot = scratch_table[cell];
        if (slot < 0) {
            if (n_voxels >= max_voxels) continue;  // spconv drops overflow
            slot = n_voxels++;
            scratch_table[cell] = slot;
            out_counts[slot] = 0;
            out_coords[slot * 3 + 0] = (int32_t)iz;
            out_coords[slot * 3 + 1] = (int32_t)iy;
            out_coords[slot * 3 + 2] = (int32_t)ix;
            std::memset(out_voxels + (int64_t)slot * max_points * point_dim,
                        0, sizeof(float) * max_points * point_dim);
        }
        const int32_t c = out_counts[slot];
        if (c >= max_points) continue;  // per-voxel cap, first-come order
        std::memcpy(out_voxels + ((int64_t)slot * max_points + c) * point_dim,
                    pt, sizeof(float) * point_dim);
        out_counts[slot] = c + 1;
    }

    // reset only the touched cells so the table is reusable
    for (int32_t v = 0; v < n_voxels; ++v) {
        const int64_t iz = out_coords[v * 3 + 0];
        const int64_t iy = out_coords[v * 3 + 1];
        const int64_t ix = out_coords[v * 3 + 2];
        scratch_table[(iz * ny + iy) * nx + ix] = -1;
    }
    return n_voxels;
}

// Batched variant over A agents with padded point buffers.
// points: (A, P, D); point_counts: (A,) valid prefix lengths.
// Outputs are (A, max_voxels, ...) slabs; returns nothing, per-agent voxel
// counts land in out_n_voxels (A,).
void voxelize_batch(const float* points, const int64_t* point_counts,
                    int32_t n_agents, int64_t points_per_agent,
                    int32_t point_dim,
                    const float* pc_range, const float* voxel_size,
                    int32_t max_voxels, int32_t max_points,
                    int32_t* scratch_table,
                    float* out_voxels, int32_t* out_coords,
                    int32_t* out_counts, int32_t* out_n_voxels) {
    const int64_t vox_slab = (int64_t)max_voxels * max_points * point_dim;
    for (int32_t a = 0; a < n_agents; ++a) {
        out_n_voxels[a] = voxelize(
            points + a * points_per_agent * point_dim, point_counts[a],
            point_dim, pc_range, voxel_size, max_voxels, max_points,
            scratch_table,
            out_voxels + a * vox_slab,
            out_coords + (int64_t)a * max_voxels * 3,
            out_counts + (int64_t)a * max_voxels);
    }
}

// Per-point pillar decoration — the host-side replacement for the
// device-side segment_sum + gather in ops/voxel.py pillar_decorate_flat
// (reference semantics: pillar_vfe.py:105-149 10-dim decorated points).
//
// points (n, 4) -> out_feats (n, 10) [xyzi | xyz-cluster_mean | xyz-center],
// out_gids (n,) flat pillar id iy*nx+ix (or dump_id for invalid points),
// out_valid (n,) uint8.
// scratch_sums: (nx*ny, 4) float accumulator (sum xyz + count), caller
// keeps it around; reset internally for touched cells only.
void decorate_pillars(const float* points, int64_t n_points,
                      const float* pc_range, const float* voxel_size,
                      int32_t dump_id,
                      float* scratch_sums, int32_t* touched,
                      float* out_feats, int32_t* out_gids,
                      uint8_t* out_valid) {
    const float x0 = pc_range[0], y0 = pc_range[1], z0 = pc_range[2];
    const float x1 = pc_range[3], y1 = pc_range[4], z1 = pc_range[5];
    const float inv_vx = 1.0f / voxel_size[0];
    const float inv_vy = 1.0f / voxel_size[1];
    const int64_t nx = (int64_t)std::lround((x1 - x0) * inv_vx);
    const int64_t ny = (int64_t)std::lround((y1 - y0) * inv_vy);

    int64_t n_touched = 0;
    // pass 1: per-pillar sums/counts
    for (int64_t p = 0; p < n_points; ++p) {
        const float* pt = points + p * 4;
        const float x = pt[0], y = pt[1], z = pt[2];
        if (x < x0 || x >= x1 || y < y0 || y >= y1 || z < z0 || z > z1) {
            out_gids[p] = dump_id;
            out_valid[p] = 0;
            continue;
        }
        int64_t ix = (int64_t)((x - x0) * inv_vx);
        int64_t iy = (int64_t)((y - y0) * inv_vy);
        if (ix >= nx) ix = nx - 1;
        if (iy >= ny) iy = ny - 1;
        const int64_t cell = iy * nx + ix;
        float* s = scratch_sums + cell * 4;
        if (s[3] == 0.0f) touched[n_touched++] = (int32_t)cell;
        s[0] += x; s[1] += y; s[2] += z; s[3] += 1.0f;
        out_gids[p] = (int32_t)cell;
        out_valid[p] = 1;
    }
    // pass 2: emit decorated features SORTED by pillar id (invalid points,
    // gid = dump_id, sort last). Sorted gids let the device reduce with
    // XLA's sorted-scatter fast path (indices_are_sorted=True on the
    // pillar max-scatter is ~100x faster than random scatter on TPU);
    // scatter-max consumers are order-insensitive, so this is free.
    std::vector<int64_t> perm(n_points);
    for (int64_t p = 0; p < n_points; ++p)
        perm[p] = ((int64_t)out_gids[p] << 32) | p;  // stable: idx in low bits
    std::sort(perm.begin(), perm.end());
    std::vector<int32_t> gids_sorted(n_points);
    std::vector<uint8_t> valid_sorted(n_points);
    for (int64_t r = 0; r < n_points; ++r) {
        const int64_t p = perm[r] & 0xFFFFFFFFll;
        const int32_t cell32 = (int32_t)(perm[r] >> 32);
        gids_sorted[r] = cell32;
        valid_sorted[r] = out_valid[p];
        const float* pt = points + p * 4;
        float* f = out_feats + r * 10;
        if (!out_valid[p]) {
            std::memset(f, 0, sizeof(float) * 10);
            continue;
        }
        const int64_t cell = cell32;
        const float* s = scratch_sums + cell * 4;
        const float inv_n = 1.0f / s[3];
        const int64_t ix = cell % nx;
        const int64_t iy = cell / nx;
        const float cx = (ix + 0.5f) * voxel_size[0] + x0;
        const float cy = (iy + 0.5f) * voxel_size[1] + y0;
        const float cz = 0.5f * voxel_size[2] + z0;
        f[0] = pt[0]; f[1] = pt[1]; f[2] = pt[2]; f[3] = pt[3];
        f[4] = pt[0] - s[0] * inv_n;
        f[5] = pt[1] - s[1] * inv_n;
        f[6] = pt[2] - s[2] * inv_n;
        f[7] = pt[0] - cx;
        f[8] = pt[1] - cy;
        f[9] = pt[2] - cz;
    }
    std::memcpy(out_gids, gids_sorted.data(), n_points * sizeof(int32_t));
    std::memcpy(out_valid, valid_sorted.data(), n_points);
    // reset touched cells
    for (int64_t t = 0; t < n_touched; ++t) {
        float* s = scratch_sums + (int64_t)touched[t] * 4;
        s[0] = s[1] = s[2] = s[3] = 0.0f;
    }
}

// Threaded batch decoration: one thread per agent, each with its own
// scratch slab (scratch_sums has shape (n_agents, nx*ny, 4) and touched
// (n_agents, nx*ny)). ~n_agents x faster wall clock on the host, which is
// what lets the loader hide under the device step.
void decorate_pillars_batch(const float* points, int32_t n_agents,
                            int64_t points_per_agent,
                            const float* pc_range, const float* voxel_size,
                            int32_t dump_id,
                            float* scratch_sums, int32_t* touched,
                            float* out_feats, int32_t* out_gids,
                            uint8_t* out_valid) {
    const float inv_vx = 1.0f / voxel_size[0];
    const float inv_vy = 1.0f / voxel_size[1];
    const int64_t nx =
        (int64_t)std::lround((pc_range[3] - pc_range[0]) * inv_vx);
    const int64_t ny =
        (int64_t)std::lround((pc_range[4] - pc_range[1]) * inv_vy);
    const int64_t ncell = nx * ny;
    std::vector<std::thread> threads;
    threads.reserve(n_agents);
    for (int32_t a = 0; a < n_agents; ++a) {
        threads.emplace_back([=]() {
            decorate_pillars(
                points + a * points_per_agent * 4, points_per_agent,
                pc_range, voxel_size, dump_id,
                scratch_sums + (int64_t)a * ncell * 4,
                touched + (int64_t)a * ncell,
                out_feats + a * points_per_agent * 10,
                out_gids + a * points_per_agent,
                out_valid + a * points_per_agent);
        });
    }
    for (auto& t : threads) t.join();
}

}  // extern "C"

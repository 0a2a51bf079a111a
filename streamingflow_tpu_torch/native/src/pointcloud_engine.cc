// Native host-side point-cloud engine.
//
// The PyTorch port's copy of the JAX package's host engine: a rebuild of the
// reference's CPU voxel op family (mmdet3d/ops/voxel/src/
// voxelization_cpu.cpp, scatter_points_cpu.cpp) and the multisweep
// aggregation inner loops (streamingflow/utils/data_classes.py:454-600).
// This library serves the *data pipeline*, not the device: it runs inside
// the loader's worker processes and holds the GIL-free hot loops (rigid
// transforms over ~350k points x 20 sweeps, first-come voxel binning,
// fixed-capacity padding, the tile sort).
//
// Plain C ABI (ctypes-loadable, no pybind11).  All buffers are caller-owned
// row-major numpy arrays; sizes are int64.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

// Rigid/affine transform of xyz columns in place.
// pts: (n, stride) float32 row-major, xyz in columns 0..2.
// tm: (4, 4) float64 row-major homogeneous transform.
void sf_transform_points(float* pts, int64_t n, int32_t stride,
                         const double* tm) {
  const double r00 = tm[0], r01 = tm[1], r02 = tm[2], t0 = tm[3];
  const double r10 = tm[4], r11 = tm[5], r12 = tm[6], t1 = tm[7];
  const double r20 = tm[8], r21 = tm[9], r22 = tm[10], t2 = tm[11];
  for (int64_t i = 0; i < n; ++i) {
    float* p = pts + i * stride;
    const double x = p[0], y = p[1], z = p[2];
    p[0] = static_cast<float>(r00 * x + r01 * y + r02 * z + t0);
    p[1] = static_cast<float>(r10 * x + r11 * y + r12 * z + t1);
    p[2] = static_cast<float>(r20 * x + r21 * y + r22 * z + t2);
  }
}

// Drop points closer than min_dist to the sensor in the xy plane (the
// devkit's remove_close, reference utils/data_classes.py:500-510), compacting
// in place.  Returns the new count.
int64_t sf_range_filter(float* pts, int64_t n, int32_t stride,
                        float min_dist) {
  const double d2 = static_cast<double>(min_dist) * min_dist;
  int64_t w = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * stride;
    const double x = p[0], y = p[1];
    if (x * x + y * y >= d2) {
      if (w != i)
        std::memcpy(pts + w * stride, p, sizeof(float) * stride);
      ++w;
    }
  }
  return w;
}

// Fused transform + close-range filter + time-lag stamp for one sweep of a
// multisweep aggregation (reference data_classes.py:560-590: transform into
// the reference sensor frame, remove_close, per-point time-lag channel).
// src: (n, src_stride) float32; dst: (>=n, dst_stride) float32 with
// dst_stride >= 4; xyz transformed, column 3 copied from src column 3
// (intensity) and column time_col (if >= 0 and < dst_stride) set to
// time_lag.  Returns number of points written.
int64_t sf_sweep_transform(const float* src, int64_t n, int32_t src_stride,
                           const double* tm, float min_dist, float* dst,
                           int32_t dst_stride, int32_t time_col,
                           float time_lag) {
  const double r00 = tm[0], r01 = tm[1], r02 = tm[2], t0 = tm[3];
  const double r10 = tm[4], r11 = tm[5], r12 = tm[6], t1 = tm[7];
  const double r20 = tm[8], r21 = tm[9], r22 = tm[10], t2 = tm[11];
  const double d2 = static_cast<double>(min_dist) * min_dist;
  int64_t w = 0;
  const int32_t ncopy = src_stride < dst_stride ? src_stride : dst_stride;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = src + i * src_stride;
    const double x = p[0], y = p[1], z = p[2];
    if (x * x + y * y < d2) continue;  // filter in *sensor* frame
    float* q = dst + w * dst_stride;
    for (int32_t c = 3; c < ncopy; ++c) q[c] = p[c];
    q[0] = static_cast<float>(r00 * x + r01 * y + r02 * z + t0);
    q[1] = static_cast<float>(r10 * x + r11 * y + r12 * z + t1);
    q[2] = static_cast<float>(r20 * x + r21 * y + r22 * z + t2);
    if (time_col >= 0 && time_col < dst_stride) q[time_col] = time_lag;
    ++w;
  }
  return w;
}

// Hard voxelization with first-come semantics, matching the reference
// CPU/CUDA voxelizer (mmdet3d/ops/voxel/src/voxelization_cpu.cpp
// hard_voxelize_cpu): points are visited in input order; each in-range point
// goes to its voxel until the voxel holds max_points; new voxels are created
// in first-touch order until max_voxels.
// pts: (n, n_feat) float32, xyz leading.
// voxels: (max_voxels, max_points, n_feat) float32, zero-filled by caller or
//         here (we zero the used prefix).
// coords: (max_voxels, 3) int32 (x, y, z) voxel indices.
// num_points: (max_voxels,) int32.
// Returns the number of voxels produced.
int64_t sf_hard_voxelize(const float* pts, int64_t n, int32_t n_feat,
                         const float* pc_range, const float* voxel_size,
                         int32_t max_points, int64_t max_voxels,
                         float* voxels, int32_t* coords,
                         int32_t* num_points) {
  const double x0 = pc_range[0], y0 = pc_range[1], z0 = pc_range[2];
  const double x1 = pc_range[3], y1 = pc_range[4], z1 = pc_range[5];
  const double vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
  const int64_t nx = static_cast<int64_t>(std::llround((x1 - x0) / vx));
  const int64_t ny = static_cast<int64_t>(std::llround((y1 - y0) / vy));
  const int64_t nz = static_cast<int64_t>(std::llround((z1 - z0) / vz));

  std::unordered_map<int64_t, int64_t> voxel_of;
  voxel_of.reserve(static_cast<size_t>(max_voxels) * 2);
  int64_t n_vox = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * n_feat;
    const int64_t cx = static_cast<int64_t>(std::floor((p[0] - x0) / vx));
    const int64_t cy = static_cast<int64_t>(std::floor((p[1] - y0) / vy));
    const int64_t cz = static_cast<int64_t>(std::floor((p[2] - z0) / vz));
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
      continue;
    const int64_t key = (cx * ny + cy) * nz + cz;
    auto it = voxel_of.find(key);
    int64_t v;
    if (it == voxel_of.end()) {
      if (n_vox >= max_voxels) continue;
      v = n_vox++;
      voxel_of.emplace(key, v);
      coords[v * 3 + 0] = static_cast<int32_t>(cx);
      coords[v * 3 + 1] = static_cast<int32_t>(cy);
      coords[v * 3 + 2] = static_cast<int32_t>(cz);
      num_points[v] = 0;
      std::memset(voxels + v * max_points * n_feat, 0,
                  sizeof(float) * max_points * n_feat);
    } else {
      v = it->second;
    }
    if (num_points[v] < max_points) {
      std::memcpy(voxels + (v * max_points + num_points[v]) * n_feat, p,
                  sizeof(float) * n_feat);
      ++num_points[v];
    }
  }
  return n_vox;
}

// Dynamic scatter: per-voxel mean/max over ALL in-range points (no caps),
// matching mmdet3d/ops/voxel/scatter_points (DynamicScatter, reduce 'mean' or
// 'max').  Output voxel order is first-touch like the reference's
// unique-preserving behaviour.
// reduced: (max_out, n_feat); coords: (max_out, 3); counts: (max_out,).
// mode: 0 = mean, 1 = max.  Returns number of voxels (<= max_out; extra
// voxels beyond max_out are dropped).
int64_t sf_dynamic_scatter(const float* pts, int64_t n, int32_t n_feat,
                           const float* pc_range, const float* voxel_size,
                           int32_t mode, int64_t max_out, float* reduced,
                           int32_t* coords, int32_t* counts) {
  const double x0 = pc_range[0], y0 = pc_range[1], z0 = pc_range[2];
  const double x1 = pc_range[3], y1 = pc_range[4], z1 = pc_range[5];
  const double vx = voxel_size[0], vy = voxel_size[1], vz = voxel_size[2];
  const int64_t nx = static_cast<int64_t>(std::llround((x1 - x0) / vx));
  const int64_t ny = static_cast<int64_t>(std::llround((y1 - y0) / vy));
  const int64_t nz = static_cast<int64_t>(std::llround((z1 - z0) / vz));

  std::unordered_map<int64_t, int64_t> voxel_of;
  voxel_of.reserve(static_cast<size_t>(max_out) * 2);
  int64_t n_vox = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * n_feat;
    const int64_t cx = static_cast<int64_t>(std::floor((p[0] - x0) / vx));
    const int64_t cy = static_cast<int64_t>(std::floor((p[1] - y0) / vy));
    const int64_t cz = static_cast<int64_t>(std::floor((p[2] - z0) / vz));
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
      continue;
    const int64_t key = (cx * ny + cy) * nz + cz;
    auto it = voxel_of.find(key);
    int64_t v;
    if (it == voxel_of.end()) {
      if (n_vox >= max_out) continue;
      v = n_vox++;
      voxel_of.emplace(key, v);
      coords[v * 3 + 0] = static_cast<int32_t>(cx);
      coords[v * 3 + 1] = static_cast<int32_t>(cy);
      coords[v * 3 + 2] = static_cast<int32_t>(cz);
      counts[v] = 0;
      for (int32_t c = 0; c < n_feat; ++c)
        reduced[v * n_feat + c] = mode == 1 ? -3.0e38f : 0.0f;
    } else {
      v = it->second;
    }
    float* r = reduced + v * n_feat;
    if (mode == 1) {
      for (int32_t c = 0; c < n_feat; ++c)
        r[c] = p[c] > r[c] ? p[c] : r[c];
    } else {
      for (int32_t c = 0; c < n_feat; ++c) r[c] += p[c];
    }
    ++counts[v];
  }
  if (mode == 0) {
    for (int64_t v = 0; v < n_vox; ++v) {
      const float inv = 1.0f / static_cast<float>(counts[v]);
      for (int32_t c = 0; c < n_feat; ++c) reduced[v * n_feat + c] *= inv;
    }
  }
  return n_vox;
}

// Bucket-sort points by BEV bin tile (counting sort, O(n)).  The binning
// kernel (streamingflow_tpu_torch/csrc/bin_sum.cu) only needs points
// *grouped by bin tile* (within-tile order is irrelevant: it compares
// global bin ids); doing the grouping here — in loader worker threads,
// overlapped with device compute — removes the device-side bitonic sort
// from the hot path.  In-place on the first n rows ((n, stride) float32,
// xyz leading).  Out-of-range / non-finite points go to the last bucket
// (the device maps them to the trash bin, which lives in the last tile).
// bins_per_tile must match ops/bin_sum.py's BINS_PER_TILE.
void sf_tile_sort_points(float* pts, int64_t n, int32_t stride,
                         const float* pc_range, const float* voxel_size,
                         int64_t bins_per_tile) {
  if (n <= 0) return;
  const float x0 = pc_range[0], y0 = pc_range[1], z0 = pc_range[2];
  const float x1 = pc_range[3], y1 = pc_range[4], z1 = pc_range[5];
  const float vx = voxel_size[0], vy = voxel_size[1];
  const int64_t nx = static_cast<int64_t>(
      std::llround((static_cast<double>(x1) - x0) / voxel_size[0]));
  const int64_t ny = static_cast<int64_t>(
      std::llround((static_cast<double>(y1) - y0) / voxel_size[1]));
  const int64_t n_bins = nx * ny + 1;  // + trash
  const int64_t n_tiles = (n_bins + bins_per_tile - 1) / bins_per_tile;

  std::vector<int32_t> bucket(n);
  std::vector<int64_t> counts(n_tiles + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * stride;
    // float math mirroring the device quantisation (jnp.floor((x-lo)/v))
    const int64_t cx = static_cast<int64_t>(std::floor((p[0] - x0) / vx));
    const int64_t cy = static_cast<int64_t>(std::floor((p[1] - y0) / vy));
    int64_t tile;
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || p[2] < z0 || p[2] >= z1 ||
        !(std::isfinite(p[0]) && std::isfinite(p[1]) && std::isfinite(p[2]))) {
      tile = n_tiles - 1;  // trash bin nx*ny rides the last tile
    } else {
      tile = (cx * ny + cy) / bins_per_tile;
    }
    bucket[i] = static_cast<int32_t>(tile);
    ++counts[tile + 1];
  }
  for (int64_t t = 0; t < n_tiles; ++t) counts[t + 1] += counts[t];
  std::vector<float> tmp(static_cast<size_t>(n) * stride);
  for (int64_t i = 0; i < n; ++i) {
    const int64_t dst = counts[bucket[i]]++;
    std::memcpy(tmp.data() + dst * stride, pts + i * stride,
                sizeof(float) * stride);
  }
  std::memcpy(pts, tmp.data(), sizeof(float) * n * stride);
}

// Gather per-sweep runs into fixed-capacity padded groups: the static-shape
// packing at the end of the loader (reference NuscenesData.py:869-873 pads
// to 350k).  src: (n, stride); group_of: (n,) int32 in [0, n_groups);
// dst: (n_groups, cap, stride) zero-padded; lens: (n_groups,) written.
// Points beyond cap in a group are dropped (counted in lens as cap).
void sf_group_pad(const float* src, int64_t n, int32_t stride,
                  const int32_t* group_of, int32_t n_groups, int64_t cap,
                  float* dst, int32_t* lens) {
  std::memset(dst, 0, sizeof(float) * n_groups * cap * stride);
  std::memset(lens, 0, sizeof(int32_t) * n_groups);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t g = group_of[i];
    if (g < 0 || g >= n_groups) continue;
    if (lens[g] >= cap) continue;
    std::memcpy(dst + (static_cast<int64_t>(g) * cap + lens[g]) * stride,
                src + i * stride, sizeof(float) * stride);
    ++lens[g];
  }
}

}  // extern "C"

// The gradient of a code-table gather, summed in a fixed order, for Hopper
// (sm_90a).
//
// Replaces what XLA gives the JAX package as the transpose of the training
// step's code gather (codenerf_tpu/training/train_step.py:255-256 and
// :329-330, tr["shape_codes"][batch["obj"]]): a scatter-add of the R
// per-ray cotangents g (R x D f32) into the n_rows rows of the table they
// were gathered from. PyTorch's backward of index_select is index_add_,
// which adds with f32 atomics in whatever order the rays arrive, so two
// trainings from one seed part in the last bits and then everywhere. Here
// the sum runs in one order, the same on every launch, and
// ops/code_rows.py::code_row_sums_plain spells the same order, so the card
// check demands the same bits:
//
//   The rays are taken in object order (perm, the stable argsort of obj:
//   an object's rays keep their ray order) and cut into tiles of kTile
//   consecutive positions. code_row_tiles_kernel walks each tile in order
//   and keeps, per object segment that meets the tile, its running sum
//   from 0. A segment that starts in the tile ends in head[obj]; the one
//   segment that started before the tile (the tile's first object) ends in
//   tail[tile]. code_row_fold_kernel then writes each object's row:
//   head[obj], plus tail[t] for every later tile t its segment reaches,
//   in tile order; 0 for an object with no rays.
//
// What bounds it on an H100: bytes. g is read once (4 R D B), the table's
// gradient written once (4 n_rows D B), plus the order (8 R + 4 n_rows B);
// the partial rows stay in L2. At the training batch (16,384 rays, two
// tables of 256 columns) that is ~17 MB a table, ~5 us at 3.35 TB/s. The
// adds are a few per byte. The order has to fill the card at both ends:
// 4 objects of 4,096 rays each (one long segment an object) and 2,458
// objects of ~7 rays. The tiles give R / kTile independent blocks a column
// block whatever the segments; the fold's longest chain is R / kTile adds
// (64 at the training batch), each a 4-byte load issued kBatch ahead.
// A thread owns one column, so a warp reads 128 contiguous bytes of a row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;    // positions a tile (code_rows.TILE)
constexpr int kCols = 128;   // columns a block, one a thread
constexpr int kBatch = 8;    // loads a thread issues before it adds

__global__ void __launch_bounds__(kCols)
    code_row_tiles_kernel(const float* __restrict__ g,
                          const int* __restrict__ perm,
                          const int* __restrict__ sorted_obj,
                          const int* __restrict__ offsets,
                          float* __restrict__ head, float* __restrict__ tail,
                          int R, int D) {
  const int t = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (col >= D) return;
  const int p0 = t * kTile;
  const int p1 = min(p0 + kTile, R);
  int cur = sorted_obj[p0];
  float acc = 0.f;
  for (int base = p0; base < p1; base += kBatch) {
    float v[kBatch];
    int o[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int p = base + j;
      o[j] = p < p1 ? sorted_obj[p] : -1;
      v[j] = p < p1 ? g[static_cast<int64_t>(perm[p]) * D + col] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (base + j >= p1) break;
      if (o[j] != cur) {
        // The segment of ``cur`` ends: in head if it started in this
        // tile, else (the tile's first segment) in tail.
        float* dst = offsets[cur] >= p0
                         ? head + static_cast<int64_t>(cur) * D
                         : tail + static_cast<int64_t>(t) * D;
        dst[col] = acc;
        acc = 0.f;
        cur = o[j];
      }
      acc += v[j];
    }
  }
  float* dst = offsets[cur] >= p0 ? head + static_cast<int64_t>(cur) * D
                                  : tail + static_cast<int64_t>(t) * D;
  dst[col] = acc;
}

__global__ void __launch_bounds__(kCols)
    code_row_fold_kernel(const float* __restrict__ head,
                         const float* __restrict__ tail,
                         const int* __restrict__ offsets,
                         float* __restrict__ out, int D) {
  const int64_t o = blockIdx.x;
  const int col = blockIdx.y * kCols + threadIdx.x;
  if (col >= D) return;
  const int b = offsets[o], e = offsets[o + 1];
  float acc = 0.f;
  if (b < e) {
    acc = head[o * D + col];
    const int t1 = (e - 1) / kTile;   // the segment's last tile
    for (int t = b / kTile + 1; t <= t1; t += kBatch) {
      float v[kBatch];
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        v[j] = t + j <= t1 ? tail[static_cast<int64_t>(t + j) * D + col]
                           : 0.f;
#pragma unroll
      for (int j = 0; j < kBatch; ++j)
        if (t + j <= t1) acc += v[j];
    }
  }
  out[o * D + col] = acc;
}

}  // namespace

// out (n_rows x D f32) = the fixed-order sums of g's rows (R x D f32) by
// object: perm, sorted_obj (R int32) and offsets (n_rows + 1 int32) are
// ops/code_rows.py::RowOrder; head (n_rows x D) and tail (ceil(R / 64) x
// D) f32 are scratch. One code_row_tiles_kernel launch (skipped at
// R = 0) and one code_row_fold_kernel launch on ``stream``; returns the
// launch's cudaError_t.
extern "C" int code_row_sums_step(const float* g, const int* perm,
                                  const int* sorted_obj,
                                  const int* offsets, float* head,
                                  float* tail, float* out, int R, int D,
                                  int n_rows, cudaStream_t stream) {
  const int col_blocks = (D + kCols - 1) / kCols;
  if (R > 0) {
    const dim3 grid((R + kTile - 1) / kTile, col_blocks);
    code_row_tiles_kernel<<<grid, kCols, 0, stream>>>(
        g, perm, sorted_obj, offsets, head, tail, R, D);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows > 0) {
    code_row_fold_kernel<<<dim3(n_rows, col_blocks), kCols, 0, stream>>>(
        head, tail, offsets, out, D);
  }
  return static_cast<int>(cudaGetLastError());
}

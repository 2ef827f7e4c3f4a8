// Ensemble traversal on raw rows: margins of every row over all trees
// (paper §2.4), without base_score.
//
// Replaces the TPU kernel src/repro/kernels/ensemble_traversal.py ::
// ensemble_margins_kernel (_kernel), which recasts both gathers (arena
// lookup per (tree, node), feature lookup per (row, feature)) as one-hot
// matmuls because the TPU has no fast gather. Hopper gathers directly,
// which is the paper's one-thread-per-instance design.
//
// What bounds it on the H100: it reads the rows once (n_rows * n_features
// * 4 bytes: 11.2 MB at 100k x 28, 3.3 us at 3.35 TB/s) and writes n_rows *
// n_classes floats; the arena is a few KB. Its work is n_trees * depth
// dependent gathers per row, so at many trees the latency of those
// dependent loads, not bandwidth, is what a later PR has to hide.
//
// Design: one thread per row. The block walks the trees in blocks of
// `trees_blk`, staging each block's arena (feature i32, threshold f32,
// leaf value f32, default_left and is_leaf u8: 14 B per node, 1.8 KB per
// depth-6 tree) in shared memory. A row reads x[row, feature] directly;
// x <= threshold goes left, NaN takes the default direction, a leaf stops
// the walk. Each thread sums its leaves into class t % n_classes in tree
// order (per-class accumulators in shared memory), so the result is
// deterministic without atomics and bit-identical to the plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__global__ void ensemble_margins_kernel(
    const int* __restrict__ feature,       // (T, A)
    const float* __restrict__ threshold,   // (T, A)
    const uint8_t* __restrict__ default_left,  // (T, A)
    const float* __restrict__ leaf_value,  // (T, A)
    const uint8_t* __restrict__ is_leaf,   // (T, A)
    const float* __restrict__ x,           // (N, F)
    float* __restrict__ out,               // (N, K)
    int n_trees, int arena, int n_rows, int n_features, int n_classes,
    int max_depth, int trees_blk) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  float* acc = smem;  // [n_classes][blockDim]
  const int blk_nodes = trees_blk * arena;
  int* s_feat = (int*)(acc + n_classes * blockDim.x);
  float* s_thr = (float*)(s_feat + blk_nodes);
  float* s_leaf = s_thr + blk_nodes;
  uint8_t* s_dl = (uint8_t*)(s_leaf + blk_nodes);
  uint8_t* s_is_leaf = s_dl + blk_nodes;

  const long long row = (long long)blockIdx.x * blockDim.x + tid;
  const bool live = row < n_rows;
  const float* xr = x + (live ? row : 0) * n_features;
  for (int c = 0; c < n_classes; ++c) acc[c * blockDim.x + tid] = 0.f;

  for (int t0 = 0; t0 < n_trees; t0 += trees_blk) {
    const int tb = min(trees_blk, n_trees - t0);
    __syncthreads();  // the previous tree block is no longer read
    const long long g0 = (long long)t0 * arena;
    for (int i = tid; i < tb * arena; i += blockDim.x) {
      s_feat[i] = feature[g0 + i];
      s_thr[i] = threshold[g0 + i];
      s_leaf[i] = leaf_value[g0 + i];
      s_dl[i] = default_left[g0 + i];
      s_is_leaf[i] = is_leaf[g0 + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int tl = 0; tl < tb; ++tl) {
      const int base = tl * arena;
      int node = 0;
      for (int d = 0; d < max_depth && !s_is_leaf[base + node]; ++d) {
        const float v = xr[s_feat[base + node]];
        const bool left = isnan(v) ? (s_dl[base + node] != 0)
                                   : (v <= s_thr[base + node]);
        node = 2 * node + (left ? 1 : 2);
      }
      float* a = acc + ((t0 + tl) % n_classes) * blockDim.x + tid;
      *a = __fadd_rn(*a, s_leaf[base + node]);
    }
  }
  if (live) {
    for (int c = 0; c < n_classes; ++c)
      out[row * n_classes + c] = acc[c * blockDim.x + tid];
  }
}

}  // namespace

extern "C" int rt_ensemble_margins(
    const void* feature, const void* threshold, const void* default_left,
    const void* leaf_value, const void* is_leaf, const void* x, void* out,
    int n_trees, int arena, int n_rows, int n_features, int n_classes,
    int max_depth, int trees_blk, int threads, void* stream) {
  const size_t smem = (size_t)n_classes * threads * sizeof(float) +
                      (size_t)trees_blk * arena * (3 * sizeof(float) + 2);
  cudaError_t err = cudaFuncSetAttribute(
      ensemble_margins_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_rows + threads - 1) / threads;
  ensemble_margins_kernel<<<blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int*)feature, (const float*)threshold,
      (const uint8_t*)default_left, (const float*)leaf_value,
      (const uint8_t*)is_leaf, (const float*)x, (float*)out, n_trees, arena,
      n_rows, n_features, n_classes, max_depth, trees_blk);
  return (int)cudaGetLastError();
}

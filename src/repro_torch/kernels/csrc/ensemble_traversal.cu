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
// n_classes floats; the arena is a few KB at depth 6. Its work is n_trees *
// depth dependent gathers per row, so at many trees the latency of those
// dependent loads, not bandwidth, is what a later PR has to hide.
//
// Design: one thread per row. Each thread sums its leaves into class
// t % n_classes in tree order (per-class accumulators in shared memory),
// so the result is deterministic without atomics and bit-identical to the
// plain version. A row reads x[row, feature] directly; x <= threshold goes
// left, NaN takes the default direction, a leaf stops the walk. The
// wrapper's plan (kernels/ensemble_traversal.py) fits any model into the
// 227 KB a block may use:
//  * class tiles on grid y: a block accumulates `class_tile` classes and
//    walks only their trees, round by round, so every class still sums in
//    tree order (300 classes x 256 rows of accumulators would be 300 KB);
//  * STAGED: the block walks its trees in blocks of `trees_blk`, staging
//    each block's arenas (feature i32, threshold f32, leaf value f32,
//    default_left and is_leaf u8: 14 B per node, 1.8 KB per depth-6 tree)
//    in shared memory;
//  * not STAGED, where one arena does not fit beside the accumulators
//    (depth 14: 459 KB a tree): every node is read from global memory
//    through the read-only path (__ldg). A row touches at most depth + 1
//    nodes of a tree, so the L2 serves the few hot top levels.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

template <bool LDG, typename T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (LDG) return __ldg(p);
  else return *p;
}

// Leaf value reached by one row in one tree arena (shared or global).
template <bool LDG>
__device__ __forceinline__ float walk(const int* feat, const float* thr,
                                      const uint8_t* dl, const float* leaf,
                                      const uint8_t* is_leaf, const float* xr,
                                      int max_depth) {
  int node = 0;
  for (int d = 0; d < max_depth && !load<LDG>(is_leaf + node); ++d) {
    const float v = xr[load<LDG>(feat + node)];
    const bool left = isnan(v) ? (load<LDG>(dl + node) != 0)
                               : (v <= load<LDG>(thr + node));
    node = 2 * node + (left ? 1 : 2);
  }
  return load<LDG>(leaf + node);
}

template <bool STAGED>
__global__ void ensemble_margins_kernel(
    const int* __restrict__ feature,       // (T, A)
    const float* __restrict__ threshold,   // (T, A)
    const uint8_t* __restrict__ default_left,  // (T, A)
    const float* __restrict__ leaf_value,  // (T, A)
    const uint8_t* __restrict__ is_leaf,   // (T, A)
    const float* __restrict__ x,           // (N, F)
    float* __restrict__ out,               // (N, K)
    int n_trees, int arena, int n_rows, int n_features, int n_classes,
    int max_depth, int class_tile, int trees_blk) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * class_tile;
  const int kc = min(class_tile, n_classes - c0);
  // The block's trees in tree order: j -> round j / kc, class c0 + j % kc.
  const int n_block_trees = n_trees / n_classes * kc;
  float* acc = smem;  // [kc][blockDim]
  const int blk_nodes = trees_blk * arena;
  int* s_feat = (int*)(acc + class_tile * blockDim.x);
  float* s_thr = (float*)(s_feat + blk_nodes);
  float* s_leaf = s_thr + blk_nodes;
  uint8_t* s_dl = (uint8_t*)(s_leaf + blk_nodes);
  uint8_t* s_is_leaf = s_dl + blk_nodes;

  const long long row = (long long)blockIdx.x * blockDim.x + tid;
  const bool live = row < n_rows;
  const float* xr = x + (live ? row : 0) * n_features;
  for (int c = 0; c < kc; ++c) acc[c * blockDim.x + tid] = 0.f;

  const int step = STAGED ? trees_blk : n_block_trees;
  for (int j0 = 0; j0 < n_block_trees; j0 += step) {
    const int tb = min(step, n_block_trees - j0);
    if constexpr (STAGED) {
      __syncthreads();  // the previous tree block is no longer read
      for (int i = tid; i < tb * arena; i += blockDim.x) {
        const int jl = i / arena;
        const int j = j0 + jl;
        const long long g =
            ((long long)(j / kc) * n_classes + c0 + j % kc) * arena + (i - jl * arena);
        s_feat[i] = feature[g];
        s_thr[i] = threshold[g];
        s_leaf[i] = leaf_value[g];
        s_dl[i] = default_left[g];
        s_is_leaf[i] = is_leaf[g];
      }
      __syncthreads();
    }
    if (!live) continue;
    for (int jl = 0; jl < tb; ++jl) {
      const int j = j0 + jl;
      float v;
      if constexpr (STAGED) {
        const int base = jl * arena;
        v = walk<false>(s_feat + base, s_thr + base, s_dl + base, s_leaf + base,
                        s_is_leaf + base, xr, max_depth);
      } else {
        const long long base =
            ((long long)(j / kc) * n_classes + c0 + j % kc) * arena;
        v = walk<true>(feature + base, threshold + base, default_left + base,
                       leaf_value + base, is_leaf + base, xr, max_depth);
      }
      float* a = acc + (j % kc) * blockDim.x + tid;
      *a = __fadd_rn(*a, v);
    }
  }
  if (live) {
    for (int c = 0; c < kc; ++c)
      out[row * n_classes + c0 + c] = acc[c * blockDim.x + tid];
  }
}

template <bool STAGED>
cudaError_t launch(const void* feature, const void* threshold,
                   const void* default_left, const void* leaf_value,
                   const void* is_leaf, const void* x, void* out, int n_trees,
                   int arena, int n_rows, int n_features, int n_classes,
                   int max_depth, int class_tile, int trees_blk, int threads,
                   cudaStream_t stream) {
  const size_t smem = (size_t)class_tile * threads * sizeof(float) +
                      (size_t)trees_blk * arena * (3 * sizeof(float) + 2);
  cudaError_t err = cudaFuncSetAttribute(
      ensemble_margins_kernel<STAGED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n_rows + threads - 1) / threads,
                  (n_classes + class_tile - 1) / class_tile);
  ensemble_margins_kernel<STAGED><<<grid, threads, smem, stream>>>(
      (const int*)feature, (const float*)threshold,
      (const uint8_t*)default_left, (const float*)leaf_value,
      (const uint8_t*)is_leaf, (const float*)x, (float*)out, n_trees, arena,
      n_rows, n_features, n_classes, max_depth, class_tile, trees_blk);
  return cudaGetLastError();
}

}  // namespace

// trees_blk = 0 reads the arenas from global memory instead of staging them.
extern "C" int rt_ensemble_margins(
    const void* feature, const void* threshold, const void* default_left,
    const void* leaf_value, const void* is_leaf, const void* x, void* out,
    int n_trees, int arena, int n_rows, int n_features, int n_classes,
    int max_depth, int class_tile, int trees_blk, int threads, void* stream) {
  if (trees_blk > 0)
    return (int)launch<true>(feature, threshold, default_left, leaf_value,
                             is_leaf, x, out, n_trees, arena, n_rows,
                             n_features, n_classes, max_depth, class_tile,
                             trees_blk, threads, (cudaStream_t)stream);
  return (int)launch<false>(feature, threshold, default_left, leaf_value,
                            is_leaf, x, out, n_trees, arena, n_rows, n_features,
                            n_classes, max_depth, class_tile, 0, threads,
                            (cudaStream_t)stream);
}

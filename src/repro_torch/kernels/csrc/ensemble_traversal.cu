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
// * 4 bytes) and writes n_rows * n_classes floats, and does a compare and a
// child index per level a row visits in each tree. At a served model's size
// (1M rows x 500 trees x depth 6) that is ~10^9 levels: the work, not the
// bytes, sets the bound, and what a thread waits on is the chain of
// dependent loads of its walk.
//
// Design (every class still sums its leaves in tree order with __fadd_rn,
// so the result is bit-identical to ref.ensemble_margins_ref):
//  * one 8-byte node, packed once per model by
//    kernels/ensemble_traversal.py::pack_nodes: {threshold bits, or the leaf
//    value on a leaf; feature | default_left << 30 | is_leaf << 31}. A level
//    is one 64-bit load of the node and one load of the row's value;
//  * each thread walks one row through G = 4 trees at once, interleaved, so
//    it has four independent load chains, and adds the four leaves in tree
//    order;
//  * ROW_TILE: the block's rows sit in shared memory feature-major
//    (s_x[f * rows + r]), copied once with coalesced cp.async, NaN kept; a
//    warp's data-dependent reads then fall in 32 distinct banks whatever
//    features its lanes pick. The transposing copy pays from ~16 trees a
//    block on; with fewer trees, or without room for the tile (very wide
//    rows), the rows are read from global memory;
//  * STAGED: the block's trees come in blocks of `trees_blk` arenas, double
//    buffered: one bulk copy (cp.async.bulk, TMA) per arena completes on
//    the stage's mbarrier, and the next block's copy runs under the walk of
//    the current one. Where two stages do not fit beside the accumulators
//    (depth >= 13), every node is one 8-byte __ldg through L2;
//  * class tiles on grid y: a block accumulates `class_tile` classes and
//    walks only their trees, round by round. Up to KREG classes sum in
//    registers; wider tiles in shared memory, one column per thread.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int G = 4;  // trees a thread walks at once
constexpr int KREG = 8;  // class tiles up to this many sum in registers
constexpr uint32_t FEAT_MASK = (1u << 30) - 1u;
constexpr uint32_t DEFAULT_LEFT = 1u << 30;
constexpr uint32_t LEAF = 1u << 31;
constexpr int BARRIER_BYTES = 16;  // two mbarriers ahead of the stages

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(1));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n"
      "TRAVERSAL_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra TRAVERSAL_WAIT;\n}"
      ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// One bulk copy global -> shared that completes `bytes` on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

template <bool LDG>
__device__ __forceinline__ uint2 load_node(const uint2* p) {
  if constexpr (LDG) return __ldg(p);
  else return *p;
}

// The leaf values one row reaches in G trees, walked together. `ar[i]` is
// tree i's arena (shared memory, or global with LDG); `xv` the row's values
// (shared, stride `xs`, with ROW_TILE; else global, stride 1). A leaf's
// feature bits are 0, so its chain reads a valid value and stays put.
template <bool LDG, bool ROW_TILE>
__device__ __forceinline__ void walk(const uint2* const* ar, const float* xv, int xs,
                                     int max_depth, float (&val)[G]) {
  uint2 nd[G];
  int node[G];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    node[i] = 0;
    nd[i] = load_node<LDG>(ar[i]);
  }
  for (int d = 0; d < max_depth; ++d) {
    bool inner = false;
#pragma unroll
    for (int i = 0; i < G; ++i) inner |= (nd[i].y & LEAF) == 0;
    if (!inner) break;
    float v[G];
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const uint32_t f = nd[i].y & FEAT_MASK;
      if constexpr (ROW_TILE) v[i] = xv[f * xs];
      else v[i] = __ldg(xv + f);
    }
#pragma unroll
    for (int i = 0; i < G; ++i) {
      if ((nd[i].y & LEAF) == 0) {
        const bool left = isnan(v[i]) ? (nd[i].y & DEFAULT_LEFT) != 0
                                      : v[i] <= __uint_as_float(nd[i].x);
        node[i] = 2 * node[i] + (left ? 1 : 2);
        nd[i] = load_node<LDG>(ar[i] + node[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < G; ++i) val[i] = __uint_as_float(nd[i].x);
}

struct Args {
  const uint2* nodes;  // (T, ap) packed nodes
  const float* x;  // (N, F)
  float* out;  // (N, K)
  int n_trees, ap, n_rows, n_features, n_classes, max_depth, class_tile, trees_blk;
};

// KR: 1 = one class in a register, KREG = up to KREG classes in registers,
// 0 = the class tile's sums in shared memory. One class has a path of its
// own: summed by KREG's compare-select (a class index and eight selects a
// leaf), 1M rows x 500 trees took 1.28x as long at depth 6 and 1.20x at
// depth 8 (tools/traversal_parts.py, H100 80GB HBM3 at 700 W).
template <bool STAGED, bool ROW_TILE, int KR>
__global__ void __launch_bounds__(512) ensemble_margins_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, rows = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int c0 = blockIdx.y * a.class_tile;
  const int kc = min(a.class_tile, a.n_classes - c0);
  // The block's trees in tree order: j -> round j / kc, class c0 + j % kc.
  const int n_block_trees = a.n_trees / a.n_classes * kc;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  uint2* stage = reinterpret_cast<uint2*>(smem + BARRIER_BYTES);  // [2][trees_blk][ap]
  float* acc_s = reinterpret_cast<float*>(stage + (STAGED ? 2 * a.trees_blk * a.ap : 0));
  float* s_x = acc_s + (KR == 0 ? a.class_tile * rows : 0);  // [F][rows]

  const long long row0 = (long long)blockIdx.x * rows;
  const long long row = row0 + tid;
  const bool live = row < a.n_rows;
  auto tree_of = [&](int j) {
    return (long long)(j / kc) * a.n_classes + c0 + j % kc;
  };
  const int step = STAGED ? a.trees_blk : max(n_block_trees, 1);
  const int n_blocks = (n_block_trees + step - 1) / step;
  // Warp 0 copies tree block b into stage s: one bulk copy per arena.
  auto fill_stage = [&](int b, int s) {
    const int j0 = b * step, tb = min(step, n_block_trees - j0);
    const uint32_t tree_bytes = (uint32_t)a.ap * sizeof(uint2);
    if (lane == 0) mbar_expect_tx(&bar[s], tb * tree_bytes);
    __syncwarp();
    for (int i = lane; i < tb; i += 32)
      bulk_copy(stage + ((long long)s * step + i) * a.ap, a.nodes + tree_of(j0 + i) * a.ap,
                tree_bytes, &bar[s]);
  };

  if constexpr (STAGED) {
    if (tid == 0) {
      mbar_init(&bar[0]);
      mbar_init(&bar[1]);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (warp == 0 && n_blocks > 0) fill_stage(0, 0);
  }
  if constexpr (ROW_TILE) {
    const int nr = (int)min((long long)rows, a.n_rows - row0);
    const float* xb = a.x + row0 * a.n_features;
    for (int i = tid; i < nr * a.n_features; i += rows) {
      const int r = i / a.n_features;
      cp_async4(s_x + (i - r * a.n_features) * rows + r, xb + i);
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
  }

  float acc[KR > 0 ? KR : 1];
#pragma unroll
  for (int c = 0; c < (KR > 0 ? KR : 1); ++c) acc[c] = 0.f;
  if constexpr (KR == 0)
    for (int c = 0; c < kc; ++c) acc_s[c * rows + tid] = 0.f;  // own column
  const float* xv = ROW_TILE ? s_x + tid : a.x + (live ? row : 0) * a.n_features;

  for (int b = 0; b < n_blocks; ++b) {
    const int j0 = b * step, tb = min(step, n_block_trees - j0);
    if constexpr (STAGED) {
      if (warp == 0 && b + 1 < n_blocks) fill_stage(b + 1, (b + 1) & 1);
      mbar_wait(&bar[b & 1], (b >> 1) & 1);
    }
    if (live) {
      for (int jl = 0; jl < tb; jl += G) {
        const int ng = min(G, tb - jl);
        const uint2* ar[G];
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const int t = jl + min(i, ng - 1);  // a short group repeats its last tree
          ar[i] = STAGED ? stage + ((long long)(b & 1) * step + t) * a.ap
                         : a.nodes + tree_of(j0 + t) * a.ap;
        }
        float v[G];
        walk<!STAGED, ROW_TILE>(ar, xv, rows, a.max_depth, v);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          if (i >= ng) break;
          const int cls = (j0 + jl + i) % kc;
          if constexpr (KR == 1) {
            acc[0] = __fadd_rn(acc[0], v[i]);
          } else if constexpr (KR > 1) {
#pragma unroll
            for (int c = 0; c < KR; ++c)
              if (c == cls) acc[c] = __fadd_rn(acc[c], v[i]);
          } else {
            float* s = acc_s + cls * rows + tid;
            *s = __fadd_rn(*s, v[i]);
          }
        }
      }
    }
    if constexpr (STAGED) __syncthreads();  // stage b & 1 is refilled at b + 2
  }
  if (!live) return;
  float* o = a.out + row * a.n_classes + c0;
  if constexpr (KR > 0) {
#pragma unroll
    for (int c = 0; c < KR; ++c)
      if (c < kc) o[c] = acc[c];
  } else {
    for (int c = 0; c < kc; ++c) o[c] = acc_s[c * rows + tid];
  }
}

template <bool STAGED, bool ROW_TILE, int KR>
cudaError_t launch(const Args& a, int threads, cudaStream_t stream) {
  const size_t smem = BARRIER_BYTES +
                      (STAGED ? 2 * (size_t)a.trees_blk * a.ap * sizeof(uint2) : 0) +
                      (KR == 0 ? (size_t)a.class_tile * threads * sizeof(float) : 0) +
                      (ROW_TILE ? (size_t)a.n_features * threads * sizeof(float) : 0);
  auto kernel = ensemble_margins_kernel<STAGED, ROW_TILE, KR>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.n_rows + threads - 1) / threads,
                  (a.n_classes + a.class_tile - 1) / a.class_tile);
  kernel<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool STAGED, bool ROW_TILE>
cudaError_t launch_classes(const Args& a, int threads, cudaStream_t stream) {
  if (a.class_tile == 1) return launch<STAGED, ROW_TILE, 1>(a, threads, stream);
  if (a.class_tile <= KREG) return launch<STAGED, ROW_TILE, KREG>(a, threads, stream);
  return launch<STAGED, ROW_TILE, 0>(a, threads, stream);
}

}  // namespace

// nodes: (n_trees, arena) packed 8-byte nodes, arena even (16-byte arenas
// for the bulk copies). trees_blk = 0 reads every node through L2;
// row_tile = 0 reads the rows from global memory. threads = rows a block,
// a multiple of 32 up to 512.
extern "C" int rt_ensemble_margins(const void* nodes, const void* x, void* out,
                                   int n_trees, int arena, int n_rows, int n_features,
                                   int n_classes, int max_depth, int class_tile,
                                   int trees_blk, int row_tile, int threads,
                                   void* stream) {
  if (arena % 2 || threads % 32 || threads > 512 || class_tile < 1)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint2*)nodes, (const float*)x, (float*)out, n_trees, arena, n_rows,
               n_features, n_classes, max_depth, class_tile, trees_blk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (trees_blk > 0)
    return (int)(row_tile ? launch_classes<true, true>(a, threads, s)
                          : launch_classes<true, false>(a, threads, s));
  return (int)(row_tile ? launch_classes<false, true>(a, threads, s)
                        : launch_classes<false, false>(a, threads, s));
}

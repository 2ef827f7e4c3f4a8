// Gradient histograms straight from the bit-packed matrix (paper §2.3).
// Three kernels share the contract of src/repro/core/histogram.py: per
// (node, feature, bin) sums of (g, h) over the rows at each level-local
// node position, out (n_nodes, n_features, max_bins, 2) float32.
//
//  * histogram_private_kernel replaces the TPU kernel
//    src/repro/kernels/histogram.py :: build_histograms_packed_kernel
//    (_private_kernel, _tree_add), which turns the scatter into one-hot
//    matmuls on the MXU because the TPU has no fast atomics. Hopper has
//    them, so this is the paper's own design: privatised shared-memory
//    histograms, flushed to the output with global atomics.
//  * histogram_rows_kernel is the same design over a compacted row buffer:
//    slot i holds row row_ids[i]. It serves src/repro/core/histogram.py ::
//    build_histograms_packed_rows, the subtraction trick's smaller-child
//    histogram below the root.
//  * histogram_global_kernel replaces the TPU kernel
//    src/repro/kernels/histogram.py :: histogram_packed (_kernel), whose
//    output block is its accumulator. The design choice carried over is
//    that one: no private histogram and no flush, every (row, feature)
//    adds straight into the output with global atomics, which stays
//    L2-resident at these sizes (1.8 MB at 32 nodes x 28 x 256).
//
// What bounds them on the H100: each full level reads the packed words once
// (n_features * n_rows * bits / 8 bytes), gh (8 B/row) and pos (4 B/row),
// and writes a small histogram: about 40 MB at 1M rows x 28 features, or
// 12 us at 3.35 TB/s. The real limit is the atomic rate: two float atomics
// per (row, feature), 56M per level at that size, in shared memory for the
// private and row kernels, in L2 for the global one.
//
// Design of the private kernels:
//  * A block owns a stripe of words (or slots) x a group of features x a
//    range of nodes, and keeps a private histogram for exactly those in
//    dynamic shared memory: [feature][node][bin][g,h] floats, updated with
//    shared-memory atomicAdd, so contending threads never reach L2.
//  * The feature group and node range are sized by the caller from the
//    227 KB opt-in limit (one feature at 32 nodes x 256 bins is 64 KB); the
//    node range is the grid's z dimension, so any n_nodes works.
//  * Packed kernel: consecutive threads take consecutive words of a
//    feature, so word loads coalesce along W. A thread unpacks SPW symbols
//    per word and keeps the SPW rows' (g, h) and node in registers across
//    the feature group; rows with a position outside the block's node range
//    (n_nodes or -1 = inactive) are skipped, and a word whose rows are all
//    skipped loads nothing.
//  * Row kernel: a thread takes one slot and, for each feature of the
//    group, one (slot, feature) pair: word packed[f, rid / SPW], shifted by
//    (rid % SPW) * bits. A slot at the dump position, or with a row id
//    outside the packed words, contributes nothing and reads nothing past
//    its position. The buffer keeps row order, so neighbouring slots often
//    share a word and a cache line.
//  * At the end the block flushes its non-zero entries to the output with
//    global atomicAdd. The caller zeroes the output first. Float order is
//    therefore not fixed from run to run, in all three kernels.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t symbol_mask(int bits) {
  return bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
}

__device__ __forceinline__ void zero_private(float* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();
}

// Adds a block's private histogram [fl][node - n0][bin][2] into the output.
__device__ __forceinline__ void flush_private(const float* hist, float* out,
                                              int nf, int slab, int f0, int n0,
                                              int n_features, int max_bins) {
  __syncthreads();
  const int per_node = max_bins * 2;
  for (int i = threadIdx.x; i < nf * slab; i += blockDim.x) {
    const float v = hist[i];
    if (v == 0.f) continue;
    const int fl = i / slab;
    const int r = i - fl * slab;
    const int node = r / per_node;
    const int rem = r - node * per_node;  // bin * 2 + (0 for g, 1 for h)
    const long long o =
        ((long long)(n0 + node) * n_features + f0 + fl) * per_node + rem;
    atomicAdd(out + o, v);
  }
}

template <int SPW>
__global__ void histogram_private_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words)
    const float2* __restrict__ gh,        // (n_rows,) (g, h)
    const int* __restrict__ pos,          // (n_rows,) node, n_nodes = inactive
    float* __restrict__ out,              // (n_nodes, n_features, max_bins, 2)
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int words_per_block) {
  extern __shared__ float hist[];  // [fl][node - n0][bin][2]
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int slab = nn * max_bins * 2;  // floats per feature
  zero_private(hist, nf * slab);

  const uint32_t mask = symbol_mask(bits);
  const long long w_begin = (long long)blockIdx.x * words_per_block;
  const long long w_end = min(w_begin + words_per_block, (long long)n_words);
  for (long long w = w_begin + threadIdx.x; w < w_end; w += blockDim.x) {
    int node[SPW];
    float g[SPW], h[SPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = w * SPW + j;
      const int p = row < n_rows ? __ldg(pos + row) - n0 : -1;
      node[j] = (p >= 0 && p < nn) ? p : -1;
      g[j] = h[j] = 0.f;
      if (node[j] >= 0) {
        const float2 v = __ldg(gh + row);
        g[j] = v.x;
        h[j] = v.y;
        any = true;
      }
    }
    if (!any) continue;
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t word = __ldg(packed + (long long)(f0 + fl) * n_words + w);
      float* hf = hist + fl * slab;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        if (node[j] < 0) continue;
        const int bin = (int)((word >> (j * bits)) & mask);
        float* slot = hf + (node[j] * max_bins + bin) * 2;
        atomicAdd(slot, g[j]);
        atomicAdd(slot + 1, h[j]);
      }
    }
  }
  flush_private(hist, out, nf, slab, f0, n0, n_features, max_bins);
}

template <int SPW>
__global__ void histogram_rows_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words)
    const float2* __restrict__ gh,        // (n_slots,) (g, h) of each slot
    const int* __restrict__ pos,          // (n_slots,) node, n_nodes = dump
    const int* __restrict__ rid,          // (n_slots,) row id of each slot
    float* __restrict__ out,              // (n_nodes, n_features, max_bins, 2)
    int n_slots, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int slots_per_block) {
  extern __shared__ float hist[];  // [fl][node - n0][bin][2]
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int slab = nn * max_bins * 2;
  zero_private(hist, nf * slab);

  const uint32_t mask = symbol_mask(bits);
  const long long n_symbols = (long long)n_words * SPW;
  const long long s_begin = (long long)blockIdx.x * slots_per_block;
  const long long s_end = min(s_begin + slots_per_block, (long long)n_slots);
  for (long long s = s_begin + threadIdx.x; s < s_end; s += blockDim.x) {
    const int p = __ldg(pos + s) - n0;
    if (p < 0 || p >= nn) continue;  // dump slot, or another tile's node
    const int r = __ldg(rid + s);
    if (r < 0 || r >= n_symbols) continue;  // padding id past the words
    const float2 v = __ldg(gh + s);
    const int w = r / SPW;
    const int shift = (r - w * SPW) * bits;
    float* hn = hist + p * max_bins * 2;
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t word = __ldg(packed + (long long)(f0 + fl) * n_words + w);
      const int bin = (int)((word >> shift) & mask);
      float* slot = hn + fl * slab + bin * 2;
      atomicAdd(slot, v.x);
      atomicAdd(slot + 1, v.y);
    }
  }
  flush_private(hist, out, nf, slab, f0, n0, n_features, max_bins);
}

template <int SPW>
__global__ void histogram_global_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words)
    const float2* __restrict__ gh,        // (n_rows,) (g, h)
    const int* __restrict__ pos,          // (n_rows,) node; n_nodes, -1 = inactive
    float* __restrict__ out,              // (n_nodes, n_features, max_bins, 2)
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits) {
  const uint32_t mask = symbol_mask(bits);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < n_words; w += stride) {
    int node[SPW];
    float g[SPW], h[SPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = w * SPW + j;
      const int p = row < n_rows ? __ldg(pos + row) : -1;
      node[j] = (p >= 0 && p < n_nodes) ? p : -1;
      g[j] = h[j] = 0.f;
      if (node[j] >= 0) {
        const float2 v = __ldg(gh + row);
        g[j] = v.x;
        h[j] = v.y;
        any = true;
      }
    }
    if (!any) continue;
    for (int f = 0; f < n_features; ++f) {
      const uint32_t word = __ldg(packed + (long long)f * n_words + w);
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        if (node[j] < 0) continue;
        const int bin = (int)((word >> (j * bits)) & mask);
        float* slot =
            out + (((long long)node[j] * n_features + f) * max_bins + bin) * 2;
        atomicAdd(slot, g[j]);
        atomicAdd(slot + 1, h[j]);
      }
    }
  }
}

// Grid and dynamic shared memory of the two private kernels.
template <typename Kernel>
cudaError_t private_launch_shape(Kernel kernel, int n_items, int n_features,
                                 int n_nodes, int max_bins, int node_tile,
                                 int feat_group, int items_per_block,
                                 dim3* grid, size_t* smem) {
  *smem = (size_t)feat_group * node_tile * max_bins * 2 * sizeof(float);
  *grid = dim3((n_items + items_per_block - 1) / items_per_block,
               (n_features + feat_group - 1) / feat_group,
               (n_nodes + node_tile - 1) / node_tile);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

template <int SPW>
cudaError_t launch_private(const void* packed, const void* gh, const void* pos,
                           void* out, int n_rows, int n_features, int n_words,
                           int n_nodes, int max_bins, int bits, int node_tile,
                           int feat_group, int words_per_block, int threads,
                           cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = private_launch_shape(
      histogram_private_kernel<SPW>, n_words, n_features, n_nodes, max_bins,
      node_tile, feat_group, words_per_block, &grid, &smem);
  if (err != cudaSuccess) return err;
  histogram_private_kernel<SPW><<<grid, threads, smem, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos, (float*)out,
      n_rows, n_features, n_words, n_nodes, max_bins, bits, node_tile,
      feat_group, words_per_block);
  return cudaGetLastError();
}

template <int SPW>
cudaError_t launch_rows(const void* packed, const void* gh, const void* pos,
                        const void* rid, void* out, int n_slots,
                        int n_features, int n_words, int n_nodes, int max_bins,
                        int bits, int node_tile, int feat_group,
                        int slots_per_block, int threads, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = private_launch_shape(
      histogram_rows_kernel<SPW>, n_slots, n_features, n_nodes, max_bins,
      node_tile, feat_group, slots_per_block, &grid, &smem);
  if (err != cudaSuccess) return err;
  histogram_rows_kernel<SPW><<<grid, threads, smem, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos,
      (const int*)rid, (float*)out, n_slots, n_features, n_words, n_nodes,
      max_bins, bits, node_tile, feat_group, slots_per_block);
  return cudaGetLastError();
}

template <int SPW>
cudaError_t launch_global(const void* packed, const void* gh, const void* pos,
                          void* out, int n_rows, int n_features, int n_words,
                          int n_nodes, int max_bins, int bits, int threads,
                          cudaStream_t stream) {
  const int blocks = (n_words + threads - 1) / threads;
  histogram_global_kernel<SPW><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos, (float*)out,
      n_rows, n_features, n_words, n_nodes, max_bins, bits);
  return cudaGetLastError();
}

}  // namespace

// Symbols per word is a template argument, so the per-row unpack and the
// row -> word division are compile-time. SPW = 32 / bits for bits 1..32.
#define RT_SPW_SWITCH(bits, CALL) \
  switch (32 / (bits)) {          \
    case 1: return (int)CALL(1);  \
    case 2: return (int)CALL(2);  \
    case 3: return (int)CALL(3);  \
    case 4: return (int)CALL(4);  \
    case 5: return (int)CALL(5);  \
    case 6: return (int)CALL(6);  \
    case 8: return (int)CALL(8);  \
    case 10: return (int)CALL(10); \
    case 16: return (int)CALL(16); \
    case 32: return (int)CALL(32); \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" int rt_histogram_private(
    const void* packed, const void* gh, const void* pos, void* out,
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int words_per_block, int threads,
    void* stream) {
#define RT_CALL(S)                                                          \
  launch_private<S>(packed, gh, pos, out, n_rows, n_features, n_words,      \
                    n_nodes, max_bins, bits, node_tile, feat_group,         \
                    words_per_block, threads, (cudaStream_t)stream)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

extern "C" int rt_histogram_rows(
    const void* packed, const void* gh, const void* pos, const void* rid,
    void* out, int n_slots, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int node_tile, int feat_group,
    int slots_per_block, int threads, void* stream) {
#define RT_CALL(S)                                                          \
  launch_rows<S>(packed, gh, pos, rid, out, n_slots, n_features, n_words,   \
                 n_nodes, max_bins, bits, node_tile, feat_group,            \
                 slots_per_block, threads, (cudaStream_t)stream)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

extern "C" int rt_histogram_packed(
    const void* packed, const void* gh, const void* pos, void* out,
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int threads, void* stream) {
#define RT_CALL(S)                                                          \
  launch_global<S>(packed, gh, pos, out, n_rows, n_features, n_words,       \
                   n_nodes, max_bins, bits, threads, (cudaStream_t)stream)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

#undef RT_SPW_SWITCH

// Largest dynamic shared memory a block may opt in to on `device`.
extern "C" int rt_smem_optin(int device, void* out_bytes) {
  return (int)cudaDeviceGetAttribute(
      (int*)out_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

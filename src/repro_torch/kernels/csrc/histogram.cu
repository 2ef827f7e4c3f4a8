// Gradient histograms straight from the bit-packed matrix (paper §2.3).
//
// Replaces the TPU kernel src/repro/kernels/histogram.py ::
// build_histograms_packed_kernel (_private_kernel, _tree_add), which turns
// the scatter into one-hot matmuls on the MXU because the TPU has no fast
// atomics. Hopper has them, so this is the paper's own design.
//
// What bounds it on the H100: each level reads the packed words once
// (n_features * n_rows * bits / 8 bytes), gh (8 B/row) and pos (4 B/row),
// and writes a small histogram: about 40 MB at 1M rows x 28 features, or
// 12 us at 3.35 TB/s. The real limit is the shared-memory atomic rate: two
// float atomics per (row, feature), 56M per level at that size.
//
// Design:
//  * A block owns a stripe of words (rows) x a group of features x a range
//    of nodes, and keeps a private histogram for exactly those in dynamic
//    shared memory: [feature][node][bin][g,h] floats, updated with
//    shared-memory atomicAdd, so contending threads never reach L2.
//  * The feature group and node range are sized by the caller from the
//    227 KB opt-in limit (one feature at 32 nodes x 256 bins is 64 KB); the
//    node range is the grid's z dimension, so any n_nodes works.
//  * Consecutive threads take consecutive words of a feature, so word loads
//    coalesce along W. A thread unpacks SPW symbols per word and keeps the
//    SPW rows' (g, h) and node in registers across the feature group;
//    rows with pos == n_nodes (inactive) or outside the node range are
//    skipped, and a word whose rows are all skipped loads nothing.
//  * At the end the block flushes its non-zero entries to the output with
//    global atomicAdd. The caller zeroes the output first. Float order is
//    therefore not fixed from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int SPW>
__global__ void histogram_packed_kernel(
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
  for (int i = threadIdx.x; i < nf * slab; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const uint32_t mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
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
cudaError_t launch(const void* packed, const void* gh, const void* pos,
                   void* out, int n_rows, int n_features, int n_words,
                   int n_nodes, int max_bins, int bits, int node_tile,
                   int feat_group, int words_per_block, cudaStream_t stream,
                   int threads) {
  const size_t smem = (size_t)feat_group * node_tile * max_bins * 2 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      histogram_packed_kernel<SPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((n_words + words_per_block - 1) / words_per_block,
            (n_features + feat_group - 1) / feat_group,
            (n_nodes + node_tile - 1) / node_tile);
  histogram_packed_kernel<SPW><<<grid, threads, smem, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos, (float*)out,
      n_rows, n_features, n_words, n_nodes, max_bins, bits, node_tile,
      feat_group, words_per_block);
  return cudaGetLastError();
}

}  // namespace

extern "C" int rt_histogram_packed(
    const void* packed, const void* gh, const void* pos, void* out,
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int words_per_block, int threads,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define RT_HIST_CASE(S)                                                      \
  case S:                                                                    \
    return (int)launch<S>(packed, gh, pos, out, n_rows, n_features, n_words, \
                          n_nodes, max_bins, bits, node_tile, feat_group,    \
                          words_per_block, s, threads);
  switch (32 / bits) {
    RT_HIST_CASE(1)
    RT_HIST_CASE(2)
    RT_HIST_CASE(3)
    RT_HIST_CASE(4)
    RT_HIST_CASE(5)
    RT_HIST_CASE(6)
    RT_HIST_CASE(8)
    RT_HIST_CASE(10)
    RT_HIST_CASE(16)
    RT_HIST_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RT_HIST_CASE
}

// Largest dynamic shared memory a block may opt in to on `device`.
extern "C" int rt_smem_optin(int device, void* out_bytes) {
  return (int)cudaDeviceGetAttribute(
      (int*)out_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

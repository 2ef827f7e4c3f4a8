// Measurement only, for tools/packed_parts.py: designs of the cluster
// kernel of src/repro_torch/kernels/csrc/histogram.cu (histogram_packed)
// that the port does not ship, kept so that their times can be taken again
// beside the shipped kernel. Nothing of the port includes or launches this
// file. It includes the shipped source, so it shares every device helper;
// each design keeps the shipped grid, stripes, reduction through
// distributed shared memory, conversion and store.
//
// interleaved_kernel: the private tile as (g, h) pairs of int64, 16 bytes
// each (every low word on one of 8 banks), with the missing bin (max_bins -
// 1) taken by kMode: kAllBins adds it as any bin (a hot key at one node
// costs a match and a shuffle tree a symbol; at 32 nodes 32 shared words
// take 80% of the adds on skewed words); kBlockTotals never adds it and
// sums the block's node totals in one row, each lane's run of rows at one
// node added where it ends, warp-aggregated (#1's end_runs), then writes
// the total less the block's other bins into the missing entry;
// kWarpTotals does the same with each warp's totals in its own row, a run
// added as it ends (no vote, no match), as the shipped kernel does.
// planar_kernel: the shipped planar tile with every bin added.
// Only the 8-bit words' instance (4 symbols a word).
#include "../src/repro_torch/kernels/csrc/histogram.cu"

namespace {

enum Mode { kAllBins, kBlockTotals, kWarpTotals };

// One (g, h) pair of block `rank`'s interleaved tile: a 16-byte
// ld.shared::cluster at the offset of `addr` in this block's.
__device__ __forceinline__ longlong2 load_pair_in(uint32_t addr, unsigned rank) {
  long long x, y;
  asm volatile("ld.shared::cluster.v2.s64 {%0, %1}, [%2];"
               : "=l"(x), "=l"(y) : "r"(in_block(addr, rank)) : "memory");
  return make_longlong2(x, y);
}

template <int SPW, int MAX_THREADS, int kMode>
__global__ void __launch_bounds__(MAX_THREADS, 1) interleaved_kernel(
    const uint32_t* __restrict__ packed, const float2* __restrict__ gh,
    const int* __restrict__ pos, float2* __restrict__ out,
    const int* __restrict__ kexp, int n_rows, int n_features, int n_words,
    int n_nodes, int max_bins, int bits, int node_tile, int feat_group,
    int words_per_block) {
  extern __shared__ __align__(16) long long tile[];
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int pairs = nf * nn * max_bins;
  long long* part = tile + pairs * 2;  // the stripe's node totals [node][2]
  const int warps = kMode == kWarpTotals ? blockDim.x >> 5 : kMode == kBlockTotals;
  long long* mine = part + (threadIdx.x >> 5) * nn * 2;  // kWarpTotals: the warp's
  for (int i = threadIdx.x; i < (pairs + warps * nn) * 2; i += blockDim.x) tile[i] = 0;
  __syncthreads();
  const double scale = pow2(__ldg(kexp));
  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  const int top = kMode == kAllBins ? max_bins : missing;  // bins added
  const unsigned rank = cluster_rank();
  const long long w_begin = (long long)rank * words_per_block;
  const long long w_end = min(w_begin + words_per_block, (long long)n_words);
  Run run{-1, make_longlong2(0, 0)};
  for (long long w = w_begin + threadIdx.x; w - (threadIdx.x & 31) < w_end;
       w += blockDim.x) {
    int node[SPW];
    longlong2 v[SPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = w * SPW + j;
      const int q = (w < w_end && row < n_rows) ? __ldg(pos + row) - n0 : -1;
      node[j] = (q >= 0 && q < nn) ? q : -1;
      v[j] = make_longlong2(0, 0);
      if (node[j] >= 0) {
        v[j] = quantise_pair(__ldg(gh + row), scale);
        any = true;
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    if constexpr (kMode == kWarpTotals) {
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        if (node[j] < 0) continue;
        if (node[j] == run.node) {
          run.sum.x += v[j].x;
          run.sum.y += v[j].y;
        } else {
          if (run.node >= 0) add_pair_shared(mine + run.node * 2, run.sum);
          run = Run{node[j], v[j]};
        }
      }
    } else if constexpr (kMode == kBlockTotals) {
#pragma unroll
      for (int j = 0; j < SPW; ++j) add_to_run(run, node[j], v[j], part);
    }
    unsigned long long same = 0;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int a = __shfl_xor_sync(kFullWarp, node[j], 1);
      const int b = __shfl_xor_sync(kFullWarp, node[j], 2);
      same |= (unsigned long long)(node[j] >= 0 && a == node[j]) << j;
      same |= (unsigned long long)(node[j] >= 0 && b == node[j]) << (SPW + j);
    }
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t word = any ? __ldg(packed + (long long)(f0 + fl) * n_words + w) : 0u;
      const uint32_t d1 = word ^ __shfl_xor_sync(kFullWarp, word, 1);
      const uint32_t d2 = word ^ __shfl_xor_sync(kFullWarp, word, 2);
      long long* hf = tile + fl * nn * max_bins * 2;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int shift = j * bits;
        const int bin = (int)((word >> shift) & mask);
        const bool on = node[j] >= 0 && (unsigned)bin < (unsigned)top;
        const bool repeat =
            on && ((((same >> j) & 1) && ((d1 >> shift) & mask) == 0) ||
                   (((same >> (SPW + j)) & 1) && ((d2 >> shift) & mask) == 0));
        const unsigned hot = __ballot_sync(kFullWarp, repeat);
        longlong2 sum = v[j];
        bool adds = on;
        if (hot & (hot - 1)) {
          const unsigned peers =
              __match_any_sync(kFullWarp, on ? node[j] * max_bins + bin : -1);
          sum = reduce_peers(peers, v[j]);
          adds = adds && leads(peers);
        }
        if (adds) add_pair_shared(hf + (node[j] * max_bins + bin) * 2, sum);
      }
    }
  }
  if constexpr (kMode == kWarpTotals) {
    if (run.node >= 0) add_pair_shared(mine + run.node * 2, run.sum);
    __syncthreads();
    for (int i = threadIdx.x; i < nn * 2; i += blockDim.x) {
      long long t = part[i];
      for (int wp = 1; wp < warps; ++wp) t += part[wp * nn * 2 + i];
      part[i] = t;  // row 0 becomes the block's totals
    }
  } else if constexpr (kMode == kBlockTotals) {
    end_runs(run.node >= 0, run, part);
  }
  if constexpr (kMode != kAllBins) {
    __syncthreads();
    // Each (feature, node)'s missing entry: the block's total less its bins.
    const int lane = threadIdx.x & 31;
    for (int u = threadIdx.x >> 5; u < nf * nn; u += blockDim.x >> 5) {
      long long* h = tile + u * max_bins * 2;  // u = fl * nn + node
      const int node = u % nn;
      long long s = 0;  // this lane's bins of one component (its parity)
      for (int e = lane; e < missing * 2; e += 32) s += h[e];
      for (int d = 16; d >= 2; d >>= 1) s += __shfl_xor_sync(kFullWarp, s, d);
      if (lane < 2) h[missing * 2 + lane] = part[node * 2 + lane] - s;
    }
  }
  sync_cluster();
  const int k = __ldg(kexp);
  const double inv = k == kNonFinite ? 0.0 : pow2(-k);
  const unsigned blocks = cluster_blocks();
  const uint32_t base = shared_address(tile);
  for (int i = rank * blockDim.x + threadIdx.x; i < pairs; i += blocks * blockDim.x) {
    longlong2 acc = make_longlong2(0, 0);
    for (unsigned r = 0; r < blocks; ++r) {
      const longlong2 p = load_pair_in(base + i * 16, r);
      acc.x += p.x;
      acc.y += p.y;
    }
    const int fn = i / max_bins;
    const int bin = i - fn * max_bins;
    const int fl = fn / nn;
    const int node = fn - fl * nn;
    const float nan = __int_as_float(0x7fc00000);
    out[((long long)(n0 + node) * n_features + f0 + fl) * max_bins + bin] =
        k == kNonFinite ? make_float2(nan, nan)
                        : make_float2(dequantise(acc.x, inv), dequantise(acc.y, inv));
  }
  sync_cluster();
}

template <int kMode>
int launch_interleaved(
    const void* packed, const void* gh, const void* pos, void* out,
    const void* kexp, int n_rows, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int node_tile, int feat_group, int cluster,
    int words_per_block, int threads, void* stream) {
  if (bits != 8 || cluster < 1 || cluster > 8 ||
      (long long)words_per_block * cluster < n_words)
    return (int)cudaErrorInvalidValue;
  const auto kernel = interleaved_kernel<4, 1024, kMode>;
  const int rows = kMode == kWarpTotals ? threads / 32 : kMode == kBlockTotals;
  const size_t smem = ((size_t)feat_group * node_tile * max_bins + rows * node_tile) * 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, (n_features + feat_group - 1) / feat_group,
                     (n_nodes + node_tile - 1) / node_tile);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)packed,
                           (const float2*)gh, (const int*)pos, (float2*)out,
                           (const int*)kexp, n_rows, n_features, n_words,
                           n_nodes, max_bins, bits, node_tile, feat_group,
                           words_per_block);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The shipped planar tile, every bin added (the missing one too).
__device__ __forceinline__ void add_planar_pair(unsigned* at, int pairs, longlong2 v) {
  add_shared_split(at, pairs, v.x);
  add_shared_split(at + 2 * pairs, pairs, v.y);
}

template <int SPW, int MAX_THREADS>
__global__ void __launch_bounds__(MAX_THREADS, 1) planar_kernel(
    const uint32_t* __restrict__ packed, const float2* __restrict__ gh,
    const int* __restrict__ pos, float2* __restrict__ out,
    const int* __restrict__ kexp, int n_rows, int n_features, int n_words,
    int n_nodes, int max_bins, int bits, int node_tile, int feat_group,
    int words_per_block) {
  extern __shared__ __align__(16) unsigned planes[];
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int pairs = nf * nn * max_bins;
  for (int i = threadIdx.x; i < 4 * pairs; i += blockDim.x) planes[i] = 0;
  __syncthreads();
  const double scale = pow2(__ldg(kexp));
  const uint32_t mask = symbol_mask(bits);
  const unsigned rank = cluster_rank();
  const long long w_begin = (long long)rank * words_per_block;
  const long long w_end = min(w_begin + words_per_block, (long long)n_words);
  for (long long w = w_begin + threadIdx.x; w - (threadIdx.x & 31) < w_end;
       w += blockDim.x) {
    int node[SPW];
    longlong2 v[SPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = w * SPW + j;
      const int q = (w < w_end && row < n_rows) ? __ldg(pos + row) - n0 : -1;
      node[j] = (q >= 0 && q < nn) ? q : -1;
      v[j] = make_longlong2(0, 0);
      if (node[j] >= 0) {
        v[j] = quantise_pair(__ldg(gh + row), scale);
        any = true;
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    unsigned long long same = 0;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int a = __shfl_xor_sync(kFullWarp, node[j], 1);
      const int b = __shfl_xor_sync(kFullWarp, node[j], 2);
      same |= (unsigned long long)(node[j] >= 0 && a == node[j]) << j;
      same |= (unsigned long long)(node[j] >= 0 && b == node[j]) << (SPW + j);
    }
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t word = any ? __ldg(packed + (long long)(f0 + fl) * n_words + w) : 0u;
      const uint32_t d1 = word ^ __shfl_xor_sync(kFullWarp, word, 1);
      const uint32_t d2 = word ^ __shfl_xor_sync(kFullWarp, word, 2);
      unsigned* hf = planes + fl * nn * max_bins;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int shift = j * bits;
        const int bin = (int)((word >> shift) & mask);
        const bool on = node[j] >= 0 && (unsigned)bin < (unsigned)max_bins;
        const bool repeat =
            on && ((((same >> j) & 1) && ((d1 >> shift) & mask) == 0) ||
                   (((same >> (SPW + j)) & 1) && ((d2 >> shift) & mask) == 0));
        const unsigned hot = __ballot_sync(kFullWarp, repeat);
        longlong2 sum = v[j];
        bool adds = on;
        if (hot & (hot - 1)) {
          const unsigned peers =
              __match_any_sync(kFullWarp, on ? node[j] * max_bins + bin : -1);
          sum = reduce_peers(peers, v[j]);
          adds = adds && leads(peers);
        }
        if (adds) add_planar_pair(hf + node[j] * max_bins + bin, pairs, sum);
      }
    }
  }
  sync_cluster();
  const int k = __ldg(kexp);
  const double inv = k == kNonFinite ? 0.0 : pow2(-k);
  const unsigned blocks = cluster_blocks();
  const uint32_t base = shared_address(planes);
  for (int i = rank * blockDim.x + threadIdx.x; i < pairs; i += blocks * blockDim.x) {
    long long g = 0, hh = 0;
    for (unsigned r = 0; r < blocks; ++r) {
      g += join64(load_in(base + i * 4, r), load_in(base + (pairs + i) * 4, r));
      hh += join64(load_in(base + (2 * pairs + i) * 4, r),
                   load_in(base + (3 * pairs + i) * 4, r));
    }
    const int fn = i / max_bins;
    const int bin = i - fn * max_bins;
    const int fl = fn / nn;
    const int node = fn - fl * nn;
    const float nan = __int_as_float(0x7fc00000);
    out[((long long)(n0 + node) * n_features + f0 + fl) * max_bins + bin] =
        k == kNonFinite ? make_float2(nan, nan)
                        : make_float2(dequantise(g, inv), dequantise(hh, inv));
  }
  sync_cluster();
}

int launch_planar(
    const void* packed, const void* gh, const void* pos, void* out,
    const void* kexp, int n_rows, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int node_tile, int feat_group, int cluster,
    int words_per_block, int threads, void* stream) {
  if (bits != 8 || cluster < 1 || cluster > 8 ||
      (long long)words_per_block * cluster < n_words)
    return (int)cudaErrorInvalidValue;
  const auto kernel = planar_kernel<4, 1024>;
  const size_t smem = (size_t)feat_group * node_tile * max_bins * 16;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster, (n_features + feat_group - 1) / feat_group,
                     (n_nodes + node_tile - 1) / node_tile);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)packed,
                           (const float2*)gh, (const int*)pos, (float2*)out,
                           (const int*)kexp, n_rows, n_features, n_words,
                           n_nodes, max_bins, bits, node_tile, feat_group,
                           words_per_block);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#define PARTS_ARGS                                                            \
  const void *packed, const void *gh, const void *pos, void *out,             \
      const void *kexp, int n_rows, int n_features, int n_words, int n_nodes, \
      int max_bins, int bits, int node_tile, int feat_group, int cluster,     \
      int words_per_block, int threads, void *stream
#define PARTS_PASS                                                           \
  packed, gh, pos, out, kexp, n_rows, n_features, n_words, n_nodes, max_bins, \
      bits, node_tile, feat_group, cluster, words_per_block, threads, stream

// rt_histogram_packed's arguments; 8-bit words only. any_bin, subtract,
// subtract_warp: interleaved_kernel's kAllBins, kBlockTotals, kWarpTotals;
// planar: planar_kernel.
extern "C" int parts_histogram_packed_any_bin(PARTS_ARGS) {
  return launch_interleaved<kAllBins>(PARTS_PASS);
}

extern "C" int parts_histogram_packed_subtract(PARTS_ARGS) {
  return launch_interleaved<kBlockTotals>(PARTS_PASS);
}

extern "C" int parts_histogram_packed_subtract_warp(PARTS_ARGS) {
  return launch_interleaved<kWarpTotals>(PARTS_PASS);
}

extern "C" int parts_histogram_packed_planar(PARTS_ARGS) {
  return launch_planar(PARTS_PASS);
}

// Measurement only: the parts of two kernel designs of
// src/repro_torch/kernels/csrc/ taken one at a time, for tools/kernel_parts.py.
// Nothing of the port includes or launches this file.
//
//  * parts_histogram: histogram_private_kernel (histogram.cu) at 8-bit
//    symbols with each part of its design switched by MODE: bit 0 one 64-bit
//    compare-and-swap per (g, h) (else two float atomicAdds), bit 1 the
//    repeat test and its __match_any_sync, bit 2 the warp stepping through
//    its words together (implied by bit 1). MODE 7 is the shipped body.
//  * parts_split_scan: split_scan_kernel (split_scan.cu) with SKIP 1 leaving
//    out lane 0's prefix sums, SKIP 2 the scoring of thresholds: the time
//    each part adds (the outputs are then not the split scan's).
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRowsUnroll = 4;  // features whose words a slot loads at once

// Sum of v over `peers` (the lanes of the warp whose key equals this lane's),
// complete in the lowest lane of each group; the shuffle tree takes
// ceil(log2(group size)) steps and none when every key is unique. Every lane
// of the warp must call it.
__device__ __forceinline__ float2 reduce_peers(unsigned peers, float2 v) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  peers &= 0xfffffffeu << lane;                    // peers above it
  while (__any_sync(kFullWarp, peers)) {
    const int next = __ffs(peers);  // 1 + next peer above still summing
    const float gx = __shfl_sync(kFullWarp, v.x, (next - 1) & 31);
    const float gy = __shfl_sync(kFullWarp, v.y, (next - 1) & 31);
    if (next) {
      v.x += gx;
      v.y += gy;
    }
    peers &= __ballot_sync(kFullWarp, !(rank & 1));  // odd ranks are done
    rank >>= 1;
  }
  return v;
}

// Adds (g, h) to the 8-byte shared-memory slot at `slot` with one 64-bit
// compare-and-swap loop. On sm_90a a float atomicAdd to shared memory is
// itself such a loop (ATOMS.CAST.SPIN in the SASS), one per float; this is
// one per pair (ATOMS.CAS.64), half the loops and half the retries under
// contention.
__device__ __forceinline__ void add_pair_shared(float* slot, float2 v) {
  union Pair {
    unsigned long long bits;
    float2 gh;
  };
  unsigned long long* p = reinterpret_cast<unsigned long long*>(slot);
  Pair seen, sum;
  seen.bits = *p;
  unsigned long long assumed;
  do {
    assumed = seen.bits;
    sum.gh = make_float2(seen.gh.x + v.x, seen.gh.y + v.y);
    seen.bits = atomicCAS(p, assumed, sum.bits);
  } while (seen.bits != assumed);
}

// True in the lane that adds its group's sum: the lowest lane of `peers`.
__device__ __forceinline__ bool leads(unsigned peers) {
  return (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0;
}

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

template <int MODE, int MIN_BLOCKS>
__global__ void __launch_bounds__(512, MIN_BLOCKS) parts_histogram_kernel(
    const uint32_t* __restrict__ packed, const float2* __restrict__ gh,
    const int* __restrict__ pos, float* __restrict__ out, int n_rows,
    int n_features, int n_words, int n_nodes, int max_bins, int node_tile,
    int feat_group, int words_per_block) {
  constexpr int SPW = 4, kBits = 8;
  constexpr bool kPairCas = MODE & 1, kMatch = MODE & 2;
  constexpr bool kLockstep = (MODE & 4) || kMatch;
  extern __shared__ float hist[];
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int slab = nn * max_bins * 2;
  zero_private(hist, nf * slab);
  const uint32_t mask = symbol_mask(kBits);
  const int missing = max_bins - 1;
  const int lane = threadIdx.x & 31;
  const long long w_begin = (long long)blockIdx.x * words_per_block;
  const long long w_end = min(w_begin + words_per_block, (long long)n_words);
  for (long long w = w_begin + threadIdx.x; (kLockstep ? w - lane : w) < w_end;
       w += blockDim.x) {
    int node[SPW];
    float2 v[SPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = w * SPW + j;
      const int p = (w < w_end && row < n_rows) ? __ldg(pos + row) - n0 : -1;
      node[j] = (p >= 0 && p < nn) ? p : -1;
      v[j] = make_float2(0.f, 0.f);
      if (node[j] >= 0) {
        v[j] = __ldg(gh + row);
        any = true;
      }
    }
    if (!(kLockstep ? __any_sync(kFullWarp, any) : any)) continue;
    unsigned same = 0;
    if (kMatch) {
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int a = __shfl_xor_sync(kFullWarp, node[j], 1);
        const int b = __shfl_xor_sync(kFullWarp, node[j], 2);
        same |= (unsigned)(node[j] >= 0 && a == node[j]) << j;
        same |= (unsigned)(node[j] >= 0 && b == node[j]) << (SPW + j);
      }
    }
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t word = any ? __ldg(packed + (long long)(f0 + fl) * n_words + w) : 0u;
      uint32_t d1 = 0, d2 = 0;
      if (kMatch) {
        d1 = word ^ __shfl_xor_sync(kFullWarp, word, 1);
        d2 = word ^ __shfl_xor_sync(kFullWarp, word, 2);
      }
      float* hf = hist + fl * slab;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int shift = j * kBits;
        const int bin = (int)((word >> shift) & mask);
        const bool on = node[j] >= 0;
        const int key = on ? node[j] * max_bins + bin : -1;
        float2 sum = v[j];
        bool adds = on;
        if (kMatch) {
          const bool repeat =
              on && (bin == missing ||
                     (((same >> j) & 1) && ((d1 >> shift) & mask) == 0) ||
                     (((same >> (SPW + j)) & 1) && ((d2 >> shift) & mask) == 0));
          const unsigned hot = __ballot_sync(kFullWarp, repeat);
          if (hot & (hot - 1)) {
            const unsigned peers = __match_any_sync(kFullWarp, key);
            sum = reduce_peers(peers, v[j]);
            adds = adds && leads(peers);
          }
        }
        if (!adds) continue;
        if (kPairCas) {
          add_pair_shared(hf + key * 2, sum);
        } else {
          atomicAdd(hf + key * 2, sum.x);
          atomicAdd(hf + key * 2 + 1, sum.y);
        }
      }
    }
  }
  flush_private(hist, out, nf, slab, f0, n0, n_features, max_bins);
}

template <int MODE, int MIN_BLOCKS>
int launch_parts_histogram(const void* packed, const void* gh, const void* pos,
                           void* out, int n_rows, int n_features, int n_words,
                           int n_nodes, int max_bins, int node_tile,
                           int feat_group, int words_per_block, void* stream) {
  const size_t smem = (size_t)feat_group * node_tile * max_bins * 2 * sizeof(float);
  const dim3 grid((n_words + words_per_block - 1) / words_per_block,
                  (n_features + feat_group - 1) / feat_group,
                  (n_nodes + node_tile - 1) / node_tile);
  cudaError_t err = cudaFuncSetAttribute(
      parts_histogram_kernel<MODE, MIN_BLOCKS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  parts_histogram_kernel<MODE, MIN_BLOCKS><<<grid, 512, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos, (float*)out,
      n_rows, n_features, n_words, n_nodes, max_bins, node_tile, feat_group,
      words_per_block);
  return (int)cudaGetLastError();
}

constexpr int kScanWarps = 2;   // (node, feature) problems per block
constexpr int kScanChunk = 16;  // pairs lane 0 loads ahead of its adds
constexpr int kLoads = 4;       // 16-byte loads a lane keeps in flight

__device__ __forceinline__ float direction_gain(float gl, float hl, float g_tot,
                                                float h_tot, float parent,
                                                float lam, float mcw) {
  const float gr = __fsub_rn(g_tot, gl);
  const float hr = __fsub_rn(h_tot, hl);
  const float left = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
  const float right = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
  const float gain = __fmul_rn(0.5f, __fsub_rn(__fadd_rn(left, right), parent));
  return (hl >= mcw && hr >= mcw) ? gain : -INFINITY;
}

// Gain of threshold c (bins <= c go left) at the better missing direction.
__device__ __forceinline__ float threshold_gain(float2 l, float2 miss,
                                               float g_tot, float h_tot,
                                               float parent, float lam,
                                               float mcw, bool* left) {
  const float gain_r = direction_gain(l.x, l.y, g_tot, h_tot, parent, lam, mcw);
  const float gain_l =
      direction_gain(__fadd_rn(l.x, miss.x), __fadd_rn(l.y, miss.y), g_tot,
                     h_tot, parent, lam, mcw);
  *left = gain_l > gain_r;
  return *left ? gain_l : gain_r;
}

// True when (a, ia) comes before (b, ib) in torch.argmax's order: NaN first,
// then the larger gain, and among equals the lower bin.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (a != a) return b == b || ia < ib;  // a is NaN
  if (b != b) return false;
  return a > b || (a == b && ia < ib);
}

// Value bins 2q and 2q + 1 of a row, zero past its nv value bins; one
// 16-byte load where the row is 16-byte aligned.
__device__ __forceinline__ float4 two_pairs(const float2* hf, int q, int nv,
                                            bool aligned) {
  if (aligned && 2 * q + 1 < nv)
    return __ldg(reinterpret_cast<const float4*>(hf) + q);
  const float2 a = 2 * q < nv ? __ldg(hf + 2 * q) : make_float2(0.f, 0.f);
  const float2 b = 2 * q + 1 < nv ? __ldg(hf + 2 * q + 1) : make_float2(0.f, 0.f);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Pairs in a warp's stage: the value bins rounded up to whole chunks.
__host__ __device__ __forceinline__ int stage_pairs(int max_bins) {
  return (max_bins - 1 + kScanChunk - 1) / kScanChunk * kScanChunk;
}

template <int SKIP>
__global__ void __launch_bounds__(kScanWarps * 32) split_scan_part(
    const float2* __restrict__ hist,   // (n, F, B) (g, h) pairs
    const float* __restrict__ parent,  // (n, 2)
    float* __restrict__ out,           // (n, F, 5)
    int n_problems, int n_features, int max_bins, float lam, float mcw) {
  extern __shared__ float4 stage4[];  // [warp][stage_pairs / 2] (g, h) pairs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int prob = blockIdx.x * kScanWarps + warp;  // n * F + f
  if (prob >= n_problems) return;  // the whole warp
  const int n = prob / n_features;
  const int nv = max_bins - 1;  // value bins; the last bin is "missing"
  const int nc = nv - 1;        // candidate thresholds 0 .. nv - 2
  const int np = stage_pairs(max_bins);
  float4* st4 = stage4 + warp * (np / 2);
  const float2* stage = reinterpret_cast<const float2*>(st4);
  const float2* hf = hist + (long long)prob * max_bins;

  // The value bins into the stage, zero past them. A row of an even
  // max_bins starts 16-byte aligned (the wrapper aligns the tensor).
  const bool aligned = (reinterpret_cast<uintptr_t>(hf) & 15) == 0;
  for (int q0 = 0; q0 < np / 2; q0 += 32 * kLoads) {
    float4 x[kLoads];
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      x[k] = two_pairs(hf, q0 + 32 * k + lane, nv, aligned);
#pragma unroll
    for (int k = 0; k < kLoads; ++k)
      if (q0 + 32 * k + lane < np / 2) st4[q0 + 32 * k + lane] = x[k];
  }
  const float g_tot = parent[2 * n], h_tot = parent[2 * n + 1];
  const float2 miss = __ldg(hf + nv);
  __syncwarp();

  // Inclusive prefix sums of the candidates' bins, strictly left to right.
  // The chunk's padding pairs past nc take prefix sums too; nothing reads
  // them.
  if (lane == 0 && SKIP != 1) {
    float g = 0.f, h = 0.f;
    float4 x[kScanChunk / 2];
#pragma unroll
    for (int u = 0; u < kScanChunk / 2; ++u) x[u] = st4[u];
    for (int b0 = 0; b0 < nc; b0 += kScanChunk) {
      float4 next[kScanChunk / 2];
      const bool more = b0 + kScanChunk < nc;
#pragma unroll
      for (int u = 0; u < kScanChunk / 2; ++u)
        next[u] = more ? st4[(b0 + kScanChunk) / 2 + u] : x[u];
#pragma unroll
      for (int u = 0; u < kScanChunk / 2; ++u) {
        float4 s;
        g = __fadd_rn(g, x[u].x);
        h = __fadd_rn(h, x[u].y);
        s.x = g;
        s.y = h;
        g = __fadd_rn(g, x[u].z);
        h = __fadd_rn(h, x[u].w);
        s.z = g;
        s.w = h;
        st4[b0 / 2 + u] = s;
      }
#pragma unroll
      for (int u = 0; u < kScanChunk / 2; ++u) x[u] = next[u];
    }
  }
  __syncwarp();

  const float pgain = __fdiv_rn(__fmul_rn(g_tot, g_tot), __fadd_rn(h_tot, lam));
  float best = -INFINITY;
  int idx = INT_MAX;
  bool left;
  for (int c = lane; c < (SKIP == 2 ? 0 : nc); c += 32) {
    const float gain =
        threshold_gain(stage[c], miss, g_tot, h_tot, pgain, lam, mcw, &left);
    if (before(gain, c, best, idx)) {
      best = gain;
      idx = c;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(kFullWarp, best, off);
    const int oi = __shfl_down_sync(kFullWarp, idx, off);
    if (before(ob, oi, best, idx)) {
      best = ob;
      idx = oi;
    }
  }
  if (lane == 0) {
    const int b = idx == INT_MAX ? 0 : idx;  // -inf everywhere: bin 0
    const float2 l = stage[b];
    threshold_gain(l, miss, g_tot, h_tot, pgain, lam, mcw, &left);
    float* o = out + (long long)prob * 5;
    o[0] = best;
    o[1] = (float)b;
    o[2] = left ? 1.f : 0.f;
    o[3] = __fadd_rn(l.x, left ? miss.x : 0.f);
    o[4] = __fadd_rn(l.y, left ? miss.y : 0.f);
  }
}

template <int SKIP>
int launch_parts_split_scan(const void* hist, const void* parent, void* out,
                            int n_nodes, int n_features, int max_bins,
                            float lam, float mcw, void* stream) {
  const int n_problems = n_nodes * n_features;
  const size_t smem = (size_t)kScanWarps * stage_pairs(max_bins) * sizeof(float2);
  split_scan_part<SKIP><<<(n_problems + kScanWarps - 1) / kScanWarps,
                          kScanWarps * 32, smem, (cudaStream_t)stream>>>(
      (const float2*)hist, (const float*)parent, (float*)out, n_problems,
      n_features, max_bins, lam, mcw);
  return (int)cudaGetLastError();
}

}  // namespace

template <int MODE>
int parts_at(int blocks_per_sm, const void* packed, const void* gh,
             const void* pos, void* out, int n_rows, int n_features,
             int n_words, int n_nodes, int max_bins, int node_tile,
             int feat_group, int words_per_block, void* stream) {
#define PARTS_CALL(B)                                                        \
  launch_parts_histogram<MODE, B>(packed, gh, pos, out, n_rows, n_features, \
                                  n_words, n_nodes, max_bins, node_tile,    \
                                  feat_group, words_per_block, stream)
  return blocks_per_sm >= 4 ? PARTS_CALL(4) : blocks_per_sm == 3 ? PARTS_CALL(3) : PARTS_CALL(2);
#undef PARTS_CALL
}

// MODE as above, registers sized to the plan's `blocks_per_sm` as in
// histogram.cu; 8-bit symbols only. 512 threads a block.
extern "C" int parts_histogram(int mode, int blocks_per_sm, const void* packed,
                               const void* gh, const void* pos, void* out,
                               int n_rows, int n_features, int n_words,
                               int n_nodes, int max_bins, int node_tile,
                               int feat_group, int words_per_block,
                               void* stream) {
#define PARTS_MODE(M)                                                        \
  parts_at<M>(blocks_per_sm, packed, gh, pos, out, n_rows, n_features,      \
              n_words, n_nodes, max_bins, node_tile, feat_group,            \
              words_per_block, stream)
  switch (mode) {
    case 0: return PARTS_MODE(0);
    case 1: return PARTS_MODE(1);
    case 4: return PARTS_MODE(4);
    case 5: return PARTS_MODE(5);
    case 6: return PARTS_MODE(6);
    case 7: return PARTS_MODE(7);
    default: return (int)cudaErrorInvalidValue;
  }
#undef PARTS_MODE
}

extern "C" int parts_split_scan(int skip, const void* hist, const void* parent,
                                void* out, int n_nodes, int n_features,
                                int max_bins, float lam, float mcw,
                                void* stream) {
  if (max_bins < 3 || max_bins > 1025) return (int)cudaErrorInvalidValue;
  switch (skip) {
    case 0: return launch_parts_split_scan<0>(hist, parent, out, n_nodes, n_features, max_bins, lam, mcw, stream);
    case 1: return launch_parts_split_scan<1>(hist, parent, out, n_nodes, n_features, max_bins, lam, mcw, stream);
    case 2: return launch_parts_split_scan<2>(hist, parent, out, n_nodes, n_features, max_bins, lam, mcw, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

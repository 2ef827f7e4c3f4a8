// Best split per (node, feature): prefix sums over the value bins, gain for
// both missing-value directions, argmax (paper §2.3, EvaluateSplit).
//
// Replaces the TPU kernel src/repro/kernels/split_scan.py :: split_scan
// (_kernel), extended to five outputs so the caller can form the left
// child's (G, H) without a second pass: [gain, bin, default_left, gl, hl].
//
// What bounds it on the H100: it reads the level's histogram once
// (n_nodes * n_features * max_bins * 8 bytes: 1.8 MB at 32 x 28 x 256) and
// writes 20 bytes per (node, feature); about 0.6 us at 3.35 TB/s, so at
// these sizes launch latency and the sequential scan (B - 2 dependent adds
// per (node, feature)) dominate.
//
// Design: one warp per (node, feature), kScanWarps of them to a block, so
// that a level of 28 problems is 14 small blocks on 14 SMs. Nothing in it
// waits on __syncthreads.
//  * The warp loads its value bins' (g, h) pairs into a stage of its own in
//    shared memory, 16 bytes (two pairs) a lane per load where the row is
//    16-byte aligned, neighbouring lanes on neighbouring pairs, each lane's
//    loads all in flight before it stores any.
//  * Lane 0 adds the prefix sums strictly left to right, the g chain and the
//    h chain side by side, and loads the next kScanChunk pairs from the
//    stage while it adds the current ones, so that only the adds' latency
//    is serial. A parallel scan would associate the adds differently at
//    neighbouring bins, so an empty bin would no longer repeat its
//    predecessor's prefix exactly and thresholds that split the rows the
//    same way would stop tying.
//  * Each lane scores the thresholds lane, lane + 32, ... and keeps its
//    best; a shuffle reduction takes the argmax, the lowest bin winning
//    ties and NaN above everything, as torch.argmax does.
//  * Lane 0 writes the five fields.
//
// Feature masks and monotone constraints (colsample_*, monotone_constraints;
// src/repro/core/split.py) select other instantiations of the same body:
//  * kMask: a (node, feature) that the (n, F) uint8 mask leaves out writes
//    [-inf, 0, 0, 0, 0] and returns before its warp loads the row, so a
//    level sampled to half its features reads half the bytes.
//  * kMono: every candidate of every feature is scored at child weights
//    clipped to the node's [lower, upper] bounds, the gain taken at the
//    clipped weights, -(2 G w + (H + lam) w w), and a split whose clipped
//    weights break its feature's sign (wl <= wr for +1, wl >= wr for -1)
//    rejected; constraint 0 only clips.
// The unconstrained body, <false, false>, is the one without either.
// All arithmetic uses the _rn intrinsics (no FMA contraction) in the order
// of src/repro/core/split.py, and the scan order is that of
// kernels/ref.py::inclusive_scan, so the kernel is bit-identical to its
// plain version.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
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

// jnp.clip / torch.clamp: NaN stays NaN; lo > hi gives hi.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// -G / (H + lam) clipped to the node's bounds.
__device__ __forceinline__ float clipped_weight(float g, float h, float lam,
                                                float lo, float hi) {
  return clip(__fdiv_rn(-g, __fadd_rn(h, lam)), lo, hi);
}

// A leaf's objective reduction at weight w: -(((2 g) w) + (((h + lam) w) w)).
__device__ __forceinline__ float gain_at_weight(float g, float h, float w,
                                                float lam) {
  return -__fadd_rn(__fmul_rn(__fmul_rn(2.f, g), w),
                    __fmul_rn(__fmul_rn(__fadd_rn(h, lam), w), w));
}

// The node's constraint context: its feature's sign and its value bounds.
struct Mono {
  int c;
  float lo, hi;
};

__device__ __forceinline__ float mono_direction_gain(float gl, float hl, float g_tot,
                                                     float h_tot, float parent,
                                                     float lam, float mcw,
                                                     Mono m) {
  const float gr = __fsub_rn(g_tot, gl);
  const float hr = __fsub_rn(h_tot, hl);
  const float wl = clipped_weight(gl, hl, lam, m.lo, m.hi);
  const float wr = clipped_weight(gr, hr, lam, m.lo, m.hi);
  const float gain = __fmul_rn(
      0.5f, __fsub_rn(__fadd_rn(gain_at_weight(gl, hl, wl, lam),
                                gain_at_weight(gr, hr, wr, lam)),
                      parent));
  const bool sign_ok = m.c == 0 || (m.c > 0 && wl <= wr) || (m.c < 0 && wl >= wr);
  return (hl >= mcw && hr >= mcw && sign_ok) ? gain : -INFINITY;
}

// Gain of threshold c (bins <= c go left) at the better missing direction.
template <bool kMono>
__device__ __forceinline__ float threshold_gain(float2 l, float2 miss,
                                               float g_tot, float h_tot,
                                               float parent, float lam,
                                               float mcw, Mono m, bool* left) {
  float gain_r, gain_l;
  if constexpr (kMono) {
    gain_r = mono_direction_gain(l.x, l.y, g_tot, h_tot, parent, lam, mcw, m);
    gain_l = mono_direction_gain(__fadd_rn(l.x, miss.x), __fadd_rn(l.y, miss.y),
                                 g_tot, h_tot, parent, lam, mcw, m);
  } else {
    gain_r = direction_gain(l.x, l.y, g_tot, h_tot, parent, lam, mcw);
    gain_l = direction_gain(__fadd_rn(l.x, miss.x), __fadd_rn(l.y, miss.y), g_tot,
                            h_tot, parent, lam, mcw);
  }
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

template <bool kMask, bool kMono>
__global__ void __launch_bounds__(kScanWarps * 32) split_scan_kernel(
    const float2* __restrict__ hist,   // (n, F, B) (g, h) pairs
    const float* __restrict__ parent,  // (n, 2)
    float* __restrict__ out,           // (n, F, 5)
    const uint8_t* __restrict__ fmask,  // (n, F), kMask only
    const int8_t* __restrict__ mono,    // (F,) in {-1, 0, +1}, kMono only
    const float* __restrict__ bounds,   // (n, 2) [lower, upper], kMono only
    int n_problems, int n_features, int max_bins, float lam, float mcw) {
  extern __shared__ float4 stage4[];  // [warp][stage_pairs / 2] (g, h) pairs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int prob = blockIdx.x * kScanWarps + warp;  // n * F + f
  if (prob >= n_problems) return;  // the whole warp
  if constexpr (kMask) {
    if (!fmask[prob]) {  // left out: the warp reads nothing of its row
      if (lane == 0) {
        float* o = out + (long long)prob * 5;
        o[0] = -INFINITY;
        o[1] = o[2] = o[3] = o[4] = 0.f;
      }
      return;
    }
  }
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
  if (lane == 0) {
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

  Mono m{0, 0.f, 0.f};
  float pgain;
  if constexpr (kMono) {
    m = Mono{mono[prob - n * n_features], bounds[2 * n], bounds[2 * n + 1]};
    pgain = gain_at_weight(g_tot, h_tot, clipped_weight(g_tot, h_tot, lam, m.lo, m.hi),
                           lam);
  } else {
    pgain = __fdiv_rn(__fmul_rn(g_tot, g_tot), __fadd_rn(h_tot, lam));
  }
  float best = -INFINITY;
  int idx = INT_MAX;
  bool left;
  for (int c = lane; c < nc; c += 32) {
    const float gain = threshold_gain<kMono>(stage[c], miss, g_tot, h_tot, pgain,
                                             lam, mcw, m, &left);
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
    threshold_gain<kMono>(l, miss, g_tot, h_tot, pgain, lam, mcw, m, &left);
    float* o = out + (long long)prob * 5;
    o[0] = best;
    o[1] = (float)b;
    o[2] = left ? 1.f : 0.f;
    o[3] = __fadd_rn(l.x, left ? miss.x : 0.f);
    o[4] = __fadd_rn(l.y, left ? miss.y : 0.f);
  }
}

__global__ void empty_kernel() {}

template <bool kMask, bool kMono>
void launch(const void* hist, const void* parent, void* out, const void* fmask,
            const void* mono, const void* bounds, int n_problems, int n_features,
            int max_bins, float lam, float mcw, cudaStream_t stream) {
  const size_t smem = (size_t)kScanWarps * stage_pairs(max_bins) * sizeof(float2);
  split_scan_kernel<kMask, kMono><<<(n_problems + kScanWarps - 1) / kScanWarps,
                                    kScanWarps * 32, smem, stream>>>(
      (const float2*)hist, (const float*)parent, (float*)out,
      (const uint8_t*)fmask, (const int8_t*)mono, (const float*)bounds, n_problems,
      n_features, max_bins, lam, mcw);
}

}  // namespace

// fmask (n, F) uint8 may be null (no mask); mono (F,) int8 and bounds (n, 2)
// f32 are both null (unconstrained) or both given. One launch either way.
extern "C" int rt_split_scan(const void* hist, const void* parent, void* out,
                             const void* fmask, const void* mono,
                             const void* bounds, int n_nodes, int n_features,
                             int max_bins, float lam, float mcw, void* stream) {
  if (max_bins < 3 || max_bins > 1025) return (int)cudaErrorInvalidValue;
  if ((mono == nullptr) != (bounds == nullptr)) return (int)cudaErrorInvalidValue;
  const int n_problems = n_nodes * n_features;
  const cudaStream_t st = (cudaStream_t)stream;
  const auto run = fmask ? (mono ? launch<true, true> : launch<true, false>)
                         : (mono ? launch<false, true> : launch<false, false>);
  run(hist, parent, out, fmask, mono, bounds, n_problems, n_features, max_bins, lam,
      mcw, st);
  return (int)cudaGetLastError();
}

// A launch of a kernel that does nothing, on `stream`: the floor under the
// time of any launch, which chip_smoke.py times beside the split scan.
extern "C" int rt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

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
// these sizes launch latency and the sequential scan (B - 1 dependent adds
// per block) dominate.
//
// Design: one block per (feature, node), one thread per value bin (block
// size the next power of two >= max_bins - 1, at most 1024). The prefix
// sums are added strictly left to right in shared memory, by one thread for
// g and one for h: a parallel scan would associate the adds differently at
// neighbouring bins, so an empty bin would no longer repeat its
// predecessor's prefix exactly and thresholds that split the rows the same
// way would stop tying. The parallelism is across the (node, feature)
// blocks. Then each thread scores its candidate threshold and a
// shared-memory tree reduction takes the argmax, the lowest bin winning
// ties as jnp.argmax does. All arithmetic uses the _rn intrinsics (no FMA
// contraction) in the order of src/repro/core/split.py, and the scan order
// is that of kernels/ref.py::inclusive_scan, so the kernel is bit-identical
// to its plain version.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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

__global__ void split_scan_kernel(const float* __restrict__ hist,    // (n, F, B, 2)
                                  const float* __restrict__ parent,  // (n, 2)
                                  float* __restrict__ out,           // (n, F, 5)
                                  int n_features, int max_bins, float lam,
                                  float mcw) {
  extern __shared__ float smem[];
  const int nt = blockDim.x;
  float* sg = smem;           // [nt] prefix sums of g
  float* sh = smem + nt;      // [nt] prefix sums of h
  float* sval = smem + 2 * nt;                 // [nt] reduction: gain
  int* sidx = (int*)(smem + 3 * nt);           // [nt] reduction: bin
  const int f = blockIdx.x, n = blockIdx.y, t = threadIdx.x;
  const long long base = ((long long)n * n_features + f) * max_bins * 2;
  const float* hf = hist + base;
  const int nv = max_bins - 1;  // value bins; the last bin is "missing"

  sg[t] = t < nv ? hf[2 * t] : 0.f;
  sh[t] = t < nv ? hf[2 * t + 1] : 0.f;
  __syncthreads();
  // Inclusive prefix sums, strictly left to right: one thread for g, one
  // (in another warp when there is one) for h.
  const int h_thread = nt > 32 ? 32 : 0;
  if (t == 0) {
    float acc = 0.f;
    for (int b = 0; b < nv; ++b) sg[b] = acc = __fadd_rn(acc, sg[b]);
  }
  if (t == h_thread) {
    float acc = 0.f;
    for (int b = 0; b < nv; ++b) sh[b] = acc = __fadd_rn(acc, sh[b]);
  }
  __syncthreads();

  const float g_tot = parent[2 * n], h_tot = parent[2 * n + 1];
  const float g_miss = hf[2 * nv], h_miss = hf[2 * nv + 1];
  const float pgain = __fdiv_rn(__fmul_rn(g_tot, g_tot), __fadd_rn(h_tot, lam));
  float gain = -INFINITY;
  int idx = 0x7fffffff;
  if (t < nv - 1) {  // candidate threshold t: bin <= t goes left
    const float gain_r =
        direction_gain(sg[t], sh[t], g_tot, h_tot, pgain, lam, mcw);
    const float gain_l =
        direction_gain(__fadd_rn(sg[t], g_miss), __fadd_rn(sh[t], h_miss),
                       g_tot, h_tot, pgain, lam, mcw);
    gain = gain_l > gain_r ? gain_l : gain_r;
    idx = t;
  }
  sval[t] = gain;
  sidx[t] = idx;
  __syncthreads();
  for (int s = nt / 2; s > 0; s >>= 1) {
    if (t < s) {
      const float ov = sval[t + s];
      const int oi = sidx[t + s];
      if (ov > sval[t] || (ov == sval[t] && oi < sidx[t])) {
        sval[t] = ov;
        sidx[t] = oi;
      }
    }
    __syncthreads();
  }

  if (t == 0) {
    const int b = sidx[0] == 0x7fffffff ? 0 : sidx[0];
    const float gl = sg[b], hl = sh[b];
    const float gain_r = direction_gain(gl, hl, g_tot, h_tot, pgain, lam, mcw);
    const float gain_l =
        direction_gain(__fadd_rn(gl, g_miss), __fadd_rn(hl, h_miss), g_tot,
                       h_tot, pgain, lam, mcw);
    const bool dl = gain_l > gain_r;
    float* o = out + ((long long)n * n_features + f) * 5;
    o[0] = sval[0];
    o[1] = (float)b;
    o[2] = dl ? 1.f : 0.f;
    o[3] = __fadd_rn(gl, dl ? g_miss : 0.f);
    o[4] = __fadd_rn(hl, dl ? h_miss : 0.f);
  }
}

}  // namespace

extern "C" int rt_split_scan(const void* hist, const void* parent, void* out,
                             int n_nodes, int n_features, int max_bins,
                             float lam, float mcw, void* stream) {
  int nt = 32;
  while (nt < max_bins - 1) nt <<= 1;
  if (nt > 1024 || max_bins < 3) return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)nt * sizeof(float);
  dim3 grid(n_features, n_nodes);
  split_scan_kernel<<<grid, nt, smem, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)parent, (float*)out, n_features,
      max_bins, lam, mcw);
  return (int)cudaGetLastError();
}

// Measurement only: design variants of two kernels of
// src/repro_torch/kernels/csrc/ that the port does not ship, for
// tools/traversal_parts.py. Nothing of the port includes or launches this
// file.
//
//  * rt_parts_cuts: the cut selection (quantile_cuts.cu) with a group of
//    `warps` warps a feature (1, 2, 4 or 8) and 8 / warps features a
//    256-thread block. 8 is the shipped grid, one feature a block.
//  * rt_parts_traversal_kreg: the shipped traversal (ensemble_traversal.cu,
//    included below), with a class tile of one summed by the KREG-register
//    compare-select path instead of its one-register path.
#include <cuda_runtime.h>
#include <math.h>

#include "../src/repro_torch/kernels/csrc/ensemble_traversal.cu"

namespace cut_parts {

constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool kept(const float* cand, int i, int hi) {
  if (i >= hi) return false;
  const float prev = i == 0 ? -INFINITY : cand[i - 1];
  return cand[i] < INFINITY && cand[i] > prev;
}

// quantile_cuts_kernel with W warps a feature: the group's warps compute
// the candidates, then compact contiguous runs of them after the counts of
// the group's earlier warps.
__global__ void __launch_bounds__(THREADS) cuts_kernel(
    const float* __restrict__ srt, const int* __restrict__ n_valid, float* __restrict__ out,
    int n_rows, int n_features, int max_bins, int W) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_block = THREADS / 32 / W;
  const int slot = warp / W, wg = warp - slot * W;
  const int f = blockIdx.x * per_block + slot;
  const bool live = f < n_features;
  const int nvb = max_bins - 1;
  const int n_cuts = nvb - 1;
  float* cand = smem + slot * n_cuts;
  int* counts = reinterpret_cast<int*>(smem + per_block * n_cuts) + slot * W;

  if (live) {
    const float nv_m1 = (float)max(n_valid[f] - 1, 1);
    for (int i = wg * 32 + lane; i < n_cuts; i += W * 32) {
      const float qs = __fmul_rn(__fdiv_rn((float)(i + 1), (float)nvb), nv_m1);
      const int lo = min(max((int)floorf(qs), 0), n_rows - 1);
      const int hi = min(max(lo + 1, 0), n_rows - 1);
      const float frac = __fsub_rn(qs, (float)lo);
      const float lov = srt[(long long)lo * n_features + f];
      float hiv = srt[(long long)hi * n_features + f];
      if (!isfinite(hiv)) hiv = lov;
      const float c = __fadd_rn(lov, __fmul_rn(frac, __fsub_rn(hiv, lov)));
      cand[i] = isfinite(c) ? c : INFINITY;
    }
  }
  __syncthreads();
  const int run = ((n_cuts + W - 1) / W + 31) & ~31;
  const int lo = min(wg * run, n_cuts), hi = min(lo + run, n_cuts);
  int n_kept = 0;
  if (live)
    for (int c0 = lo; c0 < hi; c0 += 32)
      n_kept += __popc(__ballot_sync(FULL, kept(cand, c0 + lane, hi)));
  if (lane == 0) counts[wg] = n_kept;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < W; ++w) {
    if (w == wg) base = total;
    total += counts[w];
  }
  if (!live) return;
  float* o = out + (long long)f * n_cuts;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    const bool k = kept(cand, i, hi);
    const unsigned ballot = __ballot_sync(FULL, k);
    if (k) o[base + __popc(ballot & ((1u << lane) - 1u))] = cand[i];
    base += __popc(ballot);
  }
  for (int i = total + wg * 32 + lane; i < n_cuts; i += W * 32) o[i] = INFINITY;
}

}  // namespace cut_parts

extern "C" int rt_parts_cuts(const void* srt, const void* n_valid, void* out, int n_rows,
                             int n_features, int max_bins, int warps, void* stream) {
  if (max_bins < 3 || (warps != 1 && warps != 2 && warps != 4 && warps != 8))
    return (int)cudaErrorInvalidValue;
  const int per_block = cut_parts::THREADS / 32 / warps;
  const size_t smem =
      (size_t)per_block * ((max_bins - 2) * sizeof(float) + warps * sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      cut_parts::cuts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cut_parts::cuts_kernel<<<(n_features + per_block - 1) / per_block, cut_parts::THREADS,
                           smem, (cudaStream_t)stream>>>(
      (const float*)srt, (const int*)n_valid, (float*)out, n_rows, n_features, max_bins,
      warps);
  return (int)cudaGetLastError();
}

// rt_ensemble_margins with the class tile always summed in KREG registers.
extern "C" int rt_parts_traversal_kreg(const void* nodes, const void* x, void* out,
                                       int n_trees, int arena, int n_rows, int n_features,
                                       int n_classes, int max_depth, int class_tile,
                                       int trees_blk, int row_tile, int threads,
                                       void* stream) {
  if (arena % 2 || threads % 32 || threads > 512 || class_tile < 1 || class_tile > KREG)
    return (int)cudaErrorInvalidValue;
  const Args a{(const uint2*)nodes, (const float*)x, (float*)out, n_trees, arena, n_rows,
               n_features, n_classes, max_depth, class_tile, trees_blk};
  const cudaStream_t s = (cudaStream_t)stream;
  if (trees_blk > 0)
    return (int)(row_tile ? launch<true, true, KREG>(a, threads, s)
                          : launch<true, false, KREG>(a, threads, s));
  return (int)(row_tile ? launch<false, true, KREG>(a, threads, s)
                        : launch<false, false, KREG>(a, threads, s));
}

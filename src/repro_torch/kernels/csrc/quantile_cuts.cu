// Quantile cut selection from sorted columns (paper §2.1): the ascending
// cuts, +inf tail, that src/repro/kernels/quantile_cuts.py ::
// quantile_cuts_from_sorted returns.
//
// Replaces the TPU kernel src/repro/kernels/quantile_cuts.py ::
// quantile_cuts_from_sorted (_kernel) together with the jnp.sort its
// wrapper runs after the pallas_call. The column sort stays outside, in
// torch.sort, as the reference also sorts outside its kernel.
//
// What bounds it on the H100: almost nothing. It reads two sorted values
// per candidate cut (2 * n_features * (max_bins - 2) gathers, 57 KB at 28
// features x 256 bins) and writes the cuts: well under a microsecond of
// memory time, less than one empty launch, so launch latency dominates.
// Unlike the TPU kernel it keeps no column resident, so there is no row cap
// (the reference's CUTS_KERNEL_MAX_ROWS was a VMEM limit).
//
// Design: one feature a 256-thread block (a warp a feature, or a group of
// warps, was slower back to back: tools/traversal_parts.py). The block's
// threads reproduce src/repro/core/quantile.py:60-76 operation for
// operation with _rn intrinsics (lov + frac * (hiv - lov) is never
// contracted into an FMA) and put the candidates in shared memory.
// The candidates of a column never decrease (round-to-nearest arithmetic
// is monotone and the rank lo never decreases), so the kept ones (finite,
// above their pre-dedup predecessor) are strictly increasing, and an
// order-keeping compaction of them, +inf after, is bit for bit the
// ascending sort of the candidates with +inf dedup markers. Each warp
// compacts a contiguous run of candidates with __ballot_sync/__popc, after
// the counts of the block's earlier warps (a prefix over them in shared
// memory); the tail is filled with +inf.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// Candidate i survives the dedup: finite and above its predecessor.
__device__ __forceinline__ bool kept(const float* cand, int i, int hi) {
  if (i >= hi) return false;
  const float prev = i == 0 ? -INFINITY : cand[i - 1];
  return cand[i] < INFINITY && cand[i] > prev;
}

__global__ void __launch_bounds__(THREADS) quantile_cuts_kernel(
    const float* __restrict__ srt,  // (n, F)
    const int* __restrict__ n_valid,  // (F,)
    float* __restrict__ out,  // (F, n_cuts)
    int n_rows, int n_features, int max_bins) {
  extern __shared__ float cand[];  // the feature's candidates
  __shared__ int counts[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int f = blockIdx.x;
  const int nvb = max_bins - 1;  // value bins
  const int n_cuts = nvb - 1;

  const float nv_m1 = (float)max(n_valid[f] - 1, 1);
  for (int i = threadIdx.x; i < n_cuts; i += THREADS) {
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
  __syncthreads();

  // Warp w compacts candidates [lo, hi), in chunks of 32, after the kept
  // candidates of the block's earlier warps.
  const int run = ((n_cuts + WARPS - 1) / WARPS + 31) & ~31;
  const int lo = min(warp * run, n_cuts), hi = min(lo + run, n_cuts);
  int n_kept = 0;
  for (int c0 = lo; c0 < hi; c0 += 32)
    n_kept += __popc(__ballot_sync(FULL, kept(cand, c0 + lane, hi)));
  if (lane == 0) counts[warp] = n_kept;
  __syncthreads();
  int base = 0, total = 0;
  for (int w = 0; w < WARPS; ++w) {
    if (w == warp) base = total;
    total += counts[w];
  }
  float* o = out + (long long)f * n_cuts;
  for (int c0 = lo; c0 < hi; c0 += 32) {
    const int i = c0 + lane;
    const bool k = kept(cand, i, hi);
    const unsigned ballot = __ballot_sync(FULL, k);
    if (k) o[base + __popc(ballot & ((1u << lane) - 1u))] = cand[i];
    base += __popc(ballot);
  }
  for (int i = total + threadIdx.x; i < n_cuts; i += THREADS) o[i] = INFINITY;
}

}  // namespace

extern "C" int rt_quantile_cuts(const void* srt, const void* n_valid, void* out,
                                int n_rows, int n_features, int max_bins, void* stream) {
  if (max_bins < 3) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(max_bins - 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      quantile_cuts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  quantile_cuts_kernel<<<n_features, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)srt, (const int*)n_valid, (float*)out, n_rows, n_features, max_bins);
  return (int)cudaGetLastError();
}

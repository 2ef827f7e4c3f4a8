// Quantile cut selection from sorted columns (paper §2.1).
//
// Replaces the TPU kernel src/repro/kernels/quantile_cuts.py ::
// quantile_cuts_from_sorted (_kernel). The column sort stays outside, in
// torch.sort, as the reference also sorts outside its kernel; the ascending
// re-sort of the candidates is left to the caller, as in the reference.
//
// What bounds it on the H100: almost nothing. It reads two sorted values
// per candidate cut (2 * n_features * (max_bins - 2) gathers, 57 KB at 28
// features x 256 bins) and writes the candidates: well under a
// microsecond of memory time, so launch latency dominates. Unlike the TPU
// kernel it keeps no column resident, so there is no row cap (the
// reference's CUTS_KERNEL_MAX_ROWS was a VMEM limit).
//
// Design: one block per feature, one thread per rank (strided). Each
// thread reproduces src/repro/core/quantile.py:60-76 operation for
// operation with _rn intrinsics, so lov + frac * (hiv - lov) is never
// contracted into an FMA and the result is bit-identical to the plain
// version in kernels/ref.py. The candidates go through shared memory so
// the dedup can compare each with its (pre-dedup) predecessor.
#include <cuda_runtime.h>
#include <math.h>

namespace {

__global__ void quantile_cuts_kernel(const float* __restrict__ srt,  // (n, F)
                                     const int* __restrict__ n_valid,  // (F,)
                                     float* __restrict__ out,  // (F, n_cuts)
                                     int n_rows, int n_features, int max_bins) {
  extern __shared__ float cand[];
  const int f = blockIdx.x;
  const int nvb = max_bins - 1;  // value bins
  const int n_cuts = nvb - 1;
  const float nv_m1 = (float)max(n_valid[f] - 1, 1);
  for (int i = threadIdx.x; i < n_cuts; i += blockDim.x) {
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
  for (int i = threadIdx.x; i < n_cuts; i += blockDim.x) {
    const float prev = i == 0 ? -INFINITY : cand[i - 1];
    out[(long long)f * n_cuts + i] = cand[i] > prev ? cand[i] : INFINITY;
  }
}

}  // namespace

extern "C" int rt_quantile_cuts(const void* srt, const void* n_valid, void* out,
                                int n_rows, int n_features, int max_bins,
                                void* stream) {
  if (max_bins < 3) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(max_bins - 2) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      quantile_cuts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  quantile_cuts_kernel<<<n_features, 256, smem, (cudaStream_t)stream>>>(
      (const float*)srt, (const int*)n_valid, (float*)out, n_rows, n_features,
      max_bins);
  return (int)cudaGetLastError();
}

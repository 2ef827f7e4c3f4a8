// Bit-unpack of the compressed matrix (paper §2.2): packed words
// (n_features, n_words) -> bins (n_rows, n_features) int32, row-major, the
// layout of src/repro/core/compress.py :: unpack.
//
// Replaces the TPU kernel src/repro/kernels/decompress.py :: decompress
// (_kernel), which shifts and masks a (F_BLK, W_BLK) word tile in VMEM and
// transposes outside the kernel.
//
// What bounds it on the H100: bytes. It reads the words once
// (n_features * n_words * 4 bytes) and writes 4 bytes per (row, feature):
// 140 MB at 1M rows x 28 features with 8-bit symbols, 42 us at 3.35 TB/s.
// Two integer operations per output element are far below the card's rate.
//
// Design: one thread per output element (row r, feature f), in row-major
// output order, so neighbouring threads store to neighbouring addresses and
// the stores, the larger stream, coalesce. A thread reads word
// packed[f, r / spw], shifted by (r % spw) * bits; the spw rows of one word
// reread it, mostly from L1 or L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void decompress_kernel(const uint32_t* __restrict__ packed,
                                  int* __restrict__ out, long long n_out,
                                  int n_features, int n_words, int bits,
                                  int spw) {
  const uint32_t mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < n_out; i += stride) {
    const long long r = i / n_features;
    const int f = (int)(i - r * n_features);
    const long long w = r / spw;
    const int shift = (int)(r - w * spw) * bits;
    const uint32_t word = __ldg(packed + (long long)f * n_words + w);
    out[i] = (int)((word >> shift) & mask);
  }
}

}  // namespace

extern "C" int rt_decompress(const void* packed, void* out, int n_rows,
                             int n_features, int n_words, int bits,
                             int threads, void* stream) {
  if (bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;
  const long long n_out = (long long)n_rows * n_features;
  const long long blocks = (n_out + threads - 1) / threads;
  decompress_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (int*)out, n_out, n_features, n_words, bits,
      32 / bits);
  return (int)cudaGetLastError();
}

// Measurement only: design variants of the decompress kernel
// (src/repro_torch/kernels/csrc/decompress.cu, included below) that the
// port does not ship, for tools/decompress_parts.py. Nothing of the port
// includes or launches this file.
//
//  * rt_parts_decompress_i32: the earlier one-thread-per-element kernel
//    with 32-bit index math (a 32-bit / and % by F and by spw where it did
//    64-bit ones): what the 64-bit divisions cost it. Outputs below 2^31
//    elements only.
//  * rt_parts_decompress_plain: the shipped design with plain stores in
//    place of the evict-first st.global.cs.
//  * rt_parts_decompress_bulk: the shipped design with the output assembled
//    in shared memory and written by bulk copies (cp.async.bulk
//    .global.shared::cta): one per chunk of STAGE elements of a tile's
//    contiguous span, or one per row segment of a feature tile; two stages,
//    so that filling one overlaps the other's copy.
//    Launched as the shipped kernel is, one block a tile.
//  * rt_parts_decompress_persistent: the shipped tile on a persistent grid
//    (SM count x the resident blocks the occupancy calculator allows),
//    blocks striding over the tiles, the next tile's words copied while the
//    block writes the current one (two buffers).
#include "../src/repro_torch/kernels/csrc/decompress.cu"

namespace decompress_parts {

using namespace decompress_impl;

// One thread an element, as the earlier launch's grid gave each thread of
// its grid-stride loop one element (a stride loop in int would overflow past
// 2^30 elements).
__global__ void i32_kernel(const uint32_t* __restrict__ packed, int* __restrict__ out,
                           int n_out, int n_features, int n_words, int bits, int spw) {
  const uint32_t mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_out) return;
  const int r = i / n_features;
  const int f = i - r * n_features;
  const int w = r / spw;
  const int shift = (r - w * spw) * bits;
  out[i] = (int)((__ldg(packed + f * n_words + w) >> shift) & mask);
}

struct PlainStore {
  static __device__ __forceinline__ void v4(int* p, int4 v) {
    *reinterpret_cast<int4*>(p) = v;
  }
  static __device__ __forceinline__ void s1(int* p, int v) { *p = v; }
};

constexpr int STAGE = 4096;  // elements a stage: 16 KB
constexpr int BULK_SMEM = (BUF_WORDS + 2 * STAGE) * 4;

__device__ __forceinline__ void bulk_store(int* dst, const int* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               ::"l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Until at most one of this thread's bulk copies is still reading shared memory.
__device__ __forceinline__ void bulk_wait_one() {
  asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

template <int SPW>
__global__ void __launch_bounds__(THREADS) bulk_kernel(const Launch L) {
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* buf = smem;
  int* stage[2] = {(int*)(smem + BUF_WORDS), (int*)(smem + BUF_WORDS) + STAGE};
  const int F = L.n_features;
  const Tile T = tile_at<SPW>(L, blockIdx.x);
  load_tile(L, T, smem);
  cp_async_wait_all();
  __syncthreads();
  int c = 0;  // stages filled
  if (L.n_ftiles == 1) {
    const int n_el = T.rows * F;
    int* dst = L.out + (long long)T.row0 * F;
    const int n_bulk = n_el & ~3;  // the ragged last tile's n_el % 4 go element-wise
    for (int c0 = 0; c0 < n_bulk; c0 += STAGE, ++c) {
      const int len = min(STAGE, n_bulk - c0);
      int* st = stage[c & 1];
      if (threadIdx.x == 0) bulk_wait_one();  // the stage's copy two chunks ago
      __syncthreads();
      for (int v = threadIdx.x; v < (len >> 2); v += THREADS) {
        const int e = c0 + (v << 2);
        int r = (int)(((unsigned long long)e * L.magic) >> 32);
        int f = e - r * F;
        int s[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[j] = symbol<SPW>(L, buf, f, r);
          if (++f == F) {
            f = 0;
            ++r;
          }
        }
        reinterpret_cast<int4*>(st)[v] = make_int4(s[0], s[1], s[2], s[3]);
      }
      fence_async_shared();
      __syncthreads();
      if (threadIdx.x == 0) bulk_store(dst + c0, st, (uint32_t)len * 4);
    }
    const int e = n_bulk + threadIdx.x;
    if (e < n_el) {
      const int r = (int)(((unsigned long long)e * L.magic) >> 32);
      dst[e] = symbol<SPW>(L, buf, e - r * F, r);
    }
  } else if ((F & 3) == 0 && (T.fw & 3) == 0) {
    // Feature tile: up to STAGE / fw rows a stage, one bulk copy a row
    // segment, issued by that row's thread.
    const int rows_stage = min(STAGE / T.fw, THREADS);
    for (int r0 = 0; r0 < T.rows; r0 += rows_stage, ++c) {
      const int nr = min(rows_stage, T.rows - r0);
      int* st = stage[c & 1];
      if (threadIdx.x < rows_stage) bulk_wait_one();
      __syncthreads();
      for (int i = threadIdx.x; i < nr * T.fw; i += THREADS) {
        const int r = i / T.fw, fi = i - r * T.fw;
        st[i] = symbol<SPW>(L, buf, fi, r0 + r);
      }
      fence_async_shared();
      __syncthreads();
      if (threadIdx.x < nr)
        bulk_store(L.out + (long long)(T.row0 + r0 + threadIdx.x) * F + T.f0,
                   st + threadIdx.x * T.fw, (uint32_t)T.fw * 4);
    }
  } else {
    write_rows<SPW, PlainStore>(L, T, buf);  // segments not 16-byte aligned
  }
  bulk_wait_all();
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int SPW>
__global__ void __launch_bounds__(THREADS) persistent_kernel(const Launch L) {
  __shared__ uint32_t buf[2][BUF_WORDS];
  int t = blockIdx.x;
  if (t < L.n_tiles) load_tile(L, tile_at<SPW>(L, t), buf[0]);
  cp_async_commit();
  for (int b = 0; t < L.n_tiles; t += gridDim.x, b ^= 1) {
    if (t + (int)gridDim.x < L.n_tiles)
      load_tile(L, tile_at<SPW>(L, t + gridDim.x), buf[b ^ 1]);
    cp_async_commit();
    asm volatile("cp.async.wait_group 1;" ::: "memory");  // this tile's words
    __syncthreads();
    const Tile T = tile_at<SPW>(L, t);
    if (L.n_ftiles == 1) write_span<SPW, StreamingStore>(L, T, buf[b]);
    else write_rows<SPW, StreamingStore>(L, T, buf[b]);
    __syncthreads();  // buf[b] takes the tile after next
  }
}

template <int SPW>
int launch_persistent(const Launch& L, cudaStream_t stream) {
  int device = 0, n_sm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_kernel<SPW>,
                                                        THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  const int resident = n_sm * (per_sm > 0 ? per_sm : 1);
  const int grid = L.n_tiles < resident ? L.n_tiles : resident;
  persistent_kernel<SPW><<<grid, THREADS, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

template <int SPW>
int launch_bulk(const Launch& L, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      bulk_kernel<SPW>, cudaFuncAttributeMaxDynamicSharedMemorySize, BULK_SMEM);
  if (err != cudaSuccess) return (int)err;
  bulk_kernel<SPW><<<L.n_tiles, THREADS, BULK_SMEM, stream>>>(L);
  return (int)cudaGetLastError();
}

}  // namespace decompress_parts

extern "C" int rt_parts_decompress_i32(const void* packed, void* out, int n_rows,
                                       int n_features, int n_words, int bits, void* stream) {
  const long long n_out = (long long)n_rows * n_features;
  if (bits < 1 || bits > 32 || n_out >= INT_MAX || (long long)n_features * n_words >= INT_MAX)
    return (int)cudaErrorInvalidValue;
  const int blocks = (int)((n_out + 255) / 256);
  decompress_parts::i32_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)packed, (int*)out, (int)n_out, n_features, n_words, bits, 32 / bits);
  return (int)cudaGetLastError();
}

extern "C" int rt_parts_decompress_plain(const void* packed, void* out, int n_rows,
                                         int n_features, int n_words, int bits, void* stream) {
  using namespace decompress_impl;
  if (bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;
  const Launch L = make_launch(packed, out, n_rows, n_features, n_words, bits);
  if (L.n_tiles == 0) return (int)cudaErrorInvalidValue;
  return launch_spw<decompress_parts::PlainStore>(L, (cudaStream_t)stream);
}

#define PARTS_SPW_SWITCH(LAUNCH)                                                \
  using namespace decompress_impl;                                              \
  if (bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;                \
  const Launch L = make_launch(packed, out, n_rows, n_features, n_words, bits); \
  if (L.n_tiles == 0) return (int)cudaErrorInvalidValue;                       \
  cudaStream_t s = (cudaStream_t)stream;                                        \
  switch (32 / bits) {                                                          \
    case 1: return LAUNCH<1>(L, s);                                             \
    case 2: return LAUNCH<2>(L, s);                                             \
    case 3: return LAUNCH<3>(L, s);                                             \
    case 4: return LAUNCH<4>(L, s);                                             \
    case 5: return LAUNCH<5>(L, s);                                             \
    case 6: return LAUNCH<6>(L, s);                                             \
    case 8: return LAUNCH<8>(L, s);                                             \
    case 10: return LAUNCH<10>(L, s);                                           \
    case 16: return LAUNCH<16>(L, s);                                           \
    case 32: return LAUNCH<32>(L, s);                                           \
    default: return (int)cudaErrorInvalidValue;                                 \
  }

extern "C" int rt_parts_decompress_bulk(const void* packed, void* out, int n_rows,
                                        int n_features, int n_words, int bits, void* stream) {
  PARTS_SPW_SWITCH(decompress_parts::launch_bulk)
}

extern "C" int rt_parts_decompress_persistent(const void* packed, void* out, int n_rows,
                                              int n_features, int n_words, int bits,
                                              void* stream) {
  PARTS_SPW_SWITCH(decompress_parts::launch_persistent)
}

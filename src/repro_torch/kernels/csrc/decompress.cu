// Bit-unpack of the compressed matrix (paper §2.2): packed words
// (n_features, n_words) -> bins (n_rows, n_features) int32, row-major, the
// layout of src/repro/core/compress.py :: unpack.
//
// Replaces the TPU kernel src/repro/kernels/decompress.py :: decompress
// (_kernel), which shifts and masks a (F_BLK, W_BLK) word tile in VMEM and
// transposes outside the kernel.
//
// What bounds it on the H100: bytes, and most of them writes. It reads the
// words once (n_features * n_words * 4 bytes) and writes 4 bytes per (row,
// feature), 8x the reads at 8-bit symbols: 140 MB at 1M rows x 28 features,
// 42 us at 3.35 TB/s. A shift and a mask per element are far below the
// card's integer rate, as long as little else is done per element.
//
// Design:
//  * A block unpacks one tile: 32 words (one 128-byte line) of each feature
//    row, so 32 * spw rows, of every feature when F <= 64, else of 64
//    features. Its warps copy the tile's lines into shared memory with
//    cp.async, a warp one line, coalesced, then write the tile. The grid
//    has one block a tile, so the hardware overlaps one block's copy with
//    other blocks' writes: a persistent grid sized by occupancy, its loop
//    double-buffered, was slower at every 8-bit shape timed and most on
//    Bosch-shaped words (PERF.md §6, tools/decompress_parts.py).
//  * Shared rows are padded to 33 words, features 32-63 shifted by one word
//    more, so that a warp's lanes, which read one word column of up to 16
//    features, hit different banks.
//  * The writes carry the design: each thread builds 16-byte vectors of 4
//    consecutive output elements and stores them evict-first (st.global.cs),
//    since nothing reads the output again in this launch. A tile that
//    covers all of F writes one contiguous span whose start is 128-byte
//    aligned (32 * spw rows of F elements), as flat vectors whatever F is; a
//    vector's (row, feature) comes from one multiply-high by a per-launch
//    magic number, not a division. A feature tile writes one 256-byte
//    segment a row, 16 lanes a row, as vectors when F % 4 == 0 and element
//    by element otherwise.
//  * Index arithmetic is 32-bit inside a tile, with one 64-bit base a tile,
//    so outputs past 2^31 elements work. The ragged last tile (rows past
//    n_rows) and the words past n_words are masked.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace decompress_impl {

constexpr int THREADS = 256;
constexpr int TILE_WORDS = 32;  // words of a feature row a tile: one 128-byte line
constexpr int STRIDE = TILE_WORDS + 1;  // padded shared row, in words
constexpr int FEAT_TILE = 64;  // features a tile when F is larger; all of F otherwise
constexpr int BUF_WORDS = FEAT_TILE * STRIDE;  // the shift of features 32-63 stays in the pad

struct Launch {
  const uint32_t* packed;
  int* out;
  int n_rows, n_features, n_words, bits;
  uint32_t mask;
  int feat_tile;  // features a tile
  int n_ftiles;  // feature tiles a row tile
  int n_tiles;
  unsigned long long magic;  // ceil(2^32 / F): e / F == (e * magic) >> 32 for e * F < 2^32
};

struct Tile {
  int row0, rows;  // first output row, rows in this tile
  int f0, fw;  // first feature, features in this tile
  int w0, ww;  // first word, words in this tile
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"(smem_addr(dst)), "l"(src) : "memory");
}

// Every cp.async of this thread has landed (commits the open group first).
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Word `wl` of the tile's feature `fi` in a shared buffer.
__device__ __forceinline__ int slot(int fi, int wl) {
  return fi * STRIDE + wl + ((fi >> 5) & 1);
}

template <int SPW>
__device__ __forceinline__ Tile tile_at(const Launch& L, int t) {
  int rt = t, ft = 0;
  if (L.n_ftiles > 1) {
    rt = t / L.n_ftiles;
    ft = t - rt * L.n_ftiles;
  }
  Tile T;
  T.row0 = rt * (TILE_WORDS * SPW);
  T.rows = min(TILE_WORDS * SPW, L.n_rows - T.row0);
  T.f0 = ft * L.feat_tile;
  T.fw = min(L.feat_tile, L.n_features - T.f0);
  T.w0 = rt * TILE_WORDS;
  T.ww = min(TILE_WORDS, L.n_words - T.w0);
  return T;
}

__device__ __forceinline__ void load_tile(const Launch& L, const Tile& T, uint32_t* buf) {
  const uint32_t* src = L.packed + (long long)T.f0 * L.n_words + T.w0;
  for (int i = threadIdx.x; i < T.fw * TILE_WORDS; i += THREADS) {
    const int fi = i / TILE_WORDS, wl = i % TILE_WORDS;
    if (wl < T.ww) cp_async4(buf + slot(fi, wl), src + (long long)fi * L.n_words + wl);
  }
}

// Symbol of row `r` (of the tile) in the tile's feature `fi`.
template <int SPW>
__device__ __forceinline__ int symbol(const Launch& L, const uint32_t* buf, int fi, int r) {
  return (int)((buf[slot(fi, r / SPW)] >> ((r % SPW) * L.bits)) & L.mask);
}

// The store of the writes; a template argument so that
// tools/decompress_parts.cu can time the same kernel with plain stores.
struct StreamingStore {  // evict-first: the output is not read again here
  static __device__ __forceinline__ void v4(int* p, int4 v) {
    __stcs(reinterpret_cast<int4*>(p), v);
  }
  static __device__ __forceinline__ void s1(int* p, int v) { __stcs(p, v); }
};

// A tile that covers all of F: its output is rows * F contiguous elements.
template <int SPW, class Store>
__device__ __forceinline__ void write_span(const Launch& L, const Tile& T, const uint32_t* buf) {
  const int F = L.n_features;
  const int n_el = T.rows * F;
  int* dst = L.out + (long long)T.row0 * F;
  const int n_vec = n_el >> 2;
  for (int v = threadIdx.x; v < n_vec; v += THREADS) {
    const int e = v << 2;
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
    Store::v4(dst + e, make_int4(s[0], s[1], s[2], s[3]));
  }
  const int e = (n_vec << 2) + threadIdx.x;  // the ragged last tile's n_el % 4
  if (e < n_el) {
    const int r = (int)(((unsigned long long)e * L.magic) >> 32);
    Store::s1(dst + e, symbol<SPW>(L, buf, e - r * F, r));
  }
}

// A feature tile: one segment of fw elements a row, FEAT_TILE / 4 lanes a
// row, each lane 4 consecutive features.
template <int SPW, class Store>
__device__ __forceinline__ void write_rows(const Launch& L, const Tile& T, const uint32_t* buf) {
  constexpr int LANES = FEAT_TILE / 4;
  const int F = L.n_features;
  const int fi = (threadIdx.x % LANES) * 4;
  if (fi >= T.fw) return;
  const bool vec = (F & 3) == 0 && fi + 4 <= T.fw;
  int* dst = L.out + (long long)T.row0 * F + T.f0 + fi;
  for (int r = threadIdx.x / LANES; r < T.rows; r += THREADS / LANES) {
    int* p = dst + (long long)r * F;
    if (vec) {
      Store::v4(p, make_int4(symbol<SPW>(L, buf, fi, r), symbol<SPW>(L, buf, fi + 1, r),
                             symbol<SPW>(L, buf, fi + 2, r), symbol<SPW>(L, buf, fi + 3, r)));
    } else {
      for (int j = 0; j < 4 && fi + j < T.fw; ++j) Store::s1(p + j, symbol<SPW>(L, buf, fi + j, r));
    }
  }
}

template <int SPW, class Store>
__global__ void __launch_bounds__(THREADS) decompress_kernel(const Launch L) {
  __shared__ uint32_t buf[BUF_WORDS];
  const Tile T = tile_at<SPW>(L, blockIdx.x);
  load_tile(L, T, buf);
  cp_async_wait_all();
  __syncthreads();
  if (L.n_ftiles == 1) write_span<SPW, Store>(L, T, buf);
  else write_rows<SPW, Store>(L, T, buf);
}

// The launch's tiles, or a zero tile count when the shape is refused.
inline Launch make_launch(const void* packed, void* out, int n_rows, int n_features,
                          int n_words, int bits) {
  Launch L{};
  const int spw = 32 / bits;
  if (n_rows < 1 || n_features < 1 || (long long)n_words * spw < n_rows) return L;
  L.packed = (const uint32_t*)packed;
  L.out = (int*)out;
  L.n_rows = n_rows;
  L.n_features = n_features;
  L.n_words = n_words;
  L.bits = bits;
  L.mask = bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
  L.feat_tile = n_features <= FEAT_TILE ? n_features : FEAT_TILE;
  L.n_ftiles = (n_features + L.feat_tile - 1) / L.feat_tile;
  const long long rows_tile = TILE_WORDS * spw;
  const long long n_tiles = (n_rows + rows_tile - 1) / rows_tile * L.n_ftiles;
  L.n_tiles = n_tiles < INT_MAX / 2 ? (int)n_tiles : 0;
  L.magic = ((1ull << 32) + n_features - 1) / n_features;
  return L;
}

template <int SPW, class Store>
int launch(const Launch& L, cudaStream_t stream) {
  decompress_kernel<SPW, Store><<<L.n_tiles, THREADS, 0, stream>>>(L);
  return (int)cudaGetLastError();
}

template <class Store>
int launch_spw(const Launch& L, cudaStream_t stream) {
  switch (32 / L.bits) {
    case 1: return launch<1, Store>(L, stream);
    case 2: return launch<2, Store>(L, stream);
    case 3: return launch<3, Store>(L, stream);
    case 4: return launch<4, Store>(L, stream);
    case 5: return launch<5, Store>(L, stream);
    case 6: return launch<6, Store>(L, stream);
    case 8: return launch<8, Store>(L, stream);
    case 10: return launch<10, Store>(L, stream);
    case 16: return launch<16, Store>(L, stream);
    case 32: return launch<32, Store>(L, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decompress_impl

extern "C" int rt_decompress(const void* packed, void* out, int n_rows, int n_features,
                             int n_words, int bits, void* stream) {
  using namespace decompress_impl;
  if (bits < 1 || bits > 32) return (int)cudaErrorInvalidValue;
  const Launch L = make_launch(packed, out, n_rows, n_features, n_words, bits);
  if (L.n_tiles == 0) return (int)cudaErrorInvalidValue;
  return launch_spw<StreamingStore>(L, (cudaStream_t)stream);
}

// Gradient histograms straight from the bit-packed matrix (paper §2.3).
// Three kernels share the contract of src/repro/core/histogram.py: per
// (node, feature, bin) sums of (g, h) over the rows at each level-local
// node position, (n_nodes, n_features, max_bins, 2). They add in 64-bit
// fixed point (upstream XGBoost's GradientQuantiser; kernels/fixed.py): each
// row's (g, h) is quantised to int64 round-half-even(v * 2^k) before any
// addition, with the call's exponent k read from the device through a
// pointer, and every add is an integer add into an int64 accumulator
// (n_nodes, n_features, max_bins, 2). Integer adds commute, so the sums, and
// the float32 histogram that histogram_dequantise_kernel converts from them
// once at the end, are the same bits on every call, whatever the atomics'
// order, the launch plan or the chunk layout.
//
//  * histogram_private_kernel replaces the TPU kernel
//    src/repro/kernels/histogram.py :: build_histograms_packed_kernel
//    (_private_kernel, _tree_add), which turns the scatter into one-hot
//    matmuls on the MXU because the TPU has no fast atomics. Hopper has
//    them, so this is the paper's own design: privatised shared-memory
//    histograms, flushed to the output with global atomics.
//  * histogram_rows_kernel is the same privatised design over a compacted
//    row buffer: slot i holds row row_ids[i]. It serves
//    src/repro/core/histogram.py :: build_histograms_packed_rows, the
//    subtraction trick's smaller-child histogram below the root.
//  * histogram_global_kernel replaces the TPU kernel
//    src/repro/kernels/histogram.py :: histogram_packed (_kernel), whose
//    output block is its accumulator. The design choice carried over is
//    that one: no private histogram and no flush, every (row, feature)
//    adds straight into the output with global atomics, which stays
//    L2-resident at these sizes (1.8 MB at 32 nodes x 28 x 256).
//
// What bounds them on the H100: each full level reads the packed words once
// (n_features * n_rows * bits / 8 bytes), gh (8 B/row) and pos (4 B/row),
// and writes a small histogram: about 40 MB at 1M rows x 28 features, or
// 12 us at 3.35 TB/s. The real limit is the rate of atomic updates: one
// (g, h) pair per (row, feature), 28M per level at that size, in shared
// memory for the private and row kernels, in L2 for the global one.
//
// Launch plan of the private kernels (kernels/histogram.py::launch_plan):
// a block owns a stripe of words (or slots) x a group of features x a range
// of nodes, and keeps a private histogram for exactly those in dynamic
// shared memory: [feature][node][bin][g,h] int64. The plan caps that
// histogram (16 bytes a bin) so that a target number of blocks fit on an
// SM (the row-id kernel three, about 75 KB of the SM's 228 KB; the
// privatised kernel two),
// and puts more node tiles and feature groups on the grid to make up: with
// one 224 KB block (16 warps) per SM the row-id kernel took 2-2.5x its time
// at four 56 KB blocks.
//
// histogram_private_kernel: consecutive threads take consecutive words of a
// feature, so word loads coalesce along W, and the warp steps through its
// words together (a lane past the stripe's end carries no rows), so that
// the votes below have all 32 lanes. A thread unpacks SPW symbols per word
// and keeps the SPW rows' quantised (g, h) and node in registers across the
// feature group; rows with a position outside the block's node range
// (n_nodes or -1 = inactive) are skipped, and a word whose rows are all
// skipped loads nothing.
//  * Each (g, h) is added to shared memory as two 64-bit integers, each
//    with two native 32-bit atomicAdds and a carry, as in
//    histogram_rows_kernel (add_shared_64).
//  * The key of the j-th symbol of a lane's word is its (node, bin). Where
//    the warp shows repeats at symbol j (two or more lanes in the missing
//    bin, or a lane whose key equals its xor-1 or xor-2 neighbour's, which
//    also catches a constant non-missing feature), lanes with equal keys
//    are summed with __match_any_sync and a shuffle tree, and one lane adds
//    the sum. Where it shows none the match is skipped. The neighbours'
//    nodes are compared once per word and their symbols with one shuffle of
//    the word per feature, so the test costs two shuffles and SPW votes per
//    (word, feature).
//
// histogram_rows_kernel: a thread takes one slot, and for each feature of
// the group one word packed[f, rid / SPW], shifted by (rid % SPW) * bits.
//  * The words of kRowsUnroll features are loaded before any of them is
//    used, so a slot keeps several scattered loads in flight.
//  * Each (g, h) is added to shared memory as two 64-bit integers, each
//    with two native 32-bit atomicAdds and a carry (add_shared_64): on
//    sm_90a both a float and a 64-bit integer atomicAdd to shared memory
//    are compare-and-swap loops (ATOMS.CAST.SPIN, .64), a 32-bit integer
//    one is native (ATOMS.ADD). Before the fixed point it was one 64-bit
//    compare-and-swap on the float pair.
//  * Where a warp shows repeats (two or more lanes in the missing bin, or a
//    lane whose (node, bin) equals its neighbour's), lanes with equal
//    (node, bin) are summed with __match_any_sync and a shuffle tree, and
//    one lane adds the sum: a skewed feature would otherwise send up to 32
//    atomics after one address. Where it shows none, the match is skipped:
//    on spread-out bins it costs about what it saves.
//  * At most 32 registers a thread, so that four 56 KB blocks fit an SM.
//  * A slot at the dump position, or with a row id outside the packed
//    words, contributes nothing and reads nothing past its position. The
//    buffer keeps row order, so neighbouring slots often share a word.
// Both private kernels flush the non-zero entries of their histogram to the
// int64 accumulator with 64-bit integer global atomicAdd at the end. The
// caller zeroes the accumulator (or hands a running one: the streamed pass
// adds chunk after chunk into one, at one exponent).
//
// histogram_global_kernel: a thread takes one word and its SPW rows, and
// the whole warp walks the features in step, so the lanes of a warp always
// add into one feature's output slab; each warp starts at its own feature,
// so the card's warps spread over all the slabs instead of all starting on
// feature 0's few L2 lines. Per
// symbol, lanes whose (node, bin) agree are summed with __match_any_sync
// and a shuffle tree, and one lane adds the warp's sum with two 64-bit
// integer global atomicAdds. The int64 accumulator is the output, as on the
// TPU: there is no private copy and no flush, only the conversion pass.
//
// Summation order is not fixed from run to run in any of the three kernels;
// the integer sums do not depend on it. A non-finite (g, h) in a call gives
// the exponent kNonFinite: every row quantises to 0 and the conversion
// writes NaN everywhere.
//
// The chunk stack (external memory, src/repro/core/compress.py ::
// ChunkedPackedBins): the two private kernels have a chunked instantiation
// (template flag kChunked) that reads the words of an (n_chunks,
// n_features, words_per_chunk) stack, chunk c holding rows c * chunk_rows
// .. c * chunk_rows + chunk_rows - 1, each chunk padded with zero words.
// Row r's word of feature f is ((r / chunk_rows) * n_features + f) *
// words_per_chunk + (r % chunk_rows) / SPW. The privatised kernel walks the
// stack's n_chunks * words_per_chunk words as one range, and a chunk's
// padding symbols (offset >= chunk_rows) and the rows past n_rows of a
// short last chunk go to the dump slot: the whole stack is read in one
// launch, never one a chunk. The flat instantiation is the body above,
// unchanged (its kChunked branches fold away at compile time).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRowsUnroll = 4;  // features whose words a slot loads at once
// The exponent of a call whose (g, h) holds inf or NaN (kernels/fixed.py).
constexpr int kNonFinite = -2147483647 - 1;

// 2^k as a double, built from its bits, for k in [-1022, 1022]; 0 for
// kNonFinite, so that every row of such a call quantises to 0.
__device__ __forceinline__ double pow2(int k) {
  return k == kNonFinite ? 0.0
                         : __longlong_as_double((long long)(k + 1023) << 52);
}

// round-half-even(v * scale) as int64; the product is exact in double. NaN
// (inf * 0 under kNonFinite) quantises to 0, as in kernels/fixed.py.
__device__ __forceinline__ long long quantise(float v, double scale) {
  const double x = (double)v * scale;
  return x == x ? __double2ll_rn(x) : 0ll;
}

__device__ __forceinline__ longlong2 quantise_pair(float2 v, double scale) {
  return make_longlong2(quantise(v.x, scale), quantise(v.y, scale));
}

// Sum of v over `peers` (the lanes of the warp whose key equals this lane's),
// complete in the lowest lane of each group; the shuffle tree takes
// ceil(log2(group size)) steps and none when every key is unique. Every lane
// of the warp must call it. Integer sums: the tree's order does not matter.
__device__ __forceinline__ longlong2 reduce_peers(unsigned peers, longlong2 v) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  peers &= 0xfffffffeu << lane;                    // peers above it
  while (__any_sync(kFullWarp, peers)) {
    const int next = __ffs(peers);  // 1 + next peer above still summing
    const long long gx = __shfl_sync(kFullWarp, v.x, (next - 1) & 31);
    const long long gy = __shfl_sync(kFullWarp, v.y, (next - 1) & 31);
    if (next) {
      v.x += gx;
      v.y += gy;
    }
    peers &= __ballot_sync(kFullWarp, !(rank & 1));  // odd ranks are done
    rank >>= 1;
  }
  return v;
}

// Adds v to the int64 in shared memory at `slot` with two native 32-bit
// atomicAdds, the low word's carry going into the high word (upstream
// XGBoost's AtomicAdd64As32): on sm_90a a 64-bit shared atomicAdd compiles
// to a compare-and-swap loop (ATOMS.CAST.SPIN.64). Each wrap of the low
// word happens in exactly one add, which carries, so the int64 ends exact
// (mod 2^64, two's complement: the signed sum) in any order.
__device__ __forceinline__ void add_shared_64(long long* slot, long long v) {
  unsigned* lo = reinterpret_cast<unsigned*>(slot);
  const unsigned x_lo = (unsigned)v;
  const unsigned x_hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(lo, x_lo);
  atomicAdd(lo + 1, x_hi + (old > 0xffffffffu - x_lo ? 1u : 0u));
}

// Adds the quantised (g, h) to the 16-byte shared-memory slot at `slot`.
__device__ __forceinline__ void add_pair_shared(long long* slot, longlong2 v) {
  add_shared_64(slot, v.x);
  add_shared_64(slot + 1, v.y);
}

// The same into the int64 accumulator in global memory.
__device__ __forceinline__ void add_pair_global(long long* slot, longlong2 v) {
  unsigned long long* p = reinterpret_cast<unsigned long long*>(slot);
  atomicAdd(p, (unsigned long long)v.x);
  atomicAdd(p + 1, (unsigned long long)v.y);
}

// True in the lane that adds its group's sum: the lowest lane of `peers`.
__device__ __forceinline__ bool leads(unsigned peers) {
  return (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0;
}

__device__ __forceinline__ uint32_t symbol_mask(int bits) {
  return bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
}

__device__ __forceinline__ void zero_private(long long* hist, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) hist[i] = 0;
  __syncthreads();
}

// Adds a block's private histogram [fl][node - n0][bin][2] into the int64
// accumulator.
__device__ __forceinline__ void flush_private(const long long* hist,
                                              long long* out, int nf, int slab,
                                              int f0, int n0, int n_features,
                                              int max_bins) {
  __syncthreads();
  const int per_node = max_bins * 2;
  for (int i = threadIdx.x; i < nf * slab; i += blockDim.x) {
    const long long v = hist[i];
    if (v == 0) continue;
    const int fl = i / slab;
    const int r = i - fl * slab;
    const int node = r / per_node;
    const int rem = r - node * per_node;  // bin * 2 + (0 for g, 1 for h)
    const long long o =
        ((long long)(n0 + node) * n_features + f0 + fl) * per_node + rem;
    atomicAdd(reinterpret_cast<unsigned long long*>(out + o),
              (unsigned long long)v);
  }
}

// 512 threads a block (kernels/histogram.py). MIN_BLOCKS is the launch
// plan's blocks per SM (2 to 4 with up to four symbols a word, 8 bits and
// wider), so that registers (at most 64, 40 or 32 a thread) never hold fewer
// blocks on an SM than the plan's shared memory does; more symbols a word
// need more registers than that without spilling, and take what they need
// (MIN_BLOCKS 1).
//
// kChunked: `packed` is the chunk stack and n_words its n_chunks *
// words_per_chunk words, walked as one range.
template <int SPW, int MIN_BLOCKS, bool kChunked>
__global__ void __launch_bounds__(512, MIN_BLOCKS) histogram_private_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words) or the stack
    const float2* __restrict__ gh,        // (n_rows,) (g, h)
    const int* __restrict__ pos,          // (n_rows,) node, n_nodes = inactive
    long long* __restrict__ out,          // (n_nodes, n_features, max_bins, 2)
    const int* __restrict__ kexp,         // the call's exponent k
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int words_per_block,
    int chunk_rows, int words_per_chunk) {
  extern __shared__ long long hist[];  // [fl][node - n0][bin][2]
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int slab = nn * max_bins * 2;  // int64 entries per feature
  const double scale = pow2(__ldg(kexp));
  zero_private(hist, nf * slab);

  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  const long long w_begin = (long long)blockIdx.x * words_per_block;
  const long long w_end = min(w_begin + words_per_block, (long long)n_words);
  for (long long w = w_begin + threadIdx.x; w - (threadIdx.x & 31) < w_end;
       w += blockDim.x) {
    int node[SPW];
    longlong2 v[SPW];
    bool any = false;
    // Chunked: the word's chunk, its first row, the end of the chunk's real
    // rows and the word of feature 0.
    long long row0 = 0, row_end = 0;
    const uint32_t* wp = packed;
    if constexpr (kChunked) {
      const long long c = w / words_per_chunk;
      const long long lw = w - c * words_per_chunk;
      row0 = c * chunk_rows + lw * SPW;
      row_end = min((long long)n_rows, (c + 1) * chunk_rows);
      wp = packed + c * n_features * words_per_chunk + lw;
    }
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = kChunked ? row0 + j : w * SPW + j;
      const int p = (w < w_end && row < (kChunked ? row_end : n_rows))
                        ? __ldg(pos + row) - n0 : -1;
      node[j] = (p >= 0 && p < nn) ? p : -1;
      v[j] = make_longlong2(0, 0);
      if (node[j] >= 0) {
        v[j] = quantise_pair(__ldg(gh + row), scale);
        any = true;
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    // Bit j: the xor-1 neighbour's j-th row is at this lane's j-th node;
    // bit SPW + j: the xor-2 neighbour's.
    unsigned long long same = 0;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const int a = __shfl_xor_sync(kFullWarp, node[j], 1);
      const int b = __shfl_xor_sync(kFullWarp, node[j], 2);
      same |= (unsigned long long)(node[j] >= 0 && a == node[j]) << j;
      same |= (unsigned long long)(node[j] >= 0 && b == node[j]) << (SPW + j);
    }
    for (int fl = 0; fl < nf; ++fl) {
      const uint32_t word =
          !any ? 0u
          : kChunked ? __ldg(wp + (long long)(f0 + fl) * words_per_chunk)
                     : __ldg(packed + (long long)(f0 + fl) * n_words + w);
      // Bits where the neighbours' words differ from this lane's.
      const uint32_t d1 = word ^ __shfl_xor_sync(kFullWarp, word, 1);
      const uint32_t d2 = word ^ __shfl_xor_sync(kFullWarp, word, 2);
      long long* hf = hist + fl * slab;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int shift = j * bits;
        const int bin = (int)((word >> shift) & mask);
        const bool on = node[j] >= 0;
        const bool repeat =
            on && (bin == missing ||
                   (((same >> j) & 1) && ((d1 >> shift) & mask) == 0) ||
                   (((same >> (SPW + j)) & 1) && ((d2 >> shift) & mask) == 0));
        const unsigned hot = __ballot_sync(kFullWarp, repeat);
        const int key = on ? node[j] * max_bins + bin : -1;
        longlong2 sum = v[j];
        bool adds = on;
        if (hot & (hot - 1)) {  // two or more lanes flagged: aggregate
          const unsigned peers = __match_any_sync(kFullWarp, key);
          sum = reduce_peers(peers, v[j]);
          adds = adds && leads(peers);
        }
        if (adds) add_pair_shared(hf + key * 2, sum);
      }
    }
  }
  flush_private(hist, out, nf, slab, f0, n0, n_features, max_bins);
}

// 512 threads a block and at most 32 registers a thread, so that four
// blocks fit an SM's 65,536 registers where the plan's shared memory allows
// four.
//
// kChunked: `packed` is the chunk stack, n_words its n_chunks *
// words_per_chunk words, and a row id is global: a slot reads the words of
// its row's chunk, and a row id past the stack's padded rows reads nothing.
template <int SPW, bool kChunked>
__global__ void __launch_bounds__(512, 4) histogram_rows_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words) or the stack
    const float2* __restrict__ gh,        // (n_slots,) (g, h) of each slot
    const int* __restrict__ pos,          // (n_slots,) node, n_nodes = dump
    const int* __restrict__ rid,          // (n_slots,) row id of each slot
    long long* __restrict__ out,          // (n_nodes, n_features, max_bins, 2)
    const int* __restrict__ kexp,         // the call's exponent k
    int n_slots, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int slots_per_block,
    int chunk_rows, int words_per_chunk) {
  extern __shared__ long long hist[];  // [fl][node - n0][bin][2]
  const int f0 = blockIdx.y * feat_group;
  const int nf = min(feat_group, n_features - f0);
  const int n0 = blockIdx.z * node_tile;
  const int nn = min(node_tile, n_nodes - n0);
  const int slab = nn * max_bins * 2;
  const double scale = pow2(__ldg(kexp));
  zero_private(hist, nf * slab);

  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  const long long n_symbols =
      kChunked ? (long long)(n_words / words_per_chunk) * chunk_rows
               : (long long)n_words * SPW;
  const long long s_begin = (long long)blockIdx.x * slots_per_block;
  const long long s_end = min(s_begin + slots_per_block, (long long)n_slots);
  // The warp steps through its slots together: the votes and the match
  // below need all 32 lanes, so a lane with nothing to add carries p = -1.
  for (long long s = s_begin + threadIdx.x; s - (threadIdx.x & 31) < s_end;
       s += blockDim.x) {
    int p = s < s_end ? __ldg(pos + s) - n0 : -1;
    int r = 0;
    if (p >= 0 && p < nn) r = __ldg(rid + s);
    if (p < 0 || p >= nn || r < 0 || r >= n_symbols) p = -1;  // reads nothing
    if (!__any_sync(kFullWarp, p >= 0)) continue;
    longlong2 v = make_longlong2(0, 0);
    if (p >= 0) v = quantise_pair(__ldg(gh + s), scale);
    // Chunked: the row's chunk and its offset there; the word of feature 0.
    const uint32_t* wp = packed;
    int off = r;
    if constexpr (kChunked) {
      const int c = r / chunk_rows;
      off = r - c * chunk_rows;
      wp = packed + (long long)c * n_features * words_per_chunk;
    }
    const int w = kChunked ? off / SPW : r / SPW;
    const int shift = ((kChunked ? off : r) - w * SPW) * bits;
    const int base = p * max_bins;
    for (int fl0 = 0; fl0 < nf; fl0 += kRowsUnroll) {
      uint32_t word[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        word[u] = !(p >= 0 && fl0 + u < nf) ? 0u
                  : kChunked
                      ? __ldg(wp + (long long)(f0 + fl0 + u) * words_per_chunk + w)
                      : __ldg(packed + (long long)(f0 + fl0 + u) * n_words + w);
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        if (fl0 + u >= nf) break;
        const int bin = (int)((word[u] >> shift) & mask);
        const int key = p >= 0 ? base + bin : -1;
        // Aggregate only where the warp shows repeats: lanes in the missing
        // bin, or a lane whose (node, bin) equals a neighbour's. A match
        // costs about as much as the adds it saves on spread-out bins.
        const int k1 = __shfl_xor_sync(kFullWarp, key, 1);
        const int k2 = __shfl_xor_sync(kFullWarp, key, 2);
        const unsigned hot = __ballot_sync(
            kFullWarp, p >= 0 && (bin == missing || key == k1 || key == k2));
        longlong2 sum = v;
        bool adds = p >= 0;
        if (__popc(hot) > 1) {
          const unsigned peers = __match_any_sync(kFullWarp, key);
          sum = reduce_peers(peers, v);
          adds = adds && leads(peers);
        }
        if (adds) add_pair_shared(hist + (fl0 + u) * slab + key * 2, sum);
      }
    }
  }
  flush_private(hist, out, nf, slab, f0, n0, n_features, max_bins);
}

template <int SPW>
__global__ void histogram_global_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words)
    const float2* __restrict__ gh,        // (n_rows,) (g, h)
    const int* __restrict__ pos,          // (n_rows,) node; n_nodes, -1 = inactive
    long long* __restrict__ out,          // (n_nodes, n_features, max_bins, 2)
    const int* __restrict__ kexp,         // the call's exponent k
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits) {
  const uint32_t mask = symbol_mask(bits);
  const double scale = pow2(__ldg(kexp));
  const long long stride = (long long)gridDim.x * blockDim.x;
  // The warp steps through the words together (see histogram_rows_kernel).
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w - (threadIdx.x & 31) < n_words; w += stride) {
    int node[SPW];
    longlong2 v[SPW];
    bool any = false;
#pragma unroll
    for (int j = 0; j < SPW; ++j) {
      const long long row = w * SPW + j;
      const int p = (w < n_words && row < n_rows) ? __ldg(pos + row) : -1;
      node[j] = (p >= 0 && p < n_nodes) ? p : -1;
      v[j] = make_longlong2(0, 0);
      if (node[j] >= 0) {
        v[j] = quantise_pair(__ldg(gh + row), scale);
        any = true;
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    // Each warp starts at its own feature, so the card's warps spread their
    // adds over every feature's slab instead of queueing on one in L2.
    const int start = (int)((w >> 5) % n_features);
    for (int i = 0; i < n_features; ++i) {
      const int f = i + start < n_features ? i + start : i + start - n_features;
      const uint32_t word = any ? __ldg(packed + (long long)f * n_words + w) : 0u;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int bin = (int)((word >> (j * bits)) & mask);
        const int key = node[j] >= 0 ? node[j] * max_bins + bin : -1;
        const unsigned peers = __match_any_sync(kFullWarp, key);
        const longlong2 sum = reduce_peers(peers, v[j]);
        if (node[j] >= 0 && leads(peers))
          add_pair_global(
              out + (((long long)node[j] * n_features + f) * max_bins + bin) * 2,
              sum);
      }
    }
  }
}

// The conversion pass: out[i] = float(double(acc[i]) * 2^-k), each rounding
// to nearest even, as kernels/fixed.py::dequantise computes it; NaN
// everywhere when k is kNonFinite.
__global__ void histogram_dequantise_kernel(const long long* __restrict__ acc,
                                            const int* __restrict__ kexp,
                                            float* __restrict__ out,
                                            long long n) {
  const int k = __ldg(kexp);
  const double inv = k == kNonFinite ? 0.0 : pow2(-k);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    out[i] = k == kNonFinite ? __int_as_float(0x7fc00000)
                             : __double2float_rn(__ll2double_rn(acc[i]) * inv);
}

// Grid and dynamic shared memory of the two private kernels.
template <typename Kernel>
cudaError_t private_launch_shape(Kernel kernel, int n_items, int n_features,
                                 int n_nodes, int max_bins, int node_tile,
                                 int feat_group, int items_per_block,
                                 dim3* grid, size_t* smem) {
  *smem = (size_t)feat_group * node_tile * max_bins * 2 * sizeof(long long);
  *grid = dim3((n_items + items_per_block - 1) / items_per_block,
               (n_features + feat_group - 1) / feat_group,
               (n_nodes + node_tile - 1) / node_tile);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

using PrivateKernel = void (*)(const uint32_t*, const float2*, const int*,
                               long long*, const int*, int, int, int, int, int,
                               int, int, int, int, int, int);

// The privatised kernel's instance for a plan of `blocks_per_sm` blocks.
template <int SPW, bool kChunked = false>
PrivateKernel private_kernel(int blocks_per_sm) {
  if constexpr (SPW > 4) {
    return histogram_private_kernel<SPW, 1, kChunked>;
  } else {
    return blocks_per_sm >= 4   ? histogram_private_kernel<SPW, 4, kChunked>
           : blocks_per_sm == 3 ? histogram_private_kernel<SPW, 3, kChunked>
                                : histogram_private_kernel<SPW, 2, kChunked>;
  }
}

// chunk_rows and words_per_chunk are those of the chunk stack (kChunked),
// 0 for the flat words.
template <int SPW, bool kChunked>
cudaError_t launch_private(const void* packed, const void* gh, const void* pos,
                           void* out, const void* kexp, int n_rows,
                           int n_features, int n_words,
                           int n_nodes, int max_bins, int bits, int node_tile,
                           int feat_group, int words_per_block,
                           int blocks_per_sm, int threads, int chunk_rows,
                           int words_per_chunk, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  const PrivateKernel kernel = private_kernel<SPW, kChunked>(blocks_per_sm);
  cudaError_t err = private_launch_shape(
      kernel, n_words, n_features, n_nodes, max_bins, node_tile, feat_group,
      words_per_block, &grid, &smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos,
      (long long*)out, (const int*)kexp, n_rows, n_features, n_words, n_nodes,
      max_bins, bits, node_tile, feat_group, words_per_block, chunk_rows,
      words_per_chunk);
  return cudaGetLastError();
}

template <int SPW, bool kChunked>
cudaError_t launch_rows(const void* packed, const void* gh, const void* pos,
                        const void* rid, void* out, const void* kexp,
                        int n_slots,
                        int n_features, int n_words, int n_nodes, int max_bins,
                        int bits, int node_tile, int feat_group,
                        int slots_per_block, int threads, int chunk_rows,
                        int words_per_chunk, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  cudaError_t err = private_launch_shape(
      histogram_rows_kernel<SPW, kChunked>, n_slots, n_features, n_nodes,
      max_bins, node_tile, feat_group, slots_per_block, &grid, &smem);
  if (err != cudaSuccess) return err;
  histogram_rows_kernel<SPW, kChunked><<<grid, threads, smem, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos,
      (const int*)rid, (long long*)out, (const int*)kexp, n_slots, n_features,
      n_words, n_nodes, max_bins, bits, node_tile, feat_group, slots_per_block,
      chunk_rows, words_per_chunk);
  return cudaGetLastError();
}

template <int SPW>
cudaError_t launch_global(const void* packed, const void* gh, const void* pos,
                          void* out, const void* kexp, int n_rows,
                          int n_features, int n_words, int n_nodes,
                          int max_bins, int bits, int threads,
                          cudaStream_t stream) {
  const int blocks = (n_words + threads - 1) / threads;
  histogram_global_kernel<SPW><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)packed, (const float2*)gh, (const int*)pos,
      (long long*)out, (const int*)kexp, n_rows, n_features, n_words, n_nodes,
      max_bins, bits);
  return cudaGetLastError();
}

}  // namespace

// Symbols per word is a template argument, so the per-row unpack and the
// row -> word division are compile-time. SPW = 32 / bits for bits 1..32.
#define RT_SPW_SWITCH(bits, CALL) \
  switch (32 / (bits)) {          \
    case 1: return (int)CALL(1);  \
    case 2: return (int)CALL(2);  \
    case 3: return (int)CALL(3);  \
    case 4: return (int)CALL(4);  \
    case 5: return (int)CALL(5);  \
    case 6: return (int)CALL(6);  \
    case 8: return (int)CALL(8);  \
    case 10: return (int)CALL(10); \
    case 16: return (int)CALL(16); \
    case 32: return (int)CALL(32); \
    default: return (int)cudaErrorInvalidValue; \
  }

// chunk_rows == 0: the flat (n_features, n_words) words. chunk_rows > 0: the
// chunk stack of n_words = n_chunks * words_per_chunk words a feature row,
// read by the kernel's chunked instantiation in one launch.
#define RT_CHUNK_SWITCH(LAUNCH, S, ...)                                     \
  (chunk_rows == 0 ? LAUNCH<S, false>(__VA_ARGS__, 0, 0, (cudaStream_t)stream) \
                   : LAUNCH<S, true>(__VA_ARGS__, chunk_rows, words_per_chunk, \
                                     (cudaStream_t)stream))

// The chunk stack's shape, when there is one, is whole.
static bool chunk_args_ok(int n_words, int chunk_rows, int words_per_chunk) {
  return chunk_rows == 0 || (chunk_rows > 0 && words_per_chunk > 0 &&
                             n_words % words_per_chunk == 0);
}

// `out` is the int64 accumulator (n_nodes, n_features, max_bins, 2), added
// into; `kexp` points to the call's int32 exponent on the device.
extern "C" int rt_histogram_private(
    const void* packed, const void* gh, const void* pos, void* out,
    const void* kexp, int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int words_per_block,
    int blocks_per_sm, int threads, int chunk_rows, int words_per_chunk,
    void* stream) {
  if (!chunk_args_ok(n_words, chunk_rows, words_per_chunk))
    return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  RT_CHUNK_SWITCH(launch_private, S, packed, gh, pos, out, kexp, n_rows,    \
                  n_features, n_words, n_nodes, max_bins, bits, node_tile,  \
                  feat_group, words_per_block, blocks_per_sm, threads)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

extern "C" int rt_histogram_rows(
    const void* packed, const void* gh, const void* pos, const void* rid,
    void* out, const void* kexp, int n_slots, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int node_tile, int feat_group,
    int slots_per_block, int threads, int chunk_rows, int words_per_chunk,
    void* stream) {
  if (!chunk_args_ok(n_words, chunk_rows, words_per_chunk))
    return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  RT_CHUNK_SWITCH(launch_rows, S, packed, gh, pos, rid, out, kexp, n_slots, \
                  n_features, n_words, n_nodes, max_bins, bits, node_tile,  \
                  feat_group, slots_per_block, threads)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

extern "C" int rt_histogram_packed(
    const void* packed, const void* gh, const void* pos, void* out,
    const void* kexp, int n_rows, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int threads, void* stream) {
#define RT_CALL(S)                                                          \
  launch_global<S>(packed, gh, pos, out, kexp, n_rows, n_features, n_words, \
                   n_nodes, max_bins, bits, threads, (cudaStream_t)stream)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

// float32 out[i] from the int64 accumulator acc[i], i < n, at the exponent
// `kexp` points to: the one conversion of every histogram on the card.
extern "C" int rt_histogram_dequantise(const void* acc, const void* kexp,
                                       void* out, long long n, int threads,
                                       void* stream) {
  if (n <= 0) return 0;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 4096 ? want : 4096);
  histogram_dequantise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const long long*)acc, (const int*)kexp, (float*)out, n);
  return (int)cudaGetLastError();
}

// Resident blocks per SM of one histogram kernel (0 private, 1 row-id,
// 2 global) at `bits`, `threads` and `smem` bytes of dynamic shared memory;
// the private kernel's instance is that of a plan of `plan_blocks` blocks.
template <int SPW>
cudaError_t occupancy(int kernel, int threads, int smem, int plan_blocks,
                      int* blocks) {
  const void* fn = kernel == 0   ? (const void*)private_kernel<SPW>(plan_blocks)
                   : kernel == 1 ? (const void*)histogram_rows_kernel<SPW, false>
                                 : (const void*)histogram_global_kernel<SPW>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                       (size_t)smem);
}

extern "C" int rt_histogram_occupancy(int kernel, int bits, int threads,
                                      int smem, int plan_blocks,
                                      void* out_blocks) {
  if (kernel < 0 || kernel > 2) return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  occupancy<S>(kernel, threads, smem, plan_blocks, (int*)out_blocks)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

#undef RT_SPW_SWITCH
#undef RT_CHUNK_SWITCH

// Limits of `device`: [opt-in shared memory bytes per block, shared memory
// bytes per SM, bytes the system reserves for each block, threads per SM].
extern "C" int rt_device_limits(int device, void* out) {
  const cudaDeviceAttr attrs[4] = {cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                   cudaDevAttrReservedSharedMemoryPerBlock,
                                   cudaDevAttrMaxThreadsPerMultiProcessor};
  for (int i = 0; i < 4; ++i) {
    cudaError_t err = cudaDeviceGetAttribute((int*)out + i, attrs[i], device);
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

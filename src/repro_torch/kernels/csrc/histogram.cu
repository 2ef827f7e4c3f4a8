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
//    output block is its accumulator: no private histogram and no flush,
//    every (row, feature) adds straight into the output with global
//    atomics, which stays L2-resident at these sizes.
//  * fixed_exponent_kernel computes the call's exponent k
//    (kernels/fixed.py::exponent) and zeroes the accumulator in one launch,
//    where the wrapper ran about seven small torch launches. It replaces no
//    TPU kernel: the reference adds float32 and has no exponent.
//
// What bounds them on the H100: each full level reads the packed words once
// (n_features * n_rows * bits / 8 bytes), gh (8 B/row) and pos (4 B/row),
// and writes a small histogram: about 40 MB at 1M rows x 28 features, or
// 12 us at 3.35 TB/s. The real limit is the rate of atomic updates: one
// (g, h) pair per (row, feature), 28M per level at that size, in shared
// memory for the private and row kernels, in L2 for the global one. An
// int64 to shared memory is two native 32-bit atomics and a carry
// (add_shared_64): on sm_90a a 64-bit shared atomicAdd, like a float one, is
// a compare-and-swap loop (ATOMS.CAST.SPIN.64), a 32-bit integer one is
// native (ATOMS.ADD).
//
// The two private kernels' design:
//  * No missing-bin atomics. Every bin is an exact integer, so the missing
//    bin (max_bins - 1) of a (node, feature) is exactly T[node] minus the
//    sum of its other bins, T[node] the sum of the node's quantised rows, in
//    any order. A block never adds a symbol of the missing bin. It adds its
//    other bins, and minus their sum into the missing entry of each of its
//    (node, feature)s; and it sums node totals (one int64 pair a node, once
//    a row rather than once a (row, feature), summed first over the warp's
//    lanes at the same node; in #1 a lane first sums its run of rows at one
//    node in registers and adds the run where its node changes, which at a
//    root adds nothing until the end; the row-id kernel, held to 40
//    registers, adds slot by slot).
//    The totals are the rows' own, whatever the feature, so the G feature
//    groups of a stripe split them: the block of group g sums the passes p
//    of its loop with p % G == g (every group walks the same rows in the
//    same passes) and adds its share into the missing entry of every
//    feature. Summed over the blocks, each missing entry gets T[node] once
//    and minus every other bin once: the missing bin, bit for bit, for the
//    flat words, the chunk stack (whose padding rows count in neither term)
//    and a running out= slab alike. The totals cost a block 1/G of one more
//    feature, and on skewed data (80% of symbols missing) the design
//    removes most atomics and all of the hot ones. The private histogram
//    holds max_bins - 1 bins.
//  * Rejected, measured (tools/kernel_parts.py and its kernel_parts.cu):
//    each block summing its whole stripe's totals (as much as one more
//    feature a row: the privatised kernel at 8 nodes went from 0.16 to 0.27
//    ms back to back, at 32 nodes, one feature a block, from 0.53 to 1.14),
//    and a thread-block cluster that holds one private
//    histogram between its blocks, so that 32 nodes take one node tile and
//    more features a block, adding to a neighbour's nodes through
//    distributed shared memory: those adds compile to ATOM.E.ADD and RED on
//    the generic path, not ATOMS, and cost 2-6x the local adds on spread
//    bins (PERF.md §6).
//
// Launch plan of the private kernels (kernels/histogram.py::launch_plan): a
// block owns a stripe of words (or slots) x a group of features x a range of
// nodes, and keeps a private histogram for exactly those in dynamic shared
// memory, [feature][node][bin < max_bins - 1][g, h] int64, and its share of
// the node totals, [node][2]. The plan caps that so that a target number of
// blocks fit on an SM, and puts more node tiles and feature groups on the
// grid to make up. Every node tile walks every word of its features again,
// so node tiles are what the 16-byte bins cost. The row-id kernel: three
// 512-thread blocks an SM, about 75 KB each (with one 224 KB block of 16
// warps it took 2-2.5x its time at four 56 KB blocks). The privatised
// kernel: one 1024-thread block an SM (private_plan), up to the opt-in
// 227 KB, so that 32 nodes at 256 bins (130 KB a feature) take one node
// tile, every word read once, where two 512-thread blocks an SM took two
// tiles (0.28 against 0.43 ms back to back, PERF.md §6). Its stripes make
// four waves of blocks, or two, or one: the most at which a block's rows
// still number at least twice the bins it flushes.
//
// histogram_private_kernel: consecutive threads take consecutive words of a
// feature, so word loads coalesce along W, and the warp steps through its
// words together (a lane past the stripe's end carries no rows), so that
// the votes below have all 32 lanes. A thread unpacks SPW symbols per word
// and keeps the SPW rows' quantised (g, h) and node in registers across the
// feature group; rows with a position outside the tile (n_nodes or -1 =
// inactive) are skipped, and a word whose rows are all skipped loads
// nothing. The key of the j-th symbol of a lane's word is its (node, bin).
// Where the warp shows repeats at symbol j (a lane whose key equals its
// xor-1 or xor-2 neighbour's, which catches a constant feature), lanes with
// equal keys are summed with __match_any_sync and a shuffle tree, and one
// lane adds the sum; where it shows none the match is skipped. The
// neighbours' nodes are compared once per word and their symbols with one
// shuffle of the word per feature.
//
// histogram_rows_kernel: a thread takes one slot, and for each feature of
// the group one word packed[f, rid / SPW], shifted by (rid % SPW) * bits.
// The words of kRowsUnroll features are loaded before any of them is used,
// so a slot keeps several scattered loads in flight; repeats are aggregated
// as in the privatised kernel. A slot at the dump position, or with a row
// id outside the packed words, contributes nothing and reads nothing past
// its position. The buffer keeps row order, so neighbouring slots often
// share a word.
//
// Both private kernels flush the non-zero entries of their histogram to the
// int64 accumulator with 64-bit integer global atomicAdd at the end, a warp
// a (feature, node) whose lanes also sum the bins for the missing entry,
// and their share of the node totals into every feature's missing entry.
// The wrapper zeroes the accumulator in the exponent kernel's launch (or
// hands a running one: the streamed pass adds chunk after chunk into one,
// at one exponent).
//
// histogram_global_kernel: a thread takes one word and its SPW rows, and
// the whole warp walks the features in step, so the lanes of a warp always
// add into one feature's output slab; each warp starts at its own feature,
// so the card's warps spread over all the slabs instead of all starting on
// feature 0's few L2 lines. Per symbol, lanes whose (node, bin) agree are
// summed with __match_any_sync and a shuffle tree, and one lane adds the
// warp's sum with two 64-bit integer global atomicAdds.
//
// fixed_exponent_kernel: one cluster of 8 blocks (the portable size, which
// every card places without a per-device attribute) of 1024 threads reads
// gh once, 8 bytes a row, keeping the
// largest |g| or |h| as the bits of a non-negative float (which order as
// unsigned integers; inf and NaN above every finite value), reduces it over
// each warp, block and, through distributed shared memory, the cluster,
// and block 0 turns it into k with frexp's exponent taken from the bits.
// The same blocks zero the accumulator meanwhile. No global scratch and no
// second launch: the cluster is the whole grid.
//
// Summation order is not fixed from run to run in any of the kernels; the
// integer sums do not depend on it. A non-finite (g, h) in a call gives the
// exponent kNonFinite: every row quantises to 0 and the conversion writes
// NaN everywhere.
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

#include <algorithm>
#include <vector>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRowsUnroll = 4;  // features whose words a slot loads at once
// The exponent of a call whose (g, h) holds inf or NaN, and the bounds of k
// (kernels/fixed.py: NONFINITE, K_MIN, K_MAX, SUM_BITS).
constexpr int kNonFinite = -2147483647 - 1;
constexpr int kMinExponent = -1022, kMaxExponent = 1022, kSumBits = 62;
constexpr int kExponentThreads = 1024;
constexpr int kExponentBlocks = 8;  // the exponent kernel's one cluster

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

// True in the lane that adds its group's sum: the lowest lane of `peers`.
__device__ __forceinline__ bool leads(unsigned peers) {
  return (peers & ((1u << (threadIdx.x & 31)) - 1u)) == 0;
}

__device__ __forceinline__ uint32_t symbol_mask(int bits) {
  return bits >= 32 ? 0xffffffffu : ((1u << bits) - 1u);
}

// --- the cluster -----------------------------------------------------------

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

// Every thread of every block of the cluster arrives before any goes on, and
// what they wrote to shared memory is visible to the others.
__device__ __forceinline__ void sync_cluster() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ uint32_t shared_address(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The address of the same offset as `addr` in the shared memory of block
// `rank` of the cluster (a shared::cluster address).
__device__ __forceinline__ uint32_t in_block(uint32_t addr, unsigned rank) {
  uint32_t out;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// Adds v to the int64 in shared memory at `slot` with two native 32-bit
// atomicAdds (ATOMS.ADD), the low word's carry going into the high word
// (upstream XGBoost's AtomicAdd64As32): on sm_90a a 64-bit shared atomicAdd
// compiles to a compare-and-swap loop (ATOMS.CAST.SPIN.64). Each wrap of the
// low word happens in exactly one add, which carries, so the int64 ends
// exact (mod 2^64, two's complement: the signed sum) in any order.
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

// --- the private histogram -------------------------------------------------

// A block's private histogram [fl][node - n0][bin < max_bins - 1][2] int64
// at the start of its dynamic shared memory, then its share of its stripe's
// node totals [node - n0][2] (offsets into it, so that no pointer takes
// registers across the loops).
struct Private {
  int f0, nf;        // the block's features
  int n0, nn;        // its nodes
  int bins;          // bins a (feature, node) holds: max_bins - 1
  int part;          // where the share of the node totals starts
};

__device__ __forceinline__ Private private_histogram(long long* smem,
                                                     int node_tile,
                                                     int feat_group,
                                                     int n_nodes,
                                                     int n_features,
                                                     int max_bins) {
  Private p;
  p.f0 = blockIdx.y * feat_group;
  p.nf = min(feat_group, n_features - p.f0);
  p.n0 = blockIdx.z * node_tile;
  p.nn = min(node_tile, n_nodes - p.n0);
  p.bins = max_bins - 1;
  p.part = p.nf * p.nn * p.bins * 2;
  for (int i = threadIdx.x; i < p.part + p.nn * 2; i += blockDim.x) smem[i] = 0;
  __syncthreads();
  return p;
}

// A lane's run of rows at one node of the tile: their quantised (g, h) sum.
struct Run {
  int node;  // -1: none yet
  longlong2 sum;
};

// Ends the runs of the lanes where `ends`: each run's sum is added to the
// block's share of the node totals, summed first over the warp's lanes that
// end a run at the same node. Every lane of the warp calls it.
__device__ __forceinline__ void end_runs(bool ends, const Run& run, long long* part) {
  const unsigned who = __ballot_sync(kFullWarp, ends);
  if (who == 0) return;
  longlong2 sum = run.sum;
  bool adds = ends;
  if (who & (who - 1)) {
    const unsigned peers = __match_any_sync(kFullWarp, ends ? run.node : -1);
    sum = reduce_peers(peers, run.sum);
    adds = ends && leads(peers);
  }
  if (adds) add_pair_shared(part + run.node * 2, sum);
}

// Adds one row (tile-local node, quantised (g, h); node -1: none) to the
// lane's run, ending the run first where the node changes. Every lane of
// the warp calls it.
__device__ __forceinline__ void add_to_run(Run& run, int node, longlong2 v,
                                           long long* part) {
  end_runs(node >= 0 && run.node >= 0 && node != run.node, run, part);
  if (node >= 0) {
    if (node == run.node) {
      run.sum.x += v.x;
      run.sum.y += v.y;
    } else {
      run.node = node;
      run.sum = v;
    }
  }
}

// Ends every lane's run and adds into the int64 accumulator: the block's
// share of the node totals into the missing bin of every feature; its
// histogram, a warp a (feature, node) whose lanes add the non-zero bins and
// sum them; and minus that sum into the (feature, node)'s missing bin.
__device__ __forceinline__ void flush_private(const Private& p, const Run& run,
                                              long long* smem, long long* out,
                                              int n_features, int max_bins) {
  end_runs(run.node >= 0, run, smem + p.part);
  __syncthreads();
  unsigned long long* acc = reinterpret_cast<unsigned long long*>(out);
  const int missing = (max_bins - 1) * 2;
  for (int i = threadIdx.x; i < p.nn * n_features * 2; i += blockDim.x) {
    const int node = i / (n_features * 2);
    const int rem = i - node * n_features * 2;  // f * 2 + (0 for g, 1 for h)
    const long long v = smem[p.part + node * 2 + (rem & 1)];
    if (v != 0)
      atomicAdd(acc + ((long long)(p.n0 + node) * n_features + (rem >> 1)) * max_bins * 2 +
                    missing + (rem & 1),
                (unsigned long long)v);
  }
  const int lane = threadIdx.x & 31;
  const int entries = p.bins * 2;
  for (int u = threadIdx.x >> 5; u < p.nf * p.nn; u += blockDim.x >> 5) {
    const long long* h = smem + u * entries;  // u = fl * nn + node
    const int fl = u / p.nn;
    const int node = u - fl * p.nn;
    unsigned long long* o =
        acc + ((long long)(p.n0 + node) * n_features + p.f0 + fl) * max_bins * 2;
    unsigned long long s = 0;  // this lane's bins of one component (its parity)
    for (int e = lane; e < entries; e += 32) {
      const unsigned long long v = (unsigned long long)h[e];
      s += v;
      if (v != 0) atomicAdd(o + e, v);
    }
    for (int d = 16; d >= 2; d >>= 1) s += __shfl_xor_sync(kFullWarp, s, d);
    if (lane < 2 && s != 0) atomicAdd(o + missing + lane, 0ull - s);
  }
}

// With up to four symbols a word (8 bits and wider), up to 1024 threads a
// block at 64 registers a thread (MAX_THREADS 1024): one block fills an
// SM's 65,536 registers with as many warps as two 512-thread blocks, and
// may hold the SM's whole shared memory (kernels/histogram.py ::
// private_plan). The fixed-point body spills 218 / 278 B at 40 / 32
// registers, and 64 beat 40 at 32 nodes (0.42 against 0.57 ms back to
// back, PERF.md §6). More symbols a word take 512 threads a block and what
// registers they need (MAX_THREADS 512).
//
// kChunked: `packed` is the chunk stack and n_words its n_chunks *
// words_per_chunk words, walked as one range.
template <int SPW, int MAX_THREADS, bool kChunked>
__global__ void __launch_bounds__(MAX_THREADS, 1) histogram_private_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words) or the stack
    const float2* __restrict__ gh,        // (n_rows,) (g, h)
    const int* __restrict__ pos,          // (n_rows,) node, n_nodes = inactive
    long long* __restrict__ out,          // (n_nodes, n_features, max_bins, 2)
    const int* __restrict__ kexp,         // the call's exponent k
    int n_rows, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int words_per_block,
    int chunk_rows, int words_per_chunk) {
  extern __shared__ long long smem[];
  const Private p = private_histogram(smem, node_tile, feat_group, n_nodes,
                                      n_features, max_bins);
  const double scale = pow2(__ldg(kexp));
  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  Run run{-1, make_longlong2(0, 0)};
  const long long w_begin = (long long)blockIdx.x * words_per_block;
  const long long w_end = min(w_begin + words_per_block, (long long)n_words);
  // A pass of the loop covers the same words in every feature group of the
  // stripe: this block sums the node totals of every G-th pass, from pass
  // blockIdx.y on (`wait` passes to go).
  unsigned wait = blockIdx.y;
  for (long long w = w_begin + threadIdx.x; w - (threadIdx.x & 31) < w_end;
       w += blockDim.x, wait = wait == 0 ? gridDim.y - 1 : wait - 1) {
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
      const int q = (w < w_end && row < (kChunked ? row_end : n_rows))
                        ? __ldg(pos + row) - p.n0 : -1;
      node[j] = (q >= 0 && q < p.nn) ? q : -1;
      v[j] = make_longlong2(0, 0);
      if (node[j] >= 0) {
        v[j] = quantise_pair(__ldg(gh + row), scale);
        any = true;
      }
    }
    if (!__any_sync(kFullWarp, any)) continue;
    if (wait == 0) {
#pragma unroll
      for (int j = 0; j < SPW; ++j) add_to_run(run, node[j], v[j], smem + p.part);
    }
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
    for (int fl = 0; fl < p.nf; ++fl) {
      const uint32_t word =
          !any ? 0u
          : kChunked ? __ldg(wp + (long long)(p.f0 + fl) * words_per_chunk)
                     : __ldg(packed + (long long)(p.f0 + fl) * n_words + w);
      // Bits where the neighbours' words differ from this lane's.
      const uint32_t d1 = word ^ __shfl_xor_sync(kFullWarp, word, 1);
      const uint32_t d2 = word ^ __shfl_xor_sync(kFullWarp, word, 2);
      long long* hf = smem + fl * p.nn * p.bins * 2;
#pragma unroll
      for (int j = 0; j < SPW; ++j) {
        const int shift = j * bits;
        const int bin = (int)((word >> shift) & mask);
        const bool on = node[j] >= 0 && bin < missing;
        const bool repeat =
            on && ((((same >> j) & 1) && ((d1 >> shift) & mask) == 0) ||
                   (((same >> (SPW + j)) & 1) && ((d2 >> shift) & mask) == 0));
        const unsigned hot = __ballot_sync(kFullWarp, repeat);
        longlong2 sum = v[j];
        bool adds = on;
        if (hot & (hot - 1)) {  // two or more lanes flagged: aggregate
          const unsigned peers =
              __match_any_sync(kFullWarp, on ? node[j] * max_bins + bin : -1);
          sum = reduce_peers(peers, v[j]);
          adds = adds && leads(peers);
        }
        if (adds) add_pair_shared(hf + (node[j] * p.bins + bin) * 2, sum);
      }
    }
  }
  flush_private(p, run, smem, out, n_features, max_bins);
}

// 512 threads a block and at most 40 registers a thread (MIN_BLOCKS 3), so
// that three blocks fit an SM's 65,536 registers where the plan's shared
// memory allows three; the body spills nothing at 40 (its chunked
// instantiation 16 B). At 64 registers (two blocks) it took 0.21 ms back to
// back at 16 parents where this took 0.17 (PERF.md §6).
//
// kChunked: `packed` is the chunk stack, n_words its n_chunks *
// words_per_chunk words, and a row id is global: a slot reads the words of
// its row's chunk, and a row id past the stack's padded rows reads nothing.
template <int SPW, bool kChunked>
__global__ void __launch_bounds__(512, 3) histogram_rows_kernel(
    const uint32_t* __restrict__ packed,  // (n_features, n_words) or the stack
    const float2* __restrict__ gh,        // (n_slots,) (g, h) of each slot
    const int* __restrict__ pos,          // (n_slots,) node, n_nodes = dump
    const int* __restrict__ rid,          // (n_slots,) row id of each slot
    long long* __restrict__ out,          // (n_nodes, n_features, max_bins, 2)
    const int* __restrict__ kexp,         // the call's exponent k
    int n_slots, int n_features, int n_words, int n_nodes, int max_bins,
    int bits, int node_tile, int feat_group, int slots_per_block,
    int chunk_rows, int words_per_chunk) {
  extern __shared__ long long smem[];
  const Private p = private_histogram(smem, node_tile, feat_group, n_nodes,
                                      n_features, max_bins);
  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  const long long n_symbols =
      kChunked ? (long long)(n_words / words_per_chunk) * chunk_rows
               : (long long)n_words * SPW;
  // Slot indices are int (rt_histogram_rows bounds n_slots): 40 registers
  // hold no 64-bit loop counter without spilling.
  const int s_begin = blockIdx.x * slots_per_block;
  const int s_end = min(s_begin + slots_per_block, n_slots);
  // The warp steps through its slots together: the votes and the match
  // below need all 32 lanes, so a lane with nothing to add carries q = -1.
  // This block sums the node totals of every G-th pass, as in
  // histogram_private_kernel, but slot by slot (warp-aggregated, no run
  // kept in registers).
  unsigned wait = blockIdx.y;
  for (int s = s_begin + threadIdx.x; s - (int)(threadIdx.x & 31) < s_end;
       s += blockDim.x, wait = wait == 0 ? gridDim.y - 1 : wait - 1) {
    int q = s < s_end ? __ldg(pos + s) - p.n0 : -1;
    int r = 0;
    if (q >= 0 && q < p.nn) r = __ldg(rid + s);
    if (q < 0 || q >= p.nn || r < 0 || r >= n_symbols) q = -1;  // reads nothing
    if (!__any_sync(kFullWarp, q >= 0)) continue;
    longlong2 v = make_longlong2(0, 0);
    // The scale is read again each pass: held across the loop it would
    // take two of the 40 registers.
    if (q >= 0) v = quantise_pair(__ldg(gh + s), pow2(__ldg(kexp)));
    if (wait == 0) end_runs(q >= 0, Run{q, v}, smem + p.part);
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
    const int hq = (q >= 0 ? q : 0) * p.bins * 2;  // feature 0's node q in smem
    for (int fl0 = 0; fl0 < p.nf; fl0 += kRowsUnroll) {
      uint32_t word[kRowsUnroll];
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u)
        word[u] = !(q >= 0 && fl0 + u < p.nf) ? 0u
                  : kChunked
                      ? __ldg(wp + (long long)(p.f0 + fl0 + u) * words_per_chunk + w)
                      : __ldg(packed + (long long)(p.f0 + fl0 + u) * n_words + w);
#pragma unroll
      for (int u = 0; u < kRowsUnroll; ++u) {
        if (fl0 + u >= p.nf) break;
        const int bin = (int)((word[u] >> shift) & mask);
        const bool on = q >= 0 && bin < missing;
        const int key = on ? q * max_bins + bin : -1;
        // Aggregate only where the warp shows repeats: a lane whose (node,
        // bin) equals a neighbour's. A match costs about as much as the
        // adds it saves on spread-out bins.
        const int k1 = __shfl_xor_sync(kFullWarp, key, 1);
        const int k2 = __shfl_xor_sync(kFullWarp, key, 2);
        const unsigned hot =
            __ballot_sync(kFullWarp, on && (key == k1 || key == k2));
        longlong2 sum = v;
        bool adds = on;
        if (__popc(hot) > 1) {
          const unsigned peers = __match_any_sync(kFullWarp, key);
          sum = reduce_peers(peers, v);
          adds = adds && leads(peers);
        }
        if (adds)
          add_pair_shared(smem + hq + ((fl0 + u) * p.nn * p.bins + bin) * 2, sum);
      }
    }
  }
  flush_private(p, Run{-1, make_longlong2(0, 0)}, smem, out, n_features, max_bins);
}


// frexp's exponent of the largest |g| or |h| (`top`, the bits of a
// non-negative float32) turned into the call's k for n rows, as
// kernels/fixed.py::exponent_from_max computes it.
__device__ __forceinline__ int exponent_of(unsigned top, long long n) {
  if (top >= 0x7f800000u) return kNonFinite;  // inf or NaN
  const int e = top == 0 ? 0
                : top < 0x00800000u ? (32 - __clz(top)) - 149  // subnormal
                                    : (int)(top >> 23) - 126;
  const int log2n = n > 1 ? 64 - __clzll(n - 1) : 0;
  return min(max(kSumBits - log2n - e, kMinExponent), kMaxExponent);
}

// The whole grid is one cluster (see the header): k into *kexp, and the
// n_acc int64 of acc zeroed.
__global__ void __launch_bounds__(kExponentThreads) fixed_exponent_kernel(
    const uint2* __restrict__ gh,  // (n_rows,) (g, h) as bits
    int n_rows, int* __restrict__ kexp, long long* __restrict__ acc,
    long long n_acc) {
  __shared__ unsigned warp_top[32];
  const unsigned blocks = cluster_blocks();
  const unsigned rank = cluster_rank();
  const long long stride = (long long)blocks * blockDim.x;
  const long long first = (long long)rank * blockDim.x + threadIdx.x;
  for (long long i = first; i < n_acc; i += stride) acc[i] = 0;
  unsigned top = 0;
#pragma unroll 8
  for (long long i = first; i < n_rows; i += stride) {
    const uint2 v = __ldg(gh + i);
    top = max(top, max(v.x & 0x7fffffffu, v.y & 0x7fffffffu));
  }
  top = __reduce_max_sync(kFullWarp, top);
  if ((threadIdx.x & 31) == 0) warp_top[threadIdx.x >> 5] = top;
  __syncthreads();
  if (threadIdx.x < 32) {
    top = threadIdx.x < (blockDim.x >> 5) ? warp_top[threadIdx.x] : 0u;
    top = __reduce_max_sync(kFullWarp, top);
    if (threadIdx.x == 0) warp_top[0] = top;
  }
  sync_cluster();
  if (rank == 0 && threadIdx.x == 0) {
    for (unsigned r = 1; r < blocks; ++r) {
      unsigned other;
      asm volatile("ld.shared::cluster.u32 %0, [%1];"
                   : "=r"(other) : "r"(in_block(shared_address(warp_top), r))
                   : "memory");
      top = max(top, other);
    }
    *kexp = exponent_of(top, n_rows);
  }
  sync_cluster();  // no block leaves while block 0 reads its shared memory
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


// Grid and dynamic shared memory of the two private kernels: a block's
// histogram of max_bins - 1 bins a feature and node, and its share of the
// node totals (kernels/histogram.py :: private_bytes).
template <typename Kernel>
cudaError_t private_launch_shape(Kernel kernel, int n_items, int n_features,
                                 int n_nodes, int max_bins, int node_tile,
                                 int feat_group, int items_per_block,
                                 dim3* grid, size_t* smem) {
  if (node_tile < 1 || feat_group < 1 || items_per_block < 1 || max_bins < 1)
    return cudaErrorInvalidValue;
  *smem = ((size_t)feat_group * node_tile * (max_bins - 1) + node_tile) * 16;
  *grid = dim3((n_items + items_per_block - 1) / items_per_block,
               (n_features + feat_group - 1) / feat_group,
               (n_nodes + node_tile - 1) / node_tile);
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

using PrivateKernel = void (*)(const uint32_t*, const float2*, const int*,
                               long long*, const int*, int, int, int, int, int,
                               int, int, int, int, int, int);

// The privatised kernel's instance for SPW symbols a word.
template <int SPW, bool kChunked = false>
constexpr PrivateKernel private_kernel() {
  return histogram_private_kernel<SPW, (SPW > 4 ? 512 : 1024), kChunked>;
}

// chunk_rows and words_per_chunk are those of the chunk stack (kChunked),
// 0 for the flat words.
template <int SPW, bool kChunked>
cudaError_t launch_private(const void* packed, const void* gh, const void* pos,
                           void* out, const void* kexp, int n_rows,
                           int n_features, int n_words,
                           int n_nodes, int max_bins, int bits, int node_tile,
                           int feat_group, int words_per_block,
                           int threads, int chunk_rows,
                           int words_per_chunk, cudaStream_t stream) {
  dim3 grid;
  size_t smem;
  const PrivateKernel kernel = private_kernel<SPW, kChunked>();
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

// --- which kernel a graph node launches ------------------------------------

// `func`, a captured kernel node's function, is `kernel`: the runtime gives
// a node's function as the kernel's host symbol or as its device function.
bool is_kernel(const void* func, const void* kernel) {
  if (func == kernel) return true;
  cudaFunction_t device_fn = nullptr;
  return cudaGetFuncBySymbol(&device_fn, kernel) == cudaSuccess &&
         (const void*)device_fn == func;
}

// 1 histogram_private_kernel, 2 histogram_rows_kernel, 3
// histogram_global_kernel (any instance for SPW symbols a word), else -1.
template <int SPW>
int histogram_code(const void* func) {
  if (is_kernel(func, (const void*)private_kernel<SPW, false>()) ||
      is_kernel(func, (const void*)private_kernel<SPW, true>()))
    return 1;
  if (is_kernel(func, (const void*)histogram_rows_kernel<SPW, false>) ||
      is_kernel(func, (const void*)histogram_rows_kernel<SPW, true>))
    return 2;
  return is_kernel(func, (const void*)histogram_global_kernel<SPW>) ? 3 : -1;
}

// 0 the exponent kernel, 1-3 the histogram kernels, 4 the conversion pass,
// -1 a kernel not of this file.
int kernel_code(const void* func) {
  if (is_kernel(func, (const void*)fixed_exponent_kernel)) return 0;
  if (is_kernel(func, (const void*)histogram_dequantise_kernel)) return 4;
  const int codes[] = {histogram_code<1>(func),  histogram_code<2>(func),
                       histogram_code<3>(func),  histogram_code<4>(func),
                       histogram_code<5>(func),  histogram_code<6>(func),
                       histogram_code<8>(func),  histogram_code<10>(func),
                       histogram_code<16>(func), histogram_code<32>(func)};
  for (int c : codes)
    if (c >= 0) return c;
  return -1;
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
    const void* kexp, int n_rows, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int node_tile, int feat_group, int words_per_block,
    int threads, int chunk_rows, int words_per_chunk,
    void* stream) {
  if (!chunk_args_ok(n_words, chunk_rows, words_per_chunk))
    return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  RT_CHUNK_SWITCH(launch_private, S, packed, gh, pos, out, kexp, n_rows,    \
                  n_features, n_words, n_nodes, max_bins, bits, node_tile,  \
                  feat_group, words_per_block, threads)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

extern "C" int rt_histogram_rows(
    const void* packed, const void* gh, const void* pos, const void* rid,
    void* out, const void* kexp, int n_slots, int n_features, int n_words,
    int n_nodes, int max_bins, int bits, int node_tile, int feat_group,
    int slots_per_block, int threads, int chunk_rows, int words_per_chunk,
    void* stream) {
  if (!chunk_args_ok(n_words, chunk_rows, words_per_chunk) ||
      n_slots > 2147483647 - slots_per_block - threads)  // int slot indices
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

// The call's exponent of the (n_rows, 2) float32 `gh` (8-byte aligned) into
// the int32 at `kexp`, and the n_acc int64 at `acc` zeroed (none when
// n_acc is 0), in one launch of one cluster.
extern "C" int rt_fixed_exponent(const void* gh, int n_rows, void* kexp,
                                 void* acc, long long n_acc, void* stream) {
  if (n_rows < 0 || n_acc < 0) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kExponentBlocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(kExponentBlocks);
  cfg.blockDim = dim3(kExponentThreads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, fixed_exponent_kernel,
                                       (const uint2*)gh, n_rows, (int*)kexp,
                                       (long long*)acc, n_acc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
// 2 global) at `bits`, `threads` and `smem` bytes of dynamic shared memory.
template <int SPW>
cudaError_t occupancy(int kernel, int threads, int smem, int* blocks) {
  const void* fn = kernel == 0   ? (const void*)private_kernel<SPW>()
                   : kernel == 1 ? (const void*)histogram_rows_kernel<SPW, false>
                                 : (const void*)histogram_global_kernel<SPW>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, threads,
                                                       (size_t)smem);
}

extern "C" int rt_histogram_occupancy(int kernel, int bits, int threads,
                                      int smem, void* out_blocks) {
  if (kernel < 0 || kernel > 2) return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  occupancy<S>(kernel, threads, smem, (int*)out_blocks)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

#undef RT_SPW_SWITCH
#undef RT_CHUNK_SWITCH

// Counting a call's launches on the device's own record: the caller begins
// a capture of its stream (relaxed, so that its allocator may still call
// cudaMalloc), makes the call, and ends the capture, which is destroyed
// unlaunched: nothing of the call runs.
extern "C" int rt_capture_begin(void* stream) {
  return (int)cudaStreamBeginCapture((cudaStream_t)stream,
                                     cudaStreamCaptureModeRelaxed);
}

// Ends the capture of `stream`; writes each node's kernel_code, or -2 for a
// node that launches no kernel (a copy, a memset, an event), in launch order
// (by depth in the graph) into codes[0 .. max_codes), and the node count
// into *n_nodes.
extern "C" int rt_capture_kernels(void* stream, void* codes, int max_codes,
                                  void* n_nodes) {
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamEndCapture((cudaStream_t)stream, &graph);
  if (err != cudaSuccess) return (int)err;
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (err == cudaSuccess && n > 0) err = cudaGraphGetNodes(graph, nodes.data(), &n);
  std::vector<int> depth(n, 0);
  for (size_t pass = 0; err == cudaSuccess && pass < n; ++pass)
    for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
      size_t n_deps = 0;
      err = cudaGraphNodeGetDependencies(nodes[i], nullptr, &n_deps);
      std::vector<cudaGraphNode_t> deps(n_deps);
      if (err == cudaSuccess && n_deps > 0)
        err = cudaGraphNodeGetDependencies(nodes[i], deps.data(), &n_deps);
      for (cudaGraphNode_t d : deps) {
        const size_t j = std::find(nodes.begin(), nodes.end(), d) - nodes.begin();
        if (j < n) depth[i] = std::max(depth[i], depth[j] + 1);
      }
    }
  std::vector<size_t> order(n);
  for (size_t i = 0; i < n; ++i) order[i] = i;
  std::stable_sort(order.begin(), order.end(),
                   [&](size_t a, size_t b) { return depth[a] < depth[b]; });
  for (size_t r = 0; r < n && err == cudaSuccess && (int)r < max_codes; ++r) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[order[r]], &type);
    int code = -2;
    if (err == cudaSuccess && type == cudaGraphNodeTypeKernel) {
      cudaKernelNodeParams params = {};
      code = cudaGraphKernelNodeGetParams(nodes[order[r]], &params) == cudaSuccess
                 ? kernel_code(params.func)
                 : -1;
      cudaGetLastError();  // a node this runtime cannot read is another's kernel
    }
    ((int*)codes)[r] = code;
  }
  *(int*)n_nodes = (int)n;
  const cudaError_t destroyed = cudaGraphDestroy(graph);
  return (int)(err != cudaSuccess ? err : destroyed);
}


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

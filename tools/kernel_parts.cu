// Measurement only, for tools/kernel_parts.py: a design of the two private
// histogram kernels of src/repro_torch/kernels/csrc/histogram.cu that the
// port does not ship, kept so that its times can be taken again beside the
// shipped kernels. Nothing of the port includes or launches this file.
//
// The design: the private histogram of a node tile spans a thread-block
// cluster of C blocks (consecutive along x, C a power of two up to 8):
// tile-local node p lives in block p % C, every block reads its own stripe
// of rows once and adds each (row, feature) into the block that holds the
// row's node, through distributed shared memory where that is a
// neighbour's (mapa, then atom/red.shared::cluster.add.u32, which compile
// to ATOM.E.ADD and RED on the generic path, not ATOMS). Each block keeps
// its rows' node totals (each lane summing its run of rows at one node and
// adding the run, warp-aggregated, where the node changes); the cluster
// sums them in the owners' shared memory, and each block flushes its own
// nodes with the missing bin as the total less the other bins. The plan is
// kernel_parts.py's `cluster_plan`. The chunk stack and the exponent are
// as in the shipped kernels; the exponent comes from the library.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kRowsUnroll = 4;  // features whose words a slot loads at once
// The exponent of a call whose (g, h) holds inf or NaN (kernels/fixed.py).
constexpr int kNonFinite = -2147483647 - 1;
constexpr int kMaxCluster = 8;  // blocks of a private kernel's cluster (portable)

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
// what they wrote to shared memory (their own or a neighbour's) is visible;
// a __syncthreads() when the launch has no cluster.
__device__ __forceinline__ void sync_cluster(unsigned blocks) {
  if (blocks > 1) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
                 "barrier.cluster.wait.acquire.aligned;" ::: "memory");
  } else {
    __syncthreads();
  }
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

// Native 32-bit integer atomics on shared memory: this block's (kRemote
// false, a shared::cta address) or a neighbour's (a shared::cluster one).
template <bool kRemote>
__device__ __forceinline__ unsigned atom_add_u32(uint32_t addr, unsigned v) {
  unsigned old;
  if constexpr (kRemote) {
    asm volatile("atom.shared::cluster.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "r"(addr), "r"(v) : "memory");
  } else {
    asm volatile("atom.shared.add.u32 %0, [%1], %2;"
                 : "=r"(old) : "r"(addr), "r"(v) : "memory");
  }
  return old;
}

template <bool kRemote>
__device__ __forceinline__ void red_add_u32(uint32_t addr, unsigned v) {
  if constexpr (kRemote) {
    asm volatile("red.shared::cluster.add.u32 [%0], %1;" :: "r"(addr), "r"(v)
                 : "memory");
  } else {
    asm volatile("red.shared.add.u32 [%0], %1;" :: "r"(addr), "r"(v) : "memory");
  }
}

// Adds v to the int64 in shared memory at `addr` with two native 32-bit
// atomic adds, the low word's carry going into the high word (upstream
// XGBoost's AtomicAdd64As32). Each wrap of the low word happens in exactly
// one add, which carries, so the int64 ends exact (mod 2^64, two's
// complement: the signed sum) in any order. A zero word is not added.
template <bool kRemote>
__device__ __forceinline__ void add_shared_64(uint32_t addr, long long v) {
  const unsigned x_lo = (unsigned)v;
  unsigned hi = (unsigned)((unsigned long long)v >> 32);
  if (x_lo != 0) {
    const unsigned old = atom_add_u32<kRemote>(addr, x_lo);
    hi += old > 0xffffffffu - x_lo ? 1u : 0u;
  }
  if (hi != 0) red_add_u32<kRemote>(addr + 4, hi);
}

// Adds the quantised (g, h) to the 16-byte slot at byte address `addr` of
// block `owner`'s shared memory (this block's where owner == rank).
__device__ __forceinline__ void add_pair(uint32_t addr, unsigned owner,
                                         unsigned rank, longlong2 v) {
  if (owner == rank) {
    add_shared_64<false>(addr, v.x);
    add_shared_64<false>(addr + 8, v.y);
  } else {
    const uint32_t a = in_block(addr, owner);
    add_shared_64<true>(a, v.x);
    add_shared_64<true>(a + 8, v.y);
  }
}

// --- the private histogram -------------------------------------------------

// A block's share of its cluster's private histogram: the cluster's C
// blocks hold one tile of nodes x features between them, tile-local node p
// in block p % C at index p / C.
struct Private {
  int f0, nf;          // the tile's features
  int n0, nn;          // the tile's nodes
  int bins;            // bins a (feature, node) holds: max_bins - 1
  int npr;             // nodes a block of the cluster holds
  unsigned rank;       // this block's rank in the cluster
  unsigned shift;      // log2 C
  long long* rows_total;  // [p][2]: this block's rows' sum at each node
  long long* total;       // [p / C][2]: the cluster's rows' sum at its nodes
  uint32_t base;       // shared address of [fl][p / C][bin][2]
  int fstride;         // bytes of one feature's nodes
};

// The layout of a block's dynamic shared memory, zeroed, the cluster
// synchronised: no block adds to a neighbour before the neighbour zeroed.
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
  const unsigned blocks = cluster_blocks();
  p.rank = cluster_rank();
  p.shift = __ffs(blocks) - 1;
  p.npr = (node_tile + blocks - 1) >> p.shift;
  p.bins = max_bins - 1;
  const int hist = p.nf * p.npr * p.bins * 2;
  p.rows_total = smem + hist;
  p.total = p.rows_total + node_tile * 2;
  p.base = shared_address(smem);
  p.fstride = p.npr * p.bins * 16;
  for (int i = threadIdx.x; i < hist + (node_tile + p.npr) * 2; i += blockDim.x)
    smem[i] = 0;
  sync_cluster(blocks);
  return p;
}

// A lane's run of rows at one node of the tile: their quantised (g, h) sum.
struct Run {
  int node;  // -1: none yet
  longlong2 sum;
};

// Ends the runs of the lanes where `ends`: each run's sum is added to this
// block's total at its node, summed first over the warp's lanes that end a
// run at the same node. Every lane of the warp calls it.
__device__ __forceinline__ void end_runs(bool ends, const Run& run,
                                         long long* rows_total) {
  const unsigned who = __ballot_sync(kFullWarp, ends);
  if (who == 0) return;
  longlong2 sum = run.sum;
  bool adds = ends;
  if (who & (who - 1)) {
    const unsigned peers = __match_any_sync(kFullWarp, ends ? run.node : -1);
    sum = reduce_peers(peers, run.sum);
    adds = ends && leads(peers);
  }
  if (adds) {
    const uint32_t a = shared_address(rows_total + run.node * 2);
    add_shared_64<false>(a, sum.x);
    add_shared_64<false>(a + 8, sum.y);
  }
}

// Adds one row (tile-local node, quantised (g, h); node -1: none) to the
// lane's run, ending the run first where the node changes. Every lane of
// the warp calls it.
__device__ __forceinline__ void add_to_run(Run& run, int node, longlong2 v,
                                           long long* rows_total) {
  end_runs(node >= 0 && run.node >= 0 && node != run.node, run, rows_total);
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

// Ends every lane's run, sums the cluster's node totals in their owners'
// shared memory, and adds each block's own nodes into the int64
// accumulator: a warp a (feature, node), its lanes adding the non-zero bins
// and summing them, then T[node] - that sum into the missing bin.
__device__ __forceinline__ void flush_private(const Private& p, const Run& run,
                                              long long* out, int n_features,
                                              int max_bins) {
  end_runs(run.node >= 0, run, p.rows_total);
  __syncthreads();
  const unsigned blocks = 1u << p.shift;
  for (int i = threadIdx.x; i < p.nn * 2; i += blockDim.x) {
    const long long v = p.rows_total[i];
    if (v == 0) continue;
    const int node = i >> 1;
    const unsigned owner = node & (blocks - 1);
    const uint32_t a = shared_address(p.total + (node >> p.shift) * 2 + (i & 1));
    if (owner == p.rank) {
      add_shared_64<false>(a, v);
    } else {
      add_shared_64<true>(in_block(a, owner), v);
    }
  }
  sync_cluster(blocks);
  // Nodes p < nn of the tile with p % C == rank.
  const int own = p.nn > (int)p.rank ? (p.nn - 1 - (int)p.rank) / (int)blocks + 1 : 0;
  const int lane = threadIdx.x & 31;
  const int entries = p.bins * 2;
  const long long* hist = p.rows_total - (long long)p.nf * p.npr * entries;
  for (int u = threadIdx.x >> 5; u < p.nf * own; u += blockDim.x >> 5) {
    const int fl = u / own;
    const int ln = u - fl * own;
    const long long* h = hist + ((long long)fl * p.npr + ln) * entries;
    const long long node = p.n0 + (long long)ln * blocks + p.rank;
    unsigned long long* o = reinterpret_cast<unsigned long long*>(
        out + (node * n_features + p.f0 + fl) * max_bins * 2);
    unsigned long long s = 0;  // this lane's bins of one component (its parity)
    for (int e = lane; e < entries; e += 32) {
      const unsigned long long v = (unsigned long long)h[e];
      s += v;
      if (v != 0) atomicAdd(o + e, v);
    }
    for (int d = 16; d >= 2; d >>= 1) s += __shfl_xor_sync(kFullWarp, s, d);
    if (lane < 2) {
      const unsigned long long missing =
          (unsigned long long)p.total[ln * 2 + lane] - s;
      if (missing != 0) atomicAdd(o + entries + lane, missing);
    }
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
  extern __shared__ long long smem[];
  const Private p = private_histogram(smem, node_tile, feat_group, n_nodes,
                                      n_features, max_bins);
  const double scale = pow2(__ldg(kexp));
  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  const int cmask = (1 << p.shift) - 1;
  Run run{-1, make_longlong2(0, 0)};
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
#pragma unroll
    for (int j = 0; j < SPW; ++j) add_to_run(run, node[j], v[j], p.rows_total);
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
      const uint32_t fbase = p.base + fl * p.fstride;
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
        if (adds)
          add_pair(fbase + (((node[j] >> p.shift) * p.bins + bin) << 4),
                   node[j] & cmask, p.rank, sum);
      }
    }
  }
  flush_private(p, run, out, n_features, max_bins);
}

// 512 threads a block and at most 40 registers a thread (MIN_BLOCKS 3), so
// that three blocks fit an SM's 65,536 registers where the plan's shared
// memory allows three.
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
  const double scale = pow2(__ldg(kexp));
  const uint32_t mask = symbol_mask(bits);
  const int missing = max_bins - 1;
  const int cmask = (1 << p.shift) - 1;
  Run run{-1, make_longlong2(0, 0)};
  const long long n_symbols =
      kChunked ? (long long)(n_words / words_per_chunk) * chunk_rows
               : (long long)n_words * SPW;
  const long long s_begin = (long long)blockIdx.x * slots_per_block;
  const long long s_end = min(s_begin + slots_per_block, (long long)n_slots);
  // The warp steps through its slots together: the votes and the match
  // below need all 32 lanes, so a lane with nothing to add carries q = -1.
  for (long long s = s_begin + threadIdx.x; s - (threadIdx.x & 31) < s_end;
       s += blockDim.x) {
    int q = s < s_end ? __ldg(pos + s) - p.n0 : -1;
    int r = 0;
    if (q >= 0 && q < p.nn) r = __ldg(rid + s);
    if (q < 0 || q >= p.nn || r < 0 || r >= n_symbols) q = -1;  // reads nothing
    if (!__any_sync(kFullWarp, q >= 0)) continue;
    longlong2 v = make_longlong2(0, 0);
    if (q >= 0) v = quantise_pair(__ldg(gh + s), scale);
    add_to_run(run, q, v, p.rows_total);
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
    const int base = q * max_bins;
    const uint32_t nbase = q >= 0 ? p.base + (((q >> p.shift) * p.bins) << 4) : 0u;
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
        const int key = on ? base + bin : -1;
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
          add_pair(nbase + (fl0 + u) * p.fstride + (bin << 4), q & cmask,
                   p.rank, sum);
      }
    }
  }
  flush_private(p, run, out, n_features, max_bins);
}


// Bytes of a private kernel's dynamic shared memory: its share of the
// cluster's histogram and the two node totals (kernels/histogram.py ::
// private_bytes).
size_t private_bytes(int feat_group, int node_tile, int cluster, int max_bins) {
  const long long per_block = (node_tile + cluster - 1) / cluster;
  return (size_t)(feat_group * per_block * (max_bins - 1) + node_tile + per_block) * 16;
}

// Launches a private kernel on the plan's grid, `cluster` consecutive
// blocks along x a cluster (the grid's x rounded up to a multiple of it).
template <typename... Params, typename... Args>
cudaError_t launch_private(void (*kernel)(Params...), int n_items,
                           int n_features, int n_nodes, int max_bins,
                           int node_tile, int feat_group, int items_per_block,
                           int cluster, int threads, cudaStream_t stream,
                           Args... args) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      node_tile < 1 || feat_group < 1 || items_per_block < 1 || max_bins < 1)
    return cudaErrorInvalidValue;
  const size_t smem = private_bytes(feat_group, node_tile, cluster, max_bins);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned stripes = (n_items + items_per_block - 1) / items_per_block;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((stripes + cluster - 1) / cluster * cluster,
                     (n_features + feat_group - 1) / feat_group,
                     (n_nodes + node_tile - 1) / node_tile);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
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
cudaError_t private_call(const void* packed, const void* gh, const void* pos,
                         void* out, const void* kexp, int n_rows,
                         int n_features, int n_words, int n_nodes,
                         int max_bins, int bits, int node_tile, int feat_group,
                         int words_per_block, int blocks_per_sm, int cluster,
                         int threads, int chunk_rows, int words_per_chunk,
                         cudaStream_t stream) {
  return launch_private(
      private_kernel<SPW, kChunked>(blocks_per_sm), n_words, n_features,
      n_nodes, max_bins, node_tile, feat_group, words_per_block, cluster,
      threads, stream, (const uint32_t*)packed, (const float2*)gh,
      (const int*)pos, (long long*)out, (const int*)kexp, n_rows, n_features,
      n_words, n_nodes, max_bins, bits, node_tile, feat_group, words_per_block,
      chunk_rows, words_per_chunk);
}

template <int SPW, bool kChunked>
cudaError_t rows_call(const void* packed, const void* gh, const void* pos,
                      const void* rid, void* out, const void* kexp,
                      int n_slots, int n_features, int n_words, int n_nodes,
                      int max_bins, int bits, int node_tile, int feat_group,
                      int slots_per_block, int cluster, int threads,
                      int chunk_rows, int words_per_chunk,
                      cudaStream_t stream) {
  return launch_private(
      histogram_rows_kernel<SPW, kChunked>, n_slots, n_features, n_nodes,
      max_bins, node_tile, feat_group, slots_per_block, cluster, threads,
      stream, (const uint32_t*)packed, (const float2*)gh, (const int*)pos,
      (const int*)rid, (long long*)out, (const int*)kexp, n_slots, n_features,
      n_words, n_nodes, max_bins, bits, node_tile, feat_group, slots_per_block,
      chunk_rows, words_per_chunk);
}

}  // namespace

// 8-bit symbols only (four a word): the shapes tools/kernel_parts.py times.
#define RT_SPW_SWITCH(bits, CALL) \
  switch (32 / (bits)) {          \
    case 4: return (int)CALL(4);  \
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
// into; `kexp` points to the call's int32 exponent on the device. `cluster`
// blocks (1, 2, 4 or 8) share one node tile's private histogram.
extern "C" int parts_histogram_private(
    const void* packed, const void* gh, const void* pos, void* out,
    const void* kexp, int n_rows, int n_features, int n_words, int n_nodes,
    int max_bins, int bits, int node_tile, int feat_group, int words_per_block,
    int blocks_per_sm, int cluster, int threads, int chunk_rows,
    int words_per_chunk, void* stream) {
  if (!chunk_args_ok(n_words, chunk_rows, words_per_chunk))
    return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  RT_CHUNK_SWITCH(private_call, S, packed, gh, pos, out, kexp, n_rows,      \
                  n_features, n_words, n_nodes, max_bins, bits, node_tile,  \
                  feat_group, words_per_block, blocks_per_sm, cluster,      \
                  threads)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

extern "C" int parts_histogram_rows(
    const void* packed, const void* gh, const void* pos, const void* rid,
    void* out, const void* kexp, int n_slots, int n_features, int n_words,
    int n_nodes, int max_bins, int bits, int node_tile, int feat_group,
    int slots_per_block, int cluster, int threads, int chunk_rows,
    int words_per_chunk, void* stream) {
  if (!chunk_args_ok(n_words, chunk_rows, words_per_chunk))
    return (int)cudaErrorInvalidValue;
#define RT_CALL(S)                                                          \
  RT_CHUNK_SWITCH(rows_call, S, packed, gh, pos, rid, out, kexp, n_slots,   \
                  n_features, n_words, n_nodes, max_bins, bits, node_tile,  \
                  feat_group, slots_per_block, cluster, threads)
  RT_SPW_SWITCH(bits, RT_CALL)
#undef RT_CALL
}

#undef RT_SPW_SWITCH
#undef RT_CHUNK_SWITCH

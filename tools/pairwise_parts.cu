// Parts of the pairwise kernel's design, for tools/pairwise_parts.py: the
// shipped source (kernels/csrc/pairwise.cu, included) instantiated with
// other tile bodies and other warp/block splits.
//
// variant 0  shipped: every query of <= 256 rows in block rounds
// variant 1  a query of <= 2 tiles on its window's warp alone
// variant 2  shuffle columns, every query of <= 256 rows one warp's
// variant 3  butterfly columns: lane l meets column l ^ t at step t and keeps
//            the column's term in register t; five xor-shuffle stages sum
//            each column into its lane (tiles with themselves as shipped)
// variant 4  float64 row and column sums: every term added in double, the
//            columns' doubles passed down the lanes (unrolled 4 deep, as
//            shipped; the butterfly needs its 32 steps unrolled)
// variant 5  staging alone: both kernels with tiles that compute nothing
// variant 6  the sigmoid's reciprocal by an IEEE division, its slow-path
//            branch kept
// variant 7  one chain a warp: a step waits on the previous step's shuffles
// variant 8-11  the query kernel alone: shipped, <= 2 tiles a warp's, staging
//            alone, one chain a warp
// variant 12 spread tasks of two 128-row chunks, a block of 4 warps a task
// variant 13 __expf and __fdividef for the sigmoid (outside the gate: timed
//            and its error reported, not held)
#include "../src/repro_torch/kernels/csrc/pairwise.cu"

namespace {

struct ButterflyTiles {
  template <bool kKeyed>
  static __device__ __forceinline__ void diag(const float2* sy, const int* key, double2* acc,
                                              int x0, int nv, int lane) {
    ShuffleTiles::template diag<kKeyed>(sy, key, acc, x0, nv, lane);
  }

  static __device__ __forceinline__ void off(const float2* sy, double2* accR, double2* accC,
                                             int xr, int nr, int xc, int nc, int lane) {
    const float2 r = sy[xr + lane];
    const float sr = r.x, yr = lane < nr ? r.y : __int_as_float(0x7fc00000);
    float gr = 0.0f, hr = 0.0f, cg[32], ch[32];
    double g_row = 0.0, h_row = 0.0;
#pragma unroll
    for (int t = 0; t < 32; ++t) {
      const int c = lane ^ t;
      const float2 o = sy[xc + c];
      float g0 = 0.0f, h0 = 0.0f;
      pair_terms<Sigmoid>(sr, yr, o.x, c < nc ? o.y : __int_as_float(0x7fc00000), gr, hr, g0,
                               h0);
      cg[t] = g0;
      ch[t] = h0;
      if (t == 15) {
        g_row = gr;
        h_row = hr;
        gr = hr = 0.0f;
      }
    }
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
#pragma unroll
      for (int t = 0; t < h; ++t) {
        cg[t] += __shfl_xor_sync(kFull, cg[t + h], h);
        ch[t] += __shfl_xor_sync(kFull, ch[t + h], h);
      }
    }
    if (lane < nr) add_to(accR, xr + lane, g_row + (double)gr, h_row + (double)hr);
    if (lane < nc) add_to(accC, xc + lane, (double)cg[0], (double)ch[0]);
  }
};

// The shipped schedule with every term added in float64.
__device__ __forceinline__ void pair_terms64(float sr, float yr, float sc, float yc, double& gr,
                                             double& hr, double& gc, double& hc) {
  float g = 0.0f, h = 0.0f, g2 = 0.0f, h2 = 0.0f;
  pair_terms<Sigmoid>(sr, yr, sc, yc, g, h, g2, h2);
  gr += g;
  gc += g2;
  hr += h;
  hc += h2;
}

struct F64Tiles {
  template <bool kKeyed>
  static __device__ __forceinline__ void diag(const float2* sy, const int* key, double2* acc,
                                              int x0, int nv, int lane) {
    const float2 r = sy[x0 + lane];
    const int kr = kKeyed ? key[x0 + lane] : 0;
    const bool row_ok = kKeyed ? kr >= 0 : lane < nv;
    const float sr = r.x, yr = row_ok ? r.y : __int_as_float(0x7fc00000);
    double gr = 0.0, hr = 0.0, gc = 0.0, hc = 0.0;
#pragma unroll 4
    for (int t = 1; t <= 16; ++t) {
      const int c = (lane + t) & 31;
      const float2 o = sy[x0 + c];
      bool ok = c < nv && (t < 16 || lane < 16);
      if (kKeyed) ok = ok && key[x0 + c] == kr;
      pair_terms64(sr, yr, o.x, ok ? o.y : __int_as_float(0x7fc00000), gr, hr, gc, hc);
      if (t < 16) {
        gc = __shfl_sync(kFull, gc, (lane + 1) & 31);
        hc = __shfl_sync(kFull, hc, (lane + 1) & 31);
      }
    }
    const double gcl = __shfl_sync(kFull, gc, (lane + 16) & 31);
    const double hcl = __shfl_sync(kFull, hc, (lane + 16) & 31);
    if (row_ok) add_to(acc, x0 + lane, gr + gcl, hr + hcl);
  }

  static __device__ __forceinline__ void off(const float2* sy, double2* accR, double2* accC,
                                             int xr, int nr, int xc, int nc, int lane) {
    const float2 r = sy[xr + lane];
    const float sr = r.x, yr = lane < nr ? r.y : __int_as_float(0x7fc00000);
    double gr = 0.0, hr = 0.0, gc = 0.0, hc = 0.0;
#pragma unroll 4
    for (int t = 0; t < 32; ++t) {
      const int c = (lane + t) & 31;
      const float2 o = sy[xc + c];
      pair_terms64(sr, yr, o.x, c < nc ? o.y : __int_as_float(0x7fc00000), gr, hr, gc, hc);
      gc = __shfl_sync(kFull, gc, (lane + 1) & 31);
      hc = __shfl_sync(kFull, hc, (lane + 1) & 31);
    }
    if (lane < nr) add_to(accR, xr + lane, gr, hr);
    if (lane < nc) add_to(accC, xc + lane, gc, hc);
  }
};

struct NoTiles {
  template <bool kKeyed>
  static __device__ __forceinline__ void diag(const float2*, const int*, double2*, int, int,
                                              int) {}
  static __device__ __forceinline__ void off(const float2*, double2*, double2*, int, int, int,
                                             int, int) {}
};

// sigmoid by the special-function units' approximations alone.
struct FastSigmoid {
  static __device__ __forceinline__ float of(float x) {
    return __fdividef(1.0f, 1.0f + __expf(fminf(-x, 88.0f)));
  }
};

// sigmoid by expf and an IEEE division, the division's slow-path branch kept.
struct DivisionSigmoid {
  static __device__ __forceinline__ float of(float x) { return 1.0f / (1.0f + expf(-x)); }
};

// One chain a warp: a step's pair waits on the previous step's shuffles.
template <class Sigmoid>
struct OneChainTilesOf {
  // Tile at local position x0 with itself, nv rows valid. kKeyed: a pair
  // counts only where both rows carry the same non-negative key (a window of
  // packed queries); a row with a negative key is not written.
  template <bool kKeyed>
  static __device__ __forceinline__ void diag(const float2* sy, const int* key, double2* acc,
                                              int x0, int nv, int lane) {
    const float2 r = sy[x0 + lane];
    const int kr = kKeyed ? key[x0 + lane] : 0;
    const bool row_ok = kKeyed ? kr >= 0 : lane < nv;
    const float sr = r.x, yr = row_ok ? r.y : __int_as_float(0x7fc00000);
    const int down = (lane + 1) & 31;
    float gr = 0.0f, hr = 0.0f, gc = 0.0f, hc = 0.0f;
#pragma unroll 4
    for (int t = 1; t <= 16; ++t) {  // step t: column (lane + t) mod 32
      const int c = (lane + t) & 31;
      const float2 o = sy[x0 + c];
      bool ok = c < nv && (t < 16 || lane < 16);
      if (kKeyed) ok = ok && key[x0 + c] == kr;
      pair_terms<Sigmoid>(sr, yr, o.x, ok ? o.y : __int_as_float(0x7fc00000), gr, hr, gc, hc);
      gc = __shfl_sync(kFull, gc, down);
      hc = __shfl_sync(kFull, hc, down);
    }
    // Lane L holds column (L + 17) mod 32's sum.
    const float gcl = __shfl_sync(kFull, gc, (lane + 15) & 31);
    const float hcl = __shfl_sync(kFull, hc, (lane + 15) & 31);
    if (row_ok) add_to(acc, x0 + lane, (double)gr + (double)gcl, (double)hr + (double)hcl);
  }

  // Row tile at xr (nr valid) against column tile at xc (nc valid): row sums
  // into accR, column sums into accC.
  static __device__ __forceinline__ void off(const float2* sy, double2* accR, double2* accC,
                                             int xr, int nr, int xc, int nc, int lane) {
    const float2 r = sy[xr + lane];
    const float sr = r.x, yr = lane < nr ? r.y : __int_as_float(0x7fc00000);
    const int down = (lane + 1) & 31;
    float gr = 0.0f, hr = 0.0f, gc = 0.0f, hc = 0.0f;
#pragma unroll 4
    for (int t = 0; t < 16; ++t) {
      const int c = (lane + t) & 31;
      const float2 o = sy[xc + c];
      pair_terms<Sigmoid>(sr, yr, o.x, c < nc ? o.y : __int_as_float(0x7fc00000), gr, hr, gc, hc);
      gc = __shfl_sync(kFull, gc, down);
      hc = __shfl_sync(kFull, hc, down);
    }
    // 16 terms in each partial: flush, start the second half.
    const double g_row = gr, h_row = hr;
    const float gc_half = gc, hc_half = hc;
    gr = hr = gc = hc = 0.0f;
#pragma unroll 4
    for (int t = 16; t < 32; ++t) {
      const int c = (lane + t) & 31;
      const float2 o = sy[xc + c];
      pair_terms<Sigmoid>(sr, yr, o.x, c < nc ? o.y : __int_as_float(0x7fc00000), gr, hr, gc, hc);
      gc = __shfl_sync(kFull, gc, down);
      hc = __shfl_sync(kFull, hc, down);
    }
    // Lane l holds column l's steps 16..31; its steps 0..15 sit in lane l + 16.
    const float gc0 = __shfl_sync(kFull, gc_half, (lane + 16) & 31);
    const float hc0 = __shfl_sync(kFull, hc_half, (lane + 16) & 31);
    if (lane < nr) add_to(accR, xr + lane, g_row + (double)gr, h_row + (double)hr);
    if (lane < nc) add_to(accC, xc + lane, (double)gc0 + (double)gc, (double)hc0 + (double)hc);
  }
};

template <class Tiles, int kWarpMax, int kChunk = kChunkRows>
int run(const void* scores, const void* labels, const void* order, const void* start,
        const void* end, void* gh, void* scratch, int n, void* stream) {
  int blocks = 0;
  const int err = spread_grid<Tiles, kChunk>(&blocks);
  if (err != (int)cudaSuccess) return err;
  return launch_pairwise<Tiles, kWarpMax, kChunk>(
      scores, labels, order, start, end, gh, scratch, n, blocks, (cudaStream_t)stream);
}

// The query kernel alone (its rows of spread queries left unwritten).
template <class Tiles, int kWarpMax>
int query_only(const void* scores, const void* labels, const void* order, const void* start,
               const void* end, void* gh, void* scratch, int n, void* stream) {
  const int slots = (n + kRange - 1) / kRange;
  longlong2* fix = (longlong2*)scratch;
  unsigned long long* chunk_done = (unsigned long long*)(fix + n);
  pairwise_query_kernel<Tiles, kWarpMax><<<slots, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)scores, (const float*)labels, (const int*)order, (const int*)start,
      (const int*)end, (float2*)gh, fix, chunk_done, (long long*)(chunk_done + n), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int parts_pairwise(int variant, const void* scores, const void* labels,
                              const void* order, const void* start, const void* end, void* gh,
                              void* scratch, int n, void* stream) {
#define ARGS scores, labels, order, start, end, gh, scratch, n, stream
  switch (variant) {
    case 0: return run<ShuffleTiles, kWarpTiles>(ARGS);
    case 1: return run<ShuffleTiles, 2>(ARGS);
    case 2: return run<ShuffleTiles, 8>(ARGS);
    case 3: return run<ButterflyTiles, kWarpTiles>(ARGS);
    case 4: return run<F64Tiles, kWarpTiles>(ARGS);
    case 5: return run<NoTiles, kWarpTiles>(ARGS);
    case 6: return run<ShuffleTilesOf<DivisionSigmoid>, kWarpTiles>(ARGS);
    case 7: return run<OneChainTilesOf<Sigmoid>, kWarpTiles>(ARGS);
    case 8: return query_only<ShuffleTiles, kWarpTiles>(ARGS);
    case 9: return query_only<ShuffleTiles, 2>(ARGS);
    case 10: return query_only<NoTiles, kWarpTiles>(ARGS);
    case 11: return query_only<OneChainTilesOf<Sigmoid>, kWarpTiles>(ARGS);
    case 12: return run<ShuffleTiles, kWarpTiles, 128>(ARGS);
    case 13: return run<ShuffleTilesOf<FastSigmoid>, kWarpTiles>(ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ARGS
}

// Fused K-step quasi-distance-transform chunk for Hopper (sm_90a): the
// paper's Algorithm 5.
//
// Replaces the three Pallas TPU kernels of the QDT path:
//   qdt_chain_step_launch   <- src/repro/kernels/qdt_chain.py:96
//                              qdt_chain_step (row bands)
//   qdt_tile_step_launch    <- src/repro/kernels/qdt_chain.py:192
//                              qdt_tile_step (band x tile cells)
//   qdt_compact_step_launch <- src/repro/kernels/qdt_chain.py:281
//                              qdt_compact_step (gathered patches)
//
// Each of the K steps erodes f by the 3x3 square (eps1), takes the
// residual res = f - eps1(f) in the accumulator type A (int32, float32
// for floating images) and, where res > r, stores r = res and
// d = base + step (the masked store of the paper).  base is the count of
// erosions already applied to the cell's image (per band, per tile, or
// per compact slot), so every image of a ragged-converged stack keeps
// its own distance index.
//
// What a block does.  A block takes a TB x TW sub-tile of one cell
// (where its (TB+2K) x (TW+2K) window lies: morph_common.cuh's locate)
// and is ncol warps across the window by nstrip strips down it.  Each
// thread owns the same pixels for all K steps: kRows = 16 consecutive
// rows of one window column (qdt_pixel_kernel, every dtype) or, for
// uint8 with K < 128, of four adjacent columns (qdt_u8_kernel).  It reads
// its f pixels from device memory once, pinned to the erosion identity
// outside the window, the cell's image and the array (compact patches
// arrive pinned), and keeps them in registers; for its centre pixels it
// also keeps r and the step t of the last update there (0: none) in
// registers.  Device memory is read in loops that store nothing (the
// compiler cannot tell out or shared memory from f, r and d, so a store
// of a loaded value would make every later load wait for it), and the
// write-back loads the old centre (for the flag) and d_in (where t = 0)
// before it stores: d_out = t ? base + t : d_in.
//
// A step stores the thread's pixels into a shared-memory plane (ping-pong,
// one barrier a step) and reads back its left and right neighbours; the
// rows just above and below its strip come from the neighbouring strips
// through the plane too.  eps1 is separable: a row min of left, own and
// right, then a column min over three row mins, all in registers.  Every
// step computes the whole block, with no guard: a pixel t - 1 or fewer
// from the block's edge may be wrong after step t (the one-pixel ring
// beyond the block is never written), which after K steps reaches no
// further than K - 1 from the window's edge, so the centre is exact.
// The residual and the masked store happen in registers.  float32 takes
// its min from PTX min.NaN (the canonical NaN, as jnp.minimum propagates
// NaN; the checks compare NaN positions), float64 and the integers from
// morph::pick.
//
// uint8 packs: a thread holds its four columns of a row as two words of
// 16-bit lanes (p0, p1) and (p2, p3), takes the row min from the
// neighbours' words with __byte_perm and PTX min.u16x2 (Hopper's native
// 16-bit SIMD min), and keeps r and t together as one 16-bit key a pixel,
// key = (r + 1) * 128 + 127 - t: the masked store "res > r, then r = res
// and t = step" is key = max(key, (res + 1) * 128 + 127 - step), since a
// later step has a smaller t and a tie keeps the older key.  That needs
// r in [-1, 255]: a uint8 residual lies in [0, 255], so r_in clamped to
// [-1, 255] gives every res > r test the outcome it has with r_in, and the
// write-back takes r_out = t ? key / 128 - 1 : r_in.  The residual is
// the plain 32-bit difference of the words (eps1 <= own, so no lane
// borrows).  The plane holds one byte a pixel and a warp spans 128
// columns (TW = 128 ncol - 2K, TB = 16 nstrip - 2K): at K = 32 a 64x128
// cell is two 8-warp blocks of 64x64 sub-tiles (128x128 windows), where
// one pixel a thread would need 16 blocks of 15 warps.
//
// Residuals are computed as the reference computes them: (int32)a -
// (int32)b for uint8/uint16; for int32 images a wrapping subtraction
// (through uint32_t, since signed overflow is undefined in C++); float32
// a - b; float64 images (float)a - (float)b, each cast before the
// subtraction.  A NaN residual never compares greater, so it stores
// nothing; eps1 propagates NaN.  Built without fast-math.  An inactive
// cell or invalid slot copies f, r and d through and leaves its flag at
// 0; the changed flag is "any centre f pixel moved" (NaN counts as
// moved), OR-reduced with __syncthreads_or.
//
// Bound on one H100 SXM (3.35 TB/s, 67e12/s fp32 non-tensor rate for
// every dtype).  Per launch the function reads f, r and d once and
// writes each once; its work is 4 min + 1 subtract + 1 compare per pixel
// per step.  At paper scale, 8 x 1024 x 1024, one all-active tile
// launch: uint8, K=32: 151 MB -> 45 us against 1.6e9 ops -> 24 us, bound
// by bytes; float32, K=16: 201 MB -> 60 us.  chip_smoke.py recomputes
// the bounds from its run's inputs.  What keeps the kernel above them:
// every step computes the whole block (at K = 32, 4x the centre's
// pixels), at 387 instructions a 16-row step of the packed kernel (~6 a
// pixel-step), with barrier and shared-memory latency behind two 8-warp
// blocks an SM; the load and the write-back, which spill, overlap only
// the other block's steps.  That keeps qdt_tile_step ~9x above its bound
// (0.42 ms on an H100 SXM at 700 W, chip_smoke.py).
//
// ptxas (-O3, sm_90a), registers a thread and bytes spilled: u8 128
// (188, in the load and the write-back, not in the step loop); pixel
// uint8 128 (0), uint16 128 (0), int32 128 (12), float 128 (4), double
// 128 (120).

#include <algorithm>

#include "morph_common.cuh"

namespace {

using morph::Geo;
using morph::Lattice;
using morph::max2;
using morph::min2;
using morph::pick;
using morph::Window;

// The residual's accumulator type.
template <typename T> struct Acc { using type = int32_t; };
template <> struct Acc<float> { using type = float; };
template <> struct Acc<double> { using type = float; };

__device__ __forceinline__ int32_t residual(uint8_t a, uint8_t b) {
  return static_cast<int32_t>(a) - static_cast<int32_t>(b);
}
__device__ __forceinline__ int32_t residual(uint16_t a, uint16_t b) {
  return static_cast<int32_t>(a) - static_cast<int32_t>(b);
}
__device__ __forceinline__ int32_t residual(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a)
                              - static_cast<uint32_t>(b));
}
__device__ __forceinline__ float residual(float a, float b) { return a - b; }
__device__ __forceinline__ float residual(double a, double b) {
  return static_cast<float>(a) - static_cast<float>(b);
}

// The erosion's min, propagating NaN as jnp.minimum does: one PTX
// min.NaN for float32 (its NaN is the canonical one), morph::pick for
// the rest.
template <typename T>
__device__ __forceinline__ T emin(T a, T b) {
  return pick<T, true>(a, b);
}
__device__ __forceinline__ float emin(float a, float b) {
  return morph::min_nan(a, b);
}

// The residual and distance planes of one launch, and the per-cell base.
// In stack mode they have f's layout; in compact mode the centres'
// (cap * band_h, tile_w) layout, like the f output.
struct Planes {
  const void* r_in;
  const int* d_in;
  void* r_out;
  int* d_out;
  const int* base;
};

// Rows of the column strip that each thread owns.
constexpr int kRows = 16;

// Threads a block may have (128 registers a thread).
constexpr int kMaxThreads = 512;

// The uint8 key's step field: key = (r + 1) * kSteps + kSteps - 1 - t.
constexpr int kSteps = 128;

// An inactive cell or invalid slot: the sub-tile's centre of f, r and d
// copied through, eight pixels a thread loaded before any is stored.
template <typename T, typename A>
__device__ __forceinline__ void pass_through(const Geo& g, const Window& w,
                                             const Planes& p) {
  constexpr int B = 8;
  const T* f = static_cast<const T*>(g.f);
  T* out = static_cast<T*>(g.out);
  const A* r_in = static_cast<const A*>(p.r_in);
  A* r_out = static_cast<A*>(p.r_out);
  const int K = g.k, n = w.tb * w.tw, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += B * step) {
    T fv[B];
    A rv[B];
    int dv[B];
    long long at[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int i = i0 + k * step;
      if (i < n) {
        const int r = i / w.tw, c = i % w.tw;
        at[k] = (w.orow + r) * g.out_w + w.ocol + c;
        fv[k] = f[(w.wr + K + r) * g.src_w + w.wc + K + c];
        rv[k] = r_in[at[k]];
        dv[k] = p.d_in[at[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      if (i0 + k * step < n) {
        out[at[k]] = fv[k];
        r_out[at[k]] = rv[k];
        p.d_out[at[k]] = dv[k];
      }
    }
  }
}

// One pixel a thread: window column (warp % ncol) * 32 + lane, rows
// (warp / ncol) * kRows onwards.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    qdt_pixel_kernel(Geo g, Planes p, int ncol) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = kRows;
  const int K = g.k;
  const int cell = blockIdx.x;
  const Window w = morph::locate(g, cell, blockIdx.y);
  if (g.active != nullptr && g.active[cell] == 0) {
    pass_through<T, A>(g, w, p);
    return;
  }
  const T* f = static_cast<const T*>(g.f);
  T* out = static_cast<T*>(g.out);
  const A* r_in = static_cast<const A*>(p.r_in);
  A* r_out = static_cast<A*>(p.r_out);

  const int warp = threadIdx.x >> 5;
  const int c = (warp % ncol) * 32 + (threadIdx.x & 31);
  const int r0 = (warp / ncol) * P;
  const long long gc = w.wc + c;
  const bool centre_col = c >= K && c < K + w.tw;
  const auto centre = [&](int j) {
    return centre_col && r0 + j >= K && r0 + j < K + w.tb;
  };
  const auto src_at = [&](int j) { return (w.wr + r0 + j) * g.src_w + gc; };
  const auto out_at = [&](int j) {
    return (w.orow + r0 + j - K) * g.out_w + w.ocol + c - K;
  };

  // The strip, pinned outside the window, the cell's image and the
  // array; r of its centre pixels.
  T own[P];
  A rv[P];
  const bool col_in = c < w.WW && gc >= 0 && gc < g.src_w;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long gr = w.wr + r0 + j;
    const bool in = col_in && r0 + j < w.WH && gr >= w.rlo && gr < w.rhi;
    own[j] = in ? f[src_at(j)] : Lattice<T>::hi();
    rv[j] = centre(j) ? r_in[out_at(j)] : A(0);
  }
  const int base = p.base[cell];

  // Planes hold the block's rows and columns and a one-pixel ring that is
  // never written (see the step loop).
  const int S = 32 * ncol + 2;
  const int plane = (static_cast<int>(blockDim.x) / (32 * ncol) * P + 2) * S;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  const int at = (r0 + 1) * S + c + 1;  // window pixel (r0, c)
  int tl[P];
#pragma unroll
  for (int j = 0; j < P; ++j) tl[j] = 0;

  for (int t = 1; t <= K; ++t) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[at + j * S] = own[j];
    __syncthreads();
    // row mins of rows -1 .. P (the end rows are the next strips')
    T h[P + 2];
#pragma unroll
    for (int j = -1; j <= P; ++j) {
      const T* row = a + at + j * S;
      const T mid = (j < 0 || j == P) ? row[0] : own[j];
      h[j + 1] = emin(emin(row[-1], mid), row[1]);
    }
#pragma unroll
    for (int j = 0; j < P; j += 2) {
      const T s = emin(h[j + 1], h[j + 2]);  // shared by rows j, j + 1
      const T v[2] = {emin(h[j], s), emin(s, h[j + 3])};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (centre(j + u)) {
          const A res = residual(own[j + u], v[u]);
          if (res > rv[j + u]) {
            rv[j + u] = res;
            tl[j + u] = t;
          }
        }
        own[j + u] = v[u];
      }
    }
    T* tmp = a;
    a = b;
    b = tmp;
  }

  T old[P];
  int dv[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (centre(j)) {
      old[j] = f[src_at(j)];
      dv[j] = tl[j] ? 0 : p.d_in[out_at(j)];
    }
  }
  int any = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (centre(j)) {
      const long long o = out_at(j);
      out[o] = own[j];
      r_out[o] = rv[j];
      p.d_out[o] = tl[j] ? base + tl[j] : dv[j];
      any |= (own[j] != old[j]);
    }
  }
  any = __syncthreads_or(any);
  if (any && threadIdx.x == 0) g.changed[cell] = 1;
}

// uint8, four pixels a thread: window columns 4q .. 4q + 3, q = (warp %
// ncol) * 32 + lane, rows (warp / ncol) * kRows onwards, held as two
// words of 16-bit lanes; K < kSteps.
__global__ void __launch_bounds__(kMaxThreads)
    qdt_u8_kernel(Geo g, Planes p, int ncol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = kRows;
  const int K = g.k;
  const int cell = blockIdx.x;
  const Window w = morph::locate(g, cell, blockIdx.y);
  if (g.active != nullptr && g.active[cell] == 0) {
    pass_through<uint8_t, int32_t>(g, w, p);
    return;
  }
  const uint8_t* f = static_cast<const uint8_t*>(g.f);
  uint8_t* out = static_cast<uint8_t*>(g.out);
  const int32_t* r_in = static_cast<const int32_t*>(p.r_in);
  int32_t* r_out = static_cast<int32_t*>(p.r_out);

  const int warp = threadIdx.x >> 5;
  const int q = (warp % ncol) * 32 + (threadIdx.x & 31);
  const int c0 = 4 * q;
  const int r0 = (warp / ncol) * P;
  const auto centre_row = [&](int j) {
    return r0 + j >= K && r0 + j < K + w.tb;
  };
  const auto centre_col = [&](int i) {
    return c0 + i >= K && c0 + i < K + w.tw;
  };
  const auto src_at = [&](int j, int i) {
    return (w.wr + r0 + j) * g.src_w + w.wc + c0 + i;
  };
  const auto out_at = [&](int j, int i) {
    return (w.orow + r0 + j - K) * g.out_w + w.ocol + c0 + i - K;
  };

  // The strip, pinned to 255 outside the window, the cell's image and the
  // array, as (p0, p1) and (p2, p3) lanes; each centre pixel's key.
  uint32_t own[P][2], key[P][2];
  bool col_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gc = w.wc + c0 + i;
    col_in[i] = c0 + i < w.WW && gc >= 0 && gc < g.src_w;
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long gr = w.wr + r0 + j;
    const bool row_in = r0 + j < w.WH && gr >= w.rlo && gr < w.rhi;
    uint32_t px[4], kv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      px[i] = row_in && col_in[i] ? f[src_at(j, i)] : 0xFFu;
      const int r = centre_row(j) && centre_col(i) ? r_in[out_at(j, i)] : 0;
      kv[i] = (min(max(r, -1), 255) + 1) * kSteps + kSteps - 1;
    }
    own[j][0] = px[0] | px[1] << 16;
    own[j][1] = px[2] | px[3] << 16;
    key[j][0] = kv[0] | kv[1] << 16;
    key[j][1] = kv[2] | kv[3] << 16;
  }
  const int base = p.base[cell];

  // Planes of one byte a pixel: the block's rows and columns and a ring
  // of one row and one word of columns that is never written.
  const int S = 32 * ncol + 2;  // words a row
  const int plane = (static_cast<int>(blockDim.x) / (32 * ncol) * P + 2) * S;
  uint32_t* a = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* b = a + plane;
  const int at = (r0 + 1) * S + q + 1;  // window pixels (r0, c0 .. c0 + 3)

  for (int t = 1; t <= K; ++t) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      a[at + j * S] = __byte_perm(own[j][0], own[j][1], 0x6420);
    __syncthreads();
    // row mins of rows -1 .. P (the end rows are the next strips')
    uint32_t ha[P + 2], hb[P + 2];
#pragma unroll
    for (int j = -1; j <= P; ++j) {
      const uint32_t* row = a + at + j * S;
      uint32_t x, y;
      if (j < 0 || j == P) {
        const uint32_t word = row[0];
        x = __byte_perm(word, 0, 0x4140);  // (p0, p1)
        y = __byte_perm(word, 0, 0x4342);  // (p2, p3)
      } else {
        x = own[j][0];
        y = own[j][1];
      }
      const uint32_t lx = __byte_perm(x, row[-1], 0x1017);  // (p-1, p0)
      const uint32_t mid = __byte_perm(x, y, 0x1412);       // (p1, p2)
      const uint32_t ry = __byte_perm(y, row[1], 0x1412);   // (p3, p4)
      ha[j + 1] = min2(min2(lx, x), mid);
      hb[j + 1] = min2(min2(mid, y), ry);
    }
    // the candidate key of a residual res is res * kSteps + cst
    const uint32_t cst = (2 * kSteps - 1 - t) * 0x10001u;
#pragma unroll
    for (int j = 0; j < P; j += 2) {
      const uint32_t sa = min2(ha[j + 1], ha[j + 2]);
      const uint32_t sb = min2(hb[j + 1], hb[j + 2]);
      const uint32_t va[2] = {min2(ha[j], sa), min2(sa, ha[j + 3])};
      const uint32_t vb[2] = {min2(hb[j], sb), min2(sb, hb[j + 3])};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (centre_row(j + u)) {
          key[j + u][0] = max2(key[j + u][0],
                               (own[j + u][0] - va[u]) * kSteps + cst);
          key[j + u][1] = max2(key[j + u][1],
                               (own[j + u][1] - vb[u]) * kSteps + cst);
        }
        own[j + u][0] = va[u];
        own[j + u][1] = vb[u];
      }
    }
    uint32_t* tmp = a;
    a = b;
    b = tmp;
  }

  // Write-back, two rows at a time, each loaded before any is stored
  // (four at a time spill registers).
  constexpr int WB = 2;
  int any = 0;
#pragma unroll
  for (int j0 = 0; j0 < P; j0 += WB) {
    uint8_t old[WB][4];
    int rv[WB][4], dv[WB][4];
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (centre_row(j) && centre_col(i)) {
          const uint32_t k = (key[j][i >> 1] >> (16 * (i & 1))) & 0xFFFFu;
          const int t = kSteps - 1 - static_cast<int>(k % kSteps);
          old[u][i] = f[src_at(j, i)];
          rv[u][i] = t ? static_cast<int>(k / kSteps) - 1
                       : r_in[out_at(j, i)];
          dv[u][i] = t ? base + t : p.d_in[out_at(j, i)];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < WB; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (centre_row(j) && centre_col(i)) {
          const uint8_t v = (own[j][i >> 1] >> (16 * (i & 1))) & 0xFFu;
          const long long o = out_at(j, i);
          out[o] = v;
          r_out[o] = rv[u][i];
          p.d_out[o] = dv[u][i];
          any |= (v != old[u][i]);
        }
      }
    }
  }
  any = __syncthreads_or(any);
  if (any && threadIdx.x == 0) g.changed[cell] = 1;
}

// A launch's block and sub-tile: ncol warps across, nstrip strips down.
struct Shape {
  int ncol, nstrip;
  size_t smem;
};

// The shape that launches the fewest warps for the whole cell (then the
// most blocks, so that blocks stay small, then the widest sub-tile); sets
// g.tb and g.tw.  A warp spans `cols` window columns and each plane row
// holds them and `ring` columns of `esize`-byte pixels more.  The
// sub-tile fills the block: TW = cols * ncol - 2K, TB = kRows * nstrip -
// 2K, each at most the cell's.  False when no shape fits kMaxThreads and
// 227 KB.
bool pick_shape(Geo& g, int cols, int ring, int esize, Shape* out) {
  constexpr int kWarps = kMaxThreads / 32;
  constexpr size_t kSmem = 227 * 1024;
  long long best_warps = -1, best_blocks = 0;
  int best_tw = 0;
  for (int ncol = 1; ncol <= kWarps; ++ncol) {
    for (int nstrip = 1; ncol * nstrip <= kWarps; ++nstrip) {
      const int tw = std::min(g.cell_w, cols * ncol - 2 * g.k);
      const int tb = std::min(g.cell_h, kRows * nstrip - 2 * g.k);
      if (tw < 1 || tb < 1) continue;
      const size_t smem = static_cast<size_t>(2) * (kRows * nstrip + 2)
                          * (cols * ncol + ring) * esize;
      if (smem > kSmem) continue;
      const long long blocks =
          static_cast<long long>((g.cell_h + tb - 1) / tb)
          * ((g.cell_w + tw - 1) / tw);
      const long long warps = blocks * ncol * nstrip;
      const bool better =
          best_warps < 0 || warps < best_warps
          || (warps == best_warps
              && (blocks > best_blocks
                  || (blocks == best_blocks && tw > best_tw)));
      if (better) {
        best_warps = warps;
        best_blocks = blocks;
        best_tw = tw;
        g.tb = tb;
        g.tw = tw;
        *out = Shape{ncol, nstrip, smem};
      }
    }
  }
  return best_warps > 0;
}

// The body (0: qdt_u8_kernel, 1: qdt_pixel_kernel<T>) and block shape of
// a launch of `dtype`: uint8 with K < kSteps takes the packed body (a
// plane row: 128 ncol bytes and a word each side), every other case the
// pixel body (32 ncol pixels and one each side).  Sets g.tb, g.tw,
// g.n_sub_c and *n_sub.  The launchers and qdt_geometry both take their
// shape here.
cudaError_t shape_of(Geo& g, int dtype, int* mode, Shape* sh, int* n_sub) {
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1) return cudaErrorInvalidValue;
  static const int esize[] = {1, 2, 4, 4, 8};
  if (dtype < 0 || dtype > 4) return cudaErrorInvalidValue;
  *mode = dtype == 0 && g.k < kSteps ? 0 : 1;
  const bool ok = *mode == 0 ? pick_shape(g, 128, 8, 1, sh)
                             : pick_shape(g, 32, 2, esize[dtype], sh);
  if (!ok) return cudaErrorInvalidValue;
  *n_sub = morph::sub_tiles(g);
  return *n_sub < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename Kernel>
cudaError_t launch_shape(Kernel kern, const Geo& g, const Planes& p,
                         const Shape& sh, int n_cells, int n_sub,
                         cudaStream_t stream) {
  if (n_cells == 0) return cudaSuccess;
  const cudaError_t e = morph::allow_smem(kern, sh.smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_cells, n_sub), 32 * sh.ncol * sh.nstrip, sh.smem, stream>>>(
      g, p, sh.ncol);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const Geo& g, const Planes& p, const Shape& sh,
                         int mode, int n_cells, int n_sub,
                         cudaStream_t stream) {
  if constexpr (sizeof(T) == 1) {
    if (mode == 0)
      return launch_shape(qdt_u8_kernel, g, p, sh, n_cells, n_sub, stream);
  }
  return launch_shape(qdt_pixel_kernel<T>, g, p, sh, n_cells, n_sub,
                      stream);
}

// dtype codes: 0 uint8, 1 uint16, 2 int32, 3 float32, 4 float64
cudaError_t dispatch(int dtype, const Geo& g0, const Planes& p, int n_cells,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo g = g0;
  Shape sh;
  int mode, ns;
  const cudaError_t e = shape_of(g, dtype, &mode, &sh, &ns);
  if (e != cudaSuccess) return e;
  switch (dtype) {
    case 0: return launch_typed<uint8_t>(g, p, sh, mode, n_cells, ns, s);
    case 1: return launch_typed<uint16_t>(g, p, sh, mode, n_cells, ns, s);
    case 2: return launch_typed<int32_t>(g, p, sh, mode, n_cells, ns, s);
    case 3: return launch_typed<float>(g, p, sh, mode, n_cells, ns, s);
    case 4: return launch_typed<double>(g, p, sh, mode, n_cells, ns, s);
    default: return cudaErrorInvalidValue;
  }
}

// A launcher call's Geo, shape and sub-tiles, as dispatch computes them.
cudaError_t geometry(int dtype, int compact, int rows, int w, int band_h,
                     int cell_w, int k, int bands_per_image, Geo* g,
                     int* n_cells, int* mode, Shape* sh, int* n_sub) {
  *g = morph::launch_geo(compact, rows, w, band_h, cell_w, k,
                         bands_per_image, n_cells);
  return shape_of(*g, dtype, mode, sh, n_sub);
}

}  // namespace

extern "C" {

int qdt_chain_step_launch(int dtype, const void* f, const void* r,
                          const int* d, const int* base, const int* active,
                          void* f_out, void* r_out, int* d_out, int* changed,
                          int h, int w, int band_h, int k,
                          int bands_per_image, void* stream) {
  const Geo g = morph::stack_geo(f, nullptr, active, f_out, changed, w,
                                 band_h, w, k, bands_per_image);
  return dispatch(dtype, g, Planes{r, d, r_out, d_out, base}, h / band_h,
                  stream);
}

int qdt_tile_step_launch(int dtype, const void* f, const void* r,
                         const int* d, const int* base, const int* active,
                         void* f_out, void* r_out, int* d_out, int* changed,
                         int h, int w, int band_h, int tile_w, int k,
                         int bands_per_image, void* stream) {
  const Geo g = morph::stack_geo(f, nullptr, active, f_out, changed, w,
                                 band_h, tile_w, k, bands_per_image);
  return dispatch(dtype, g, Planes{r, d, r_out, d_out, base},
                  (h / band_h) * (w / tile_w), stream);
}

int qdt_compact_step_launch(int dtype, const void* f_patch, const void* r,
                            const int* d, const int* base, const int* valid,
                            void* f_out, void* r_out, int* d_out,
                            int* changed, int cap, int band_h, int tile_w,
                            int k, void* stream) {
  const Geo g = morph::patch_geo(f_patch, nullptr, valid, f_out, changed,
                                 band_h, tile_w, k);
  return dispatch(dtype, g, Planes{r, d, r_out, d_out, base}, cap, stream);
}

// The launch geometry of a launcher call, without launching: a stack of
// `rows` x w cut into band_h x cell_w cells, or (compact = 1) `rows`
// patches of (band_h + 2K) x (cell_w + 2K).  Fills shape = (mode, tb, tw,
// ncol, nstrip, smem, n_sub) and returns 0, or returns the error the
// launcher would.
int qdt_geometry(int dtype, int compact, int rows, int w, int band_h,
                 int cell_w, int k, int bands_per_image, long long* shape) {
  Geo g;
  Shape sh;
  int n_cells, mode, ns;
  const cudaError_t e = geometry(dtype, compact, rows, w, band_h, cell_w, k,
                                 bands_per_image, &g, &n_cells, &mode, &sh,
                                 &ns);
  if (e != cudaSuccess) return e;
  const long long v[7] = {mode, g.tb, g.tw, sh.ncol, sh.nstrip,
                          static_cast<long long>(sh.smem), ns};
  for (int i = 0; i < 7; ++i) shape[i] = v[i];
  return 0;
}

// Every window of that launch (morph::fill_windows: n_cells * n_sub
// blocks, cell-major, ten values each).
int qdt_windows(int dtype, int compact, int rows, int w, int band_h,
                int cell_w, int k, int bands_per_image, long long* windows) {
  Geo g;
  Shape sh;
  int n_cells, mode, ns;
  const cudaError_t e = geometry(dtype, compact, rows, w, band_h, cell_w, k,
                                 bands_per_image, &g, &n_cells, &mode, &sh,
                                 &ns);
  if (e != cudaSuccess) return e;
  morph::fill_windows(g, n_cells, ns, windows);
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

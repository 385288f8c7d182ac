// Fused K-step 3x3 erosion/dilation kernels for Hopper (sm_90a).
//
// Replaces the four Pallas TPU kernels of the main path:
//   chain_step_launch            <- src/repro/kernels/erode_chain.py:60
//                                   chain_step (K fused eps1/delta1)
//   geodesic_chain_step_launch   <- src/repro/kernels/geodesic_chain.py:99
//                                   geodesic_chain_step (row bands)
//   geodesic_tile_step_launch    <- src/repro/kernels/geodesic_chain.py:189
//                                   geodesic_tile_step (band x tile cells)
//   geodesic_compact_step_launch <- src/repro/kernels/geodesic_chain.py:269
//                                   geodesic_compact_step (gathered patches)
//
// Each of the K steps takes the 3x3 min (erosion) or max (dilation) and,
// for the geodesic kernels, clamps it by the mask (max for erosion, min
// for dilation).  Rows outside the cell's image and columns outside the
// array are pinned to the lattice identity (compact patches arrive
// pinned); every launch writes a new buffer, so every halo is read from
// pre-chunk values.  The geodesic kernels set the cell's flag when any
// centre pixel moved (NaN counts as moved), OR-reduced with
// __syncthreads_or; an inactive cell or invalid slot copies its centre
// through and leaves its flag at 0.
//
// What a block does.  A block takes a TB x TW sub-tile of one cell
// (where its (TB+2K) x (TW+2K) window lies: morph_common.cuh's locate)
// and is ncol warps across the window by nstrip strips down it.  Each
// thread owns the same pixels for all K steps: kRows consecutive rows (32
// for a chain, 16 for a geodesic step, whose mask is held in registers
// too) of one window column (morph_pixel_kernel: uint16, int32, float32,
// float64) or of four adjacent columns (morph_u8_kernel).  It reads its
// pixels (and mask pixels) from device memory once, pinned to the
// identity outside the window, the image and the array, and keeps them
// in registers.  Device memory is read in loops that store nothing (the
// compiler cannot tell out from f and m, so a store before a load would
// make the load wait for it); the uint8 write-back loads nothing (f's
// words stay in registers for the flag), the pixel write-back loads the
// old centre before its first store.
//
// A step stores the thread's pixels into a shared-memory plane (ping-pong,
// one barrier a step) and reads back its left and right neighbours; the
// rows just above and below its strip come from the neighbouring strips
// through the plane too.  The 3x3 op is separable: a row op of left, own
// and right, then a column op over three row results, all in registers,
// rolling down the strip with the middle pair shared by two rows.  Every
// step computes the whole block, with no guard: a pixel t - 1 or fewer
// from the block's edge may be wrong after step t (the one-pixel ring
// beyond the block is never written), which after K steps reaches no
// further than K - 1 from the window's edge, so the centre is exact.
// float32 takes its min and max from PTX min.NaN / max.NaN (the
// canonical NaN, as jnp.minimum propagates NaN; the checks compare NaN
// positions), the other pixel dtypes from morph::pick.
//
// uint8 packs: a thread holds each row of its four pixels as the even
// lanes (p0, p2) and the odd lanes (p1, p3) of two 16-bit-lane words.
// With s = op(even, odd) the row op is op(s, (p-1, p1)) for the even
// lanes and op(s, (p2, p4)) for the odd ones: one __byte_perm each from
// the neighbours' plane words and three PTX min.u16x2 / max.u16x2
// (Hopper's 16-bit SIMD); the column op is three more for two rows, the
// clamp one a word.  The plane holds one byte a pixel (one __byte_perm
// packs a row), so a warp spans 128 columns: TW = 128 ncol - 2K, TB =
// kRows nstrip - 2K.  One shape function serves all four launchers: the
// fewest warps for the whole cell, then the most blocks.  At the main
// path's uint8 K = 32 a 512 x 1024 chain band is 24 blocks of 12 warps
// with 128 x 192 centres (ragged at the band's edges) in 192 x 256
// windows, 2.25x the band's pixels; a geodesic band 48 blocks of 15
// warps with 176 x 64 centres in 240 x 128 windows (2.8x); a 64 x 128
// tile or compact cell two 8-warp blocks of 128 x 128 windows (4x).
// repro_torch.analysis.indexmaps models this choice and every block's
// window, and holds them against morph_geometry / morph_windows.
//
// Bound on one H100 SXM (3.35 TB/s; the 67e12/s fp32 non-tensor rate is
// used for every dtype, which keeps it a lower bound).  Per launch the
// function must read each input once and write each output once, and
// its min/max count is 4 per pixel per step (5 with the mask clamp) over
// the pixels it needs: the whole image for the band and tile kernels (a
// tiling's halo recompute is not the function's work), and for a patch
// of the compact kernel the region each step still needs (step s of K:
// the centre and K - s pixels around it).  At paper scale, 8 x 1024 x
// 1024:
//   chain uint8, K=32: 16.8 MB -> 5.0 us; 1.07e9 ops -> 16.0 us: bound
//     by operations.
//   chain float32, K=16: 67.1 MB -> 20.0 us; 5.4e8 ops -> 8.0 us: bound
//     by bytes.
//   geodesic chain uint8, K=32: 25.2 MB -> 7.5 us; 1.34e9 ops ->
//     20.0 us: bound by operations.
//   tile uint8, K=32, 64 x 128 cells, all 1024 active: 25.2 MB ->
//     7.5 us; 1.34e9 ops -> 20.0 us: bound by operations.
//   compact uint8, 512 patches of 128 x 192 (64 x 128 centres): 29.4 MB
//     -> 8.8 us; 1.27e9 ops -> 18.9 us: bound by operations.
// chip_smoke.py recomputes each bound from its run's inputs.  What keeps
// the kernels above them: every step computes the whole block (2.25x
// to 4x the cell's pixels), ~2.5 integer instructions a uint8
// pixel-step (permutes and 16-bit SIMD min/max; the bound counts 4
// min/max a pixel-step at the fp32 rate), a barrier a step behind one
// 16-warp block (or two 8-warp blocks) an SM at 128 registers a thread,
// and a load and a write-back that overlap no other block's steps; which
// of these dominates is not measured.  That keeps chain_step ~9x above
// its bound (0.14 ms on an H100 SXM at 700 W, chip_smoke.py).
//
// ptxas (-O3, sm_90a), registers a thread and bytes spilled: u8 chain
// 128 (16), u8 geodesic 128 (56, in the load and the write-back); pixel
// chain uint16 128 (0), int32 99 (0), float 102 (0), double 123 (0);
// pixel geodesic uint16 128 (32), int32 116 (0), float 116 (0), double
// 128 (20).  A K that no block shape covers returns
// cudaErrorInvalidValue: above 127 (uint8 chain), 63 (uint8 geodesic
// step, uint16 to float32 chain), 47 (float64 chain) or 39 (geodesic
// step of the pixel body); the planner's fuse_k is 16 or 32.

#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "morph_common.cuh"

namespace {

using morph::Geo;
using morph::Lattice;
using morph::max2;
using morph::min2;
using morph::pick;
using morph::Window;

// Rows of the strip that each thread owns: 32 for a chain, 16 for a
// geodesic step, whose mask takes registers too.
template <bool GEO>
constexpr int kRows = GEO ? 16 : 32;

// Threads a block may have (128 registers a thread).
constexpr int kMaxThreads = 512;

// The step's min (MIN) or max, propagating NaN: PTX min.NaN / max.NaN
// for float32 (the canonical NaN), morph::pick for the rest.
template <typename T, bool MIN>
struct Op {
  __device__ __forceinline__ static T f(T a, T b) { return pick<T, MIN>(a, b); }
};
template <bool MIN>
struct Op<float, MIN> {
  __device__ __forceinline__ static float f(float a, float b) {
    return MIN ? morph::min_nan(a, b) : morph::max_nan(a, b);
  }
};

// The same on two words of 16-bit lanes.
template <bool MIN>
__device__ __forceinline__ uint32_t op2(uint32_t a, uint32_t b) {
  return MIN ? min2(a, b) : max2(a, b);
}

// An inactive cell or invalid slot: the sub-tile's centre of f copied
// through, eight pixels a thread loaded before any is stored.
template <typename T>
__device__ __forceinline__ void pass_through(const Geo& g, const Window& w) {
  constexpr int B = 8;
  const T* f = static_cast<const T*>(g.f);
  T* out = static_cast<T*>(g.out);
  const int K = g.k, n = w.tb * w.tw, step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += B * step) {
    T v[B];
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int i = i0 + k * step;
      if (i < n)
        v[k] = f[(w.wr + K + i / w.tw) * g.src_w + w.wc + K + i % w.tw];
    }
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const int i = i0 + k * step;
      if (i < n) out[(w.orow + i / w.tw) * g.out_w + w.ocol + i % w.tw] = v[k];
    }
  }
}

// The changed flag of the cell: any thread's `any`, OR-reduced.
__device__ __forceinline__ void flag_changed(const Geo& g, int any) {
  any = __syncthreads_or(any);
  if (any && threadIdx.x == 0) g.changed[blockIdx.x] = 1;
}

// One pixel a thread: window column (warp % ncol) * 32 + lane, rows
// (warp / ncol) * kRows onwards.
template <typename T, bool MIN, bool GEO>
__global__ void __launch_bounds__(kMaxThreads)
    morph_pixel_kernel(Geo g, int ncol) {
  using O = Op<T, MIN>;
  using C = Op<T, !MIN>;  // the mask clamp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = kRows<GEO>;
  const int K = g.k;
  const Window w = morph::locate(g, blockIdx.x, blockIdx.y);
  if (g.active != nullptr && g.active[blockIdx.x] == 0) {
    pass_through<T>(g, w);
    return;
  }
  const T* f = static_cast<const T*>(g.f);
  const T* m = static_cast<const T*>(g.m);
  T* out = static_cast<T*>(g.out);
  const T id = MIN ? Lattice<T>::hi() : Lattice<T>::lo();

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

  // The strip of f (and of the mask), pinned to the identity outside the
  // window, the cell's image and the array.
  T own[P], mk[P];
  const bool col_in = c < w.WW && gc >= 0 && gc < g.src_w;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long gr = w.wr + r0 + j;
    const bool in = col_in && r0 + j < w.WH && gr >= w.rlo && gr < w.rhi;
    own[j] = in ? f[src_at(j)] : id;
    if (GEO) mk[j] = in ? m[src_at(j)] : id;
  }

  // Planes hold the block's rows and columns and a one-pixel ring that is
  // never written (see the header).
  const int S = 32 * ncol + 2;
  const int plane = (static_cast<int>(blockDim.x) / (32 * ncol) * P + 2) * S;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  const int at = (r0 + 1) * S + c + 1;  // window pixel (r0, c)

  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[at + j * S] = own[j];
    __syncthreads();
    // row ops of rows j - 1 .. j + 2, rolling; rows -1 and P are the
    // next strips'
    const T* up = a + at - S;
    T hm = O::f(O::f(up[-1], up[0]), up[1]);
    T h0 = O::f(O::f(a[at - 1], own[0]), a[at + 1]);
#pragma unroll
    for (int j = 0; j < P; j += 2) {
      const T* r1 = a + at + (j + 1) * S;
      const T* r2 = r1 + S;
      const T h1 = O::f(O::f(r1[-1], own[j + 1]), r1[1]);
      const T mid2 = j + 2 < P ? own[min(j + 2, P - 1)] : r2[0];
      const T h2 = O::f(O::f(r2[-1], mid2), r2[1]);
      const T s = O::f(h0, h1);  // shared by rows j, j + 1
      T v0 = O::f(hm, s), v1 = O::f(s, h2);
      if (GEO) {
        v0 = C::f(v0, mk[j]);
        v1 = C::f(v1, mk[j + 1]);
      }
      own[j] = v0;
      own[j + 1] = v1;
      hm = h1;
      h0 = h2;
    }
    T* tmp = a;
    a = b;
    b = tmp;
  }

  // Write-back: the old centre (for the flag) loaded before any store.
  T old[P];
  if (GEO) {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (centre(j)) old[j] = f[src_at(j)];
  }
  int any = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (centre(j)) {
      out[out_at(j)] = own[j];
      if (GEO) any |= (own[j] != old[j]);
    }
  }
  if (GEO) flag_changed(g, any);
}

// The row op of one row of four pixels (p0 .. p3) held as lanes ev =
// (p0, p2) and ov = (p1, p3), with the left and right neighbours' words
// l and r (bytes p-4 .. p-1 and p4 .. p7): he = op(p-1, p0, p1) and
// op(p1, p2, p3), ho = op(p0, p1, p2) and op(p2, p3, p4).
template <bool MIN>
__device__ __forceinline__ void row_op(uint32_t ev, uint32_t ov, uint32_t l,
                                       uint32_t r, uint32_t& he,
                                       uint32_t& ho) {
  const uint32_t s = op2<MIN>(ev, ov);  // op(p0, p1), op(p2, p3)
  he = op2<MIN>(s, __byte_perm(ov, l, 0x1017));  // with (p-1, p1)
  ho = op2<MIN>(s, __byte_perm(ev, r, 0x1412));  // with (p2, p4)
}

// A word of four pixels as its even and odd 16-bit lanes, and back.
__device__ __forceinline__ uint32_t even(uint32_t word) {
  return __byte_perm(word, 0, 0x4240);  // (p0, p2)
}
__device__ __forceinline__ uint32_t odd(uint32_t word) {
  return __byte_perm(word, 0, 0x4341);  // (p1, p3)
}
__device__ __forceinline__ uint32_t pack(uint32_t ev, uint32_t ov) {
  return __byte_perm(ev, ov, 0x6240);  // (p0, p1, p2, p3)
}

// uint8, four pixels a thread: window columns 4q .. 4q + 3, q = (warp %
// ncol) * 32 + lane, rows (warp / ncol) * kRows onwards, each row held
// as its even and odd 16-bit lanes.
template <bool MIN, bool GEO>
__global__ void __launch_bounds__(kMaxThreads)
    morph_u8_kernel(Geo g, int ncol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = kRows<GEO>;
  const int K = g.k;
  const Window w = morph::locate(g, blockIdx.x, blockIdx.y);
  if (g.active != nullptr && g.active[blockIdx.x] == 0) {
    pass_through<uint8_t>(g, w);
    return;
  }
  const uint8_t* f = static_cast<const uint8_t*>(g.f);
  const uint8_t* m = static_cast<const uint8_t*>(g.m);
  uint8_t* out = static_cast<uint8_t*>(g.out);
  const uint32_t id = MIN ? 0xFFu : 0u;

  const int warp = threadIdx.x >> 5;
  const int q = (warp % ncol) * 32 + (threadIdx.x & 31);
  const int c0 = 4 * q;
  const int r0 = (warp / ncol) * P;
  const auto centre_row = [&](int j) {
    return r0 + j >= K && r0 + j < K + w.tb;
  };
  // columns in the window and the array, and the centre's bytes
  bool col_in[4];
  bool all_in = true;
  uint32_t cmask = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long gc = w.wc + c0 + i;
    col_in[i] = c0 + i < w.WW && gc >= 0 && gc < g.src_w;
    all_in = all_in && col_in[i];
    if (c0 + i >= K && c0 + i < K + w.tw) cmask |= 0xFFu << (8 * i);
  }
  // row j of src as one word (byte i: column c0 + i), pinned to id
  // outside the window, the cell's image and the array
  const auto load = [&](const uint8_t* src, int j) -> uint32_t {
    const long long gr = w.wr + r0 + j;
    const bool row_in = r0 + j < w.WH && gr >= w.rlo && gr < w.rhi;
    const long long o = gr * g.src_w + w.wc + c0;
    if (row_in && all_in
        && ((reinterpret_cast<uintptr_t>(src) + o) & 3) == 0)
      return *reinterpret_cast<const uint32_t*>(src + o);
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      word |= (row_in && col_in[i] ? src[o + i] : id) << (8 * i);
    return word;
  };

  // The strip (and the mask's) as lanes; f's words for the flag.
  uint32_t e[P], o[P], me[P], mo[P], f0[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const uint32_t word = load(f, j);
    if (GEO) {
      const uint32_t mw = load(m, j);
      me[j] = even(mw);
      mo[j] = odd(mw);
      f0[j] = word;
    }
    e[j] = even(word);
    o[j] = odd(word);
  }

  // Planes of one byte a pixel: the block's rows and columns and a ring
  // of one row and one word of columns that is never written.
  const int S = 32 * ncol + 2;  // words a row
  const int plane = (static_cast<int>(blockDim.x) / (32 * ncol) * P + 2) * S;
  uint32_t* a = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* b = a + plane;
  const int at = (r0 + 1) * S + q + 1;  // window pixels (r0, c0 .. c0 + 3)

  for (int t = 0; t < K; ++t) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[at + j * S] = pack(e[j], o[j]);
    __syncthreads();
    // row ops of rows j - 1 .. j + 2, rolling; rows -1 and P are the
    // next strips'
    uint32_t hme, hmo, h0e, h0o;
    {
      const uint32_t* up = a + at - S;
      const uint32_t word = up[0];
      row_op<MIN>(even(word), odd(word), up[-1], up[1], hme, hmo);
      row_op<MIN>(e[0], o[0], a[at - 1], a[at + 1], h0e, h0o);
    }
#pragma unroll
    for (int j = 0; j < P; j += 2) {
      const uint32_t* r1 = a + at + (j + 1) * S;
      const uint32_t* r2 = r1 + S;
      uint32_t h1e, h1o, h2e, h2o;
      row_op<MIN>(e[j + 1], o[j + 1], r1[-1], r1[1], h1e, h1o);
      if (j + 2 < P) {
        const int n = min(j + 2, P - 1);
        row_op<MIN>(e[n], o[n], r2[-1], r2[1], h2e, h2o);
      } else {
        const uint32_t word = r2[0];
        row_op<MIN>(even(word), odd(word), r2[-1], r2[1], h2e, h2o);
      }
      const uint32_t se = op2<MIN>(h0e, h1e), so = op2<MIN>(h0o, h1o);
      uint32_t v0e = op2<MIN>(hme, se), v1e = op2<MIN>(se, h2e);
      uint32_t v0o = op2<MIN>(hmo, so), v1o = op2<MIN>(so, h2o);
      if (GEO) {
        v0e = op2<!MIN>(v0e, me[j]);
        v0o = op2<!MIN>(v0o, mo[j]);
        v1e = op2<!MIN>(v1e, me[j + 1]);
        v1o = op2<!MIN>(v1o, mo[j + 1]);
      }
      e[j] = v0e;
      o[j] = v0o;
      e[j + 1] = v1e;
      o[j + 1] = v1o;
      hme = h1e;
      hmo = h1o;
      h0e = h2e;
      h0o = h2o;
    }
    uint32_t* tmp = a;
    a = b;
    b = tmp;
  }

  // Write-back: nothing is loaded; a whole aligned centre word at once.
  int any = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (centre_row(j)) {
      const uint32_t word = pack(e[j], o[j]);
      if (GEO) any |= ((word ^ f0[j]) & cmask) != 0;
      const long long at_out =
          (w.orow + r0 + j - K) * g.out_w + w.ocol + c0 - K;
      if (cmask == 0xFFFFFFFFu
          && ((reinterpret_cast<uintptr_t>(out) + at_out) & 3) == 0) {
        *reinterpret_cast<uint32_t*>(out + at_out) = word;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if ((cmask >> (8 * i)) & 1)
            out[at_out + i] = static_cast<uint8_t>(word >> (8 * i));
      }
    }
  }
  if (GEO) flag_changed(g, any);
}

// A launch's block and sub-tile: ncol warps across, nstrip strips down.
struct Shape {
  int ncol, nstrip;
  size_t smem;
};

// The shape of every launcher: the one that launches the fewest warps for
// the whole cell (then the most blocks, so that blocks stay small, then
// the widest sub-tile); sets g.tb and g.tw.  A warp spans `cols` window
// columns and each plane row holds them and `ring` columns of
// `esize`-byte pixels more.  The sub-tile fills the block: TW = cols *
// ncol - 2K, TB = rows * nstrip - 2K, each at most the cell's.  False
// when no shape fits kMaxThreads and 227 KB.
bool pick_shape(Geo& g, int rows, int cols, int ring, int esize,
                Shape* out) {
  constexpr int kWarps = kMaxThreads / 32;
  constexpr size_t kSmem = 227 * 1024;
  long long best_warps = -1, best_blocks = 0;
  int best_tw = 0;
  for (int ncol = 1; ncol <= kWarps; ++ncol) {
    for (int nstrip = 1; ncol * nstrip <= kWarps; ++nstrip) {
      const int tw = std::min(g.cell_w, cols * ncol - 2 * g.k);
      const int tb = std::min(g.cell_h, rows * nstrip - 2 * g.k);
      if (tw < 1 || tb < 1) continue;
      const size_t smem = static_cast<size_t>(2) * (rows * nstrip + 2)
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

// The body (0: morph_u8_kernel, 1: morph_pixel_kernel<T>) and block
// shape of a launch of `dtype`: uint8 takes the packed body (a plane
// row: 128 ncol bytes and a word each side), every other dtype the pixel
// body (32 ncol pixels and one each side).  Sets g.tb, g.tw, g.n_sub_c
// and *n_sub.  The launchers and morph_geometry both take their shape
// here.
cudaError_t shape_of(Geo& g, int dtype, bool geo, int* mode, Shape* sh,
                     int* n_sub) {
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1) return cudaErrorInvalidValue;
  static const int esize[] = {1, 2, 4, 4, 8};
  if (dtype < 0 || dtype > 4) return cudaErrorInvalidValue;
  const int rows = geo ? kRows<true> : kRows<false>;
  *mode = dtype == 0 ? 0 : 1;
  const bool ok = *mode == 0
                      ? pick_shape(g, rows, 128, 8, 1, sh)
                      : pick_shape(g, rows, 32, 2, esize[dtype], sh);
  if (!ok) return cudaErrorInvalidValue;
  *n_sub = morph::sub_tiles(g);
  return *n_sub < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename Kernel>
cudaError_t launch_shape(Kernel kern, const Geo& g, const Shape& sh,
                         int n_cells, int n_sub, cudaStream_t stream) {
  if (n_cells == 0) return cudaSuccess;
  const cudaError_t e = morph::allow_smem(kern, sh.smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_cells, n_sub), 32 * sh.ncol * sh.nstrip, sh.smem, stream>>>(
      g, sh.ncol);
  return cudaGetLastError();
}

template <typename T, bool MIN, bool GEO>
cudaError_t launch_one(const Geo& g, const Shape& sh, int n_cells, int n_sub,
                       cudaStream_t stream) {
  if constexpr (std::is_same<T, uint8_t>::value)
    return launch_shape(morph_u8_kernel<MIN, GEO>, g, sh, n_cells, n_sub,
                        stream);
  else
    return launch_shape(morph_pixel_kernel<T, MIN, GEO>, g, sh, n_cells,
                        n_sub, stream);
}

template <typename T>
cudaError_t launch_typed(const Geo& g, const Shape& sh, bool is_min,
                         bool geo, int n_cells, int n_sub,
                         cudaStream_t stream) {
  if (is_min) {
    return geo ? launch_one<T, true, true>(g, sh, n_cells, n_sub, stream)
               : launch_one<T, true, false>(g, sh, n_cells, n_sub, stream);
  }
  return geo ? launch_one<T, false, true>(g, sh, n_cells, n_sub, stream)
             : launch_one<T, false, false>(g, sh, n_cells, n_sub, stream);
}

// dtype codes: 0 uint8, 1 uint16, 2 int32, 3 float32, 4 float64
cudaError_t dispatch(int dtype, const Geo& g0, int is_min, int geo,
                     int n_cells, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Geo g = g0;
  Shape sh;
  int mode, ns;
  const cudaError_t e = shape_of(g, dtype, geo != 0, &mode, &sh, &ns);
  if (e != cudaSuccess) return e;
  switch (dtype) {
    case 0: return launch_typed<uint8_t>(g, sh, is_min, geo, n_cells, ns, s);
    case 1: return launch_typed<uint16_t>(g, sh, is_min, geo, n_cells, ns, s);
    case 2: return launch_typed<int32_t>(g, sh, is_min, geo, n_cells, ns, s);
    case 3: return launch_typed<float>(g, sh, is_min, geo, n_cells, ns, s);
    case 4: return launch_typed<double>(g, sh, is_min, geo, n_cells, ns, s);
    default: return cudaErrorInvalidValue;
  }
}

// A launcher call's Geo, shape and sub-tiles, as dispatch computes them.
cudaError_t geometry(int dtype, int geo, int compact, int rows, int w,
                     int band_h, int cell_w, int k, int bands_per_image,
                     Geo* g, int* n_cells, int* mode, Shape* sh, int* n_sub) {
  *g = morph::launch_geo(compact, rows, w, band_h, cell_w, k,
                         bands_per_image, n_cells);
  return shape_of(*g, dtype, geo != 0, mode, sh, n_sub);
}

}  // namespace

extern "C" {

int chain_step_launch(int dtype, int is_min, const void* x, void* out, int h,
                      int w, int band_h, int k, int bands_per_image,
                      void* stream) {
  const Geo g = morph::stack_geo(x, nullptr, nullptr, out, nullptr, w,
                                 band_h, w, k, bands_per_image);
  return dispatch(dtype, g, is_min, 0, h / band_h, stream);
}

int geodesic_chain_step_launch(int dtype, int is_min, const void* f,
                               const void* m, const int* active, void* out,
                               int* changed, int h, int w, int band_h, int k,
                               int bands_per_image, void* stream) {
  const Geo g = morph::stack_geo(f, m, active, out, changed, w, band_h, w,
                                 k, bands_per_image);
  return dispatch(dtype, g, is_min, 1, h / band_h, stream);
}

int geodesic_tile_step_launch(int dtype, int is_min, const void* f,
                              const void* m, const int* active, void* out,
                              int* changed, int h, int w, int band_h,
                              int tile_w, int k, int bands_per_image,
                              void* stream) {
  const Geo g = morph::stack_geo(f, m, active, out, changed, w, band_h,
                                 tile_w, k, bands_per_image);
  return dispatch(dtype, g, is_min, 1, (h / band_h) * (w / tile_w), stream);
}

int geodesic_compact_step_launch(int dtype, int is_min, const void* f_patch,
                                 const void* m_patch, const int* valid,
                                 void* out, int* changed, int cap, int band_h,
                                 int tile_w, int k, void* stream) {
  const Geo g = morph::patch_geo(f_patch, m_patch, valid, out, changed,
                                 band_h, tile_w, k);
  return dispatch(dtype, g, is_min, 1, cap, stream);
}

// The launch geometry of a launcher call, without launching: a stack of
// `rows` x w cut into band_h x cell_w cells (geodesic_*: geo = 1), or
// (compact = 1) `rows` patches of (band_h + 2K) x (cell_w + 2K).  Fills
// shape = (mode, tb, tw, ncol, nstrip, smem, n_sub) and returns 0, or
// returns the error the launcher would.
int morph_geometry(int dtype, int geo, int compact, int rows, int w,
                   int band_h, int cell_w, int k, int bands_per_image,
                   long long* shape) {
  Geo g;
  Shape sh;
  int n_cells, mode, ns;
  const cudaError_t e = geometry(dtype, geo, compact, rows, w, band_h,
                                 cell_w, k, bands_per_image, &g, &n_cells,
                                 &mode, &sh, &ns);
  if (e != cudaSuccess) return e;
  const long long v[7] = {mode, g.tb, g.tw, sh.ncol, sh.nstrip,
                          static_cast<long long>(sh.smem), ns};
  for (int i = 0; i < 7; ++i) shape[i] = v[i];
  return 0;
}

// Every window of that launch (morph::fill_windows: n_cells * n_sub
// blocks, cell-major, ten values each).
int morph_windows(int dtype, int geo, int compact, int rows, int w,
                  int band_h, int cell_w, int k, int bands_per_image,
                  long long* windows) {
  Geo g;
  Shape sh;
  int n_cells, mode, ns;
  const cudaError_t e = geometry(dtype, geo, compact, rows, w, band_h,
                                 cell_w, k, bands_per_image, &g, &n_cells,
                                 &mode, &sh, &ns);
  if (e != cudaSuccess) return e;
  morph::fill_windows(g, n_cells, ns, windows);
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

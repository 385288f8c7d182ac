// Fused K-step generalised-geodesic-distance chunk for Hopper (sm_90a):
// the grey-weighted distance of repro.gdt.
//
// Replaces the three Pallas TPU kernels of the gdt path:
//   gdt_chain_step_launch   <- src/repro/kernels/gdt_chain.py:150
//                              gdt_chain_step (row bands)
//   gdt_tile_step_launch    <- src/repro/kernels/gdt_chain.py:236
//                              gdt_tile_step (band x tile cells)
//   gdt_compact_step_launch <- src/repro/kernels/gdt_chain.py:312
//                              gdt_compact_step (gathered patches)
//
// Each of the K steps relaxes the distance plane d over the 8-neighbours
// q of every pixel p,
//     d'(p) = min(d(p), min_q d(q) + w(p, q)),  w = 1 + |lamb*|i(p)-i(q)||,
// and then pins d' = +inf wherever the seed/pad plane s < 0.  The weight
// rounds as the reference's does: lamb*|di| rounds, 1 + . rounds, then
// d(q) + w rounds.  -O3 lets nvcc contract a multiply and an add into one
// fused multiply-add (one rounding), so the weight is written with
// __fmul_rn/__fadd_rn (__dmul_rn/__dadd_rn for double), which are never
// contracted.  lamb arrives as a double and is cast to T once, the
// rounding of float32(lamb) in jnp and torch.  lamb == 0 is its own
// instance (kUnit): weight exactly 1, no multiply, no i plane.  The min
// propagates NaN, as jnp.minimum does (PTX min.NaN for float32,
// morph::pick for float64); a NaN seed is not a pad (NaN < 0 is false).
//
// What a block does.  A block takes a TB x TW sub-tile of one cell
// (where its (TB+2K) x (TW+2K) window lies: morph_common.cuh's locate)
// and is ncol warps across the window by nstrip strips down it.  Each
// thread owns one window column and kRows = 16 consecutive rows of it
// for the whole launch: it reads its pixels of d, i and s from device
// memory once, pinned outside the window, the cell's image and the array
// to the planes' identities (d -> +inf, i -> 0, s -> -1; compact patches
// arrive pinned and a window never leaves its patch), and keeps its d
// values and its pad bits (s < 0) in registers.  Weights: for float32
// with lamb != 0 (kReg) one pass after the load computes each owned
// pixel's weights from the i window, staged in shared memory, and keeps
// them in registers for the K steps.  w(p, q) = w(q, p) bit for bit (a
// rounded difference only changes sign when its operands swap, and |.|
// drops the sign, of NaN and inf too), so a vertical weight serves both
// rows it joins: 7 registers a pixel.  float64, and K >= 32 where the
// 12-warp register instance has no shape, keep the i window in shared
// memory and recompute the weights each step (kIwin); lamb == 0 has
// none (kUnit).  A step reads the neighbours' d from the previous
// step's shared-memory plane (ping-pong, one barrier a step): walking
// down its strip a thread reads each row of the left and right columns
// once and its own column from registers, about 2 loads and 1 store a
// pixel-step.  Every step computes the whole block, with no guard: a
// pixel t - 1 or fewer from the window's edge may be wrong after step t
// (the ring beyond the window is never written), which after K steps
// reaches no further than K - 1 from the edge, so the centre is exact.
// Shared memory: 2 planes (3 for kIwin) of (16 nstrip + 2) x (32 ncol
// + 2) pixels, the block's rows and columns and that one-pixel ring.
// The launcher picks (ncol, nstrip) and the sub-tile that fills it (TW
// = 32 ncol - 2K, TB = 16 nstrip - 2K, at most the cell's) with the
// fewest warps for the whole cell: at K = 16 a 64x128 cell takes four
// 32x64 sub-tiles of 12 warps (64x96 windows, 51.7 KB in float32).  A
// whole cell in one block (a 96x160 window) would need 15,360 pixels of
// weights, ~108 K registers, more than an SM's 64 K.  An inactive cell
// or invalid slot copies d through and leaves its flag at 0; the
// changed flag is "any centre pixel moved" (NaN counts as moved),
// OR-reduced with __syncthreads_or.  Every launch writes a new buffer,
// so halos are read from pre-chunk values.
//
// Bound on one H100 SXM (3.35 TB/s, 67e12/s fp32 non-tensor).  Per launch
// the function reads d, i and s once and writes d once; its operations
// are the weights once per pixel (8 x: subtract, abs, multiply, add),
// then 8 adds, 8 mins and the clamp per pixel per step.  At 8 x 1024 x
// 1024 float32, K=16, one all-active tile launch: 134 MB -> 40.1 us,
// against 2.55e9 ops -> 38.0 us: bound by bytes.  chip_smoke.py
// recomputes the bounds from its run's inputs.  The step loop runs ~24
// instructions a pixel-step (8 adds, 8 min.NaN, the pad select, 2 loads
// and a store) over 3x the centre's pixels; besides the steps a
// launch loads, computes the weights and writes back, which one block
// per SM (kReg's registers) cannot overlap with another block's steps.
// That keeps the kernel ~15x above the bound (0.595 ms on an H100 SXM
// at 700 W, chip_smoke.py).
//
// ptxas (-O3, sm_90a), registers a thread and bytes spilled: kReg float
// 168 (36, all outside the step loop), kIwin float 116 (0), kUnit float
// 79 (0), kIwin double 128 (12), kUnit double 117 (0).

#include <algorithm>

#include "morph_common.cuh"

namespace {

using morph::Geo;
using morph::Lattice;
using morph::pick;
using morph::Window;

__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float abs_of(float a) { return fabsf(a); }
__device__ __forceinline__ double abs_of(double a) { return fabs(a); }

// 1 + |lamb * |ip - iq||, each operation rounded on its own.
template <typename T>
__device__ __forceinline__ T weight(T lamb, T ip, T iq) {
  return add_rn(T(1), abs_of(mul_rn(lamb, abs_of(sub_rn(ip, iq)))));
}

// Where a launch keeps its weights.
enum Mode {
  kUnit = 0,  // lamb == 0: every weight is 1, no i plane
  kReg = 1,   // computed once a launch, held in registers for the K steps
  kIwin = 2,  // recomputed each step from an i window in shared memory
};

// Rows of the column strip that each thread owns.
constexpr int kRows = 16;

// Threads a block may have; kReg's weights need 168 registers a thread.
template <int MODE>
constexpr int max_threads() { return MODE == kReg ? 384 : 512; }

// Window planes in shared memory: d twice (ping-pong), and for kIwin the
// i window (kReg stages i in the second d plane, which is free until
// the first step writes it).
template <int MODE>
constexpr int n_planes() { return MODE == kIwin ? 3 : 2; }

// A pixel's 3x3 neighbourhood in one plane.
template <typename T>
struct Nb {
  T nw, n, ne, w, c, e, sw, s, se;
};

// Walks a thread's column strip down one shared-memory plane: each row
// reads the left and right columns once, a row ahead of its use; the
// own column's rows come from the caller, who may hold them in
// registers.
template <typename T, int P>
struct Strip {
  const T* p;  // the plane at the strip's first pixel
  int S;       // row stride
  T lm, l0, lp, rm, r0, rp;  // left and right columns at rows j-1, j, j+1
  __device__ __forceinline__ Strip(const T* at, int stride)
      : p(at), S(stride), lm(at[-stride - 1]), l0(at[-1]),
        lp(at[stride - 1]), rm(at[-stride + 1]), r0(at[1]),
        rp(at[stride + 1]) {}
  // Row j's neighbourhood, given the own column at rows j - 1, j, j + 1.
  __device__ __forceinline__ Nb<T> next(int j, T up, T cur, T dn) {
    const Nb<T> nb{lm, up, rm, l0, cur, r0, lp, dn, rp};
    lm = l0;
    l0 = lp;
    rm = r0;
    r0 = rp;
    if (j + 2 <= P) {  // row j + 2 lies in the plane
      lp = p[(j + 2) * S - 1];
      rp = p[(j + 2) * S + 1];
    }
    return nb;
  }
};

// The min that propagates NaN, as jnp.minimum does: a NaN operand wins.
// float32 takes one instruction (PTX min.NaN, whose NaN is the canonical
// one); float64 has none and takes morph::pick.
__device__ __forceinline__ float nan_min(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ double nan_min(double a, double b) {
  return pick<double, true>(a, b);
}

// min(d(p), min_q d(q) + w(p, q)) over the 8 neighbours, as a tree: a
// min that propagates NaN gives the same value in any order.
template <typename T>
__device__ __forceinline__ T relax(T own, const Nb<T>& d, T wnw, T wn,
                                   T wne, T ww, T we, T wsw, T ws, T wse) {
  const T a = nan_min(add_rn(d.nw, wnw), add_rn(d.n, wn));
  const T b = nan_min(add_rn(d.ne, wne), add_rn(d.w, ww));
  const T c = nan_min(add_rn(d.e, we), add_rn(d.sw, wsw));
  const T e = nan_min(add_rn(d.s, ws), add_rn(d.se, wse));
  return nan_min(own, nan_min(nan_min(a, b), nan_min(c, e)));
}

// Geo.f is the d plane, Geo.m the i plane.  The block is ncol warps
// across the window by blockDim.x / (32 * ncol) strips down it: thread
// (lane, warp) owns window column (warp % ncol) * 32 + lane, rows
// (warp / ncol) * kRows onwards, for the whole launch.
template <typename T, int MODE>
__global__ void __launch_bounds__(max_threads<MODE>())
    gdt_kernel(Geo g, const T* s, T lamb, int ncol) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int P = kRows;
  const int K = g.k;
  const int cell = blockIdx.x;
  const Window w = morph::locate(g, cell, blockIdx.y);
  const T* d = static_cast<const T*>(g.f);
  const T* im = static_cast<const T*>(g.m);
  T* out = static_cast<T*>(g.out);

  const int warp = threadIdx.x >> 5;
  const int c = (warp % ncol) * 32 + (threadIdx.x & 31);
  const int r0 = (warp / ncol) * P;
  const long long gc = w.wc + c;
  const bool centre_col = c >= K && c < K + w.tw;

  // Device memory is read in loops that store nothing: the compiler
  // cannot tell out or shared memory from d, i and s, so a store of a
  // loaded value would make every later load wait for it, and a strip's
  // loads would go one at a time.
  const auto centre = [&](int j) {
    return centre_col && r0 + j >= K && r0 + j < K + w.tb;
  };
  const auto out_at = [&](int j) {
    return (w.orow + r0 + j - K) * g.out_w + w.ocol + c - K;
  };
  T old[P];
  const auto read_centre = [&]() {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (centre(j)) old[j] = d[(w.wr + r0 + j) * g.src_w + gc];
  };

  if (g.active != nullptr && g.active[cell] == 0) {
    // converged cell / sentinel slot: d passes through, flag stays 0
    read_centre();
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (centre(j)) out[out_at(j)] = old[j];
    return;
  }

  // Planes hold the block's rows and columns and a one-pixel ring that is
  // never written (see the step loop).
  const int S = 32 * ncol + 2;
  const int plane = (static_cast<int>(blockDim.x) / (32 * ncol) * P + 2) * S;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  T* iw = MODE == kIwin ? b + plane : b;
  const int at = (r0 + 1) * S + c + 1;  // window pixel (r0, c)
  const T inf = Lattice<T>::hi();

  // The strip, pinned outside the window, the cell's image and the
  // array: d -> +inf, i -> 0, s -> -1 (a pad).
  T own[P], iv[P], sv[P];
  const bool col_in = c < w.WW && gc >= 0 && gc < g.src_w;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long gr = w.wr + r0 + j;
    const bool in = col_in && r0 + j < w.WH && gr >= w.rlo && gr < w.rhi;
    const long long src = gr * g.src_w + gc;
    own[j] = in ? d[src] : inf;
    if (MODE != kUnit) iv[j] = in ? im[src] : T(0);
    sv[j] = in ? s[src] : T(-1);
  }
  unsigned pad = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (sv[j] < T(0)) pad |= 1u << j;
    a[at + j * S] = own[j];
    if (MODE != kUnit) iw[at + j * S] = iv[j];
  }
  __syncthreads();

  // kReg: each pixel's weights, computed once.  wv[j] joins rows j - 1
  // and j: the north weight of row j and, since w(p, q) = w(q, p), the
  // south weight of row j - 1.
  T wv[P + 1], wnw[P], wne[P], ww[P], we[P], wsw[P], wse[P];
  if constexpr (MODE == kReg) {
    Strip<T, P> si(iw + at, S);
    T up = iw[at - S], cur = iw[at];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T dn = iw[at + (j + 1) * S];
      const Nb<T> i3 = si.next(j, up, cur, dn);
      wnw[j] = weight(lamb, cur, i3.nw);
      wv[j] = weight(lamb, cur, i3.n);
      wne[j] = weight(lamb, cur, i3.ne);
      ww[j] = weight(lamb, cur, i3.w);
      we[j] = weight(lamb, cur, i3.e);
      wsw[j] = weight(lamb, cur, i3.sw);
      wse[j] = weight(lamb, cur, i3.se);
      if (j == P - 1) wv[P] = weight(lamb, cur, dn);
      up = cur;
      cur = dn;
    }
    __syncthreads();  // b is the first step's output
  }

  // Every step computes the whole block.  A pixel t - 1 or fewer from
  // the window's edge may be wrong after step t (its neighbours beyond
  // the window are the ring's), which reaches row and column K - 1 at
  // most after K steps: the centre is exact, with no guard in the loop.
  for (int t = 0; t < K; ++t) {
    Strip<T, P> sd(a + at, S);
    T up = a[at - S];
    Strip<T, P> si(iw + at, S);  // kIwin only
    T iup = T(0), icur = T(0);
    if constexpr (MODE == kIwin) {
      iup = iw[at - S];
      icur = iw[at];
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const T cur = own[j];
      const T dn = j + 1 < P ? own[j + 1] : a[at + P * S];
      const Nb<T> d3 = sd.next(j, up, cur, dn);
      T best;
      if constexpr (MODE == kUnit) {
        best = relax(cur, d3, T(1), T(1), T(1), T(1), T(1), T(1), T(1),
                     T(1));
      } else if constexpr (MODE == kReg) {
        best = relax(cur, d3, wnw[j], wv[j], wne[j], ww[j], we[j], wsw[j],
                     wv[j + 1], wse[j]);
      } else {
        const T idn = iw[at + (j + 1) * S];
        const Nb<T> i3 = si.next(j, iup, icur, idn);
        best = relax(cur, d3, weight(lamb, icur, i3.nw),
                     weight(lamb, icur, i3.n), weight(lamb, icur, i3.ne),
                     weight(lamb, icur, i3.w), weight(lamb, icur, i3.e),
                     weight(lamb, icur, i3.sw), weight(lamb, icur, i3.s),
                     weight(lamb, icur, i3.se));
        iup = icur;
        icur = idn;
      }
      own[j] = (pad >> j) & 1u ? inf : best;
      b[at + j * S] = own[j];
      up = cur;
    }
    __syncthreads();
    T* tmp = a;
    a = b;
    b = tmp;
  }

  read_centre();
  int any = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (centre(j)) {
      out[out_at(j)] = own[j];
      any |= (own[j] != old[j]);
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
// fewest blocks, then the widest sub-tile); sets g.tb and g.tw.  The
// sub-tile fills the block: TW = 32 * ncol - 2K, TB = kRows * nstrip -
// 2K, each at most the cell's.  False when no shape fits the block's
// threads and 227 KB.
template <typename T, int MODE>
bool pick_shape(Geo& g, Shape* out) {
  constexpr int kWarps = max_threads<MODE>() / 32;
  constexpr size_t kSmem = 227 * 1024;
  long long best_warps = -1, best_blocks = 0;
  int best_tw = 0;
  for (int ncol = 1; ncol <= kWarps; ++ncol) {
    for (int nstrip = 1; ncol * nstrip <= kWarps; ++nstrip) {
      const int tw = std::min(g.cell_w, 32 * ncol - 2 * g.k);
      const int tb = std::min(g.cell_h, kRows * nstrip - 2 * g.k);
      if (tw < 1 || tb < 1) continue;
      const size_t smem = static_cast<size_t>(n_planes<MODE>())
                          * (kRows * nstrip + 2) * (32 * ncol + 2)
                          * sizeof(T);
      if (smem > kSmem) continue;
      const long long blocks =
          static_cast<long long>((g.cell_h + tb - 1) / tb)
          * ((g.cell_w + tw - 1) / tw);
      const long long warps = blocks * ncol * nstrip;
      const bool better =
          best_warps < 0 || warps < best_warps
          || (warps == best_warps
              && (blocks < best_blocks
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

// The instance (kUnit, kReg, kIwin) and block shape of a launch of T:
// lamb == 0 takes kUnit; float32 takes kReg wherever a shape fits its 12
// warps (K up to 31), else kIwin, as float64 always does (its weights
// would need twice the registers).  Sets g.tb, g.tw, g.n_sub_c and
// *n_sub.
template <typename T>
cudaError_t shape_typed(Geo& g, double lamb, int* mode, Shape* sh,
                        int* n_sub) {
  bool ok;
  if (lamb == 0.0) {
    *mode = kUnit;
    ok = pick_shape<T, kUnit>(g, sh);
  } else {
    ok = false;
    if constexpr (sizeof(T) == 4) {
      *mode = kReg;
      ok = pick_shape<T, kReg>(g, sh);
    }
    if (!ok) {
      *mode = kIwin;
      ok = pick_shape<T, kIwin>(g, sh);
    }
  }
  if (!ok) return cudaErrorInvalidValue;
  *n_sub = morph::sub_tiles(g);
  return *n_sub < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

// dtype codes: 3 float32, 4 float64 (the gdt takes float planes only).
// The launchers and gdt_geometry both take their shape here.
cudaError_t shape_of(Geo& g, int dtype, double lamb, int* mode, Shape* sh,
                     int* n_sub) {
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case 3: return shape_typed<float>(g, lamb, mode, sh, n_sub);
    case 4: return shape_typed<double>(g, lamb, mode, sh, n_sub);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int MODE>
cudaError_t launch_mode(const Geo& g, const Shape& sh, const T* s, T lamb,
                        int n_cells, int n_sub, cudaStream_t stream) {
  if (n_cells == 0) return cudaSuccess;
  auto kern = gdt_kernel<T, MODE>;
  const cudaError_t e = morph::allow_smem(kern, sh.smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_cells, n_sub), 32 * sh.ncol * sh.nstrip, sh.smem, stream>>>(
      g, s, lamb, sh.ncol);
  return cudaGetLastError();
}

// lamb crosses as a double and is cast to T once.
template <typename T>
cudaError_t launch_typed(const Geo& g, const Shape& sh, int mode,
                         const void* s, double lamb, int n_cells, int n_sub,
                         cudaStream_t stream) {
  const T* sp = static_cast<const T*>(s);
  const T lt = static_cast<T>(lamb);
  if (mode == kUnit)
    return launch_mode<T, kUnit>(g, sh, sp, lt, n_cells, n_sub, stream);
  if constexpr (sizeof(T) == 4) {  // no float64 kReg instance
    if (mode == kReg)
      return launch_mode<T, kReg>(g, sh, sp, lt, n_cells, n_sub, stream);
  }
  return launch_mode<T, kIwin>(g, sh, sp, lt, n_cells, n_sub, stream);
}

cudaError_t dispatch(int dtype, const Geo& g0, const void* s, double lamb,
                     int n_cells, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Geo g = g0;
  Shape sh;
  int mode, ns;
  const cudaError_t e = shape_of(g, dtype, lamb, &mode, &sh, &ns);
  if (e != cudaSuccess) return e;
  if (dtype == 3)
    return launch_typed<float>(g, sh, mode, s, lamb, n_cells, ns, st);
  return launch_typed<double>(g, sh, mode, s, lamb, n_cells, ns, st);
}

// A launcher call's Geo, shape and sub-tiles, as dispatch computes them.
cudaError_t geometry(int dtype, int compact, int rows, int w, int band_h,
                     int cell_w, int k, int bands_per_image, double lamb,
                     Geo* g, int* n_cells, int* mode, Shape* sh,
                     int* n_sub) {
  *g = morph::launch_geo(compact, rows, w, band_h, cell_w, k,
                         bands_per_image, n_cells);
  return shape_of(*g, dtype, lamb, mode, sh, n_sub);
}

}  // namespace

extern "C" {

int gdt_chain_step_launch(int dtype, const void* d, const void* i,
                          const void* s, const int* active, void* d_out,
                          int* changed, int h, int w, int band_h, int k,
                          int bands_per_image, double lamb, void* stream) {
  const Geo g = morph::stack_geo(d, i, active, d_out, changed, w, band_h,
                                 w, k, bands_per_image);
  return dispatch(dtype, g, s, lamb, h / band_h, stream);
}

int gdt_tile_step_launch(int dtype, const void* d, const void* i,
                         const void* s, const int* active, void* d_out,
                         int* changed, int h, int w, int band_h, int tile_w,
                         int k, int bands_per_image, double lamb,
                         void* stream) {
  const Geo g = morph::stack_geo(d, i, active, d_out, changed, w, band_h,
                                 tile_w, k, bands_per_image);
  return dispatch(dtype, g, s, lamb, (h / band_h) * (w / tile_w), stream);
}

int gdt_compact_step_launch(int dtype, const void* d_patch,
                            const void* i_patch, const void* s_patch,
                            const int* valid, void* d_out, int* changed,
                            int cap, int band_h, int tile_w, int k,
                            double lamb, void* stream) {
  const Geo g = morph::patch_geo(d_patch, i_patch, valid, d_out, changed,
                                 band_h, tile_w, k);
  return dispatch(dtype, g, s_patch, lamb, cap, stream);
}

// The launch geometry of a launcher call, without launching: a stack of
// `rows` x w cut into band_h x cell_w cells, or (compact = 1) `rows`
// patches of (band_h + 2K) x (cell_w + 2K), at lamb.  Fills shape =
// (mode, tb, tw, ncol, nstrip, smem, n_sub) and returns 0, or returns
// the error the launcher would.
int gdt_geometry(int dtype, int compact, int rows, int w, int band_h,
                 int cell_w, int k, int bands_per_image, double lamb,
                 long long* shape) {
  Geo g;
  Shape sh;
  int n_cells, mode, ns;
  const cudaError_t e = geometry(dtype, compact, rows, w, band_h, cell_w, k,
                                 bands_per_image, lamb, &g, &n_cells, &mode,
                                 &sh, &ns);
  if (e != cudaSuccess) return e;
  const long long v[7] = {mode, g.tb, g.tw, sh.ncol, sh.nstrip,
                          static_cast<long long>(sh.smem), ns};
  for (int i = 0; i < 7; ++i) shape[i] = v[i];
  return 0;
}

// Every window of that launch (morph::fill_windows: n_cells * n_sub
// blocks, cell-major, ten values each).
int gdt_windows(int dtype, int compact, int rows, int w, int band_h,
                int cell_w, int k, int bands_per_image, double lamb,
                long long* windows) {
  Geo g;
  Shape sh;
  int n_cells, mode, ns;
  const cudaError_t e = geometry(dtype, compact, rows, w, band_h, cell_w, k,
                                 bands_per_image, lamb, &g, &n_cells, &mode,
                                 &sh, &ns);
  if (e != cudaSuccess) return e;
  morph::fill_windows(g, n_cells, ns, windows);
  return 0;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

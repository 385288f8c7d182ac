// Pieces shared by the fused morphology kernels for Hopper (sm_90a):
// morph_chain.cu (erosion/dilation chains and geodesic steps),
// qdt_chain.cu (the quasi-distance transform) and gdt_chain.cu (the
// grey-weighted geodesic distance).
//
// All take a TB x TW sub-tile of one scheduling cell per block: a row
// band (n_tiles = 1, cell_w = array width), a band x column tile, or one
// pre-pinned patch of a vertically stacked patch array (compact).  This
// header holds the lattice identities, the NaN-propagating min/max and
// the PTX SIMD min/max, where a block's window lies and which source
// rows are pinned (locate), the sub-tile count of a launch (sub_tiles)
// and the host side of the geometry exports (launch_geo, fill_windows);
// each source picks its own block shape.  repro_torch.analysis.indexmaps
// models this arithmetic and holds it against those exports.  Sub-tiling is
// exact: after K steps a centre pixel depends only on its
// K-neighbourhood inside its image, so any TB x TW gives the same
// result.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace morph {

template <typename T> struct Lattice;
template <> struct Lattice<uint8_t> {
  __device__ static uint8_t hi() { return 0xFF; }
  __device__ static uint8_t lo() { return 0; }
};
template <> struct Lattice<uint16_t> {
  __device__ static uint16_t hi() { return 0xFFFF; }
  __device__ static uint16_t lo() { return 0; }
};
template <> struct Lattice<int32_t> {
  __device__ static int32_t hi() { return 0x7FFFFFFF; }
  __device__ static int32_t lo() { return -0x7FFFFFFF - 1; }
};
template <> struct Lattice<float> {
  __device__ static float hi() { return __int_as_float(0x7F800000); }
  __device__ static float lo() { return __int_as_float(0xFF800000); }
};
template <> struct Lattice<double> {
  __device__ static double hi() {
    return __longlong_as_double(0x7FF0000000000000LL);
  }
  __device__ static double lo() {
    return __longlong_as_double(static_cast<long long>(0xFFF0000000000000ULL));
  }
};

// NaN-propagating min (MIN) or max: a NaN operand wins either way, as
// with jnp.minimum (fminf/fmaxf would return the non-NaN operand).
template <typename T, bool MIN>
__device__ __forceinline__ T pick(T a, T b) {
  if (MIN) return (b < a || b != b) ? b : a;
  return (b > a || b != b) ? b : a;
}

// float32 min and max that return the canonical NaN when either operand
// is NaN: one PTX min.NaN / max.NaN on the card.
__host__ __device__ __forceinline__ float min_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? __builtin_nanf("") : (b < a ? b : a);
#endif
}
__host__ __device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
#else
  return (a != a || b != b) ? __builtin_nanf("") : (b > a ? b : a);
#endif
}

// Lane-wise min and max of two words of 16-bit lanes: PTX min.u16x2 /
// max.u16x2 on the card (Hopper's native 16-bit SIMD).
__host__ __device__ __forceinline__ uint32_t min2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("min.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const uint32_t lo = (a & 0xFFFFu) < (b & 0xFFFFu) ? a & 0xFFFFu
                                                   : b & 0xFFFFu;
  return lo | ((a >> 16) < (b >> 16) ? a >> 16 : b >> 16) << 16;
#endif
}
__host__ __device__ __forceinline__ uint32_t max2(uint32_t a, uint32_t b) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("max.u16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
#else
  const uint32_t lo = (a & 0xFFFFu) > (b & 0xFFFFu) ? a & 0xFFFFu
                                                   : b & 0xFFFFu;
  return lo | ((a >> 16) > (b >> 16) ? a >> 16 : b >> 16) << 16;
#endif
}

// Where one launch reads and writes.  A cell is a row band (n_tiles=1,
// cell_w = array width), a band x column tile, or (compact) one
// pre-pinned patch of a vertically stacked patch array.
struct Geo {
  const void* f;        // marker / input (gdt: the distance plane)
  const void* m;        // mask (geodesic) or grey-weight image (gdt)
  const int* active;    // per-cell activity or slot validity, or null
  void* out;            // new buffer
  int* changed;         // per-cell flag, zeroed by the caller
  long long src_w;      // row stride of f and m
  long long out_w;      // row stride of out
  int k;                // fused steps
  int cell_h, cell_w;   // centre of one cell
  int n_tiles;          // cells per band row (stack mode)
  int rows_per_image;   // pinning period of the stack (stack mode)
  int compact;          // 1: f/m are stacked (cell_h+2K) x (cell_w+2K) patches
  int tb, tw, n_sub_c;  // sub-tile and sub-tiles per cell row
};

// One block's sub-tile: the kernels pass blockIdx.x as the cell and
// blockIdx.y as the sub-tile.
struct Window {
  int tb, tw;            // this sub-tile (ragged at the cell's edge)
  int WH, WW;            // window rows and columns
  long long wr, wc;      // window origin in the source
  long long rlo, rhi;    // the source rows that are not pinned
  long long orow, ocol;  // the sub-tile's origin in the output
};

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}

// Where block (cell, sub) reads and writes.  Host code calls it too: the
// *_windows exports list a launch's windows with it.
__host__ __device__ __forceinline__ Window locate(const Geo& g, int cell,
                                                  int sub) {
  const int K = g.k;
  const int sr = sub / g.n_sub_c, sc = sub % g.n_sub_c;
  Window w;
  w.tb = imin(g.tb, g.cell_h - sr * g.tb);
  w.tw = imin(g.tw, g.cell_w - sc * g.tw);
  w.WH = w.tb + 2 * K;
  w.WW = w.tw + 2 * K;
  if (g.compact) {
    const long long pr = static_cast<long long>(cell) * (g.cell_h + 2 * K);
    w.wr = pr + static_cast<long long>(sr) * g.tb;
    w.wc = static_cast<long long>(sc) * g.tw;
    w.rlo = pr;
    w.rhi = pr + g.cell_h + 2 * K;
    w.orow = static_cast<long long>(cell) * g.cell_h
             + static_cast<long long>(sr) * g.tb;
    w.ocol = w.wc;
  } else {
    const int bi = cell / g.n_tiles, tj = cell % g.n_tiles;
    const long long band0 = static_cast<long long>(bi) * g.cell_h;
    w.orow = band0 + static_cast<long long>(sr) * g.tb;
    w.ocol = static_cast<long long>(tj) * g.cell_w
             + static_cast<long long>(sc) * g.tw;
    w.wr = w.orow - K;
    w.wc = w.ocol - K;
    w.rlo = band0 - band0 % g.rows_per_image;  // first row of the image
    w.rhi = w.rlo + g.rows_per_image;
  }
  return w;
}

// Sets g.n_sub_c and returns the sub-tiles per cell (gridDim.y), or -1
// when there are more than a grid's y dimension takes.
inline int sub_tiles(Geo& g) {
  g.n_sub_c = (g.cell_w + g.tw - 1) / g.tw;
  const long long n_sub =
      static_cast<long long>((g.cell_h + g.tb - 1) / g.tb) * g.n_sub_c;
  return n_sub > 65535 ? -1 : static_cast<int>(n_sub);
}

// Opts a kernel into more than 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// A stacked (H, W) array cut into cells of band_h x cell_w.
inline Geo stack_geo(const void* f, const void* m, const int* active,
                     void* out, int* changed, int w, int band_h, int cell_w,
                     int k, int bands_per_image) {
  Geo g{};
  g.f = f;
  g.m = m;
  g.active = active;
  g.out = out;
  g.changed = changed;
  g.src_w = w;
  g.out_w = w;
  g.k = k;
  g.cell_h = band_h;
  g.cell_w = cell_w;
  g.n_tiles = w / cell_w;
  g.rows_per_image = bands_per_image * band_h;
  g.compact = 0;
  return g;
}

// A vertical stack of (band_h + 2K, tile_w + 2K) patches whose centres
// go to a (cap * band_h, tile_w) array.
inline Geo patch_geo(const void* f, const void* m, const int* valid,
                     void* out, int* changed, int band_h, int tile_w,
                     int k) {
  Geo g{};
  g.f = f;
  g.m = m;
  g.active = valid;
  g.out = out;
  g.changed = changed;
  g.src_w = tile_w + 2 * k;
  g.out_w = tile_w;
  g.k = k;
  g.cell_h = band_h;
  g.cell_w = tile_w;
  g.n_tiles = 1;
  g.rows_per_image = band_h + 2 * k;
  g.compact = 1;
  return g;
}

// The Geo of a launcher call, without its pointers: a stack of `rows` x
// w cut into band_h x cell_w cells, or (compact) `rows` patches of
// (band_h + 2K) x (cell_w + 2K); sets *n_cells.  The *_geometry and
// *_windows exports start here.
inline Geo launch_geo(int compact, int rows, int w, int band_h, int cell_w,
                      int k, int bands_per_image, int* n_cells) {
  if (compact) {
    *n_cells = rows;
    return patch_geo(nullptr, nullptr, nullptr, nullptr, nullptr, band_h,
                     cell_w, k);
  }
  *n_cells = (rows / band_h) * (w / cell_w);
  return stack_geo(nullptr, nullptr, nullptr, nullptr, nullptr, w, band_h,
                   cell_w, k, bands_per_image);
}

// Every window of a launch of n_cells x n_sub blocks, cell-major: ten
// values each, Window's fields in order.
inline void fill_windows(const Geo& g, int n_cells, int n_sub,
                         long long* out) {
  for (int cell = 0; cell < n_cells; ++cell) {
    for (int sub = 0; sub < n_sub; ++sub) {
      const Window w = locate(g, cell, sub);
      long long* o = out + 10LL * (static_cast<long long>(cell) * n_sub + sub);
      o[0] = w.tb;
      o[1] = w.tw;
      o[2] = w.WH;
      o[3] = w.WW;
      o[4] = w.wr;
      o[5] = w.wc;
      o[6] = w.rlo;
      o[7] = w.rhi;
      o[8] = w.orow;
      o[9] = w.ocol;
    }
  }
}

}  // namespace morph

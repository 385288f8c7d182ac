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
// What a block does.  The Pallas kernels hold a whole (band_h+2K) x
// (tile_w+2K) cell in VMEM; a full-width 512-row uint8 band is ~627 KB,
// far above the 227 KB of shared memory one Hopper block can have.  So
// each block takes a TB x TW sub-tile of one scheduling cell (a band, a
// band x tile cell, or a gathered patch):
//   1. it loads the (TB+2K) x (TW+2K) window of the marker (and of the
//      mask) into dynamic shared memory, pinning rows outside the cell's
//      image and columns outside the array to the lattice identity
//      (patches arrive pre-pinned);
//   2. it runs K separable min/max passes, shrinking the computed region
//      by one pixel per side each step (only that region can still be
//      exact), clamping by the mask for the geodesic kernels;
//   3. it writes the TB x TW centre to a new buffer, never in place, so
//      every halo is read from pre-chunk values;
//   4. the geodesic kernels OR "any centre pixel changed" across the
//      block with __syncthreads_or and one thread stores 1 into the
//      cell's flag (a benign race: every writer stores the same value);
//   5. an inactive cell or an invalid slot copies its centre through
//      and leaves its flag at 0.
// Sub-tiling is exact: after K steps a centre pixel depends only on its
// K-neighbourhood inside its image, so any TB x TW gives the reference's
// result.  min/max propagate NaN like jnp.minimum (fminf/fmaxf would
// return the non-NaN operand).
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
//   geodesic chain uint8, K=32: 25.2 MB -> 7.5 us; 1.34e9 ops ->
//     20.0 us: bound by operations.
//   tile uint8, K=32, 64 x 128 cells, all 1024 active: 25.2 MB ->
//     7.5 us; 1.34e9 ops -> 20.0 us: bound by operations.
//   compact uint8, 512 patches of 128 x 192 (64 x 128 centres): 29.4 MB
//     -> 8.8 us; 1.27e9 ops -> 18.9 us: bound by operations.
// chip_smoke.py recomputes each bound from its run's inputs.  A first
// kernel: byte-wide shared-memory traffic keeps it far from these
// bounds; packed SIMD (__vminu4), register-resident passes and TMA are
// later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// NaN-propagating min (MIN) or max: a NaN operand wins either way.
template <typename T, bool MIN>
__device__ __forceinline__ T pick(T a, T b) {
  if (MIN) return (b < a || b != b) ? b : a;
  return (b > a || b != b) ? b : a;
}

// Where one launch reads and writes.  A cell is a row band (n_tiles=1,
// cell_w = array width), a band x column tile, or (compact) one
// pre-pinned patch of a vertically stacked patch array.
struct Geo {
  const void* f;        // marker / input
  const void* m;        // mask (geodesic only)
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

template <typename T, bool MIN, bool GEO>
__global__ void __launch_bounds__(kThreads) fused_kernel(Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = g.k;
  const int cell = blockIdx.x;
  const int sr = blockIdx.y / g.n_sub_c, sc = blockIdx.y % g.n_sub_c;
  const int tb = min(g.tb, g.cell_h - sr * g.tb);
  const int tw = min(g.tw, g.cell_w - sc * g.tw);
  const int WH = tb + 2 * K, WW = tw + 2 * K, WS = g.tw + 2 * K;

  // window origin (wr, wc) in the source, its unpinned row range
  // [rlo, rhi), and the sub-tile's origin (orow, ocol) in the output
  long long wr, wc, rlo, rhi, orow, ocol;
  if (g.compact) {
    const long long pr = static_cast<long long>(cell) * (g.cell_h + 2 * K);
    wr = pr + static_cast<long long>(sr) * g.tb;
    wc = static_cast<long long>(sc) * g.tw;
    rlo = pr;
    rhi = pr + g.cell_h + 2 * K;
    orow = static_cast<long long>(cell) * g.cell_h
           + static_cast<long long>(sr) * g.tb;
    ocol = wc;
  } else {
    const int bi = cell / g.n_tiles, tj = cell % g.n_tiles;
    const long long band0 = static_cast<long long>(bi) * g.cell_h;
    orow = band0 + static_cast<long long>(sr) * g.tb;
    ocol = static_cast<long long>(tj) * g.cell_w
           + static_cast<long long>(sc) * g.tw;
    wr = orow - K;
    wc = ocol - K;
    rlo = band0 - band0 % g.rows_per_image;  // first row of the image
    rhi = rlo + g.rows_per_image;
  }
  const T* f = static_cast<const T*>(g.f);
  const T* m = static_cast<const T*>(g.m);
  T* out = static_cast<T*>(g.out);
  const int tid = threadIdx.x;

  if (g.active != nullptr && g.active[cell] == 0) {
    // converged cell / sentinel slot: centre passes through, flag stays 0
    for (int i = tid; i < tb * tw; i += kThreads) {
      const int r = i / tw, c = i % tw;
      out[(orow + r) * g.out_w + ocol + c] =
          f[(wr + K + r) * g.src_w + wc + K + c];
    }
    return;
  }

  const T id = MIN ? Lattice<T>::hi() : Lattice<T>::lo();
  const int plane = (g.tb + 2 * K) * WS;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  T* mk = b + plane;
  for (int i = tid; i < WH * WW; i += kThreads) {
    const int r = i / WW, c = i % WW;
    const long long gr = wr + r, gc = wc + c;
    const bool in = gr >= rlo && gr < rhi && gc >= 0 && gc < g.src_w;
    const long long at = gr * g.src_w + gc;
    a[r * WS + c] = in ? f[at] : id;
    if (GEO) mk[r * WS + c] = in ? m[at] : id;
  }
  __syncthreads();

  const int tx = tid & 31, ty = tid >> 5;
  constexpr int kRows = kThreads / 32;
  for (int t = 1; t <= K; ++t) {
    // horizontal pass a -> b on rows [t-1, WH-t+1), columns [t, WW-t)
    for (int r = t - 1 + ty; r < WH - t + 1; r += kRows) {
      const T* src = a + r * WS;
      T* dst = b + r * WS;
      for (int c = t + tx; c < WW - t; c += 32)
        dst[c] = pick<T, MIN>(pick<T, MIN>(src[c - 1], src[c]), src[c + 1]);
    }
    __syncthreads();
    // vertical pass b -> a (then the mask clamp) on rows [t, WH-t)
    for (int r = t + ty; r < WH - t; r += kRows) {
      const T* up = b + (r - 1) * WS;
      const T* mid = b + r * WS;
      const T* dn = b + (r + 1) * WS;
      T* dst = a + r * WS;
      for (int c = t + tx; c < WW - t; c += 32) {
        T v = pick<T, MIN>(pick<T, MIN>(up[c], mid[c]), dn[c]);
        if (GEO) v = pick<T, !MIN>(v, mk[r * WS + c]);
        dst[c] = v;
      }
    }
    __syncthreads();
  }

  int any = 0;
  for (int i = tid; i < tb * tw; i += kThreads) {
    const int r = i / tw, c = i % tw;
    const T v = a[(K + r) * WS + K + c];
    out[(orow + r) * g.out_w + ocol + c] = v;
    if (GEO) any |= (v != f[(wr + K + r) * g.src_w + wc + K + c]);
  }
  if (GEO) {
    any = __syncthreads_or(any);
    if (any && tid == 0) g.changed[cell] = 1;
  }
}

// Choose the sub-tile: the largest useful fraction TB*TW/((TB+2K)(TW+2K))
// whose working arrays fit half the 227 KB (two blocks per SM), else all
// of it.  Sub-tiles never exceed the cell.
bool pick_subtile(int k, int esize, int narr, int cell_h, int cell_w,
                  int* tb_out, int* tw_out, size_t* smem_out) {
  static const int kTB[] = {128, 64, 32, 16, 8};
  static const int kTW[] = {256, 128, 64, 32};
  static const size_t kBudget[] = {113 * 1024, 227 * 1024};
  for (size_t budget : kBudget) {
    double best = -1.0;
    for (int tb0 : kTB) {
      for (int tw0 : kTW) {
        const int tb = tb0 < cell_h ? tb0 : cell_h;
        const int tw = tw0 < cell_w ? tw0 : cell_w;
        const size_t smem = static_cast<size_t>(narr) * (tb + 2 * k)
                            * (tw + 2 * k) * esize;
        if (smem > budget) continue;
        const double eff = static_cast<double>(tb) * tw
                           / ((tb + 2.0 * k) * (tw + 2.0 * k));
        if (eff > best) {
          best = eff;
          *tb_out = tb;
          *tw_out = tw;
          *smem_out = smem;
        }
      }
    }
    if (best > 0) return true;
  }
  return false;
}

template <typename T, bool MIN, bool GEO>
cudaError_t launch_one(const Geo& g, int n_cells, int n_sub, size_t smem,
                       cudaStream_t stream) {
  auto kern = fused_kernel<T, MIN, GEO>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(n_cells, n_sub), kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(Geo g, bool is_min, bool geo, int n_cells,
                         cudaStream_t stream) {
  size_t smem = 0;
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1 ||
      !pick_subtile(g.k, sizeof(T), geo ? 3 : 2, g.cell_h, g.cell_w, &g.tb,
                    &g.tw, &smem))
    return cudaErrorInvalidValue;
  g.n_sub_c = (g.cell_w + g.tw - 1) / g.tw;
  const long long n_sub =
      static_cast<long long>((g.cell_h + g.tb - 1) / g.tb) * g.n_sub_c;
  if (n_sub > 65535) return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const int ns = static_cast<int>(n_sub);
  if (is_min) {
    return geo ? launch_one<T, true, true>(g, n_cells, ns, smem, stream)
               : launch_one<T, true, false>(g, n_cells, ns, smem, stream);
  }
  return geo ? launch_one<T, false, true>(g, n_cells, ns, smem, stream)
             : launch_one<T, false, false>(g, n_cells, ns, smem, stream);
}

// dtype codes: 0 uint8, 1 uint16, 2 int32, 3 float32, 4 float64
cudaError_t dispatch(int dtype, const Geo& g, int is_min, int geo,
                     int n_cells, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_typed<uint8_t>(g, is_min, geo, n_cells, s);
    case 1: return launch_typed<uint16_t>(g, is_min, geo, n_cells, s);
    case 2: return launch_typed<int32_t>(g, is_min, geo, n_cells, s);
    case 3: return launch_typed<float>(g, is_min, geo, n_cells, s);
    case 4: return launch_typed<double>(g, is_min, geo, n_cells, s);
    default: return cudaErrorInvalidValue;
  }
}

Geo stack_geo(const void* f, const void* m, const int* active, void* out,
              int* changed, int w, int band_h, int cell_w, int k,
              int bands_per_image) {
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

}  // namespace

extern "C" {

int chain_step_launch(int dtype, int is_min, const void* x, void* out, int h,
                      int w, int band_h, int k, int bands_per_image,
                      void* stream) {
  const Geo g = stack_geo(x, nullptr, nullptr, out, nullptr, w, band_h, w,
                          k, bands_per_image);
  return dispatch(dtype, g, is_min, 0, h / band_h, stream);
}

int geodesic_chain_step_launch(int dtype, int is_min, const void* f,
                               const void* m, const int* active, void* out,
                               int* changed, int h, int w, int band_h, int k,
                               int bands_per_image, void* stream) {
  const Geo g = stack_geo(f, m, active, out, changed, w, band_h, w, k,
                          bands_per_image);
  return dispatch(dtype, g, is_min, 1, h / band_h, stream);
}

int geodesic_tile_step_launch(int dtype, int is_min, const void* f,
                              const void* m, const int* active, void* out,
                              int* changed, int h, int w, int band_h,
                              int tile_w, int k, int bands_per_image,
                              void* stream) {
  const Geo g = stack_geo(f, m, active, out, changed, w, band_h, tile_w, k,
                          bands_per_image);
  return dispatch(dtype, g, is_min, 1, (h / band_h) * (w / tile_w), stream);
}

int geodesic_compact_step_launch(int dtype, int is_min, const void* f_patch,
                                 const void* m_patch, const int* valid,
                                 void* out, int* changed, int cap, int band_h,
                                 int tile_w, int k, void* stream) {
  Geo g{};
  g.f = f_patch;
  g.m = m_patch;
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
  return dispatch(dtype, g, is_min, 1, cap, stream);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

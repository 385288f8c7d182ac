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
// The window, its pinning and the sub-tile choice are shared with
// qdt_chain.cu (morph_common.cuh).  Sub-tiling is exact: after K steps a
// centre pixel depends only on its K-neighbourhood inside its image, so
// any TB x TW gives the reference's result.  min/max propagate NaN like
// jnp.minimum (fminf/fmaxf would return the non-NaN operand).
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

#include "morph_common.cuh"

namespace {

using morph::Geo;
using morph::kThreads;
using morph::Lattice;
using morph::pick;
using morph::Window;

template <typename T, bool MIN, bool GEO>
__global__ void __launch_bounds__(kThreads) fused_kernel(Geo g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = g.k;
  const int cell = blockIdx.x;
  const Window w = morph::locate(g);
  const int WH = w.WH, WW = w.WW, WS = w.WS;
  const T* f = static_cast<const T*>(g.f);
  const T* m = static_cast<const T*>(g.m);
  T* out = static_cast<T*>(g.out);
  const int tid = threadIdx.x;

  if (g.active != nullptr && g.active[cell] == 0) {
    // converged cell / sentinel slot: centre passes through, flag stays 0
    morph::copy_centre(out, f, g, w);
    return;
  }

  const T id = MIN ? Lattice<T>::hi() : Lattice<T>::lo();
  const int plane = (g.tb + 2 * K) * WS;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  T* mk = b + plane;
  morph::load_window(a, f, g, w, id);
  if (GEO) morph::load_window(mk, m, g, w, id);
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
  for (int i = tid; i < w.tb * w.tw; i += kThreads) {
    const int r = i / w.tw, c = i % w.tw;
    const T v = a[(K + r) * WS + K + c];
    out[(w.orow + r) * g.out_w + w.ocol + c] = v;
    if (GEO) any |= (v != f[(w.wr + K + r) * g.src_w + w.wc + K + c]);
  }
  if (GEO) {
    any = __syncthreads_or(any);
    if (any && tid == 0) g.changed[cell] = 1;
  }
}

template <typename T, bool MIN, bool GEO>
cudaError_t launch_one(const Geo& g, int n_cells, int n_sub, size_t smem,
                       cudaStream_t stream) {
  auto kern = fused_kernel<T, MIN, GEO>;
  const cudaError_t e = morph::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_cells, n_sub), kThreads, smem, stream>>>(g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(Geo g, bool is_min, bool geo, int n_cells,
                         cudaStream_t stream) {
  size_t smem = 0;
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1 ||
      !morph::pick_subtile(g.k, sizeof(T), geo ? 3 : 2, 0, g.cell_h,
                           g.cell_w, &g.tb, &g.tw, &smem))
    return cudaErrorInvalidValue;
  const int ns = morph::sub_tiles(g);
  if (ns < 0) return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

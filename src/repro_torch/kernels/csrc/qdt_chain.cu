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
// What a block does.  As in morph_chain.cu (window, pinning and sub-tile
// choice from morph_common.cuh), a block takes a TB x TW sub-tile of one
// cell and holds its (TB+2K) x (TW+2K) f window in two shared-memory
// planes, pinned to the erosion identity outside the cell's image and
// the array (patches arrive pre-pinned).  r and d belong to the TB x TW
// centre only: the block reads them from device memory once, keeps them
// in shared memory behind the f planes for all K steps, and writes them
// once.  The computed region shrinks by one pixel per side each step and
// always holds the centre exactly, so a centre pixel's value before the
// step (the old f plane) and after it (the vertical pass's result) are
// both at hand where the vertical pass writes it: that pass forms the
// residual and makes the masked store.  An inactive cell or invalid slot
// copies f, r and d through and leaves its flag at 0; the changed flag
// is "any centre f pixel moved", OR-reduced with __syncthreads_or.
//
// Residuals are computed as the reference computes them: (int32)a -
// (int32)b for uint8/uint16; for int32 images a wrapping subtraction
// (through uint32_t, since signed overflow is undefined in C++); float32
// a - b; float64 images (float)a - (float)b, each cast before the
// subtraction.  A NaN residual never compares greater, so it stores
// nothing; eps1 propagates NaN through morph::pick.  Built without
// fast-math.
//
// Bound on one H100 SXM (3.35 TB/s, 67e12/s fp32 non-tensor rate for
// every dtype).  Per launch the function reads f, r and d once and
// writes each once; its work is 4 min + 1 subtract + 1 compare per pixel
// per step.  At paper scale, 8 x 1024 x 1024, one all-active tile
// launch: uint8, K=32: 144 MB -> 43 us against 1.6e9 ops -> 24 us, bound
// by bytes; float32, K=16: 192 MB -> 57 us.  chip_smoke.py recomputes
// the bounds from its run's inputs.  A first kernel: the byte-wide
// shared-memory passes and two block barriers per step, as in
// morph_chain.cu, keep it far above them.

#include "morph_common.cuh"

namespace {

using morph::Geo;
using morph::kThreads;
using morph::Lattice;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) qdt_kernel(Geo g, Planes p) {
  using A = typename Acc<T>::type;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = g.k;
  const int cell = blockIdx.x;
  const Window w = morph::locate(g);
  const int WH = w.WH, WW = w.WW, WS = w.WS;
  const T* f = static_cast<const T*>(g.f);
  T* out = static_cast<T*>(g.out);
  const A* r_in = static_cast<const A*>(p.r_in);
  A* r_out = static_cast<A*>(p.r_out);
  const int tid = threadIdx.x;

  if (g.active != nullptr && g.active[cell] == 0) {
    // converged cell / sentinel slot: f, r and d pass through, flag 0
    morph::copy_centre(out, f, g, w);
    for (int i = tid; i < w.tb * w.tw; i += kThreads) {
      const long long at =
          (w.orow + i / w.tw) * g.out_w + w.ocol + i % w.tw;
      r_out[at] = r_in[at];
      p.d_out[at] = p.d_in[at];
    }
    return;
  }

  const int plane = (g.tb + 2 * K) * WS;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  A* rs = reinterpret_cast<A*>(smem_raw
                               + morph::align16(2 * plane * sizeof(T)));
  int* ds = reinterpret_cast<int*>(rs + g.tb * g.tw);
  morph::load_window(a, f, g, w, Lattice<T>::hi());
  for (int i = tid; i < w.tb * w.tw; i += kThreads) {
    const long long at = (w.orow + i / w.tw) * g.out_w + w.ocol + i % w.tw;
    rs[i] = r_in[at];
    ds[i] = p.d_in[at];
  }
  const int base = p.base[cell];
  __syncthreads();

  const int tx = tid & 31, ty = tid >> 5;
  constexpr int kRows = kThreads / 32;
  for (int t = 1; t <= K; ++t) {
    // horizontal pass a -> b on rows [t-1, WH-t+1), columns [t, WW-t)
    for (int r = t - 1 + ty; r < WH - t + 1; r += kRows) {
      const T* src = a + r * WS;
      T* dst = b + r * WS;
      for (int c = t + tx; c < WW - t; c += 32)
        dst[c] = pick<T, true>(pick<T, true>(src[c - 1], src[c]),
                               src[c + 1]);
    }
    __syncthreads();
    // vertical pass b -> a on rows [t, WH-t); at a centre pixel, the
    // residual of this step and the masked store of r and d
    for (int r = t + ty; r < WH - t; r += kRows) {
      const T* up = b + (r - 1) * WS;
      const T* mid = b + r * WS;
      const T* dn = b + (r + 1) * WS;
      T* dst = a + r * WS;
      const int cr = r - K;
      const bool centre_row = cr >= 0 && cr < w.tb;
      for (int c = t + tx; c < WW - t; c += 32) {
        const T v = pick<T, true>(pick<T, true>(up[c], mid[c]), dn[c]);
        const int cc = c - K;
        if (centre_row && cc >= 0 && cc < w.tw) {
          const A res = residual(dst[c], v);
          const int i = cr * w.tw + cc;
          if (res > rs[i]) {
            rs[i] = res;
            ds[i] = base + t;
          }
        }
        dst[c] = v;
      }
    }
    __syncthreads();
  }

  int any = 0;
  for (int i = tid; i < w.tb * w.tw; i += kThreads) {
    const int r = i / w.tw, c = i % w.tw;
    const T v = a[(K + r) * WS + K + c];
    const long long at = (w.orow + r) * g.out_w + w.ocol + c;
    out[at] = v;
    r_out[at] = rs[i];
    p.d_out[at] = ds[i];
    any |= (v != f[(w.wr + K + r) * g.src_w + w.wc + K + c]);
  }
  any = __syncthreads_or(any);
  if (any && tid == 0) g.changed[cell] = 1;
}

template <typename T>
cudaError_t launch_typed(Geo g, const Planes& p, int n_cells,
                         cudaStream_t stream) {
  using A = typename Acc<T>::type;
  size_t smem = 0;
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1 ||
      !morph::pick_subtile(g.k, sizeof(T), 2, sizeof(A) + sizeof(int),
                           g.cell_h, g.cell_w, &g.tb, &g.tw, &smem))
    return cudaErrorInvalidValue;
  const int ns = morph::sub_tiles(g);
  if (ns < 0) return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  auto kern = qdt_kernel<T>;
  const cudaError_t e = morph::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_cells, ns), kThreads, smem, stream>>>(g, p);
  return cudaGetLastError();
}

// dtype codes: 0 uint8, 1 uint16, 2 int32, 3 float32, 4 float64
cudaError_t dispatch(int dtype, const Geo& g, const Planes& p, int n_cells,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_typed<uint8_t>(g, p, n_cells, s);
    case 1: return launch_typed<uint16_t>(g, p, n_cells, s);
    case 2: return launch_typed<int32_t>(g, p, n_cells, s);
    case 3: return launch_typed<float>(g, p, n_cells, s);
    case 4: return launch_typed<double>(g, p, n_cells, s);
    default: return cudaErrorInvalidValue;
  }
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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

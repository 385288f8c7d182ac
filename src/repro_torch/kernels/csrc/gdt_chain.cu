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
// instance (UNIT): weight exactly 1, no multiply, no i plane.  The min
// propagates NaN (morph::pick), as jnp.minimum does; a NaN seed is not a
// pad (NaN < 0 is false).
//
// What a block does.  As in morph_chain.cu (window, pinning and sub-tile
// choice from morph_common.cuh), a block takes a TB x TW sub-tile of one
// cell and loads its (TB+2K) x (TW+2K) window of each plane into shared
// memory, pinned outside the cell's image and the array to the planes'
// identities: d -> +inf, i -> 0, s -> -1 (compact patches arrive pinned
// by the driver's gather, and a window never leaves its patch, so
// nothing is re-pinned there).  The kernel reads s only as "s < 0", so s
// is held as a one-byte pad mask; d is held twice (ping-pong) and i once.
// Shared memory per window pixel: 3 * sizeof(T) + 1 bytes (2 * sizeof(T)
// + 1 for lamb == 0), which pick_subtile counts as that many one-byte
// windows.  Each step computes the region that can still be exact (one
// pixel less per side per step), reading the 8 neighbours from the
// previous plane; the weights are recomputed each step from the resident
// i window.  An inactive cell or invalid slot copies d through and
// leaves its flag at 0; the changed flag is "any centre pixel moved"
// (NaN counts as moved), OR-reduced with __syncthreads_or.  Every launch
// writes a new buffer, so halos are read from pre-chunk values.
//
// Bound on one H100 SXM (3.35 TB/s, 67e12/s fp32 non-tensor).  Per launch
// the function reads d, i and s once and writes d once; its operations
// are the weights once per pixel (8 x: subtract, abs, multiply, add),
// then 8 adds, 8 mins and the clamp per pixel per step.  At 8 x 1024 x
// 1024 float32, K=16, one all-active tile launch: 134 MB -> 40.1 us,
// against 2.55e9 ops -> 38.0 us: bound by bytes.  chip_smoke.py
// recomputes the bounds from its run's inputs.  A first kernel: the
// weights recomputed every step, 18 shared-memory loads per pixel per
// step and a barrier per step keep it far above the bound.

#include "morph_common.cuh"

namespace {

using morph::Geo;
using morph::kThreads;
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

// The s window as a pad mask: 1 where s < 0 (pads and pinned halos).
struct PadMark {
  template <typename T>
  __device__ __forceinline__ unsigned char operator()(T v) const {
    return v < T(0) ? 1 : 0;
  }
};

// Geo.f is the d plane, Geo.m the i plane.
template <typename T, bool UNIT>
__global__ void __launch_bounds__(kThreads) gdt_kernel(Geo g, const T* s,
                                                        T lamb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = g.k;
  const int cell = blockIdx.x;
  const Window w = morph::locate(g);
  const int WH = w.WH, WW = w.WW, WS = w.WS;
  const T* d = static_cast<const T*>(g.f);
  const T* im = static_cast<const T*>(g.m);
  T* out = static_cast<T*>(g.out);
  const int tid = threadIdx.x;

  if (g.active != nullptr && g.active[cell] == 0) {
    // converged cell / sentinel slot: d passes through, flag stays 0
    morph::copy_centre(out, d, g, w);
    return;
  }

  const T inf = Lattice<T>::hi();
  const int plane = (g.tb + 2 * K) * WS;
  T* a = reinterpret_cast<T*>(smem_raw);
  T* b = a + plane;
  T* iw = b + plane;                        // unused when UNIT
  unsigned char* pad =
      reinterpret_cast<unsigned char*>(UNIT ? iw : iw + plane);
  morph::load_window(a, d, g, w, inf);
  if (!UNIT) morph::load_window(iw, im, g, w, T(0));
  morph::load_window_as(pad, s, g, w, static_cast<unsigned char>(1),
                        PadMark());
  __syncthreads();

  const int tx = tid & 31, ty = tid >> 5;
  constexpr int kRows = kThreads / 32;
  for (int t = 1; t <= K; ++t) {
    // step t: a -> b on rows [t, WH-t), columns [t, WW-t)
    for (int r = t + ty; r < WH - t; r += kRows) {
      for (int c = t + tx; c < WW - t; c += 32) {
        const int at = r * WS + c;
        T best = inf;
        if (!pad[at]) {
          best = a[at];
          const T ip = UNIT ? T(0) : iw[at];
#pragma unroll
          for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
            for (int dx = -1; dx <= 1; ++dx) {
              if (dy == 0 && dx == 0) continue;
              const int q = at + dy * WS + dx;
              const T wq = UNIT ? T(1) : weight(lamb, ip, iw[q]);
              best = pick<T, true>(best, add_rn(a[q], wq));
            }
          }
        }
        b[at] = best;
      }
    }
    __syncthreads();
    T* tmp = a;
    a = b;
    b = tmp;
  }

  int any = 0;
  for (int i = tid; i < w.tb * w.tw; i += kThreads) {
    const int r = i / w.tw, c = i % w.tw;
    const T v = a[(K + r) * WS + K + c];
    out[(w.orow + r) * g.out_w + w.ocol + c] = v;
    any |= (v != d[(w.wr + K + r) * g.src_w + w.wc + K + c]);
  }
  any = __syncthreads_or(any);
  if (any && tid == 0) g.changed[cell] = 1;
}

template <typename T, bool UNIT>
cudaError_t launch_one(const Geo& g, const T* s, T lamb, int n_cells,
                       int n_sub, size_t smem, cudaStream_t stream) {
  auto kern = gdt_kernel<T, UNIT>;
  const cudaError_t e = morph::allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_cells, n_sub), kThreads, smem, stream>>>(g, s, lamb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(Geo g, const void* s, double lamb, int n_cells,
                         cudaStream_t stream) {
  const bool unit = lamb == 0.0;
  // bytes per window pixel: d twice, i once (not for lamb == 0), s mask
  const int px_bytes = (unit ? 2 : 3) * static_cast<int>(sizeof(T)) + 1;
  size_t smem = 0;
  if (g.k < 1 || g.cell_h < 1 || g.cell_w < 1 ||
      !morph::pick_subtile(g.k, 1, px_bytes, 0, g.cell_h, g.cell_w, &g.tb,
                           &g.tw, &smem))
    return cudaErrorInvalidValue;
  const int ns = morph::sub_tiles(g);
  if (ns < 0) return cudaErrorInvalidValue;
  if (n_cells == 0) return cudaSuccess;
  const T* sp = static_cast<const T*>(s);
  const T lt = static_cast<T>(lamb);
  if (unit) return launch_one<T, true>(g, sp, lt, n_cells, ns, smem, stream);
  return launch_one<T, false>(g, sp, lt, n_cells, ns, smem, stream);
}

// dtype codes: 3 float32, 4 float64 (the gdt takes float planes only)
cudaError_t dispatch(int dtype, const Geo& g, const void* s, double lamb,
                     int n_cells, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 3: return launch_typed<float>(g, s, lamb, n_cells, st);
    case 4: return launch_typed<double>(g, s, lamb, n_cells, st);
    default: return cudaErrorInvalidValue;
  }
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

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

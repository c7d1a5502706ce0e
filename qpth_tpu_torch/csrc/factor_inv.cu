// Kernel A: Linv = inv(chol(R + diag(dinv))), optionally with one solve.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::_factor_inv_call
// (factor_inv_lanes, factor_inv_solve_lanes, factor_inv_solve_rz_lanes),
// whose _chol_inv_inplace factors and inverts together, pivot by pivot.
// One thread block per QP factors and inverts in one m x m shared-memory
// tile (40 KB at m = 100 in float32), so R is read from device memory once
// and Linv written once, on the 32-row panels of kernels C and E
// (panel.cuh):
//   (1) R's lower triangle is staged by cp.async, each entry to its mirror
//       place above the diagonal, which the panel routines read: only R's
//       lower triangle counts, as in kernels.py::factor_inv_plain (R = G
//       Q^-1 G^T from a product need not be bitwise symmetric). With RZ the
//       whole R is staged and R z taken from it, then the mirror pass;
//   (2) T = R + diag(dinv) is factored in place, Lt on and above the
//       diagonal (factor_panels, kernel C's loop: the shift folded into each
//       pivot, the pivots' rsqrt to isqv); with RHS, y = L^-1 rhs rides as
//       one more column;
//   (3) L is inverted in place (trinv_panels, kernel E's scheme): inv(L)
//       fills the lower triangle and diagonal, Lt stays strictly above it,
//       and isqv are the reciprocals of Lt's diagonal, so no division;
//   (4) with RHS, x = L^-T y by back substitution on Lt's strict upper
//       triangle, which the inverse leaves in place (back_warp, the pivots
//       from isqv), in warp 0 beside the inverse in the other seven;
//   (5) all warps write inv(L) out, lower triangular with exact zeros above
//       the diagonal, and x.
// Barriers (factor_inv_barriers): 1 after the staging (3 with RZ), 3 P - 1
// in the factor, 2 P - 1 in the inverse, 1 joining the back substitution,
// with P = ceil(m / 32) panels: 19 at m = 100 without rhs, 20 with, 22 with
// rz, against one a pivot step (~103) in the factor-inverse it replaces.
// Up to m = 17 in float32 and 50 in float64 the launcher keeps that
// factor-inverse (factor_inv_tile_kernel below), which is faster there.
//
// What bounds it on an H100: bytes. At B = 4096, m = 100 R's triangle in
// and the dense Linv out (248 MB in float32) take >= 0.074 ms at 3.35 TB/s
// (0.150 ms in float64), its ~2/3 m^3 flops per QP (the factor and the
// inverse, m^3 / 3 each) >= 0.041 ms at 67 TFLOP/s. What a block waits on
// is the factor's 32-step chains (one warp's, over each diagonal block; the
// first and the last panel's with no other work beside them), then the
// inverse's chains and barriers, against 4 (float32, the register cap of
// __launch_bounds__) or 2 (float64) blocks an SM; the block products run on
// register tiles in every warp.
//
// Variants (compile-time flags of one template):
//   RHS = false            Linv only                    (factor_inv_lanes)
//   RHS = true,  RZ=false  + x = T^-1 rhs               (factor_inv_solve_lanes)
//   RHS = true,  RZ=true   + x = T^-1 (rhs - R z), R z  (factor_inv_solve_rz_lanes)
//                          taken from the raw R in shared memory before the
//                          mirror pass overwrites its upper triangle.
#include "panel.cuh"

namespace qpth {

// Barriers one QP passes in the panel kernel: the staging's (and R z's and
// the mirror's), the factor's, the inverse's (of the warps that run it) and,
// where warp 0 runs the back substitution beside the inverse, the one that
// joins them.
__host__ __device__ constexpr int factor_inv_barriers(int m, bool rhs,
                                                      bool rz) {
  return 1 + (rz ? 2 : 0) + 5 * panels(m) - 2 +
         (rhs && panels(m) < kWarps ? 1 : 0);
}

template <typename T, bool RHS, bool RZ>
__global__ void __launch_bounds__(kThreads, PanelBlocks<T>::value)
factor_inv_kernel(const T* __restrict__ R, const T* __restrict__ dinv,
                  const T* __restrict__ rhs, const T* __restrict__ z,
                  T* __restrict__ Linv, T* __restrict__ x, int m,
                  long long r_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Tm = reinterpret_cast<T*>(smem_raw);  // R, then Lt above inv(L)
  T* dv = Tm + m * m;                      // dinv, the factor's shift
  T* isqv = dv + m;                        // the pivots' rsqrt
  T* ys = isqv + m;                        // rhs, then y = L^-1 rhs, then x
  T* zs = ys + m;                          // z (RZ)
  T* w = zs + m;                           // R z (RZ)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const long long b = blockIdx.x;
  const T* Rb = R + b * r_stride;
  // Staged by cp.async, every copy of the block in flight at once: with RZ
  // the whole R, else its lower triangle, each entry to its mirror place.
  if (RZ) {
    for (int i = threadIdx.x; i < m * m; i += blockDim.x)
      cp_async_elt(Tm + i, Rb + i, true);
  } else {
    for (int r = warp; r < m; r += kWarps)
      for (int c = lane; c <= r; c += 32)
        cp_async_elt(Tm + c * m + r, Rb + r * m + c, true);
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    cp_async_elt(dv + i, dinv + b * m + i, true);
    if (RHS) cp_async_elt(ys + i, rhs + b * m + i, true);
    if (RZ) cp_async_elt(zs + i, z + b * m + i, true);
  }
  cp_async_wait_all();
  __syncthreads();

  if (RZ) {  // R z from the whole raw R; then the mirror pass (a warp per
             // row: reads below the diagonal and writes above it never meet)
    smem_matvec<T, false>(Tm, zs, w, m);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) ys[i] -= w[i];
    for (int r = warp; r < m; r += kWarps)
      for (int c = lane; c < r; c += 32) Tm[c * m + r] = Tm[r * m + c];
    __syncthreads();
  }

  factor_panels<T, true, RHS>(Tm, SquareTile{m, m}, dv, isqv, ys, warp, lane);

  // The inverse (trinv_panels) and, with RHS, x = L^-T y in warp 0
  // (back_warp). Both read Lt's strict upper triangle and isqv only, and the
  // inverse writes below it, so where the other warps have a diagonal block
  // each (m <= 224) warp 0 runs the back substitution beside the inverse;
  // else first, before joining it.
  const bool beside = RHS && panels(m) < kWarps;
  if (RHS && warp == 0) back_warp(Tm, SquareTile{m, m}, isqv, ys, lane);
  if (!beside || warp != 0)
    trinv_panels(Tm, m, isqv, beside ? 1 : 0, beside ? kWarps - 1 : kWarps,
                 warp, lane);
  if (beside) __syncthreads();

  store_triangle<T, false>(Linv + b * m * m, Tm, m, 0, kWarps, warp, lane);
  if (RHS)
    for (int i = threadIdx.x; i < m; i += blockDim.x) x[b * m + i] = ys[i];
}

// At small m the panels' one-warp chains leave the block's other warps idle
// and their registers cap it at 4 (float32) or 2 (float64) blocks an SM:
// the per-pivot factor-inverse of the TPU kernel (common.cuh::chol_inv_smem,
// one barrier a pivot step, m^3 / 3 multiply-adds swept by all warps, up to
// 8 blocks an SM) is faster up to these widths (PERF.md kernel table, rows
// 1-3), and the launcher takes it there.
template <typename T> struct TileMaxM;
template <> struct TileMaxM<float> { static constexpr int value = 17; };
template <> struct TileMaxM<double> { static constexpr int value = 50; };

template <typename T, bool RHS, bool RZ>
__global__ void __launch_bounds__(kThreads)
factor_inv_tile_kernel(const T* __restrict__ R, const T* __restrict__ dinv,
                       const T* __restrict__ rhs, const T* __restrict__ z,
                       T* __restrict__ Linv, T* __restrict__ x, int m,
                       long long r_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Tm = reinterpret_cast<T*>(smem_raw);  // R, then inv(L)
  T* dv = Tm + m * m;
  T* isqv = dv + m;
  T* r = isqv + m;
  T* w = r + m;
  T* zs = w + m;

  const long long b = blockIdx.x;
  const T* Rb = R + b * r_stride;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) Tm[i] = Rb[i];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    dv[i] = dinv[b * m + i];
    if (RHS) r[i] = rhs[b * m + i];
    if (RZ) zs[i] = z[b * m + i];
  }
  __syncthreads();

  if (RZ) {  // R z from the whole R, before the factorization mirrors it
    smem_matvec<T, false>(Tm, zs, w, m);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) r[i] -= w[i];
  }

  chol_inv_smem(Tm, dv, isqv, m);  // its first barrier publishes r

  T* Lb = Linv + b * m * m;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) Lb[i] = Tm[i];
  if (RHS) {
    const T xc = apply_inv(Tm, r, w, m);
    if (threadIdx.x < m) x[b * m + threadIdx.x] = xc;
  }
}

template <typename T, bool RHS, bool RZ>
static int launch(const void* R, const void* dinv, const void* rhs,
                  const void* z, void* Linv, void* x, int B, int m,
                  int r_batched, void* stream) {
  auto kern = m <= TileMaxM<T>::value ? factor_inv_tile_kernel<T, RHS, RZ>
                                       : factor_inv_kernel<T, RHS, RZ>;
  const size_t smem = smem_bytes<T>(m);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return int(err);
  kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(R), static_cast<const T*>(dinv),
      static_cast<const T*>(rhs), static_cast<const T*>(z),
      static_cast<T*>(Linv), static_cast<T*>(x), m,
      r_batched ? (long long)m * m : 0LL);
  return int(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* R, const void* dinv, const void* rhs,
                    const void* z, void* Linv, void* x, int B, int m,
                    int r_batched, void* stream) {
  if (rhs == nullptr)
    return launch<T, false, false>(R, dinv, rhs, z, Linv, x, B, m, r_batched, stream);
  if (z == nullptr)
    return launch<T, true, false>(R, dinv, rhs, z, Linv, x, B, m, r_batched, stream);
  return launch<T, true, true>(R, dinv, rhs, z, Linv, x, B, m, r_batched, stream);
}

}  // namespace qpth

// R: (bR, m, m) with bR in {1, B} (r_batched = bR > 1), its lower triangle
// read (the whole R for R z); dinv, rhs, z, x: (B, m); Linv: (B, m, m).
// rhs / z / x may be null (rhs null => z and x unused). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int qpth_factor_inv_f32(const void* R, const void* dinv,
                                   const void* rhs, const void* z, void* Linv,
                                   void* x, int B, int m, int r_batched,
                                   void* stream) {
  return qpth::dispatch<float>(R, dinv, rhs, z, Linv, x, B, m, r_batched, stream);
}

extern "C" int qpth_factor_inv_f64(const void* R, const void* dinv,
                                   const void* rhs, const void* z, void* Linv,
                                   void* x, int B, int m, int r_batched,
                                   void* stream) {
  return qpth::dispatch<double>(R, dinv, rhs, z, Linv, x, B, m, r_batched, stream);
}

// Block barriers one QP of width m passes (with rhs or without, with z).
extern "C" int qpth_factor_inv_barriers(int m, int rhs, int rz) {
  return qpth::factor_inv_barriers(m, rhs != 0, rz != 0);
}

// The largest m at which the launcher takes factor_inv_tile_kernel, in
// float64 (f64 != 0) or float32.
extern "C" int qpth_factor_inv_tile_max(int f64) {
  return f64 ? qpth::TileMaxM<double>::value : qpth::TileMaxM<float>::value;
}

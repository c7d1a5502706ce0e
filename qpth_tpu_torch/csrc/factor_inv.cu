// Kernel A: Linv = inv(chol(R + diag(dinv))), optionally with one solve.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::_factor_inv_call
// (factor_inv_lanes, factor_inv_solve_lanes, factor_inv_solve_rz_lanes).
// One thread block per QP; R is factored and inverted in place in one m x m
// shared-memory tile (40 KB at m = 100 in float32: 5 blocks per SM), so R
// is read from device memory once and Linv written once.
//
// What bounds it on an H100: at B = 4096, m = 100 the bytes (the triangle of
// the symmetric R in, the dense Linv out, 247 MB) take >= 0.074 ms at
// 3.35 TB/s and the ~2/3 m^3 flops per QP >= 0.041 ms at 67 TFLOP/s, so
// bytes bound it. The device-memory traffic is already the minimum (every
// intermediate stays on chip); what sets the time is the chain of m
// dependent pivot steps. common.cuh::chol_inv_smem runs each behind one
// barrier and sweeps only the triangles it needs (m^3 / 3 multiply-adds per
// QP), and the one tile lets 5 blocks share an SM, so the steps of one QP
// overlap those of four others. Register tiling or several QPs per block
// would shorten the chain further.
//
// Variants (compile-time flags of one template):
//   RHS = false            Linv only                    (factor_inv_lanes)
//   RHS = true,  RZ=false  + x = T^-1 rhs               (factor_inv_solve_lanes)
//   RHS = true,  RZ=true   + x = T^-1 (rhs - R z), R z  (factor_inv_solve_rz_lanes)
//                          taken from the raw R in shared memory before the
//                          factorization overwrites it.
#include "common.cuh"

namespace qpth {

template <typename T, bool RHS, bool RZ>
__global__ void __launch_bounds__(kThreads)
factor_inv_kernel(const T* __restrict__ R, const T* __restrict__ dinv,
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

  // inv(L) with its exact zeros above the diagonal: callers multiply the
  // whole matrix.
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
  auto kern = factor_inv_kernel<T, RHS, RZ>;
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

// R: (bR, m, m) with bR in {1, B} (r_batched = bR > 1); dinv, rhs, z, x: (B, m);
// Linv: (B, m, m). rhs / z / x may be null (rhs null => z and x unused).
// Returns the cudaError_t of the launch (0 on success).
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

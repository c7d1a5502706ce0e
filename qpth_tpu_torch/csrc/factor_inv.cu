// Kernel A: Linv = inv(chol(R + diag(dinv))), optionally with one solve.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::_factor_inv_call
// (factor_inv_lanes, factor_inv_solve_lanes, factor_inv_solve_rz_lanes).
// One thread block per QP; R and Linv of that QP sit in shared memory
// (2 m^2 words: 80 KB at m = 100 in float32), so R is read from device
// memory once and Linv written once.
//
// What bounds it on an H100: at B = 4096, m = 100 the bytes (the triangle of
// the symmetric R in, the dense Linv out, 247 MB) take >= 0.074 ms at
// 3.35 TB/s and the ~2/3 m^3 flops per QP >= 0.041 ms at 67 TFLOP/s, so
// bytes bound it. This first version does not
// get near that: each of the m pivot steps is a dependent step behind two
// block barriers, with 2 blocks resident per SM (shared memory bounds
// occupancy). The design keeps every intermediate on chip (the factor L is
// never stored; only its current column lives in a shared vector) so the
// device-memory traffic is already the minimum; the step latency is what a
// later version attacks (register tiling, several QPs per block).
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
  T* Tm = reinterpret_cast<T*>(smem_raw);
  T* Gm = Tm + m * m;
  T* dv = Gm + m * m;
  T* lcol = dv + m;
  T* r = lcol + m;
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

  if (RZ) {
    smem_matvec<T, false>(Tm, zs, w, m);
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += blockDim.x) r[i] -= w[i];
    // chol_inv_smem starts with a barrier after its identity fill.
  }

  chol_inv_smem(Tm, Gm, dv, lcol, m);

  T* Lb = Linv + b * m * m;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) Lb[i] = Gm[i];
  if (RHS) {
    const T xc = apply_inv(Gm, r, w, m);
    if (threadIdx.x < m) x[b * m + threadIdx.x] = xc;
  }
}

template <typename T, bool RHS, bool RZ>
static int launch(const void* R, const void* dinv, const void* rhs,
                  const void* z, void* Linv, void* x, int B, int m,
                  int r_batched, void* stream) {
  auto kern = factor_inv_kernel<T, RHS, RZ>;
  const size_t smem = smem_bytes<T>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
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

// Kernel C: Lt = chol(R + diag(dinv))^T, optionally with one solve.
//
// Replaces the TPU kernels qpth_tpu/ops/pallas/cholesky.py::cholesky_t_pallas
// (no shift), ::factor_kkt_t_pallas (shift dinv = 1/d), and
// qpth_tpu/ops/pallas/lanes.py::factor_kkt_lanes (shift) and
// ::factor_solve_kkt_lanes (shift and x = T^-1 rhs). The lanes layout of the
// last two, (m_p, m_p, B), is a TPU fact: in the port all four are this one
// batch-major function.
//
// One thread block per QP holds T in one m x m shared-memory tile (40 KB at
// m = 100 in float32) and runs common.cuh's
// right-looking rank-1 recurrence with rsqrt pivots, one barrier per pivot
// step; the reference's 16-wide MXU blocking has no use on a thread block.
// Only R's upper triangle is read. With rhs, one warp then runs the forward
// substitution (SAXPY over the rows of Lt) and the back substitution (row dot
// products) on the factor while it is still in shared memory (kernel 9's
// fusion), so the factor is never read back from device memory.
//
// What bounds it on an H100: at B = 4096, m = 100 in float32, R's triangle in
// (83 MB) and Lt out (dense, its zeros written too, 164 MB) take >= 0.074 ms
// at 3.35 TB/s; counting Lt by its triangle, as the port's bound does,
// >= 0.049 ms. Its m^3 / 3 multiply-adds per QP take 0.041 ms at 67 TFLOP/s.
// This first version is bound by the m dependent pivot steps instead.
//
// Variants (compile-time flags of one template):
//   SHIFT = false, RHS = false   chol(R)^T                  (cholesky_t_pallas)
//   SHIFT = true,  RHS = false   chol(R + diag(dinv))^T     (factor_kkt_*)
//   RHS = true                   + x = T^-1 rhs             (factor_solve_kkt_lanes)
#include "common.cuh"

namespace qpth {

template <typename T>
__host__ __device__ constexpr size_t chol_smem_bytes(int m) {
  return (size_t(m) * m + size_t(kCholVectors) * m) * sizeof(T);
}

template <typename T, bool SHIFT, bool RHS>
__global__ void __launch_bounds__(kThreads)
chol_kernel(const T* __restrict__ R, const T* __restrict__ dinv,
            const T* __restrict__ rhs, T* __restrict__ Lt, T* __restrict__ x,
            int m, long long r_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Tm = reinterpret_cast<T*>(smem_raw);
  T* dv = Tm + m * m;
  T* isqv = dv + m;
  T* ys = isqv + m;
  T* xs = ys + m;

  const long long b = blockIdx.x;
  const T* Rb = R + b * r_stride;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) {
    const int r = i / m;
    if (i - r * m >= r) Tm[i] = Rb[i];  // the upper triangle only
  }
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (SHIFT) dv[i] = dinv[b * m + i];
    if (RHS) ys[i] = rhs[b * m + i];
  }
  __syncthreads();

  chol_smem<T, SHIFT>(Tm, dv, isqv, m);

  T* Lb = Lt + b * m * m;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) Lb[i] = Tm[i];
  if (RHS && threadIdx.x < 32) {
    lt_forward_warp(Tm, m, ys, m);
    lt_backward_warp(Tm, m, ys, xs, m);
    for (int i = threadIdx.x; i < m; i += 32) x[b * m + i] = xs[i];
  }
}

template <typename T, bool SHIFT, bool RHS>
static int launch(const void* R, const void* dinv, const void* rhs, void* Lt,
                  void* x, int B, int m, int r_batched, void* stream) {
  auto kern = chol_kernel<T, SHIFT, RHS>;
  const size_t smem = chol_smem_bytes<T>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(R), static_cast<const T*>(dinv),
      static_cast<const T*>(rhs), static_cast<T*>(Lt), static_cast<T*>(x), m,
      r_batched ? (long long)m * m : 0LL);
  return int(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* R, const void* dinv, const void* rhs, void* Lt,
                    void* x, int B, int m, int r_batched, void* stream) {
  if (dinv == nullptr) {
    if (rhs == nullptr)
      return launch<T, false, false>(R, dinv, rhs, Lt, x, B, m, r_batched, stream);
    return launch<T, false, true>(R, dinv, rhs, Lt, x, B, m, r_batched, stream);
  }
  if (rhs == nullptr)
    return launch<T, true, false>(R, dinv, rhs, Lt, x, B, m, r_batched, stream);
  return launch<T, true, true>(R, dinv, rhs, Lt, x, B, m, r_batched, stream);
}

}  // namespace qpth

// R: (bR, m, m) with bR in {1, B} (r_batched = bR > 1), symmetric (its upper
// triangle is read); dinv, rhs, x: (B, m), each may be null (rhs null => x
// unused); Lt: (B, m, m). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int qpth_chol_f32(const void* R, const void* dinv, const void* rhs,
                             void* Lt, void* x, int B, int m, int r_batched,
                             void* stream) {
  return qpth::dispatch<float>(R, dinv, rhs, Lt, x, B, m, r_batched, stream);
}

extern "C" int qpth_chol_f64(const void* R, const void* dinv, const void* rhs,
                             void* Lt, void* x, int B, int m, int r_batched,
                             void* stream) {
  return qpth::dispatch<double>(R, dinv, rhs, Lt, x, B, m, r_batched, stream);
}

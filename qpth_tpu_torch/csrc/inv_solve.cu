// Kernel 5: x = Linv^T (Linv rhs) = T^-1 rhs from the cached inverse factor
// Linv = inv(chol(T)) that kernel A wrote.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::inv_solve_lanes
// (_inv_solve_kernel / _inv_apply). It serves every solve on a factor after
// the first: the corrector and the Gondzio corrections of the composed IPM
// step.
//
// One thread block per QP, and Linv is read from device memory exactly once:
// a warp takes row i, its lanes hold the row's entries in registers, the warp
// sum gives w_i = Linv[i] . rhs, and the same registers then feed the rank-1
// update x += Linv[i]^T w_i into per-lane partial sums. The partial sums of
// the warps meet in shared memory at the end. No m x m tile is kept on chip,
// so the only size limit is m <= kThreads.
//
// What bounds it on an H100: bytes. Only the lower triangle of Linv is read
// (the rest is zero). At B = 4096, m = 100 that is 83 MB in float32 (166 MB
// in float64, which the float64 default runs) plus two (B, m) vectors,
// >= 0.026 ms (0.051 ms) at 3.35 TB/s; its 2 m (m + 1) flops per QP take
// 0.001 ms at 67 TFLOP/s.
#include "common.cuh"

namespace qpth {

constexpr int kColsPerLane = kThreads / 32;  // m <= kThreads

template <typename T>
__global__ void __launch_bounds__(kThreads)
inv_solve_kernel(const T* __restrict__ Linv, const T* __restrict__ rhs,
                 T* __restrict__ x, int m) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* rs = reinterpret_cast<T*>(smem_raw);  // m
  T* part = rs + m;                        // kWarps x m

  const long long b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T* Lb = Linv + b * m * m;
  for (int i = threadIdx.x; i < m; i += blockDim.x) rs[i] = rhs[b * m + i];
  __syncthreads();

  T xacc[kColsPerLane];
#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) xacc[t] = T(0);

  for (int i = warp; i < m; i += kWarps) {
    T row[kColsPerLane];
    T acc = T(0);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) {
      const int c = lane + 32 * t;
      row[t] = c <= i ? Lb[i * m + c] : T(0);  // lower triangle only
      if (c <= i) acc += row[t] * rs[c];
    }
    acc = warp_sum(acc);
#pragma unroll
    for (int t = 0; t < kColsPerLane; ++t) xacc[t] += row[t] * acc;
  }

#pragma unroll
  for (int t = 0; t < kColsPerLane; ++t) {
    const int c = lane + 32 * t;
    if (c < m) part[warp * m + c] = xacc[t];
  }
  __syncthreads();
  const int c = threadIdx.x;
  if (c < m) {
    T s = part[c];
    for (int wi = 1; wi < kWarps; ++wi) s += part[wi * m + c];
    x[b * m + c] = s;
  }
}

template <typename T>
static int launch(const void* Linv, const void* rhs, void* x, int B, int m,
                  void* stream) {
  const size_t smem = size_t(1 + kWarps) * m * sizeof(T);  // <= 18 KB
  inv_solve_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Linv), static_cast<const T*>(rhs),
      static_cast<T*>(x), m);
  return int(cudaGetLastError());
}

}  // namespace qpth

// Linv: (B, m, m) lower triangular; rhs, x: (B, m). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int qpth_inv_solve_f32(const void* Linv, const void* rhs, void* x,
                                  int B, int m, void* stream) {
  return qpth::launch<float>(Linv, rhs, x, B, m, stream);
}

extern "C" int qpth_inv_solve_f64(const void* Linv, const void* rhs, void* x,
                                  int B, int m, void* stream) {
  return qpth::launch<double>(Linv, rhs, x, B, m, stream);
}

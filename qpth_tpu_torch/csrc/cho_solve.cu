// Kernel D: x solving (L L^T) x = v from a Cholesky factor, by two
// triangular substitutions.
//
// Replaces the TPU kernels qpth_tpu/ops/pallas/cholesky.py::
// cho_solve_vec_t_pallas and qpth_tpu/ops/pallas/lanes.py::cho_solve_lanes
// (the same function; the lanes layout is a TPU fact). It is the blocked
// backend's solve2: every solve on T's factor Lt after the first, and, in
// substitution mode, every Q and S11 solve on their factors.
//
// One thread block per QP stages the factor's triangle in shared memory with
// all its threads, then one warp runs the forward substitution in SAXPY form
// over the rows of Lt (row j of Lt is column j of L) and the back
// substitution as row dot products, as cholesky.py:289-308 does. The factor
// comes as Lt (upper, kernel C's output) or as L itself (lower, the layout of
// KKTFactors.L_Q and L_S11): a lower factor is transposed on its way into
// shared memory, so both run the same substitutions. A shared factor (batch
// 1, the OptNet pattern) is read with batch stride 0. The tile's leading
// dimension is odd, so the transposing stores meet no bank conflicts.
//
// What bounds it on an H100: bytes. The factor's triangle in (83 MB at
// B = 4096, n = 100 in float32; 166 MB in float64) and two (B, n) vectors
// take >= 0.026 ms (0.051 ms) at 3.35 TB/s. This first version is bound by
// the 2 n dependent steps of the two substitutions, run by one warp per QP.
#include "common.cuh"

namespace qpth {

constexpr int kSolveThreads = 128;

template <typename T, bool LOWER>
__global__ void __launch_bounds__(kSolveThreads)
cho_solve_kernel(const T* __restrict__ L, const T* __restrict__ v,
                 T* __restrict__ x, int n, int ld, long long l_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* U = reinterpret_cast<T*>(smem_raw);  // Lt, leading dimension ld
  T* ys = U + n * ld;
  T* xs = ys + n;

  const long long b = blockIdx.x;
  const T* Lb = L + b * l_stride;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    if (LOWER) {
      if (c <= r) U[c * ld + r] = Lb[i];  // L[r][c] = Lt[c][r]
    } else if (c >= r) {
      U[r * ld + c] = Lb[i];
    }
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) ys[i] = v[b * n + i];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  lt_forward_warp(U, ld, ys, n);
  lt_backward_warp(U, ld, ys, xs, n);
  for (int i = threadIdx.x; i < n; i += 32) x[b * n + i] = xs[i];
}

template <typename T, bool LOWER>
static int launch(const void* L, const void* v, void* x, int B, int n,
                  int l_batched, void* stream) {
  auto kern = cho_solve_kernel<T, LOWER>;
  const int ld = n | 1;
  const size_t smem = (size_t(n) * ld + 2 * size_t(n)) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<B, kSolveThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(L), static_cast<const T*>(v), static_cast<T*>(x),
      n, ld, l_batched ? (long long)n * n : 0LL);
  return int(cudaGetLastError());
}

template <typename T>
static int dispatch(const void* L, const void* v, void* x, int B, int n,
                    int l_batched, int lower, void* stream) {
  if (lower) return launch<T, true>(L, v, x, B, n, l_batched, stream);
  return launch<T, false>(L, v, x, B, n, l_batched, stream);
}

}  // namespace qpth

// L: (bL, n, n) with bL in {1, B} (l_batched = bL > 1): Lt = L^T (upper,
// lower = 0) or L (lower = 1); v, x: (B, n). Returns the cudaError_t of the
// launch (0 on success).
extern "C" int qpth_cho_solve_f32(const void* L, const void* v, void* x, int B,
                                  int n, int l_batched, int lower,
                                  void* stream) {
  return qpth::dispatch<float>(L, v, x, B, n, l_batched, lower, stream);
}

extern "C" int qpth_cho_solve_f64(const void* L, const void* v, void* x, int B,
                                  int n, int l_batched, int lower,
                                  void* stream) {
  return qpth::dispatch<double>(L, v, x, B, n, l_batched, lower, stream);
}

// Kernel E: invL = inv(L) from Lt = L^T.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/cholesky.py::trinv_pallas (and
// the triangular inverse inside spd_inverse, whose Gram product invL^T invL
// stays a torch.matmul, as it stays outside the Pallas kernel there).
//
// One thread block per QP stages Lt and the inverse in shared memory. Column
// c of inv(L) is the forward substitution L x = e_c, independent of the other
// columns, so thread c runs it in SAXPY form over the rows of Lt:
//   x_j /= Lt[j][j],  x_k -= Lt[j][k] x_j   (k > j),   for j = c .. n-1.
// All threads walk the same (j, k) (thread c idles for j < c), so every read
// of Lt is a broadcast, and
// thread c's column is X[.][c], on consecutive addresses across the warp: no
// barrier after the staging. The output is lower triangular in row layout
// (row i of inv(L) in row i) with exact zeros above the diagonal.
//
// What bounds it on an H100: bytes. At B = 4096, n = 100 in float32 the
// triangles of Lt in and invL out take >= 0.049 ms at 3.35 TB/s; its n^3 / 6
// multiply-adds per QP take 0.020 ms at 67 TFLOP/s. This first version is
// bound by the n^2 / 2 dependent shared-memory steps of column 0.
#include "common.cuh"

namespace qpth {

template <typename T>
__global__ void __launch_bounds__(kThreads)
trinv_kernel(const T* __restrict__ Lt, T* __restrict__ invL, int n, int ld) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* U = reinterpret_cast<T*>(smem_raw);  // Lt
  T* X = U + n * ld;                      // inv(L), X[k][c] at k * ld + c

  const long long b = blockIdx.x;
  const T* Lb = Lt + b * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n, c = i - r * n;
    if (c >= r) U[r * ld + c] = Lb[i];
    X[r * ld + c] = r == c ? T(1) : T(0);
  }
  __syncthreads();
  // Column c is zero above row c: thread c joins at step j = c.
  const int c = threadIdx.x;
  for (int j = 0; j < n; ++j) {
    if (c > j) continue;
    const T xj = X[j * ld + c] / U[j * ld + j];
    X[j * ld + c] = xj;
    for (int k = j + 1; k < n; ++k) X[k * ld + c] -= U[j * ld + k] * xj;
  }
  __syncthreads();
  T* Ob = invL + b * n * n;
  for (int i = threadIdx.x; i < n * n; i += blockDim.x) {
    const int r = i / n;
    Ob[i] = X[r * ld + (i - r * n)];
  }
}

template <typename T>
static int launch(const void* Lt, void* invL, int B, int n, void* stream) {
  const int ld = n | 1;
  const size_t smem = 2 * size_t(n) * ld * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      trinv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  trinv_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Lt), static_cast<T*>(invL), n, ld);
  return int(cudaGetLastError());
}

}  // namespace qpth

// Lt: (B, n, n) upper triangular (the lower part is not read); invL:
// (B, n, n). Returns the cudaError_t of the launch (0 on success).
extern "C" int qpth_trinv_f32(const void* Lt, void* invL, int B, int n,
                              void* stream) {
  return qpth::launch<float>(Lt, invL, B, n, stream);
}

extern "C" int qpth_trinv_f64(const void* Lt, void* invL, int B, int n,
                              void* stream) {
  return qpth::launch<double>(Lt, invL, B, n, stream);
}

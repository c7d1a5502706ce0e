// Kernel E: invL = inv(L) from Lt = L^T.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/cholesky.py::trinv_pallas (and
// the triangular inverse inside spd_inverse, whose Gram product invL^T invL
// stays a torch.matmul, as it stays outside the Pallas kernel there).
//
// One thread block per QP holds Lt and the inverse in one m x m
// shared-memory tile, the layout kernel A inverts in too: Lt's strictly
// upper triangle above the diagonal, inv(L)'s lower triangle and diagonal on
// and below it, and the reciprocals of Lt's diagonal in one m-vector. It
// launches with kernel C's working set (panel.cuh::chol_smem_bytes, checked
// by kernels.py::chol_fits: m <= 239 in float32, <= 168 in float64):
// whatever C factors, E inverts. The algorithm is the TPU kernel's
// _trinv_kernel (cholesky.py:203) in panels of 32 rows
// (panel.cuh::trinv_panels, which kernel A calls on its own factor):
//   * all nb = ceil(m / 32) <= 8 diagonal blocks are inverted at once, one
//     warp each, X_ii = inv(L_ii) by forward substitution in registers;
//   * then for row block i = 1 .. nb - 1, with L[i, :i] read as Lt's columns,
//       C = -L[i, :i] invL[:i, :i]      all warps, 4 x 4 register tiles,
//       invL[i, :i] = X_ii C            a thread per column, in place.
// Barriers: 1 after the staging, 1 after the diagonal blocks and 2 per row
// block, 2 nb in all (8 at m = 100), and no dependent chain longer than a
// diagonal block's 32 steps. The output is lower triangular in row layout
// (row i of inv(L) in row i) with exact zeros above the diagonal.
//
// What bounds it on an H100: bytes. At B = 4096, n = 100 in float32 the
// triangles of Lt in and invL out take >= 0.049 ms at 3.35 TB/s; its n^3 / 6
// multiply-adds per QP take 0.020 ms at 67 TFLOP/s. The diagonal blocks'
// chains (32 steps, one warp each, all at once) and the 2 nb barriers are
// what a block waits on; the one tile lets 4 (float32, the register cap) or
// 2 (float64) blocks share an SM.
#include "panel.cuh"

namespace qpth {

__host__ __device__ constexpr int trinv_barriers(int n) {
  return 2 * ((n + kPanelWidth - 1) / kPanelWidth);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, PanelBlocks<T>::value)
trinv_kernel(const T* __restrict__ Lt, T* __restrict__ invL, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Tm = reinterpret_cast<T*>(smem_raw);
  T* rd = Tm + n * n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const long long b = blockIdx.x;
  const T* Lb = Lt + b * n * n;
  for (int r = warp; r < n; r += kWarps)  // the upper triangle only
    for (int c = r + lane; c < n; c += 32) {
      const T v = Lb[r * n + c];
      if (c > r) Tm[r * n + c] = v;
      else rd[r] = T(1) / v;
    }
  __syncthreads();

  trinv_panels(Tm, n, rd, 0, kWarps, warp, lane);
  store_triangle<T, false>(invL + b * n * n, Tm, n, 0, kWarps, warp, lane);
}

template <typename T>
static int launch(const void* Lt, void* invL, int B, int n, void* stream) {
  const size_t smem = chol_smem_bytes<T>(n);  // kernel C's working set
  const cudaError_t err = set_smem(trinv_kernel<T>, smem);
  if (err != cudaSuccess) return int(err);
  trinv_kernel<T><<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Lt), static_cast<T*>(invL), n);
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

// Block barriers one QP of width n passes.
extern "C" int qpth_trinv_barriers(int n) { return qpth::trinv_barriers(n); }

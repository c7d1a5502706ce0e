// Kernel C: Lt = chol(R + diag(dinv))^T, optionally with one solve.
//
// Replaces the TPU kernels qpth_tpu/ops/pallas/cholesky.py::cholesky_t_pallas
// (no shift), ::factor_kkt_t_pallas (shift dinv = 1/d), and
// qpth_tpu/ops/pallas/lanes.py::factor_kkt_lanes (shift) and
// ::factor_solve_kkt_lanes (shift and x = T^-1 rhs). The lanes layout of the
// last two, (m_p, m_p, B), is a TPU fact: in the port all four are this one
// batch-major function.
//
// One thread block per QP stages R's upper triangle in one m x m
// shared-memory tile (40 KB at m = 100 in float32) and factors it
// right-looking in panels of 32 rows (panel.cuh::factor_panels, which the
// fused IPM steps share), as the TPU kernel's
// _chol_blocked_writeout (cholesky.py:92) does in panels of 16:
//   (a) one warp factors the panel's diagonal block in registers, folding the
//       shift into each pivot when it is reached, the pivots' rsqrt to isqv;
//   (b) every thread solves one column of the panel's rows beyond the block,
//       Lt[p, rest] = U_pp^-T T[p, rest], by forward substitution with isqv,
//       in sub-blocks of 8 rows (panel.cuh). The JAX kernel's W = X_pp
//       T[p, rest] would need X_pp = inv(U_pp^T) formed first, a second
//       32-step chain on the critical path; a variant that ran (b) as
//       16-row chains with the warps' register tiles between them was
//       slower on the card (PERF.md §6).
//   (c) the warps apply the rank-32 update T[rest, rest] -= W^T W to the
//       upper triangle on register tiles: first all eight to the next
//       panel's diagonal block (4 rows each), then warp 0 factors it, (a)
//       of the next panel, while the other seven update the rest (4 x 4
//       per lane).
// Barriers: 1 after the staging, 1 after the first (a), then 1 after (b),
// after the diagonal block's update and after (c): 3 per panel, 12 per QP
// at m = 100 (32 + 32 + 32 + 4). Every element receives its rank-1 updates
// in pivot order, as in kernels.py::chol_plain.
//
// With rhs, the forward substitution y = L^-1 rhs rides in the panel loop
// as one more column of (b) and (c) (y is the extra column of the augmented
// matrix's factor). The back substitution L^T x = y then runs by panels
// from the last (panel.cuh::back_panels): warp 0 runs the diagonal block's
// chain with isqv (no division) while the other warps update the rows above
// (and, at the first panel, write Lt out); 1 barrier per panel more, 16
// per QP at m = 100 in all. The factor never leaves shared memory in
// between.
//
// What bounds it on an H100: bytes. At B = 4096, m = 100 in float32, R's
// triangle in and Lt out (by its triangle, as the port's bound counts it)
// take >= 0.049 ms at 3.35 TB/s; its m^3 / 3 multiply-adds per QP take
// 0.041 ms at 67 TFLOP/s (0.081 ms in float64 at 34). The design takes the
// dependent pivot steps off the block's critical path (32-step chains in one
// warp per panel, beside the other warps' updates) and cuts the
// shared-memory accesses per multiply-add from three to a half (register
// tiles); what is left is the chains and
// barriers of 4 panels against 2 (float64) to 4 (float32) blocks per SM
// (PERF.md §6).
//
// Variants (compile-time flags of one template):
//   SHIFT = false, RHS = false   chol(R)^T                  (cholesky_t_pallas)
//   SHIFT = true,  RHS = false   chol(R + diag(dinv))^T     (factor_kkt_*)
//   RHS = true                   + x = T^-1 rhs             (factor_solve_kkt_lanes)
#include "panel.cuh"

namespace qpth {

// Block barriers one QP passes: the staging's, the first (a)'s, (b) of each
// panel, and the diagonal block's update and (c) of all but the last; with
// rhs 1 per panel more for the back substitution.
__host__ __device__ constexpr int chol_barriers(int m, bool rhs) {
  return 3 * panels(m) + (rhs ? panels(m) : 0);
}

template <typename T, bool SHIFT, bool RHS>
__global__ void __launch_bounds__(kThreads, PanelBlocks<T>::value)
chol_kernel(const T* __restrict__ R, const T* __restrict__ dinv,
            const T* __restrict__ rhs, T* __restrict__ Lt, T* __restrict__ x,
            int m, long long r_stride) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Tm = reinterpret_cast<T*>(smem_raw);
  T* dv = Tm + m * m;
  T* isqv = dv + m;
  T* ys = isqv + m;
  T* xs = ys + m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  const long long b = blockIdx.x;
  const T* Rb = R + b * r_stride;
  for (int r = warp; r < m; r += kWarps)  // the upper triangle only
    for (int c = r + lane; c < m; c += 32) Tm[r * m + c] = Rb[r * m + c];
  for (int i = threadIdx.x; i < m; i += blockDim.x) {
    if (SHIFT) dv[i] = dinv[b * m + i];
    if (RHS) ys[i] = rhs[b * m + i];
  }
  __syncthreads();

  factor_panels<T, SHIFT, RHS>(Tm, SquareTile{m, m}, dv, isqv, ys, warp, lane);

  T* Lb = Lt + b * m * m;
  if (!RHS) {
    store_triangle<T, true>(Lb, Tm, m, 0, kWarps, warp, lane);
    return;
  }

  // Back substitution Lt x = y (back_panels). The other warps write Lt out
  // while warp 0 copies y and runs the last panel's chain.
  if (warp == 0) {
    for (int i = lane; i < m; i += 32) xs[i] = ys[i];
  } else {
    store_triangle<T, true>(Lb, Tm, m, 1, kWarps - 1, warp, lane);
  }
  back_panels(Tm, SquareTile{m, m}, isqv, xs, warp, lane);
  for (int i = threadIdx.x; i < m; i += blockDim.x) x[b * m + i] = xs[i];
}

template <typename T, bool SHIFT, bool RHS>
static int launch(const void* R, const void* dinv, const void* rhs, void* Lt,
                  void* x, int B, int m, int r_batched, void* stream) {
  auto kern = chol_kernel<T, SHIFT, RHS>;
  const size_t smem = chol_smem_bytes<T>(m);
  const cudaError_t err = set_smem(kern, smem);
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

// Block barriers one QP of width m passes (with rhs or without).
extern "C" int qpth_chol_barriers(int m, int rhs) {
  return qpth::chol_barriers(m, rhs != 0);
}

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
// right-looking in panels of 32 rows (panel.cuh), as the TPU kernel's
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
// from the last: warp 0 runs the diagonal block's chain with isqv (no
// division) while the other warps update the rows above (and, at the first
// panel, write Lt out); 1 barrier per panel more, 16 per QP at m = 100 in
// all. The factor never leaves shared memory in between.
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

__host__ __device__ constexpr int panels(int m) {
  return (m + kPanelWidth - 1) / kPanelWidth;
}

// Block barriers one QP passes: the staging's, the first (a)'s, (b) of each
// panel, and the diagonal block's update and (c) of all but the last; with
// rhs 1 per panel more for the back substitution.
__host__ __device__ constexpr int chol_barriers(int m, bool rhs) {
  return 3 * panels(m) + (rhs ? panels(m) : 0);
}

// One warp's 4 MI x 32 tile at (rb, cb) of the trailing matrix takes the
// panel's rank-w update, T[r][c] -= sum_k W[k][r] W[k][c] (W: the panel's
// rows of Lt, leading dimension m), on and above the diagonal.
template <typename T, int MI>
__device__ __forceinline__ void update_tile(T* Tm, const T* W, int m, int w,
                                            int rb, int cb, int lane) {
  int r[MI], c[4], ar[MI], bc[4];
  tile_coords<MI>(rb, cb, lane, r, c);
#pragma unroll
  for (int i = 0; i < MI; ++i) ar[i] = min(r[i], m - 1);
#pragma unroll
  for (int q = 0; q < 4; ++q) bc[q] = min(c[q], m - 1);
  T acc[MI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[i][q] = Tm[ar[i] * m + bc[q]];
  tile_update<T, false, MI>(acc, W, W, m, ar, bc, 0, w);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r[i] < m && c[q] < m && c[q] >= r[i]) Tm[r[i] * m + c[q]] = acc[i][q];
}

// x_i -= sum_{k < w} Lt[i][p0 + k] x[p0 + k]: row i above panel p0 takes
// the panel's solution.
template <typename T>
__device__ __forceinline__ void back_update_row(const T* Tm, int m, int p0,
                                                int w, T* xs, int i) {
  const T* Ui = Tm + i * m + p0;
  T acc = xs[i];
  for (int k = 0; k < w; ++k) acc -= Ui[k] * xs[p0 + k];
  xs[i] = acc;
}

// One warp's chain of the back substitution over panel p0's w x w diagonal
// block, column order, k descending: x_k = r_k isq_k, r_i -= Lt[i][k] x_k
// (i < k); lane i holds r_i, the pivot's reciprocal is isqv's rsqrt.
template <typename T>
__device__ __forceinline__ void back_chain(const T* Tm, int m, int p0, int w,
                                           const T* isqv, T* xs, int lane) {
  const bool on = lane < w;
  const T* Ui = Tm + (p0 + (on ? lane : 0)) * m + p0;
  const T isq = on ? isqv[p0 + lane] : T(0);
  T rv = on ? xs[p0 + lane] : T(0);
#pragma unroll
  for (int k = kPanelWidth - 1; k >= 0; --k) {
    if (k >= w) continue;
    if (lane == k) rv *= isq;
    const T xk = __shfl_sync(kWarpAll, rv, k);
    if (on && lane < k) rv -= Ui[k] * xk;
  }
  if (on) xs[p0 + lane] = rv;
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

  // (a) of the first panel; each later panel's (a) rides in the previous
  // panel's (c).
  if (warp == 0) chol_diag_block<T, SHIFT>(Tm, m, 0, min(kPanelWidth, m), dv, isqv, lane);
  __syncthreads();
  for (int p0 = 0; p0 < m; p0 += kPanelWidth) {
    const int w = min(kPanelWidth, m - p0);
    const int base = p0 + w, rest = m - base;
    // (b) the panel's rows beyond the diagonal block, a column per thread;
    // with rhs, y's panel as one more column.
    for (int t = threadIdx.x; t < rest + (RHS ? 1 : 0); t += blockDim.x) {
      const bool is_y = RHS && t == rest;
      panel_solve_column(Tm, m, p0, w, isqv, is_y ? ys + p0 : Tm + p0 * m + base + t,
                         is_y ? 1 : m);
    }
    __syncthreads();
    if (rest == 0) break;
    // (c) the rank-w update of the trailing upper triangle. First the next
    // panel's diagonal block, 4 rows a warp; then warp 0 factors it, (a) of
    // the next panel, while the other warps update the rest (and y) in
    // tiles of 16 x 32.
    const T* W = Tm + p0 * m;
    if (4 * warp < min(kPanelWidth, rest))
      update_tile<T, 1>(Tm, W, m, w, base + 4 * warp, base, lane);
    __syncthreads();
    if (warp == 0) {
      chol_diag_block<T, SHIFT>(Tm, m, base, min(kPanelWidth, rest), dv, isqv, lane);
    } else {
      const int ntc = (rest + kTileCols - 1) / kTileCols;
      const int ntiles = ntc * ((rest + kTileRows - 1) / kTileRows);
      for (int t = warp - 1; t < ntiles; t += kWarps - 1) {
        const int tr = t / ntc, tc = t - tr * ntc;
        // Skip the tiles wholly below the diagonal, and the diagonal block's.
        if (tc < tr / 2 || (tc == 0 && tr < 2)) continue;
        update_tile<T, 4>(Tm, W, m, w, base + kTileRows * tr, base + kTileCols * tc, lane);
      }
      for (int t = threadIdx.x - 32; RHS && t < rest; t += blockDim.x - 32) {
        T acc = ys[base + t];
        for (int k = 0; k < w; ++k) acc -= W[k * m + base + t] * ys[p0 + k];
        ys[base + t] = acc;
      }
    }
    __syncthreads();
  }

  T* Lb = Lt + b * m * m;
  if (!RHS) {
    store_triangle<T, true>(Lb, Tm, m, 0, kWarps, warp, lane);
    return;
  }

  // Back substitution Lt x = y, panels descending, in column order. Warp 0
  // runs each panel's chain (back_chain) while the other warps write Lt out
  // (first panel) or apply the panel before to the rows above the next one;
  // warp 0 applies it to the next panel's own rows first: 1 barrier per
  // panel.
  int p0 = (panels(m) - 1) * kPanelWidth;
  if (warp == 0) {
    for (int i = lane; i < m; i += 32) xs[i] = ys[i];
    __syncwarp();
    back_chain(Tm, m, p0, m - p0, isqv, xs, lane);
  } else {
    store_triangle<T, true>(Lb, Tm, m, 1, kWarps - 1, warp, lane);
  }
  __syncthreads();
  for (; p0 > 0; p0 -= kPanelWidth) {
    const int w = min(kPanelWidth, m - p0), q0 = p0 - kPanelWidth;
    if (warp == 0) {
      back_update_row(Tm, m, p0, w, xs, q0 + lane);
      __syncwarp();
      back_chain(Tm, m, q0, kPanelWidth, isqv, xs, lane);
    } else {
      for (int i = threadIdx.x - 32; i < q0; i += blockDim.x - 32)
        back_update_row(Tm, m, p0, w, xs, i);
    }
    __syncthreads();
  }
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

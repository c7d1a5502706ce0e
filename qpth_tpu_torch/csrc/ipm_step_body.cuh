// Shared body of the three fused-step kernels: one whole Mehrotra iteration
// per QP, in one of three modes:
//   kStepXFree (ipm_step_xfree.cu): neq = 0, x never enters; writes
//     zeta = z + dz for the caller's coefficient-tracked x;
//   kStepX (ipm_step.cu): neq = 0 with the direct x update;
//   kStepEq (ipm_step_eq.cu): equality constraints, the y and x updates.
//
// It follows the TPU kernels qpth_tpu/ops/pallas/lanes.py::
// _ipm_step_xfree_kernel, ::_ipm_step_kernel and ::_ipm_step_eq_kernel line by
// line ([EQ]: kStepEq only; [X]: every mode but kStepXFree):
//   [EQ] r1 = rb + S21^T z + S11 y;  u = S11^-1 (-r1);
//        rhs_a = q - S21 (W z + y + u) - R z          (else rhs_a = q - R z)
//   factor T = R + diag(s/z) in one m x m tile (R z is taken from the raw R
//   first);
//   predictor dz_a = T^-1 rhs_a, ds_a = (-z - dz_a)/d, [EQ] dy_a = u - W dz_a;
//   Mehrotra centering sigma = (t1/t2)^3, mu = |t2|/m; corrector, [EQ] with
//   dy -= W dz_c; n_correctors Gondzio passes, each accepted per QP when it
//   lengthens the step, [EQ] with dy -= W ddz on acceptance;
//   [X] dx = -(x + Q^-1 p) - Q^-1 G^T (z + dz) [- Q^-1 A^T (y + dy)];
//   alpha2 = min(0.999 step, 1); a NaN in any of dz, ds, dx, dy freezes the
//   QP: alpha = 0 and every direction masked.
//
// One thread block per QP. R sits in one m x m shared-memory tile; thread i
// keeps element i of every m-vector (s, z, d, dz, ds, ...) in registers, and
// the per-QP min / sum reductions are block reductions. T = R + diag(s/z) is
// factored in place on kernel C's 32-row panels (panel.cuh::factor_panels:
// one warp's register chain per diagonal block, the trailing updates on 4 x 4
// register tiles, 3 barriers a panel), with the predictor's RHS riding as
// one more column (its forward substitution), then back_panels for dz_a.
// The corrector and each Gondzio pass are one forward and one back
// substitution by panels from the factor left in the tile (solve_panels:
// warp 0 runs each 32-step chain while the other warps apply the
// off-diagonal blocks). No inverse is formed, and nothing but the step's
// outputs is written to device memory. The panel routines read the tile's
// upper triangle: R's lower one is mirrored onto it first (R = G Q^-1 G^T
// from a product need not be bitwise symmetric; the plain version reads the
// lower triangle), after R z is taken from the raw R.
//
// Barriers (x-free mode, step_barriers): 3 before the factor, 3 P - 1 in
// it, P in the predictor's back substitution, 2 P - 1 a further solve, 2 a
// block reduction, 1 for the freeze, with P = ceil(m / 32) panels: 34 at
// m = 100 and n_correctors = 0, + 11 a Gondzio pass (the factor-inverse
// with one barrier a pivot passed ~115). The panels' chains and the
// barriers between them set its time, against 4 (float32, the register cap
// of __launch_bounds__) or 2 (float64) blocks an SM.
//
// The nz- and neq-vectors (dx; y, u, dy and one scratch) live in shared
// memory and are walked with strided loops, so nz and neq are not tied to the
// thread count. Q^-1 G^T and the equality operands (S21, W, S11^-1, S11,
// Q^-1 A^T) do not fit beside the tile; they are read from device memory
// where they are used, one warp per row with its lanes on consecutive
// addresses. Each carries its own batch flag: a shared operand is read with
// batch stride 0 and stays in L2.
#pragma once

#include "panel.cuh"

namespace qpth {

// Bits of StepArgs::batched: the operand has batch B (else 1).
enum StepOperand {
  kOpR = 1, kOpIGT = 2, kOpS21 = 4, kOpW = 8, kOpIS11 = 16, kOpS11 = 32,
  kOpIAT = 64
};

template <typename T>
struct StepArgs {
  const T *R, *iGT, *S21, *W, *iS11, *S11, *iAT;  // matrices
  const T *x, *s, *z, *y, *q, *ip, *rb;           // state and invariants
  T *x_out, *s_out, *z_out, *y_out, *a_out;
  T *zeta_out;  // kStepXFree only
  int m, nz, neq, batched, n_correctors;
};

enum StepMode { kStepXFree, kStepX, kStepEq };

// Block barriers one QP passes in the x-free mode (the header's count); the
// other modes add the equality algebra's and the dx pass's.
__host__ __device__ constexpr int step_barriers(int m, int n_correctors) {
  return 6 * panels(m) + 10 + n_correctors * (2 * panels(m) + 3);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads, PanelBlocks<T>::value)
ipm_step_kernel(StepArgs<T> a) {
  constexpr bool EQ = MODE == kStepEq;
  constexpr bool DX = MODE != kStepXFree;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kWarps];
  const int m = a.m, nz = DX ? a.nz : 0, neq = EQ ? a.neq : 0;
  T* Tm = reinterpret_cast<T*>(smem_raw);  // R, then Lt above the diagonal
  T* dv = Tm + m * m;                      // s / z, the factor's shift
  T* isqv = dv + m;                        // the pivots' rsqrt
  T* xs = isqv + m;                        // the substitutions' vector
  T* w = xs + m;                           // R z
  T* zs = w + m;                           // z, then scratch
  T* ss = zs + m;                          // s across the factor
  // S21 (W z + y + u), until the predictor's RHS is formed.
  T* lcol = ss + m;
  T* dxs = Tm + m * m + kSmemVectors * m;  // nz
  T* ys = dxs + nz;                        // neq each from here
  T* us = ys + neq;
  T* dys = us + neq;
  T* ts = dys + neq;

  const long long b = blockIdx.x;
  const int i = threadIdx.x;
  const int lane = i & 31, warp = i >> 5;
  const bool act = i < m;
  const T* Rb = operand(a.R, a.batched, kOpR, b, size_t(m) * m);
  const T* iGT = DX ? operand(a.iGT, a.batched, kOpIGT, b, size_t(nz) * m) : nullptr;
  const T* Wm = nullptr;
  const T* iAT = nullptr;
  for (int k = i; k < m * m; k += blockDim.x) Tm[k] = Rb[k];

  if (act) {
    const T s0 = a.s[b * m + i], z0 = a.z[b * m + i];
    dv[i] = s0 / z0;
    zs[i] = z0;
    ss[i] = s0;
  }
  if (EQ)
    for (int c = i; c < neq; c += blockDim.x) ys[c] = a.y[b * neq + c];
  __syncthreads();

  if (EQ) {
    const T* S21 = operand(a.S21, a.batched, kOpS21, b, size_t(m) * neq);
    const T* iS11 = operand(a.iS11, a.batched, kOpIS11, b, size_t(neq) * neq);
    const T* S11 = operand(a.S11, a.batched, kOpS11, b, size_t(neq) * neq);
    Wm = operand(a.W, a.batched, kOpW, b, size_t(neq) * m);
    iAT = operand(a.iAT, a.batched, kOpIAT, b, size_t(nz) * neq);
    // ts = -r1 = -(rb + S21^T z + S11 y): S11 y by rows, S21^T z by columns
    // (thread c walks column c, neighbours on neighbouring addresses).
    gmem_matvec(S11, ys, ts, neq, neq);
    __syncthreads();
    for (int c = i; c < neq; c += blockDim.x) {
      T acc = T(0);
      for (int k = 0; k < m; ++k) acc += S21[size_t(k) * neq + c] * zs[k];
      ts[c] = -((a.rb[b * neq + c] + acc) + ts[c]);
    }
    __syncthreads();
    gmem_matvec(iS11, ts, us, neq, neq);  // u
    __syncthreads();
    gmem_matvec(Wm, zs, ts, neq, m);      // W z
    __syncthreads();
    for (int c = i; c < neq; c += blockDim.x) ts[c] = (ts[c] + ys[c]) + us[c];
    __syncthreads();
    gmem_matvec(S21, ts, lcol, m, neq);   // S21 (W z + y + u)
    __syncthreads();
  }

  // Predictor RHS, with R z from the whole raw R; then R's lower triangle is
  // mirrored onto the upper one, which the panel routines read (a warp per
  // row, reads below the diagonal and writes above it never meet).
  smem_matvec<T, false>(Tm, zs, w, m);
  __syncthreads();
  if (act) {
    const T q = a.q[b * m + i];
    xs[i] = EQ ? (q - lcol[i]) - w[i] : q - w[i];
  }
  for (int r = warp; r < m; r += kWarps)
    for (int c = lane; c < r; c += 32) Tm[c * m + r] = Tm[r * m + c];
  __syncthreads();

  // T's factor, with the predictor's forward substitution riding in it.
  factor_panels<T, true, true>(Tm, m, dv, isqv, xs, warp, lane);

  // x = T^-1 r for r held one element per thread.
  auto solve = [&](T r) { return solve_panels(Tm, m, isqv, xs, r, warp, lane); };

  const MinOp mn;
  const SumOp sm;
  const T one = T(1);
  const T inf = inf_t<T>();

  // ts = W v for an m-vector held one element per thread (zs is free once
  // R z is taken and z is back in a register). Ends with a barrier.
  auto w_apply = [&](T v) {
    if (act) zs[i] = v;
    __syncthreads();
    gmem_matvec(Wm, zs, ts, neq, m);
    __syncthreads();
  };

  // Predictor: the back substitution of the riding column.
  back_panels(Tm, m, isqv, xs, warp, lane);
  const T s = act ? ss[i] : T(1);
  const T z = act ? zs[i] : T(1);
  const T d = z / s;
  const T dz_a = act ? xs[i] : T(0);
  const T ds_a = (-z - dz_a) / d;
  if (EQ) {
    w_apply(dz_a);
    for (int c = i; c < neq; c += blockDim.x) dys[c] = us[c] - ts[c];
  }
  const T alpha = nan_min(
      block_reduce(act ? nan_min(step_of(z, dz_a), step_of(s, ds_a)) : inf, mn, red), one);
  const T t2 = block_reduce(act ? s * z : T(0), sm, red);
  const T t1 = block_reduce(
      act ? (s + alpha * ds_a) * (z + alpha * dz_a) : T(0), sm, red);
  const T ratio = t1 / t2;
  const T sig = ratio * ratio * ratio;
  const T mu = fabs(t2) / T(m);

  // Corrector (RHS zero except rs).
  const T rs_c = (-(mu * sig) + ds_a * dz_a) / s;
  const T dz_c = solve(-(rs_c / d));
  const T ds_c = (-rs_c - dz_c) / d;
  T dz = dz_a + dz_c;
  T ds = ds_a + ds_c;
  if (EQ) {
    w_apply(dz_c);
    for (int c = i; c < neq; c += blockDim.x) dys[c] -= ts[c];
  }

  // Gondzio centrality correctors.
  for (int g = 0; g < a.n_correctors; ++g) {
    const T a_g = nan_min(
        block_reduce(act ? nan_min(step_of(z, dz), step_of(s, ds)) : inf, mn, red), one);
    const T a_t = nan_min(T(1.08) * a_g + T(0.08), one);
    const T v = (s + a_t * ds) * (z + a_t * dz);
    const T mu_t = sig * mu;
    const T rs_g = (v - nan_min(nan_max(v, T(0.1) * mu_t), T(10.0) * mu_t)) / s;
    const T ddz = solve(-(rs_g / d));
    const T dds = (-rs_g - ddz) / d;
    const T dz_n = dz + ddz;
    const T ds_n = ds + dds;
    const T a_n = nan_min(
        block_reduce(act ? nan_min(step_of(z, dz_n), step_of(s, ds_n)) : inf, mn, red), one);
    if (a_n > a_g) {  // uniform across the block; false on NaN
      dz = dz_n;
      ds = ds_n;
      if (EQ) {
        w_apply(ddz);
        for (int c = i; c < neq; c += blockDim.x) dys[c] -= ts[c];
      }
    }
  }

  // Combined dx, one warp per row of Q^-1 G^T (and Q^-1 A^T).
  if (DX) {
    if (act) zs[i] = z + dz;
    if (EQ)
      for (int c = i; c < neq; c += blockDim.x) ts[c] = ys[c] + dys[c];
    __syncthreads();
  }
  for (int k = warp; k < nz; k += kWarps) {
    const T* grow = iGT + size_t(k) * m;
    T acc = T(0);
    for (int c = lane; c < m; c += 32) acc += grow[c] * zs[c];
    acc = warp_sum(acc);
    T acc_y = T(0);
    if (EQ) {
      const T* arow = iAT + size_t(k) * neq;
      for (int c = lane; c < neq; c += 32) acc_y += arow[c] * ts[c];
      acc_y = warp_sum(acc_y);
    }
    if (lane == 0) {
      const T xp = a.x[b * nz + k] + a.ip[b * nz + k];
      dxs[k] = EQ ? (-xp - acc) - acc_y : -acc - xp;
    }
  }
  if (DX) __syncthreads();

  T alpha2 = nan_min(
      T(0.999) * block_reduce(act ? nan_min(step_of(z, dz), step_of(s, ds)) : inf, mn, red),
      one);
  bool bad = act && (isnan(dz) || isnan(ds));
  for (int k = i; k < nz; k += blockDim.x) bad = bad || isnan(dxs[k]);
  if (EQ)
    for (int c = i; c < neq; c += blockDim.x) bad = bad || isnan(dys[c]);
  const bool frozen = __syncthreads_or(bad);
  if (frozen) alpha2 = T(0);
  for (int k = i; k < nz; k += blockDim.x)
    a.x_out[b * nz + k] = a.x[b * nz + k] + alpha2 * (frozen ? T(0) : dxs[k]);
  if (act) {
    const T dz_m = frozen ? T(0) : dz;
    if (!DX) a.zeta_out[b * m + i] = z + dz_m;
    a.s_out[b * m + i] = s + alpha2 * (frozen ? T(0) : ds);
    a.z_out[b * m + i] = z + alpha2 * dz_m;
  }
  if (EQ)
    for (int c = i; c < neq; c += blockDim.x)
      a.y_out[b * neq + c] = ys[c] + alpha2 * (frozen ? T(0) : dys[c]);
  if (i == 0) a.a_out[b] = alpha2;
}

template <typename T, int MODE>
static int launch_step(const StepArgs<T>& a, int B, void* stream) {
  auto kern = ipm_step_kernel<T, MODE>;
  const size_t smem = smem_bytes<T>(a.m, MODE != kStepXFree ? a.nz : 0,
                                    MODE == kStepEq ? a.neq : 0);
  cudaError_t err = set_smem(kern, smem);
  if (err != cudaSuccess) return int(err);
  kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

}  // namespace qpth

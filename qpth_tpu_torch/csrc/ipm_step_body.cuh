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
//   factor T = R + diag(s/z) in one tile (R z is taken from the raw R
//   first);
//   predictor dz_a = T^-1 rhs_a, ds_a = (-z - dz_a)/d, [EQ] dy_a = u - W dz_a;
//   Mehrotra centering sigma = (t1/t2)^3, mu = |t2|/m; corrector, [EQ] with
//   dy -= W dz_c; n_correctors Gondzio passes, each accepted per QP when it
//   lengthens the step, [EQ] with dy -= W ddz on acceptance;
//   [X] dx = -(x + Q^-1 p) - Q^-1 G^T (z + dz) [- Q^-1 A^T (y + dy)];
//   alpha2 = min(0.999 step, 1); a NaN in any of dz, ds, dx, dy freezes the
//   QP: alpha = 0 and every direction masked.
//
// One thread block per QP. T sits in one shared-memory tile; thread i keeps
// element i of every m-vector (s, z, d, dz, ds, ...) in registers, and the
// per-QP min / sum reductions are block reductions. T = R + diag(s/z) is
// factored in place on kernel C's 32-row panels (panel.cuh::factor_panels:
// one warp's register chain per diagonal block, the trailing updates on 4 x 4
// register tiles, 3 barriers a panel), with the predictor's RHS riding as
// one more column (its forward substitution), then back_panels for dz_a.
// The corrector and each Gondzio pass are one forward and one back
// substitution by panels from the factor left in the tile (solve_panels:
// warp 0 runs each 32-step chain while the other warps apply the
// off-diagonal blocks). No inverse is formed, and nothing but the step's
// outputs is written to device memory. The panel routines read the tile's
// upper triangle, where R's lower one is mirrored (R = G Q^-1 G^T from a
// product need not be bitwise symmetric; the plain version reads the lower
// triangle). One pass over R's rows in device memory, a warp a row, stages
// the tile and takes R z from the raw R: each row is read once, one barrier
// follows, and R z is summed in smem_matvec's order, so it has the bits of a
// matvec from a tile holding the whole R.
//
// One body, instantiated by the warps a block (step_warps): float32 up to
// m = kSixWarpMaxM in blocks of 6 warps, 5 an SM, else 8 warps, 4 an SM in
// float32 and 2 in float64; the rows of the tile padded to an odd stride
// where that fits (prepare_step). Each element receives the same operations
// in the same order in both: the panel routines differ only in how their
// independent work is dealt to the warps, and a block reduction's partials
// of warps past m are their identity.
//
// Barriers (x-free mode, step_barriers): 2 before the factor, 3 P - 1 in
// it, P in the predictor's back substitution, 2 P - 1 a further solve, 2 a
// block reduction, 1 for the freeze, with P = ceil(m / 32) panels: 33 at
// m = 100 and n_correctors = 0, + 11 a Gondzio pass (the factor-inverse
// with one barrier a pivot passed ~115).
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

// The widest float32 QP whose step runs in blocks of 6 warps. A block's time
// is its one-warp chains and the barriers after them, so the blocks an SM
// holds at once set the kernel's time. 8-warp blocks are held to 4 an SM by
// their 64 registers a thread; 6-warp blocks, at the same registers, fit 5
// up to m = 100 (43.6 KB of shared memory a block there, in every mode while
// nz + 4 neq <= 511), and past m ~ 102 shared memory holds them to 4 too,
// where 8 warps share the same work faster (float32 on the card, B = 4096,
// x-free step: m = 100 6 warps 0.524 ms, 8 warps 0.581; m = 112-192 8 warps
// fastest; PERF.md §6). Float64's 8-warp blocks fit 2 an SM by shared
// memory, as 6-warp blocks would.
constexpr int kSixWarpMaxM = 100;

template <typename T>
__host__ __device__ constexpr int step_warps(int m) {
  return sizeof(T) == 4 && m <= kSixWarpMaxM ? 6 : kWarps;
}

// Blocks an SM an instantiation of NW warps is compiled for
// (__launch_bounds__): as many as the 8-warp blocks' registers a thread
// allow (64 in float32, 128 in float64).
template <typename T, int NW>
struct StepBlocks {
  static constexpr int value = PanelBlocks<T>::value * kWarps / NW;
};

// R's rows, and columns a lane, each warp of the staging pass has in
// flight at once.
constexpr int kStageRows = 4;
constexpr int kStageCols = 4;

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
  int ld;  // the tile's row stride (prepare_step sets it)
};

enum StepMode { kStepXFree, kStepX, kStepEq };

// Block barriers one QP passes in the x-free mode (the header's count); the
// other modes add the equality algebra's and the dx pass's.
__host__ __device__ constexpr int step_barriers(int m, int n_correctors) {
  return 6 * panels(m) + 9 + n_correctors * (2 * panels(m) + 3);
}

// Shared memory of one block: the tile, kSmemVectors m-vectors, and with the
// direct x update one nz-vector and kSmemEqVectors neq-vectors
// (common.cuh::smem_bytes with the tile's padded rows).
template <typename T>
__host__ __device__ size_t step_smem_bytes(SquareTile L, int nz, int neq) {
  return (L.words() + size_t(kSmemVectors) * L.m + size_t(nz) +
          size_t(kSmemEqVectors) * neq) * sizeof(T);
}

template <typename T, int MODE, int NW>
__global__ void __launch_bounds__(32 * NW, StepBlocks<T, NW>::value)
ipm_step_kernel(StepArgs<T> a) {
  constexpr bool EQ = MODE == kStepEq;
  constexpr bool DX = MODE != kStepXFree;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[NW];
  const int m = a.m, nz = DX ? a.nz : 0, neq = EQ ? a.neq : 0;
  const SquareTile L{m, a.ld};
  T* Tm = reinterpret_cast<T*>(smem_raw);  // Lt above the diagonal
  T* dv = Tm + L.words();                  // s / z, the factor's shift
  T* isqv = dv + m;                        // the pivots' rsqrt
  T* xs = isqv + m;                        // the substitutions' vector
  T* zs = xs + m;                          // z, then scratch
  T* ss = zs + m;                          // s across the factor
  // S21 (W z + y + u), until the predictor's RHS is formed.
  T* lcol = ss + m;
  T* dxs = dv + kSmemVectors * m;          // nz
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
    gmem_matvec<NW>(S11, ys, ts, neq, neq);
    __syncthreads();
    for (int c = i; c < neq; c += blockDim.x) {
      T acc = T(0);
      for (int k = 0; k < m; ++k) acc += S21[size_t(k) * neq + c] * zs[k];
      ts[c] = -((a.rb[b * neq + c] + acc) + ts[c]);
    }
    __syncthreads();
    gmem_matvec<NW>(iS11, ts, us, neq, neq);  // u
    __syncthreads();
    gmem_matvec<NW>(Wm, zs, ts, neq, m);      // W z
    __syncthreads();
    for (int c = i; c < neq; c += blockDim.x) ts[c] = (ts[c] + ys[c]) + us[c];
    __syncthreads();
    gmem_matvec<NW>(S21, ts, lcol, m, neq);   // S21 (W z + y + u)
    __syncthreads();
  }

  // One pass over R's rows in device memory, a warp a row, kStageRows rows
  // and kStageCols columns a lane in flight: row r's products with z in
  // smem_matvec's order (R z), the predictor's RHS, and its lower triangle
  // and diagonal to their mirror places (c, r) in the tile's upper triangle;
  // each row read once.
  for (int r0 = warp; r0 < m; r0 += kStageRows * NW) {
    T acc[kStageRows];
#pragma unroll
    for (int h = 0; h < kStageRows; ++h) acc[h] = T(0);
    for (int c0 = 0; c0 < m; c0 += 32 * kStageCols) {
      T v[kStageRows][kStageCols];
#pragma unroll
      for (int h = 0; h < kStageRows; ++h) {
        const int r = r0 + h * NW;
#pragma unroll
        for (int j = 0; j < kStageCols; ++j) {
          const int c = c0 + lane + 32 * j;
          v[h][j] = (r < m && c < m) ? Rb[size_t(r) * m + c] : T(0);
        }
      }
#pragma unroll
      for (int h = 0; h < kStageRows; ++h) {
        const int r = r0 + h * NW;
        if (r >= m) break;  // uniform across the warp
#pragma unroll
        for (int j = 0; j < kStageCols; ++j) {
          const int c = c0 + lane + 32 * j;
          if (c < m) acc[h] += v[h][j] * zs[c];
          if (c <= r) Tm[c * L.ld + r] = v[h][j];
        }
      }
    }
#pragma unroll
    for (int h = 0; h < kStageRows; ++h) {
      const int r = r0 + h * NW;
      if (r >= m) break;  // uniform across the warp
      const T rz = warp_sum(acc[h]);
      if (lane == 0) {
        const T q = a.q[b * m + r];
        xs[r] = EQ ? (q - lcol[r]) - rz : q - rz;
      }
    }
  }
  __syncthreads();

  // T's factor, with the predictor's forward substitution riding in it.
  factor_panels<T, true, true, NW>(Tm, L, dv, isqv, xs, warp, lane);

  // x = T^-1 r for r held one element per thread.
  auto solve = [&](T r) { return solve_panels(Tm, L, isqv, xs, r, warp, lane); };

  const MinOp mn;
  const SumOp sm;
  const T one = T(1);
  const T inf = inf_t<T>();

  // ts = W v for an m-vector held one element per thread (zs is free once
  // R z is taken and z is back in a register). Ends with a barrier.
  auto w_apply = [&](T v) {
    if (act) zs[i] = v;
    __syncthreads();
    gmem_matvec<NW>(Wm, zs, ts, neq, m);
    __syncthreads();
  };

  // Predictor: the back substitution of the riding column.
  back_panels(Tm, L, isqv, xs, warp, lane);
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
      block_reduce<NW>(act ? nan_min(step_of(z, dz_a), step_of(s, ds_a)) : inf, mn, red), one);
  const T t2 = block_reduce<NW>(act ? s * z : T(0), sm, red);
  const T t1 = block_reduce<NW>(
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
        block_reduce<NW>(act ? nan_min(step_of(z, dz), step_of(s, ds)) : inf, mn, red), one);
    const T a_t = nan_min(T(1.08) * a_g + T(0.08), one);
    const T v = (s + a_t * ds) * (z + a_t * dz);
    const T mu_t = sig * mu;
    const T rs_g = (v - nan_min(nan_max(v, T(0.1) * mu_t), T(10.0) * mu_t)) / s;
    const T ddz = solve(-(rs_g / d));
    const T dds = (-rs_g - ddz) / d;
    const T dz_n = dz + ddz;
    const T ds_n = ds + dds;
    const T a_n = nan_min(
        block_reduce<NW>(act ? nan_min(step_of(z, dz_n), step_of(s, ds_n)) : inf, mn, red), one);
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
  for (int k = warp; k < nz; k += NW) {
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
      T(0.999) * block_reduce<NW>(act ? nan_min(step_of(z, dz), step_of(s, ds)) : inf, mn, red),
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

// The instantiation of NW warps, opted into its shared memory (set_smem:
// also the largest carve-out, so that as many blocks as fit share an SM).
// The tile's rows are padded to an odd stride where that fits beside
// kernels.fits' 8 words of reduction scratch: a column's 32 words then sit
// in 32 banks (at m = 100, 4-way conflicts in the back substitution's chains
// and row updates and in the staging's mirrored stores).
template <typename T, int MODE, int NW>
static cudaError_t prepare_step(int m, int nz, int neq, int* ld, size_t* smem) {
  nz = MODE != kStepXFree ? nz : 0;
  neq = MODE == kStepEq ? neq : 0;
  *ld = m;
  if (step_smem_bytes<T>(SquareTile{m, m | 1}, nz, neq) + kWarps * sizeof(T) <=
      kSmemLimit)
    *ld = m | 1;
  *smem = step_smem_bytes<T>(SquareTile{m, *ld}, nz, neq);
  return set_smem(ipm_step_kernel<T, MODE, NW>, *smem);
}

template <typename T, int MODE, int NW>
static int launch_as(StepArgs<T> a, int B, void* stream) {
  size_t smem = 0;
  const cudaError_t err = prepare_step<T, MODE, NW>(a.m, a.nz, a.neq, &a.ld, &smem);
  if (err != cudaSuccess) return int(err);
  ipm_step_kernel<T, MODE, NW><<<B, 32 * NW, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int MODE>
static int launch_step(StepArgs<T> a, int B, void* stream) {
  if constexpr (sizeof(T) == 4)
    if (step_warps<T>(a.m) == 6) return launch_as<T, MODE, 6>(a, B, stream);
  return launch_as<T, MODE, kWarps>(a, B, stream);
}

// Blocks of the instantiation launch_step takes that one SM holds at once at
// (m, nz, neq) (cudaOccupancyMaxActiveBlocksPerMultiprocessor); minus the
// cudaError_t where the query fails.
template <typename T, int MODE, int NW>
static int blocks_as(int m, int nz, int neq) {
  size_t smem = 0;
  int ld = m, n = 0;
  cudaError_t err = prepare_step<T, MODE, NW>(m, nz, neq, &ld, &smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, ipm_step_kernel<T, MODE, NW>, 32 * NW, smem);
  return err == cudaSuccess ? n : -int(err);
}

template <typename T, int MODE>
static int step_blocks_per_sm(int m, int nz, int neq) {
  if constexpr (sizeof(T) == 4)
    if (step_warps<T>(m) == 6) return blocks_as<T, MODE, 6>(m, nz, neq);
  return blocks_as<T, MODE, kWarps>(m, nz, neq);
}

}  // namespace qpth

// Each step library exports, for its mode, the warps a block its launcher
// takes at width m, qpth_ipm_step_warps(m, f64), and that kernel's blocks an
// SM, qpth_ipm_step_blocks_per_sm(m, f64, nz, neq) (the x-free mode ignores
// nz and neq, the direct-x mode neq).
#define QPTH_STEP_SHAPE(MODE)                                                 \
  extern "C" int qpth_ipm_step_warps(int m, int f64) {                       \
    return f64 ? qpth::step_warps<double>(m) : qpth::step_warps<float>(m);   \
  }                                                                          \
  extern "C" int qpth_ipm_step_blocks_per_sm(int m, int f64, int nz,         \
                                             int neq) {                      \
    return f64 ? qpth::step_blocks_per_sm<double, MODE>(m, nz, neq)          \
               : qpth::step_blocks_per_sm<float, MODE>(m, nz, neq);          \
  }

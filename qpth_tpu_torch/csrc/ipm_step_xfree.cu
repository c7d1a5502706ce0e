// Kernel B: one whole x-free Mehrotra iteration (neq = 0) per QP.
//
// Replaces the TPU kernel qpth_tpu/ops/pallas/lanes.py::ipm_step_xfree_lanes
// (_ipm_step_xfree_kernel) and follows its algebra line by line:
//   rhs_a = q - R z; factor and invert T = R + diag(s/z);
//   predictor dz_a = T^-1 rhs_a, ds_a = (-z - dz_a)/d; step to boundary;
//   Mehrotra centering sigma = (t1/t2)^3, mu = |t2|/m; corrector;
//   n_correctors Gondzio passes, each accepted per QP when it lengthens the
//   step; alpha2 = min(0.999 step, 1); NaN freeze from (dz, ds) only.
// Outputs zeta = z + dz (masked), s', z' and alpha. x never enters: the
// caller carries it as recurrence coefficients (core/pdipm.py).
//
// One thread block per QP. R and inv(L) sit in shared memory; thread i
// keeps element i of every m-vector (s, z, d, dz, ds, ...) in registers, and
// the per-QP min / sum reductions are block reductions. Each solve is two
// shared-memory matvecs with inv(L).
//
// What bounds it on an H100: at B = 4096, m = 100 it must read R (164 MB)
// plus a few (B, m) vectors, >= 0.05 ms at 3.35 TB/s; its ~2/3 m^3 + 2 m^2
// (2 + n_correctors) flops per QP take ~0.04 ms at 67 TFLOP/s. As in kernel A
// the device-memory traffic is already minimal (R read once, nothing but
// vectors written); the m dependent pivot steps, each behind two barriers,
// set its time in this first version.
#include "common.cuh"

namespace qpth {

template <typename T>
__device__ __forceinline__ T step_of(T v, T dv) {
  return dv < T(0) ? -v / dv : inf_t<T>();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ipm_step_xfree_kernel(const T* __restrict__ R, const T* __restrict__ S,
                      const T* __restrict__ Z, const T* __restrict__ Q,
                      T* __restrict__ zeta_out, T* __restrict__ s_out,
                      T* __restrict__ z_out, T* __restrict__ a_out, int m,
                      long long r_stride, int n_correctors) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[kWarps];
  T* Tm = reinterpret_cast<T*>(smem_raw);
  T* Gm = Tm + m * m;
  T* dv = Gm + m * m;
  T* lcol = dv + m;
  T* r = lcol + m;
  T* w = r + m;
  T* zs = w + m;

  const long long b = blockIdx.x;
  const int i = threadIdx.x;
  const bool act = i < m;
  const T* Rb = R + b * r_stride;
  for (int k = i; k < m * m; k += blockDim.x) Tm[k] = Rb[k];

  const T s = act ? S[b * m + i] : T(1);
  const T z = act ? Z[b * m + i] : T(1);
  const T q = act ? Q[b * m + i] : T(0);
  const T d = z / s;
  if (act) {
    dv[i] = s / z;
    zs[i] = z;
  }
  __syncthreads();

  // Predictor RHS q - R z, from the raw R before the factorization.
  smem_matvec<T, false>(Tm, zs, w, m);
  __syncthreads();
  if (act) r[i] = q - w[i];
  chol_inv_smem(Tm, Gm, dv, lcol, m);  // its first barrier publishes r

  const MinOp mn;
  const SumOp sm;
  const T one = T(1);
  const T inf = inf_t<T>();

  // Predictor.
  const T dz_a = apply_inv(Gm, r, w, m);
  const T ds_a = (-z - dz_a) / d;
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
  if (act) r[i] = -(rs_c / d);
  __syncthreads();
  const T dz_c = apply_inv(Gm, r, w, m);
  const T ds_c = (-rs_c - dz_c) / d;
  T dz = dz_a + dz_c;
  T ds = ds_a + ds_c;

  // Gondzio centrality correctors.
  for (int g = 0; g < n_correctors; ++g) {
    const T a_g = nan_min(
        block_reduce(act ? nan_min(step_of(z, dz), step_of(s, ds)) : inf, mn, red), one);
    const T a_t = nan_min(T(1.08) * a_g + T(0.08), one);
    const T v = (s + a_t * ds) * (z + a_t * dz);
    const T mu_t = sig * mu;
    const T rs_g = (v - nan_min(nan_max(v, T(0.1) * mu_t), T(10.0) * mu_t)) / s;
    if (act) r[i] = -(rs_g / d);
    __syncthreads();
    const T ddz = apply_inv(Gm, r, w, m);
    const T dds = (-rs_g - ddz) / d;
    const T dz_n = dz + ddz;
    const T ds_n = ds + dds;
    const T a_n = nan_min(
        block_reduce(act ? nan_min(step_of(z, dz_n), step_of(s, ds_n)) : inf, mn, red), one);
    if (a_n > a_g) {  // uniform across the block
      dz = dz_n;
      ds = ds_n;
    }
  }

  T alpha2 = nan_min(
      T(0.999) * block_reduce(act ? nan_min(step_of(z, dz), step_of(s, ds)) : inf, mn, red),
      one);
  const bool frozen = __syncthreads_or(act && (isnan(dz) || isnan(ds)));
  if (frozen) alpha2 = T(0);
  const T dz_m = frozen ? T(0) : dz;
  if (act) {
    zeta_out[b * m + i] = z + dz_m;
    s_out[b * m + i] = s + alpha2 * (frozen ? T(0) : ds);
    z_out[b * m + i] = z + alpha2 * dz_m;
  }
  if (i == 0) a_out[b] = alpha2;
}

template <typename T>
static int launch(const void* R, const void* s, const void* z, const void* q,
                  void* zeta, void* s_out, void* z_out, void* alpha, int B,
                  int m, int r_batched, int n_correctors, void* stream) {
  auto kern = ipm_step_xfree_kernel<T>;
  const size_t smem = smem_bytes<T>(m);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  kern<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(R), static_cast<const T*>(s),
      static_cast<const T*>(z), static_cast<const T*>(q),
      static_cast<T*>(zeta), static_cast<T*>(s_out), static_cast<T*>(z_out),
      static_cast<T*>(alpha), m, r_batched ? (long long)m * m : 0LL,
      n_correctors);
  return int(cudaGetLastError());
}

}  // namespace qpth

// R: (bR, m, m), bR in {1, B}; s, z, q, zeta, s_out, z_out: (B, m);
// alpha: (B,). Returns the cudaError_t of the launch (0 on success).
extern "C" int qpth_ipm_step_xfree_f32(const void* R, const void* s,
                                       const void* z, const void* q,
                                       void* zeta, void* s_out, void* z_out,
                                       void* alpha, int B, int m,
                                       int r_batched, int n_correctors,
                                       void* stream) {
  return qpth::launch<float>(R, s, z, q, zeta, s_out, z_out, alpha, B, m,
                             r_batched, n_correctors, stream);
}

extern "C" int qpth_ipm_step_xfree_f64(const void* R, const void* s,
                                       const void* z, const void* q,
                                       void* zeta, void* s_out, void* z_out,
                                       void* alpha, int B, int m,
                                       int r_batched, int n_correctors,
                                       void* stream) {
  return qpth::launch<double>(R, s, z, q, zeta, s_out, z_out, alpha, B, m,
                              r_batched, n_correctors, stream);
}

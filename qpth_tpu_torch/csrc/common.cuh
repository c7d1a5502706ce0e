// Shared device code of the port's Hopper kernels: one thread block per QP,
// the matrices of that QP held in dynamic shared memory.
//
// Layout: row-major m x m tiles with leading dimension m; every vector is an
// m-array in shared memory or one register per thread (thread i <-> row i).
// Compiled without --use_fast_math: a lane whose T is not SPD must produce
// NaN (rsqrt of a negative pivot) and the NaN must propagate to the caller,
// which freezes that lane.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace qpth {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// m-vectors a kernel may keep in shared memory beside its two m x m tiles,
// and the neq-vectors of the equality-constrained step. The fused steps with
// the direct x update also keep one nz-vector (dx). The Python wrappers use
// the same counts in their fit predicate.
constexpr int kSmemVectors = 8;
constexpr int kSmemEqVectors = 4;

template <typename T>
__host__ __device__ constexpr size_t smem_bytes(int m, int nz = 0, int neq = 0) {
  return (2 * size_t(m) * m + size_t(kSmemVectors) * m + size_t(nz) +
          size_t(kSmemEqVectors) * neq) * sizeof(T);
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }

template <typename T> __device__ __forceinline__ T inf_t();
template <> __device__ __forceinline__ float inf_t<float>() { return CUDART_INF_F; }
template <> __device__ __forceinline__ double inf_t<double>() { return CUDART_INF; }

// min / max that propagate NaN, as jnp.minimum / jnp.min and torch.minimum /
// torch.amin do (fminf would drop it and let a NaN lane look healthy).
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) { return (a != a || a < b) ? a : b; }
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) { return (a != a || a > b) ? a : b; }

struct MinOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return nan_min(a, b); }
};
struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Reduce one value per thread over the whole block; every thread gets the
// result. `red` holds kWarps entries. All threads of the block must call it.
template <typename T, typename Op>
__device__ T block_reduce(T v, Op op, T* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, off));
  if (lane == 0) red[warp] = v;
  __syncthreads();
  T r = red[0];
  for (int w = 1; w < kWarps; ++w) r = op(r, red[w]);
  __syncthreads();  // red may be reused right away
  return r;
}

// out[i] = sum_c M[i][c] v[c] over c < ncols(i), one warp per row.
// ncols(i) = m for a full matvec, i + 1 for the lower triangle.
template <typename T, bool kLower>
__device__ void smem_matvec(const T* M, const T* v, T* out, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < m; i += kWarps) {
    const int nc = kLower ? i + 1 : m;
    T acc = T(0);
    for (int c = lane; c < nc; c += 32) acc += M[i * m + c] * v[c];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// out[i] = sum_c M[i][c] v[c] for a row-major rows x cols matrix M in device
// memory, v and out in shared memory. One warp per row, its lanes on
// consecutive addresses. The caller places the barriers.
template <typename T>
__device__ void gmem_matvec(const T* __restrict__ M, const T* v, T* out, int rows, int cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < rows; i += kWarps) {
    const T* row = M + size_t(i) * cols;
    T acc = T(0);
    for (int c = lane; c < cols; c += 32) acc += row[c] * v[c];
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
}

// Cholesky of T + diag(dinv) interleaved with the inverse of its factor
// (the recurrence of the TPU kernel's _chol_inv_inplace):
//   pivot step j:  isq = rsqrt(T[j][j] + dinv[j]),  L[k][j] = T[k][j] isq,
//                  G[j] *= isq,  G[k] -= L[k][j] G[j],
//                  T[k][e] -= L[k][j] L[e][j]          (k, e > j).
// On entry Tm holds T (only its lower triangle and diagonal are read); on
// exit Gm holds inv(L), lower triangular, row i of inv(L) in row i. For each
// row k > j the step touches exactly m entries (G columns <= j, T columns
// > j), so a warp sweeps one row with its lanes on consecutive addresses.
template <typename T>
__device__ void chol_inv_smem(T* Tm, T* Gm, const T* dinv, T* lcol, int m) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x)
    Gm[i] = (i / m == i % m) ? T(1) : T(0);
  __syncthreads();
  for (int j = 0; j < m; ++j) {
    const T isq = rsqrt_t(Tm[j * m + j] + dinv[j]);
    for (int k = j + 1 + threadIdx.x; k < m; k += blockDim.x) lcol[k] = Tm[k * m + j] * isq;
    for (int c = threadIdx.x; c <= j; c += blockDim.x) Gm[j * m + c] *= isq;
    __syncthreads();
    for (int k = j + 1 + warp; k < m; k += kWarps) {
      const T lk = lcol[k];
      T* grow = Gm + k * m;
      T* trow = Tm + k * m;
      for (int e = lane; e < m; e += 32) {
        if (e <= j) grow[e] -= lk * Gm[j * m + e];
        else trow[e] -= lk * lcol[e];
      }
    }
    __syncthreads();
  }
}

// x = G^T (G r) = T^-1 r from the inverse factor G. Thread c returns x[c]
// (0 for c >= m). `w` is an m-vector of scratch. Ends with a barrier, so the
// caller may overwrite r and w right after.
template <typename T>
__device__ T apply_inv(const T* Gm, const T* r, T* w, int m) {
  smem_matvec<T, true>(Gm, r, w, m);
  __syncthreads();
  T x = T(0);
  const int c = threadIdx.x;
  if (c < m)
    for (int i = c; i < m; ++i) x += Gm[i * m + c] * w[i];
  __syncthreads();
  return x;
}

// The block's slice of an operand with batch 1 or B: bit `bit` of `batched`
// set means batch B (else the one copy is read with batch stride 0).
template <typename T>
__device__ __forceinline__ const T* operand(const T* base, int batched, int bit,
                                            long long b, size_t size) {
  return base + ((batched & bit) ? size_t(b) * size : size_t(0));
}

// Largest step a with v + a dv >= 0 for one coordinate.
template <typename T>
__device__ __forceinline__ T step_of(T v, T dv) {
  return dv < T(0) ? -v / dv : inf_t<T>();
}

}  // namespace qpth

// Panel helpers of kernels C (csrc/chol.cu) and E (csrc/trinv.cu): one thread
// block per QP holds one m x m row-major tile (leading dimension m) in shared
// memory, and the factorization or inversion walks it in panels of 32 rows,
// one warp's width. The dependent chains run only inside a warp, over a
// panel's 32 x 32 diagonal block, in registers and lane shuffles; every warp
// then works on the block products between panels, each lane on a 4 x 4
// register tile, so each shared-memory load feeds two multiply-adds instead
// of a third of one. A panel costs a few block barriers, not one per pivot.
//
// The last panel is ragged (m = 100 is 32 + 32 + 32 + 4): a routine given a
// panel of w < 32 rows keeps the missing rows at zero and never stores them.
// Products are plain fused multiply-adds in the working precision (no tensor
// cores, no TF32).
#pragma once

#include "common.cuh"

namespace qpth {

constexpr int kPanelWidth = 32;          // rows per panel = lanes per warp
constexpr unsigned kWarpAll = 0xffffffffu;

// Blocks per SM a panel kernel is compiled for (__launch_bounds__' second
// argument, so at most 65536 / (256 n) registers a thread): without the cap
// nvcc gives the unrolled 32-step chains 116-196 registers and one block per
// SM. Shared memory allows 5 blocks of the float32 tile at m = 100 and 2 of
// the float64 one.
template <typename T> struct PanelBlocks;
template <> struct PanelBlocks<float> { static constexpr int value = 4; };
template <> struct PanelBlocks<double> { static constexpr int value = 2; };

// The shared memory both kernels launch with: the m x m tile and
// kCholVectors m-vectors (C: dinv, the pivots' rsqrt, y and x of the fused
// solve; E uses one, for the reciprocals of Lt's diagonal). The Python
// wrappers check the same bytes in kernels.py::chol_fits.
constexpr int kCholVectors = 4;

template <typename T>
__host__ __device__ constexpr size_t chol_smem_bytes(int m) {
  return (size_t(m) * m + size_t(kCholVectors) * m) * sizeof(T);
}

// out = the tile's upper (UPPER) or lower triangle and diagonal, exact zeros
// across it, written row by row: the calling warps w0 .. w0 + nw - 1 take a
// row each in turn, their lanes along the row (coalesced, no index
// division).
template <typename T, bool UPPER>
__device__ __forceinline__ void store_triangle(T* __restrict__ out, const T* Tm,
                                               int m, int w0, int nw, int warp,
                                               int lane) {
  for (int r = warp - w0; r < m; r += nw)
    for (int c = lane; c < m; c += 32)
      out[r * m + c] = (UPPER ? c >= r : c <= r) ? Tm[r * m + c] : T(0);
}

// A warp's register tile: 4 MI rows x 32 columns of the output, lane
// (ly, lx) = (lane / 8, lane % 8) owning rows rb + ly + 4 i (i < MI) and
// columns cb + lx + 8 q (q < 4). The MI rows a k-step reads are 4
// consecutive words each (a broadcast to 8 lanes), the four columns' 8
// consecutive words: no bank conflict in float32 or float64. MI = 4 (16 x 32
// tiles) feeds two multiply-adds per shared-memory load; MI = 1 (4 x 32)
// cuts a 32 x 32 block into eight warps' shares.
constexpr int kTileRows = 16;
constexpr int kTileCols = 32;

template <int MI>
__device__ __forceinline__ void tile_coords(int rb, int cb, int lane,
                                            int (&r)[MI], int (&c)[4]) {
  const int ly = lane >> 3, lx = lane & 7;
#pragma unroll
  for (int i = 0; i < MI; ++i) r[i] = rb + ly + 4 * i;
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = cb + lx + 8 * q;
}

// acc[i][q] -= sum_{k0 <= k < k1} A[k ld + ar[i]] B[k ld + bc[q]]: a rank-k
// update of one register tile, k ascending. With MASK_B, B is read as lower
// triangular (its entry (k, bc[q]) counts only where k >= bc[q]; the tile may
// hold anything above it). ar and bc must be valid column indices.
template <typename T, bool MASK_B, int MI>
__device__ __forceinline__ void tile_update(T (&acc)[MI][4], const T* A,
                                            const T* B, int ld,
                                            const int (&ar)[MI],
                                            const int (&bc)[4], int k0, int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const T* Ak = A + k * ld;
    const T* Bk = B + k * ld;
    T a[MI], b[4];
#pragma unroll
    for (int i = 0; i < MI; ++i) a[i] = Ak[ar[i]];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      b[q] = Bk[bc[q]];
      if (MASK_B) b[q] = k >= bc[q] ? b[q] : T(0);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][q] -= a[i] * b[q];
  }
}

// One warp factors the w x w diagonal block at (p0, p0) of the tile, whose
// upper triangle and diagonal hold the trailing matrix T (the strictly lower
// part is not read): Lt = chol(T + diag(dinv))^T in place, with the pivots'
// rsqrt in isqv[p0 + j]. The same right-looking rank-1 recurrence as
// kernels.py::chol_plain,
//   piv = T[j][j] (+ dinv[j]),  isq = rsqrt(piv),
//   Lt[j][j] = piv isq,  Lt[j][c] = T[j][c] isq,  T[r][c] -= Lt[j][r] Lt[j][c],
// with lane c holding column c of the block (rows 0..c) in registers: a step
// is one shuffle for the pivot and one per later row; no division, no
// barrier, no shared-memory access between the load and the store.
// Not inlined, as panel_solve_column below: each then gets its own register
// allocation, and the kernels' spills are gone (PERF.md §6).
template <typename T, bool SHIFT>
__device__ __noinline__ void chol_diag_block(T* Tm, int m, int p0, int w,
                                                const T* dinv, T* isqv,
                                                int lane) {
  T d[kPanelWidth];
#pragma unroll
  for (int r = 0; r < kPanelWidth; ++r)
    d[r] = (r < w && r <= lane && lane < w) ? Tm[(p0 + r) * m + p0 + lane]
                                           : T(0);
  // Lane j adds the shift to its own pivot when step j reaches it: the
  // shift's load stays off the chain.
  const T dl = (SHIFT && lane < w) ? dinv[p0 + lane] : T(0);
#pragma unroll
  for (int j = 0; j < kPanelWidth; ++j) {
    if (j >= w) break;
    const T piv = __shfl_sync(kWarpAll, SHIFT ? d[j] + dl : d[j], j);
    const T isq = rsqrt_t(piv);
    if (lane == 0) isqv[p0 + j] = isq;
    const T u = (lane == j ? piv : d[j]) * isq;   // Lt[j][lane], lane >= j
    d[j] = u;
#pragma unroll
    for (int r = j + 1; r < kPanelWidth; ++r) d[r] -= __shfl_sync(kWarpAll, u, r) * u;
  }
#pragma unroll
  for (int r = 0; r < kPanelWidth; ++r)
    if (r < w && r <= lane && lane < w) Tm[(p0 + r) * m + p0 + lane] = d[r];
}

// The panel's rows of Lt beyond its diagonal block, one column at a time:
// column c of rows p0 .. p0 + w - 1 (x, at col[j * stride]) solves
// U_pp^T x = t by forward substitution in column (SAXPY) order,
//   x_j *= isq_j,  x_i -= Lt[p0 + j][p0 + i] x_j   (i > j),
// the products of chol_plain's within-panel rank-1 updates in its order. It
// runs in sub-blocks of kSub rows: their chain in registers, then their
// updates of the column's later rows through shared memory, four rows at a
// time, so a thread holds kSub values and not 32. The diagonal block's
// entries are read as broadcasts (every thread reads the same word).
constexpr int kSub = 8;

template <typename T>
__device__ __noinline__ void panel_solve_column(const T* Tm, int m, int p0,
                                                   int w, const T* isqv,
                                                   T* col, int stride) {
  for (int s0 = 0; s0 < w; s0 += kSub) {
    const int ws = min(kSub, w - s0);
    T x[kSub];
#pragma unroll
    for (int j = 0; j < kSub; ++j) x[j] = j < ws ? col[(s0 + j) * stride] : T(0);
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      if (j >= ws) break;
      x[j] *= isqv[p0 + s0 + j];
      const T* Uj = Tm + (p0 + s0 + j) * m + p0 + s0;
#pragma unroll
      for (int i = j + 1; i < kSub; ++i)
        if (i < ws) x[i] -= Uj[i] * x[j];
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      if (j < ws) col[(s0 + j) * stride] = x[j];
    // The later rows (only a whole sub-block has any); rows past w are
    // neither read nor written.
    const T* U = Tm + (p0 + s0) * m + p0;
    for (int i = s0 + ws; i < w; i += 4) {
      T acc[4];
      int iu[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        iu[u] = min(i + u, w - 1);
        acc[u] = col[iu[u] * stride];
      }
#pragma unroll
      for (int j = 0; j < kSub; ++j)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[u] -= U[j * m + iu[u]] * x[j];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (i + u < w) col[(i + u) * stride] = acc[u];
    }
  }
}

// One warp inverts the w x w lower-triangular diagonal block L_pp at
// (p0, p0), read from Lt's strictly upper triangle there (L[i][k] =
// Lt[k][i]) and the reciprocals rd of Lt's diagonal, and stores X = inv(L_pp)
// in the tile's lower triangle and diagonal of that block. Lane e solves
// column e of L X = I in column order,
//   x_j *= rd_j,  x_i -= Lt[p0 + j][p0 + i] x_j   (i > j),
// as kernels.py::trinv_plain does (with the pivot's reciprocal taken once,
// off the chain); every read of Lt is a broadcast.
template <typename T>
__device__ __forceinline__ void trinv_diag_block(T* Tm, int m, int p0, int w,
                                                 const T* rd, int lane) {
  T x[kPanelWidth];
#pragma unroll
  for (int i = 0; i < kPanelWidth; ++i) x[i] = i == lane ? T(1) : T(0);
#pragma unroll
  for (int j = 0; j < kPanelWidth; ++j) {
    if (j >= w) break;
    x[j] *= rd[p0 + j];
    const T* Uj = Tm + (p0 + j) * m + p0;
#pragma unroll
    for (int i = j + 1; i < kPanelWidth; ++i)
      if (i < w) x[i] -= Uj[i] * x[j];
  }
#pragma unroll
  for (int i = 0; i < kPanelWidth; ++i)
    if (i < w && lane <= i) Tm[(p0 + i) * m + p0 + lane] = x[i];
}

}  // namespace qpth

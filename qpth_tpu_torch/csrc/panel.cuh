// Panel helpers of kernels A (csrc/factor_inv.cu), C (csrc/chol.cu) and E
// (csrc/trinv.cu) and of the fused IPM steps (csrc/ipm_step_body.cuh): one
// thread block per QP holds one m x m row-major tile in shared memory
// (SquareTile: row stride ld), and the factorization, its substitutions or
// the inversion walk it in panels of 32 rows, one warp's width. The
// dependent chains run only inside a warp, over a panel's 32 x 32 diagonal block, in registers
// and lane shuffles; every warp then works on the block products between
// panels, each lane on a 4 x 4 register tile, so each shared-memory load
// feeds two multiply-adds instead of a third of one. A panel costs a few
// block barriers, not one per pivot.
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

// The tile: m x m, row r at r ld (kernels A, C and E with ld = m, their
// lower triangle holding inv(L) or never read; the fused steps with an odd
// ld where it fits, so that the 32 words of a column fall in 32 banks). The
// factorization and the substitutions store only on and above the diagonal.
struct SquareTile {
  int m, ld;
  __host__ __device__ size_t words() const { return size_t(m) * ld; }
};

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
__device__ __noinline__ void chol_diag_block(T* Tm, int ld, int p0, int w,
                                                const T* dinv, T* isqv,
                                                int lane) {
  T d[kPanelWidth];
#pragma unroll
  for (int r = 0; r < kPanelWidth; ++r)
    d[r] = (r < w && r <= lane && lane < w) ? Tm[(p0 + r) * ld + p0 + lane]
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
    if (r < w && r <= lane && lane < w) Tm[(p0 + r) * ld + p0 + lane] = d[r];
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
__device__ __noinline__ void panel_solve_column(const T* Tm, int ld, int p0,
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
      const T* Uj = Tm + (p0 + s0 + j) * ld + p0 + s0;
#pragma unroll
      for (int i = j + 1; i < kSub; ++i)
        if (i < ws) x[i] -= Uj[i] * x[j];
    }
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      if (j < ws) col[(s0 + j) * stride] = x[j];
    // The later rows (only a whole sub-block has any); rows past w are
    // neither read nor written.
    const T* U = Tm + (p0 + s0) * ld + p0;
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
        for (int u = 0; u < 4; ++u) acc[u] -= U[j * ld + iu[u]] * x[j];
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


__host__ __device__ constexpr int panels(int m) {
  return (m + kPanelWidth - 1) / kPanelWidth;
}

// A barrier of the nw warps w0 .. w0 + nw - 1 that run a routine: the whole
// block's (__syncthreads) when they are all its warps, else named barrier 1
// for their 32 nw threads, so that the warps outside it can work beside them.
__device__ __forceinline__ void warps_sync(int nw) {
  if (nw == kWarps)
    __syncthreads();
  else
    asm volatile("bar.sync 1, %0;\n" ::"r"(32 * nw) : "memory");
}

// inv(L) in place in the tile, from Lt = L^T strictly above the diagonal
// (L[i][k] = Lt[k][i]) and rd, the reciprocals of Lt's diagonal: inv(L)
// fills the lower triangle and diagonal, row i of inv(L) in row i, and Lt's
// strict upper triangle is left as it was. The TPU kernel's _trinv_kernel
// (cholesky.py:203) on 32-row panels, run by warps w0 .. w0 + nw - 1:
//   * all nb = panels(n) <= nw diagonal blocks at once, one warp each,
//     X_ii = inv(L_ii) by forward substitution in registers
//     (trinv_diag_block);
//   * then for row block I = 1 .. nb - 1, with L[I, :I] read as Lt's
//     columns,
//       C = -L[I, :I] invL[:I, :I]      the warps' 4 x 4 register tiles,
//       invL[I, :I] = X_II C            a thread per column, in place.
// Neither reads the tile's diagonal (the pivots come from rd) or writes
// above it. On entry Lt and rd are published behind a barrier; 2 nb - 1
// barriers of the nw warps (warps_sync), the last one before return, and no
// dependent chain longer than a diagonal block's 32 steps. Kernel E
// (trinv.cu) runs it on all the block's warps, kernel A (factor_inv.cu) on
// all but warp 0 when warp 0 has a back substitution to run beside it.
template <typename T>
__device__ __forceinline__ void trinv_panels(T* Tm, int n, const T* rd, int w0,
                                             int nw, int warp, int lane) {
  const int nb = panels(n), wi = warp - w0;
  if (wi < nb) {
    const int p0 = kPanelWidth * wi;
    trinv_diag_block(Tm, n, p0, min(kPanelWidth, n - p0), rd, lane);
  }
  warps_sync(nw);

  for (int I0 = kPanelWidth; I0 < n; I0 += kPanelWidth) {
    const int w = min(kPanelWidth, n - I0);
    // C = -L[I, :I] invL[:I, :I] into rows I0 .. I0 + w - 1, columns < I0:
    // C[r][c] = -sum_{c <= k < I0} Lt[k][I0 + r] invL[k][c].
    const int ntc = I0 / kTileCols;
    const int ntiles = ntc * ((w + kTileRows - 1) / kTileRows);
    for (int t = wi; t < ntiles; t += nw) {
      const int tr = t / ntc, tc = t - tr * ntc;
      int r[4], c[4], ar[4], bc[4];
      tile_coords(kTileRows * tr, kTileCols * tc, lane, r, c);
      T acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ar[i] = I0 + min(r[i], w - 1);
        bc[i] = min(c[i], I0 - 1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = T(0);
      }
      tile_update<T, true, 4>(acc, Tm, Tm, n, ar, bc, kTileCols * tc, I0);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r[i] < w && c[q] < I0) Tm[(I0 + r[i]) * n + c[q]] = acc[i][q];
    }
    warps_sync(nw);
    // invL[I, c] = X_II C[:, c], a thread per column c < I0, rows descending
    // so that each result overwrites a C entry no later row needs.
    const T* X = Tm + I0 * n + I0;
    for (int c = 32 * wi + lane; c < I0; c += 32 * nw) {
      T* col = Tm + I0 * n + c;
      T y[kPanelWidth];
#pragma unroll
      for (int s = 0; s < kPanelWidth; ++s) y[s] = s < w ? col[s * n] : T(0);
#pragma unroll
      for (int r = kPanelWidth - 1; r >= 0; --r) {
        if (r >= w) continue;
        T acc = T(0);
#pragma unroll
        for (int s = 0; s <= r; ++s) acc += X[r * n + s] * y[s];
        col[r * n] = acc;
      }
    }
    warps_sync(nw);
  }
}

// One warp's 4 MI x 32 tile at (rb, cb) of the trailing matrix takes the
// panel's rank-w update, T[r][c] -= sum_k W[k][r] W[k][c] (W: the panel's
// rows of Lt, at row stride L.ld), on and above the diagonal.
template <typename T, int MI>
__device__ __forceinline__ void update_tile(T* Tm, const T* W, SquareTile L,
                                            int w, int rb, int cb, int lane) {
  const int m = L.m, ld = L.ld;
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
    for (int q = 0; q < 4; ++q) acc[i][q] = Tm[ar[i] * ld + bc[q]];
  tile_update<T, false, MI>(acc, W, W, ld, ar, bc, 0, w);
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (r[i] < m && c[q] < m && c[q] >= r[i]) Tm[r[i] * ld + c[q]] = acc[i][q];
}

// r_i -= sum_{k < w} Lt[p0 + k][i] y[p0 + k]: row i below panel p0 takes
// the panel's solution of the forward substitution L y = r (column i of the
// panel's rows: consecutive rows on consecutive words).
template <typename T>
__device__ __forceinline__ void fwd_update_row(const T* Tm, SquareTile L,
                                               int p0, int w, T* xs, int i) {
  const T* U = Tm + p0 * L.ld + i;
  T acc = xs[i];
  for (int k = 0; k < w; ++k) acc -= U[k * L.ld] * xs[p0 + k];
  xs[i] = acc;
}

// One warp's chain of the forward substitution over panel p0's w x w
// diagonal block, column order, j ascending: y_j = r_j isq_j, r_i -=
// Lt[p0 + j][p0 + i] y_j (i > j); lane i holds r_i, the pivot's reciprocal
// is isqv's rsqrt. Row j of the block is read with consecutive lanes on
// consecutive words. This chain and back_chain are unrolled by 8, not
// whole: whole, their hoisted loads spilled the fused steps' state
// (PERF.md §6).
template <typename T>
__device__ __forceinline__ void fwd_chain(const T* Tm, SquareTile L, int p0,
                                          int w, const T* isqv, T* xs,
                                          int lane) {
  const bool on = lane < w;
  const T* Uj = Tm + p0 * L.ld + p0 + (on ? lane : 0);
  const T isq = on ? isqv[p0 + lane] : T(0);
  T rv = on ? xs[p0 + lane] : T(0);
#pragma unroll 8
  for (int j = 0; j < w; ++j) {
    if (lane == j) rv *= isq;
    const T yj = __shfl_sync(kWarpAll, rv, j);
    if (on && lane > j) rv -= Uj[j * L.ld] * yj;
  }
  if (on) xs[p0 + lane] = rv;
}

// x_i -= sum_{k < w} Lt[i][p0 + k] x[p0 + k]: row i above panel p0 takes
// the panel's solution.
template <typename T>
__device__ __forceinline__ void back_update_row(const T* Tm, SquareTile L,
                                                int p0, int w, T* xs, int i) {
  const T* Ui = Tm + i * L.ld + p0;
  T acc = xs[i];
  for (int k = 0; k < w; ++k) acc -= Ui[k] * xs[p0 + k];
  xs[i] = acc;
}

// One warp's chain of the back substitution over panel p0's w x w diagonal
// block, column order, k descending: x_k = r_k isq_k, r_i -= Lt[i][k] x_k
// (i < k); lane i holds r_i, the pivot's reciprocal is isqv's rsqrt.
template <typename T>
__device__ __forceinline__ void back_chain(const T* Tm, SquareTile L, int p0,
                                           int w, const T* isqv, T* xs,
                                           int lane) {
  const bool on = lane < w;
  const T* Ui = Tm + (p0 + (on ? lane : 0)) * L.ld + p0;
  const T isq = on ? isqv[p0 + lane] : T(0);
  T rv = on ? xs[p0 + lane] : T(0);
#pragma unroll 8
  for (int k = w - 1; k >= 0; --k) {
    if (lane == k) rv *= isq;
    const T xk = __shfl_sync(kWarpAll, rv, k);
    if (on && lane < k) rv -= Ui[k] * xk;
  }
  if (on) xs[p0 + lane] = rv;
}

// Lt = chol(T + diag(dinv))^T in place in the tile's upper triangle and
// diagonal (the strictly lower part is never read), right-looking in panels
// of 32 rows; with RHS, also y = L^-1 rhs in place in ys. Per panel:
//   (a) one warp factors the panel's diagonal block in registers, folding the
//       shift into each pivot when it is reached, the pivots' rsqrt to isqv;
//   (b) every thread solves one column of the panel's rows beyond the block,
//       Lt[p, rest] = U_pp^-T T[p, rest], by forward substitution with isqv,
//       in sub-blocks of 8 rows; with RHS, y's panel is one more column;
//   (c) the warps apply the rank-32 update T[rest, rest] -= W^T W to the
//       upper triangle on register tiles: first all NW warps to the next
//       panel's diagonal block (4 rows at a time), then warp 0 factors it,
//       (a) of the next panel, while the other NW - 1 update the rest (4 x 4
//       per lane) and y's later rows.
// On entry the tile (and dinv, rhs) are published behind a barrier; it
// returns behind one, after 3 panels(m) - 1 barriers: 1 after the first (a),
// then 1 after (b), after the diagonal block's update and after (c), the
// last panel (b)'s alone. Every element receives its rank-1 updates in pivot
// order, as in kernels.py::chol_plain, and y's in the order of fwd_chain,
// whatever the row stride and the block's warp count NW.
template <typename T, bool SHIFT, bool RHS, int NW = kWarps>
__device__ __forceinline__ void factor_panels(T* Tm, SquareTile L, const T* dv,
                                              T* isqv, T* ys, int warp,
                                              int lane) {
  const int m = L.m;
  if (warp == 0) chol_diag_block<T, SHIFT>(Tm, L.ld, 0, min(kPanelWidth, m), dv, isqv, lane);
  __syncthreads();
  for (int p0 = 0; p0 < m; p0 += kPanelWidth) {
    const int w = min(kPanelWidth, m - p0);
    const int base = p0 + w, rest = m - base;
    // (b) the panel's rows beyond the diagonal block, a column per thread;
    // with rhs, y's panel as one more column.
    for (int t = threadIdx.x; t < rest + (RHS ? 1 : 0); t += blockDim.x) {
      const bool is_y = RHS && t == rest;
      panel_solve_column(Tm, L.ld, p0, w, isqv,
                         is_y ? ys + p0 : Tm + p0 * L.ld + base + t,
                         is_y ? 1 : L.ld);
    }
    __syncthreads();
    if (rest == 0) break;
    // (c) the rank-w update of the trailing upper triangle. First the next
    // panel's diagonal block, 4 rows a warp at a time; then warp 0 factors
    // it, (a) of the next panel, while the other warps update the rest (and
    // y) in tiles of 16 x 32.
    const T* W = Tm + p0 * L.ld;
    for (int rb = 4 * warp; rb < min(kPanelWidth, rest); rb += 4 * NW)
      update_tile<T, 1>(Tm, W, L, w, base + rb, base, lane);
    __syncthreads();
    if (warp == 0) {
      chol_diag_block<T, SHIFT>(Tm, L.ld, base, min(kPanelWidth, rest), dv, isqv, lane);
    } else {
      const int ntc = (rest + kTileCols - 1) / kTileCols;
      const int ntiles = ntc * ((rest + kTileRows - 1) / kTileRows);
      for (int t = warp - 1; t < ntiles; t += NW - 1) {
        const int tr = t / ntc, tc = t - tr * ntc;
        // Skip the tiles wholly below the diagonal, and the diagonal block's.
        if (tc < tr / 2 || (tc == 0 && tr < 2)) continue;
        update_tile<T, 4>(Tm, W, L, w, base + kTileRows * tr, base + kTileCols * tc, lane);
      }
      for (int t = threadIdx.x - 32; RHS && t < rest; t += blockDim.x - 32)
        fwd_update_row(Tm, L, p0, w, ys, base + t);
    }
    __syncthreads();
  }
}

// The back substitution Lt x = y in place in xs, panels descending, in
// column order. Warp 0 runs each panel's chain (back_chain) after applying
// the panel below to that panel's own rows, while the other warps apply it
// to the rows above. On entry y is published behind a barrier (warp 0 may
// also have written the last panel's rows itself); the warps that are not
// warp 0 may come in late, their first phase is theirs (kernel C writes Lt
// out there). panels(m) barriers, the last one before return.
template <typename T>
__device__ __forceinline__ void back_panels(const T* Tm, SquareTile L,
                                            const T* isqv, T* xs, int warp,
                                            int lane) {
  const int m = L.m;
  int p0 = (panels(m) - 1) * kPanelWidth;
  if (warp == 0) {
    __syncwarp();
    back_chain(Tm, L, p0, m - p0, isqv, xs, lane);
  }
  __syncthreads();
  for (; p0 > 0; p0 -= kPanelWidth) {
    const int w = min(kPanelWidth, m - p0), q0 = p0 - kPanelWidth;
    if (warp == 0) {
      back_update_row(Tm, L, p0, w, xs, q0 + lane);
      __syncwarp();
      back_chain(Tm, L, q0, kPanelWidth, isqv, xs, lane);
    } else {
      for (int i = threadIdx.x - 32; i < q0; i += blockDim.x - 32)
        back_update_row(Tm, L, p0, w, xs, i);
    }
    __syncthreads();
  }
}

// back_panels in one warp: per panel from the last, the panel's chain
// (back_chain), then the rows above it take the panel's solution
// (back_update_row), a row a lane. Every x_i receives the same operations in
// the same order as in back_panels, with __syncwarp between the phases and
// no block barrier, so that the other warps can work beside it. On entry y
// is published to the warp; it reads only Lt's strict upper triangle and
// isqv.
template <typename T>
__device__ __forceinline__ void back_warp(const T* Tm, SquareTile L,
                                          const T* isqv, T* xs, int lane) {
  for (int p0 = (panels(L.m) - 1) * kPanelWidth; p0 >= 0; p0 -= kPanelWidth) {
    const int w = min(kPanelWidth, L.m - p0);
    __syncwarp();
    back_chain(Tm, L, p0, w, isqv, xs, lane);
    __syncwarp();
    for (int i = lane; i < p0; i += 32) back_update_row(Tm, L, p0, w, xs, i);
  }
  __syncwarp();
}

// x = T^-1 r from the factor in the tile (factor_panels' Lt and isqv):
// thread i < m gives r_i and gets x_i back (0 past m). The forward
// substitution L y = r by panels ascending, each panel's chain in warp 0
// (fwd_chain) after it applied the panel before to the panel's own rows,
// while the other warps apply it to the rows below; then back_panels. Warp 0
// holds the first panel's rows itself, so the first chain needs no barrier,
// and runs the last panel's two chains back to back: 2 panels(m) - 1
// barriers. xs is the routine's scratch: before its first barrier and after
// its last, a thread touches only its own element, so calls may follow one
// another with no barrier between. Not inlined: the fused steps keep their
// per-thread state across each call, and a register allocation of its own
// leaves the chains theirs (PERF.md §6).
template <typename T>
__device__ __noinline__ T solve_panels(const T* Tm, SquareTile L,
                                       const T* isqv, T* xs, T r, int warp,
                                       int lane) {
  const int i = threadIdx.x, m = L.m;
  if (i < m) xs[i] = r;
  if (warp == 0) {
    __syncwarp();
    fwd_chain(Tm, L, 0, min(kPanelWidth, m), isqv, xs, lane);
  }
  const int last = (panels(m) - 1) * kPanelWidth;
  for (int p0 = 0; p0 < last; p0 += kPanelWidth) {
    __syncthreads();
    const int n0 = p0 + kPanelWidth;  // the next panel
    if (warp == 0) {
      const int wn = min(kPanelWidth, m - n0);
      if (lane < wn) fwd_update_row(Tm, L, p0, kPanelWidth, xs, n0 + lane);
      __syncwarp();
      fwd_chain(Tm, L, n0, wn, isqv, xs, lane);
    } else {
      for (int t = n0 + i; t < m; t += blockDim.x - 32)  // rows past n0 + 31
        fwd_update_row(Tm, L, p0, kPanelWidth, xs, t);
    }
  }
  back_panels(Tm, L, isqv, xs, warp, lane);
  return i < m ? xs[i] : T(0);
}

}  // namespace qpth

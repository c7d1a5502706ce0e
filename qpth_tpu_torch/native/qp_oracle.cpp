// Native float64 QP oracle: dense Mehrotra predictor-corrector IPM.
//
// Role: the port's native ground-truth solver, the C++ twin of
// qpth_tpu_torch/solvers/oracle.py (upstream qpth's per-instance CVXPY
// fallback). QPSolvers.CPU_ORACLE solves a batch through it without a
// Python loop per instance.
//
// Solves  min 1/2 x'Qx + p'x  s.t. Gx <= h, Ax = b  by eliminating
// ds = (-rc - s.*dz)./z from the complementarity row and solving the
// augmented (n+m+neq) system with partially-pivoted Gaussian elimination.
//
// C ABI only; no external dependencies.

#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Solve M x = rhs in place (M is k x k row-major, destroyed). Returns 0 on
// success, -1 on singular pivot.
int lin_solve(std::vector<double>& M, std::vector<double>& rhs, int k) {
  for (int col = 0; col < k; ++col) {
    int piv = col;
    double best = std::fabs(M[col * k + col]);
    for (int r = col + 1; r < k; ++r) {
      double v = std::fabs(M[r * k + col]);
      if (v > best) { best = v; piv = r; }
    }
    if (best < 1e-300) return -1;
    if (piv != col) {
      for (int c = col; c < k; ++c) std::swap(M[piv * k + c], M[col * k + c]);
      std::swap(rhs[piv], rhs[col]);
    }
    double d = M[col * k + col];
    for (int r = col + 1; r < k; ++r) {
      double f = M[r * k + col] / d;
      if (f == 0.0) continue;
      for (int c = col; c < k; ++c) M[r * k + c] -= f * M[col * k + c];
      rhs[r] -= f * rhs[col];
    }
  }
  for (int col = k - 1; col >= 0; --col) {
    double acc = rhs[col];
    for (int c = col + 1; c < k; ++c) acc -= M[col * k + c] * rhs[c];
    rhs[col] = acc / M[col * k + col];
  }
  return 0;
}

struct Work {
  int n, m, neq, k;
  const double *Q, *p, *G, *h, *A, *b;
  std::vector<double> M0;  // augmented matrix template (D-block patched)

  void build_template() {
    k = n + m + neq;
    M0.assign((size_t)k * k, 0.0);
    for (int i = 0; i < n; ++i)
      for (int j = 0; j < n; ++j) M0[(size_t)i * k + j] = Q[(size_t)i * n + j];
    for (int r = 0; r < m; ++r)
      for (int c = 0; c < n; ++c) {
        M0[(size_t)c * k + (n + r)] = G[(size_t)r * n + c];  // G^T
        M0[(size_t)(n + r) * k + c] = G[(size_t)r * n + c];  // G
      }
    for (int r = 0; r < neq; ++r)
      for (int c = 0; c < n; ++c) {
        M0[(size_t)c * k + (n + m + r)] = A[(size_t)r * n + c];  // A^T
        M0[(size_t)(n + m + r) * k + c] = A[(size_t)r * n + c];  // A
      }
  }

  // Newton solve given current s, z and rhs residuals.
  int newton(const double* s, const double* z, const double* rd,
             const double* rp, const double* re, const double* rc,
             double* dx, double* ds, double* dz, double* dy) {
    std::vector<double> M = M0;
    std::vector<double> rhs((size_t)k);
    for (int r = 0; r < m; ++r)
      M[(size_t)(n + r) * k + (n + r)] = -s[r] / z[r];
    for (int i = 0; i < n; ++i) rhs[i] = -rd[i];
    for (int r = 0; r < m; ++r) rhs[n + r] = -rp[r] + rc[r] / z[r];
    for (int r = 0; r < neq; ++r) rhs[n + m + r] = -re[r];
    if (lin_solve(M, rhs, k) != 0) return -1;
    std::memcpy(dx, rhs.data(), sizeof(double) * n);
    std::memcpy(dz, rhs.data() + n, sizeof(double) * m);
    if (neq) std::memcpy(dy, rhs.data() + n + m, sizeof(double) * neq);
    for (int r = 0; r < m; ++r) ds[r] = (-rc[r] - s[r] * dz[r]) / z[r];
    return 0;
  }
};

double max_step(const double* v, const double* dv, int m) {
  double a = 1.0;
  for (int i = 0; i < m; ++i)
    if (dv[i] < 0.0) {
      double t = -v[i] / dv[i];
      if (t < a) a = t;
    }
  return a;
}

}  // namespace

extern "C" {

// Solve one QP. Row-major inputs. Returns 0 = converged, 1 = max_iter
// reached (best effort), -1 = numerical failure.
int qp_solve(int n, int m, int neq, const double* Q, const double* p,
             const double* G, const double* h, const double* A,
             const double* b, double tol, int max_iter, double* x, double* y,
             double* lam, double* s) {
  Work w;
  w.n = n; w.m = m; w.neq = neq;
  w.Q = Q; w.p = p; w.G = G; w.h = h; w.A = A; w.b = b;
  w.build_template();

  // Interior start: x = (Q + I)^{-1}(-p); s = max(h - Gx, 1); z = 1; y = 0.
  {
    std::vector<double> M((size_t)n * n);
    std::vector<double> rhs((size_t)n);
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) M[(size_t)i * n + j] = Q[(size_t)i * n + j];
      M[(size_t)i * n + i] += 1.0;
      rhs[i] = -p[i];
    }
    if (lin_solve(M, rhs, n) != 0) return -1;
    std::memcpy(x, rhs.data(), sizeof(double) * n);
  }
  std::vector<double> z((size_t)m, 1.0);
  for (int r = 0; r < m; ++r) {
    double gx = 0.0;
    for (int c = 0; c < n; ++c) gx += G[(size_t)r * n + c] * x[c];
    double sv = h[r] - gx;
    s[r] = sv > 1.0 ? sv : 1.0;
  }
  for (int r = 0; r < neq; ++r) y[r] = 0.0;

  std::vector<double> rd(n), rp(m), re(neq), rc(m);
  std::vector<double> dx(n), ds(m), dz(m), dy(neq);
  std::vector<double> dx2(n), ds2(m), dz2(m), dy2(neq);

  int status = 1;
  for (int it = 0; it < max_iter; ++it) {
    // Residuals.
    for (int i = 0; i < n; ++i) {
      double acc = p[i];
      for (int j = 0; j < n; ++j) acc += Q[(size_t)i * n + j] * x[j];
      for (int r = 0; r < m; ++r) acc += G[(size_t)r * n + i] * z[r];
      for (int r = 0; r < neq; ++r) acc += A[(size_t)r * n + i] * y[r];
      rd[i] = acc;
    }
    double rmax = 0.0, mu = 0.0;
    for (int r = 0; r < m; ++r) {
      double gx = 0.0;
      for (int c = 0; c < n; ++c) gx += G[(size_t)r * n + c] * x[c];
      rp[r] = gx + s[r] - h[r];
      mu += s[r] * z[r];
    }
    mu /= m;
    for (int r = 0; r < neq; ++r) {
      double ax = 0.0;
      for (int c = 0; c < n; ++c) ax += A[(size_t)r * n + c] * x[c];
      re[r] = ax - b[r];
    }
    for (int i = 0; i < n; ++i) rmax = std::fmax(rmax, std::fabs(rd[i]));
    for (int r = 0; r < m; ++r) rmax = std::fmax(rmax, std::fabs(rp[r]));
    for (int r = 0; r < neq; ++r) rmax = std::fmax(rmax, std::fabs(re[r]));
    if (rmax < tol && mu < tol) { status = 0; break; }

    // Predictor.
    for (int r = 0; r < m; ++r) rc[r] = s[r] * z[r];
    if (w.newton(s, z.data(), rd.data(), rp.data(), re.data(), rc.data(),
                 dx.data(), ds.data(), dz.data(), dy.data()) != 0)
      return -1;
    double ap = max_step(s, ds.data(), m);
    double ad = max_step(z.data(), dz.data(), m);
    double mu_aff = 0.0;
    for (int r = 0; r < m; ++r)
      mu_aff += (s[r] + ap * ds[r]) * (z[r] + ad * dz[r]);
    mu_aff /= m;
    double sig = mu_aff / mu;
    sig = sig * sig * sig;

    // Corrector (combined).
    for (int r = 0; r < m; ++r)
      rc[r] = s[r] * z[r] + ds[r] * dz[r] - sig * mu;
    if (w.newton(s, z.data(), rd.data(), rp.data(), re.data(), rc.data(),
                 dx2.data(), ds2.data(), dz2.data(), dy2.data()) != 0)
      return -1;
    double eta = 0.99995;
    double a = std::fmin(eta * max_step(s, ds2.data(), m),
                         eta * max_step(z.data(), dz2.data(), m));
    if (a > 1.0) a = 1.0;
    for (int i = 0; i < n; ++i) x[i] += a * dx2[i];
    for (int r = 0; r < m; ++r) { s[r] += a * ds2[r]; z[r] += a * dz2[r]; }
    for (int r = 0; r < neq; ++r) y[r] += a * dy2[r];
  }
  std::memcpy(lam, z.data(), sizeof(double) * m);
  // Non-finite iterates (overflow on infeasible/degenerate instances)
  // count as numerical failure, not best-effort.
  for (int i = 0; i < n; ++i)
    if (!std::isfinite(x[i])) return -1;
  for (int r = 0; r < m; ++r)
    if (!std::isfinite(lam[r]) || !std::isfinite(s[r])) return -1;
  for (int r = 0; r < neq; ++r)
    if (!std::isfinite(y[r])) return -1;
  return status;
}

// Batched entry point: arrays have leading batch dims (bQ, bG, bA in {1, B}
// for matrix params; p/h/b at full B). Failed lanes are isolated: their
// outputs are NaN-filled (and flagged in `status` when non-null) while
// every healthy lane still gets its solution — one infeasible instance
// must not take down the batch (contrast the reference's whole-batch
// try/except bail-out, batch.py:110-113). Returns number of failed lanes.
int qp_solve_batch_status(int B, int n, int m, int neq, int bQ, int bG,
                          int bA, const double* Q, const double* p,
                          const double* G, const double* h, const double* A,
                          const double* b, double tol, int max_iter,
                          double* x, double* y, double* lam, double* s,
                          int* status) {
  int failures = 0;
  // Lanes are independent QPs; parallelize across host cores (the analog
  // of the reference batching its CVXPY fallback, which it never did —
  // qp.py:104-115 is a serial Python loop).
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int i = 0; i < B; ++i) {
    const double* Qi = Q + (size_t)(bQ > 1 ? i : 0) * n * n;
    const double* Gi = G + (size_t)(bG > 1 ? i : 0) * m * n;
    const double* Ai = neq ? A + (size_t)(bA > 1 ? i : 0) * neq * n : nullptr;
    int rc = qp_solve(n, m, neq, Qi, p + (size_t)i * n, Gi,
                      h + (size_t)i * m, Ai,
                      neq ? b + (size_t)i * neq : nullptr, tol, max_iter,
                      x + (size_t)i * n, y + (size_t)i * neq,
                      lam + (size_t)i * m, s + (size_t)i * m);
    if (rc < 0) {
      ++failures;
      const double qnan = std::nan("");
      for (int c = 0; c < n; ++c) x[(size_t)i * n + c] = qnan;
      for (int r = 0; r < neq; ++r) y[(size_t)i * neq + r] = qnan;
      for (int r = 0; r < m; ++r) {
        lam[(size_t)i * m + r] = qnan;
        s[(size_t)i * m + r] = qnan;
      }
    }
    if (status) status[i] = rc;
  }
  return failures;
}

// Back-compat wrapper without the per-lane status array.
int qp_solve_batch(int B, int n, int m, int neq, int bQ, int bG, int bA,
                   const double* Q, const double* p, const double* G,
                   const double* h, const double* A, const double* b,
                   double tol, int max_iter, double* x, double* y,
                   double* lam, double* s) {
  return qp_solve_batch_status(B, n, m, neq, bQ, bG, bA, Q, p, G, h, A, b,
                               tol, max_iter, x, y, lam, s, nullptr);
}

}  // extern "C"

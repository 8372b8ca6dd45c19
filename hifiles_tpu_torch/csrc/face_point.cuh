// K4, the interior common flux: the work of one face point and of one
// tile of face points, shared by the kernels (common_flux.cu) and the host
// driver the CPU tests build from this header with g++.
//
// At a face point, from its two sides' states u_l, u_r, the l side's unit
// normal n and, viscous, the element-side normal viscous fluxes qn_l, qn_r
// (K3's qn; the r side's carries the r element's own outward normal):
//   fn  = riemann(u_l, u_r, n)                 Rusanov, RoeM, HLLC, or
//                                              Lax-Friedrichs (equation 1)
//   s   = the LDG switch of n (ldg_sign)
//   fn += (1/2 + beta s) qn_l - (1/2 - beta s) qn_r - tau (u_r - u_l)
// and fn goes to the l side's flux-point slot, -fn to the r side's.  Each
// function follows the plane version of hifiles_tpu_torch/solver/
// residual_soa.py (rusanov_p, roem_p, hllc_p, lf_p, ldg_sign_p) operation
// for operation.
//
// Layouts (faces minor, as the residual's face planes; N = R * C points
// p = row * C + col):
//   u_l, u_r, qn_l, qn_r  (F, R, C)      qn null when inviscid
//   norm                  (d, R, C')     C' = C, or 1: one column of the
//                                        rows, broadcast over the faces
//   slot_l                (R, C)  int64  the l side's flux-point slot
//   slot_r                (R, n_r) int64 the r side's, the first n_r
//                                        columns only (a sharded run's
//                                        halo faces follow them)
//   out                   (F, n_slots)   the flux-point rows
// A row is one point of every face (R = nfp, C = faces) or the whole flat
// point axis of a mixed mesh (R = 1).
//
// A tile is rows x cols points of the planes: tile_compute takes point j of
// a tile in plane order (cols minor: neighbouring threads read neighbouring
// faces) and stages its fn and slots; tile_store takes point k in face
// order (rows minor: neighbouring threads write a face's run of slots).
#pragma once

#include "volume_point.cuh"

extern "C" {
// One launch's face planes.  Mirrored by
// hifiles_tpu_torch/solver/common_flux.py::_FaceArgs.
struct HftFaceArgs {
  const void *u_l, *u_r, *qn_l, *qn_r, *norm;
  const int64_t *slot_l, *slot_r;
  void* out;
  int32_t n_rows, n_cols, n_r, norm_cols;
  int64_t n_slots;
};

// The physics of a launch: equation 0 (Navier-Stokes or Euler, with the
// Riemann solver ``riemann``) or 1 (advection-diffusion, Lax-Friedrichs).
// Mirrored by hifiles_tpu_torch/solver/common_flux.py::_FacePhysics.
struct HftFacePhysics {
  int32_t equation, riemann, n_dims, n_fields, viscous;
  double gamma, ldg_beta, ldg_tau, lambda_lf, wave_speed[3];
};
}

namespace hft {

// riemann_solve_type's codes; Lax-Friedrichs is equation 1's flux
constexpr int kRusanov = 0, kRoeM = 2, kHllc = 3, kLaxFriedrichs = -1;

template <typename T>
struct FacePrm {
  T gamma, gm1, beta, tau, half_lam, ws[3];
};

// the constants as the plane version rounds them: Python floats combined
// in double, then cast to the planes' dtype
template <typename T>
FacePrm<T> face_prm_of(const HftFacePhysics& p) {
  FacePrm<T> prm;
  prm.gamma = static_cast<T>(p.gamma);
  prm.gm1 = static_cast<T>(p.gamma - 1.0);
  prm.beta = static_cast<T>(p.ldg_beta);
  prm.tau = static_cast<T>(p.ldg_tau);
  prm.half_lam = static_cast<T>(0.5 * p.lambda_lf);
  for (int m = 0; m < 3; ++m) prm.ws[m] = static_cast<T>(p.wave_speed[m]);
  return prm;
}

HFT_HD float dabs(float x) { return fabsf(x); }
HFT_HD double dabs(double x) { return fabs(x); }
HFT_HD float dpow(float x, float y) { return powf(x, y); }
HFT_HD double dpow(double x, double y) { return pow(x, y); }
template <typename T>
HFT_HD T dmin(T a, T b) { return b < a ? b : a; }
template <typename T>
HFT_HD T dmax(T a, T b) { return a < b ? b : a; }
// a value of a face plane, which the launch reads once
template <typename T>
HFT_HD T ld(const T* p) { return *p; }

// _prims_p
template <typename T, int D>
struct Prims {
  T rho, vel[D], vn, vsq, p;
};

template <typename T, int D, int F>
HFT_HD Prims<T, D> prims(const T (&u)[F], const T (&n)[D], T gm1) {
  Prims<T, D> q;
  q.rho = u[0];
  const T inv_rho = T(1) / q.rho;
#pragma unroll
  for (int m = 0; m < D; ++m) q.vel[m] = u[1 + m] * inv_rho;
  q.vn = q.vel[0] * n[0];
  q.vsq = q.vel[0] * q.vel[0];
#pragma unroll
  for (int m = 1; m < D; ++m) {
    q.vn += q.vel[m] * n[m];
    q.vsq += q.vel[m] * q.vel[m];
  }
  q.p = gm1 * (u[D + 1] - T(0.5) * q.rho * q.vsq);
  return q;
}

// _normal_flux_p; the SA working variable advects passively
template <typename T, int D, int F>
HFT_HD void normal_flux(const T (&u)[F], const T (&n)[D],
                        const Prims<T, D>& q, T (&f)[F]) {
  f[0] = q.rho * q.vn;
#pragma unroll
  for (int m = 0; m < D; ++m) f[1 + m] = u[1 + m] * q.vn + q.p * n[m];
  f[D + 1] = (u[D + 1] + q.p) * q.vn;
#pragma unroll
  for (int k = D + 2; k < F; ++k) f[k] = u[k] * q.vn;
}

// rusanov_p (ref:src/inters.cpp:277-324)
template <typename T, int D, int F>
HFT_HD void rusanov(const T (&ul)[F], const T (&ur)[F], const T (&n)[D],
                    const FacePrm<T>& prm, T (&f)[F]) {
  const Prims<T, D> l = prims<T, D, F>(ul, n, prm.gm1);
  const Prims<T, D> r = prims<T, D, F>(ur, n, prm.gm1);
  T fl[F], fr[F];
  normal_flux<T, D, F>(ul, n, l, fl);
  normal_flux<T, D, F>(ur, n, r, fr);
  const T eig = dsqrt(prm.gamma * (l.p + r.p) / (l.rho + r.rho)) +
                T(0.5) * dabs(l.vn + r.vn);
#pragma unroll
  for (int k = 0; k < F; ++k) {
    f[k] = T(0.5) * ((fl[k] + fr[k]) - eig * (ur[k] - ul[k]));
  }
}

// hllc_p: HLLC with Roe-average wavespeeds (ref:src/inters.cpp:439-532),
// the star state of the side that the wave speeds select alone
template <typename T, int D, int F>
HFT_HD void hllc(const T (&ul)[F], const T (&ur)[F], const T (&n)[D],
                 const FacePrm<T>& prm, T (&f)[F]) {
  static_assert(F == D + 2, "HLLC's star states carry no SA field");
  const Prims<T, D> l = prims<T, D, F>(ul, n, prm.gm1);
  const Prims<T, D> r = prims<T, D, F>(ur, n, prm.gm1);
  const T h_l = (ul[D + 1] + l.p) / l.rho;
  const T h_r = (ur[D + 1] + r.p) / r.rho;
  const T sq_rho = dsqrt(r.rho / l.rho);
  const T rrho = T(1) / (sq_rho + T(1));
  const T vn_m = rrho * (l.vn + sq_rho * r.vn);
  const T h_m = rrho * (h_l + sq_rho * h_r);
  const T a_m = dsqrt(prm.gm1 * (h_m - T(0.5) * vn_m * vn_m));
  const T S_R = vn_m + a_m;
  const T S_L = vn_m - a_m;
  const T S_star =
      (r.p - l.p + l.rho * l.vn * (S_L - l.vn) -
       r.rho * r.vn * (S_R - r.vn)) /
      (l.rho * (S_L - l.vn) - r.rho * (S_R - r.vn));
  const bool left = S_L >= T(0) || S_star >= T(0);
  const bool star = !(S_L >= T(0)) && (S_star >= T(0) || S_R >= T(0));
  const T(&u)[F] = left ? ul : ur;
  const Prims<T, D>& q = left ? l : r;
  normal_flux<T, D, F>(u, n, q, f);
  if (!star) return;
  const T S = left ? S_L : S_R;
  const T rcp = T(1) / (S - S_star);
  const T pre = q.p + q.rho * (S - q.vn) * (S_star - q.vn);
  f[0] = S_star * (S * u[0] - f[0]) * rcp;
#pragma unroll
  for (int m = 0; m < D; ++m) {
    f[1 + m] = (S_star * (S * u[1 + m] - f[1 + m]) + S * pre * n[m]) * rcp;
  }
  f[D + 1] = (S_star * (S * u[D + 1] - f[D + 1]) + S * pre * S_star) * rcp;
}

// roem_p: the RoeM scheme (ref:src/inters.cpp:327-437); the SA row's bdq
// term is zero
template <typename T, int D, int F>
HFT_HD void roem(const T (&ul)[F], const T (&ur)[F], const T (&n)[D],
                 const FacePrm<T>& prm, T (&f)[F]) {
  const Prims<T, D> l = prims<T, D, F>(ul, n, prm.gm1);
  const Prims<T, D> r = prims<T, D, F>(ur, n, prm.gm1);
  T fl[F], fr[F];
  normal_flux<T, D, F>(ul, n, l, fl);
  normal_flux<T, D, F>(ur, n, r, fr);
  const T h_l = (ul[D + 1] + l.p) / l.rho;
  const T h_r = (ur[D + 1] + r.p) / r.rho;
  const T drho = r.rho - l.rho, dp = r.p - l.p, dh = h_r - h_l;
  const T dvn = r.vn - l.vn;
  const T sq_rho = dsqrt(r.rho / l.rho);
  const T rrho = T(1) / (T(1) + sq_rho);
  const T ratr = sq_rho * rrho;
  const T ra = sq_rho * l.rho;
  const T ha = h_l * rrho + h_r * ratr;
  T va[D];
#pragma unroll
  for (int m = 0; m < D; ++m) va[m] = l.vel[m] * rrho + r.vel[m] * ratr;
  T qq = va[0] * va[0], va_n = va[0] * n[0];
#pragma unroll
  for (int m = 1; m < D; ++m) {
    qq += va[m] * va[m];
    va_n += va[m] * n[m];
  }
  const T aa = dsqrt(prm.gm1 * (ha - T(0.5) * qq));
  const T rcp_aa = T(1) / aa;
  const T abs_ma = dabs(va_n * rcp_aa);
  T b1 = dmax(dmax(va_n + aa, r.vn + aa), T(0));
  T b2 = dmin(dmin(va_n - aa, l.vn - aa), T(0));
  T b1b2 = b1 * b2;
  const T rcp_b1_b2 = T(1) / (b1 - b2);
  b1 = b1 * rcp_b1_b2;
  b2 = b2 * rcp_b1_b2;
  b1b2 = b1b2 * rcp_b1_b2;
  const T h = T(1) - dmin(l.p / r.p, r.p / l.p);
  const T f_ = abs_ma != T(0) ? dpow(abs_ma, h) : T(1);
  const T g_ = f_ / (T(1) + abs_ma);
  const T bdq0 = drho - f_ * dp * rcp_aa * rcp_aa;
  f[0] = b1 * fl[0] - b2 * fr[0] + b1b2 * ((ur[0] - ul[0]) - g_ * bdq0);
#pragma unroll
  for (int m = 0; m < D; ++m) {
    const T bq =
        bdq0 * va[m] + ra * ((r.vel[m] - l.vel[m]) - n[m] * dvn);
    f[1 + m] = b1 * fl[1 + m] - b2 * fr[1 + m] +
               b1b2 * ((ur[1 + m] - ul[1 + m]) - g_ * bq);
  }
  const T du_e = r.rho * h_r - l.rho * h_l;
  f[D + 1] = b1 * fl[D + 1] - b2 * fr[D + 1] +
             b1b2 * (du_e - g_ * (bdq0 * ha + ra * dh));
#pragma unroll
  for (int k = D + 2; k < F; ++k) {
    f[k] = b1 * fl[k] - b2 * fr[k] + b1b2 * ((ur[k] - ul[k]) - g_ * T(0));
  }
}

// lf_p: scalar advection's Lax-Friedrichs flux (ref:src/inters.cpp:535-557)
template <typename T, int D>
HFT_HD void lax_friedrichs(const T (&ul)[1], const T (&ur)[1],
                           const T (&n)[D], const FacePrm<T>& prm,
                           T (&f)[1]) {
  const T u_av = T(0.5) * (ul[0] + ur[0]);
  const T u_diff = ul[0] - ur[0];
  T ns = prm.ws[0] * n[0];
#pragma unroll
  for (int m = 1; m < D; ++m) ns += prm.ws[m] * n[m];
  f[0] = ns * u_av + prm.half_lam * dabs(ns) * u_diff;
}

// ldg_sign_p: riemann.ldg_beta_switch of the normal, tol 1e-10
template <typename T, int D>
HFT_HD T ldg_sign(const T (&n)[D]) {
  const T tol = T(1e-10);
  const T n0 = n[0], n01 = n[0] + n[1];
  if (n0 < -tol) return T(-1);
  if (n0 > tol) return T(1);
  if (n01 < -tol) return T(-1);
  if (n01 > tol) return T(1);
  if (D == 3 && n[0] + n[D - 1] < -tol) return T(-1);
  return T(1);
}

// The common flux of point (row, col) of the face planes, every field.
template <typename T, int D, int F, int SOLVER, bool VISC>
HFT_HD void face_point(const HftFaceArgs& a, const FacePrm<T>& prm, int row,
                       int col, T (&f)[F]) {
  const size_t plane = static_cast<size_t>(a.n_rows) * a.n_cols;
  const size_t p = static_cast<size_t>(row) * a.n_cols + col;
  const T* u_l = static_cast<const T*>(a.u_l) + p;
  const T* u_r = static_cast<const T*>(a.u_r) + p;
  T ul[F], ur[F], n[D];
#pragma unroll
  for (int i = 0; i < F; ++i) {
    ul[i] = ld(u_l + i * plane);
    ur[i] = ld(u_r + i * plane);
  }
  const size_t np = static_cast<size_t>(a.n_rows) * a.norm_cols;
  const T* norm = static_cast<const T*>(a.norm) +
                  (a.norm_cols == 1 ? static_cast<size_t>(row) : p);
#pragma unroll
  for (int m = 0; m < D; ++m) n[m] = ld(norm + m * np);
  if constexpr (SOLVER == kLaxFriedrichs) {
    lax_friedrichs<T, D>(ul, ur, n, prm, f);
  } else if constexpr (SOLVER == kRusanov) {
    rusanov<T, D, F>(ul, ur, n, prm, f);
  } else if constexpr (SOLVER == kRoeM) {
    roem<T, D, F>(ul, ur, n, prm, f);
  } else {
    hllc<T, D, F>(ul, ur, n, prm, f);
  }
  if constexpr (VISC) {
    // the LDG common viscous flux (ref:src/inters.cpp:561-611); the r
    // side enters with a sign flip, n_r = -n_l
    const T s = ldg_sign<T, D>(n);
    const T bl = T(0.5) + prm.beta * s;
    const T br = T(0.5) - prm.beta * s;
    const T* qn_l = static_cast<const T*>(a.qn_l) + p;
    const T* qn_r = static_cast<const T*>(a.qn_r) + p;
#pragma unroll
    for (int i = 0; i < F; ++i) {
      f[i] = f[i] + bl * ld(qn_l + i * plane) - br * ld(qn_r + i * plane) -
             prm.tau * (ur[i] - ul[i]);
    }
  }
}

// fn at the l side's slot, -fn at the r side's (sr < 0: none, a halo face)
template <typename T, int F>
HFT_HD void store_point(const HftFaceArgs& a, int64_t sl, int64_t sr,
                        const T (&f)[F]) {
  T* out = static_cast<T*>(a.out);
  const size_t n = static_cast<size_t>(a.n_slots);
#pragma unroll
  for (int i = 0; i < F; ++i) {
    out[i * n + sl] = f[i];
    if (sr >= 0) out[i * n + sr] = -f[i];
  }
}

// Point p (0 <= p < N) in plane order, written straight to its slots: the
// naive mapping, one thread a point
template <typename T, int D, int F, int SOLVER, bool VISC>
HFT_HD void naive_point(const HftFaceArgs& a, const FacePrm<T>& prm, int p) {
  const int row = p / a.n_cols;
  const int col = p - row * a.n_cols;
  T f[F];
  face_point<T, D, F, SOLVER, VISC>(a, prm, row, col, f);
  store_point<T, F>(
      a, a.slot_l[p],
      col < a.n_r ? a.slot_r[static_cast<size_t>(row) * a.n_r + col] : -1,
      f);
}

// The tile of a launch: rows x cols points, cols a multiple of 32 (a
// warp's run of faces in a row), rows x cols about kPoints; its staging
// area padded to cols + 1 a row so that a face's points sit in
// neighbouring banks.
struct FaceTile {
  int rows, cols;
  HFT_HD int pitch() const { return cols + 1; }
  HFT_HD int points() const { return rows * cols; }
};

template <typename T>
struct FaceTileSize {
  static constexpr int kPoints = sizeof(T) == 4 ? 1024 : 512;
  static constexpr int kMaxRows = sizeof(T) == 4 ? 32 : 16;
};

template <typename T>
FaceTile face_tile(int n_rows) {
  FaceTile t;
  t.rows = n_rows < FaceTileSize<T>::kMaxRows ? n_rows
                                              : FaceTileSize<T>::kMaxRows;
  if (t.rows < 1) t.rows = 1;
  t.cols = FaceTileSize<T>::kPoints / t.rows / 32 * 32;
  if (t.cols < 32) t.cols = 32;
  return t;
}

// the staging area of a tile: fn (F, rows, pitch), then the l and r slots
// (rows, pitch) as int32
template <typename T, int F>
size_t face_stage_bytes(const FaceTile& t) {
  return static_cast<size_t>(t.rows) * t.pitch() *
         (F * sizeof(T) + 2 * sizeof(int32_t));
}

// Point j of tile (tx, ty) in plane order: its fn and slots staged.
template <typename T, int D, int F, int SOLVER, bool VISC>
HFT_HD void tile_compute(const HftFaceArgs& a, const FacePrm<T>& prm,
                         const FaceTile& t, int tx, int ty, int j, T* s_f,
                         int32_t* s_sl, int32_t* s_sr) {
  const int r = j / t.cols;
  const int c = j - r * t.cols;
  const int row = ty * t.rows + r, col = tx * t.cols + c;
  if (row >= a.n_rows || col >= a.n_cols) return;
  T f[F];
  face_point<T, D, F, SOLVER, VISC>(a, prm, row, col, f);
  const int s = r * t.pitch() + c;
  const int fstride = t.rows * t.pitch();
#pragma unroll
  for (int i = 0; i < F; ++i) s_f[i * fstride + s] = f[i];
  s_sl[s] = static_cast<int32_t>(
      ld(a.slot_l + static_cast<size_t>(row) * a.n_cols + col));
  s_sr[s] = col < a.n_r ? static_cast<int32_t>(ld(
                              a.slot_r + static_cast<size_t>(row) * a.n_r +
                              col))
                        : -1;
}

// Point k of tile (tx, ty) in face order (rows minor), written from the
// staging area to its slots.
template <typename T, int F>
HFT_HD void tile_store(const HftFaceArgs& a, const FaceTile& t, int tx,
                       int ty, int k, const T* s_f, const int32_t* s_sl,
                       const int32_t* s_sr) {
  const int c = k / t.rows;
  const int r = k - c * t.rows;
  const int row = ty * t.rows + r, col = tx * t.cols + c;
  if (row >= a.n_rows || col >= a.n_cols) return;
  const int s = r * t.pitch() + c;
  const int fstride = t.rows * t.pitch();
  T f[F];
#pragma unroll
  for (int i = 0; i < F; ++i) f[i] = s_f[i * fstride + s];
  store_point<T, F>(a, s_sl[s], s_sr[s], f);
}

// The launches K4 refuses: another d; equation 0 with F other than d + 2
// or d + 3, an unknown solver or HLLC with the SA field; equation 1 with
// F other than 1; another equation; viscous without qn; n_r beyond the
// columns, a normal that is neither full nor one column; more points or
// slots than an int counts; a missing plane of a launch with points.
inline bool face_refused(const HftFaceArgs& a, const HftFacePhysics& p) {
  const int d = p.n_dims, f = p.n_fields;
  bool known = false;
  if (p.equation == 1) {
    known = f == 1;
  } else if (p.equation == 0) {
    known = (f == d + 2 || f == d + 3) &&
            (p.riemann == kRusanov || p.riemann == kRoeM ||
             (p.riemann == kHllc && f == d + 2));
  }
  const long long n = static_cast<long long>(a.n_rows) * a.n_cols;
  if ((d != 2 && d != 3) || !known || a.n_rows < 0 || a.n_cols < 0 ||
      a.n_r < 0 || a.n_r > a.n_cols || n > 0x7fffffff ||
      (a.norm_cols != 1 && a.norm_cols != a.n_cols) || a.n_slots < 0 ||
      a.n_slots > 0x7fffffff) {
    return true;
  }
  return n > 0 && (!a.u_l || !a.u_r || !a.norm || !a.slot_l ||
                   (a.n_r > 0 && !a.slot_r) || !a.out ||
                   (p.viscous && (!a.qn_l || !a.qn_r)));
}

// Runs ``op.run<T, D, F, SOLVER, VISC>()``, the instantiation of the
// launch's physics, and returns its int.
template <typename T, int D, int F, int SOLVER, class Op>
int by_visc(bool viscous, const Op& op) {
  return viscous ? op.template run<T, D, F, SOLVER, true>()
                 : op.template run<T, D, F, SOLVER, false>();
}

template <typename T, int D, class Op>
int by_solver(const HftFacePhysics& p, const Op& op) {
  const bool v = p.viscous != 0;
  if (p.equation == 1) return by_visc<T, D, 1, kLaxFriedrichs>(v, op);
  const bool sa = p.n_fields == D + 3;
  switch (p.riemann) {
    case kRusanov:
      return sa ? by_visc<T, D, D + 3, kRusanov>(v, op)
                : by_visc<T, D, D + 2, kRusanov>(v, op);
    case kRoeM:
      return sa ? by_visc<T, D, D + 3, kRoeM>(v, op)
                : by_visc<T, D, D + 2, kRoeM>(v, op);
    default:
      return by_visc<T, D, D + 2, kHllc>(v, op);
  }
}

template <typename T, class Op>
int dispatch_face(const HftFacePhysics& p, const Op& op) {
  return p.n_dims == 2 ? by_solver<T, 2>(p, op) : by_solver<T, 3>(p, op);
}

}  // namespace hft

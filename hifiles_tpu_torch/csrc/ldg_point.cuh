// K3, the element side of the LDG gradient path: the work of one flux
// point and of one solution point, shared by the kernels (ldg_element.cu)
// and the host driver the CPU tests build from this header with g++.
//
// At a flux point (fpts_slot), from the transformed gradient extrapolated
// there:
//   g[l][i]  = (1/det) sum_m adj(J)[m][l] tgf[m][i]     physical gradient
//   f[i][m]  = the viscous (+ SGS, + added) flux of the point (point_flux
//              of volume_point.cuh, inviscid part off)
//   qn[i]    = sum_m f[i][m] n[m]                       normal projection
// and g itself where the block has boundary faces (their viscous flux
// reads it).  At a solution point (upts_point), from the transformed
// gradient with its face lift:
//   gr[l][i] = (1/det) sum_m adj(J)[m][l] tg[m][i]
//
// Layouts (elements minor, as the residual's; S = E * Pf flux-point slots
// e * Pf + fpt):
//   tgf    (d, F, E, Pf)   transformed gradient at the flux points
//   u      (F, E, Pf)      state at the flux points
//   jg     (d, d, E', Pf)  adj(J)[m][l]
//   inv_det (E', Pf), norm (d, E', Pf), delta and wdist (E', Pf)
//   extra  (d, F, E, Pf)   added physical flux at the flux points, or null
//   -> qn (F, E, Pf), grad (d, F, E, Pf) or null
// and at the solution points
//   tg (d, U, F, E), jg (d, d, U, E'), inv_det (U, E') -> grad (d, U, F, E),
// the layout the volume kernel reads.  E' = E (element stride 1) or 1
// (stride 0: one column broadcast over the elements of a uniform mesh).
#pragma once

#include "volume_point.cuh"

extern "C" {
// One block's planes at the flux points; the physics is HftVolumeArgs
// (viscous, the inviscid part off).  Mirrored by
// hifiles_tpu_torch/solver/ldg_element.py::_FptsArgs.
struct HftFptsArgs {
  const void *tgf, *u, *jg, *inv_det, *norm, *delta, *wdist, *extra;
  void *qn, *grad;
  int32_t n_eles, n_fpts;
  int32_t jg_stride, inv_det_stride, norm_stride, delta_stride, wdist_stride;
};

// One block's planes at the solution points.  Mirrored by
// hifiles_tpu_torch/solver/ldg_element.py::_UptsArgs.
struct HftUptsArgs {
  const void *tg, *jg, *inv_det;
  void* grad;
  int32_t n_dims, n_upts, n_fields, n_eles, jg_stride, inv_det_stride;
};
}

namespace hft {

// The points of a launch, a * b, as an int; -1 when they do not fit one.
inline int launch_points(int32_t a, int32_t b) {
  const long long n = static_cast<long long>(a) * b;
  return a < 0 || b < 0 || n > 0x7fffffff ? -1 : static_cast<int>(n);
}

// The launches K3 refuses: another d, F or SGS model than the volume
// kernel's, the inviscid part on or the viscous part off, or more points
// than an int counts.
inline bool fpts_refused(const HftFptsArgs& a, const HftVolumeArgs& p) {
  const int d = p.n_dims, f = p.n_fields;
  return (d != 2 && d != 3) || (f != d + 2 && f != d + 3) ||
         p.sgs < kSgsNone || p.sgs > kSgsWale || !p.viscous || p.inviscid ||
         launch_points(a.n_eles, a.n_fpts) < 0;
}

inline bool upts_refused(const HftUptsArgs& a) {
  return (a.n_dims != 2 && a.n_dims != 3) || a.n_fields < 1 ||
         launch_points(a.n_upts, a.n_eles) < 0;
}

// point_flux's inputs at one flux point: the state read where the flux
// needs it, the physical gradient already in registers
template <typename T, int D, int F>
struct FluxPoint {
  const T* up;  // &u[0][slot]
  const T* xp;  // &extra[0][0][slot], or null
  size_t plane;  // E * Pf
  T dl, wd;
  T grad[D][F];
  HFT_HD T u(int i) const { return up[i * plane]; }
  HFT_HD T g(int dd, int i) const { return grad[dd][i]; }
  HFT_HD T delta() const { return dl; }
  HFT_HD T wdist() const { return wd; }
  HFT_HD T extra(int dd, int i) const { return xp[(dd * F + i) * plane]; }
};

// Flux point ``s`` (0 <= s < E * Pf) of one block.
template <typename T, int D, int F, int SGS>
HFT_HD void fpts_slot(const HftFptsArgs& a, const Params<T>& prm, int s) {
  const size_t n = static_cast<size_t>(a.n_eles) * a.n_fpts;
  const int col = s % a.n_fpts;
  // a geometry plane's entry for this slot, and its planes' stride
  const size_t gj = a.jg_stride ? s : col;
  const size_t pj = a.jg_stride ? n : a.n_fpts;
  const T* tgf = static_cast<const T*>(a.tgf) + s;
  const T* jg = static_cast<const T*>(a.jg) + gj;
  const T inv_det =
      static_cast<const T*>(a.inv_det)[a.inv_det_stride ? s : col];

  FluxPoint<T, D, F> in;
  in.up = static_cast<const T*>(a.u) + s;
  in.xp = a.extra ? static_cast<const T*>(a.extra) + s : nullptr;
  in.plane = n;
  in.dl = in.wd = T(0);
  if (SGS != kSgsNone) {
    in.dl = static_cast<const T*>(a.delta)[a.delta_stride ? s : col];
  }
  if (SGS == kSgsSmagorinsky) {
    in.wd = static_cast<const T*>(a.wdist)[a.wdist_stride ? s : col];
  }
  T t[D][F];
#pragma unroll
  for (int m = 0; m < D; ++m) {
#pragma unroll
    for (int i = 0; i < F; ++i) t[m][i] = tgf[(m * F + i) * n];
  }
#pragma unroll
  for (int l = 0; l < D; ++l) {
    T adj[D];  // adj(J)[m][l]
#pragma unroll
    for (int m = 0; m < D; ++m) adj[m] = jg[(m * D + l) * pj];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      T acc = adj[0] * t[0][i];
#pragma unroll
      for (int m = 1; m < D; ++m) acc += adj[m] * t[m][i];
      in.grad[l][i] = acc * inv_det;
    }
  }
  if (a.grad) {
    T* g = static_cast<T*>(a.grad) + s;
#pragma unroll
    for (int l = 0; l < D; ++l) {
#pragma unroll
      for (int i = 0; i < F; ++i) g[(l * F + i) * n] = in.grad[l][i];
    }
  }

  T f[F][D];
  point_flux<T, D, F, SGS, false>(in, prm, f);
  const size_t nn = a.norm_stride ? n : a.n_fpts;
  const T* norm = static_cast<const T*>(a.norm) + (a.norm_stride ? s : col);
  T nrm[D];
#pragma unroll
  for (int m = 0; m < D; ++m) nrm[m] = norm[m * nn];
  T* qn = static_cast<T*>(a.qn) + s;
#pragma unroll
  for (int i = 0; i < F; ++i) {
    T acc = f[i][0] * nrm[0];
#pragma unroll
    for (int m = 1; m < D; ++m) acc += f[i][m] * nrm[m];
    qn[i * n] = acc;
  }
}

// Solution point ``p`` = upt * E + e (0 <= p < U * E) of one block, every
// field.
template <typename T, int D>
HFT_HD void upts_point(const HftUptsArgs& a, int p) {
  const int E = a.n_eles, U = a.n_upts, F = a.n_fields;
  const int upt = p / E;
  const int e = p - upt * E;
  const size_t Ej = a.jg_stride ? E : 1;
  const size_t gj = static_cast<size_t>(upt) * Ej + (a.jg_stride ? e : 0);
  const T* jg = static_cast<const T*>(a.jg) + gj;
  const T inv_det = static_cast<const T*>(
      a.inv_det)[static_cast<size_t>(upt) * (a.inv_det_stride ? E : 1) +
                 (a.inv_det_stride ? e : 0)];
  T adj[D][D];  // adj[m][l] = adj(J)[m][l]
#pragma unroll
  for (int m = 0; m < D; ++m) {
#pragma unroll
    for (int l = 0; l < D; ++l) adj[m][l] = jg[(m * D + l) * U * Ej];
  }
  // (m, upt, i, e) of a (d, U, F, E) array
  const size_t field = E, dim = static_cast<size_t>(U) * F * E;
  const size_t base = static_cast<size_t>(upt) * F * E + e;
  const T* tg = static_cast<const T*>(a.tg) + base;
  T* gr = static_cast<T*>(a.grad) + base;
  for (int i = 0; i < F; ++i) {
    T t[D];
#pragma unroll
    for (int m = 0; m < D; ++m) t[m] = tg[m * dim + i * field];
#pragma unroll
    for (int l = 0; l < D; ++l) {
      T acc = adj[0][l] * t[0];
#pragma unroll
      for (int m = 1; m < D; ++m) acc += adj[m][l] * t[m];
      gr[l * dim + i * field] = acc * inv_det;
    }
  }
}

}  // namespace hft

// The volume kernel's work for one solution point, and the tiling that
// hands points to it; shared by the kernel (volume_tdisf.cu) and the host
// driver the CPU tests build from this header with g++.  The physical
// flux of one point (point_flux) is K3's too (ldg_point.cuh), which
// projects it on the face normal instead.
//
// Per point: the 2-D or 3-D physical flux of the configuration
// (point_flux), then the adjugate transform
//   tdisf[l][i] = sum_m adj(J)[l][m] * f_i,m   (point_tdisf)
//   * the Euler flux, with the SA working variable advected (F = d + 3);
//   * the Navier-Stokes flux with constant or Sutherland viscosity, and for
//     F = d + 3 the SA eddy viscosity mu_t = nu~ f_v1, its conductivity
//     and the SA diffusion row (ref:src/flux.cpp:127-325);
//   * an eddy-viscosity SGS flux, Smagorinsky with wall limiting or WALE
//     (ref:src/eles.cpp:2470-2612; the deviatoric parts subtract a third
//     of the trace at d = 2 too, as the JAX sgs_flux_p does);
//   * an added physical flux (the similarity SGS flux), before the
//     transform;
//   * the inviscid part on or off (template parameter INV).
//
// Layouts of one segment (one element block of one shard; elements minor):
//   u      (U, F, E)      conserved state, F = d + 2 or d + 3
//   grad   (d, U, F, E)   physical gradient (read only when viscous)
//   jg     (d, d, U, E')  adj(J)[l][m]
//   delta  (U, E')        SGS cutoff length, filter ratio included
//   wdist  (U, E')        wall distance
//   extra  (d, U, F, E)   added physical flux, or null
//   out    (d, U, F, E)   transformed flux
// E' = E (element stride 1) or 1 (stride 0: one column broadcast over the
// elements of a uniform mesh).
//
// A tile is one solution point times up to kElems consecutive elements
// of one segment.  Each input plane of a tile (a field of u, grad or
// extra, an entry of jg, delta, wdist at element stride 1) is one
// contiguous run of the tile's elements, staged at its own slot of a
// shared-memory stage: slot s holds the run of plane_run(..., s).  Planes
// at element stride 0 are not staged: a tile reads their one value.
#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#ifndef HFT_HD
#ifdef __CUDACC__
#define HFT_HD __host__ __device__ __forceinline__
#else
#define HFT_HD inline
#endif
#endif

extern "C" {
// Physics of one launch, uniform over its segments; mirrored by
// hifiles_tpu_torch/solver/volume.py::_Args.
struct HftVolumeArgs {
  int32_t n_fields, n_dims;
  double gamma, prandtl, prandtl_t, mu_inf, rt_inf, c_sth, c_v1, omega, C_s,
      kappa;
  int32_t viscous, inviscid, sutherland, sgs, has_extra;
};

// One segment of a launch: one element block of one shard.  The caller
// sets the pointers, U, E and the element strides (0 or 1) of jg, delta
// and wdist; fill_table sets first_tile, tiles_per_row and bulk.
// Mirrored by hifiles_tpu_torch/solver/volume.py::_Segment.
struct HftVolumeSegment {
  const void *u, *grad, *jg, *delta, *wdist, *extra;
  void* out;
  int32_t n_upts, n_eles, jg_stride, delta_stride, wdist_stride;
  int32_t first_tile, tiles_per_row, bulk;
};
}

namespace hft {

constexpr int kMaxSegments = 16;
constexpr int kSgsNone = -1, kSgsSmagorinsky = 0, kSgsWale = 1;

// elements of a tile, and the threads of a CTA: 512 B per staged plane in
// f32, 1 KB in f64
template <typename T>
struct TileShape {
  static constexpr int kElems = 128;
};

// planes a tile stages at most: u, grad, jg, delta, wdist, extra
template <int D, int F>
struct MaxPlanes {
  static constexpr int value = F + D * F + D * D + 2 + D * F;
};

template <typename T>
struct Params {
  T gamma, prandtl, prandtl_t, mu_inf, rt_inf, c_sth, c_v1, omega, C_s, kappa;
  bool viscous, sutherland, has_extra;
};

template <typename T>
Params<T> params_of(const HftVolumeArgs& a) {
  Params<T> prm;
  prm.gamma = static_cast<T>(a.gamma);
  prm.prandtl = static_cast<T>(a.prandtl);
  prm.prandtl_t = static_cast<T>(a.prandtl_t);
  prm.mu_inf = static_cast<T>(a.mu_inf);
  prm.rt_inf = static_cast<T>(a.rt_inf);
  prm.c_sth = static_cast<T>(a.c_sth);
  prm.c_v1 = static_cast<T>(a.c_v1);
  prm.omega = static_cast<T>(a.omega);
  prm.C_s = static_cast<T>(a.C_s);
  prm.kappa = static_cast<T>(a.kappa);
  prm.viscous = a.viscous != 0;
  prm.sutherland = a.sutherland != 0;
  prm.has_extra = a.has_extra != 0;
  return prm;
}

HFT_HD float dsqrt(float x) { return sqrtf(x); }
HFT_HD double dsqrt(double x) { return sqrt(x); }
HFT_HD float dexp(float x) { return expf(x); }
HFT_HD double dexp(double x) { return exp(x); }
HFT_HD float dlog1p(float x) { return log1pf(x); }
HFT_HD double dlog1p(double x) { return log1p(x); }

// log(1 + exp(x)) in the form that cannot overflow (jax.nn.softplus)
template <typename T>
HFT_HD T softplus(T x) {
  return (x > T(0) ? x : T(0)) + dlog1p(dexp(-(x < T(0) ? -x : x)));
}

// The physical flux of one point, f[i][dd] of field i along dimension dd.
// ``in`` gives the point's inputs: u(i), g(dd, i) = d u_i / d x_dd,
// delta(), wdist() and extra(dd, i), each read where the arithmetic first
// needs it.
template <typename T, int D, int F, int SGS, bool INV, class In>
HFT_HD void point_flux(const In& in, const Params<T>& prm, T (&f)[F][D]) {
  static_assert(D == 2 || D == 3, "2-D or 3-D");
  static_assert(F == D + 2 || F == D + 3, "NS fields, or NS + SA");
  constexpr bool kSA = F == D + 3;  // the SA working variable is field F-1
  constexpr int kE = D + 1;         // total energy

  T q[F];
#pragma unroll
  for (int i = 0; i < F; ++i) q[i] = in.u(i);
  const T rho = q[0];
  const T inv_rho = T(1) / rho;
  T v[D];
  T q2 = T(0);
#pragma unroll
  for (int m = 0; m < D; ++m) {
    v[m] = q[1 + m] * inv_rho;
    q2 += v[m] * v[m];
  }

  if (INV) {
    const T p = (prm.gamma - T(1)) * (q[kE] - T(0.5) * rho * q2);
    const T hp = q[kE] + p;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      f[0][dd] = q[1 + dd];
#pragma unroll
      for (int i = 0; i < D; ++i) f[1 + i][dd] = q[1 + i] * v[dd];
      f[kE][dd] = hp * v[dd];
      if (kSA) f[F - 1][dd] = q[F - 1] * v[dd];  // SA advection
      f[1 + dd][dd] += p;
    }
  } else {
#pragma unroll
    for (int i = 0; i < F; ++i) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) f[i][dd] = T(0);
    }
  }

  if (prm.viscous) {
    T g[F][D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
#pragma unroll
      for (int i = 0; i < F; ++i) g[i][dd] = in.g(dd, i);
    }
    T dv[D][D];  // dv[i][dd] = d v_i / d x_dd
#pragma unroll
    for (int i = 0; i < D; ++i) {
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        dv[i][dd] = (g[1 + i][dd] - v[i] * g[0][dd]) * inv_rho;
      }
    }
    const T inte = q[kE] * inv_rho - T(0.5) * q2;
    T dint[D];
    T div = T(0);
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      T vdv = T(0);
#pragma unroll
      for (int i = 0; i < D; ++i) vdv += v[i] * dv[i][dd];
      dint[dd] = (g[kE][dd] - (T(0.5) * q2 + inte) * g[0][dd]) * inv_rho - vdv;
      div += dv[dd][dd];
    }

    T mu = prm.mu_inf;
    if (prm.sutherland) {
      const T rt = (prm.gamma - T(1)) * inte / prm.rt_inf;
      mu = prm.mu_inf * rt * dsqrt(rt) * (T(1) + prm.c_sth) / (rt + prm.c_sth);
    }
    T mu_tot = mu;
    T kth = mu * prm.gamma / prm.prandtl;
    T chi = T(0);
    if (kSA) {
      // SA eddy viscosity, clipped at nu~ < 0
      const T nu_c = q[F - 1];
      chi = nu_c / mu;
      const T chi3 = chi * chi * chi;
      const T fv1 = chi3 / (chi3 + prm.c_v1 * prm.c_v1 * prm.c_v1);
      const T mu_t = nu_c >= T(0) ? nu_c * fv1 : T(0);
      mu_tot = mu + mu_t;
      kth = (mu / prm.prandtl + mu_t / prm.prandtl_t) * prm.gamma;
    }
    const T lam = T(-2.0 / 3.0) * mu_tot * div;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      T tau[D];  // tau[i] = tau_i,dd
#pragma unroll
      for (int i = 0; i < D; ++i) {
        tau[i] = mu_tot * (dv[i][dd] + dv[dd][i]);
      }
      tau[dd] += lam;
      T vtau = T(0);
#pragma unroll
      for (int i = 0; i < D; ++i) {
        f[1 + i][dd] -= tau[i];
        vtau += v[i] * tau[i];
      }
      f[kE][dd] -= vtau + kth * dint[dd];
    }
    if (kSA) {
      // SA diffusion, psi through the overflow-free softplus
      const T nu_tilde = q[F - 1] * inv_rho;
      const T psi =
          chi <= T(10) ? T(0.05) * softplus(T(20) * chi) : chi;
      const T coef = (T(1) / prm.omega) * mu * (T(1) + psi);
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        f[F - 1][dd] -= coef * (g[F - 1][dd] - g[0][dd] * nu_tilde) * inv_rho;
      }
    }

    if (SGS != kSgsNone) {
      const T dl = in.delta();
      T S[D][D];
      T s2 = T(0);
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int l = 0; l < D; ++l) {
          S[i][l] = T(0.5) * (dv[i][l] + dv[l][i]);
          s2 += S[i][l] * S[i][l];
        }
      }
      T mu_sgs;
      if (SGS == kSgsSmagorinsky) {
        const T wd = in.wdist();
        const T a = wd * wd * (prm.kappa * prm.kappa);
        const T b = (prm.C_s * prm.C_s) * dl * dl;
        mu_sgs = rho * (a < b ? a : b) * dsqrt(T(2) * s2);
      } else {
        T g2[D][D];
        T tr3 = T(0);
#pragma unroll
        for (int i = 0; i < D; ++i) {
#pragma unroll
          for (int l = 0; l < D; ++l) {
            T acc = T(0);
#pragma unroll
            for (int k = 0; k < D; ++k) acc += dv[i][k] * dv[k][l];
            g2[i][l] = acc;
          }
          tr3 += g2[i][i];
        }
        tr3 /= T(3);  // a third of the trace at d = 2 as well (sgs_flux_p)
        T num = T(0);
#pragma unroll
        for (int i = 0; i < D; ++i) {
#pragma unroll
          for (int l = 0; l < D; ++l) {
            const T sq = T(0.5) * (g2[i][l] + g2[l][i]) - (i == l ? tr3 : T(0));
            num += sq * sq;
          }
        }
        const T rnum = dsqrt(num);
        const T den = s2 * s2 * dsqrt(s2) + num * dsqrt(rnum);
        mu_sgs = rho * (prm.C_s * prm.C_s) * dl * dl * num * rnum /
                 (den + T(1e-12));
      }
      T trS3 = T(0);
#pragma unroll
      for (int i = 0; i < D; ++i) trS3 += S[i][i];
      trS3 /= T(3);
      const T coef = prm.gamma * mu_sgs / prm.prandtl_t;
#pragma unroll
      for (int mm = 0; mm < D; ++mm) {
        T mom[D];  // mom[i] = -2 mu_sgs (S_i,mm - delta_i,mm trS/3)
        T vdv = T(0);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          mom[i] = T(-2) * mu_sgs * (S[i][mm] - (i == mm ? trS3 : T(0)));
          vdv += v[i] * dv[i][mm];
        }
        // de = d(e_int)/dx_mm in the form of the JAX sgs_flux_p
        const T dke = T(0.5) * q2 * g[0][mm] + rho * vdv;
        const T de = (g[kE][mm] - dke - g[0][mm] * inte) * inv_rho;
        T vmom = T(0);
#pragma unroll
        for (int i = 0; i < D; ++i) {
          f[1 + i][mm] += mom[i];
          vmom += v[i] * mom[i];
        }
        f[kE][mm] += -coef * de + vmom;
      }
    }
  }

  if (prm.has_extra) {
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
#pragma unroll
      for (int i = 0; i < F; ++i) f[i][dd] += in.extra(dd, i);
    }
  }
}

// The transformed flux of one point: point_flux, then the adjugate
// transform.  ``in`` gives point_flux's inputs and jg(l, m);
// ``out.put(l, i, v)`` takes tdisf[l][i].
template <typename T, int D, int F, int SGS, bool INV, class In, class Out>
HFT_HD void point_tdisf(const In& in, const Params<T>& prm, const Out& out) {
  T f[F][D];
  point_flux<T, D, F, SGS, INV>(in, prm, f);
#pragma unroll
  for (int l = 0; l < D; ++l) {
    T a[D];
#pragma unroll
    for (int mm = 0; mm < D; ++mm) a[mm] = in.jg(l, mm);
#pragma unroll
    for (int i = 0; i < F; ++i) {
      T acc = a[0] * f[i][0];
#pragma unroll
      for (int mm = 1; mm < D; ++mm) acc += a[mm] * f[i][mm];
      out.put(l, i, acc);
    }
  }
}

// ----------------------------------------------------------------------
// tiles
// ----------------------------------------------------------------------

struct TileLoc {
  int seg, upt, e0, n;  // segment, solution point, first element, elements
};

// Tile ``tile`` of a table whose segments fill_table has numbered: the
// last segment starting at or before it, then its point and element run.
HFT_HD TileLoc tile_location(const HftVolumeSegment* seg, int n_seg, int tile,
                             int te) {
  int s = 0;
  for (int k = 1; k < n_seg; ++k) {
    if (seg[k].first_tile <= tile) s = k;
  }
  const int local = tile - seg[s].first_tile;
  const int upt = local / seg[s].tiles_per_row;
  const int e0 = (local - upt * seg[s].tiles_per_row) * te;
  const int left = seg[s].n_eles - e0;
  return TileLoc{s, upt, e0, left < te ? left : te};
}

// Which inputs a segment stages, as slot offsets (-1: not staged).
struct StageSlots {
  int grad, jg, delta, wdist, extra, n;
};

template <int D, int F, int SGS>
HFT_HD StageSlots stage_slots(const HftVolumeSegment& s, bool viscous,
                              bool has_extra) {
  StageSlots st;
  int n = F;  // u's F planes first
  st.grad = viscous ? n : -1;
  n += viscous ? D * F : 0;
  st.jg = s.jg_stride ? n : -1;
  n += s.jg_stride ? D * D : 0;
  const bool sgs = viscous && SGS != kSgsNone;
  st.delta = sgs && s.delta_stride ? n : -1;
  n += st.delta >= 0 ? 1 : 0;
  st.wdist = sgs && SGS == kSgsSmagorinsky && s.wdist_stride ? n : -1;
  n += st.wdist >= 0 ? 1 : 0;
  st.extra = has_extra ? n : -1;
  n += has_extra ? D * F : 0;
  st.n = n;
  return st;
}

// The first element of slot ``slot``'s run for the tile at (upt, e0).
template <typename T, int D, int F>
HFT_HD const T* plane_run(const HftVolumeSegment& s, const StageSlots& st,
                          int upt, int e0, int slot) {
  const int U = s.n_upts;
  const size_t E = static_cast<size_t>(s.n_eles);
  const T* base;
  int plane;  // index of the (..., E) plane in its array
  if (slot < F) {
    base = static_cast<const T*>(s.u);
    plane = upt * F + slot;
  } else if (st.grad >= 0 && slot < st.grad + D * F) {
    const int k = slot - st.grad;  // dd * F + i
    base = static_cast<const T*>(s.grad);
    plane = ((k / F) * U + upt) * F + k % F;
  } else if (st.jg >= 0 && slot < st.jg + D * D) {
    base = static_cast<const T*>(s.jg);
    plane = (slot - st.jg) * U + upt;
  } else if (slot == st.delta) {
    base = static_cast<const T*>(s.delta);
    plane = upt;
  } else if (slot == st.wdist) {
    base = static_cast<const T*>(s.wdist);
    plane = upt;
  } else {
    const int k = slot - st.extra;  // dd * F + i
    base = static_cast<const T*>(s.extra);
    plane = ((k / F) * U + upt) * F + k % F;
  }
  return base + plane * E + e0;
}

// The inputs of element j of a staged tile: staged planes from the stage
// (slot s at stage[s * TE + j]), planes at element stride 0 from their
// one column.
template <typename T, int D, int F>
struct StagedPoint {
  const T* stage;
  const HftVolumeSegment* seg;
  StageSlots st;
  int upt, j;

  static constexpr int TE = TileShape<T>::kElems;
  HFT_HD T at(int slot) const { return stage[slot * TE + j]; }
  HFT_HD T u(int i) const { return at(i); }
  HFT_HD T g(int dd, int i) const { return at(st.grad + dd * F + i); }
  HFT_HD T extra(int dd, int i) const { return at(st.extra + dd * F + i); }
  HFT_HD T jg(int l, int m) const {
    return st.jg >= 0 ? at(st.jg + l * D + m)
                      : static_cast<const T*>(seg->jg)[(l * D + m) *
                                                         seg->n_upts + upt];
  }
  HFT_HD T delta() const {
    return st.delta >= 0 ? at(st.delta)
                         : static_cast<const T*>(seg->delta)[upt];
  }
  HFT_HD T wdist() const {
    return st.wdist >= 0 ? at(st.wdist)
                         : static_cast<const T*>(seg->wdist)[upt];
  }
};

// Stores tdisf[l][i] of element e0 + j at (l, upt, i, e0 + j) of out.
template <typename T, int F>
struct PointOut {
  T* out;  // &out[0][upt][0][e0 + j]
  size_t dim_stride;  // U * F * E
  size_t field_stride;  // E
  HFT_HD void put(int l, int i, T v) const {
    out[l * dim_stride + i * field_stride] = v;
  }
};

// Numbers the tiles of a table: each segment's first_tile and
// tiles_per_row, and bulk (1 where every staged run starts and ends on a
// 16-byte boundary, so a 1-D bulk copy can stage it).  Returns the table's
// tile count.
template <typename T, int D, int F, int SGS>
int fill_table(HftVolumeSegment* seg, int n_seg, bool viscous,
               bool has_extra) {
  constexpr int TE = TileShape<T>::kElems;
  int tiles = 0;
  for (int k = 0; k < n_seg; ++k) {
    HftVolumeSegment& s = seg[k];
    const StageSlots st = stage_slots<D, F, SGS>(s, viscous, has_extra);
    s.first_tile = tiles;
    s.tiles_per_row = (s.n_eles + TE - 1) / TE;
    tiles += s.n_upts * s.tiles_per_row;
    const void* staged[6] = {s.u, st.grad >= 0 ? s.grad : nullptr,
                             st.jg >= 0 ? s.jg : nullptr,
                             st.delta >= 0 ? s.delta : nullptr,
                             st.wdist >= 0 ? s.wdist : nullptr,
                             st.extra >= 0 ? s.extra : nullptr};
    bool aligned = (static_cast<size_t>(s.n_eles) * sizeof(T)) % 16 == 0;
    for (const void* p : staged) {
      aligned = aligned && reinterpret_cast<uintptr_t>(p) % 16 == 0;
    }
    s.bulk = aligned ? 1 : 0;
  }
  return tiles;
}

// Runs ``op.run<T, D, F, SGS>()``, the instantiation of (d, F, the SGS
// model), and returns its int: K1's launches add the inviscid switch
// (dispatch), K3's flux-point launches take it as it is.
template <typename T, int D, int F, class Op>
int by_sgs(int sgs, const Op& op) {
  switch (sgs) {
    case kSgsSmagorinsky:
      return op.template run<T, D, F, kSgsSmagorinsky>();
    case kSgsWale:
      return op.template run<T, D, F, kSgsWale>();
    default:
      return op.template run<T, D, F, kSgsNone>();
  }
}

template <typename T, class Op>
int dispatch_physics(int d, int f, int sgs, const Op& op) {
  if (d == 2) {
    return f == 5 ? by_sgs<T, 2, 5>(sgs, op) : by_sgs<T, 2, 4>(sgs, op);
  }
  return f == 6 ? by_sgs<T, 3, 6>(sgs, op) : by_sgs<T, 3, 5>(sgs, op);
}

template <class Op>
struct ByInv {
  bool inv;
  const Op& op;
  template <typename T, int D, int F, int SGS>
  int run() const {
    return inv ? op.template run<T, D, F, SGS, true>()
               : op.template run<T, D, F, SGS, false>();
  }
};

// Runs ``op.run<T, D, F, SGS, INV>()``, the instantiation of (d, F, the SGS
// model, the inviscid switch), and returns its int.
template <typename T, class Op>
int dispatch(int d, int f, int sgs, bool inv, const Op& op) {
  return dispatch_physics<T>(d, f, sgs, ByInv<Op>{inv, op});
}

}  // namespace hft

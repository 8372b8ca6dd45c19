// Volume stage of the FR residual on Hopper: per solution point, the 2-D
// or 3-D physical flux of the configuration, then the adjugate transform
//   tdisf[l][i] = sum_m adj(J)[l][m] * f_i,m .
//
// Replaces hifiles_tpu/solver/pallas_kernels.py::volume_tdisf_fm (body
// _volume_kernel), extended from its constant-viscosity 3-D Navier-Stokes
// flux to the volume stage of hifiles_tpu/solver/residual_soa.py:1094-1139
// at d = 2 and d = 3 (quads and tris; hexes and tets):
//   * the Euler flux, with the SA working variable advected (F = d + 3);
//   * the Navier-Stokes flux with constant or Sutherland viscosity, and for
//     F = d + 3 the SA eddy viscosity mu_t = nu~ f_v1, its conductivity
//     and the SA diffusion row (ref:src/flux.cpp:127-325);
//   * an eddy-viscosity SGS flux, Smagorinsky with wall limiting or WALE
//     (ref:src/eles.cpp:2470-2612; the deviatoric parts subtract a third
//     of the trace at d = 2 too, as the JAX sgs_flux_p does);
//   * an added physical flux (the similarity SGS flux), before the
//     transform;
//   * the inviscid part on or off: the over-integration path launches the
//     kernel at the cubature points with the inviscid part only and at the
//     solution points with the viscous part only.
// Layouts (elements minor, the port's state):
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
// What bounds it: memory.  Per point the viscous 3-D F = 5 case reads 5
// state + 15 gradient values (+ 9 geometry values unless broadcast) and
// writes 15, about 80 B in and 60 B out in f32, against 200-400 flops; one
// call at E=4096, U=125 moves about 72 MB.  At d = 2 (F = 4) a point reads
// 4 + 8 values (+ 4 geometry) and writes 8, 64 B in f32 with broadcast
// geometry.  So every physical flux stays in registers and is never
// written to device memory.  One thread per (solution point, element),
// element index fastest, so every plane load and store is coalesced.  The
// dimension, the field count, the SGS model and the inviscid switch are
// template parameters (they set the register count); viscosity,
// Sutherland's law and the added flux are flags uniform over the grid.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSgsNone = -1, kSgsSmagorinsky = 0, kSgsWale = 1;

}  // namespace

extern "C" {
// Shapes, strides and scalar parameters of one launch; mirrored by
// hifiles_tpu_torch/solver/volume.py::_Args.
struct HftVolumeArgs {
  int64_t n_upts, n_eles, n_fields, n_dims, jg_stride, delta_stride,
      wdist_stride;
  double gamma, prandtl, prandtl_t, mu_inf, rt_inf, c_sth, c_v1, omega, C_s,
      kappa;
  int32_t viscous, inviscid, sutherland, sgs;
};
}

namespace {

template <typename T>
struct Params {
  T gamma, prandtl, prandtl_t, mu_inf, rt_inf, c_sth, c_v1, omega, C_s, kappa;
  bool viscous, sutherland;
};

__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog1p(float x) { return log1pf(x); }
__device__ __forceinline__ double dlog1p(double x) { return log1p(x); }

// log(1 + exp(x)) in the form that cannot overflow (jax.nn.softplus)
template <typename T>
__device__ __forceinline__ T softplus(T x) {
  return (x > T(0) ? x : T(0)) + dlog1p(dexp(-(x < T(0) ? -x : x)));
}

template <typename T, int D, int F, int SGS, bool INV>
__global__ void __launch_bounds__(kThreads) volume_tdisf_kernel(
    const T* __restrict__ u, const T* __restrict__ grad,
    const T* __restrict__ jg, const T* __restrict__ delta,
    const T* __restrict__ wdist, const T* __restrict__ extra,
    T* __restrict__ out, int64_t n_upts, int64_t n_eles, int64_t jg_stride,
    int64_t delta_stride, int64_t wdist_stride, Params<T> prm) {
  static_assert(D == 2 || D == 3, "2-D or 3-D");
  static_assert(F == D + 2 || F == D + 3, "NS fields, or NS + SA");
  constexpr bool kSA = F == D + 3;  // the SA working variable is field F-1
  constexpr int kE = D + 1;         // total energy
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= n_upts * n_eles) return;
  const int64_t upt = idx / n_eles;
  const int64_t e = idx - upt * n_eles;

  // u (U, F, E): field i of point (upt, e) sits at (upt*F + i)*E + e
  const T* up = u + upt * F * n_eles + e;
  T q[F];
#pragma unroll
  for (int i = 0; i < F; ++i) q[i] = up[i * n_eles];
  const T rho = q[0];
  const T inv_rho = T(1) / rho;
  T v[D];
  T q2 = T(0);
#pragma unroll
  for (int m = 0; m < D; ++m) {
    v[m] = q[1 + m] * inv_rho;
    q2 += v[m] * v[m];
  }

  // f[i][dd]: flux of field i along dimension dd
  T f[F][D];
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
    // grad (d, U, F, E): dimension dd of field i at ((dd*U + upt)*F + i)*E + e
    const int64_t dim_stride = n_upts * F * n_eles;
    const T* gp = grad + upt * F * n_eles + e;
    T g[F][D];
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
#pragma unroll
      for (int i = 0; i < F; ++i) g[i][dd] = gp[dd * dim_stride + i * n_eles];
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
      const int64_t ds = delta_stride ? n_eles : 1;
      const int64_t ws = wdist_stride ? n_eles : 1;
      const T dl = delta[upt * ds + e * delta_stride];
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
        const T wd = wdist[upt * ws + e * wdist_stride];
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

  const int64_t out_dim = n_upts * F * n_eles;
  if (extra != nullptr) {
    const T* xp = extra + upt * F * n_eles + e;
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
#pragma unroll
      for (int i = 0; i < F; ++i) f[i][dd] += xp[dd * out_dim + i * n_eles];
    }
  }

  // jg (d, d, U, E'): adj(J)[l][mm] at ((l*d + mm)*U + upt)*E' + e*stride
  const int64_t jg_upt_stride = jg_stride ? n_eles : 1;
  const T* jp = jg + upt * jg_upt_stride + e * jg_stride;
  const int64_t jg_plane = n_upts * jg_upt_stride;
  T* op = out + upt * F * n_eles + e;
#pragma unroll
  for (int l = 0; l < D; ++l) {
    T a[D];
#pragma unroll
    for (int mm = 0; mm < D; ++mm) a[mm] = jp[(l * D + mm) * jg_plane];
#pragma unroll
    for (int i = 0; i < F; ++i) {
      T acc = a[0] * f[i][0];
#pragma unroll
      for (int mm = 1; mm < D; ++mm) acc += a[mm] * f[i][mm];
      op[l * out_dim + i * n_eles] = acc;
    }
  }
}

struct Ptrs {
  const void *u, *grad, *jg, *delta, *wdist, *extra;
  void* out;
};

template <typename T, int D, int F, int SGS, bool INV>
void launch_one(const Ptrs& p, const HftVolumeArgs& a, const Params<T>& prm,
                cudaStream_t stream) {
  const int64_t n = a.n_upts * a.n_eles;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  volume_tdisf_kernel<T, D, F, SGS, INV>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
          static_cast<const T*>(p.u), static_cast<const T*>(p.grad),
          static_cast<const T*>(p.jg), static_cast<const T*>(p.delta),
          static_cast<const T*>(p.wdist), static_cast<const T*>(p.extra),
          static_cast<T*>(p.out), a.n_upts, a.n_eles, a.jg_stride,
          a.delta_stride, a.wdist_stride, prm);
}

template <typename T, int D, int F, int SGS>
void launch_inv(const Ptrs& p, const HftVolumeArgs& a, const Params<T>& prm,
                cudaStream_t s) {
  if (a.inviscid) {
    launch_one<T, D, F, SGS, true>(p, a, prm, s);
  } else {
    launch_one<T, D, F, SGS, false>(p, a, prm, s);
  }
}

template <typename T, int D, int F>
void launch_sgs(const Ptrs& p, const HftVolumeArgs& a, const Params<T>& prm,
                cudaStream_t s) {
  switch (a.sgs) {
    case kSgsSmagorinsky:
      launch_inv<T, D, F, kSgsSmagorinsky>(p, a, prm, s);
      break;
    case kSgsWale:
      launch_inv<T, D, F, kSgsWale>(p, a, prm, s);
      break;
    default:
      launch_inv<T, D, F, kSgsNone>(p, a, prm, s);
  }
}

template <typename T, int D>
void launch_fields(const Ptrs& p, const HftVolumeArgs& a,
                   const Params<T>& prm, cudaStream_t s) {
  if (a.n_fields == D + 3) {
    launch_sgs<T, D, D + 3>(p, a, prm, s);
  } else {
    launch_sgs<T, D, D + 2>(p, a, prm, s);
  }
}

template <typename T>
int launch(const Ptrs& p, const HftVolumeArgs* a, int device, void* stream) {
  if (a->n_dims != 2 && a->n_dims != 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->n_fields != a->n_dims + 2 && a->n_fields != a->n_dims + 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a->sgs < kSgsNone || a->sgs > kSgsWale) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own CUDA runtime: select the tensors' device
  // in it (the primary context PyTorch uses too)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  Params<T> prm;
  prm.gamma = static_cast<T>(a->gamma);
  prm.prandtl = static_cast<T>(a->prandtl);
  prm.prandtl_t = static_cast<T>(a->prandtl_t);
  prm.mu_inf = static_cast<T>(a->mu_inf);
  prm.rt_inf = static_cast<T>(a->rt_inf);
  prm.c_sth = static_cast<T>(a->c_sth);
  prm.c_v1 = static_cast<T>(a->c_v1);
  prm.omega = static_cast<T>(a->omega);
  prm.C_s = static_cast<T>(a->C_s);
  prm.kappa = static_cast<T>(a->kappa);
  prm.viscous = a->viscous != 0;
  prm.sutherland = a->sutherland != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->n_dims == 2) {
    launch_fields<T, 2>(p, *a, prm, s);
  } else {
    launch_fields<T, 3>(p, *a, prm, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int hft_volume_tdisf_f32(const void* u, const void* grad, const void* jg,
                         const void* delta, const void* wdist,
                         const void* extra, void* out,
                         const HftVolumeArgs* args, int device, void* stream) {
  return launch<float>(Ptrs{u, grad, jg, delta, wdist, extra, out}, args,
                       device, stream);
}

int hft_volume_tdisf_f64(const void* u, const void* grad, const void* jg,
                         const void* delta, const void* wdist,
                         const void* extra, void* out,
                         const HftVolumeArgs* args, int device, void* stream) {
  return launch<double>(Ptrs{u, grad, jg, delta, wdist, extra, out}, args,
                        device, stream);
}

}  // extern "C"

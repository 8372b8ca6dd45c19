// Volume stage of the FR residual on Hopper: per solution point, the 3-D
// Euler flux plus the constant-viscosity Navier-Stokes flux (stress tau,
// heat flux kappa * grad(e)), then the adjugate transform
//   tdisf[l][i] = sum_m adj(J)[l][m] * f_i,m .
//
// Replaces hifiles_tpu/solver/pallas_kernels.py::volume_tdisf_fm (body
// _volume_kernel), on the port's elements-minor layout:
//   u     (U, F, E)        conserved state, F = 5
//   grad  (d, U, F, E)     physical gradient (read only when viscous)
//   jg    (d, d, U, E')    adj(J)[l][m]; E' = E (jg_ele_stride 1) or
//                          E' = 1 (jg_ele_stride 0: one column broadcast
//                          over the elements of a uniform mesh)
//   out   (d, U, F, E)     transformed flux
//
// What bounds it: memory.  Per point it reads 5 state + 15 gradient + up to
// 9 geometry values and writes 15, about 116 B in and 60 B out in f32,
// against about 200 flops; one call at E=4096, U=125 moves about 90 MB.
// So the design keeps every physical flux in registers and never writes it
// to device memory: the fluxes exist only between the loads and the
// adjugate contraction.  One thread per (solution point, element), element
// index fastest, so every plane load and store is coalesced.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kDims = 3;
constexpr int kFields = 5;
constexpr int kThreads = 256;

template <typename T>
__global__ void volume_tdisf_kernel(const T* __restrict__ u,
                                    const T* __restrict__ grad,
                                    const T* __restrict__ jg,
                                    T* __restrict__ out, int64_t n_upts,
                                    int64_t n_eles, int64_t jg_ele_stride,
                                    T gamma, T mu, T prandtl, bool viscous) {
  const int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                      threadIdx.x;
  if (idx >= n_upts * n_eles) return;
  const int64_t upt = idx / n_eles;
  const int64_t e = idx - upt * n_eles;

  // u (U, F, E): field i of point (upt, e) sits at (upt*F + i)*E + e
  const T* up = u + upt * kFields * n_eles + e;
  const T rho = up[0];
  const T m[kDims] = {up[n_eles], up[2 * n_eles], up[3 * n_eles]};
  const T en = up[4 * n_eles];
  const T inv_rho = T(1) / rho;
  const T v[kDims] = {m[0] * inv_rho, m[1] * inv_rho, m[2] * inv_rho};
  const T q2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const T p = (gamma - T(1)) * (en - T(0.5) * rho * q2);
  const T hp = en + p;

  // f[i][dd]: flux of field i along dimension dd
  T f[kFields][kDims];
#pragma unroll
  for (int dd = 0; dd < kDims; ++dd) {
    f[0][dd] = m[dd];
#pragma unroll
    for (int i = 0; i < kDims; ++i) f[1 + i][dd] = m[i] * v[dd];
    f[4][dd] = hp * v[dd];
  }
  f[1][0] += p;
  f[2][1] += p;
  f[3][2] += p;

  if (viscous) {
    // grad (d, U, F, E): dimension dd of field i at ((dd*U + upt)*F + i)*E + e
    const int64_t dim_stride = n_upts * kFields * n_eles;
    const T* gp = grad + upt * kFields * n_eles + e;
    T g[kFields][kDims];
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
#pragma unroll
      for (int i = 0; i < kFields; ++i) {
        g[i][dd] = gp[dd * dim_stride + i * n_eles];
      }
    }
    T dv[kDims][kDims];  // dv[i][dd] = d v_i / d x_dd
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) {
        dv[i][dd] = (g[1 + i][dd] - v[i] * g[0][dd]) * inv_rho;
      }
    }
    const T inte = en * inv_rho - T(0.5) * q2;
    T dint[kDims];
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
      dint[dd] = (g[4][dd] - (T(0.5) * q2 + inte) * g[0][dd]) * inv_rho -
                 (v[0] * dv[0][dd] + v[1] * dv[1][dd] + v[2] * dv[2][dd]);
    }
    const T div = dv[0][0] + dv[1][1] + dv[2][2];
    const T lam = T(-2.0 / 3.0) * mu;
    const T kth = mu * gamma / prandtl;
    T tau[kDims][kDims];
#pragma unroll
    for (int i = 0; i < kDims; ++i) {
#pragma unroll
      for (int dd = 0; dd < kDims; ++dd) tau[i][dd] = mu * (dv[i][dd] + dv[dd][i]);
      tau[i][i] += lam * div;
    }
#pragma unroll
    for (int dd = 0; dd < kDims; ++dd) {
#pragma unroll
      for (int i = 0; i < kDims; ++i) f[1 + i][dd] -= tau[i][dd];
      f[4][dd] -= v[0] * tau[0][dd] + v[1] * tau[1][dd] + v[2] * tau[2][dd] +
                  kth * dint[dd];
    }
  }

  // jg (d, d, U, E'): adj(J)[l][mm] at ((l*d + mm)*U + upt)*E' + e*stride
  const int64_t jg_upt_stride = jg_ele_stride ? n_eles : 1;
  const T* jp = jg + upt * jg_upt_stride + e * jg_ele_stride;
  const int64_t jg_plane = n_upts * jg_upt_stride;
  const int64_t out_dim = n_upts * kFields * n_eles;
  T* op = out + upt * kFields * n_eles + e;
#pragma unroll
  for (int l = 0; l < kDims; ++l) {
    const T a0 = jp[(l * kDims + 0) * jg_plane];
    const T a1 = jp[(l * kDims + 1) * jg_plane];
    const T a2 = jp[(l * kDims + 2) * jg_plane];
#pragma unroll
    for (int i = 0; i < kFields; ++i) {
      op[l * out_dim + i * n_eles] = a0 * f[i][0] + a1 * f[i][1] + a2 * f[i][2];
    }
  }
}

template <typename T>
int launch(const void* u, const void* grad, const void* jg, void* out,
           int64_t n_upts, int64_t n_eles, int64_t jg_ele_stride,
           double gamma, double mu, double prandtl, int viscous, int device,
           void* stream) {
  // this library carries its own CUDA runtime: select the tensors' device
  // in it (the primary context PyTorch uses too)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int64_t n = n_upts * n_eles;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  volume_tdisf_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(u), static_cast<const T*>(grad),
      static_cast<const T*>(jg), static_cast<T*>(out), n_upts, n_eles,
      jg_ele_stride, static_cast<T>(gamma), static_cast<T>(mu),
      static_cast<T>(prandtl), viscous != 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int hft_volume_tdisf_f32(const void* u, const void* grad, const void* jg,
                         void* out, int64_t n_upts, int64_t n_eles,
                         int64_t jg_ele_stride, double gamma, double mu,
                         double prandtl, int viscous, int device,
                         void* stream) {
  return launch<float>(u, grad, jg, out, n_upts, n_eles, jg_ele_stride, gamma,
                       mu, prandtl, viscous, device, stream);
}

int hft_volume_tdisf_f64(const void* u, const void* grad, const void* jg,
                         void* out, int64_t n_upts, int64_t n_eles,
                         int64_t jg_ele_stride, double gamma, double mu,
                         double prandtl, int viscous, int device,
                         void* stream) {
  return launch<double>(u, grad, jg, out, n_upts, n_eles, jg_ele_stride,
                        gamma, mu, prandtl, viscous, device, stream);
}

}  // extern "C"

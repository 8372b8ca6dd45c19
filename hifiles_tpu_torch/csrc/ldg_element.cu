// K3 on Hopper: the element side of the LDG gradient path of the FR
// residual, two kernels (ldg_point.cuh has the per-point arithmetic and
// the layouts).
//   * ldg_fpts_kernel, at the flux points of one block: the physical
//     gradient from the transformed one the opp_0 GEMM extrapolated there,
//     the viscous (+ SGS, + added) flux, and its projection qn on the
//     outward normal, which the LDG common flux takes; the gradient itself
//     only where the block has boundary faces;
//   * ldg_upts_kernel, at the solution points of one block: the physical
//     gradient from the transformed one, its face lift already added by
//     the lift GEMM, in the layout the volume kernel reads.
//
// It replaces no TPU kernel: the JAX package's element side is jnp that
// XLA fuses (hifiles_tpu/solver/residual_soa.py:1079-1085, :1153-1182).
// In plain PyTorch the same algebra is ~250 operations a stage, each
// streaming whole planes through device memory.
//
// What bounds it on the H100: bytes.  At a 3-D F = 5 flux point it reads
// 15 gradient and 5 state values and writes 5 (25 more with boundary
// faces), against ~300 flops; at a solution point it reads and writes 15.
// What the design does about it: one thread a point, each input read once
// and each output written once, coalesced along the slots or elements; the
// physical gradient and the flux stay in registers; a geometry plane at
// element stride 0 (a uniform mesh) is one column of Pf or U values, read
// from cache, so it costs no bytes.
// The dimension, the field count and the SGS model are template parameters
// (they set the register count); Sutherland's law and the added flux are
// flags uniform over the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "ldg_point.cuh"

namespace {

using hft::Params;

constexpr int kThreads = 256;

template <typename T, int D, int F, int SGS>
__global__ void __launch_bounds__(kThreads)
    ldg_fpts_kernel(const __grid_constant__ HftFptsArgs a,
                    const __grid_constant__ Params<T> prm, int n) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s < n) hft::fpts_slot<T, D, F, SGS>(a, prm, s);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    ldg_upts_kernel(const __grid_constant__ HftUptsArgs a, int n) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n) hft::upts_point<T, D>(a, p);
}

template <typename T>
struct FptsLaunch {
  const HftFptsArgs* a;
  Params<T> prm;
  int n;
  cudaStream_t stream;
  template <typename, int D, int F, int SGS>
  int run() const {
    ldg_fpts_kernel<T, D, F, SGS>
        <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(*a, prm, n);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int launch_fpts(const HftFptsArgs* a, const HftVolumeArgs* phys, int device,
                void* stream) {
  if (hft::fpts_refused(*a, *phys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own CUDA runtime: select the tensors' device
  // in it (the primary context PyTorch uses too)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int n = hft::launch_points(a->n_eles, a->n_fpts);
  if (n == 0) return 0;
  return hft::dispatch_physics<T>(
      phys->n_dims, phys->n_fields, phys->sgs,
      FptsLaunch<T>{a, hft::params_of<T>(*phys), n,
                    static_cast<cudaStream_t>(stream)});
}

template <typename T>
int launch_upts(const HftUptsArgs* a, int device, void* stream) {
  if (hft::upts_refused(*a)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int n = hft::launch_points(a->n_upts, a->n_eles);
  if (n == 0) return 0;
  const int grid = (n + kThreads - 1) / kThreads;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a->n_dims == 2) {
    ldg_upts_kernel<T, 2><<<grid, kThreads, 0, s>>>(*a, n);
  } else {
    ldg_upts_kernel<T, 3><<<grid, kThreads, 0, s>>>(*a, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K3 at the flux points of one block, on ``stream`` of card ``device``.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int hft_ldg_fpts_f32(const HftFptsArgs* a, const HftVolumeArgs* phys,
                     int device, void* stream) {
  return launch_fpts<float>(a, phys, device, stream);
}

int hft_ldg_fpts_f64(const HftFptsArgs* a, const HftVolumeArgs* phys,
                     int device, void* stream) {
  return launch_fpts<double>(a, phys, device, stream);
}

// K3 at the solution points of one block.
int hft_ldg_upts_f32(const HftUptsArgs* a, int device, void* stream) {
  return launch_upts<float>(a, device, stream);
}

int hft_ldg_upts_f64(const HftUptsArgs* a, int device, void* stream) {
  return launch_upts<double>(a, device, stream);
}

}  // extern "C"

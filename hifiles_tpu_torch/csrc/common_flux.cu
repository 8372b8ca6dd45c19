// K4 on Hopper: the interior common flux of the FR residual in one launch
// a stage and card (face_point.cuh has the per-point arithmetic, the
// tiling and the layouts).  At every point of every interior face it
// computes the Riemann flux (Rusanov, RoeM, HLLC, or Lax-Friedrichs for
// advection-diffusion), adds the LDG common viscous flux from the two
// sides' normal viscous fluxes qn and writes fn to the l side's flux-point
// slot and -fn to the r side's.
//
// It replaces no TPU kernel: the JAX package's common flux is jnp that XLA
// fuses (hifiles_tpu/solver/residual_soa.py:1185-1190 and the Riemann
// calls before it).  In plain PyTorch the same work is ~255 elementwise
// operations a stage, each streaming whole face planes through device
// memory, and the write-back three more.
//
// What bounds it on the H100: bytes.  A viscous 3-D point reads 5 + 5
// states, 5 + 5 qn and 3 normals and writes 5 + 5 flux values (33 values,
// 132 B in f32; the two slots, 16 B more), against ~150 flops.  What the
// design does about it: each value is read once and written once, the
// flux stays in registers.  A block takes a tile of rows x cols points of
// the (rows, faces) planes: it reads them row by row, neighbouring threads
// on neighbouring faces (coalesced), computes each point, stages fn and
// the slots in shared memory, and writes them face by face, neighbouring
// threads on a face's neighbouring slots (the points of one face side are
// one run of an element's flux-point row).  A thread a point in plane
// order (the naive mapping) writes every value to another face's run
// instead: 9x slower on the TGV's faces.  Flat
// planes (a mixed mesh, one row) are already in face order, and take the
// thread a point mapping.  A normal at one column is read from cache, so
// it costs no bytes.  512 threads a block (256: 10% slower at the cells'
// shapes, 128: 20%).
// The dimension, the field count, the solver and the viscous switch are
// template parameters (they set the register count and the loads).
#include <cuda_runtime.h>

#include <cstdint>

#include "face_point.cuh"

namespace {

using hft::FacePrm;
using hft::FaceTile;

constexpr int kThreads = 512;

extern __shared__ __align__(16) unsigned char face_stage[];

template <typename T, int D, int F, int SOLVER, bool VISC>
__global__ void __launch_bounds__(kThreads)
    common_flux_kernel(const __grid_constant__ HftFaceArgs a,
                       const __grid_constant__ FacePrm<T> prm,
                       const FaceTile t) {
  T* s_f = reinterpret_cast<T*>(face_stage);
  int32_t* s_sl = reinterpret_cast<int32_t*>(s_f + F * t.rows * t.pitch());
  int32_t* s_sr = s_sl + t.rows * t.pitch();
  const int n = t.points();
  for (int j = threadIdx.x; j < n; j += kThreads) {
    hft::tile_compute<T, D, F, SOLVER, VISC>(a, prm, t, blockIdx.x,
                                             blockIdx.y, j, s_f, s_sl, s_sr);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n; k += kThreads) {
    hft::tile_store<T, F>(a, t, blockIdx.x, blockIdx.y, k, s_f, s_sl, s_sr);
  }
}

template <typename T, int D, int F, int SOLVER, bool VISC>
__global__ void __launch_bounds__(kThreads)
    common_flux_naive_kernel(const __grid_constant__ HftFaceArgs a,
                             const __grid_constant__ FacePrm<T> prm, int n) {
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p < n) hft::naive_point<T, D, F, SOLVER, VISC>(a, prm, p);
}

template <typename T>
struct Launch {
  const HftFaceArgs* a;
  FacePrm<T> prm;
  cudaStream_t stream;
  template <typename, int D, int F, int SOLVER, bool VISC>
  int run() const {
    const int n = a->n_rows * a->n_cols;
    if (a->n_rows == 1) {
      common_flux_naive_kernel<T, D, F, SOLVER, VISC>
          <<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(*a, prm,
                                                                   n);
    } else {
      const FaceTile t = hft::face_tile<T>(a->n_rows);
      const dim3 grid((a->n_cols + t.cols - 1) / t.cols,
                      (a->n_rows + t.rows - 1) / t.rows);
      common_flux_kernel<T, D, F, SOLVER, VISC>
          <<<grid, kThreads, hft::face_stage_bytes<T, F>(t), stream>>>(
              *a, prm, t);
    }
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T>
int launch(const HftFaceArgs* a, const HftFacePhysics* phys, int device,
           void* stream) {
  if (hft::face_refused(*a, *phys)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (static_cast<long long>(a->n_rows) * a->n_cols == 0) return 0;
  const FaceTile t = hft::face_tile<T>(a->n_rows);
  if ((a->n_rows + t.rows - 1) / t.rows > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // this library carries its own CUDA runtime: select the tensors' device
  // in it (the primary context PyTorch uses too)
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  return hft::dispatch_face<T>(
      *phys, Launch<T>{a, hft::face_prm_of<T>(*phys),
                       static_cast<cudaStream_t>(stream)});
}

}  // namespace

extern "C" {

// K4 over one launch's face planes, on ``stream`` of card ``device``.
// Returns cudaGetLastError() after the launch (0 = cudaSuccess).
int hft_common_flux_f32(const HftFaceArgs* a, const HftFacePhysics* phys,
                        int device, void* stream) {
  return launch<float>(a, phys, device, stream);
}

int hft_common_flux_f64(const HftFaceArgs* a, const HftFacePhysics* phys,
                        int device, void* stream) {
  return launch<double>(a, phys, device, stream);
}

}  // extern "C"

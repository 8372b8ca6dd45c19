// Volume stage of the FR residual on Hopper: the transformed flux at
// every solution point of every segment of a launch (volume_point.cuh has
// the per-point arithmetic, the layouts and the tiling).
//
// Replaces hifiles_tpu/solver/pallas_kernels.py::volume_tdisf_fm (body
// _volume_kernel), extended from its constant-viscosity 3-D Navier-Stokes
// flux to the volume stage of hifiles_tpu/solver/residual_soa.py:1094-1139
// at d = 2 and d = 3 (quads, tris, hexes, tets, prisms).
//
// What bounds it on the H100: bytes.  Per point the viscous 3-D F = 5 case
// reads 5 state + 15 gradient values (+ 9 geometry values unless
// broadcast) and writes 15, about 80 B in and 60 B out in f32, against
// 200-400 flops; one block at E=4096, U=125 moves about 72 MB.  The
// physical flux stays in registers and is never written to device memory.
//
// What the design does about it:
//   * one grouped launch: a table of up to kMaxSegments segments (one
//     element block of one shard each, its own pointers, U, E and element
//     strides) passed by value as a __grid_constant__ parameter, so the
//     blocks and shards of a stage on one card share one launch and none
//     sits alone at the launch floor; no device allocation, so it is safe
//     inside a CUDA graph;
//   * tiles staged in shared memory by asynchronous copies: a tile is one
//     solution point times 128 elements (TileShape), a CTA 128 threads;
//     each of its input planes is one contiguous run, copied by a 1-D TMA
//     bulk copy where its start and length are multiples of 16 bytes (the
//     segment's ``bulk``; warp 0 issues them, a plane a lane), else by
//     cp.async of one element a thread, both completing on the stage's
//     mbarrier.  A grid of the CTAs that fit on the card walks the tiles
//     through a two-stage ring: tile k+1's copies are in flight while tile
//     k computes, so the bytes in flight do not depend on a variant's
//     registers.  Planes at element stride 0 are read once per tile from
//     their column;
//   * 32-bit tile arithmetic (one division per tile, none per thread);
//     outputs stored from registers, coalesced along the elements.
// Measured on the H100 against the one-launch-per-block kernel it replaces
// (PERF.md): even at full width, and ahead inside the stage where the
// grouped launch replaces several small ones; behind on the small blocks
// alone when their inputs stay in L2 between back-to-back launches.
// The dimension, the field count, the SGS model and the inviscid switch
// are template parameters (they set the register count); viscosity,
// Sutherland's law and the added flux are flags uniform over the launch.
#include <cuda_runtime.h>

#include <cstdint>

#include "volume_point.cuh"

namespace {

using hft::kMaxSegments;
using hft::kSgsNone;
using hft::kSgsWale;
using hft::MaxPlanes;
using hft::Params;
using hft::StageSlots;
using hft::TileLoc;
using hft::TileShape;

constexpr int kMaxDevices = 64;

template <typename T>
struct Table {
  HftVolumeSegment seg[kMaxSegments];
  int32_t n_seg, n_tiles, stage_elems;  // stage_elems: planes * kElems
  Params<T> prm;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of parity ``parity`` to complete.  A stage that
// never completes is a fault: trap (the launch then fails) rather than
// hang the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t spins = 0;
  do {
    if (++spins == (1u << 30)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// 1-D TMA bulk copy global -> shared, completing on ``bar``
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// one element global -> shared; completion tracked by cp_async_arrive
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                     smem_addr(dst)),
                 "l"(src)
                 : "memory");
  }
}

// this thread's arrival on ``bar`` once its cp.async copies have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Stage tile ``tile``'s planes into ``stage``; every thread arrives once
// on ``bar`` (the mbarrier counts kElems arrivals and, for bulk
// copies, their bytes).
template <typename T, int D, int F, int SGS>
__device__ __forceinline__ void issue(const Table<T>& tab, int tile,
                                      T* stage, uint64_t* bar) {
  constexpr int TE = TileShape<T>::kElems;
  const TileLoc loc = hft::tile_location(tab.seg, tab.n_seg, tile, TE);
  const HftVolumeSegment& s = tab.seg[loc.seg];
  const StageSlots st =
      hft::stage_slots<D, F, SGS>(s, tab.prm.viscous, tab.prm.has_extra);
  const int j = threadIdx.x;
  if (s.bulk) {
    if (j < 32) {
      // warp 0 issues the bulk copies, a plane a lane, once lane 0 has set
      // their bytes; earlier generic-proxy accesses of the stage are
      // ordered before the async proxy's writes
      const uint32_t bytes = static_cast<uint32_t>(loc.n * sizeof(T));
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      if (j == 0) mbar_arrive_expect_tx(bar, bytes * st.n);
      __syncwarp();
      for (int slot = j; slot < st.n; slot += 32) {
        bulk_copy(stage + slot * TE,
                  hft::plane_run<T, D, F>(s, st, loc.upt, loc.e0, slot), bytes,
                  bar);
      }
      if (j != 0) mbar_arrive(bar);
    } else {
      mbar_arrive(bar);
    }
  } else {
    if (j < loc.n) {
      for (int slot = 0; slot < st.n; ++slot) {
        cp_async(stage + slot * TE + j,
                 hft::plane_run<T, D, F>(s, st, loc.upt, loc.e0, slot) + j);
      }
    }
    cp_async_arrive(bar);
  }
}

template <typename T, int D, int F, int SGS, bool INV>
__global__ void __launch_bounds__(TileShape<T>::kElems, 2)
    volume_tdisf_kernel(const __grid_constant__ Table<T> tab) {
  constexpr int TE = TileShape<T>::kElems;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  T* const stages = reinterpret_cast<T*>(smem);
  const int j = threadIdx.x;
  if (j == 0) {
    mbar_init(&bar[0], TE);
    mbar_init(&bar[1], TE);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int tile = blockIdx.x;
  if (tile < tab.n_tiles) {
    issue<T, D, F, SGS>(tab, tile, stages, &bar[0]);
  }
  for (int k = 0; tile < tab.n_tiles; tile += gridDim.x, ++k) {
    const int b = k & 1;
    const int next = tile + gridDim.x;
    if (next < tab.n_tiles) {
      issue<T, D, F, SGS>(tab, next, stages + (b ^ 1) * tab.stage_elems,
                          &bar[b ^ 1]);
    }
    mbar_wait(&bar[b], (k >> 1) & 1);
    const TileLoc loc = hft::tile_location(tab.seg, tab.n_seg, tile, TE);
    if (j < loc.n) {
      const HftVolumeSegment* s = &tab.seg[loc.seg];
      const hft::StagedPoint<T, D, F> in{
          stages + b * tab.stage_elems, s,
          hft::stage_slots<D, F, SGS>(*s, tab.prm.viscous,
                                      tab.prm.has_extra),
          loc.upt, j};
      const size_t E = static_cast<size_t>(s->n_eles);
      const hft::PointOut<T, F> out{
          static_cast<T*>(s->out) + static_cast<size_t>(loc.upt) * F * E +
              loc.e0 + j,
          static_cast<size_t>(s->n_upts) * F * E, E};
      hft::point_tdisf<T, D, F, SGS, INV>(in, tab.prm, out);
    }
    // every thread is done with stage b before it is staged again
    __syncthreads();
  }
}

// per instantiation: CTAs resident on one SM for each stage size in
// planes, set by prepare
template <typename T, int D, int F, int SGS, bool INV>
struct Occupancy {
  static int per_sm[MaxPlanes<D, F>::value + 1];
};
template <typename T, int D, int F, int SGS, bool INV>
int Occupancy<T, D, F, SGS, INV>::per_sm[MaxPlanes<D, F>::value + 1];

int g_sms[kMaxDevices];

template <typename T, int D, int F, int SGS, bool INV>
size_t smem_bytes(int planes) {
  return 2 * static_cast<size_t>(planes) * TileShape<T>::kElems * sizeof(T);
}

template <typename T, int D, int F, int SGS, bool INV>
cudaError_t prepare_one() {
  auto* kern = volume_tdisf_kernel<T, D, F, SGS, INV>;
  constexpr int kMax = MaxPlanes<D, F>::value;
  cudaError_t rc = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<T, D, F, SGS, INV>(kMax)));
  for (int planes = 1; rc == cudaSuccess && planes <= kMax; ++planes) {
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &Occupancy<T, D, F, SGS, INV>::per_sm[planes], kern,
        TileShape<T>::kElems, smem_bytes<T, D, F, SGS, INV>(planes));
  }
  return rc;
}

template <typename T, int D, int F, int SGS, bool INV>
cudaError_t launch_one(Table<T>& tab, int device, cudaStream_t stream) {
  tab.n_tiles = hft::fill_table<T, D, F, SGS>(
      tab.seg, tab.n_seg, tab.prm.viscous, tab.prm.has_extra);
  int planes = 0;
  for (int k = 0; k < tab.n_seg; ++k) {
    const int n = hft::stage_slots<D, F, SGS>(tab.seg[k], tab.prm.viscous,
                                              tab.prm.has_extra)
                      .n;
    planes = n > planes ? n : planes;
  }
  tab.stage_elems = planes * TileShape<T>::kElems;
  const int per_sm = Occupancy<T, D, F, SGS, INV>::per_sm[planes];
  if (per_sm < 1 || g_sms[device] < 1) return cudaErrorInvalidConfiguration;
  const int fill = per_sm * g_sms[device];
  const int grid = tab.n_tiles < fill ? tab.n_tiles : fill;
  if (grid < 1) return cudaSuccess;
  volume_tdisf_kernel<T, D, F, SGS, INV>
      <<<grid, TileShape<T>::kElems, smem_bytes<T, D, F, SGS, INV>(planes),
         stream>>>(tab);
  return cudaGetLastError();
}

struct Prepare {
  template <typename T, int D, int F, int SGS, bool INV>
  int run() const {
    return static_cast<int>(prepare_one<T, D, F, SGS, INV>());
  }
};

template <typename T>
struct Launch {
  Table<T>* tab;
  int device;
  cudaStream_t stream;
  template <typename, int D, int F, int SGS, bool INV>
  int run() const {
    return static_cast<int>(
        launch_one<T, D, F, SGS, INV>(*tab, device, stream));
  }
};

template <typename T>
cudaError_t prepare_dtype() {
  for (int d = 2; d <= 3; ++d) {
    for (int f = d + 2; f <= d + 3; ++f) {
      for (int sgs = kSgsNone; sgs <= kSgsWale; ++sgs) {
        for (int inv = 0; inv <= 1; ++inv) {
          const int rc = hft::dispatch<T>(d, f, sgs, inv != 0, Prepare{});
          if (rc != 0) return static_cast<cudaError_t>(rc);
        }
      }
    }
  }
  return cudaSuccess;
}

template <typename T>
int launch(const HftVolumeSegment* segs, int n_seg, const HftVolumeArgs* a,
           int device, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || device < 0 ||
      device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  Table<T> tab = {};
  for (int k = 0; k < n_seg; ++k) tab.seg[k] = segs[k];
  tab.n_seg = n_seg;
  tab.prm = hft::params_of<T>(*a);
  return hft::dispatch<T>(
      a->n_dims, a->n_fields, a->viscous ? a->sgs : kSgsNone,
      a->inviscid != 0,
      Launch<T>{&tab, device, static_cast<cudaStream_t>(stream)});
}

}  // namespace

extern "C" {

// Sets every instantiation's shared-memory limit and records its
// occupancy on ``device``: once per device, before its first launch and
// outside any graph capture.  Returns a cudaError_t (0 = cudaSuccess).
int hft_volume_prepare(int device) {
  if (device < 0 || device >= kMaxDevices) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t rc = cudaSetDevice(device);
  if (rc == cudaSuccess) {
    rc = cudaDeviceGetAttribute(&g_sms[device],
                                cudaDevAttrMultiProcessorCount, device);
  }
  if (rc == cudaSuccess) rc = prepare_dtype<float>();
  if (rc == cudaSuccess) rc = prepare_dtype<double>();
  return static_cast<int>(rc);
}

// One launch over ``n_seg`` segments (1..16) sharing ``args``.  Returns
// cudaGetLastError() after the launch (0 = cudaSuccess).
int hft_volume_tdisf_f32(const HftVolumeSegment* segs, int n_seg,
                         const HftVolumeArgs* args, int device,
                         void* stream) {
  return launch<float>(segs, n_seg, args, device, stream);
}

int hft_volume_tdisf_f64(const HftVolumeSegment* segs, int n_seg,
                         const HftVolumeArgs* args, int device,
                         void* stream) {
  return launch<double>(segs, n_seg, args, device, stream);
}

// The multi-card step's halo copies (parallel/cards.py), not a kernel.
//
// Whether card ``device`` can read card ``peer``'s memory directly; when
// it can, enables that access in ``device``'s primary context (an access
// already enabled counts as enabled).  Returns 1 when enabled, 0 when the
// pair has no peer access, or -(cudaError_t) on an error.
int hft_peer_enable(int device, int peer) {
  int can = 0;
  cudaError_t rc = cudaDeviceCanAccessPeer(&can, device, peer);
  if (rc != cudaSuccess) return -static_cast<int>(rc);
  if (!can) return 0;
  rc = cudaSetDevice(device);
  if (rc == cudaSuccess) rc = cudaDeviceEnablePeerAccess(peer, 0);
  if (rc == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();
    rc = cudaSuccess;
  }
  return rc == cudaSuccess ? 1 : -static_cast<int>(rc);
}

// ``bytes`` from ``src`` on another card to ``dst`` on card
// ``dst_device``, issued on ``stream``, a stream of ``dst_device``: a
// copy between the cards' unified addresses (cudaMemcpyDefault), over
// NVLink once hft_peer_enable has enabled the pair.  (cudaMemcpyPeerAsync
// cannot be captured.)  Returns a cudaError_t (0 = cudaSuccess).
int hft_peer_copy(void* dst, int dst_device, const void* src, size_t bytes,
                  void* stream) {
  cudaError_t rc = cudaSetDevice(dst_device);
  if (rc == cudaSuccess) {
    rc = cudaMemcpyAsync(dst, src, bytes, cudaMemcpyDefault,
                         static_cast<cudaStream_t>(stream));
  }
  return static_cast<int>(rc);
}

// The node count of the graph that ``stream`` is capturing, for the
// program's tracing (tracing.capture), not a kernel: -1 when the stream
// captures nothing, or -(cudaError_t) - 1 on an error.
long long hft_graph_nodes(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t rc = cudaStreamGetCaptureInfo(
      static_cast<cudaStream_t>(stream), &status, &id, &graph);
  if (rc != cudaSuccess) return -static_cast<long long>(rc) - 1;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) return -1;
  size_t n = 0;
  rc = cudaGraphGetNodes(graph, nullptr, &n);
  if (rc != cudaSuccess) return -static_cast<long long>(rc) - 1;
  return static_cast<long long>(n);
}

}  // extern "C"

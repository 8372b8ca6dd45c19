"""The volume kernel's source on the CPU: the per-point function, the tile
numbering and the staging layout of hifiles_tpu_torch/csrc/
volume_point.cuh, compiled by g++ into a host driver that walks every
segment's tiles as the kernel's CTAs do (a grid-stride loop through
tile_location), stages each tile's planes from plane_run's runs into a
poisoned stage buffer, and computes each element through StagedPoint and
point_tdisf.  The driver has the C entries of the CUDA library, so the
wrapper's own segment tables and argument struct (volume.launch_segments)
drive it.  Held against the plain version on every instantiation (d = 2
and 3, F = d+2 and d+3, SGS none, Smagorinsky and WALE, inviscid part on
and off) and flag (viscous, Sutherland, added flux), in f32 and f64, with
broadcast and full geometry, and on ragged segment tables: segments of
different U and E in one launch, E not a multiple of the tile, E*4 not a
multiple of 16 (no bulk copy), a misaligned operand, broadcast and full
geometry side by side, and more segments than one launch takes.

The asynchronous copies, mbarriers and the ring of stages run only on the
card: chip_smoke.py holds the kernel as nvcc builds it there."""

import ctypes
import dataclasses
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hifiles_tpu_torch.backend import CSRC
from hifiles_tpu_torch.solver import volume as V

torch.set_num_threads(1)

# the C entries of csrc/volume_tdisf.cu on the host: the same tables
# (fill_table) and instantiations (dispatch), each tile staged by memcpy
HOST_DRIVER = r"""
#include <algorithm>
#include <cstring>
#include <vector>

#include "volume_point.cuh"

namespace {

template <typename T>
struct Run {
  HftVolumeSegment* seg;
  int n_seg;
  hft::Params<T> prm;
  int grid;
  template <typename, int D, int F, int SGS, bool INV>
  int run() const {
    constexpr int TE = hft::TileShape<T>::kElems;
    const int n_tiles = hft::fill_table<T, D, F, SGS>(seg, n_seg, prm.viscous,
                                                      prm.has_extra);
    std::vector<T> stage(hft::MaxPlanes<D, F>::value * TE);
    for (int b = 0; b < grid; ++b) {
      for (int tile = b; tile < n_tiles; tile += grid) {
        const hft::TileLoc loc = hft::tile_location(seg, n_seg, tile, TE);
        const HftVolumeSegment& s = seg[loc.seg];
        const hft::StageSlots st =
            hft::stage_slots<D, F, SGS>(s, prm.viscous, prm.has_extra);
        std::fill(stage.begin(), stage.end(), T(NAN));
        for (int slot = 0; slot < st.n; ++slot) {
          std::memcpy(&stage[slot * TE],
                      hft::plane_run<T, D, F>(s, st, loc.upt, loc.e0, slot),
                      loc.n * sizeof(T));
        }
        const size_t E = static_cast<size_t>(s.n_eles);
        for (int j = 0; j < loc.n; ++j) {
          const hft::StagedPoint<T, D, F> in{stage.data(), &s, st, loc.upt,
                                             j};
          const hft::PointOut<T, F> out{
              static_cast<T*>(s.out) + loc.upt * F * E + loc.e0 + j,
              static_cast<size_t>(s.n_upts) * F * E, E};
          hft::point_tdisf<T, D, F, SGS, INV>(in, prm, out);
        }
      }
    }
    return n_tiles;
  }
};

template <typename T>
int host_launch(HftVolumeSegment* seg, int n_seg, const HftVolumeArgs* a) {
  if (n_seg < 1 || n_seg > hft::kMaxSegments) return -1;
  return hft::dispatch<T>(a->n_dims, a->n_fields,
                          a->viscous ? a->sgs : hft::kSgsNone,
                          a->inviscid != 0,
                          Run<T>{seg, n_seg, hft::params_of<T>(*a), 3});
}

template <typename T>
int copy_launch(const HftVolumeSegment* segs, int n_seg,
                const HftVolumeArgs* a) {
  std::vector<HftVolumeSegment> seg(segs, segs + n_seg);
  return host_launch<T>(seg.data(), n_seg, a) < 0 ? 1 : 0;
}

}  // namespace

extern "C" {
int hft_volume_tdisf_f32(const HftVolumeSegment* segs, int n_seg,
                         const HftVolumeArgs* args, int, void*) {
  return copy_launch<float>(segs, n_seg, args);
}
int hft_volume_tdisf_f64(const HftVolumeSegment* segs, int n_seg,
                         const HftVolumeArgs* args, int, void*) {
  return copy_launch<double>(segs, n_seg, args);
}
// the launch on the caller's table, which it leaves numbered: the tile
// count, or -1 for a table the kernel refuses
int host_table_f32(HftVolumeSegment* segs, int n_seg,
                   const HftVolumeArgs* args) {
  return host_launch<float>(segs, n_seg, args);
}
int host_table_f64(HftVolumeSegment* segs, int n_seg,
                   const HftVolumeArgs* args) {
  return host_launch<double>(segs, n_seg, args);
}
}
"""

TILE = {torch.float32: 128, torch.float64: 128}   # TileShape::kElems


@pytest.fixture(autouse=True)
def zero_counters():
    """The host driver's launches count on the kernel's counters, which
    the CPU tests elsewhere expect at 0: set them back after each test."""
    yield
    V.reset_counters()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host driver built from the kernel's header."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("volume_tdisf_host")
    (d / "host_driver.cpp").write_text(HOST_DRIVER)
    lib = d / "libvolume_tdisf_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(lib), str(d / "host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    lib = V.bind_entries(ctypes.CDLL(str(lib)))
    for name in ("host_table_f32", "host_table_f64"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.POINTER(V._Segment), ctypes.c_int,
                       ctypes.POINTER(V._Args)]
        fn.restype = ctypes.c_int
    return lib


def run_host(lib, calls, prm):
    """The calls through the wrapper's launch path on the host driver;
    returns (outputs, the calls of each launch)."""
    calls = [V.VolumeCall(*c) for c in calls]
    V._check_group(calls, prm)
    D = calls[0].jg.shape[0]
    outs = [torch.full((D,) + tuple(c.u.shape), float("nan"),
                       dtype=c.u.dtype) for c in calls]
    entry = (lib.hft_volume_tdisf_f32 if calls[0].u.dtype == torch.float32
             else lib.hft_volume_tdisf_f64)
    parts = V.launch_segments(entry, calls, prm, outs, 0, None)
    return outs, parts


def host_table(lib, calls, prm):
    """The segment table the kernel numbers for one launch of ``calls``:
    per segment (first_tile, tiles_per_row, bulk), and the tile count."""
    calls = [V.VolumeCall(*c) for c in calls]
    c = calls[0]
    D = c.jg.shape[0]
    outs = [torch.empty((D,) + tuple(x.u.shape), dtype=x.u.dtype)
            for x in calls]
    table = V.segments_of(calls, prm, outs)
    args = V.args_of(prm, c.u.shape[1], D, c.extra is not None)
    fn = (lib.host_table_f32 if c.u.dtype == torch.float32
          else lib.host_table_f64)
    n = fn(table, len(calls), ctypes.byref(args))
    return [(s.first_tile, s.tiles_per_row, s.bulk) for s in table], n


def held(got, want, dtype, what):
    tol = 1e-5 if dtype == torch.float32 else 1e-12
    scale = max(want.abs().max().item(), 1.0)
    assert torch.isfinite(got).all(), what
    assert (got - want).abs().max().item() <= tol * scale, what


def operands(U, E, d, F, seed):
    """Seeded operands of one block (numpy): u, grad, jg, delta, wdist,
    extra, in ranges where every branch of the physics is taken."""
    rng = np.random.default_rng(seed)
    u = rng.random((U, F, E)) + 1.0
    u[:, d + 1] += 10.0
    if F == d + 3:
        u[:, d + 2] = BASE.mu * rng.uniform(-2.0, 20.0, (U, E))
    return (u, rng.normal(size=(d, U, F, E)) * 0.5, rng.random((d, d, U, E)),
            0.5 + rng.random((U, E)), 0.5 * rng.random((U, E)),
            rng.normal(size=(d, U, F, E)) * 0.1)


def call_of(ops, prm, dtype, geo, add):
    """A VolumeCall of numpy operands: ``geo`` "full", "broadcast" (jg,
    delta and wdist one column) or "mixed" (jg and delta one column, wdist
    full, as the channel launches it)."""
    u, grad, jg, delta, wdist, extra = (torch.tensor(a, dtype=dtype)
                                        for a in ops)
    col = lambda a: a[..., :1].contiguous()
    if geo != "full":
        jg, delta = col(jg), col(delta)
        wdist = col(wdist) if geo == "broadcast" else wdist
    return V.VolumeCall(u, grad if prm.viscous else None, jg, delta, wdist,
                        extra if add else None)


BASE = V.VolumeParams(gamma=1.4, prandtl=0.72, mu=0.05, viscous=True,
                      rt_inf=1.0, c_sth=0.368, prandtl_t=0.9, C_s=0.1,
                      kappa=0.41)
# every template instantiation (sgs, inviscid) with the viscous flux, and
# the inviscid-only launch, each with the SA field or without
CASES = [dict(sgs=sgs, inviscid=inv) for sgs in (V.SGS_NONE,
                                                 V.SGS_SMAGORINSKY,
                                                 V.SGS_WALE)
         for inv in (True, False)] + [dict(viscous=False)]


@pytest.mark.parametrize("sa", [False, True], ids=["ns", "sa"])
@pytest.mark.parametrize("d", [2, 3])
def test_kernel_source_matches_plain_version(host_kernel, d, sa):
    """One segment: E spans three tiles, the last ragged, E*4 a multiple
    of 16 (bulk copies on the card)."""
    F = d + 2 + int(sa)
    U, E = 7, 300
    ops = operands(U, E, d, F, d + 10 * sa)
    n = 0
    for case, fix_vis, add, dtype, geo in itertools.product(
            CASES, (1, 0), (False, True), (torch.float32, torch.float64),
            ("full", "broadcast")):
        prm = dataclasses.replace(BASE, fix_vis=fix_vis, **case)
        call = call_of(ops, prm, dtype, geo, add)
        want = V.volume_tdisf_ref(*call[:3], prm, *call[3:])
        (got,), parts = run_host(host_kernel, [call], prm)
        assert len(parts) == 1
        held(got, want, dtype, (case, fix_vis, add, dtype, geo))
        n += 1
    assert n == len(CASES) * 16


# ragged segment tables: (d, F, [(U, E, geometry), ...])
TABLES = {
    # three blocks of different U and E; E = 33 leaves E*4 off 16 bytes
    "three_shapes": (3, 5, [(7, 300, "full"), (4, 33, "broadcast"),
                            (5, 256, "full")]),
    # a mixed mesh's quads (broadcast) and tris (full), d = 2, SA
    "quad_tri": (2, 5, [(9, 130, "broadcast"), (6, 517, "full")]),
    # the channel's three shards (1,366 / 1,365 / 1,365 at full width)
    "channel_shards": (3, 5, [(7, 137, "mixed"), (7, 136, "mixed"),
                              (7, 136, "mixed")]),
    # four shards of prisms and tets, 8 segments
    "prism_tet_shards": (3, 5, [(6, 64, "full"), (4, 192, "full")] * 4),
}


@pytest.mark.parametrize("name", sorted(TABLES))
def test_kernel_source_segment_tables(host_kernel, name):
    """Several segments in one launch, each against its plain version."""
    d, F, shapes = TABLES[name]
    ops = [operands(U, E, d, F, 100 + k) for k, (U, E, _) in
           enumerate(shapes)]
    for case, add, dtype in itertools.product(
            CASES, (False, True), (torch.float32, torch.float64)):
        prm = dataclasses.replace(BASE, **case)
        calls = [call_of(o, prm, dtype, geo, add)
                 for o, (_, _, geo) in zip(ops, shapes)]
        outs, parts = run_host(host_kernel, calls, prm)
        assert [len(p) for p in parts] == [len(calls)]
        for k, (c, got) in enumerate(zip(calls, outs)):
            want = V.volume_tdisf_ref(*c[:3], prm, *c[3:])
            held(got, want, dtype, (name, k, case, add, dtype))


def test_kernel_source_tile_numbering(host_kernel):
    """fill_table numbers each segment's tiles after the last one's (U
    rows of ceil(E / tile)), and stages by bulk copy only where every
    staged run starts and ends on 16 bytes: E*size a multiple of 16 and
    every staged operand aligned.  Broadcast columns are not staged, so
    their alignment does not matter."""
    prm = dataclasses.replace(BASE, sgs=V.SGS_SMAGORINSKY)
    for dtype in (torch.float32, torch.float64):
        te = TILE[dtype]
        d, F, shapes = TABLES["three_shapes"]
        calls = [call_of(operands(U, E, d, F, k), prm, dtype, geo, False)
                 for k, (U, E, geo) in enumerate(shapes)]
        rows, n = host_table(host_kernel, calls, prm)
        first, want = 0, []
        for U, E, _ in shapes:
            per_row = -(-E // te)
            size = E * (4 if dtype == torch.float32 else 8)
            want.append((first, per_row, int(size % 16 == 0)))
            first += U * per_row
        assert rows == want and n == first
        # u one element into its storage: no bulk copy for that segment
        c = calls[0]
        shifted = torch.empty(c.u.numel() + 1, dtype=dtype)
        shifted[1:] = c.u.reshape(-1)
        moved = c._replace(u=shifted[1:].view(c.u.shape))
        rows, _ = host_table(host_kernel, [moved] + calls[1:], prm)
        assert [r[2] for r in rows] == [0] + [w[2] for w in want[1:]]
        outs, _ = run_host(host_kernel, [moved], prm)
        held(outs[0], V.volume_tdisf_ref(*moved[:3], prm, *moved[3:]),
             dtype, "misaligned u")
        # a broadcast jg column at an odd address leaves bulk on
        b = call_of(operands(5, 256, d, F, 7), prm, dtype, "broadcast",
                    False)
        col = torch.empty(b.jg.numel() + 1, dtype=dtype)
        col[1:] = b.jg.reshape(-1)
        b = b._replace(jg=col[1:].view(b.jg.shape))
        rows, _ = host_table(host_kernel, [b], prm)
        assert rows[0][2] == 1
        outs, _ = run_host(host_kernel, [b], prm)
        held(outs[0], V.volume_tdisf_ref(*b[:3], prm, *b[3:]), dtype,
             "misaligned broadcast column")


def test_kernel_source_splits_long_tables(host_kernel):
    """More segments than one launch takes (MAX_SEGMENTS) go out as
    several launches, each segment's output still its own."""
    d, F = 3, 5
    prm = dataclasses.replace(BASE, sgs=V.SGS_WALE)
    n = V.MAX_SEGMENTS + 4
    calls = [call_of(operands(3, 20 + k, d, F, k), prm, torch.float64,
                     "full" if k % 2 else "broadcast", False)
             for k in range(n)]
    V.reset_counters()
    outs, parts = run_host(host_kernel, calls, prm)
    assert [len(p) for p in parts] == [V.MAX_SEGMENTS, 4]
    f, key = V.volume_tdisf, V.call_variant(calls[0], prm)
    assert (f.launches, f.segments, dict(f.by_variant)) == (2, n, {key: 2})
    assert sum(f.by_shape.values()) == n and sorted(
        len(k[1]) for k in f.by_group) == [4, V.MAX_SEGMENTS]
    for c, got in zip(calls, outs):
        held(got, V.volume_tdisf_ref(*c[:3], prm, *c[3:]), torch.float64,
             "split")
    d_, F_, shapes = TABLES["three_shapes"]
    calls = [call_of(operands(U, E, d_, F_, k), prm, torch.float32, geo,
                     False) for k, (U, E, geo) in enumerate(shapes)]
    _, n_tiles = host_table(host_kernel, calls * 6, prm)
    assert n_tiles == -1          # 18 segments: the kernel refuses them

"""K4's source on the CPU: the per-point and per-tile functions of
hifiles_tpu_torch/csrc/face_point.cuh (face_point with each Riemann
solver, the LDG switch and combination, tile_compute and tile_store, and
naive_point) and its launch checks, compiled by g++ into a host driver
with the C entries of the CUDA library: the tiled entry walks every tile
as the kernel's blocks do (every point of a tile in plane order, then
every point in face order; flat planes a point at a time, as the kernel
maps them), the naive entry every point.  The wrapper's
own argument structs (common_flux.launch) drive it.  Held against the
plain version (the plane Riemann functions of residual_soa.py, the LDG
line and the indexed stores of the write-back) for Rusanov, RoeM and HLLC
at d = 2 and 3 with F = d + 2, Rusanov and RoeM with F = d + 3 and
Lax-Friedrichs with F = 1; viscous and inviscid, f32 and f64, full and
one-column normals, face planes (nfp, faces), flat planes (a mixed mesh)
and a shard's planes whose last columns are halo faces (their r side not
written).

The launches themselves run only on the card: chip_smoke.py holds the
kernel as nvcc builds it there."""

import ctypes
import dataclasses
import itertools
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hifiles_tpu_torch.backend import CSRC
from hifiles_tpu_torch.solver import common_flux as K
from hifiles_tpu_torch.solver import volume as V
from hifiles_tpu_torch.solver.residual import ResidualConfig

torch.set_num_threads(1)

# the C entries of csrc/common_flux.cu on the host: the same checks and
# instantiations (dispatch_face); a tile's shared memory is a buffer
HOST_DRIVER = r"""
#include <cstring>
#include <vector>

#include "face_point.cuh"

namespace {

template <typename T>
struct Walk {
  const HftFaceArgs* a;
  hft::FacePrm<T> prm;
  bool naive;
  template <typename, int D, int F, int SOLVER, bool VISC>
  int run() const {
    const int n = a->n_rows * a->n_cols;
    if (naive || a->n_rows == 1) {
      for (int p = 0; p < n; ++p) {
        hft::naive_point<T, D, F, SOLVER, VISC>(*a, prm, p);
      }
      return 0;
    }
    const hft::FaceTile t = hft::face_tile<T>(a->n_rows);
    std::vector<unsigned char> stage(hft::face_stage_bytes<T, F>(t));
    T* s_f = reinterpret_cast<T*>(stage.data());
    int32_t* s_sl = reinterpret_cast<int32_t*>(s_f + F * t.rows * t.pitch());
    int32_t* s_sr = s_sl + t.rows * t.pitch();
    for (int ty = 0; ty < (a->n_rows + t.rows - 1) / t.rows; ++ty) {
      for (int tx = 0; tx < (a->n_cols + t.cols - 1) / t.cols; ++tx) {
        std::memset(stage.data(), 0xff, stage.size());
        for (int j = 0; j < t.points(); ++j) {
          hft::tile_compute<T, D, F, SOLVER, VISC>(*a, prm, t, tx, ty, j, s_f,
                                                   s_sl, s_sr);
        }
        for (int k = 0; k < t.points(); ++k) {
          hft::tile_store<T, F>(*a, t, tx, ty, k, s_f, s_sl, s_sr);
        }
      }
    }
    return 0;
  }
};

template <typename T>
int walk(const HftFaceArgs* a, const HftFacePhysics* p, bool naive) {
  if (hft::face_refused(*a, *p)) return 1;
  if (static_cast<long long>(a->n_rows) * a->n_cols == 0) return 0;
  return hft::dispatch_face<T>(*p, Walk<T>{a, hft::face_prm_of<T>(*p),
                                           naive});
}

}  // namespace

extern "C" {
int hft_common_flux_f32(const HftFaceArgs* a, const HftFacePhysics* p, int,
                        void*) {
  return walk<float>(a, p, false);
}
int hft_common_flux_f64(const HftFaceArgs* a, const HftFacePhysics* p, int,
                        void*) {
  return walk<double>(a, p, false);
}
int hft_common_flux_naive_f32(const HftFaceArgs* a, const HftFacePhysics* p,
                              int, void*) {
  return walk<float>(a, p, true);
}
int hft_common_flux_naive_f64(const HftFaceArgs* a, const HftFacePhysics* p,
                              int, void*) {
  return walk<double>(a, p, true);
}
}
"""


@pytest.fixture(autouse=True)
def zero_counters():
    yield
    V.reset_counters()


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The host driver built from K4's header."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found")
    d = tmp_path_factory.mktemp("common_flux_host")
    (d / "host_driver.cpp").write_text(HOST_DRIVER)
    lib = d / "libcommon_flux_host.so"
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC",
                    "-I", CSRC, "-o", str(lib), str(d / "host_driver.cpp")],
                   check=True, capture_output=True, timeout=300)
    return K.bind_entries(ctypes.CDLL(str(lib)))


def entry(lib, name, dtype):
    return getattr(lib, f"hft_{name}_"
                   f"{'f32' if dtype == torch.float32 else 'f64'}")


BASE = ResidualConfig(gamma=1.4, viscous=True, ldg_beta=0.5, ldg_tau=0.3,
                      wave_speed=(1.0, -0.5, 0.25), lambda_lf=0.8)

# the face planes' layouts: (rows, columns, columns with an r side) of
# (F, R, C) planes, or R None for flat (F, C) planes; R = 25 splits into
# row tiles in f64, R = 40 in f32 too, C = 70 into column tiles, C = 2500
# (flat) into tiles of 1,024
LAYOUTS = {"faces": (25, 70, 70), "faces_p2": (9, 33, 33),
           "rows40": (40, 40, 40), "flat": (None, 2500, 2500),
           "sharded": (25, 70, 52), "flat_sharded": (None, 300, 211)}


def unit_normals(rng, d, shape):
    """Random unit normals (d, *shape), half of them on the axes (n0 = 0
    on every axis but the first), where the LDG switch reads its later
    components."""
    n = rng.normal(size=(d,) + shape)
    k = rng.integers(0, d, size=shape)
    sign = rng.choice([-1.0, 1.0], size=shape)
    on_axis = rng.random(shape) < 0.5
    for m in range(d):
        n[m] = np.where(on_axis, np.where(k == m, sign, 0.0), n[m])
    return n / np.linalg.norm(n, axis=0)


def states(rng, d, F, shape):
    """Conserved states (F, *shape): subsonic and supersonic both ways, so
    that every HLLC and RoeM branch is taken; the SA field as the
    residual carries it; equation 1's scalar."""
    if F == 1:
        return rng.normal(size=(1,) + shape)
    rho = 1.0 + rng.random(shape)
    p = 1.0 + rng.random(shape)
    vel = rng.normal(size=(d,) + shape) * rng.choice([0.1, 0.5, 2.5],
                                                     size=shape)
    u = np.empty((F,) + shape)
    u[0] = rho
    u[1:d + 1] = rho * vel
    u[d + 1] = p / 0.4 + 0.5 * rho * (vel ** 2).sum(0)
    if F == d + 3:
        u[d + 2] = rng.uniform(-0.1, 2.0, shape)
    return u


def operands(d, F, layout, seed):
    """Seeded numpy operands of one launch: u_l, u_r, qn_l, qn_r, the full
    normals, the slots (a random permutation of the slot space, which
    also holds n_b slots no face side of the launch writes) and n_slots."""
    rng = np.random.default_rng(seed)
    R, C, n_r = LAYOUTS[layout]
    shape = (C,) if R is None else (R, C)
    N, Nr = C * (R or 1), n_r * (R or 1)
    n_slots = N + Nr + 17
    perm = rng.permutation(n_slots)
    return dict(u_l=states(rng, d, F, shape), u_r=states(rng, d, F, shape),
                qn_l=rng.normal(size=(F,) + shape),
                qn_r=rng.normal(size=(F,) + shape),
                norm=unit_normals(rng, d, shape), slot_l=perm[:N],
                slot_r=perm[N:N + Nr], n_slots=n_slots)


def call(ops, dtype, one_column, viscous):
    """The torch operands of a launch: (u_l, u_r, qn_l, qn_r, norm,
    slot_l, slot_r, n_slots)."""
    t = {k: torch.tensor(ops[k], dtype=dtype)
         for k in ("u_l", "u_r", "qn_l", "qn_r", "norm")}
    if one_column:
        t["norm"] = t["norm"][..., :1].contiguous()
    if not viscous:
        t["qn_l"] = t["qn_r"] = None
    return (t["u_l"], t["u_r"], t["qn_l"], t["qn_r"], t["norm"],
            torch.tensor(ops["slot_l"]), torch.tensor(ops["slot_r"]),
            ops["n_slots"])


# (equation, riemann_solve_type, d, F)
PHYSICS = ([(0, s, d, d + 2) for s in (3, 0, 2) for d in (2, 3)]
           + [(0, s, d, d + 3) for s in (0, 2) for d in (2, 3)]
           + [(1, 0, d, 1) for d in (2, 3)])


@pytest.mark.parametrize(
    "phys", PHYSICS, ids=lambda p: "eq{}-{}-d{}F{}".format(
        p[0], "lf" if p[0] else K.SOLVERS[p[1]], p[2], p[3]))
def test_common_flux_source_matches_plain_version(host_kernel, phys):
    """K4, one instantiation of (solver, d, F): viscous and inviscid, f32
    and f64, every layout, full and one-column normals, both thread
    mappings; the slots of the launch written once each, the others
    untouched."""
    eq, solver, d, F = phys
    n = 0
    for viscous, dtype, layout, one_column, name in itertools.product(
            (True, False), (torch.float32, torch.float64), sorted(LAYOUTS),
            (False, True), K.ENTRIES):
        cfg = dataclasses.replace(BASE, equation=eq,
                                  riemann_solve_type=solver, viscous=viscous)
        ops = operands(d, F, layout, 97 * d + 13 * F + solver)
        args = call(ops, dtype, one_column, viscous)
        R, C, n_r = LAYOUTS[layout]
        assert K.check(*args, cfg) == (d, F, R or 1, C, n_r)
        out = torch.full((F, args[-1]), float("nan"), dtype=dtype)
        K.launch(entry(host_kernel, name, dtype), *args, cfg, out, 0, None)
        want = K.common_flux_ref(*args, cfg)
        what = (viscous, dtype, layout, one_column, name)
        written = torch.cat([args[5], args[6]])
        got, ref = out[:, written], want[:, written]
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert torch.isfinite(got).all(), what
        assert (got - ref).abs().max().item() <= tol * max(
            ref.abs().max().item(), 1.0), what
        rest = torch.ones(args[-1], dtype=torch.bool)
        rest[written] = False
        assert rest.sum().item() == 17
        assert torch.isnan(out[:, rest]).all(), what
        # the CPU wrapper is the plain version
        cpu = K.common_flux(*args, cfg)
        assert torch.equal(cpu[:, written], ref), what
        n += 1
    assert n == 96 and K.common_flux.launches == 0


def test_common_flux_plain_version_is_the_residuals_old_form():
    """The plain version is the residual's earlier code: the plane Riemann
    function, the LDG line with the switch of the normals, and write's
    two indexed stores of fn and -fn (the halo faces' r side left out)."""
    from hifiles_tpu_torch.solver.residual_soa import ldg_sign_p, riemann_of
    d, F = 3, 5
    cfg = dataclasses.replace(BASE, riemann_solve_type=3)
    u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots = call(
        operands(d, F, "sharded", 5), torch.float64, False, True)
    nrm = list(norm.unbind(0))
    fn = torch.stack(riemann_of(cfg, d)(u_l.unbind(0), u_r.unbind(0), nrm,
                                        cfg.gamma, d))
    sgn = ldg_sign_p(nrm)
    fn = (fn + (0.5 + cfg.ldg_beta * sgn) * qn_l
          - (0.5 - cfg.ldg_beta * sgn) * qn_r - cfg.ldg_tau * (u_r - u_l))
    got = K.common_flux(u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots,
                        cfg)
    n_r = LAYOUTS["sharded"][2]
    assert torch.equal(got[:, slot_l], fn.reshape(F, -1))
    assert torch.equal(got[:, slot_r], -fn[..., :n_r].reshape(F, -1))


def test_common_flux_source_refuses(host_kernel):
    """The launches the kernel refuses (HLLC with the SA field, another
    equation or F, viscous without qn, n_r beyond the columns, a normal
    of neither width, more points or slots than an int counts) return an
    error, and the wrapper's checks refuse bad operands."""
    d, F = 3, 5
    ops = operands(d, F, "faces", 1)
    args = call(ops, torch.float64, False, True)
    run = entry(host_kernel, "common_flux", torch.float64)
    out = torch.empty((F, args[-1]), dtype=torch.float64)

    def rc(change_args=None, **phys):
        a = K._FaceArgs(
            u_l=args[0].data_ptr(), u_r=args[1].data_ptr(),
            qn_l=args[2].data_ptr(), qn_r=args[3].data_ptr(),
            norm=args[4].data_ptr(), slot_l=args[5].data_ptr(),
            slot_r=args[6].data_ptr(), out=out.data_ptr(), n_rows=25,
            n_cols=70, n_r=70, norm_cols=70, n_slots=args[-1])
        for k, v in (change_args or {}).items():
            setattr(a, k, v)
        p = K.physics_of(dataclasses.replace(BASE, riemann_solve_type=3),
                         d, F)
        for k, v in phys.items():
            setattr(p, k, v)
        return run(ctypes.byref(a), ctypes.byref(p), 0, None)
    assert rc() == 0
    for change_args, phys in [
            ({}, dict(n_fields=6)), ({}, dict(equation=2)),
            ({}, dict(equation=1)), ({}, dict(n_dims=4)),
            ({}, dict(riemann=1)), (dict(qn_r=None), {}),
            (dict(n_r=71), {}), (dict(norm_cols=7), {}),
            (dict(n_rows=2 ** 16, n_cols=2 ** 16), {}),
            (dict(n_slots=2 ** 31), {}), (dict(out=None), {})]:
        assert rc(change_args, **phys) == 1, (change_args, phys)
    assert rc(dict(qn_l=None, qn_r=None), viscous=0) == 0
    assert rc(dict(n_rows=0, u_l=None, out=None)) == 0
    cfg = dataclasses.replace(BASE, riemann_solve_type=3)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        K.launch(run, *args, dataclasses.replace(cfg, equation=3), out, 0,
                 None)
    u_l, u_r, qn_l, qn_r, norm, slot_l, slot_r, n_slots = args
    good = dict(u_l=u_l, u_r=u_r, qn_l=qn_l, qn_r=qn_r, norm=norm,
                slot_l=slot_l, slot_r=slot_r, n_slots=n_slots, cfg=cfg)
    bad = [
        (dict(cfg=dataclasses.replace(cfg, riemann_solve_type=1)), "K4"),
        (dict(u_l=u_l[:4].contiguous(), u_r=u_r[:4].contiguous(),
              qn_l=qn_l[:4].contiguous(), qn_r=qn_r[:4].contiguous()),
         "K4"),
        (dict(qn_r=None), "qn_r"),
        (dict(norm=norm[..., :7].contiguous()), "norm"),
        (dict(norm=norm[:1]), "norm"),
        (dict(slot_l=slot_l[:-1]), "slot_l"),
        (dict(slot_r=slot_r[:-1]), "slot_l"),
        (dict(slot_r=slot_r.int()), "int64"),
        (dict(u_r=u_r.float()), "device and dtype"),
        (dict(u_l=u_l.transpose(1, 2).contiguous().transpose(1, 2)),
         "contiguous"),
    ]
    for change, match in bad:
        kw = dict(good)
        kw.update(change)
        with pytest.raises(ValueError, match=match):
            K.common_flux(**kw)


def test_common_flux_counter_follows_captured_replays():
    """K4's launch counter rides volume.captured_launches and count_replay
    as the volume kernel's does: a capture's launches come back as one
    replay's and leave the counter as it was; each replay adds them;
    reset_counters zeroes them."""
    f = K.common_flux

    def capture():
        for _ in range(5):
            f.launches += 1
            f.by_variant["D3F5+hllc+ldg"] += 1
    V.reset_counters()
    delta = V.captured_launches(capture)
    assert (f.launches, len(f.by_variant)) == (0, 0)
    for _ in range(3):
        V.count_replay(delta)
    assert f.launches == 15
    assert dict(f.by_variant) == {"D3F5+hllc+ldg": 15}
    V.reset_counters()
    assert (f.launches, len(f.by_variant)) == (0, 0)


@pytest.mark.parametrize("cfg,d,F,want", [
    (BASE, 3, 5, "D3F5+rusanov+ldg"),
    (dataclasses.replace(BASE, riemann_solve_type=3, viscous=False), 2, 4,
     "D2F4+hllc"),
    (dataclasses.replace(BASE, riemann_solve_type=2), 3, 6, "D3F6+roem+ldg"),
    (dataclasses.replace(BASE, equation=1), 2, 1, "D2F1+lf+ldg")])
def test_common_flux_variant_names(cfg, d, F, want):
    """The counter's variant names: dimension, fields, solver, LDG."""
    assert K.variant(cfg, F, d) == want

"""The writers of the PyTorch port (hifiles_tpu_torch/io) on the port's
solvers against the JAX package's writers on the JAX solvers, both holding
the same state (set_state on the port, the state assigned on the JAX side):
vtu, tecplot and ASCII restart files byte for byte, the HDF5 restart, CGNS
and probe files dataset by dataset, history with its wall-clock column
dropped; the fields read from gradient_fn or sensor_fn numerically at 1e-10;
restarts written by either side read by the other (cross-order and mixed
too); the forces at 1e-10.  f64 on the CPU, on the cases of
tests/test_io.py, test_io_extras.py, test_probes.py and test_forces.py that
need no reference tree."""

import os
import sys
import xml.etree.ElementTree as ET

import h5py
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hifiles_tpu.config.params import ISOTHERM_WALL, SLIP_WALL
from hifiles_tpu.io import cgns as jcgns
from hifiles_tpu.io import forces as jforces
from hifiles_tpu.io import history as jhistory
from hifiles_tpu.io import probes as jprobes
from hifiles_tpu.io import restart as jrestart
from hifiles_tpu.io import tecplot as jtecplot
from hifiles_tpu.io import vtu as jvtu
from hifiles_tpu.mesh.generate import (periodic_hex_mesh,
                                       periodic_mixed_mesh_2d,
                                       periodic_prism_mesh,
                                       periodic_quad_mesh, periodic_tet_mesh)
from hifiles_tpu.solver.multiblock import MixedSolver as JaxMixedSolver
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.io import cgns as tcgns
from hifiles_tpu_torch.io import forces as tforces
from hifiles_tpu_torch.io import history as thistory
from hifiles_tpu_torch.io import probes as tprobes
from hifiles_tpu_torch.io import restart as trestart
from hifiles_tpu_torch.io import tecplot as ttecplot
from hifiles_tpu_torch.io import vtu as tvtu

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402
from test_io import vortex_input  # noqa: E402
from test_torch_diagnostics import walled  # noqa: E402
from test_torch_featured import channel_twin  # noqa: E402

torch.set_num_threads(1)

DIAG = ["u", "v", "w", "energy", "pressure", "mach", "vorticity",
        "q_criterion", "scaled_q_criterion"]
INTEGRALS = ["kineticenergy", "enstropy", "pressuredilatation",
             "straincolonproduct", "devstraincolonproduct"]


def vortex(order=3, **attrs):
    p = vortex_input(order=order)
    p.diagnostic_fields = list(DIAG)
    p.integral_quantities = list(INTEGRALS)
    p.p_res = 3
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def tgv(order=2, **attrs):
    p = tgv_input()
    p.order = order
    p.diagnostic_fields = list(DIAG)
    p.integral_quantities = list(INTEGRALS)
    for k, v in attrs.items():
        setattr(p, k, v)
    return p


def channel():
    """The forced, averaged channel twin: average fields in the plots."""
    p, mesh = channel_twin()
    p.diagnostic_fields = ["pressure", "vorticity"]
    return p, mesh


# name -> (deck, mesh): quad, hex, tet, prism and tri+quad meshes, and the
# walled channel with running averages
CASES = {
    "quad": lambda: (vortex(), periodic_quad_mesh(4, 4, -5, 5, -5, 5)),
    "hex": lambda: (tgv(), periodic_hex_mesh(3, 3, 3)),
    "tet": lambda: (tgv(), periodic_tet_mesh(2, 2, 2)),
    "prism": lambda: (tgv(), periodic_prism_mesh(2, 2, 2)),
    "mixed": lambda: (vortex(order=2), periodic_mixed_mesh_2d(
        4, 4, -10, 10, -10, 10)),
    "channel_avg": channel,
}


def seeded(u, seed=0, amp=0.02):
    rng = np.random.default_rng(seed)
    return np.asarray(u) * (1.0 + amp * rng.random(np.asarray(u).shape))


def pair(p, mesh, time=0.125, seed=0):
    """The JAX solver and the port's CPU solver of one deck and mesh (a
    MixedSolver for mixed and prism meshes, as both drivers route them),
    given the same seeded state, time and running averages."""
    types = np.unique(mesh.ctype)
    mixed = types.size > 1 or int(types[0]) == hifiles_tpu_torch.PRISM
    if mixed:
        js = JaxMixedSolver(p, mesh)
        ts = hifiles_tpu_torch.MixedSolver(run_input_from(p),
                                           mesh_from(mesh), device="cpu")
        u = tuple(seeded(a, seed + i) for i, a in enumerate(js.u))
        js.u = tuple(jnp.asarray(a) for a in u)
        ts.set_state(u, tuple(np.zeros_like(a) for a in u), time)
    else:
        js = JaxSolver(p, mesh)
        ts = hifiles_tpu_torch.Solver(run_input_from(p), mesh_from(mesh),
                                      device="cpu")
        u = seeded(js.u, seed)
        ua = None
        if js.u_avg is not None:
            ua = seeded(np.ones(js.u_avg.shape), seed + 1)
            js.u_avg = jnp.asarray(ua)
        js.u = jnp.asarray(u)
        ts.set_state(u, np.zeros_like(u), time, u_avg=ua)
    js.time = time
    return js, ts


def read_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def vtu_arrays(path):
    """{name: text} of a vtu file's DataArrays (the points' under "")."""
    return {da.get("Name", ""): da.text
            for da in ET.parse(path).iter("DataArray")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_vtu_and_tecplot_byte_identical(case, tmp_path):
    p, mesh = CASES[case]()
    js, ts = pair(p, mesh)
    a, b = tmp_path / "jax", tmp_path / "port"
    fa = jvtu.write_vtu(js, str(a), 4)
    fb = tvtu.write_vtu(ts, str(b), 4)
    assert os.path.relpath(fa, a) == os.path.relpath(fb, b)
    written = sorted(os.path.relpath(os.path.join(r, f), a)
                     for r, _, fs in os.walk(a) for f in fs)
    assert written == sorted(os.path.relpath(os.path.join(r, f), b)
                             for r, _, fs in os.walk(b) for f in fs)
    for rel in written:
        assert read_bytes(a / rel) == read_bytes(b / rel), rel
    if case == "channel_avg":
        assert "rho_average" in vtu_arrays(fb)
    if hasattr(ts, "cts"):
        return       # tecplot writes one element type
    ta = jtecplot.write_tec(js, str(a), 4)
    tb = ttecplot.write_tec(ts, str(b), 4)
    assert read_bytes(ta) == read_bytes(tb)


def test_sensor_field_matches_jax(tmp_path):
    """The sensor plot field comes from sensor_fn: numerically equal; every
    other field byte-identical."""
    p = vortex(shock_cap=1, s0=0.0, riemann_solve_type=2)
    p.diagnostic_fields = ["pressure", "sensor"]
    js, ts = pair(p, periodic_quad_mesh(4, 4, -5, 5, -5, 5), seed=3)
    fa = jvtu.write_vtu(js, str(tmp_path / "jax"), 1)
    fb = tvtu.write_vtu(ts, str(tmp_path / "port"), 1)
    da, db = vtu_arrays(fa), vtu_arrays(fb)
    assert sorted(da) == sorted(db)
    for name in da:
        if name != "sensor":
            assert da[name] == db[name], name
    sa = np.array(da["sensor"].split(), dtype=float)
    sb = np.array(db["sensor"].split(), dtype=float)
    assert sa.max() > 0
    assert np.abs(sa - sb).max() < 1e-10 * max(np.abs(sa).max(), 1.0)


def test_scaled_q_criterion_alone(tmp_path):
    """Asked alone, scaled_q_criterion raises in the JAX writers (their
    gradient is built only for vorticity and q_criterion) and is written by
    the port's, equal to the field the JAX writer gives beside
    q_criterion."""
    p = vortex(diagnostic_fields=["scaled_q_criterion"])
    js, ts = pair(p, periodic_quad_mesh(4, 4, -5, 5, -5, 5))
    with pytest.raises(TypeError):
        jvtu.write_vtu(js, str(tmp_path / "jax_alone"), 1)
    with pytest.raises(TypeError):
        jtecplot.write_tec(js, str(tmp_path), 1)
    fb = tvtu.write_vtu(ts, str(tmp_path / "port"), 1)
    tb = ttecplot.write_tec(ts, str(tmp_path), 2)
    js.p.diagnostic_fields = ["q_criterion", "scaled_q_criterion"]
    fa = jvtu.write_vtu(js, str(tmp_path / "jax"), 1)
    ta = jtecplot.write_tec(js, str(tmp_path), 1)
    assert vtu_arrays(fb)["scaled_q_criterion"] == \
        vtu_arrays(fa)["scaled_q_criterion"]
    cols_a = np.loadtxt(ta, skiprows=3, max_rows=16 * 9)
    cols_b = np.loadtxt(tb, skiprows=3, max_rows=16 * 9)
    assert np.array_equal(cols_b[:, -1], cols_a[:, -1])
    assert np.array_equal(cols_b[:, :-1], cols_a[:, :-2])


@pytest.mark.parametrize("case", ["quad", "mixed", "channel_avg"])
def test_history_matches_jax(case, tmp_path):
    """history.plt with every integral quantity, less its wall-clock
    column."""
    p, mesh = CASES[case]()
    if case != "channel_avg":
        p.integral_quantities = list(INTEGRALS)
    js, ts = pair(p, mesh)
    ha = jhistory.HistoryWriter(str(tmp_path / "a.plt"), js)
    hb = thistory.HistoryWriter(str(tmp_path / "b.plt"), ts)
    for it in (10, 20):
        ra, rb = ha.write(it), hb.write(it)
        assert np.abs(ra["residual"] - rb["residual"]).max() <= \
            1e-10 * np.abs(ra["residual"]).max()
    la = (tmp_path / "a.plt").read_text().splitlines()
    lb = (tmp_path / "b.plt").read_text().splitlines()
    assert la[:2] == lb[:2] and len(la) == len(lb) == 4
    for x, y in zip(la[2:], lb[2:]):
        x = np.array(x.split()[:-1], dtype=float)
        y = np.array(y.split()[:-1], dtype=float)
        assert np.abs(x - y).max() <= 1e-10 * np.abs(x).max()


def h5_tree(path):
    """{name: (value, attrs)} of every group and dataset of an HDF5 file,
    the root's attributes under "/"."""
    out = {}
    with h5py.File(path, "r") as f:
        out["/"] = (None, {k: np.asarray(v) for k, v in f.attrs.items()})

        def visit(name, obj):
            val = obj[...] if isinstance(obj, h5py.Dataset) else None
            out[name] = (val, {k: np.asarray(v) for k, v in obj.attrs.items()})
        f.visititems(visit)
    return out


def assert_h5_equal(pa, pb):
    ta, tb = h5_tree(pa), h5_tree(pb)
    assert sorted(ta) == sorted(tb)
    for name, (va, aa) in ta.items():
        vb, ab = tb[name]
        assert (va is None) == (vb is None), name
        if va is not None:
            assert va.dtype == vb.dtype and np.array_equal(va, vb), name
        assert sorted(aa) == sorted(ab), name
        for k in aa:
            assert aa[k].dtype == ab[k].dtype and np.array_equal(aa[k],
                                                                 ab[k]), \
                (name, k)


@pytest.mark.parametrize("case", ["quad", "hex", "mixed"])
def test_restart_files_identical_and_cross_read(case, tmp_path):
    """HDF5 restarts equal dataset for dataset; ASCII restarts byte for byte
    (single-type solvers); each side reads the other's file back to the
    same state and time, and its RK register is clear."""
    p, mesh = CASES[case]()
    js, ts = pair(p, mesh, time=0.375)
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir()
    b.mkdir()
    fa = jrestart.write_restart(str(a), js, step=7)
    fb = trestart.write_restart(str(b), ts, step=7)
    assert os.path.basename(fa) == os.path.basename(fb) == "Rest_000000007.h5"
    assert_h5_equal(fa, fb)
    files = [(fa, fb)]
    if case != "mixed":
        aa = jrestart.write_restart_ascii(str(a), js, step=7)
        ab = trestart.write_restart_ascii(str(b), ts, step=7)
        assert read_bytes(aa) == read_bytes(ab)
        files.append((aa, ab))
    for fa, fb in files:
        read = ((jrestart.read_restart, trestart.read_restart)
                if fa.endswith(".h5") else
                (jrestart.read_restart_ascii, trestart.read_restart_ascii))
        js2, ts2 = pair(p, mesh, time=0.0, seed=11)
        ts2.run(1, dt=1e-4)
        assert read[0](fb, js2) == read[1](fa, ts2) == 0.375
        ua = js2.u if isinstance(js2.u, tuple) else (js2.u,)
        ub = ts2.u if isinstance(ts2.u, tuple) else (ts2.u,)
        for x, y in zip(ua, ub):
            assert np.array_equal(np.asarray(x), y)
        assert ts2.time == 0.375 and not ts2.reg_soa.abs().max()


# the ASCII restart writes one element type
@pytest.mark.parametrize("case,fmt", [("quad", "h5"), ("hex", "h5"),
                                      ("mixed", "h5"), ("quad", "ascii"),
                                      ("hex", "ascii")])
def test_restart_cross_order(case, fmt, tmp_path):
    """A p+1 file read into a p run re-interpolates through opp_r: the port
    reading the JAX file equals the JAX solver reading it."""
    p, mesh = CASES[case]()
    js, _ = pair(p, mesh, time=0.25)
    write = (jrestart.write_restart if fmt == "h5"
             else jrestart.write_restart_ascii)
    read_j = jrestart.read_restart if fmt == "h5" \
        else jrestart.read_restart_ascii
    read_t = trestart.read_restart if fmt == "h5" \
        else trestart.read_restart_ascii
    f = write(str(tmp_path), js, step=0)
    q = CASES[case]()[0]
    q.order -= 1
    js2, ts2 = pair(q, mesh)
    assert read_j(f, js2) == read_t(f, ts2) == 0.25
    ua = js2.u if isinstance(js2.u, tuple) else (js2.u,)
    ub = ts2.u if isinstance(ts2.u, tuple) else (ts2.u,)
    for x, y in zip(ua, ub):
        assert np.abs(np.asarray(x) - y).max() <= 1e-14 * np.abs(y).max()


@pytest.mark.parametrize("case", ["quad", "mixed"])
def test_cgns_identical(case, tmp_path):
    p, mesh = CASES[case]()
    p.diagnostic_fields = ["u", "v", "energy", "pressure", "mach",
                           "vorticity"]
    js, ts = pair(p, mesh)
    fa = jcgns.write_cgns(js, str(tmp_path / "a"), 3)
    fb = tcgns.write_cgns(ts, str(tmp_path / "b"), 3)
    assert os.path.basename(fa) == os.path.basename(fb)
    assert_h5_equal(fa, fb)
    za, zb = (jcgns.read_cgns_summary(fa)["zones"],
              tcgns.read_cgns_summary(fb)["zones"])
    assert [z["fields"] for z in za] == [z["fields"] for z in zb]


PROBE_CASES = {
    "quad": lambda: (vortex(), periodic_quad_mesh(8, 8, -5, 5, -5, 5),
                     jprobes.probe_line([-4, 0.1], [4, 0.3], 7)),
    "mixed": lambda: (vortex(order=2), periodic_mixed_mesh_2d(
        8, 8, -10, 10, -10, 10), np.array([[-5.1, 0.3], [5.2, -0.7],
                                           [0.05, 0.0], [-9.9, 9.9]])),
    "viscous_hex": lambda: (tgv(), periodic_hex_mesh(3, 3, 3),
                            np.array([[0.3, 0.2, 0.1], [-2.0, 1.0, 2.5]])),
}


@pytest.mark.parametrize("case", sorted(PROBE_CASES))
def test_probes_identical(case, tmp_path):
    """Probe location and sampling, and the HDF5 and ASCII probe files
    after two appends (the viscous case re-dimensionalizes the ASCII
    rows)."""
    p, mesh, pts = PROBE_CASES[case]()
    js, ts = pair(p, mesh)
    fields = ["rho", "u", "v", "pressure", "specific_total_energy"]
    pa = jprobes.ProbeSet(js, pts, fields)
    pb = tprobes.ProbeSet(ts, pts, fields)
    assert np.array_equal(pa.ele, pb.ele) and pb.owned.size == len(pts)
    assert np.array_equal(pa.sample(), pb.sample())
    wa = [jprobes.ProbeHDF5Writer(str(tmp_path / "a.h5"), pa),
          jprobes.ProbeASCIIWriter(str(tmp_path / "a"), pa)]
    wb = [tprobes.ProbeHDF5Writer(str(tmp_path / "b.h5"), pb),
          tprobes.ProbeASCIIWriter(str(tmp_path / "b"), pb)]
    for t in (0.0, 0.5):
        for w in wa:
            w.append(t)
        for w in wb:
            w.append(t)
    assert_h5_equal(tmp_path / "a.h5", tmp_path / "b.h5")
    for k in range(len(pts)):
        assert read_bytes(tmp_path / "a" / f"probe_{k}.dat") == \
            read_bytes(tmp_path / "b" / f"probe_{k}.dat")


def test_probe_script_setup_identical(tmp_path):
    script = tmp_path / "probes.txt"
    script.write_text("line wake ( -4.0 0.0 0.0  4.0 0.0 0.0  0.5 5 )\n"
                      "point ( 0.25 0.5 0.0 )\n")
    p = vortex(probe=1, probe_fields=["rho", "pressure"], probe_freq=1,
               probe_source_file=str(script))
    js, ts = pair(p, periodic_quad_mesh(8, 8, -5, 5, -5, 5))
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ma = jprobes.setup_probes(js.p, js, str(tmp_path / "a"))
    mb = tprobes.setup_probes(ts.p, ts, str(tmp_path / "b"))
    assert [n for n, _, _ in ma.sets] == [n for n, _, _ in mb.sets]
    ma.append(js, 1)
    mb.append(ts, 1)
    for name, _, _ in ma.sets:
        assert_h5_equal(tmp_path / "a" / f"{name}.h5",
                        tmp_path / "b" / f"{name}.h5")


FORCE_CASES = {
    "isotherm": lambda: walled(ISOTHERM_WALL),
    "slip": lambda: walled(SLIP_WALL),
}


@pytest.mark.parametrize("case", sorted(FORCE_CASES))
def test_forces_match_jax(case, tmp_path):
    """compute_forces at 1e-10 (its viscous part reads gradient_fn); the cp
    dump byte for byte; force.dat numerically."""
    p, mesh = FORCE_CASES[case]()
    p.calc_force, p.area_ref = 1, 2.0
    js, ts = pair(p, mesh)
    fa, fb = jforces.compute_forces(js), tforces.compute_forces(ts)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        a, b = np.asarray(fa[k]), np.asarray(fb[k])
        assert a.shape == b.shape, k
        assert np.abs(a - b).max() <= 1e-10 * max(np.abs(a).max(), 1.0), k
    assert np.abs(fa["vis_force"]).max() > 0 or case == "slip"
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    jforces.write_force_file(js, str(tmp_path / "a"), 5)
    tforces.write_force_file(ts, str(tmp_path / "b"), 5)
    cp = "cp_000000005.dat"
    assert read_bytes(tmp_path / "a" / cp) == read_bytes(tmp_path / "b" / cp)
    da = np.loadtxt(tmp_path / "a" / "force.dat")
    db = np.loadtxt(tmp_path / "b" / "force.dat")
    assert np.abs(da - db).max() <= 1e-10 * np.abs(da).max()

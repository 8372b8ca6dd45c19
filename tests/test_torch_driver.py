"""The run driver of the PyTorch port (``python -m hifiles_tpu_torch
<deck>``, hifiles_tpu_torch.driver.main) against the JAX package's
(hifiles_tpu.driver.main) on the same deck, each in its own output
directory, at f64 on the CPU: the printed monitor, force and final-error
rows at 1e-10 (or one unit of their last printed digit), history.plt less
its wall-clock column, error.dat, and the files written; on a TGV hex
Gambit deck, the mixed tri+quad Gmsh deck of tests/test_driver_mixed.py,
the Couette deck, a local-dt deck and a restart.  Then the counterparts of
tests/test_cli_multidevice.py: ``--devices N --device cpu`` runs against
the port's single-device run, and probes on a ShardedSolver."""

import os
import re
import shutil
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu import driver as jax_driver
from hifiles_tpu.config.params import RunInput as JaxRunInput
from hifiles_tpu.mesh.gambit import write_gambit
from hifiles_tpu.mesh.generate import (periodic_hex_mesh,
                                       periodic_mixed_mesh_2d,
                                       ywall_channel_quad_mesh)

from hifiles_tpu_torch import driver as port_driver
from hifiles_tpu_torch.config.params import RunInput
from hifiles_tpu_torch.convert import run_input_from

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import tgv_deck  # noqa: E402
from test_cli_multidevice import _short_deck  # noqa: E402
from test_driver_mixed import write_gmsh22  # noqa: E402

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")
NUM = r"[-+]?\d+\.\d+e[-+]\d+"

MIXED_DECK = """
equation 0
viscous 0
order 2
ic_form 0
test_case 1
n_steps 20
adv_type 3
riemann_solve_type 0
dt_type 0
dt 5e-4
u_c_ic 0.0
v_c_ic 0.0
w_c_ic 0.0
rho_c_ic 1.0
p_c_ic 17.857142857142858
Mach_free_stream 0.3
plot_freq 20
restart_dump_freq 0
monitor_res_freq 10
mesh_file box.msh
mesh_format 1
dx_cyclic 20.0
dy_cyclic 20.0
bc_Cyclic_type Cyclic
"""


def hex_case(d, **run):
    write_gambit(periodic_hex_mesh(4, 4, 4), str(d / "tgv.neu"))
    kw = dict(order=2, n_steps=4, monitor_res_freq=2, plot_freq=4,
              restart_dump_freq=4,
              diagnostic_fields="3 pressure vorticity q_criterion")
    kw.update(run)
    (d / "run.deck").write_text(tgv_deck("tgv.neu", **kw))
    return d / "run.deck"


def mixed_case(d, extra=""):
    """tests/test_driver_mixed.py:51-89's deck and Gmsh mesh."""
    write_gmsh22(periodic_mixed_mesh_2d(4, 4, -10.0, 10.0, -10.0, 10.0),
                 "Cyclic", d / "box.msh")
    (d / "run.deck").write_text(MIXED_DECK + extra)
    return d / "run.deck"


def couette_case(d):
    write_gambit(ywall_channel_quad_mesh(4, 4, 0.0, 2.0, 0.0, 1.0,
                                         bc_ymin="Isotherm_Fix",
                                         bc_ymax="Isotherm_Mov"),
                 str(d / "quad_couette.neu"))
    shutil.copy(os.path.join(DECKS, "input_couette_50"), d / "run.deck")
    return d / "run.deck"


CASES = {
    "hex": hex_case,
    "mixed": mixed_case,
    "couette": couette_case,
    "local_dt": lambda d: hex_case(d, dt_type=2, CFL=0.5, n_steps=6,
                                   restart_dump_freq=3),
}


def rows(out):
    """The numbers of the printed monitor, force and final-error rows."""
    return [[float(x) for x in re.findall(NUM, line)]
            for line in out.splitlines()
            if line.startswith(("iter", "final error", "         force"))]


def assert_close(a, b):
    """At 1e-10 relative, or one unit of the last printed digit (the rows
    print 7 and the files 11 significant digits)."""
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    digit = 10.0 ** (np.floor(np.log10(np.maximum(np.abs(a), 1e-300))) - 9)
    assert np.all(np.abs(a - b) <= np.maximum(1e-10 * np.abs(a),
                                              1.0001 * digit)), (a, b)


def run_both(deck, tmp_path, capsys):
    """Each driver on the deck, into tmp_path/jax and tmp_path/port;
    returns their stdouts."""
    outs = {}
    for name, main, extra in (("jax", jax_driver.main, []),
                              ("port", port_driver.main,
                               ["--device", "cpu"])):
        assert main([str(deck), "--f64", "--outdir", str(tmp_path / name),
                     *extra]) == 0
        outs[name] = capsys.readouterr().out
    return outs


def files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def table(path, drop_last=False):
    lines = path.read_text().splitlines()
    data = [line.split() for line in lines if line[:1].isdigit()]
    return [x[:-1] if drop_last else x for x in data], \
        [line for line in lines if not line[:1].isdigit()]


def assert_outputs_match(tmp_path, outs, names=("jax", "port")):
    """The runs ``names`` (their stdouts in ``outs``, their files in
    tmp_path/<name>) agree."""
    a, b = (tmp_path / name for name in names)
    ra, rb = (rows(outs[name]) for name in names)
    assert ra and len(ra) == len(rb)
    for x, y in zip(ra, rb):
        assert_close(x, y)
    assert files(a) == files(b)
    ha, head_a = table(a / "history.plt", drop_last=True)
    hb, head_b = table(b / "history.plt", drop_last=True)
    assert head_a == head_b and len(ha) == len(hb) > 0
    assert_close(ha, hb)
    if (a / "error.dat").exists():
        assert_close(table(a / "error.dat")[0], table(b / "error.dat")[0])
    for rel in files(a):
        if rel.endswith((".pvtu", ".vtu", ".dat")) and "error" not in rel \
                and "force" not in rel:
            ta = (a / rel).read_text().split()
            tb = (b / rel).read_text().split()
            assert len(ta) == len(tb), rel
            na = [x for x in ta if re.fullmatch(r"[-+.\deE]+", x)]
            nb = [x for x in tb if re.fullmatch(r"[-+.\deE]+", x)]
            assert [x for x in ta if x not in na] == \
                [x for x in tb if x not in nb], rel
            assert_close(np.array(na, dtype=float), np.array(nb, dtype=float))


@pytest.mark.parametrize("case", sorted(CASES))
def test_driver_matches_jax(case, tmp_path, capsys):
    deck = CASES[case](tmp_path)
    outs = run_both(deck, tmp_path, capsys)
    assert_outputs_match(tmp_path, outs)
    assert "volume_tdisf launches" in outs["port"]
    assert "flux_point_qn launches" in outs["port"]
    assert "solution_point_gradient launches" in outs["port"]
    assert "common_flux launches" in outs["port"]
    if case == "couette":
        assert "force.dat" in files(tmp_path / "port")


def test_restart_round_trip(tmp_path, capsys):
    """4 steps dumping an HDF5 restart, then a deck restarting from it for
    2 more: both drivers read their own file back and agree."""
    hex_case(tmp_path, restart_ascii=0, diagnostic_fields="0")
    run_both(tmp_path / "run.deck", tmp_path, capsys)
    assert "Rest_000000004.h5" in files(tmp_path / "port")
    (tmp_path / "restart.deck").write_text(tgv_deck(
        "tgv.neu", order=2, n_steps=2, monitor_res_freq=2, plot_freq=6,
        restart_dump_freq=6, restart_ascii=0, restart_flag=1,
        restart_iter=4, n_restart_files=1, diagnostic_fields="0"))
    outs = run_both(tmp_path / "restart.deck", tmp_path, capsys)
    assert "restarted from" in outs["port"]
    assert_outputs_match(tmp_path, outs)
    assert re.search(r"^iter +6 ", outs["port"], re.M)


def test_ascii_restart_continues_exactly(tmp_path, capsys):
    """The port's driver restarts from its ASCII dump (restart_ascii): the
    state it reads back is the one written (repr floats), so 2 + 2 steps
    give the uninterrupted 4-step run's rows."""
    hex_case(tmp_path, n_steps=2, monitor_res_freq=2, plot_freq=10,
             restart_dump_freq=2)
    argv = ["--f64", "--device", "cpu", "--outdir"]
    assert port_driver.main([str(tmp_path / "run.deck"), *argv,
                             str(tmp_path / "a")]) == 0
    (tmp_path / "restart.deck").write_text(tgv_deck(
        "tgv.neu", order=2, n_steps=2, monitor_res_freq=2, plot_freq=10,
        restart_dump_freq=10, restart_flag=1, restart_iter=2,
        n_restart_files=1))
    assert port_driver.main([str(tmp_path / "restart.deck"), *argv,
                             str(tmp_path / "a")]) == 0
    (tmp_path / "whole.deck").write_text(tgv_deck(
        "tgv.neu", order=2, n_steps=4, monitor_res_freq=2, plot_freq=10,
        restart_dump_freq=10))
    assert port_driver.main([str(tmp_path / "whole.deck"), *argv,
                             str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "restarted from" in out and "Rest_000000002_p0000.dat" in out
    ra = table(tmp_path / "a" / "history.plt", drop_last=True)[0]
    rb = table(tmp_path / "b" / "history.plt", drop_last=True)[0]
    assert ra[-1][0] == rb[-1][0] == "4"
    assert ra[-1] == rb[-1]


def test_devices_option_raises(tmp_path, monkeypatch):
    """--devices never moves a run to the CPU unasked: without CUDA it
    raises unless --device cpu is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    deck = hex_case(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_driver.main([str(deck), "--devices", "2", "--outdir",
                          str(tmp_path / "out")])


def test_devices_matches_single_device(tmp_path, capsys):
    """tests/test_cli_multidevice.py:44-72 on the port: the vortex-parity
    deck (16^2 quads, p=3, 20 steps) as 4 shards on the CPU against the
    single-device run: error.dat at rtol 1e-9, the history's residual
    columns at rtol 1e-8, the HDF5 restart's datasets at 1e-11."""
    import h5py
    deck = _short_deck(tmp_path, "deck")
    out1, out4 = str(tmp_path / "run1"), str(tmp_path / "run4")
    argv = [deck, "--f64", "--device", "cpu", "--outdir"]
    assert port_driver.main([*argv, out1]) == 0
    assert port_driver.main([*argv, out4, "--devices", "4"]) == 0
    assert "shards: 4 on cpu x4" in capsys.readouterr().out
    e1 = np.loadtxt(os.path.join(out1, "error.dat"))
    e4 = np.loadtxt(os.path.join(out4, "error.dat"))
    np.testing.assert_allclose(e4, e1, rtol=1e-9, atol=1e-14)
    h1 = np.loadtxt(os.path.join(out1, "history.plt"), skiprows=2)
    h4 = np.loadtxt(os.path.join(out4, "history.plt"), skiprows=2)
    assert h1.shape == h4.shape == (2, 7)
    np.testing.assert_allclose(h4[:, 1:5], h1[:, 1:5], rtol=1e-8,
                               atol=1e-13)
    with h5py.File(os.path.join(out1, "Rest_000000020.h5"), "r") as f1, \
            h5py.File(os.path.join(out4, "Rest_000000020.h5"), "r") as f4:
        floats = [k for k in f1 if isinstance(f1[k], h5py.Dataset)
                  and f1[k].dtype.kind == "f"]
        assert floats
        for k in floats:
            np.testing.assert_allclose(np.asarray(f4[k]), np.asarray(f1[k]),
                                       rtol=1e-11, atol=1e-14)


def test_devices_restart_round_trip(tmp_path, capsys):
    """tests/test_cli_multidevice.py:102-113 on the port: a --devices run
    restarted from its own dump scatters the state back onto the shards
    and continues as the single-device restart does."""
    deck = _short_deck(tmp_path, "deck_a")
    deck2 = _short_deck(tmp_path, "deck_b", n_steps=10,
                        extra=("restart_flag 1", "restart_iter 20",
                               "n_restart_files 1"))
    for name, extra in (("one", []), ("four", ["--devices", "4"])):
        out = str(tmp_path / name)
        for d in (deck, deck2):
            assert port_driver.main([d, "--f64", "--device", "cpu",
                                     "--outdir", out, *extra]) == 0
    assert "restarted from" in capsys.readouterr().out
    e1 = np.loadtxt(str(tmp_path / "one" / "error.dat"))
    e4 = np.loadtxt(str(tmp_path / "four" / "error.dat"))
    assert e4.shape == (2, 4) and np.isfinite(e4).all()
    np.testing.assert_allclose(e4, e1, rtol=1e-9, atol=1e-14)


def test_devices_mixed_deck_matches_single_device(tmp_path, capsys):
    """The tri+quad Gmsh deck as 3 shards (ShardedMixedSolver, its dt
    from the twin): the same monitor rows and files as the single-device
    run."""
    deck = mixed_case(tmp_path)
    argv = [str(deck), "--f64", "--device", "cpu", "--outdir"]
    assert port_driver.main([*argv, str(tmp_path / "one")]) == 0
    one = capsys.readouterr().out
    assert port_driver.main([*argv, str(tmp_path / "three"),
                             "--devices", "3"]) == 0
    three = capsys.readouterr().out
    assert "3 devices" in three
    assert_outputs_match(tmp_path, {"one": one, "three": three},
                         names=("one", "three"))


def test_sharded_probe_owner_slot_sampling():
    """tests/test_cli_multidevice.py:75-99 on the port: a ProbeSet on a
    ShardedSolver samples only the probes' elements from the padded
    (n, El, U, F) state and matches the one on a Solver."""
    from hifiles_tpu_torch import Solver
    from hifiles_tpu_torch.convert import mesh_from
    from hifiles_tpu_torch.io.probes import ProbeSet
    from hifiles_tpu_torch.parallel import ShardedSolver, select_devices
    from test_io_extras import vortex_input
    from hifiles_tpu.mesh.generate import periodic_quad_mesh

    mesh = mesh_from(periodic_quad_mesh(8, 8, -10, 10, -10, 10))
    p = run_input_from(vortex_input())
    s1 = Solver(p, mesh, device="cpu")
    ss = ShardedSolver(run_input_from(vortex_input()), mesh,
                       devices=select_devices(8, "cpu"))
    s1.run(3, dt=p.dt)
    ss.run(3, dt=p.dt)
    pts = np.array([[0.0, 0.0], [3.3, -2.1], [-7.7, 8.8]])
    ps1 = ProbeSet(s1, pts, ["rho", "u", "pressure"])
    ps8 = ProbeSet(ss, pts, ["rho", "u", "pressure"])
    assert ps8._owner_slots is not None
    np.testing.assert_allclose(ps8.sample(), ps1.sample(), rtol=1e-11,
                               atol=1e-14)


def test_patched_mixed_deck_raises(tmp_path):
    """A patch on a mixed mesh: the JAX MixedSolver leaves the state
    unpatched, and the port refuses the deck by name."""
    deck = mixed_case(tmp_path, extra="patch 1\npatch_type 1\npatch_x 0.0\n")
    with pytest.raises(NotImplementedError, match="patch"):
        port_driver.main([str(deck), "--device", "cpu", "--outdir",
                          str(tmp_path / "out")])


def test_usage_without_arguments(capsys):
    assert port_driver.main([]) == 1
    assert "usage: python -m hifiles_tpu_torch" in capsys.readouterr().out


def bench_plain_input():
    """bench.run_tgv("plain")'s RunInput, as bench.py:278-298 builds it
    (without running the benchmark)."""
    p = JaxRunInput()
    p.equation = 0
    p.viscous = 1
    p.order = 4
    p.ic_form = 7
    p.adv_type = 3
    p.riemann_solve_type = 3
    p.dt_type = 0
    p.n_steps = 10
    p.vcjh_scheme_hexa = 1
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.prandtl = 0.72
    p.Mach_free_stream, p.T_free_stream = 0.1, 300.0
    p.rho_free_stream = 0.0008421095852102401
    p.mu_gas = 1.827e-5
    p.L_free_stream = 1.0
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.1, 300.0, 0.0008421095852102401
    p.dt = 1.440389e-5
    p.setup_params()
    return p


# what the driver phase's deck sets beyond bench.run_tgv's RunInput: run
# control and output only
RUN_CONTROL = {"n_steps", "monitor_res_freq", "res_norm_type", "plot_freq",
               "diagnostic_fields", "integral_quantities",
               "restart_dump_freq", "restart_ascii", "mesh_file", "_deck"}


def test_smoke_deck_is_bench_plain(tmp_path):
    """chip_smoke's driver deck parses to bench.run_tgv("plain")'s
    RunInput, attribute for attribute, apart from its run control."""
    (tmp_path / "d").write_text(tgv_deck("tgv16.neu"))
    got = vars(RunInput.from_deck(str(tmp_path / "d")))
    want = vars(run_input_from(bench_plain_input()))
    assert sorted(got) == sorted(want)
    differ = {k for k in got if k not in ("bc_list", "_deck")
              and not np.array_equal(np.asarray(got[k], dtype=object),
                                     np.asarray(want[k], dtype=object))}
    assert differ | {"_deck"} == RUN_CONTROL, differ
    assert got["n_steps"] == 20 and got["res_norm_type"] == 1
    assert got["diagnostic_fields"] == ["vorticity", "q_criterion"]
    assert got["bc_list"] == want["bc_list"] == []

"""The port's benchmark entry point (hifiles_tpu_torch.bench) against the
root bench.py: its copies of bench.py's constants and decks, its cases
against the decks and meshes bench.py's run_* functions build, the f64
residual rows of small twins against the JAX solvers on the CPU, its
cumulative JSON line, its gate and its refusal of unknown names."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

import hifiles_tpu.config.params as jparams
import hifiles_tpu.solver.multiblock as jmultiblock
import hifiles_tpu.solver.solver as jsolver
from hifiles_tpu.mesh.generate import periodic_mixed_mesh_2d

from hifiles_tpu_torch import MixedSolver, RunInput, Solver
from hifiles_tpu_torch import bench as port
from hifiles_tpu_torch.convert import mesh_from, run_input_from

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, ROOT)
import bench as root  # noqa: E402
from test_torch_host_copies import same  # noqa: E402

torch.set_num_threads(1)

# bench.py's metric strings (bench.py:316-318, :340-341, :372-373,
# :402-403), letter for letter
METRICS = {
    "plain": "TGV p=4 hex 16^3 viscous NS DOF*RK-stage/s",
    "overint": "TGV p=4 hex 16^3 viscous NS +overint DOF*RK-stage/s",
    "smag": "TGV p=4 hex 16^3 viscous NS +smag DOF*RK-stage/s",
    "shock": "TGV p=4 hex 16^3 viscous NS +shock DOF*RK-stage/s",
    "rans": "TGV p=4 hex 16^3 viscous NS +rans DOF*RK-stage/s",
    "mixed": "mixed tri+quad 13824c p=4 viscous vortex DOF*RK-stage/s",
    "mixed3d": "mixed prism/tet 8192p+24576t p=2 wall-modeled LES "
               "DOF*RK-stage/s",
    "channel": "forced-channel LES 16^3 p=4 +averaging DOF*RK-stage/s",
}
# bench.py's DOF of each case: E (p+1)^3 on the hexes (bench.py:311,
# :398), REFERENCE_BASELINE.json's for the mixed meshes
DOF = dict(plain=4096 * 125, overint=4096 * 125, smag=4096 * 125,
           shock=4096 * 125, rans=4096 * 125, channel=4096 * 125,
           mixed=253440, mixed3d=393216)


def same_input(p_jax, p_port):
    """The JAX package's RunInput, converted, equals the port's, field by
    field (the parsed deck by its lines)."""
    c = run_input_from(p_jax)
    decks = c._deck, p_port._deck
    c._deck = p_port._deck = None
    try:
        same(c, p_port, "RunInput")
    finally:
        c._deck, p_port._deck = decks
    if decks[0] is not None or decks[1] is not None:
        assert decks[0]._lines == decks[1]._lines
        assert decks[0].name == decks[1].name


def test_constants_equal_bench_py():
    assert port.GOLDENS == root.GOLDENS
    assert port.GATE_RTOL == root.GATE_RTOL
    assert port.ALL_CONFIGS == root.ALL_CONFIGS


@pytest.mark.parametrize("name", root.ALL_CONFIGS)
def test_configure_and_mixed_input_equal_bench_py(name):
    pj, pp = jparams.RunInput(), RunInput()
    if name in ("mixed", "mixed3d", "channel"):
        # configure covers the TGV configurations only, in both
        for f, p in ((root.configure, pj), (port.configure, pp)):
            with pytest.raises(SystemExit):
                f(p, name)
    else:
        root.configure(pj, name)
        port.configure(pp, name)
    same_input(pj, pp)
    same_input(root.mixed_input(), port.mixed_input())


class _Built(Exception):
    pass


def bench_py_case(name, monkeypatch, **env):
    """(RunInput, MeshData, solver class name) that bench.py's run_* hands
    to the JAX solver for configuration ``name`` (``env``: bench.py's size
    knobs): the solver is replaced by a stub that records its arguments
    and stops the run."""
    got = {}

    def stub(cls):
        def build(p, mesh, **kw):
            got.update(p=p, mesh=mesh, cls=cls)
            raise _Built
        return build
    monkeypatch.setattr(jsolver, "Solver", stub("Solver"))
    monkeypatch.setattr(jmultiblock, "MixedSolver", stub("MixedSolver"))
    for k in ("BENCH_ORDER", "BENCH_MESH", "BENCH_STEPS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    run = {"mixed": root.run_mixed, "mixed3d": root.run_mixed3d,
           "channel": root.run_channel}.get(name)
    with pytest.raises(_Built):
        run() if run else root.run_tgv(name)
    return got["p"], got["mesh"], got["cls"]


@pytest.mark.parametrize("name", root.ALL_CONFIGS)
def test_case_equals_bench_py_deck_and_mesh(name, monkeypatch):
    """Each configuration's case at full width: bench.py's deck and mesh,
    solver class, DOF, metric string, and gated."""
    p_jax, mesh_jax, cls = bench_py_case(name, monkeypatch)
    c = port.case(name)
    same_input(p_jax, c.p)
    assert same(mesh_from(mesh_jax), c.mesh, "mesh") >= 5
    assert c.solver is {"Solver": Solver, "MixedSolver": MixedSolver}[cls]
    assert c.dof == DOF[name]
    assert c.metric == METRICS[name]
    assert c.gated


def jax_row(p, mesh, cls, steps):
    """The JAX solver's L1 residual row after steps + steps f64 steps on
    the CPU, bench.py's protocol at ``steps``."""
    s = cls(p, mesh)
    s.run(steps, dt=p.dt)
    s.run(steps, dt=p.dt)
    return s.residual_norm(1)


@pytest.mark.parametrize("name", ["plain", "mixed"])
def test_small_twin_matches_jax(name, monkeypatch):
    """run_config on the CPU in f64, 2 + 2 steps, on small twins of `plain`
    (p=2, 3^3 hexes, bench.py's deck at BENCH_ORDER=2 BENCH_MESH=3) and of
    `mixed` (p=2, 4^2 tri+quad box): the same residual row as the JAX
    solver on the same deck, within 1e-10 * max(scale, 1)
    (tests/test_residual_soa.py:29-36)."""
    if name == "plain":
        p, mesh, _ = bench_py_case("plain", monkeypatch, BENCH_ORDER="2",
                                   BENCH_MESH="3", BENCH_STEPS="2")
        monkeypatch.undo()
        want = jax_row(p, mesh, jsolver.Solver, 2)
        sizes = dict(order=2, n1=3)
    else:
        p = root.mixed_input()
        p.order = 2
        want = jax_row(p, periodic_mixed_mesh_2d(4, 4, -10, 10, -10, 10),
                       jmultiblock.MixedSolver, 2)
        sizes = dict(order=2, n=4)
    r = port.run_config(name, device="cpu", repeats=1, steps=2,
                        dtype=torch.float64, **sizes)
    scale = np.abs(want).max()
    assert np.abs(r["row"] - want).max() < 1e-10 * max(scale, 1.0), (
        r["row"], want)
    assert not r["gated"] and r["value"] > 0 and r["eager"] > 0
    assert r["quartiles"][0] <= r["value"] <= r["quartiles"][1]


SMALL = {"plain": dict(order=1, n1=2), "mixed": dict(order=1, n=2)}


@pytest.mark.parametrize("names", [["plain"], ["mixed"], ["plain", "mixed"]],
                         ids="+".join)
def test_main_prints_bench_py_line(names, monkeypatch, capsys):
    """main's cumulative line after each configuration: bench.py's keys,
    each config entry with `eager` and `quartiles` beside bench.py's, and
    vs_baseline from REFERENCE_BASELINE.json."""
    run = port.run_config
    monkeypatch.setattr(port, "run_config", functools.partial(
        lambda name, **kw: run(name, **SMALL[name], **kw), device="cpu",
        repeats=1, steps=2))
    port.main(names)
    out = capsys.readouterr()
    lines = [json.loads(x) for x in out.out.splitlines()]
    assert len(lines) == len(names)
    with open(os.path.join(ROOT, "REFERENCE_BASELINE.json")) as f:
        ref = json.load(f)
    last = lines[-1]
    keys = {"metric", "value", "unit", "vs_baseline", "gated"}
    if len(names) == 1:
        assert set(last) == keys
        base = (ref["tgv_p4_hex_dof_stage_per_s"] if names == ["plain"]
                else ref["per_config_dof_stage_per_s"][names[0]])
    else:
        assert set(last) == keys | {"configs", "configs_done"}
        assert [x["configs_done"] for x in lines] == ["1/2", "2/2"]
        assert list(last["configs"]) == names
        for k, v in last["configs"].items():
            assert set(v) == {"value", "gated", "vs_baseline", "eager",
                              "quartiles"}
            assert v["vs_baseline"] == pytest.approx(
                v["value"] / ref["per_config_dof_stage_per_s"][k],
                rel=1e-12)
        base = ref["tgv_p4_hex_dof_stage_per_s"]
    assert last["unit"] == "DOF*RK-stage/s" and last["gated"] is False
    assert last["value"] > 0
    assert last["vs_baseline"] == pytest.approx(last["value"] / base,
                                                rel=1e-12)
    for name in names:
        assert f"bench[{name}]: " in out.err
        assert f"bench[{name}] volume_tdisf launches: " in out.err


@pytest.mark.parametrize("name", root.ALL_CONFIGS)
def test_gate(name):
    """Rows within the rtol pass; a row off by more raises; the channel's
    row 3 passes at 0.2 and fails at 0.3."""
    gold = np.asarray(root.GOLDENS[name])
    rtol = root.GATE_RTOL.get(name, 5e-3)
    port.gate(name, gold * (1 + 0.5 * rtol))
    for i in range(len(gold)):
        row = gold.copy()
        row[i] *= 1 + 2 * rtol
        if name == "channel" and i == 3:
            port.gate(name, row)
            continue
        with pytest.raises(AssertionError):
            port.gate(name, row)
    with pytest.raises(AssertionError):
        port.gate(name, np.where(np.arange(len(gold)) == 0, np.nan, gold))
    if name == "channel":
        row = gold.copy()
        row[3] *= 1.2
        port.gate(name, row)
        row[3] = gold[3] * 1.3
        with pytest.raises(AssertionError):
            port.gate(name, row)


@pytest.mark.parametrize("argv", [["plainx"], ["plain", "nope"],
                                  ["--device", "cpu"]])
def test_unknown_config_exits(argv, monkeypatch):
    """An unknown name exits before any configuration runs."""
    monkeypatch.setattr(port, "run_config", None)
    with pytest.raises(SystemExit):
        port.main(argv)


def test_no_cuda_raises():
    """Without a GPU the default device raises (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port.run_config("plain", order=1, n1=2)

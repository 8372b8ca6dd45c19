"""The channel at Re_tau = 395 (configs/channel_retau395.json) and its
three readers on a synthetic run.

- the configuration: the test channel deck (channel_deck.json) with only
  the viscosity, the time step, the CFL note and the monitor's cadence
  changed; rho U_b delta / mu = 6,875 (Re_b = 13,750); the cell lists
  the three readers and reports them alone among the cells;
- the readers on test_h100_program_trace's synthetic record, the step's
  graph given two residual.boundary ranges (the boundary states before
  the gradient, the boundary common flux after the interior one) and the
  rows a mass-flux span: ``boundary_ms_per_step`` sums both ranges'
  device time per step, ``boundary_kernels_per_stage`` counts their
  operations per RK stage, ``massflux_ms`` is the span's host ms per row
  of the untraced chunk; a program that marks no boundary part (the
  periodic box, or a program without the part) reads None for the first
  two and the mass flux as before; one replay short of the graph, or no
  program record, reads None.
"""

import json
import math
import os

import pytest

from bench_h100 import program_trace as pt
from bench_h100 import spec
from bench_h100.reference import physics

from . import test_h100_program_trace as base

HERE = os.path.dirname(os.path.abspath(__file__))
CELL = "channel_retau395.mon50"
READERS = ("boundary_ms_per_step", "boundary_kernels_per_stage",
           "massflux_ms")
CHANGED = {"mu_gas", "dt", "CFL", "monitor_res_freq"}

# the walled step's graph: part -> its nodes' kernel names
GRAPH = [("step.pre", ["force_a"]),
         ("residual.face_states", ["gemm_a", "index_b"]),
         ("residual.boundary", ["index_bb", "ghost_c", "ldg_d"]),
         ("residual.gradient", ["gemm_c", "mul_d", "add_e"]),
         ("residual.volume", ["volume_tdisf_f"]),
         ("residual.common_flux", ["hllc_g"]),
         ("residual.boundary", ["hllc_bg", "visc_bh"]),
         ("residual.divergence", ["index_h", "gemm_i"]),
         ("step.update", ["axpy_j"]),
         ("step.post", ["avg_k"])]
BOUNDARY = 5                      # nodes in residual.boundary a step


def test_configuration_is_the_channel_deck_at_re_tau_395():
    conf = json.load(open(os.path.join(spec.ROOT, "bench_h100", "configs",
                                       "channel_retau395.json")))
    deck = json.load(open(os.path.join(HERE, "channel_deck.json")))["deck"]
    assert set(conf["deck"]) == set(deck)
    assert {k for k in deck if conf["deck"][k] != deck[k]} == CHANGED
    assert conf["mesh"] == dict(n=[32, 40, 32], lo=[0.0, 0.0, 0.0],
                                hi=[2 * math.pi, 2.0, math.pi], walls=True)
    assert conf["reduced"] == [] and conf["precision"] == "float32"
    ph = physics(conf["deck"])
    # the bulk velocity and density are the reference's: Re_b / 2 = 1/mu
    assert ph["vel_ic"][0] == pytest.approx(1.0)
    assert ph["rho_ic"] == pytest.approx(1.0)
    assert 1.0 / ph["mu"] == pytest.approx(6875.0, rel=1e-9)
    # the acoustic CFL (2p + 1) (|u| + c) dt / h_y on the wall-normal axis
    c = 1.0 / float(conf["deck"]["Mach_free_stream"])
    cfl = 9 * (1.0 + c) * ph["dt"] / (2.0 / 40)
    assert cfl == pytest.approx(float(conf["deck"]["CFL"]), rel=0.01)
    assert ph["les"] and ph["forcing"] and ph["bf_type"] == 1
    assert len(ph["average_fields"]) == 5
    assert set(conf["limits"]) == {"step", "row", "ke", "avg"}


def test_cell_reports_the_three_readers():
    bench = spec.load()
    cell = spec.Cell(bench, CELL)
    assert cell.chips == 1 and cell.traffic["name"] == "mon50"
    assert set(READERS) <= set(cell.per_layer)
    assert "k1_roofline_pct" in cell.per_layer
    assert "dof_stage_per_s" in cell.e2e
    for w in bench["workloads"]:
        if w["name"] != CELL:
            other = spec.Cell(bench, w["name"])
            assert not set(READERS) & set(other.per_layer)
    for name in READERS:
        assert callable(spec.reader(name))


@pytest.fixture
def walled(monkeypatch):
    monkeypatch.setattr(base, "GRAPH", GRAPH)
    monkeypatch.setattr(base, "NODES", sum(len(k) for _, k in GRAPH))


def with_massflux(prog, ms=30.0):
    """The program's record with a massflux span after each chunk's
    monitor row."""
    ns = lambda t: int(round(t * 1e9))
    for i, c0 in enumerate((base.T0, base.T0 + 1.0)):
        prog["spans"].append(base.Span(1000 + i, "massflux", None,
                                       ns(c0 + 0.401),
                                       ns(c0 + 0.401 + ms * 1e-3)))
    return prog


def readings(monkeypatch, rec, prog):
    monkeypatch.setattr(pt, "program_record", lambda: prog)
    return {name: spec.reader(name)(rec) for name in READERS}


@pytest.mark.parametrize("stages", [1, 5])
def test_sound_walled_run(monkeypatch, walled, stages):
    rec = base.bench_record()
    rec.n_stages = stages
    got = readings(monkeypatch, rec, with_massflux(base.program()))
    assert got["boundary_ms_per_step"] == pytest.approx(
        BOUNDARY * 10 * base.US * 1e3)
    assert got["boundary_kernels_per_stage"] == pytest.approx(
        BOUNDARY / stages)
    assert got["massflux_ms"] == pytest.approx(30.0)
    ops, _ = pt.replay_parts(rec, base.program())
    assert {o.name for o in ops["residual.boundary"]} == {
        "index_bb", "ghost_c", "ldg_d", "hllc_bg", "visc_bh"}


def test_no_boundary_part_reads_none(monkeypatch):
    """The periodic box's graph (test_h100_program_trace's), or the
    walled step of a program that does not mark the part."""
    got = readings(monkeypatch, base.bench_record(),
                   with_massflux(base.program()))
    assert got["boundary_ms_per_step"] is None
    assert got["boundary_kernels_per_stage"] is None
    assert got["massflux_ms"] == pytest.approx(30.0)


def test_no_forcing_no_massflux(monkeypatch, walled):
    got = readings(monkeypatch, base.bench_record(), base.program())
    assert got["massflux_ms"] is None
    assert got["boundary_ms_per_step"] is not None


def test_short_replay_or_no_record_reads_none(monkeypatch, walled):
    rec = base.bench_record(drop=2 * base.NODES + 3)
    got = readings(monkeypatch, rec, with_massflux(base.program()))
    assert got["boundary_ms_per_step"] is None
    assert got["boundary_kernels_per_stage"] is None
    got = readings(monkeypatch, base.bench_record(), None)
    assert all(v is None for v in got.values())

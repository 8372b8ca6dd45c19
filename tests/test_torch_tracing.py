"""The port's own tracing (hifiles_tpu_torch/tracing.py) on the CPU:

- spans nest, name their parents, keep a bounded ring and aggregates
  that nothing evicts, and a span inside one of its own name adds nothing
  to its aggregate;
- without a profiler a span opens no profiler range; under
  torch.profiler every span is a range ``hf.<name>`` nested as the
  record nests it;
- a 4^3 TGV Solver's ``setup.*`` spans cover its constructor, and the
  history writer's row its five ``monitor.*`` parts;
- a capture through tests/test_torch_graph.py's stand-in graph, its
  nodes counted by a stand-in that counts the step's tensor operations,
  gives part ranges that tile [0, captured_nodes): every operation of the
  captured step lies in one part; residual.boundary is there exactly
  where the mesh has boundary faces, whose count (2 nx nz in a channel)
  is the counter ``boundary_faces``;
- the driver's ``wall seconds:`` line keeps its parts and ``--profile``
  still writes its trace, whose ``hf.*`` ranges nest as the record;
- the hand kernels' launch counts: every registered kernel in the record
  by its number, a capture holds its launches (also one that cannot
  count nodes, and keeps no capture then), each replay counts them, and
  reset zeroes them (a launches-only reset, them alone).
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import hifiles_tpu_torch
from hifiles_tpu_torch import tracing
from hifiles_tpu_torch.convert import run_input_from
from hifiles_tpu_torch.io.history import HistoryWriter

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import test_torch_graph as graph_tests  # noqa: E402
from test_face_path import tgv_input  # noqa: E402
from test_torch_featured import channel_twin  # noqa: E402
from trace_torch import matches_trace  # noqa: E402

torch.set_num_threads(1)

PARTS = {"step.pre", "step.update", "step.post", "residual.face_states",
         "residual.gradient", "residual.volume", "residual.common_flux",
         "residual.divergence", "residual.halo", "residual.boundary"}


@pytest.fixture(autouse=True)
def empty_record():
    tracing.reset()
    yield
    tracing.reset()


def spans_named(rec, name):
    return [s for s in rec["spans"] if s.name == name]


def children(rec, parent):
    return [s for s in rec["spans"] if s.parent == parent.id]


def test_launch_record_lists_every_kernel_by_number():
    launches = tracing.record()["launches"]
    numbers = [tracing._rec.kernels[k][0] for k in launches]
    assert numbers == sorted(numbers)
    assert set(launches) == set(tracing._rec.kernels) >= {
        "volume_tdisf", "flux_point_qn", "solution_point_gradient",
        "common_flux"}
    assert launches["volume_tdisf"] == dict(
        launches=0, by_variant={}, segments=0, by_shape={}, by_group={})
    assert launches["common_flux"] == dict(launches=0, by_variant={})


@pytest.mark.parametrize("nodes", [False, True], ids=["cannot count",
                                                      "counts nodes"])
def test_a_capture_holds_its_launches_for_each_replay(nodes):
    tracing.launch("common_flux", "a")
    with tracing.capture((lambda: 7) if nodes else None) as held:
        tracing.launch("common_flux", "a")
        tracing.launch("volume_tdisf", "v", [(3, 4), (2, 5)])
    rec = tracing.record()
    assert rec["launches"]["common_flux"]["launches"] == 1
    assert rec["launches"]["volume_tdisf"]["launches"] == 0
    assert len(rec["captures"]) == int(nodes)
    assert rec["counters"].get("captured_nodes") == (7 if nodes else None)
    for _ in range(3):
        tracing.replay(held)
    launches = tracing.record()["launches"]
    assert launches["common_flux"] == dict(launches=4, by_variant={"a": 4})
    assert launches["volume_tdisf"] == dict(
        launches=3, by_variant={"v": 3}, segments=6,
        by_shape={("v", 3, 4): 3, ("v", 2, 5): 3},
        by_group={("v", ((2, 5), (3, 4))): 3})
    tracing.reset()
    assert all(c["launches"] == 0 and not c["by_variant"]
               for c in tracing.record()["launches"].values())


def test_a_launches_only_reset_keeps_the_rest_of_the_record():
    """reset(launches_only=True) zeroes the launch counts and keeps the
    spans, totals, counters and captures (set-up's, which a reader of the
    record after set-up needs)."""
    with tracing.span("setup.x"):
        pass
    tracing.counter("boundary_faces", 12)
    with tracing.capture(lambda: 3):
        pass
    tracing.launch("common_flux", "a")
    before = tracing.record()
    tracing.reset(launches_only=True)
    after = tracing.record()
    assert after["launches"]["common_flux"] == dict(launches=0,
                                                    by_variant={})
    assert before["launches"]["common_flux"]["launches"] == 1
    for key in ("spans", "totals", "counters", "captures"):
        assert after[key] == before[key]
    assert after["counters"] == dict(boundary_faces=12, captured_nodes=3)


def test_spans_nest_and_name_their_parents():
    with tracing.span("a"):
        with tracing.span("b"):
            with tracing.span("c"):
                pass
        with tracing.span("b"):
            pass
    with tracing.span("d"):
        pass
    rec = tracing.record()
    (a,), (d,) = spans_named(rec, "a"), spans_named(rec, "d")
    b1, b2 = spans_named(rec, "b")
    (c,) = spans_named(rec, "c")
    assert a.parent is None and d.parent is None
    assert b1.parent == b2.parent == a.id and c.parent == b1.id
    assert a.start_ns <= b1.start_ns <= c.start_ns <= c.end_ns <= b1.end_ns \
        <= b2.start_ns <= b2.end_ns <= a.end_ns <= d.start_ns
    assert rec["totals"]["b"][0] == 2
    assert rec["totals"]["b"][1] == sum(s.end_ns - s.start_ns
                                        for s in (b1, b2))
    assert rec["totals"]["b"][2] == max(s.end_ns - s.start_ns
                                        for s in (b1, b2))


def test_the_ring_is_bounded_and_the_aggregates_are_not():
    with tracing.span("x") as first:
        pass
    for _ in range(tracing.RING + 9):
        with tracing.span("x"):
            pass
    rec = tracing.record()
    assert len(rec["spans"]) == tracing.RING
    assert rec["totals"]["x"][0] == tracing.RING + 10
    # the oldest ten went, the rest are kept in order
    assert [s.id for s in rec["spans"]] == list(
        range(first.id + 10, first.id + 10 + tracing.RING))


def test_a_span_inside_its_own_name_adds_nothing_to_the_aggregate():
    with tracing.span("monitor") as outer:
        with tracing.span("monitor"):
            time.sleep(0.001)
    rec = tracing.record()
    assert len(spans_named(rec, "monitor")) == 2
    count, total, _ = rec["totals"]["monitor"]
    assert count == 1 and total == outer.end_ns - outer.start_ns
    assert outer.seconds == pytest.approx(total * 1e-9)


def test_no_profiler_no_range(monkeypatch):
    made = []
    real = tracing._RecordFunctionFast
    monkeypatch.setattr(tracing, "_RecordFunctionFast",
                        lambda name: made.append(name) or real(name))
    with tracing.span("a"), tracing.part("b"):
        pass
    assert made == []
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            pass
    assert made == ["hf.a"]


def small_tgv(order=2, n=4):
    """The 4^3 TGV (p=2) deck and mesh, with the kinetic energy
    monitored."""
    p = run_input_from(tgv_input())
    p.order = order
    p.integral_quantities = ["kineticenergy"]
    return p, hifiles_tpu_torch.periodic_hex_mesh(n, n, n)


def test_profiler_ranges_nest_as_the_record():
    from torch.profiler import ProfilerActivity, profile
    p, mesh = small_tgv()
    s = hifiles_tpu_torch.Solver(p, mesh, device="cpu")
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("outer"):
            s.run(1, dt=p.dt)
    rec = tracing.record()
    by_id = {x.id: x.name for x in rec["spans"]}
    want = sorted((x.name, by_id.get(x.parent)) for x in rec["spans"])
    got = []
    for e in prof.events():
        if not e.name.startswith("hf."):
            continue
        up = e.cpu_parent
        while up is not None and not up.name.startswith("hf."):
            up = up.cpu_parent
        got.append((e.name[3:], None if up is None else up.name[3:]))
    assert sorted(got) == want
    assert {"run", "step.update", "residual.gradient"} <= {n for n, _ in got}


def test_solver_setup_spans_cover_the_constructor():
    p, mesh = small_tgv()
    t0 = time.perf_counter()
    hifiles_tpu_torch.Solver(p, mesh, device="cpu")
    wall = time.perf_counter() - t0
    rec = tracing.record()
    (setup,) = spans_named(rec, "setup")
    kids = children(rec, setup)
    assert {k.name for k in kids} == {
        "setup.faces", "setup.geometry", "setup.residual", "setup.loop",
        "setup.initial_state"}
    assert sum(k.end_ns - k.start_ns for k in kids) * 1e-9 >= 0.9 * wall
    (faces,) = spans_named(rec, "setup.faces")
    assert {k.name for k in children(rec, faces)} == {
        "setup.faces.interior", "setup.faces.cyclic"}


def test_history_row_records_its_five_parts(tmp_path):
    p, mesh = small_tgv()
    s = hifiles_tpu_torch.Solver(p, mesh, device="cpu")
    tracing.reset()
    HistoryWriter(str(tmp_path / "history.plt"), s).write(1)
    rec = tracing.record()
    (row,) = spans_named(rec, "monitor")
    kids = children(rec, row)
    assert [k.name for k in kids] == [
        "monitor.residual", "monitor.to_host", "monitor.norm",
        "monitor.integrals", "monitor.to_host", "monitor.write"]
    assert sum(k.end_ns - k.start_ns for k in kids) >= \
        0.9 * (row.end_ns - row.start_ns)


class OperationCount(TorchDispatchMode):
    """A stand-in for the graph's node count on the CPU: the tensor
    operations the step runs, views and allocations left out (a CUDA
    graph records neither as a node)."""

    FREE = {torch.ops.aten.empty.memory_format,
            torch.ops.aten.empty_strided.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func not in self.FREE:
            self.n += 1
        return func(*args, **(kwargs or {}))


class CountingGraph(graph_tests.IdentityGraph):
    """IdentityGraph whose capture counts the step's operations, which
    ``count_nodes`` reads as graph.CudaStepGraph's reads its graph's
    nodes."""

    def capture(self, body):
        self.ops = OperationCount()

        def counted():
            with self.ops:
                body()
        super().capture(counted)

    def count_nodes(self):
        return self.ops.n


def walled_channel():
    """The channel twin's deck on a 3 x 4 x 2 channel: 2 * 3 * 2 wall
    faces, none of the other axes' counts."""
    from hifiles_tpu.mesh.generate import channel_hex_mesh
    p, _ = channel_twin(spinup_steps=1.5)
    s = graph_tests.port(p, channel_hex_mesh(3, 4, 2))
    return s, p, p.dt


# boundary faces of the walled configurations: 2 nx nz in a channel
WALL_FACES = {"channel_twin": 2 * 4 * 2, "walled_channel": 2 * 3 * 2}


@pytest.mark.parametrize("name", ["plain", "channel_twin", "svv", "shock",
                                  "sem_replay_draws", "mixed_tri_quad",
                                  "tgv_4_shards", "walled_channel"])
def test_captured_parts_tile_the_graph(name):
    s, p, dt = (walled_channel() if name == "walled_channel"
                else graph_tests.build(name, seam=False))
    CountingGraph.seam(s)
    s.run(3, dt=dt)
    rec = tracing.record()
    (cap,) = rec["captures"]
    parts = cap["parts"]
    assert cap["nodes"] > 0 and rec["counters"]["captured_nodes"] == \
        cap["nodes"]
    assert parts[0][1] == 0 and parts[-1][2] == cap["nodes"]
    assert all(a[2] == b[1] for a, b in zip(parts, parts[1:]))
    assert all(a <= b for _, a, b in parts)
    names = {n for n, _, _ in parts}
    assert names <= PARTS
    assert {"residual.face_states", "residual.gradient", "residual.volume",
            "residual.common_flux", "residual.divergence",
            "step.update"} <= names
    faces = rec["counters"]["boundary_faces"]
    assert ("residual.boundary" in names) is (faces > 0)
    if name in WALL_FACES:
        assert faces == WALL_FACES[name]
    if name in ("plain", "svv", "shock", "mixed_tri_quad", "tgv_4_shards"):
        assert faces == 0
    assert s.capture_seconds == pytest.approx(
        (spans_named(rec, "run.capture")[0].end_ns
         - spans_named(rec, "run.capture")[0].start_ns) * 1e-9)
    # nothing is counted outside a capture, nor by a replay
    assert len(rec["captures"]) == 1
    assert [x.name for x in spans_named(rec, "run.replays")] == \
        ["run.replays"]


def test_driver_wall_line_and_profile_trace(tmp_path, capsys):
    from chip_smoke import tgv_deck
    from hifiles_tpu_torch.driver import main
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    write_gambit(hifiles_tpu_torch.periodic_hex_mesh(2, 2, 2),
                 str(tmp_path / "box.neu"))
    deck = tmp_path / "run.deck"
    deck.write_text(tgv_deck("box.neu", order=1, n_steps=4,
                             monitor_res_freq=2, plot_freq=4,
                             restart_dump_freq=4))
    out_dir = tmp_path / "out"
    assert main([str(deck), "--device", "cpu", "--outdir", str(out_dir),
                 "--profile"]) == 0
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("wall seconds: ")]
    wall = json.loads(line[0][len("wall seconds: "):])
    assert set(wall) == {"mesh read", "solver set-up", "first chunk",
                         "steps", "monitor", "vtu", "restart write"}
    assert all(v > 0 for v in wall.values())
    rec = tracing.record()
    assert wall["monitor"] == pytest.approx(rec["totals"]["monitor"][1]
                                            * 1e-9)
    trace = out_dir / "torch_trace"
    assert trace.exists()
    assert matches_trace(str(trace), rec["spans"])
    assert np.isfinite(wall["steps"])

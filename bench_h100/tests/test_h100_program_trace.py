"""The readers of the program's own spans and counters
(program_trace.py and the nine metrics that read it) on a synthetic run:
the program's record (tracing.record()'s layout) beside the benchmark's
record of a traced chunk and an untraced one.  Sound, every metric reads
its value; with the clocks apart by more than ALIGN_S the offset and the
idle gaps named by program spans read None, and the metrics, which use
no clock, read as before; with one replay short of the captured graph's
nodes, or the capture after the traced chunk, the device-trace readings
are None; with no program record (a program without the tracing module),
all nine are None."""

import collections
import types

import pytest

from bench_h100 import program_trace as pt
from bench_h100 import spec
from bench_h100.trace import DeviceOp, HostRange

Span = collections.namedtuple("Span", "id name parent start_ns end_ns")

# the step's graph: part -> its nodes' kernel names, in capture order
GRAPH = [("step.pre", []),
         ("residual.face_states", ["gemm_a", "index_b"]),
         ("residual.gradient", ["gemm_c", "mul_d", "add_e"]),
         ("residual.volume", ["volume_tdisf_f"]),
         ("residual.common_flux", ["hllc_g"]),
         ("residual.divergence", ["index_h", "gemm_i"]),
         ("step.update", ["axpy_j"])]
NODES = sum(len(k) for _, k in GRAPH)          # 11
STEPS = 4
OFFSET = -70.0            # trace clock = host clock + OFFSET (seconds)
US = 1e-6
T0 = 100.0                # the traced chunk's start, host clock


def program(captured_at=T0 - 5.0):
    """The program's record: set-up, the capture, and per chunk its run
    and monitor row with their parts (host clock, ns)."""
    spans, parts, node = [], [], 0
    for name, kernels in GRAPH:
        parts.append((name, node, node + len(kernels)))
        node += len(kernels)
    ns = lambda t: int(round(t * 1e9))
    i = 0

    def add(name, a, b, parent=None):
        nonlocal i
        spans.append(Span(i, name, parent, ns(a), ns(b)))
        i += 1
        return i - 1

    for c0 in (T0, T0 + 1.0):          # traced chunk, untraced chunk
        add("compute_dt", c0 + 0.001, c0 + 0.002)
        r = add("run", c0 + 0.003, c0 + 0.010)
        add("run.replays", c0 + 0.004, c0 + 0.009, r)
        m = add("monitor", c0 + 0.100, c0 + 0.400)
        add("monitor.residual", c0 + 0.100, c0 + 0.110, m)
        add("monitor.to_host", c0 + 0.110, c0 + 0.200, m)
        add("monitor.norm", c0 + 0.200, c0 + 0.250, m)
        add("monitor.to_host", c0 + 0.250, c0 + 0.300, m)
        add("monitor.integrals", c0 + 0.300, c0 + 0.390, m)
        add("monitor.write", c0 + 0.390, c0 + 0.399, m)
    totals = {"setup": (1, ns(170.0), ns(170.0)),
              "setup.faces": (1, ns(100.0), ns(100.0)),
              "setup.geometry": (1, ns(15.0), ns(15.0))}
    return dict(spans=spans, totals=totals,
                counters={"captured_nodes": NODES},
                captures=[dict(start_ns=ns(captured_at), nodes=NODES,
                               parts=parts)])


def bench_record(shift=0.0, drop=None):
    """The benchmark's record of a traced chunk (STEPS replayed steps of
    the graph, the dt copy before them, its ranges on the trace clock,
    the benchmark range ``run`` moved by ``shift`` s) and an untraced
    one; ``drop``: the index of one replayed operation left out."""
    kernels = [k for _, ks in GRAPH for k in ks]
    ops, t = [], T0 + 0.005 + OFFSET
    ops.append(DeviceOp(0, "fill_dt", t, t + 2 * US, None))
    t += 5 * US
    for _ in range(STEPS):
        for k in kernels:
            ops.append(DeviceOp(0, k, t, t + 10 * US, None))
            t += 12 * US
    if drop is not None:
        del ops[1 + drop]
    # the monitor row's residual and its copy to the host
    for t in (T0 + 0.105 + OFFSET, T0 + 0.26 + OFFSET):
        ops.append(DeviceOp(0, "monitor_kernel", t, t + 10 * US, None))
    spans, ranges = [], []
    for name, a, b in (("chunk", T0, T0 + 0.5),
                       ("compute_dt", T0 + 0.0009, T0 + 0.0021),
                       ("run", T0 + 0.0029, T0 + 0.0101),
                       ("monitor", T0 + 0.0999, T0 + 0.4001)):
        spans.append((name, a, b))
        move = shift if name == "run" else 0.0
        ranges.append(HostRange(name, a + OFFSET - 2 * US + move,
                                b + OFFSET + 2 * US + move))
    c1 = T0 + 1.0
    spans += [("chunk", c1, c1 + 0.5), ("monitor", c1 + 0.0999,
                                        c1 + 0.4001)]
    chunks = [dict(steps=STEPS, t0=T0, t1=T0 + 0.5, issued=0.001,
                   traced=True),
              dict(steps=STEPS, t0=c1, t1=c1 + 0.5, issued=0.001,
                   traced=False)]
    return types.SimpleNamespace(ops=ops, ranges=ranges, spans=spans,
                                 chunks=chunks, n_stages=1, chips=1)


HOST = ("face_pairing_s", "geometry_s", "monitor_copy_ms",
        "monitor_numpy_ms")
DEVICE = ("face_states_ms_per_step", "gradient_ms_per_step",
          "common_flux_ms_per_step", "divergence_ms_per_step",
          "rk_update_ms_per_step")


def readings(monkeypatch, rec, prog):
    monkeypatch.setattr(pt, "program_record", lambda: prog)
    return {name: spec.reader(name)(rec) for name in HOST + DEVICE}


def test_sound_run_reads_every_metric(monkeypatch):
    rec = bench_record()
    got = readings(monkeypatch, rec, program())
    assert got["face_pairing_s"] == pytest.approx(100.0)
    assert got["geometry_s"] == pytest.approx(15.0)
    # one row in the untraced chunk: to_host 90 + 50 ms, numpy 50 + 90 ms
    assert got["monitor_copy_ms"] == pytest.approx(140.0)
    assert got["monitor_numpy_ms"] == pytest.approx(140.0)
    per = lambda n: n * 10 * US * 1e3          # ms of n 10-us kernels
    assert got["face_states_ms_per_step"] == pytest.approx(per(2))
    assert got["gradient_ms_per_step"] == pytest.approx(per(3))
    assert got["common_flux_ms_per_step"] == pytest.approx(per(1))
    assert got["divergence_ms_per_step"] == pytest.approx(per(2))
    assert got["rk_update_ms_per_step"] == pytest.approx(per(1))
    assert pt.clock_offset(rec) == pytest.approx(OFFSET - 2 * US)
    # the chunk's own range opens late (the profiler's first): no matter
    rec.ranges[0] = rec.ranges[0]._replace(start=rec.ranges[0].start
                                           + 300 * US)
    assert pt.clock_offset(rec) == pytest.approx(OFFSET - 2 * US)
    ops, steps = pt.replay_parts(rec, program())
    assert steps == STEPS
    assert sum(len(v) for v in ops.values()) == STEPS * NODES
    assert {o.name for o in ops["residual.volume"]} == {"volume_tdisf_f"}
    # idle between the replays' kernels (in run.replays), from the
    # replays to the residual (no program span), from the residual to the
    # copy (in the first monitor.to_host), then to the chunk's end (its
    # midpoint in monitor.integrals)
    gaps = dict(pt.idle_gaps(rec, program()))
    assert set(gaps) == {"run.replays", "other", "monitor.to_host",
                         "monitor.integrals"}
    assert gaps["run.replays"] == pytest.approx(
        (STEPS * NODES - 1) * 2 * US + 3 * US)
    assert gaps["monitor.to_host"] == pytest.approx(0.155, abs=1e-4)
    assert gaps["monitor.integrals"] == pytest.approx(0.24, abs=1e-4)
    rep = pt.report(rec, program())
    assert rep["captured_nodes"] == NODES
    assert rep["replay_ms_per_step"]["residual.volume"]["ops"] == 1


def test_misaligned_clock_names_no_gap(monkeypatch):
    rec = bench_record(shift=150 * US)
    assert pt.clock_offset(rec) is None
    devs = dict(pt.clock_deviations(rec)[1])
    assert devs["run"] == pytest.approx(150 * US)
    assert devs["monitor"] == pytest.approx(0.0, abs=1e-9)
    assert pt.idle_gaps(rec, program()) is None
    assert pt.report(rec, program())["idle_gaps_s"] is None
    # no reading places a span on the trace's clock: the parts go by
    # their place in the step's graph, the host readings by the host clock
    got = readings(monkeypatch, rec, program())
    assert got == readings(monkeypatch, bench_record(), program())
    assert None not in got.values()


def test_replay_short_of_the_graph_reads_none(monkeypatch):
    rec = bench_record(drop=2 * NODES + 3)
    assert pt.clock_offset(rec) is not None
    assert pt.replay_parts(rec, program()) is None
    got = readings(monkeypatch, rec, program())
    assert all(got[name] is None for name in DEVICE)


def test_program_without_tracing_reads_none(monkeypatch):
    got = readings(monkeypatch, bench_record(), None)
    assert all(v is None for v in got.values())


def test_a_capture_after_the_traced_chunk_is_not_the_one_replayed(
        monkeypatch):
    got = readings(monkeypatch, bench_record(),
                   program(captured_at=T0 + 0.7))
    assert all(got[name] is None for name in DEVICE)

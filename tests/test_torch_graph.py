"""The port's compiled run chunk on the CPU: BlockLoop._make_run_chunk, one
time step captured once and replayed (a CUDA graph on the card,
solver/graph.py), the counterpart of the JAX package's jitted lax.scan
chunk (hifiles_tpu/solver/solver.py:273-482, multiblock.py:724-840).

The card's capture cannot run here, so the runner's capture seam
(``BlockLoop._step_graph``) takes ``IdentityGraph``, which does on the CPU
what a CUDA graph does to the solver: a capture runs the step's Python
once (its host-side effects happen once, its tensor effects are undone:
a capture runs no kernel) and a replay runs the step again with no host
call counted.  Both refuse host syncs (``no_host_syncs``), which would
break a capture on the card.  Then:
  (a) capture safety: the step makes no host sync and keeps its buffers
      (state, register, featured carry, inlet state) across steps,
      ``restore`` and ``set_state``, in every configuration the chunk
      runs: plain, the channel's small twin (forcing, averages), a ramped
      inflow, SVV, shock capture, SEM with DeviceDraws and ReplayDraws,
      white noise with ReplayDraws (each step's draws enter its state),
      dt_type 2, the tri+quad MixedSolver and the 4^3 TGV in 4 shards;
  (b) the runner's bookkeeping, bit for bit against the eager loop
      (``run(..., graph=False)``): chunks of several calls, a new dt
      without a new capture, a new dt kind or draw object with one,
      snapshot/restore between calls, each hand kernel's launch counts
      once per replayed step;
  (c) parity: the captured runner in f64 against the JAX Solver,
      MixedSolver and ShardedSolver chunks for 3 steps on the same numpy
      inputs, at tests/test_residual_soa.py's 1e-10 * max(scale, 1).
"""

import contextlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifiles_tpu.mesh.generate import (periodic_hex_mesh,
                                       periodic_mixed_mesh_2d)
from hifiles_tpu.parallel.sharding import ShardedSolver as JaxShardedSolver
from hifiles_tpu.solver.multiblock import MixedSolver as JaxMixedSolver
from hifiles_tpu.solver.solver import Solver as JaxSolver

import hifiles_tpu_torch
from hifiles_tpu_torch import tracing
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.parallel import ShardedSolver, select_devices
from hifiles_tpu_torch.solver import common_flux, ldg_element, volume
from hifiles_tpu_torch.solver.turb_inlet import DeviceDraws, ReplayDraws

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402
from test_mixed import vortex_input  # noqa: E402
from test_torch_featured import channel_twin, ramped_duct  # noqa: E402
from test_torch_features import deck  # noqa: E402
from test_torch_turb_inlet import duct_3d, jax_draws  # noqa: E402

torch.set_num_threads(1)

SYNCS = ("item", "__bool__", "__float__", "__int__", "tolist", "numpy")


@contextlib.contextmanager
def no_host_syncs():
    """Tensor methods that wait for the device (and abort a capture on
    the card) raise."""
    saved = {name: getattr(torch.Tensor, name) for name in SYNCS}

    def refuse(name):
        def f(*args, **kwargs):
            raise AssertionError(f"host sync in the captured step: "
                                 f"Tensor.{name}")
        return f
    try:
        for name in SYNCS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


class IdentityGraph:
    """graph.CudaStepGraph's stand-in on the CPU for ``solver``: a capture
    runs the step's Python once, then returns the solver to where it was
    (a CUDA capture runs no kernel); a replay runs the step with its
    launches held, as a capture holds them (a replay makes no host call:
    the runner counts it).  ``captures`` counts the captures of every
    IdentityGraph."""

    captures = 0

    def __init__(self, solver, device, generators):
        self.solver, self.generators = solver, list(generators)

    @classmethod
    def seam(cls, solver):
        """Set ``solver``'s capture seam to this class."""
        solver._step_graph = lambda device, gens: cls(solver, device, gens)
        return solver

    def warm_up(self, body):
        body()

    def capture(self, body):
        IdentityGraph.captures += 1
        snap = self.solver.snapshot()
        with no_host_syncs():
            body()
        self.solver.restore(snap)

    def replay(self, body):
        with no_host_syncs(), tracing.capture(None):
            body()

    def release(self):
        pass


def port(p, mesh, cls=None, **kw):
    """The port's solver ``cls`` (default Solver) on the CPU, f64."""
    cls = cls or hifiles_tpu_torch.Solver
    if cls is not ShardedSolver:
        kw["device"] = "cpu"
    return cls(run_input_from(p), mesh_from(mesh), **kw)


def inlet_duct(draws, inlet_type=2):
    """The 4^3 duct (p=2) with a SEM (40 eddies) or white-noise inlet and
    the draw object ``draws`` ("device" or "replay": one numpy stream of
    12 steps)."""
    def make():
        p, mesh = duct_3d(inlet_type, 40, 4)
        p.order = 2
        return p, mesh, draws
    return make


def local_dt_tgv():
    p = tgv_input()
    p.order, p.dt_type, p.CFL = 2, 2, 0.5
    return p, periodic_hex_mesh(4, 4, 4)


def mixed_box():
    return (vortex_input(order=2, viscous=1),
            periodic_mixed_mesh_2d(4, 4, -10, 10, -10, 10))


def sharded_tgv():
    p = tgv_input()
    p.order = 2
    return p, periodic_hex_mesh(4, 4, 4)


def _p2(make):
    def f():
        p, mesh = make()
        p.order = 2
        return p, mesh
    return f


# name -> make() giving (deck, mesh[, draws]); the solver class by name
CONFIGS = {
    "plain": _p2(lambda: (tgv_input(), periodic_hex_mesh(4, 4, 4))),
    "channel_twin": lambda: channel_twin(spinup_steps=1.5),
    "ramped_duct": ramped_duct,
    "svv": lambda: (deck(LES=1, SGS_model=3), periodic_hex_mesh(3, 3, 3)),
    "shock": lambda: (deck(order=3, shock_cap=1, s0=0.0),
                      periodic_hex_mesh(3, 3, 3)),
    "sem_device_draws": inlet_duct("device"),
    "sem_replay_draws": inlet_duct("replay"),
    "white_noise_replay_draws": inlet_duct("replay", inlet_type=1),
    "dt_type_2": local_dt_tgv,
    "mixed_tri_quad": mixed_box,
    "tgv_4_shards": sharded_tgv,
}


def build(name, seam=True):
    """The port's solver of CONFIGS[name] on the CPU in f64, its capture
    seam set to IdentityGraph (``seam``), and its time step."""
    made = CONFIGS[name]()
    p, mesh = made[:2]
    if name == "mixed_tri_quad":
        s = port(p, mesh, hifiles_tpu_torch.MixedSolver)
    elif name == "tgv_4_shards":
        s = port(p, mesh, ShardedSolver, devices=select_devices(4, "cpu"))
    else:
        s = port(p, mesh)
    if len(made) == 3:
        if made[2] == "replay":
            rng = np.random.default_rng(3)
            s.set_inlet_draws(ReplayDraws(
                [rng.random(sh) for _ in range(12)
                 for sh in s.turb_inlet.draw_shapes], "cpu", torch.float64))
        else:
            s.set_inlet_draws(DeviceDraws(5, "cpu", torch.float64))
    if seam:
        IdentityGraph.seam(s)
    dt = s.compute_dt() if p.dt_type == 2 else p.dt
    return s, p, dt


def buffers(s):
    """The data pointers of the buffers a captured step reads and
    writes."""
    ts = [s.u_soa, s.reg_soa, s._k, s._mdot_old, s._t_sim, s.u_avg_soa,
          getattr(s, "_bf", None), s._fluc, s._dt_s]
    if s._ti_state is not None:
        ts += list(s._ti_state[:2])
    out = []
    for t in ts:
        if t is not None:
            out += [q.data_ptr() for q in getattr(t, "parts", [t])]
    return out


def state(s):
    """State, register, averages and featured carry as one f64 vector."""
    ts = [s.u_soa, s.reg_soa, s.u_avg_soa, s._k, s._mdot_old, s._t_sim]
    if s._ti_state is not None:
        ts += list(s._ti_state[:2])
    return torch.cat([q.reshape(-1) for t in ts if t is not None
                      for q in getattr(t, "parts", [t])])


# ----------------------------------------------------------------------
# (a) capture safety
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_captured_step_is_capture_safe(name):
    """3 captured steps (a warm-up, a capture, 2 replays) with host syncs
    refused in the captured step, bit for bit the eager loop's; the
    buffers keep their addresses across steps, restore and set_state."""
    s, p, dt = build(name)
    ref, _, _ = build(name, seam=False)
    snap = s.snapshot()
    ptrs = buffers(s)
    s.run(3, dt=dt)
    assert s.run_path.endswith("captured") and s._graph is not None
    assert buffers(s) == ptrs
    ref.run(3, dt=dt, graph=False)
    assert ref.run_path.endswith("eager")
    assert torch.equal(state(s), state(ref))
    assert s.time == ref.time
    s.restore(snap)
    assert buffers(s) == ptrs
    s.run(2, dt=dt)
    u = s.gather_u() if hasattr(s, "gather_u") else s.u
    s.set_state(u, tuple(np.zeros_like(a) for a in u)
                if isinstance(u, tuple) else np.zeros_like(u), 0.0)
    assert buffers(s) == ptrs
    s.run(1, dt=dt)
    assert buffers(s) == ptrs and torch.isfinite(state(s)).all()


# ----------------------------------------------------------------------
# (b) the runner's bookkeeping
# ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["plain", "sem_replay_draws",
                                  "white_noise_replay_draws", "tgv_4_shards"])
def test_chunks_match_the_eager_loop(name):
    """run(3) then run(2) captured is the eager run(5) bit for bit, with
    one capture; a snapshot taken between the calls and restored gives
    the same 2 steps again."""
    s, _, dt = build(name)
    ref, _, _ = build(name, seam=False)
    n0 = IdentityGraph.captures
    s.run(3, dt=dt)
    snap = s.snapshot()
    s.run(2, dt=dt)
    ref.run(5, dt=dt, graph=False)
    assert IdentityGraph.captures == n0 + 1
    assert torch.equal(state(s), state(ref)) and s.time == ref.time
    after = state(s)
    s.restore(snap)
    s.run(2, dt=dt)
    assert torch.equal(state(s), after)
    assert IdentityGraph.captures == n0 + 1


def test_new_dt_without_new_capture():
    """A new dt between calls takes effect through the dt buffer, with no
    new capture; a per-element dt (a new kind) is captured anew, and so is
    a new draw object."""
    s, p, dt = build("channel_twin")
    ref, _, _ = build("channel_twin", seam=False)
    n0 = IdentityGraph.captures
    for x in (dt, 0.5 * dt, 0.25 * dt):
        s.run(2, dt=x)
        ref.run(2, dt=x, graph=False)
    assert IdentityGraph.captures == n0 + 1
    assert torch.equal(state(s), state(ref)) and s.time == ref.time
    assert float(s._dt_s) == 0.25 * dt

    s, p, _ = build("dt_type_2")
    ref, _, _ = build("dt_type_2", seam=False)
    n0 = IdentityGraph.captures
    for x in (p.dt, s.compute_dt(), 0.5 * s.compute_dt()):
        s.run(2, dt=x)
        ref.run(2, dt=x, graph=False)
    assert IdentityGraph.captures == n0 + 2
    assert torch.equal(state(s), state(ref)) and s.time == ref.time

    s, _, dt = build("sem_device_draws")
    ref, _, _ = build("sem_device_draws", seam=False)
    n0 = IdentityGraph.captures
    s.run(2, dt=dt)
    ref.run(2, dt=dt, graph=False)
    for x in (s, ref):
        x.set_inlet_draws(DeviceDraws(9, "cpu", torch.float64))
        x.run(2, dt=dt, graph=x is s)
    assert IdentityGraph.captures == n0 + 2
    assert torch.equal(state(s), state(ref))


# kernel -> (module, the plain version its wrapper calls on the CPU)
PLAIN = {"volume_tdisf": (volume, "volume_tdisf_many_ref"),
         "flux_point_qn": (ldg_element, "flux_point_qn_ref"),
         "solution_point_gradient": (ldg_element,
                                     "solution_point_gradient_ref"),
         "common_flux": (common_flux, "common_flux_ref")}


def count_plain(monkeypatch, kernel):
    """Stand in for the card's launches of ``kernel``: each call of its
    plain version counts as one launch in the program's record (the
    volume kernel's with its blocks' (U, E))."""
    mod, name = PLAIN[kernel]
    plain = getattr(mod, name)

    def counted(*args, **kwargs):
        shapes = ([(c.u.shape[0], c.u.shape[2]) for c in args[0]]
                  if kernel == "volume_tdisf" else None)
        tracing.launch(kernel, "stand-in", shapes)
        return plain(*args, **kwargs)
    monkeypatch.setattr(mod, name, counted)


def launches(kernel):
    return tracing.record()["launches"][kernel]


# mesh -> the blocks (shards) the volume kernel's grouped launch carries
BLOCKS = {"plain": 1, "mixed_tri_quad": 2, "tgv_4_shards": 4}


@pytest.mark.parametrize("mesh", list(BLOCKS))
@pytest.mark.parametrize("kernel", list(PLAIN))
def test_launches_counted_per_replayed_step(monkeypatch, kernel, mesh):
    """Each hand kernel's launch counts (tracing's record) follow the
    captured run on one block, a MixedSolver's two and a ShardedSolver's
    four shards: the warm-up step counts as an eager step, the capture
    adds nothing, each replay adds one step's launches, so that 5
    captured steps count what 5 eager steps count, in launches, variants
    and (the volume kernel) segments, shapes and groups; the volume
    kernel launches once per RK stage, whatever the blocks and shards,
    carrying every block; tracing.reset() clears the count."""
    count_plain(monkeypatch, kernel)
    ref, _, dt = build(mesh, seam=False)
    s, _, _ = build(mesh)
    tracing.reset()
    ref.run(1, dt=dt, graph=False)
    step = launches(kernel)
    assert step["launches"] >= s.n_stages
    tracing.reset()
    s.run(1, dt=dt)
    assert (s.captures, s.replays) == (1, 0)
    assert launches(kernel) == step
    for k in range(1, 5):
        s.run(1, dt=dt)
        got = launches(kernel)
        assert s.replays == k and got["launches"] == (k + 1) * \
            step["launches"]
    tracing.reset()
    ref.run(5, dt=dt, graph=False)
    assert got == launches(kernel)
    if kernel == "volume_tdisf":
        assert got["launches"] == 5 * s.n_stages
        assert got["segments"] == sum(got["by_shape"].values()) == \
            5 * s.n_stages * BLOCKS[mesh]
    tracing.reset()
    assert launches(kernel)["launches"] == 0
    assert not launches(kernel)["by_variant"]


def test_card_graph_is_the_default():
    """The eager loop is what the CPU runs; graph=False asks for it
    anywhere; a solver without a seam makes no graph on the CPU."""
    s, _, dt = build("plain", seam=False)
    assert s._make_run_chunk() is None
    s.run(1, dt=dt)
    assert s.run_path == "SoA (fast) eager" and s._graph is None
    t, _, _ = build("channel_twin")
    t.run(1, dt=dt, graph=False)
    assert t.run_path == "SoA featured (fast) eager" and t._graph is None


@pytest.mark.parametrize("enabled", [True, False])
def test_capture_keeps_the_cycle_collector_off(monkeypatch, enabled):
    """A collection inside a capture frees dead solvers' graphs there,
    which invalidates the capture on the card: CudaStepGraph.capture and
    CudaCards.enter(capture=True) .. leave() keep the collector off for
    the capture, also when the body raises, and leave it as it was."""
    import gc
    from hifiles_tpu_torch.solver import graph

    class Stream:
        def wait_stream(self, other):
            pass
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode", lambda: 0)
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode", lambda mode: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setattr(torch.cuda, "set_stream", lambda s: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        seen = []
        g = graph.CudaStepGraph.__new__(graph.CudaStepGraph)
        g.graph, g.stream = None, None
        g.capture(lambda: seen.append(gc.isenabled()))

        def boom():
            seen.append(gc.isenabled())
            raise RuntimeError("body")
        with pytest.raises(RuntimeError, match="body"):
            g.capture(boom)
        assert seen == [False, False] and gc.isenabled() == enabled
        c = graph.CudaCards.__new__(graph.CudaCards)
        c.devices, c.streams = ["cuda:0", "cuda:1"], [Stream(), Stream()]
        c.enter(capture=True)
        assert not gc.isenabled()
        c.leave()
        assert gc.isenabled() == enabled
        c.enter(capture=False)
        assert gc.isenabled() == enabled
        c.leave()
        assert gc.isenabled() == enabled
    finally:
        (gc.enable if was else gc.disable)()


# ----------------------------------------------------------------------
# (c) parity with the JAX run chunk
# ----------------------------------------------------------------------

def held(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(a).max(), 1.0)
    assert np.isfinite(b).all()
    assert np.abs(a - b).max() < 1e-10 * scale, np.abs(a - b).max()


@pytest.mark.parametrize("name", ["plain", "channel_twin", "sem_replay_draws",
                                  "dt_type_2"])
def test_captured_solver_matches_jax_chunk(name):
    """3 captured steps of the port's Solver against the JAX Solver's run
    chunk from the same seeded state (the SEM inlet replaying the JAX
    draws)."""
    made = CONFIGS[name]()
    p, mesh = made[:2]
    js = JaxSolver(p, mesh)
    ts = IdentityGraph.seam(port(p, mesh))
    rng = np.random.default_rng(7)
    u0 = np.asarray(js.u) * (1.0 + 0.01 * rng.random(js.u.shape))
    js.u = jnp.asarray(u0)
    ts.set_state(u0, np.zeros_like(u0), 0.0)
    if len(made) == 3:
        ts.set_inlet_draws(ReplayDraws(jax_draws(js.turb_inlet, None, 3),
                                       "cpu", torch.float64))
    dt = js.compute_dt() if p.dt_type == 2 else p.dt
    js.run(3, dt=dt)
    ts.run(3, dt=np.asarray(dt) if p.dt_type == 2 else dt)
    assert ts.run_path.endswith("captured")
    held(js.u, ts.u)
    assert ts.time == pytest.approx(js.time, rel=1e-15)
    if js.u_avg is not None:
        held(js.u_avg, ts.u_avg)


def test_captured_mixed_solver_matches_jax_chunk():
    """3 captured steps of the tri+quad MixedSolver against the JAX
    MixedSolver's mixed SoA chunk (multiblock.py:724-840)."""
    p, mesh = mixed_box()
    js = JaxMixedSolver(p, mesh)
    ts = IdentityGraph.seam(port(p, mesh, hifiles_tpu_torch.MixedSolver))
    u0 = tuple(np.asarray(a) for a in js.u)
    ts.set_state(u0, tuple(np.zeros_like(a) for a in u0), 0.0)
    js.run(3, dt=p.dt)
    ts.run(3, dt=p.dt)
    assert ts.run_path.endswith("captured")
    for a, b in zip(js.u, ts.u):
        held(a, b)


def test_captured_sharded_solver_matches_jax_chunk():
    """3 captured steps of the 4^3 TGV in 4 shards against the JAX
    ShardedSolver's step on 4 of the conftest's virtual CPU devices."""
    p, mesh = sharded_tgv()
    ts = IdentityGraph.seam(port(p, mesh, ShardedSolver,
                                 devices=select_devices(4, "cpu")))
    js = JaxShardedSolver(p, mesh, devices=jax.devices()[:4],
                          dtype=jnp.float64)
    assert np.array_equal(ts.owner, js.owner)
    js.run(3, dt=p.dt)
    ts.run(3, dt=p.dt)
    assert ts.run_path.endswith("captured")
    held(js.u, ts.u)


def test_driver_prints_run_path_and_traces_a_later_chunk(tmp_path, capsys):
    """``python -m hifiles_tpu_torch`` prints the run path after its first
    chunk and, with --profile, traces its second chunk (on the card,
    replays of the captured step)."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
    from chip_smoke import tgv_deck
    from hifiles_tpu_torch.driver import main
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    write_gambit(hifiles_tpu_torch.periodic_hex_mesh(2, 2, 2),
                 str(tmp_path / "box.neu"))
    deck = tmp_path / "run.deck"
    deck.write_text(tgv_deck("box.neu", order=1, n_steps=3,
                             monitor_res_freq=1, plot_freq=10,
                             restart_dump_freq=10))
    assert main([str(deck), "--device", "cpu", "--outdir",
                 str(tmp_path / "out"), "--profile"]) == 0
    out = capsys.readouterr().out
    assert "run path: SoA (fast) eager" in out
    assert out.index("iter        2") < out.index("profiler trace written") \
        < out.index("iter        3")
    assert (tmp_path / "out" / "torch_trace").exists()

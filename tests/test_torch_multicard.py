"""Element-sharded runs with shards on several cards, captured per card
(hifiles_tpu_torch/parallel/cards.py), on stand-in cards on the CPU, in
f64.

The card's captures cannot run here.  ``StandInCards`` takes the place of
solver/graph.CudaCards for a solver whose shards it maps to stand-in
cards (all on the CPU): a capture runs the step's program once, cut by
cut, with host syncs refused, and returns the solver to where it was (a
capture runs nothing); a replay runs the program again, each cut issuing
the schedule of the segment it ends (every card's waits, graph, event
record), which the stand-ins log, and the cut's copies.  Then:
  * the segmented step equals the eager sharded step (``graph=False``)
    bit for bit, for a viscous TGV in 4 shards on 4 cards, the forced
    wall-bounded channel with running averages in 3 on 3 (its plane sums
    over the shards) and the tri+quad box in 2 on 2, and the JAX
    package's ShardedSolver (ShardedMixedSolver) on the virtual CPU
    devices of tests/conftest.py within 1e-10 * max(scale, 1);
  * the schedule: one wait per neighbouring card and segment and none on
    a card's own events; every read of a copy's source ordered after its
    write and before the source's next write, by the logged waits and
    records alone; as many segments per card as cuts plus one;
  * the one-card path is untouched: shards on one card keep BlockLoop's
    one whole-step capture.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifiles_tpu.mesh.generate import (channel_hex_mesh, periodic_hex_mesh,
                                       periodic_mixed_mesh_2d)
from hifiles_tpu.parallel.mixed_sharding import \
    ShardedMixedSolver as JaxShardedMixedSolver
from hifiles_tpu.parallel.sharding import ShardedSolver as JaxShardedSolver

from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.parallel import (ShardedMixedSolver, ShardedSolver,
                                        select_devices)
from hifiles_tpu_torch.parallel.cards import card_waits
from hifiles_tpu_torch.solver import volume
from hifiles_tpu_torch.solver.turb_inlet import ReplayDraws

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402
from test_mixed import vortex_input  # noqa: E402
from test_torch_featured import channel_twin, ramped_duct  # noqa: E402
from test_torch_graph import IdentityGraph, no_host_syncs  # noqa: E402
from test_torch_turb_inlet import duct_3d  # noqa: E402

torch.set_num_threads(1)


class _Stream:
    def __init__(self, log, k):
        self.log, self.k = log, k

    def wait_event(self, ev):
        self.log.append(("wait", self.k, ev))


class _Event:
    def __init__(self, log):
        self.log = log

    def record(self, stream):
        self.log.append(("record", stream.k, self))


class _Graph:
    def __init__(self, log, k, j):
        self.log, self.k, self.j = log, k, j

    def replay(self):
        self.log.append(("replay", self.k, self.j))

    def reset(self):
        pass


class StandInCards:
    """graph.CudaCards' stand-in for ``solver`` with its shards on the
    stand-in cards ``card_of`` (shard -> card): it logs each replayed
    segment's waits, graph and record, makes copies with ``copy_``, and
    under ``rerun`` runs a replay's program with the volume kernel's
    counters held (the replay is counted once by the runner)."""

    def __init__(self, solver, card_of):
        n = max(card_of) + 1
        self.solver, self.n, self.log = solver, n, []
        self.streams = [_Stream(self.log, k) for k in range(n)]
        self.made = [0] * n
        self.copies = 0
        solver._cards = [solver.devices[0]] * n
        solver._card_of = list(card_of)
        solver._card_backend = self

    def current(self, k):
        return self.streams[k]

    def event(self):
        return _Event(self.log)

    def graph(self, k, generators=()):
        self.made[k] += 1
        return _Graph(self.log, k, self.made[k] - 1)

    def sync(self):
        pass

    def enter(self, capture):
        self._capture = capture
        if capture:
            self._snap = self.solver.snapshot()
            self._guard = no_host_syncs()
            self._guard.__enter__()

    def leave(self):
        if self._capture:
            self._guard.__exit__(None, None, None)
            self.solver.restore(self._snap)

    def begin(self, k, graph):
        pass

    def end(self, k, graph):
        pass

    def copy(self, dst, kd, src, ks):
        self.copies += 1
        dst.copy_(src)

    def rerun(self, fn):
        with no_host_syncs():
            volume.captured_launches(fn)


def tgv4():
    p = tgv_input()
    p.order = 2
    return p, periodic_hex_mesh(4, 4, 4)


def channel3():
    return channel_twin(spinup_steps=1.5)


def mixed2():
    return (vortex_input(order=2, viscous=1),
            periodic_mixed_mesh_2d(4, 4, -10, 10, -10, 10))


# name -> (make, shards, cross points per step)
CASES = {"tgv x4": (tgv4, 4, 10), "channel x3": (channel3, 3, 11),
         "mixed x2": (mixed2, 2, 10)}


def build(name, cards=True, seed=7):
    """The port's sharded solver of CASES[name] on the CPU in f64, each
    shard on a stand-in card of its own (``cards``; else every shard on
    one, the one-card path, through IdentityGraph), from a seeded
    perturbation of its initial state."""
    make, n, _ = CASES[name]
    p, mesh = make()
    cls = ShardedMixedSolver if name.startswith("mixed") else ShardedSolver
    s = cls(run_input_from(p), mesh_from(mesh),
            devices=select_devices(n, "cpu"))
    u = s.gather_u()
    rng = np.random.default_rng(seed)
    bump = lambda a: a * (1.0 + 0.01 * rng.random(a.shape))
    u = tuple(map(bump, u)) if isinstance(u, tuple) else bump(u)
    s.set_state(u, (tuple(np.zeros_like(a) for a in u)
                    if isinstance(u, tuple) else np.zeros_like(u)), 0.0)
    if cards:
        StandInCards(s, list(range(n)))
    else:
        IdentityGraph.seam(s)
    return s, p, u


def state(s):
    ts = [s.u_soa, s.reg_soa, s.u_avg_soa, s._k, s._mdot_old, s._t_sim]
    return torch.cat([q.reshape(-1) for t in ts if t is not None
                      for q in getattr(t, "parts", [t])])


@pytest.mark.parametrize("name", sorted(CASES))
def test_segmented_step_equals_eager(name, monkeypatch):
    """run(3) then run(2) captured per card (a warm-up, a capture, 4
    replays) is the eager run(5) bit for bit, with one capture, the
    volume stage's grouped call once per RK stage (a plain version that
    counts each grouped call as one launch stands in for the card's), and
    the run path naming the cards."""
    f, plain = volume.volume_tdisf, volume.volume_tdisf_many_ref

    def counted(calls, prm):
        f.launches += 1
        return plain(calls, prm)
    monkeypatch.setattr(volume, "volume_tdisf_many_ref", counted)
    s, p, _ = build(name)
    ref, _, _ = build(name)
    volume.reset_counters()
    s.run(3, dt=p.dt)
    s.run(2, dt=p.dt)
    launches = volume.volume_tdisf.launches
    ref.run(5, dt=p.dt, graph=False)
    n = CASES[name][1]
    assert s.run_path.endswith(f"captured (shards on {n} cards)")
    assert ref.run_path.endswith(f"eager (shards on {n} cards)")
    assert s.captures == 1 and s.replays == 4
    assert torch.equal(state(s), state(ref)) and s.time == ref.time
    # the stand-ins share the CPU, whose grouped call carries every shard
    assert launches == 5 * s.n_stages
    volume.reset_counters()


def sem_duct():
    p, mesh = duct_3d(2, 40, 4)
    p.order = 2
    return p, mesh


@pytest.mark.parametrize("make", [sem_duct, ramped_duct],
                         ids=["sem duct x2", "ramped duct x2"])
def test_inlet_and_ramp_on_cards(make):
    """The 4^3 SEM duct (its inlet's rows gathered to the controller's
    card and its fluctuations sent back at the step's start, one numpy
    draw stream replayed) and the ramped inflow duct (each card's copy of
    the ramp counter) in 2 shards on 2 cards: 4 steps captured per card
    equal the eager steps bit for bit, the inlet's eddies included."""
    p, mesh = make()
    runs = []
    for _ in range(2):
        s = ShardedSolver(run_input_from(p), mesh_from(mesh),
                          devices=select_devices(2, "cpu"))
        if s.turb_inlet is not None:
            rng = np.random.default_rng(3)
            s.set_inlet_draws(ReplayDraws(
                [rng.random(sh) for _ in range(6)
                 for sh in s.turb_inlet.draw_shapes], "cpu", torch.float64))
        StandInCards(s, [0, 1])
        runs.append(s)
    s, ref = runs
    s.run(4, dt=p.dt)
    ref.run(4, dt=p.dt, graph=False)
    assert s.run_path.endswith("captured (shards on 2 cards)")
    assert len(s._graph.cuts) == 10 + 2 * (s.turb_inlet is not None)
    assert torch.equal(state(s), state(ref))
    if s.turb_inlet is not None:
        for a, b in zip(s._ti_state[:2], ref._ti_state[:2]):
            assert torch.equal(a, b)


def held(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        x, y = np.asarray(x), np.asarray(y)
        scale = max(np.abs(x).max(), 1.0)
        assert np.isfinite(y).all()
        assert np.abs(x - y).max() <= 1e-10 * scale, np.abs(x - y).max()


@pytest.mark.parametrize("name", ["channel x3", "tgv x4"])
def test_segmented_step_matches_jax_sharded(name):
    """3 steps captured per card against the JAX package's ShardedSolver
    on as many of the conftest's virtual CPU devices, from one state (the
    tri+quad box's eager step, which its segmented step equals bit for
    bit, is held to the JAX ShardedMixedSolver by
    tests/test_torch_mixed_sharding.py)."""
    s, p, u = build(name)
    make, n, _ = CASES[name]
    p, mesh = make()
    if name.startswith("mixed"):
        js = JaxShardedMixedSolver(p, mesh, devices=jax.devices()[:n],
                                   dtype=jnp.float64)
    else:
        js = JaxShardedSolver(p, mesh, devices=jax.devices()[:n],
                              dtype=jnp.float64)
    js.scatter_u(u)
    js.run(3, dt=p.dt)
    s.run(3, dt=p.dt)
    assert s.run_path.endswith("captured (shards on %d cards)" % n)
    held(js.gather_u(), s.gather_u())
    assert s.time == pytest.approx(js.time, rel=1e-15)
    if name == "channel x3":
        held(js.gather_u_avg(), s.gather_u_avg())


def happens_before(log, n):
    """Vector clocks of the logged schedule: per logged replay, the clock
    of its card at its launch (each card's stream runs its replays in
    order; a wait joins the clock the event recorded)."""
    clock = [[0] * n for _ in range(n)]
    recorded, at = {}, []
    for op, k, x in log:
        if op == "wait":
            # an event never recorded yet (the first step's waits on the
            # step before) is passed at once, as on the card
            if x in recorded:
                clock[k] = [max(a, b) for a, b in zip(clock[k], recorded[x])]
        elif op == "replay":
            clock[k][k] += 1
            at.append((k, x, list(clock[k])))
        else:
            recorded[x] = list(clock[k])
    return at


@pytest.mark.parametrize("name", sorted(CASES))
def test_schedule_waits_and_guards(name):
    """The schedule of 4 replayed steps: one wait per neighbouring card
    and segment, never on the card's own events; as many segments per card
    as cross points plus one; each copy's source written (segment c on its
    card) before the receiver's segment c+1 reads it, and that read before
    the source's next write, by the logged waits and records alone."""
    s, p, _ = build(name)
    s.run(5, dt=p.dt)
    cs, cards = s._graph, s._card_backend
    n, cuts = cards.n, CASES[name][2]
    assert len(cs.cuts) == cuts
    assert all(len(g) == cuts + 1 for g in cs.graphs)
    for seg in cs.waits:
        for k, w in enumerate(seg):
            assert len({r for r, _ in w}) == len(w)
            assert all(r != k for r, _ in w)
    # a halo cut: each card waits once on each card it receives from
    nbrs = [set() for _ in range(n)]
    for src, ks, dst, kd in cs.cuts[-1]:
        nbrs[kd].add(ks)
    for k in range(n):
        assert {r for r, _ in cs.waits[-1][k]} >= nbrs[k] != set()
    # every wait is issued for an event already recorded, except on the
    # first step's (never recorded, a no-op on the card)
    at = happens_before(cards.log, n)
    segs = cuts + 1
    assert len(at) == 4 * n * segs
    pos = {(k, j, step): clock for step in range(4)
           for k, j, clock in at[step * n * segs:(step + 1) * n * segs]}
    checked = 0
    for step in range(3):
        for c, copies in enumerate(cs.cuts):
            for src, ks, dst, kd in copies:
                write = pos[(ks, c, step)][ks]
                read = pos[(kd, c + 1, step)]
                assert read[ks] >= write            # read after write
                # the source's next write: its next cut, maybe next step
                later = [c2 for c2, cp in enumerate(cs.cuts)
                         if c2 > c and any(x is src for x, *_ in cp)]
                nxt = ((later[0], step) if later else
                       (min(c2 for c2, cp in enumerate(cs.cuts)
                            if any(x is src for x, *_ in cp)), step + 1))
                assert pos[(ks, *nxt)][kd] >= read[kd]   # write after read
                checked += 1
    assert checked > 0 and cards.copies > 0


def test_card_waits_rule():
    """card_waits on a hand-made schedule: two cards swapping one buffer
    each at two cuts, and a one-way copy whose reader is not a sender."""
    # cuts 0 and 1: card 0 and 1 swap buffers A/B, then C/D
    cuts = [[("A", 0, 1), ("B", 1, 0)], [("C", 0, 1), ("D", 1, 0)]]
    w = card_waits(cuts, 2)
    assert w[0] == [[(1, 1)], [(0, 1)]]     # guard: A/B read in seg 1
    assert w[1] == [[(1, 0)], [(0, 0)]]     # data; guards of C/D subsumed
    assert w[2] == [[(1, 1)], [(0, 1)]]     # data of cut 1
    # one way, 0 -> 1 only: card 0 waits on card 1 only to overwrite
    w = card_waits([[("A", 0, 1)]], 2)
    assert w[0] == [[(1, 1)], []] and w[1] == [[], [(0, 0)]]


def test_one_card_keeps_its_whole_step_graph():
    """Shards on one card take BlockLoop's one whole-step capture: no
    segment, no cut, no card copies, and the run path of one card."""
    s, p, _ = build("tgv x4", cards=False)
    ref, _, _ = build("tgv x4", cards=False)
    n0 = IdentityGraph.captures
    s.run(3, dt=p.dt)
    ref.run(3, dt=p.dt, graph=False)
    assert s.run_path == "SoA (fast) captured"
    assert ref.run_path == "SoA (fast) eager"
    assert IdentityGraph.captures == n0 + 1
    assert isinstance(s._graph, IdentityGraph)
    assert s._cstep is None and s._cbufs == {} and s._reps is None
    assert torch.equal(state(s), state(ref))


# ----------------------------------------------------------------------
# the scripts of the multi-card paths
# ----------------------------------------------------------------------

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import multicard_torch  # noqa: E402
import validate_torch_tgv as vt  # noqa: E402


def test_laminar_gates_of_the_32_cube_run():
    """compare(..., laminar_only=True), the gates of the 32^3 run to t = 4
    on four cards: the JAX 32^3 curve cut at t = 4 passes them against the
    whole JAX file, and only them; raised by 1.5x the laminar bound it
    fails the laminar gate; held by every gate it fails the span."""
    with open(vt.JAX_CURVES[32]) as f:
        ref = json.load(f)
    keep = [i for i, t in enumerate(ref["t"]) if t <= vt.LAMINAR_T]
    curve = dict(tke0=ref["tke0"], t=[ref["t"][i] for i in keep],
                 dissipation=[ref["dissipation"][i] for i in keep])
    out = vt.compare(curve, ref, laminar_only=True)
    assert out["ok"] and out["laminar_samples"] == len(keep) == 40
    assert set(out["checks"]) == {"finite", "covers", "tke0", "laminar"}
    bump = 1.5 * vt.LAMINAR_TOL * ref["peak_dissipation"]
    high = dict(curve, dissipation=[d + bump for d in curve["dissipation"]])
    assert not vt.compare(high, ref, laminar_only=True)["checks"]["laminar"]
    assert not vt.compare(curve, ref)["checks"]["covers"]


def test_validate_in_shards_equals_one_solver():
    """validate(devices=2) on the CPU (two shards of ShardedSolver, TKE
    read through the twin) gives the single Solver's curve at 2^3, p=1,
    f64, within 1e-12."""
    kw = dict(order=1, n1=2, t_end=0.2, device="cpu", dtype=torch.float64)
    one, two = vt.validate(**kw), vt.validate(devices=2, **kw)
    assert two["run_path"] == one["run_path"] == "SoA (fast) eager"
    np.testing.assert_allclose(two["dissipation"], one["dissipation"],
                               rtol=1e-12, atol=0)
    assert two["tke0"] == one["tke0"]


def test_multicard_script_needs_two_cards():
    """scripts/multicard_torch.py refuses to run without two cards."""
    with pytest.raises(RuntimeError, match="visible cards"):
        multicard_torch.main([])
    assert set(multicard_torch.CELLS) == {"plain x4", "channel x3",
                                          "mixed3d x4"}

"""The multi-device dry run of the port (hifiles_tpu_torch.multichip) on
the CPU in f64, with more shards than stand-in cards.

Each of the eight legs of the JAX package's ``dryrun_multichip``
(__graft_entry__.py:106-243) is built by the port's ``multichip`` at its
dry-run shape in 8 shards, placed on 4 stand-in cards as select_devices
places 8 shards on 4 cards (``CARD_OF``: shard s on card s % 4, so the
shards at ring offset 4 share a card and hand their halo parts over
without a cut), its step captured per card (tests/test_torch_multicard.py's
StandInCards).  This file:
  * holds the port's leg inputs to the JAX legs', attribute for attribute;
  * holds five legs (plain, shock, smag, rans, p1) after 3 steps to the
    JAX package's ShardedSolver on the conftest's 8 virtual CPU devices,
    from one seeded state, within 1e-10 * max(scale, 1);
  * holds four legs' steps, captured per card, to their eager sharded
    steps bit for bit (leg_segmented);
  * holds same-card neighbours of tests/test_torch_multicard.py's cases:
    `tgv x4` with cards [0, 0, 1, 1] and `channel x3` with [0, 1, 0],
    bit for bit the eager step, with the schedule's ordering checks,
    card_waits' rule and the grouped volume call once per RK stage;
  * the refusals: the dry run on a missing card, and the multi-card parts
    of scripts/multicard_torch.py with fewer than 2 cards.
tests/test_torch_multichip_b.py holds the other three legs against JAX and
the other four legs' segmented steps against their eager ones (the legs
are split so that neither file takes much over 100 s of one worker, most
of it JAX compiles).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hifiles_tpu.config.params import RunInput as JaxRunInput
from hifiles_tpu.mesh.generate import (channel_hex_mesh,
                                       channel_prism_tet_mesh,
                                       periodic_hex_mesh,
                                       periodic_mixed_mesh_2d)
from hifiles_tpu.parallel.mixed_sharding import \
    ShardedMixedSolver as JaxShardedMixedSolver
from hifiles_tpu.parallel.sharding import ShardedSolver as JaxShardedSolver

from hifiles_tpu_torch import multichip, tracing
from hifiles_tpu_torch.convert import run_input_from
from hifiles_tpu_torch.parallel import (ShardedMixedSolver, ShardedSolver,
                                        select_devices)
from hifiles_tpu_torch.parallel.cards import card_waits
from hifiles_tpu_torch.solver import volume

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(__file__))
import __graft_entry__ as graft  # noqa: E402
from test_torch_graph import count_plain  # noqa: E402
from test_torch_multicard import (CASES, StandInCards,  # noqa: E402
                                  happens_before, multicard_torch, state)

torch.set_num_threads(1)


def launched():
    """The volume kernel's launches in the program's record."""
    return tracing.record()["launches"]["volume_tdisf"]["launches"]

N = 8
CARD_OF = [s % 4 for s in range(N)]
DECKS = os.path.join(ROOT, "tests", "decks")


def jax_leg(name, n=N):
    """The JAX leg ``name`` of dryrun_multichip(n): its input and mesh as
    __graft_entry__.py builds them (_tgv_input for the TGV legs; the
    channel, tri+quad and prism/tet inputs as its lines 163-166, 199-209
    and 226-230 write them), and its solver class."""
    nx = max(4, n)
    tgv = {"plain": (3, None), "shock": (2, "shock"), "smag": (2, "smag"),
           "rans": (2, "rans"), "p1": (1, None)}
    if name in tgv:
        order, feat = tgv[name]
        mesh = (periodic_hex_mesh(nx, 4, 4) if name == "plain"
                else periodic_hex_mesh(nx, 2, 2))
        return graft._tgv_input(order=order, feature=feat), mesh, \
            JaxShardedSolver
    if name == "channel":
        p = JaxRunInput.from_deck(os.path.join(DECKS,
                                               "input_channel_les_bench"))
        p.order = 2
        return p, channel_hex_mesh(nx, 2, 2), JaxShardedSolver
    if name == "mixed":
        p2 = JaxRunInput()
        p2.equation, p2.viscous, p2.order = 0, 1, 2
        p2.ic_form, p2.adv_type, p2.riemann_solve_type = 0, 3, 0
        p2.dt_type, p2.dt = 0, 1e-4
        p2.mach_free_stream = 0.3
        p2.dx_cyclic = p2.dy_cyclic = 20.0
        p2.mu_inf, p2.rt_inf, p2.c_sth = 1e-4, 1.0, 0.0
        p2.fix_vis, p2.prandtl = 1, 0.72
        p2.shock_cap, p2.s0 = 1, 0.0
        return (p2, periodic_mixed_mesh_2d(2 * n, 2, -10, 10, -10, 10),
                JaxShardedMixedSolver)
    assert name == "mixed3d"
    p3 = JaxRunInput.from_deck(os.path.join(DECKS,
                                            "input_prism_tet_wm_bench"))
    return (p3, channel_prism_tet_mesh(nx, 2, 1, 1, x1=2.0, y1=1.0, z1=1.0),
            JaxShardedMixedSolver)


def same(a, b):
    """Equality of deck attributes: NaN equals NaN, arrays and lists by
    element, objects by their attributes."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if hasattr(a, "__dict__") and hasattr(b, "__dict__"):
        return same_vars(a, b)
    return a == b


def same_vars(a, b):
    va, vb = vars(a), vars(b)
    return set(va) == set(vb) and all(same(va[k], vb[k]) for k in va)


def seeded(s, seed=7):
    """Set the port's sharded solver ``s`` to a seeded perturbation of its
    state (after the leg's own seeding); returns the state, per type for a
    mixed mesh, in the twin's layout."""
    u = s.gather_u()
    rng = np.random.default_rng(seed)
    bump = lambda a: a * (1.0 + 0.01 * rng.random(a.shape))
    u = tuple(map(bump, u)) if isinstance(u, tuple) else bump(u)
    s.set_state(u, (tuple(np.zeros_like(a) for a in u)
                    if isinstance(u, tuple) else np.zeros_like(u)), 0.0)
    return u


def port_leg(name, cards=True):
    """The port's leg ``name`` on the CPU in f64, 8 shards on 4 stand-in
    cards (``cards``; else on the one CPU device), from the seeded
    state."""
    s, p = multichip.build_leg(name, N, "cpu", torch.float64)
    u = seeded(s)
    if cards:
        StandInCards(s, CARD_OF)
    return s, p, u


def held(a, b):
    for x, y in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        x, y = np.asarray(x), np.asarray(y)
        scale = max(np.abs(x).max(), 1.0)
        assert x.shape == y.shape and np.isfinite(y).all()
        assert np.abs(x - y).max() <= 1e-10 * scale, np.abs(x - y).max()


def leg_against_jax(name):
    """Leg ``name``: 3 steps of the port's segmented step on 4 stand-in
    cards against the JAX leg on 8 virtual devices from the same state
    (the channel's averages too)."""
    s, p, u = port_leg(name)
    jp, mesh, cls = jax_leg(name)
    js = cls(jp, mesh, devices=jax.devices()[:N], dtype=jnp.float64)
    js.scatter_u(u)
    js.run(3, dt=jp.dt)
    s.run(3, dt=p.dt)
    assert s.run_path.startswith("SoA")
    assert s.run_path.endswith("captured (shards on 4 cards)")
    assert s.captures == 1 and s.replays == 2
    held(js.gather_u(), s.gather_u())
    assert s.time == pytest.approx(js.time, rel=1e-15)
    if multichip.LEGS[name].featured:
        held(js.gather_u_avg(), s.gather_u_avg())


@pytest.mark.parametrize("name", list(multichip.LEGS))
def test_leg_inputs_match_graft_entry(name):
    """Each leg's deck equals the JAX leg's attribute for attribute (the
    tri+quad leg's directly set attributes, setup_params never called,
    included), its mesh the JAX mesh's, and its solver class the JAX
    one's counterpart; the placement is round-robin."""
    jp, jmesh, cls = jax_leg(name)
    leg = multichip.LEGS[name]
    assert same_vars(leg.make_input(), run_input_from(jp))
    mesh = leg.make_mesh(N)
    assert np.array_equal(mesh.ctype, jmesh.ctype)
    assert np.array_equal(mesh.xv, jmesh.xv)
    assert leg.mixed == (cls is JaxShardedMixedSolver)


def leg_segmented(name, monkeypatch):
    """Leg ``name``, 8 shards on 4 stand-in cards: its steps then 2 more
    (a warm-up, a capture, replays) equal as many eager sharded steps bit
    for bit, the grouped volume call once per RK stage (the stand-ins
    share the CPU, whose one grouped call per stage carries every shard's
    every block, none of them empty), the run path naming the 4 cards, the
    JAX leg's checks passed, and the schedule of the replays ordering
    every copy."""
    plain = volume.volume_tdisf_many_ref
    sizes = []

    def counted(calls, prm):
        tracing.launch("volume_tdisf", "stand-in")
        sizes.extend(c.u.shape[2] for c in calls)
        return plain(calls, prm)
    monkeypatch.setattr(volume, "volume_tdisf_many_ref", counted)
    s, p, _ = port_leg(name)
    ref, _, _ = port_leg(name)
    steps = multichip.LEGS[name].steps
    tracing.reset()
    s.run(steps, dt=p.dt)
    s.run(2, dt=p.dt)
    launches = launched()
    ref.run(steps + 2, dt=p.dt, graph=False)
    multichip.check_leg(name, s)
    assert s.run_path.endswith("captured (shards on 4 cards)")
    assert ref.run_path.endswith("eager (shards on 4 cards)")
    assert s.captures == 1 and s.replays == steps + 1
    assert torch.equal(state(s), state(ref)) and s.time == ref.time
    assert launches == (steps + 2) * s.n_stages
    assert min(sizes) > 0
    assert check_schedule(s, steps + 1) > 0
    tracing.reset()


@pytest.mark.parametrize("name", ["plain", "shock", "smag", "rans", "p1"])
def test_leg_matches_jax_sharded(name):
    leg_against_jax(name)


@pytest.mark.parametrize("name", ["plain", "shock", "smag", "rans"])
def test_leg_segmented_step_equals_eager(name, monkeypatch):
    leg_segmented(name, monkeypatch)


# ----------------------------------------------------------------------
# shards sharing a card: tests/test_torch_multicard.py's cases with
# repeated cards
# ----------------------------------------------------------------------

# name -> the card of each shard
SHARED = {"tgv x4": [0, 0, 1, 1], "channel x3": [0, 1, 0]}


def shared(name):
    """CASES[name] of tests/test_torch_multicard.py from its seeded state
    with its shards on the stand-in cards SHARED[name]."""
    make, n, _ = CASES[name]
    p, mesh = make()
    from hifiles_tpu_torch.convert import mesh_from
    s = ShardedSolver(run_input_from(p), mesh_from(mesh),
                      devices=select_devices(n, "cpu"))
    seeded(s)
    StandInCards(s, SHARED[name])
    return s, p


def check_schedule(s, steps):
    """The logged schedule of ``steps`` replayed steps of ``s``: one wait
    per neighbouring card and segment and none on the card's own events;
    every copy's source written before its reader's next segment reads it
    and read before the source's next write, by the logged waits and
    records alone (as tests/test_torch_multicard.py checks one shard a
    card).  Returns the number of copies checked."""
    cs, cards = s._graph, s._card_backend
    n, cuts = cards.n, len(cs.cuts)
    assert all(len(g) == cuts + 1 for g in cs.graphs)
    for seg in cs.waits:
        for k, w in enumerate(seg):
            assert len({r for r, _ in w}) == len(w)
            assert all(r != k for r, _ in w)
    for c, copies in enumerate(cs.cuts):
        for src, ks, dst, kd in copies:
            assert ks != kd
            assert (ks, c) in cs.waits[c + 1][kd]
    at = happens_before(cards.log, n)
    segs = cuts + 1
    assert len(at) == steps * n * segs
    pos = {(k, j, step): clock for step in range(steps)
           for k, j, clock in at[step * n * segs:(step + 1) * n * segs]}
    checked = 0
    for step in range(steps - 1):
        for c, copies in enumerate(cs.cuts):
            for src, ks, dst, kd in copies:
                write = pos[(ks, c, step)][ks]
                read = pos[(kd, c + 1, step)]
                assert read[ks] >= write
                later = [c2 for c2, cp in enumerate(cs.cuts)
                         if c2 > c and any(x is src for x, *_ in cp)]
                nxt = ((later[0], step) if later else
                       (min(c2 for c2, cp in enumerate(cs.cuts)
                            if any(x is src for x, *_ in cp)), step + 1))
                assert pos[(ks, *nxt)][kd] >= read[kd]
                checked += 1
    return checked


@pytest.mark.parametrize("name", sorted(SHARED))
def test_same_card_neighbours_equal_eager(name, monkeypatch):
    """Shards that share a stand-in card take each other's halo parts as
    views, with no cut: 3 + 2 steps captured per card are the eager 5 bit
    for bit, the grouped volume call once per RK stage, every cut's copy
    between two cards (none between shards of one card), and the logged
    schedule of the 4 replays orders each copy's read after its write and
    before the source's next write."""
    count_plain(monkeypatch, "volume_tdisf")
    s, p = shared(name)
    ref, _ = shared(name)
    tracing.reset()
    s.run(3, dt=p.dt)
    s.run(2, dt=p.dt)
    launches = launched()
    ref.run(5, dt=p.dt, graph=False)
    n = max(SHARED[name]) + 1
    assert s.run_path.endswith(f"captured (shards on {n} cards)")
    assert torch.equal(state(s), state(ref)) and s.time == ref.time
    assert launches == 5 * s.n_stages
    # a cut per exchange still: each exchange crosses the two cards
    assert len(s._graph.cuts) == CASES[name][2]
    assert check_schedule(s, 4) > 0
    tracing.reset()


def test_card_waits_rule_with_shared_cards():
    """card_waits when several copies of one cut leave a card or reach one
    (two shards a card): one wait per neighbouring card and segment, the
    latest, none on the card's own events."""
    # cut 0: cards 0 and 1 swap two buffers each (shards 0, 2 on card 0;
    # 1, 3 on card 1); cut 1 the same with other buffers; and card 2
    # receiving from both at cut 1
    cuts = [[("A0", 0, 1), ("A2", 0, 1), ("B1", 1, 0), ("B3", 1, 0)],
            [("C0", 0, 1), ("C2", 0, 2), ("D1", 1, 0), ("D3", 1, 2)]]
    w = card_waits(cuts, 3)
    # segment 0 writes A/B: it waits for their readers on the other card
    # (segment 1 of the step before), one wait though two buffers
    assert w[0] == [[(1, 1)], [(0, 1)], []]
    # segment 1 reads cut 0's data (one wait per card though two copies)
    # and writes C/D, which card 2 read in segment 2 of the step before
    assert w[1] == [[(1, 0), (2, 2)], [(0, 0), (2, 2)], []]
    # segment 2: the data of cut 1; card 2 waits on both senders
    assert w[2] == [[(1, 1)], [(0, 1)], [(0, 1), (1, 1)]]
    for seg in w:
        for k, ws in enumerate(seg):
            assert all(r != k for r, _ in ws)
            assert len({r for r, _ in ws}) == len(ws)


def test_shard_without_a_type_makes_no_segment(monkeypatch):
    """The tri+quad leg's input on a 4 x 2 box in 8 shards: shards 4-7
    hold no quad, and their sub-blocks leave the quads out, so no grouped
    volume call carries an empty segment; captured on 4 stand-in cards it
    is the eager step bit for bit."""
    from hifiles_tpu_torch import periodic_mixed_mesh_2d as port_mixed_mesh
    plain = volume.volume_tdisf_many_ref
    sizes = []

    def counted(calls, prm):
        sizes.extend(c.u.shape[2] for c in calls)
        return plain(calls, prm)
    monkeypatch.setattr(volume, "volume_tdisf_many_ref", counted)
    p = multichip.mixed_input()
    runs = []
    for graph in (True, False):
        s = ShardedMixedSolver(p, port_mixed_mesh(4, 2, -10, 10, -10, 10),
                               devices=select_devices(N, "cpu"))
        seeded(s)
        StandInCards(s, CARD_OF)
        s.run(3, dt=p.dt, graph=graph)
        runs.append(s)
    assert [len(sh) for sh in runs[0]._shard_shapes] == [2] * 4 + [1] * 4
    assert sizes and min(sizes) == 1
    assert torch.equal(state(runs[0]), state(runs[1]))


def test_select_devices_two_shards_a_card(monkeypatch, capsys):
    """select_devices(8, "cuda") with 4 visible cards places the shards
    round-robin, two a card, and prints "cuda:k x2" for each card."""
    import hifiles_tpu_torch.parallel as par
    monkeypatch.setattr(par, "select_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    devices = par.select_devices(N, "cuda")
    assert [str(d) for d in devices] == [f"cuda:{k}" for k in CARD_OF]
    assert capsys.readouterr().out.strip() == (
        "shards: 8 on cuda:0 x2, cuda:1 x2, cuda:2 x2, cuda:3 x2")


def test_driver_devices_8_reaches_select_devices(tmp_path, monkeypatch,
                                                 capsys):
    """``python -m hifiles_tpu_torch <deck> --devices 8`` builds its
    sharded solver on select_devices(8, device): on the CPU, 8 shards of a
    3^3 box, 2 steps, its residual rows those of the single-device run."""
    from chip_smoke import tgv_deck
    from hifiles_tpu_torch import driver
    from hifiles_tpu_torch import periodic_hex_mesh as port_hex_mesh
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    write_gambit(port_hex_mesh(3, 3, 3), str(tmp_path / "box.neu"))
    (tmp_path / "run.deck").write_text(tgv_deck(
        "box.neu", order=1, n_steps=2, monitor_res_freq=1, plot_freq=2,
        restart_dump_freq=2))
    rows = {}
    for extra in ([], ["--devices", "8"]):
        out = tmp_path / f"out{len(extra)}"
        assert driver.main([str(tmp_path / "run.deck"), "--device", "cpu",
                            "--f64", "--outdir", str(out), *extra]) == 0
        text = capsys.readouterr().out
        rows[len(extra)] = [line.split("res:")[1] for line in
                            text.splitlines() if line.startswith("iter")]
    assert "shards: 8 on cpu x8" in text
    assert len(rows[2]) == 2
    for a, b in zip(rows[0], rows[2]):
        np.testing.assert_allclose(np.array(b.split(), dtype=float),
                                   np.array(a.split(), dtype=float),
                                   rtol=1e-10)


# ----------------------------------------------------------------------
# refusals
# ----------------------------------------------------------------------

def test_dryrun_refuses_a_missing_card():
    """dryrun_multichip on "cuda" raises here (no card) and never falls
    back to the CPU; its command line takes one shard count."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        multichip.dryrun_multichip(N)
    with pytest.raises(SystemExit):
        multichip.main(["eight"])


@pytest.mark.parametrize("part", ["legs", "cells8", "driver8"])
def test_multicard_parts_need_two_cards(part):
    """scripts/multicard_torch.py's parts with more shards than cards
    refuse to run with fewer than 2 visible cards; CELLS8 names bench.py's
    eight configurations, each in 8 shards on 4 cards."""
    with pytest.raises(RuntimeError, match="visible cards"):
        multicard_torch.main(["--parts", part])
    assert list(multicard_torch.CELLS8.values()) == [
        (name, 8, 4) for name in ("plain", "smag", "overint", "rans",
                                  "shock", "channel", "mixed", "mixed3d")]

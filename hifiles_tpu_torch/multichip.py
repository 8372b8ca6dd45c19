"""The multi-device dry run of hifiles_tpu_torch: the counterpart of the
JAX package's ``__graft_entry__.dryrun_multichip`` (__graft_entry__.py:
106-243, with its ``_tgv_input``, :9-42).

  python -m hifiles_tpu_torch.multichip N

runs its eight legs, in order, through the element-sharded solvers in N
shards placed by ``parallel.select_devices`` (round-robin over the visible
cards, several shards to a card when N exceeds them):
  plain    - viscous TGV, p=3, on periodic_hex_mesh(max(4, N), 4, 4);
  shock    - Persson sensor + filter + RoeM, p=2, on (max(4, N), 2, 2);
  smag     - Smagorinsky LES, p=2, same mesh;
  rans     - SA-RANS, p=2, nu~ seeded to mu_tilde_inf, same mesh;
  channel  - the forced, averaged `channel` deck (tests/decks/
             input_channel_les_bench) at p=2, channel_hex_mesh(max(4, N),
             2, 2), 2 steps;
  p1       - viscous TGV, p=1, on (max(4, N), 2, 2);
  mixed    - tri+quad with shock capture through ShardedMixedSolver, p=2,
             periodic_mixed_mesh_2d(2 N, 2, -10, 10, -10, 10);
  mixed3d  - the wall-modelled prism/tet deck (tests/decks/
             input_prism_tet_wm_bench) on channel_prism_tet_mesh(max(4,
             N), 2, 1, 1, x1=2, y1=1, z1=1).
Every leg takes one step but the channel's two, in f32, as the JAX legs.
For each leg it checks what the JAX leg asserts (the sharded SoA path
taken, on N > 1 cards through each card's segments of the step; forcing
and averages on the channel, wall-model tables on `mixed3d`; a finite
state and finite averages) and prints one line.  The inputs are copied
attribute for attribute, the mixed leg's too, which sets its free-stream
attributes itself and never calls setup_params (__graft_entry__.py:
199-209).  Imports torch, numpy and hifiles_tpu_torch only; runs on the
card and raises without CUDA unless ``device="cpu"`` is given.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable

import numpy as np
import torch

from . import (RunInput, channel_hex_mesh, channel_prism_tet_mesh,
               periodic_hex_mesh, periodic_mixed_mesh_2d)
from .bench import CHANNEL_DECK, MIXED3D_DECK
from .parallel import ShardedMixedSolver, ShardedSolver, select_devices


def tgv_input(order=2, feature=None) -> RunInput:
    """__graft_entry__.py:9-42: the viscous TGV deck, plain or with a
    feature ("shock", "smag" or "rans")."""
    p = RunInput()
    p.equation = 0
    p.viscous = 1
    p.order = order
    p.ic_form = 7
    p.adv_type = 3
    p.riemann_solve_type = 3
    p.dt_type = 0
    p.n_steps = 1
    p.vcjh_scheme_hexa = 1
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2 * np.pi
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.Mach_free_stream, p.T_free_stream = 0.1, 300.0
    p.rho_free_stream = 0.0008421095852102401
    p.mu_gas = 1.827e-5
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.1, 300.0, 0.0008421095852102401
    p.dt = 1.440389e-5
    if feature == "shock":
        p.shock_cap, p.s0 = 1, 0.0
        p.riemann_solve_type = 2
    elif feature == "smag":
        p.LES, p.SGS_model = 1, 0
        p.C_s, p.filter_ratio, p.filter_type = 0.1, 2.0, 2
    elif feature == "rans":
        p.RANS = 1
        p.riemann_solve_type = 0
    p.setup_params()
    return p


def channel_input() -> RunInput:
    """__graft_entry__.py:163-166: the `channel` deck at p=2 (the order
    set after the deck's setup, as there)."""
    p = RunInput.from_deck(CHANNEL_DECK)
    p.order = 2
    return p


def mixed_input() -> RunInput:
    """__graft_entry__.py:199-209: the viscous tri+quad box with shock
    capture, its attributes set directly and setup_params never called
    (``mach_free_stream`` in lower case, as there)."""
    p2 = RunInput()
    p2.equation, p2.viscous, p2.order = 0, 1, 2
    p2.ic_form, p2.adv_type, p2.riemann_solve_type = 0, 3, 0
    p2.dt_type, p2.dt = 0, 1e-4
    p2.mach_free_stream = 0.3
    p2.dx_cyclic = p2.dy_cyclic = 20.0
    p2.mu_inf, p2.rt_inf, p2.c_sth = 1e-4, 1.0, 0.0
    p2.fix_vis, p2.prandtl = 1, 0.72
    p2.shock_cap, p2.s0 = 1, 0.0
    return p2


def mixed3d_input() -> RunInput:
    """__graft_entry__.py:226-228: the wall-modelled prism/tet deck."""
    return RunInput.from_deck(MIXED3D_DECK)


@dataclasses.dataclass(frozen=True)
class Leg:
    """One leg of the dry run: its input, its mesh for n shards, whether
    it runs through ShardedMixedSolver, its steps, and what it checks
    beyond a finite state (``seed_nu``: the SA field set to mu_tilde_inf
    before the steps; ``featured``: forcing and averages; ``wall_model``:
    wall-model tables)."""
    make_input: Callable[[], RunInput]
    make_mesh: Callable[[int], object]
    mixed: bool = False
    steps: int = 1
    seed_nu: bool = False
    featured: bool = False
    wall_model: bool = False
    what: str = ""


def _nx(n):
    return max(4, n)


# __graft_entry__.py:114-243, in its order
LEGS = {
    "plain": Leg(lambda: tgv_input(order=3),
                 lambda n: periodic_hex_mesh(_nx(n), 4, 4),
                 what="p=3 viscous RK45 step through the sharded SoA fast "
                      "path"),
    "shock": Leg(lambda: tgv_input(order=2, feature="shock"),
                 lambda n: periodic_hex_mesh(_nx(n), 2, 2),
                 what="p=2 shock step through the sharded SoA path"),
    "smag": Leg(lambda: tgv_input(order=2, feature="smag"),
                lambda n: periodic_hex_mesh(_nx(n), 2, 2),
                what="p=2 smag step through the sharded SoA path"),
    "rans": Leg(lambda: tgv_input(order=2, feature="rans"),
                lambda n: periodic_hex_mesh(_nx(n), 2, 2), seed_nu=True,
                what="p=2 SA-RANS 6-field step through the sharded SoA "
                     "path"),
    "channel": Leg(channel_input, lambda n: channel_hex_mesh(_nx(n), 2, 2),
                   steps=2, featured=True,
                   what="p=2 forced-channel LES + averaging steps through "
                        "the sharded SoA featured path"),
    "p1": Leg(lambda: tgv_input(order=1),
              lambda n: periodic_hex_mesh(_nx(n), 2, 2),
              what="p=1 RK45 viscous step"),
    "mixed": Leg(mixed_input,
                 lambda n: periodic_mixed_mesh_2d(2 * n, 2, -10, 10, -10, 10),
                 mixed=True,
                 what="p=2 viscous+shock step through the sharded mixed SoA "
                      "path"),
    "mixed3d": Leg(mixed3d_input,
                   lambda n: channel_prism_tet_mesh(_nx(n), 2, 1, 1, x1=2.0,
                                                    y1=1.0, z1=1.0),
                   mixed=True, wall_model=True,
                   what="p=2 wall-modelled LES step through the sharded "
                        "mixed SoA path"),
}


def build_leg(name, n_shards, device="cuda", dtype=torch.float32):
    """Leg ``name``'s sharded solver in ``n_shards`` shards placed by
    select_devices(n_shards, device), its state seeded as the leg seeds
    it; returns (solver, deck).  Raises where the leg's tables are
    missing."""
    leg = LEGS[name]
    p, mesh = leg.make_input(), leg.make_mesh(n_shards)
    cls = ShardedMixedSolver if leg.mixed else ShardedSolver
    s = cls(p, mesh, devices=select_devices(n_shards, device), dtype=dtype)
    if leg.featured and not (s._forcing and s._avg):
        raise AssertionError(f"dry run {name}: forcing or averages missing")
    if leg.wall_model and not s.has_wm:
        raise AssertionError(f"dry run {name}: wall-model tables missing")
    if leg.seed_nu:
        # the TGV IC leaves nu~ 0; the free-stream level makes the SA
        # source and the 6th field live (__graft_entry__.py:150-152)
        u = s.gather_u()
        u[..., -1] = p.mu_tilde_inf
        s.scatter_u(u)
    return s, p


def check_leg(name, s):
    """What the JAX leg asserts after its steps: the sharded SoA path (on
    N > 1 cards each card's segments), a finite state and, where the run
    keeps them, finite averages.  Raises on a miss."""
    n = s._n_cards()
    want = f"(shards on {n} cards)" if n > 1 else ""
    if not (s.run_path.startswith("SoA") and s.run_path.endswith(want)):
        raise AssertionError(f"dry run {name}: run path {s.run_path!r}")
    u = s.gather_u()
    for a in (u if isinstance(u, tuple) else (u,)):
        if not np.isfinite(a).all():
            raise AssertionError(f"dry run {name}: non-finite state")
    if LEGS[name].featured:
        avg = s.gather_u_avg()
        if avg is None or not np.isfinite(avg).all():
            raise AssertionError(f"dry run {name}: averages missing or "
                                 "non-finite")


def run_leg(name, n_shards, device="cuda", dtype=torch.float32):
    """Leg ``name`` built, stepped its steps and checked; prints its line
    and returns its solver."""
    s, p = build_leg(name, n_shards, device, dtype)
    s.run(LEGS[name].steps, dt=p.dt)
    check_leg(name, s)
    cards = s._n_cards()
    print(f"dryrun_multichip: {n_shards} shards on {cards} "
          f"{'card' if cards == 1 else 'cards'}, {s.mesh.n_cells} "
          f"{'cells' if LEGS[name].mixed else 'hexes'}, {name}: "
          f"{LEGS[name].what} OK ({s.run_path})", flush=True)
    return s


def dryrun_multichip(n_shards, device="cuda", dtype=torch.float32):
    """Every leg of LEGS in ``n_shards`` shards on ``device`` (the cards by
    default, round-robin), in order; returns {leg: solver}."""
    return {name: run_leg(name, n_shards, device, dtype) for name in LEGS}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1 or not argv[0].isdigit() or int(argv[0]) < 1:
        raise SystemExit("usage: python -m hifiles_tpu_torch.multichip N")
    dryrun_multichip(int(argv[0]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hifiles_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line).  Every run on the card goes through the solvers'
captured step (BlockLoop.run: one step captured as a CUDA graph and
replayed; its run path is checked), unless it is the eager run a
comparison asks for (``graph=False``):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the hand-written kernels from hifiles_tpu_torch/csrc
               and print ptxas's registers and spills per instantiation;
  3. kernel  - hold each variant of the volume kernel (d = 3 and d = 2)
               against its plain PyTorch version on the card at the main
               paths' shapes, the sharded cells' shards included (f32 and
               f64, broadcast and full geometry),
               time both, and compute the least time the card could take
               (bytes moved at 3.35 TB/s, operations at 67 TFLOP/s f32);
               the d = 2 and mixed-block variants timed again with the L2
               flushed before every launch (by a write and by a read of
               256 MB); the shards of the dry run's legs (a few elements
               each) and the 8,192 hexes a card of the 32^3 TGV on four
               cards; then the grouped launches the paths issue (GROUPS:
               the blocks of `mixed` and `mixed3d`, the shards of the
               sharded cells, and each card's two shards of bench.py's
               configurations and of the legs in 8 shards on 4 cards, one
               launch each), segment by segment against the plain version,
               timed beside the same segments launched one at a time;
               then K3's two entries (K3_ROWS: the 32^3 TGV's block and
               the blocks of bench.py's `plain`, `smag`, `rans`,
               `channel` with boundary faces, `mixed` and `mixed3d`)
               against their plain versions (f32 and f64), timed beside
               them and their byte bound; then K4 (K4_ROWS: the interior
               faces of both benchmark cells, `plain`, `rans`, a `plain`
               x4 shard with its halo faces, and the flat planes of
               `mixed` and `mixed3d`, on synthetic slot tables of the same
               shapes) against its plain version (f32 and f64), timed
               beside it and its byte bound;
  4. small   - the port on the card against the port on the CPU (f64, 2
               steps) for `plain` and each feature configuration (4^3 p=3),
               the wall-bounded ones (the channel's small twin, the
               wall-modelled channels, a ramped inflow/outflow duct, the
               quad channels with walls, wall model and SA-RANS), the
               quad, tri and tet blocks (the vortex on 8^2 quads, a
               periodic tri box, RoeM and over-integration on tets), and
               the mixed meshes through MixedSolver (the tri+quad box with
               Smagorinsky LES and with over-integration, the wall-modelled
               tri+quad channel, the wall-modelled prism/tet channel, a
               prism TGV box); advection-diffusion on quads, tris, hexes,
               tets (each with and without over-integration), an AD_WALL
               quad channel and the tri+quad box; SEM and white-noise
               inlets on the quad channel and a 4^3 duct and SEM on the
               tri+quad channel, the inlet's draws one numpy stream
               replayed on both devices; then element-sharded runs
               (parallel.ShardedSolver, ShardedMixedSolver), every shard
               on the card, against the same shards on the CPU and the
               single-device solver on the card (f64, 2 steps, 1e-11):
               the 4^3 TGV in 4 shards, the walled quad channel in 7 of
               unequal size, the channel's small twin in 3, a SEM duct in
               4, the tri+quad box and the wall-modelled prism/tet channel
               in 4; then the legs: hifiles_tpu_torch.multichip's
               dryrun_multichip(8, "cuda:0") in f64 (the JAX package's
               eight dry-run legs, all 8 shards on the card, each captured
               whole) and 2 replayed steps more, against the same legs on
               the CPU (1e-11), the phase's wall seconds printed;
  5. reference - the isentropic vortex (16^2 quads, p=3, f64, 100 steps)
               against the reference binary's L2 error row, and the 8^3
               hex, tet, tri+quad and prism over-integration cases, the
               curved 20-node hex and 15-node prism boxes and the
               wall-modelled prism/tet channel against its L1 residual
               rows;
  6. slices  - (each cell with its graph phase: 10 captured steps against
               10 eager steps from one snapshot, gated at 1e-6 * max|u|,
               device kernels of a replayed step against an eager step's
               within 1%, the volume kernel among them as often, the
               capture's time and the memory the graph holds; the rates
               captured and eager, interleaved)
               the `plain`, `smag`, `overint`, `rans` and `shock` cases of
               bench.py (TGV p=4 on 16^3 periodic hexes, f32) and its
               `channel` case (forced plane-channel LES on 16^3 hexes, p=4,
               f32), built by hifiles_tpu_torch.bench (imported as
               ``bench``), for 10 + 10 steps each, gated on
               bench.GOLDENS (the `channel` then 40 steps more, ungated,
               logging whether it stays finite); the `quad`
               (bench.mixed_input's vortex, p=4, 96^2 quads) and `tet`
               (the TGV deck, p=4, 12^3 Kuhn tets) slices gated on
               TORCH_GOLDENS; bench.py's `mixed` (the
               vortex on the 96^2 tri+quad box, p=4) and `mixed3d` (the
               wall-modelled prism/tet LES channel, p=2) cases through
               MixedSolver, gated on bench.GOLDENS; `sem` (a WALE LES duct,
               16^3 hexes, p=4, fed by a 1000-eddy SEM inlet replaying the
               JAX package's draws) and `advdiff` (the 3-D sine wave, 16^3
               hexes, p=4) gated on TORCH_GOLDENS (`advdiff` also on its
               error rows, from the same run in f64); then `sem` again from its initial state with the
               default device draws, against a laminar-inlet twin, with
               its inlet's mass flux and the inlet update's device time;
               the kernels' launch counts read around each run; the rates
               of every one of these cells, captured and eager, from 6
               interleaved 10-step repeats (bench.rates), and their device
               kernels per RK stage; then the benchmark entry point,
               `python3 -m hifiles_tpu_torch.bench plain` as a subprocess:
               its JSON record gated and its rate within 15% of this
               process's `plain` median; then the sharded cells, all
               shards on the card: `plain` in 4 shards, `channel` in 3
               (1,366/1,365/1,365 elements) and `mixed3d` in 4 through
               ShardedMixedSolver, 10 + 10 steps gated on bench.GOLDENS,
               the volume kernel launched once a stage for all the shards'
               blocks on the card, their rates, captured and eager, beside
               `plain` from 4 interleaved repeats and their device kernels
               per RK stage;
  7. driver  - `python3 -m hifiles_tpu_torch <deck>` as a subprocess on
               the `plain` case written as a deck and a Gambit file (TGV
               p=4 on 16^3 hexes, f32, 20 steps): its iter-20 row gated on
               bench.GOLDENS["plain"], its vtu, history and ASCII restart
               files parsed, its volume kernel launches, its wall seconds
               per part and its launches per RK stage (a profiled chunk);
               then a restart from the ASCII dump to step 30, held to an
               uninterrupted 30-step run; then the same deck with
               `--devices 4 --profile` (4 shards on the card): its iter-20
               row gated on bench.GOLDENS["plain"], its history rows held
               to the single-device run's (residual norms at rtol 1e-3,
               integral quantities at 1e-6), its files parsed,
               its volume kernel launches, wall seconds and launches per
               RK stage; and card-vs-CPU f64 cases of compute_dt (dt_type
               1 and 2), gradient_fn, sensor_fn and compute_forces, the
               Couette case against the reference binary's error rows,
               and, with h5py, an HDF5 restart round trip and a CGNS
               write;
  8. long    - the long runs, each on the captured path of the port's
               Solver: the Sod shock tube (120 x 2 quads, p=2, Euler,
               HLLC, Persson sensor + filter, 1000 steps to t = 2 ms) in
               f64 and f32 against the exact solution with the bounds of
               tests/test_shock_tube.py, the f64 state against the port on
               the CPU (1e-11), and without shock capture to step 2500
               (non-finite or a density under 0.105); the forced channel
               `channel_bf1` (the `channel` deck with body_force_type 1,
               f32) gated on TORCH_GOLDENS at steps 20 and 100, then to
               step 1000, finite and its forcing's mass flux within 1e-3
               of mdot0 after every chunk; the TGV Re=1600 validation run
               (scripts/validate_torch_tgv.py: 16^3 hexes, p=4, f32) to
               t = 14, 28,000 steps from one capture, held to the JAX
               package's dissipation curve (validation/tgv_re1600.json)
               and to validate_tgv.py's PASS rule on the DNS peak;
  multicard - with more than one visible card, the multi-card paths of
               scripts/multicard_torch.py: `plain` x4, `channel` x3 and
               `mixed3d` x4 with each card capturing its own shards'
               segments of the step (gated, bit for bit the same shards on
               one card and the eager step, their rates), and the driver
               with --devices 4 on the cards (history held to the
               single-device run's, restart continued), and the dry run's
               legs in 8 shards on the cards (bit for bit the same shards
               on one card and the eager step); on one card one line on
               stderr saying it was not run;
  9. checks  - no module of JAX, of the JAX package or the root bench.py
               was imported; the graph phase's summary, and the card's
               peak reserved memory and the wall seconds after each phase.
The last two lines are the kernel record (each variant at one shape, its
launches that carried that shape and its segments, summed over the paths
that launch it, split in ``launches_by_path``, the long runs' paths
`tgv_re1600`, `sod` and `channel_bf1` and the entry point's `bench` among
them: the shards of the sharded cells are variants of their own; then each
grouped launch, its launches and segments; a row's paths that run only on
several cards, and did not run here, are named under "not_run") and
{"ok": true, "device": ...}; before them, the rows whose every path runs
only on several cards and did not run here, each with its times and
bound.
The script imports nothing of JAX, nothing of the JAX package and not the
root bench.py.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

from hifiles_tpu_torch import bench

ROOT = os.path.dirname(os.path.abspath(__file__))
# when main() started: log_memory reports the wall seconds since
T_START = time.perf_counter()

# kernel vs plain version: max-abs error bound relative to max(scale, 1);
# the two sum in different orders (see tests/test_pallas_volume.py: 2e-6)
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
N_TIMED = 20
# device-side sleep ahead of a timed window, ~0.1 s at the H100's clock:
# longer than the host takes to queue N_TIMED calls of either version
SLEEP_CYCLES = 200_000_000
SLICES = ["plain", "smag", "overint", "rans", "shock"]
CHANNEL_DECK = bench.CHANNEL_DECK
DECKS = os.path.join(ROOT, "tests", "decks")
# The reference HiFiLES binary's goldens, copied from
# tests/test_regression_reference.py (this script cannot import that test
# module): the isentropic vortex's L2 error row on 16x16 periodic quads,
# p=3, f64, 100 steps (VORTEX_L2_GOLD, :98-99), held to 1e-10 per entry;
# and the iter-25 L1 monitor row of the periodic 3^3 tet box, p=3, with
# over-integration (TET_OVERINT_GOLD, :360-361), held to
# 2e-4 * max(0.05, gold) as that test does.
VORTEX_L2_GOLD = [2.1256349151199823e-04, 6.1372013985323446e-04,
                  6.3453168975985310e-04, 1.6902774295053655e-03]
TET_OVERINT_GOLD = [0.07863888, 0.64529890, 0.64317376, 0.37543747,
                    19.72164115]
# and the iter-25 L1 rows of the tri+quad box (6^2, p=3, over-integration;
# MIX2D_OVERINT_GOLD, :384-413, held to 2e-3 * max(0.05, gold)) and of the
# periodic 4^3 prism box (p=3, over-integration; PRISM_OVERINT_GOLD,
# :339-353, 2e-4 * max(0.05, gold)), and the iter-100 L1 row of the
# wall-modelled prism/tet channel (channel_prism_tet_mesh(4, 4, 2, 2), p=2;
# tests/test_mixed_wall_model.py:99-130 PRISM_TET_WM_GOLD, 1e-5 per entry)
MIX2D_OVERINT_GOLD = [0.00253871, 0.01610982, 0.01617601, 0.51149966]
PRISM_OVERINT_GOLD = [0.00306439, 0.07352466, 0.07351704, 0.05934145,
                      0.73944568]
PRISM_TET_WM_GOLD = [0.00000004, 0.00117114, 0.00000670, 0.00087835,
                     0.00000279]
# and the iter-25 L1 rows of the 8^3 hex box with over-integration
# (OVERINT_GOLD, :318-330, 1e-5 per entry) and of the curved boxes, 20-node
# hexes (HEX20_CURVED_GOLD, :418-430, 1e-5) and 15-node prisms
# (PRISM15_CURVED_GOLD, :439-452, 2e-4 * max(0.05, gold)), all p=3 on 3^3
OVERINT_GOLD = [0.00064499, 0.04740269, 0.04740269, 0.06241743, 0.10784275]
HEX20_CURVED_GOLD = [0.00569147, 0.05896665, 0.05973250, 0.06931635,
                     1.41603482]
PRISM15_CURVED_GOLD = [0.01114666, 0.12510596, 0.12508644, 0.07261163,
                       2.78693465]
# and the Couette case's error.dat rows, solution and gradient L2
# (tests/test_regression_reference.py:274-275: tests/decks/input_couette_50
# on ywall_channel_quad_mesh(4, 4, 0, 2, 0, 1), p=3, 50 steps, f64), held
# to 1e-6 * max(1, |gold|) as that test does
COUETTE_SOL_GOLD = [3.217344e-03, 7.738214e-01, 3.380815e-03, 5.081588e-01]
COUETTE_GRAD_GOLD = [4.398921e-02, 5.456541e+00, 3.992768e-02, 3.513095e+00]
# The `quad` and `tet` slices' L1 rows after 10 + 10 f32 steps, recorded by
# the JAX package on the CPU: `JAX_PLATFORMS=cpu python
# scripts/gen_torch_goldens.py quad tet` (2026-10-16).
TORCH_GOLDENS = {
    "quad": [6.737320711035903e-03, 2.258829840337748e-02,
             2.2595005150420167e-02, 3.9932333253928504e-02],
    "tet": [6.941967087375578e-04, 5.019483229620459e-02,
            5.0192843611841405e-02, 6.321338054396550e-02,
            1.1797680043921853e-01],
}
# And the `sem` and `advdiff` slices' rows, with the `sem` slice's time step
# (compute_dt at its initial state, CFL 0.5) and the JAX package's draws for
# its 20 steps in tests/data/torch_sem_draws.npz, and the compute_error(2)
# rows (solution, gradient) of the `advdiff` run in f64, where they are
# discretization error (in f32 the state's rounding outweighs it):
# `JAX_PLATFORMS=cpu python scripts/gen_torch_goldens.py sem advdiff`
# (2026-10-16).
TORCH_GOLDENS.update({
    "sem": [5.544654069449343e-03, 3.389007923192047e-02,
            2.073151018085818e-02, 2.177892742176728e-02,
            3.9334797727837895e-01],
    "advdiff": [3.6139982474148273e+00],
    "advdiff_error": [5.0933625432293215e-14, 4.0942964632156793e-10],
})
SEM_DT = 0.00363610265776515
# And the forced channel `channel_bf1` (the `channel` deck with
# body_force_type 1, the deadbeat forcing, set in code): its rows after
# 10 + 10 and after 100 f32 steps; the JAX run's forcing read
# |mflux / mdot0 - 1| <= 2.76e-7 after every one of its 100 steps:
# `JAX_PLATFORMS=cpu python scripts/gen_torch_goldens.py channel_bf1`
# (2026-10-17).
TORCH_GOLDENS.update({
    "channel_bf1": [1.6286548556062864e-02, 7.713223576172137e-01,
                    1.9819908601247993e-01, 2.0743787212961805e-04,
                    1.1341651018225012e+00],
    "channel_bf1_100": [2.67728330698662e-02, 6.186563537280898e-01,
                        7.353327711785669e-02, 1.9902132424388835e-04,
                        1.7425662232520513e+00],
})
# the `advdiff` slice's time step: the deck's 1e-3 diverges at 16^3 p=4 (the
# diffusive limit scales as h^2 / (p + 1)^4); 1e-4 keeps the deck's
# D dt (p + 1)^4 / h^2 of tests/test_adv_diff.py (8^2, p=3) within 2x
ADVDIFF_DT = 1e-4
SEM_DRAWS = os.path.join(ROOT, "tests", "data", "torch_sem_draws.npz")
NEW_SLICES = ["quad", "tet"]
INLET_SLICES = ["sem", "advdiff"]
# the `sem` slice's state before its gated run, for the run with the
# default device draws
IC_SNAPSHOTS = {}
# the graph phase's record of each cell (graph_vs_eager)
GRAPHS = {}
# bench.py's mixed-mesh cases, through MixedSolver, gated on bench.GOLDENS
MIXED_SLICES = ["mixed", "mixed3d"]
# interleaved 10-step repeats of each cell's rate: 6 leave the long runs
# room in the time limit
N_RATE_REPEATS = 6
# the sharded cells (parallel.ShardedSolver / ShardedMixedSolver, all
# shards on the one card): name -> (slice, shards); their rates are taken
# beside `plain` in SHARDED_REPEATS interleaved repeats
SHARDED_SLICES = {"plain x4": ("plain", 4), "channel x3": ("channel", 3),
                  "mixed3d x4": ("mixed3d", 4)}
SHARDED_REPEATS = 4
# the driver's sharded run, its single-device run (phase 7) the reference
DRIVER_SHARDS = 4
# the dry run's legs (hifiles_tpu_torch.multichip): their shards, and the
# steps each takes after its own, replayed from its capture
LEG_SHARDS = 8
LEG_MORE_STEPS = 2
# the paths of the kernel record that run only on several cards (the
# multicard phase, scripts/multicard_torch.py): where one did not run, a
# row names it under "not_run", and a row of such paths alone is printed
# apart from the kernel record, with its times and bound
MULTICARD_PATHS = {"legs on 4 cards", "tgv 32^3 on 4 cards"} | {
    f"{name} x8 on 4 cards" for name in ("plain", "smag", "overint", "rans",
                                         "shock", "channel", "mixed",
                                         "mixed3d")}
LEG_PATHS = ("legs", "legs on 4 cards")
# the volume kernel's variants timed again with the L2 flushed (their
# inputs, 9-45 MB, fit the H100's 50 MB of L2), and the flush's size
L2_FLUSHED = ["ns_2d", "smagorinsky_2d", "rans_2d", "mixed_quad", "mixed_tri",
              "mixed3d_prism", "mixed3d_tet"]
FLUSH_BYTES = 256 * 2**20
# the card's published peaks (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the card-vs-CPU runs: bench configurations plus the options no bench
# configuration reaches (WALE, the similarity flux, Sutherland viscosity)
SMALL = {"plain": {}, "smag": {}, "overint": {}, "rans": {}, "shock": {},
         "wale": dict(LES=1, SGS_model=1, C_s=0.1),
         "similarity": dict(LES=1, SGS_model=4, C_s=0.1),
         "sutherland": dict(fix_vis=0)}
# The long runs (phase 8): the TGV Re=1600 validation run to t = 14
# (scripts/validate_torch_tgv.py's validate, 28,000 captured steps, 300 s on
# an H100); the Sod shock tube to t = 2 ms (1000 steps) and without shock capture to 2500 steps;
# the forced channel `channel_bf1` to step 1000, its rows gated at steps 20
# (CHANNEL_RTOL) and 100 (CHANNEL_BF1_RTOL_100: bench's `overint` entry,
# 0.25 on row 3 as CHANNEL_RTOL), its forcing's own mass flux within
# MFLUX_BOUND of mdot0 after every chunk (twice the JAX CPU run's worst
# reading would replace it had that read above 5e-4; it read 2.76e-7)
SOD_STEPS = 1000
SOD_NO_CAPTURE_STEPS = 2500
CHANNEL_BF1_STEPS = 1000
CHANNEL_BF1_RTOL_100 = [2e-2, 2e-2, 2e-2, 0.25, 2e-2]
MFLUX_BOUND = 1e-3


def log(msg):
    print(msg, flush=True)


def tgv_input(order=4, config="plain", **attrs):
    """bench.tgv_input's TGV deck (bench.py:278-298) at ``order``, with
    bench.configure(config) for the bench configurations (SLICES) and
    ``attrs`` applied before setup_params."""
    return bench.tgv_input(config if config in SLICES else "plain", order,
                           **attrs)


# The driver phase's deck: bench.run_tgv("plain")'s RunInput (bench.py:
# 278-298, the reference's Taylor_Green_vortex deck) written as a deck,
# with the run control of DRIVER_RUN (vectors carry their length first)
TGV_DECK = dict(
    equation=0, viscous=1, order=4, ic_form=7, adv_type=3,
    riemann_solve_type=3, dt_type=0, dt=1.440389e-5, vcjh_scheme_hexa=1,
    gamma=1.4, R_gas=286.9, fix_vis=1, prandtl=0.72, Mach_free_stream=0.1,
    T_free_stream=300.0, rho_free_stream=0.0008421095852102401,
    mu_gas=1.827e-5, L_free_stream=1.0, Mach_c_ic=0.1, T_c_ic=300.0,
    rho_c_ic=0.0008421095852102401)
DRIVER_RUN = dict(
    n_steps=20, monitor_res_freq=10, res_norm_type=1, plot_freq=20,
    write_type=0, diagnostic_fields="2 vorticity q_criterion",
    integral_quantities="2 kineticenergy enstropy", restart_dump_freq=20,
    restart_ascii=1)


def tgv_deck(mesh_file, **run):
    """The text of the driver phase's deck on ``mesh_file``: TGV_DECK on a
    2 pi periodic box (one Cyclic group), DRIVER_RUN, and ``run``'s
    entries over both (e.g. order, n_steps, restart_flag)."""
    import math
    keys = dict(TGV_DECK, **DRIVER_RUN)
    keys.update(run)
    keys.update(dx_cyclic=2 * math.pi, dy_cyclic=2 * math.pi,
                dz_cyclic=2 * math.pi, mesh_file=mesh_file,
                bc_Cyclic_type="cyclic")
    return "".join(f"{k} {v}\n" for k, v in keys.items())


def channel_input(order=4, wall_model=0):
    """bench.channel_input's deck (bench.py:377-404) at ``order``; with
    ``wall_model`` its walls use that wall model."""
    p = bench.channel_input(order)
    if wall_model:
        p.wall_model = wall_model
        p.read_boundary_params(["Cyclic", "Wall"])
        p.bc_list[1].use_wm = 1
    return p


def duct_mesh(n):
    """The n^3 periodic hex box with its x- faces in the "Inflow" group and
    its x+ faces in the "Outflow" group; y and z stay cyclic."""
    from hifiles_tpu_torch import periodic_hex_mesh
    mesh = periodic_hex_mesh(n, n, n)
    for c in range(mesh.n_cells):
        if c % n == 0:
            mesh.bc_id[c, 4] = 1
        if c % n == n - 1:
            mesh.bc_id[c, 2] = 2
    mesh.bc_names = ["Cyclic", "Inflow", "Outflow"]
    return mesh


def duct_input(order=3):
    """The TGV deck with a total-pressure inflow ramped toward its target
    (SUB_IN_CHAR) and a fixed back pressure (SUB_OUT_SIMP), in the deck's
    non-dimensional scales (rho ~ 1, p ~ 71.4, T ~ 1)."""
    from hifiles_tpu_torch.config.params import (CYCLIC, SUB_IN_CHAR,
                                           SUB_OUT_SIMP, BCParams)
    p = tgv_input(order=order)
    p.bc_list = [
        BCParams(name="Cyclic", flag=CYCLIC),
        BCParams(name="Inflow", flag=SUB_IN_CHAR, p_total=72.2,
                 T_total=1.01, nx=1.0, ny=0.0, nz=0.0, pressure_ramp=1,
                 p_ramp_coeff=0.05, T_ramp_coeff=0.05, p_total_old=71.5,
                 T_total_old=1.0),
        BCParams(name="Outflow", flag=SUB_OUT_SIMP, p_static=71.0,
                 T_total=1.0)]
    return p


def les_input(inlet_type=2, n_eddy=40, mode=0):
    """tests/test_turb_inlet.py:13-48's deck with the port's RunInput: WALE
    LES (C_s 0.5, filter ratio 2), Rusanov, a uniform Mach-0.2 x-flow,
    p=2, dt 1e-5; the groups of channel_quad_mesh: an inflow (SUB_IN_SIMP,
    ``inlet_type``: 1 white noise, 2 SEM, with ``n_eddy`` eddies in
    ``mode``), an outflow (SUB_OUT_SIMP) and the cyclic y faces."""
    from hifiles_tpu_torch.config.params import (CYCLIC, SUB_IN_SIMP,
                                                 SUB_OUT_SIMP, BCParams,
                                                 RunInput)
    p = RunInput()
    p.equation, p.viscous, p.LES, p.SGS_model = 0, 1, 1, 1
    p.C_s, p.filter_ratio, p.order, p.ic_form = 0.5, 2.0, 2, 1
    p.adv_type, p.riemann_solve_type, p.dt_type, p.dt = 3, 0, 0, 1e-5
    p.vcjh_scheme_quad = 1
    p.dy_cyclic = 1.0
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.Mach_free_stream, p.T_free_stream = 0.2, 300.0
    p.rho_free_stream = 1.17723946
    p.mu_gas = 1.827e-5
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.2, 300.0, 1.17723946
    p.nx_c_ic, p.ny_c_ic = 1.0, 0.0
    p.setup_params()
    p.bc_list = [
        BCParams(name="Inflow", flag=SUB_IN_SIMP, rho=p.rho_c_ic,
                 velocity=(p.u_c_ic, 0.0, 0.0), inlet_type=inlet_type,
                 mode=mode, turb_1=(0.01 * p.u_c_ic * p.uvw_ref) ** 2
                 if mode == 0 else 0.01, turb_2=10.0, n_eddy=n_eddy,
                 vis_y=0.0),
        BCParams(name="Outflow", flag=SUB_OUT_SIMP, p_static=p.p_c_ic,
                 T_total=p.T_c_ic),
        BCParams(name="Cyclic", flag=CYCLIC)]
    return p


def les_duct_input(order=4, n_eddy=1000, inlet_type=2):
    """les_input on duct_mesh's groups (Cyclic, Inflow, Outflow), cyclic
    with period 2 pi in y and z, at ``order``, with the `sem` slice's time
    step SEM_DT."""
    import math
    p = les_input(inlet_type=inlet_type, n_eddy=n_eddy)
    inflow, outflow, cyc = p.bc_list
    p.bc_list = [cyc, inflow, outflow]
    p.order = order
    p.dy_cyclic = p.dz_cyclic = 2 * math.pi
    p.dt = SEM_DT
    return p


def mixed_channel_mesh():
    """channel_mixed_mesh_2d(4, 2) on [0, 2] x [0, 1]: tris and quads, the
    groups of les_input."""
    from hifiles_tpu_torch.mesh.generate import channel_mixed_mesh_2d
    return channel_mixed_mesh_2d(4, 2, 0.0, 2.0, 0.0, 1.0)


def adv_diff_input(order=4, dims=3, over_int=False):
    """tests/test_adv_diff.py:13-33's deck with the port's RunInput: the
    decaying sine wave (equation 1, test case 2), Lax-Friedrichs, LDG beta
    0.5 and tau 1, D = 0.05, dt 1e-3 on the [-1, 1] box, wave speed
    (1, 0.5) in 2-D and (1, 0.5, 0.25) in 3-D; with over-integration at
    order + 2 if asked."""
    from hifiles_tpu_torch.config.params import RunInput
    p = RunInput()
    p.equation, p.viscous, p.order, p.ic_form, p.test_case = 1, 1, order, 2, 2
    p.n_steps, p.adv_type, p.riemann_solve_type = 0, 3, 1
    p.dt_type, p.dt = 0, 1e-3
    p.vcjh_scheme_quad = 1
    p.wave_speed = (1.0, 0.5, 0.25 if dims == 3 else 0.0)
    p.diff_coeff, p.lambda_lf, p.ldg_beta, p.ldg_tau = 0.05, 1.0, 0.5, 1.0
    p.dx_cyclic = p.dy_cyclic = p.dz_cyclic = 2.0
    if over_int:
        p.over_int, p.over_int_order = 1, order + 2
    return p


def quad_wall_input(rans=False, wall_model=0):
    """The x-periodic quad channel decks of tests/test_residual_soa.py:145,
    :163 (tests/test_rans_viscous_bc.py's SA channel deck, p=1): SA-RANS
    over adiabatic walls, or Smagorinsky LES over isothermal walls with
    ``wall_model`` on them."""
    from hifiles_tpu_torch.config.params import (ADIABAT_WALL, CYCLIC,
                                                 ISOTHERM_WALL, BCParams,
                                                 RunInput)
    p = RunInput()
    p.equation, p.viscous, p.RANS, p.order, p.ic_form = 0, 1, 1, 1, 1
    p.adv_type, p.riemann_solve_type = 3, 0
    p.dt_type, p.dt, p.n_steps = 0, 1e-5, 0
    p.vcjh_scheme_quad = 1
    p.dx_cyclic = 4.0
    p.gamma, p.R_gas, p.fix_vis = 1.4, 286.9, 1
    p.Mach_free_stream, p.T_free_stream = 0.2, 300.0
    p.rho_free_stream = 1.17723946
    p.mu_gas = 1.827e-5
    p.Mach_c_ic, p.T_c_ic, p.rho_c_ic = 0.2, 300.0, 1.17723946
    p.nx_c_ic, p.ny_c_ic = 1.0, 0.0
    p.setup_params()
    if rans:
        wall = BCParams(name="Wall", flag=ADIABAT_WALL)
    else:
        p.RANS = 0
        p.LES, p.SGS_model, p.C_s = 1, 0, 0.1
        p.wall_model = wall_model
        wall = BCParams(name="Wall", flag=ISOTHERM_WALL, T_static=1.0,
                        use_wm=int(bool(wall_model)))
    p.bc_list = [BCParams(name="Cyc", flag=CYCLIC),
                 BCParams(name="CycX", flag=CYCLIC), wall]
    return p


def sod_input(shock_cap=1):
    """The Sod shock tube of tests/test_shock_tube.py:72-104 (_sod_input;
    testcases/euler/stube parameters): Euler, p=2, HLLC, RK45, dt 2e-6,
    the Persson sensor (s0 1e-3) and exponential filter (36, order 4)
    when ``shock_cap``, slip walls "L" and "R" at the tube's ends."""
    from hifiles_tpu_torch.config.params import (CYCLIC, SLIP_WALL,
                                                  BCParams, RunInput)
    p = RunInput()
    p.equation = 0
    p.viscous = 0
    p.order = 2
    p.ic_form = 10
    p.x_shock_ic = 5.0
    p.adv_type = 3
    p.riemann_solve_type = 3
    p.dt_type = 0
    p.dt = 2e-6
    p.n_steps = 0
    p.vcjh_scheme_quad = 1
    p.shock_cap = shock_cap
    p.shock_det = 0
    p.s0 = 1e-3
    p.expf_fac = 36.0
    p.expf_order = 4
    p.expf_cutoff = 0
    p.shock_det_field = 0
    p.dy_cyclic = 0.2
    p.u_c_ic = p.v_c_ic = p.w_c_ic = 0.0
    p.p_c_ic = 1e4
    p.rho_c_ic = 0.125
    p.bc_list = [BCParams(name="L", flag=SLIP_WALL),
                 BCParams(name="R", flag=SLIP_WALL),
                 BCParams(name="Cyclic", flag=CYCLIC)]
    return p


def sod_mesh():
    """The tube: 120 x 2 quads on [0, 10] x [0, 0.2], cyclic in y
    (tests/test_shock_tube.py:107-108)."""
    from hifiles_tpu_torch import channel_quad_mesh
    return channel_quad_mesh(120, 2, 0.0, 10.0, 0.0, 0.2, bc_x="L",
                             bc_X="R")


def exact_sod(x, t, x0, rho_l, p_l, rho_r, p_r, gamma=1.4):
    """Exact density of the Sod Riemann problem (zero initial velocity):
    copied from tests/test_shock_tube.py:15-69 (exact_sod, _df_shock),
    which this script cannot import, _df_shock nested."""
    import numpy as np
    c_l = np.sqrt(gamma * p_l / rho_l)
    c_r = np.sqrt(gamma * p_r / rho_r)

    def f(p, rho_k, p_k, c_k):
        if p > p_k:  # shock
            A = 2.0 / ((gamma + 1) * rho_k)
            B = (gamma - 1) / (gamma + 1) * p_k
            return (p - p_k) * np.sqrt(A / (p + B))
        return (2 * c_k / (gamma - 1)) * ((p / p_k) ** ((gamma - 1)
                                                        / (2 * gamma)) - 1)

    def df_shock(p, rho_k, p_k):
        A = 2.0 / ((gamma + 1) * rho_k)
        B = (gamma - 1) / (gamma + 1) * p_k
        return np.sqrt(A / (p + B)) * (1 - (p - p_k) / (2 * (p + B)))

    # Newton iteration for p_star
    p_star = 0.5 * (p_l + p_r)
    for _ in range(60):
        fl, fr = f(p_star, rho_l, p_l, c_l), f(p_star, rho_r, p_r, c_r)
        dfl = ((p_star / p_l) ** (-(gamma + 1) / (2 * gamma))) / (rho_l * c_l) \
            if p_star <= p_l else df_shock(p_star, rho_l, p_l)
        dfr = ((p_star / p_r) ** (-(gamma + 1) / (2 * gamma))) / (rho_r * c_r) \
            if p_star <= p_r else df_shock(p_star, rho_r, p_r)
        p_star -= (fl + fr) / (dfl + dfr)
    u_star = 0.5 * (f(p_star, rho_r, p_r, c_r) - f(p_star, rho_l, p_l, c_l))

    xi = (x - x0) / t
    rho = np.empty_like(xi)
    # left rarefaction (p_star < p_l for Sod)
    rho_star_l = rho_l * (p_star / p_l) ** (1 / gamma)
    c_star_l = np.sqrt(gamma * p_star / rho_star_l)
    head, tail = -c_l, u_star - c_star_l
    # right shock
    s_shock = u_star + c_r * np.sqrt((gamma + 1) / (2 * gamma) * p_star / p_r
                                     + (gamma - 1) / (2 * gamma))
    rho_star_r = rho_r * ((p_star / p_r + (gamma - 1) / (gamma + 1))
                          / ((gamma - 1) / (gamma + 1) * p_star / p_r + 1))
    for i, s in enumerate(xi):
        if s < head:
            rho[i] = rho_l
        elif s < tail:
            # inside the left fan: c = (2 c_l - (gamma-1) s) / (gamma+1)
            c = (2 / (gamma + 1)) * (c_l - (gamma - 1) / 2 * s)
            rho[i] = rho_l * (c / c_l) ** (2 / (gamma - 1))
        elif s < u_star:
            rho[i] = rho_star_l
        elif s < s_shock:
            rho[i] = rho_star_r
        else:
            rho[i] = rho_r
    return rho


def sod_check(s, t):
    """The checks of tests/test_shock_tube.py:88-100 on the Sod state of
    solver ``s`` at time ``t``: the L1 distance of the cell-mean density
    to exact_sod (< 0.02), the cell means within (0.11, 1.05) and the
    nodal density within (0.115, 1.02).  Returns (passed, L1, cell-mean
    range, nodal range)."""
    import numpy as np
    u = s.u
    w = s.ops.upts_weights[None, :] * s.block.detjac_upts
    rho_mean = np.einsum("eu,eu->e", w, u[..., 0]) / w.sum(axis=1)
    x_mean = np.einsum("eu,eu->e", w, s.block.pos_upts[..., 0]) \
        / w.sum(axis=1)
    l1 = float(np.abs(rho_mean - exact_sod(x_mean, t, 5.0, 1.0, 1e5, 0.125,
                                           1e4)).mean())
    means = (float(rho_mean.min()), float(rho_mean.max()))
    nodal = (float(u[..., 0].min()), float(u[..., 0].max()))
    ok = bool(np.isfinite(u).all() and l1 < 0.02 and means[1] < 1.05
              and means[0] > 0.11 and nodal[1] < 1.02 and nodal[0] > 0.115)
    return ok, l1, means, nodal


def channel_bf1_input(order=4):
    """The `channel` deck (channel_input) with body_force_type 1: the
    deadbeat forcing (hifiles_tpu/solver/solver.py:513-516), set in code."""
    p = channel_input(order=order)
    p.body_force_type = 1
    return p


def quad_wall_mesh(x1=4.0, nx=8, ny=4):
    """channel_quad_mesh(nx, ny) on [0, x1] x [0, 1]: cyclic in x, walls at
    y = 0 and y = 1 (the groups of tests/test_residual_soa.py:154-157)."""
    from hifiles_tpu_torch import channel_quad_mesh
    mesh = channel_quad_mesh(nx, ny, 0.0, x1, 0.0, 1.0, bc_x="Cyc",
                             bc_X="Cyc", bc_y="Wall")
    mesh.bc_id[mesh.bc_id == 1] = 0
    mesh.bc_names = ["Cyc", "unused", "Wall"]
    return mesh


def slice_case(name):
    """(deck, mesh) of a slice at full width: bench.py's configurations
    from bench.case (the TGV cases, p=4 on 16^3 periodic hexes; `mixed`,
    the vortex on the 96^2 tri+quad box, 4,608 quads and 9,216 tris, p=4;
    `mixed3d`, tests/decks/input_prism_tet_wm_bench on
    channel_prism_tet_mesh(32, 32, 4, 4), 8,192 prisms near the wall and
    24,576 tets above, p=2; `channel`, its deck on channel_hex_mesh(16, 16,
    16)); `quad`, bench.mixed_input()'s vortex on the quad half of the
    `mixed` cell's 96^2 box (9,216 quads, p=4); `tet`, bench.tgv_input's
    TGV deck on 12^3 Kuhn tets (10,368 tets, p=4); `sem`, les_duct_input on
    duct_mesh(16) (4,096 hexes, p=4, a 1000-eddy SEM inlet on its 256 x-
    faces); `advdiff`, adv_diff_input on the 16^3 box [-1, 1]^3 (4,096
    hexes, p=4, one field) with dt ADVDIFF_DT."""
    from hifiles_tpu_torch import (periodic_hex_mesh, periodic_quad_mesh,
                                   periodic_tet_mesh)
    if name in bench.ALL_CONFIGS:
        c = bench.case(name)
        return c.p, c.mesh
    if name == "quad":
        return bench.mixed_input(), periodic_quad_mesh(96, 96, -10, 10, -10,
                                                       10)
    if name == "sem":
        return les_duct_input(order=4, n_eddy=1000), duct_mesh(16)
    if name == "advdiff":
        p = adv_diff_input(order=4)
        p.dt = ADVDIFF_DT
        return p, periodic_hex_mesh(16, 16, 16, -1, 1, -1, 1, -1, 1)
    return tgv_input(order=4), periodic_tet_mesh(12, 12, 12)


def periodic_tri_mesh(nx, ny, x0=-1.0, x1=1.0, y0=-1.0, y1=1.0):
    """The nx x ny periodic quad box with every quad split into 2 tris along
    its bl->tr diagonal: the split of hifiles_tpu/mesh/generate.py:106-150
    (periodic_mixed_mesh_2d) applied to every cell, from the port's
    periodic_quad_mesh.  All boundaries stay in the one Cyclic group."""
    import numpy as np
    from hifiles_tpu_torch import TRI, periodic_quad_mesh
    from hifiles_tpu_torch.mesh.core import (MAX_F_PER_C, MAX_V_PER_C,
                                             NUM_F_PER_C, MeshData,
                                             corner_vlist_face)
    quads = periodic_quad_mesh(nx, ny, x0, x1, y0, y1)
    cells = []
    for q in quads.c2v[:, :4]:                   # bl, br, tl, tr
        cells += [[q[0], q[1], q[3]], [q[0], q[3], q[2]]]
    C = len(cells)
    c2v = -np.ones((C, MAX_V_PER_C), dtype=np.int64)
    c2v[:, :3] = cells
    bc_id = -np.ones((C, MAX_F_PER_C), dtype=np.int64)
    mesh = MeshData(n_dims=2, xv=quads.xv.copy(), c2v=c2v,
                    c2n_v=np.full(C, 3, dtype=np.int64),
                    ctype=np.full(C, TRI, dtype=np.int64), bc_id=bc_id,
                    bc_names=["Cyclic"], ic2icg=np.arange(C, dtype=np.int64))
    lo, hi = np.array([x0, y0]), np.array([x1, y1])
    for c in range(C):
        for k in range(NUM_F_PER_C[TRI]):
            pts = mesh.xv[c2v[c, corner_vlist_face(TRI, 3, k)]]
            for ax in range(2):
                if ((np.abs(pts[:, ax] - lo[ax]) < 1e-10).all()
                        or (np.abs(pts[:, ax] - hi[ax]) < 1e-10).all()):
                    bc_id[c, k] = 0
    return mesh


def mixed_wall_mesh(nx=8, ny=4):
    """periodic_mixed_mesh_2d(nx, ny) on [0, 4] x [0, 1] with walls at
    y = 0 and y = 1 in group 2 ("Wall"), cyclic in x (the mesh of
    tests/test_mixed_wall_model.py:56-74)."""
    import numpy as np
    from hifiles_tpu_torch import periodic_mixed_mesh_2d
    from hifiles_tpu_torch.mesh.core import NUM_F_PER_C, corner_vlist_face
    mesh = periodic_mixed_mesh_2d(nx, ny, 0.0, 4.0, 0.0, 1.0)
    mesh.bc_names = ["Cyc", "unused", "Wall"]
    for c in range(mesh.n_cells):
        for k in range(NUM_F_PER_C[int(mesh.ctype[c])]):
            if mesh.bc_id[c, k] < 0:
                continue
            vl = corner_vlist_face(int(mesh.ctype[c]), int(mesh.c2n_v[c]), k)
            y = mesh.xv[mesh.c2v[c, vl], 1]
            on_y = (np.abs(y) < 1e-10).all() or (np.abs(y - 1.0) < 1e-10).all()
            mesh.bc_id[c, k] = 2 if on_y else 0
    return mesh


def small_mixed():
    """name -> (deck, mesh) of the card-vs-CPU runs through MixedSolver:
    the vortex of `mixed` on the 6^2 tri+quad box (p=3) with Smagorinsky
    LES and with over-integration; the wall-modelled tri+quad channel; the
    wall-modelled prism/tet channel of input_prism_tet_wm_25 on
    channel_prism_tet_mesh(3, 2, 2, 2) (p=2); the TGV deck on
    periodic_prism_mesh(3, 3, 3) (p=3)."""
    from hifiles_tpu_torch import (RunInput, channel_prism_tet_mesh,
                                   periodic_mixed_mesh_2d,
                                   periodic_prism_mesh)
    box = lambda: periodic_mixed_mesh_2d(6, 6, -10, 10, -10, 10)
    les, over = bench.mixed_input(order=3), bench.mixed_input(order=3)
    les.LES, les.SGS_model, les.C_s = 1, 0, 0.1
    over.over_int, over.over_int_order = 1, 5
    return {
        "mixed_les": (les, box()),
        "mixed_overint": (over, box()),
        "mixed_channel_wm1": (quad_wall_input(wall_model=1),
                              mixed_wall_mesh()),
        "prism_tet_wm": (RunInput.from_deck(os.path.join(
            DECKS, "input_prism_tet_wm_25")),
            channel_prism_tet_mesh(3, 2, 2, 2, x1=2.0, y1=1.0, z1=1.0)),
        "prism_tgv": (tgv_input(order=3), periodic_prism_mesh(3, 3, 3)),
    }


def small_bounded():
    """name -> (deck, mesh) of the wall-bounded card-vs-CPU runs."""
    from hifiles_tpu_torch import channel_hex_mesh
    return {
        "channel": (channel_input(order=2), channel_hex_mesh(4, 4, 2)),
        "channel_wm1": (channel_input(order=2, wall_model=1),
                        channel_hex_mesh(4, 4, 2)),
        "channel_wm2": (channel_input(order=2, wall_model=2),
                        channel_hex_mesh(4, 4, 2)),
        "duct_ramp": (duct_input(order=3), duct_mesh(4)),
        "quad_channel": (quad_wall_input(), quad_wall_mesh()),
        "quad_channel_wm1": (quad_wall_input(wall_model=1),
                             quad_wall_mesh()),
        "quad_rans": (quad_wall_input(rans=True), quad_wall_mesh()),
    }


def small_types():
    """name -> (deck, mesh) of the card-vs-CPU runs on quad, tri and tet
    blocks: the vortex deck on 8^2 quads (p=3), the vortex of `quad` on a
    periodic box of 72 tris (p=3, viscous, HLLC), the TGV deck with RoeM on
    periodic_tet_mesh(2, 2, 2) (p=3), and the tet over-integration deck on
    periodic_tet_mesh(3, 3, 3)."""
    from hifiles_tpu_torch import (RunInput, periodic_quad_mesh,
                                   periodic_tet_mesh)
    return {
        "vortex": (RunInput.from_deck(os.path.join(DECKS,
                                                   "input_vortex_parity")),
                   periodic_quad_mesh(8, 8, -5, 5, -5, 5)),
        "tri": (bench.mixed_input(order=3),
                periodic_tri_mesh(6, 6, -10, 10, -10, 10)),
        "tet_roem": (tgv_input(order=3, riemann_solve_type=2),
                     periodic_tet_mesh(2, 2, 2)),
        "tet_overint": (RunInput.from_deck(os.path.join(
            DECKS, "input_tet_overint_25")), periodic_tet_mesh(3, 3, 3)),
    }


def small_adv_diff():
    """name -> (deck, mesh) of the card-vs-CPU advection-diffusion runs:
    the sine wave on quads (4^2, p=3), tris (3^2, p=3), hexes (3^3, p=2)
    and tets (2^3, p=2), each with and without over-integration; between
    AD_WALL walls on the x-periodic quad channel (8 x 4, p=2); on the
    tri+quad box (3^2, p=2) through MixedSolver."""
    from hifiles_tpu_torch import (periodic_hex_mesh, periodic_mixed_mesh_2d,
                                   periodic_quad_mesh, periodic_tet_mesh)
    from hifiles_tpu_torch.config.params import AD_WALL, CYCLIC, BCParams
    box = (-1, 1, -1, 1, -1, 1)
    meshes = {"quad": (2, 3, lambda: periodic_quad_mesh(4, 4, *box[:4])),
              "tri": (2, 3, lambda: periodic_tri_mesh(3, 3, *box[:4])),
              "hex": (3, 2, lambda: periodic_hex_mesh(3, 3, 3, *box)),
              "tet": (3, 2, lambda: periodic_tet_mesh(2, 2, 2, *box))}
    cases = {}
    for name, (dims, order, mesh) in meshes.items():
        for over in (False, True):
            cases[f"advdiff_{name}" + ("_over_int" if over else "")] = (
                adv_diff_input(order, dims, over), mesh())
    p = adv_diff_input(order=2, dims=2)
    p.bc_list = [BCParams(name="Cyc", flag=CYCLIC),
                 BCParams(name="CycX", flag=CYCLIC),
                 BCParams(name="Wall", flag=AD_WALL)]
    mesh = quad_wall_mesh(x1=2.0)
    cases["advdiff_ad_wall"] = (p, mesh)
    cases["advdiff_tri_quad"] = (adv_diff_input(order=2, dims=2),
                                 periodic_mixed_mesh_2d(3, 3, *box[:4]))
    return cases


def small_inlets():
    """name -> (deck, mesh) of the card-vs-CPU turbulent-inlet runs: SEM
    (40 eddies) and white noise on les_input's quad channel (8 x 4, p=2)
    and on a 4^3 duct (p=2), SEM (8 eddies) on the tri+quad channel
    through MixedSolver."""
    from hifiles_tpu_torch import channel_quad_mesh
    channel = lambda: channel_quad_mesh(8, 4, 0.0, 2.0, 0.0, 1.0)
    return {
        "sem_channel": (les_input(2), channel()),
        "white_noise_channel": (les_input(1), channel()),
        "sem_duct": (les_duct_input(order=2, n_eddy=40), duct_mesh(4)),
        "white_noise_duct": (les_duct_input(order=2, n_eddy=40,
                                            inlet_type=1), duct_mesh(4)),
        "sem_tri_quad": (les_input(2, n_eddy=8), mixed_channel_mesh()),
    }


def numpy_draws(inlet, n_steps, seed=0):
    """One numpy stream of a turbulent inlet's draws for n_steps (standard
    normal for white noise, uniform [0, 1) for SEM), the same on every
    device."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape) if inlet.inlet_type == 1
            else rng.random(shape)
            for _ in range(n_steps) for shape in inlet.draw_shapes]


def make_solver(p, mesh, config, device, dtype):
    """The port's Solver for a deck, or its MixedSolver for a mesh of
    several element types or of prisms (as the JAX package's command-line
    entry point routes them); for `rans`, nu~ is seeded at the free-stream level as
    bench.py:305-309 does (the TGV IC leaves it 0)."""
    import numpy as np
    from hifiles_tpu_torch import PRISM, MixedSolver, Solver
    types = np.unique(mesh.ctype)
    mixed = types.size > 1 or int(types[0]) == PRISM
    s = (MixedSolver if mixed else Solver)(p, mesh, device=device,
                                           dtype=dtype)
    if config == "rans":
        s.u_soa[:, -1] = p.mu_tilde_inf
    return s


def flat(x):
    """A solver's state (or averages) as one numpy vector: Solver gives
    one array, MixedSolver a tuple of them."""
    import numpy as np
    return np.concatenate([a.ravel() for a in
                           (x if isinstance(x, tuple) else (x,))])


def type_names(mesh):
    """The element types of a mesh, e.g. "tri+quad"."""
    import numpy as np
    from hifiles_tpu_torch import CTYPE_NAMES
    return "+".join(CTYPE_NAMES[int(t)] for t in np.unique(mesh.ctype))


def blocks_of(s):
    """A solver's blocks as text: type, elements E and points U each."""
    from hifiles_tpu_torch import CTYPE_NAMES
    return ", ".join(f"{CTYPE_NAMES[b.ops.ele_type]} E={b.n_eles} "
                     f"U={b.ops.n_upts}" for b in s._blocks)


def k1_per_stage(s):
    """(launches, segments) of the volume kernel per RK stage of solver
    ``s``: one grouped launch per card carrying every block of every
    shard there, or two with over-integration (the cubature points'
    inviscid flux, then the solution points' viscous flux); none for
    equation 1 (plain torch)."""
    blocks = len(s._blocks)
    cards = len(set(getattr(s, "devices", [s.device])))
    if s.p.equation == 1:
        return 0, 0
    if s.p.over_int:
        return 2 * cards, 2 * blocks
    return cards, blocks


def reset_k1():
    """Every hand kernel's launch counts back to 0."""
    from hifiles_tpu_torch import tracing
    tracing.reset(launches_only=True)


def launches_of(kernel="volume_tdisf"):
    """A hand kernel's launch counts since reset_k1 (tracing.record)."""
    from hifiles_tpu_torch import tracing
    return tracing.record()["launches"][kernel]


def read_k1(counts, name):
    """The volume kernel's counters into ``counts`` under ``name``: by
    variant (launches), ``:blocks`` by (variant, U, E) (segments) and
    ``:groups`` by (variant, its segments' shapes) (launches); returns
    (launches, segments)."""
    f = launches_of()
    counts[name] = f["by_variant"]
    counts[name + ":blocks"] = f["by_shape"]
    counts[name + ":groups"] = f["by_group"]
    return f["launches"], f["segments"]


def check_k1(name, got, s, runs):
    """At least k1_per_stage(s) launches and segments per RK stage over
    ``runs`` stages: ``got`` (launches, segments)."""
    need = tuple(runs * k for k in k1_per_stage(s))
    if got[0] < need[0] or got[1] < need[1]:
        raise AssertionError(f"volume_tdisf on {name}: (launches, "
                             f"segments) {got}, expected >= {need}")
    return need


def cuda_ms_flushed(fn, write, n=N_TIMED, repeats=5):
    """cuda_ms of fn() with the L2 cache flushed before every call: the
    time of n (flush, fn()) pairs less that of n flushes.  A flush writes
    FLUSH_BYTES (more than the H100's 50 MB of L2), leaving dirty lines
    that fn()'s misses must write back, as a stage's earlier kernels leave
    them; or, ``write`` false, reads them, leaving clean lines."""
    import torch
    buf = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")
    flush = ((lambda: buf.fill_(1.0)) if write
             else (lambda: torch.sum(buf, 0, out=total)))

    def both():
        flush()
        fn()
    out = cuda_ms(both, n, repeats) - cuda_ms(flush, n, repeats)
    del buf, total
    return out


def cuda_ms(fn, n=N_TIMED, repeats=5):
    """Device time of one fn() in ms: the median over ``repeats`` of the
    mean over n calls, timed with CUDA events.  The n calls are queued
    behind a device-side sleep, so the device runs them back to back and
    the host's launch overhead (tens of us per call, as long as the volume
    kernel itself) stays out of the window."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    return card


def _demangle(names):
    tool = shutil.which("c++filt")
    if not tool or not names:
        return names
    res = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    out = res.stdout.splitlines()
    return out if res.returncode == 0 and len(out) == len(names) else names


def phase_build():
    """Build the kernel library; print registers and spills of every
    instantiation as ptxas reports them."""
    from hifiles_tpu_torch import backend
    t0 = time.perf_counter()
    report = backend.build_kernels(force=True)
    log(f"build: {backend.LIB_PATH} in {time.perf_counter() - t0:.2f} s")
    rows, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = dict(entry=m.group(1))
            rows.append(cur)
        elif cur is not None:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                cur["spill_stores"] = int(m.group(1))
                cur["spill_loads"] = int(m.group(2))
    for row, name in zip(rows, _demangle([r["entry"] for r in rows])):
        m = re.search(r"\w+<[^<>]*>", name)
        log(f"  ptxas: {m.group(0) if m else name}: "
            f"{row.get('registers')} registers, spill "
            f"stores {row.get('spill_stores')} B, loads "
            f"{row.get('spill_loads')} B")


# The volume kernel's variants: what each configuration's volume stage
# launches (volume.variant names the launch), the configuration whose run
# counts its launches, and the shapes of that launch (d, solution points U,
# elements E; d = 3, U = 125, E = 4096 unless given).
VARIANTS = [
    dict(name="ns", F=5, prm={}, path=("plain", "tgv_re1600", "bench")),
    dict(name="smagorinsky", F=5, prm=dict(sgs=0), path="smag"),
    dict(name="rans", F=6, prm={}, path="rans"),
    dict(name="overint_cubature", F=5, prm=dict(viscous=False), U=343,
         path="overint"),
    dict(name="viscous_only", F=5, prm=dict(inviscid=False),
         path="overint"),
    dict(name="wale", F=5, prm=dict(sgs=1), path="sem"),
    dict(name="added_flux", F=5, prm={}, extra=True, path="similarity"),
    dict(name="sutherland", F=5, prm=dict(fix_vis=0), path="sutherland"),
    # as the channel launches it: geometry and the SGS cutoff broadcast
    # (uniform hexes), the wall distance full (stride 1)
    dict(name="smagorinsky_mixed_stride", F=5, prm=dict(sgs=0),
         geos=("mixed",), path=("channel", "channel_bf1")),
    # d = 2 at the `quad` slice's shapes (96^2 quads, p=4); the Smagorinsky
    # and SA variants run on the walled quad channels
    dict(name="ns_2d", D=2, F=4, prm={}, U=25, E=9216, path="quad"),
    dict(name="smagorinsky_2d", D=2, F=4, prm=dict(sgs=0), U=25, E=9216,
         path="quad_channel_wm1"),
    dict(name="rans_2d", D=2, F=5, prm={}, U=25, E=9216, path="quad_rans"),
    # the Sod shock tube's Euler launch: 120 x 2 quads, p=2
    dict(name="sod", D=2, F=4, prm=dict(viscous=False), U=9, E=240,
         path="sod"),
    # the `tet` slice's launch: 12^3 Kuhn tets, p=4, geometry per element
    # (six orientations: nothing compresses)
    dict(name="ns_tet", F=5, prm={}, U=35, E=10368, geos=("full",),
         path="tet"),
    # the blocks of the mixed meshes, told apart by shape
    # (volume_tdisf.by_shape counts each segment): the `mixed` quads
    # (uniform, broadcast geometry) and tris (two orientations, full
    # geometry), p=4; the `mixed3d` prisms and tets with Smagorinsky LES
    # (full geometry, SGS cutoff and wall distance), p=2
    dict(name="mixed_quad", D=2, F=4, prm={}, U=25, E=4608, path="mixed"),
    dict(name="mixed_tri", D=2, F=4, prm={}, U=15, E=9216, geos=("full",),
         path="mixed"),
    dict(name="mixed3d_prism", F=5, prm=dict(sgs=0), U=18, E=8192,
         geos=("full",), path="mixed3d"),
    dict(name="mixed3d_tet", F=5, prm=dict(sgs=0), U=10, E=24576,
         geos=("full",), path="mixed3d"),
    # the shards of the sharded cells (near-balanced contiguous
    # partitions), matched by (variant, U, E): `plain` x4's
    # 1,024 hexes a shard, through the API and the driver's --devices 4
    # (broadcast geometry); `channel` x3's 1,366 and 1,365 (geometry
    # broadcast, wall distance full); `mixed3d` x4's 2,048 prisms and
    # 6,144 tets (full geometry)
    dict(name="ns_shard", F=5, prm={}, E=1024,
         path=("plain x4", "driver --devices")),
    dict(name="smagorinsky_mixed_stride_shard", F=5, prm=dict(sgs=0),
         E=1366, geos=("mixed",), path="channel x3"),
    dict(name="smagorinsky_mixed_stride_shard_less", F=5, prm=dict(sgs=0),
         E=1365, geos=("mixed",), path="channel x3"),
    dict(name="mixed3d_prism_shard", F=5, prm=dict(sgs=0), U=18, E=2048,
         geos=("full",), path="mixed3d x4"),
    dict(name="mixed3d_tet_shard", F=5, prm=dict(sgs=0), U=10, E=6144,
         geos=("full",), path="mixed3d x4"),
    # the 32^3 TGV in 4 shards on 4 cards (scripts/multicard_torch.py
    # --parts scaling, scripts/validate_torch_tgv.py --devices 4): 8,192
    # hexes a card
    dict(name="ns_card_of_tgv32", F=5, prm={}, E=8192,
         path="tgv 32^3 on 4 cards"),
    # the shards of the dry run's legs (hifiles_tpu_torch.multichip, 8
    # shards): a few elements each, far below a tile of 128, all on the
    # card (`legs`) or two a card on four; the smag and channel legs share
    # a shape and a variant (the channel's wall distance full)
    dict(name="ns_leg_p3", F=5, prm={}, U=64, E=16, path=LEG_PATHS),
    dict(name="ns_leg_p2", F=5, prm={}, U=27, E=4, path=LEG_PATHS),
    dict(name="smagorinsky_leg", F=5, prm=dict(sgs=0), U=27, E=4,
         geos=("broadcast", "mixed"), path=LEG_PATHS),
    dict(name="rans_leg", F=6, prm={}, U=27, E=4, path=LEG_PATHS),
    dict(name="ns_leg_p1", F=5, prm={}, U=8, E=4, path=LEG_PATHS),
    dict(name="mixed_tri_leg", D=2, F=4, prm={}, U=6, E=4, geos=("full",),
         path=LEG_PATHS),
    dict(name="mixed_quad_leg", D=2, F=4, prm={}, U=9, E=2, path=LEG_PATHS),
    dict(name="mixed3d_tet_leg", F=5, prm=dict(sgs=0), U=10, E=12,
         geos=("full",), path=LEG_PATHS),
    dict(name="mixed3d_prism_leg", F=5, prm=dict(sgs=0), U=18, E=4,
         geos=("full",), path=LEG_PATHS),
]
# The grouped launches of the main paths: every block of a stage (and
# every shard on the card) in one launch (volume.volume_tdisf_many), as
# segments (U, E, geometry) in the order the path issues them; the
# variant's F, d and parameters as in VARIANTS.
GROUPS = [
    dict(name="mixed", D=2, F=4, prm={}, path="mixed",
         segs=[(25, 4608, "broadcast"), (15, 9216, "full")]),
    dict(name="mixed3d", F=5, prm=dict(sgs=0), path="mixed3d",
         segs=[(18, 8192, "full"), (10, 24576, "full")]),
    dict(name="plain x4", F=5, prm={}, path=("plain x4", "driver --devices"),
         segs=[(125, 1024, "broadcast")] * 4),
    dict(name="channel x3", F=5, prm=dict(sgs=0), path="channel x3",
         segs=[(125, 1366, "mixed"), (125, 1365, "mixed"),
               (125, 1365, "mixed")]),
    dict(name="mixed3d x4", F=5, prm=dict(sgs=0), path="mixed3d x4",
         segs=[(18, 2048, "full"), (10, 6144, "full")] * 4),
    # two shards a card, 8 on 4 (scripts/multicard_torch.py --parts cells8
    # legs): each card's launch of a stage; cells that share a variant and
    # shapes share a row (`shock` launches `plain`'s; the `channel` the
    # Smagorinsky variant of `smag`, its wall distance full)
    dict(name="plain+shock x8, a card", F=5, prm={},
         path=("plain x8 on 4 cards", "shock x8 on 4 cards"),
         segs=[(125, 512, "broadcast")] * 2),
    dict(name="smag+channel x8, a card", F=5, prm=dict(sgs=0),
         path=("smag x8 on 4 cards", "channel x8 on 4 cards"),
         segs=[(125, 512, "broadcast"), (125, 512, "mixed")]),
    dict(name="overint x8 cubature, a card", F=5, prm=dict(viscous=False),
         path="overint x8 on 4 cards", segs=[(343, 512, "broadcast")] * 2),
    dict(name="overint x8 viscous, a card", F=5, prm=dict(inviscid=False),
         path="overint x8 on 4 cards", segs=[(125, 512, "broadcast")] * 2),
    dict(name="rans x8, a card", F=6, prm={}, path="rans x8 on 4 cards",
         segs=[(125, 512, "broadcast")] * 2),
    dict(name="mixed x8, a card", D=2, F=4, prm={},
         path="mixed x8 on 4 cards",
         segs=[(15, 1152, "full"), (25, 576, "broadcast")] * 2),
    dict(name="mixed3d x8, a card", F=5, prm=dict(sgs=0),
         path="mixed3d x8 on 4 cards",
         segs=[(10, 3072, "full"), (18, 1024, "full")] * 2),
    dict(name="legs p3, a card", F=5, prm={}, path="legs on 4 cards",
         segs=[(64, 16, "broadcast")] * 2),
    dict(name="legs shock, a card", F=5, prm={}, path="legs on 4 cards",
         segs=[(27, 4, "broadcast")] * 2),
    dict(name="legs smag+channel, a card", F=5, prm=dict(sgs=0),
         path="legs on 4 cards",
         segs=[(27, 4, "broadcast"), (27, 4, "mixed")]),
    dict(name="legs rans, a card", F=6, prm={}, path="legs on 4 cards",
         segs=[(27, 4, "broadcast")] * 2),
    dict(name="legs p1, a card", F=5, prm={}, path="legs on 4 cards",
         segs=[(8, 4, "broadcast")] * 2),
    dict(name="legs mixed, a card", D=2, F=4, prm={}, path="legs on 4 cards",
         segs=[(6, 4, "full"), (9, 2, "broadcast")] * 2),
    dict(name="legs mixed3d, a card", F=5, prm=dict(sgs=0),
         path="legs on 4 cards",
         segs=[(10, 12, "full"), (18, 4, "full")] * 2),
]
# a viscous case whose viscous, SGS and SA terms are not lost in the
# inviscid flux's scale (SGS cutoff delta ~ 1, mu = 0.05)
KERNEL_PRM = dict(gamma=1.4, prandtl=0.72, mu=0.05, viscous=True,
                  rt_inf=1.0, c_sth=0.368, prandtl_t=0.9, C_s=0.1,
                  kappa=0.41)
# the elementwise aten ops whose output elements count as operations
ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt",
             "pow", "exp", "log1p", "logaddexp", "maximum", "minimum",
             "clamp", "where", "reciprocal", "ge", "gt", "le", "lt"}


def volume_inputs(E, U, F, D, dtype, device, seed=0):
    """Seeded operands at the main path's shapes: u (U, F, E) (for
    F = D + 3 nu~/mu spans [-2, 20]: both psi branches and the mu_t clip),
    grad (D, U, F, E), jg (D, D, U, E), delta and wdist (U, E) (both
    branches of the Smagorinsky wall limit), an added flux (D, U, F, E)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    u = rng.random((U, F, E)) + 1.0
    u[:, D + 1] += 10.0                # positive internal energy
    if F == D + 3:
        u[:, D + 2] = KERNEL_PRM["mu"] * rng.uniform(-2.0, 20.0, (U, E))
    grad = rng.normal(size=(D, U, F, E)) * 0.5
    jg = rng.random((D, D, U, E))
    delta = 0.5 + rng.random((U, E))
    wdist = 0.5 * rng.random((U, E))
    extra = rng.normal(size=(D, U, F, E)) * 0.1
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return [t(a) for a in (u, grad, jg, delta, wdist, extra)]


def volume_bytes(u, grad, jg, prm, delta, wdist, extra):
    """Bytes the volume stage must move: each operand it reads once (grad
    only when viscous, delta and wdist only with an SGS model), and the
    (D, U, F, E) output written once."""
    D = jg.shape[0]
    read = [u, jg] + ([grad] if prm.viscous else [])
    if prm.viscous and prm.sgs >= 0:
        read += [delta, wdist]
    if extra is not None:
        read.append(extra)
    n = sum(t.numel() for t in read) + D * u.numel()
    return n * u.element_size()


def volume_ops(args):
    """Operations of the volume stage on these inputs: the output elements
    of every elementwise arithmetic op its plain version dispatches (the
    same algebra as the kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from hifiles_tpu_torch.solver.volume import volume_tdisf_ref

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ARITH_OPS and hasattr(out, "numel"):
                Count.n += out.numel()
            return out
    with Count():
        volume_tdisf_ref(*args)
    return Count.n


def geometry_args(prm, geo, u, grad, jg, delta, wdist, extra):
    """volume_tdisf's arguments with the geometry ``geo``: "full",
    "broadcast" (jg, delta and wdist one column) or "mixed" (jg and delta
    one column, wdist full: the channel's launch)."""
    cut = (lambda t: t[..., :1].contiguous()) if geo != "full" \
        else (lambda t: t)
    cut_w = cut if geo != "mixed" else (lambda t: t)
    return (u, grad if prm.viscous else None, cut(jg), prm, cut(delta),
            cut_w(wdist), extra)


def phase_groups():
    """Each grouped launch of GROUPS against the plain version, segment by
    segment (f32 and f64, at KERNEL_TOL); in f32 its time, the plain
    version's, the same segments launched one at a time, and its bound
    (the sum of its segments').  Returns {"group <name>": record}."""
    import dataclasses
    import torch
    from hifiles_tpu_torch.solver.volume import (
        VolumeCall, VolumeParams, variant, volume_tdisf, volume_tdisf_many,
        volume_tdisf_many_ref, volume_tdisf_ref)
    dev = torch.device("cuda", 0)
    base = VolumeParams(**KERNEL_PRM)
    recs = {}
    for g in GROUPS:
        prm = dataclasses.replace(base, **g["prm"])
        D, F = g.get("D", 3), g["F"]
        g["key"] = variant(prm, F, False, D)
        g["shapes"] = tuple(sorted((U, E) for U, E, _ in g["segs"]))
        for dtype in (torch.float32, torch.float64):
            args = [geometry_args(prm, geo, *volume_inputs(
                E, U, F, D, dtype, dev, seed=k)[:5], None)
                for k, (U, E, geo) in enumerate(g["segs"])]
            calls = [VolumeCall(*a[:3], *a[4:]) for a in args]
            outs = volume_tdisf_many(calls, prm)
            torch.cuda.synchronize()
            errs, bounds = [], []
            for a, out in zip(args, outs):
                ref = volume_tdisf_ref(*a)
                errs.append((out - ref).abs().max().item())
                bounds.append(KERNEL_TOL[str(dtype)[6:]]
                              * max(ref.abs().max().item(), 1.0))
            line = (f"kernel volume_tdisf[group {g['name']}] ({g['key']}, "
                    f"{len(calls)} segments (U, E, geometry) {g['segs']}) "
                    f"{str(dtype)[6:]}: max_abs_err per segment "
                    f"{[float(f'{e:.3e}') for e in errs]} (bounds "
                    f"{[float(f'{b:.3e}') for b in bounds]})")
            if dtype == torch.float32:
                ms = cuda_ms(lambda: volume_tdisf_many(calls, prm))
                plain_ms = cuda_ms(lambda: volume_tdisf_many_ref(calls,
                                                                 prm))
                separate_ms = cuda_ms(
                    lambda: [volume_tdisf(*a) for a in args])
                nbytes = sum(volume_bytes(*a) for a in args)
                ops = sum(volume_ops(a) for a in args)
                bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                ops_ms = ops / F32_OPS_PER_S * 1e3
                line += (f" one launch {ms:.4f} ms, the segments launched "
                         f"one at a time {separate_ms:.4f} ms, plain "
                         f"{plain_ms:.4f} ms; moves {nbytes / 1e6:.3f} MB "
                         f"(bound {bytes_ms:.4f} ms at 3.35 TB/s, share "
                         f"{bytes_ms / ms:.3f}), {ops / 1e6:.1f} M ops "
                         f"(bound {ops_ms:.4f} ms at 67 TFLOP/s)")
                recs["group " + g["name"]] = dict(
                    max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                    bound_ms=max(bytes_ms, ops_ms),
                    bound_by="bytes" if bytes_ms >= ops_ms
                    else "operations", library_ms=None,
                    separate_ms=separate_ms)
            log(line)
            if not all(e <= b for e, b in zip(errs, bounds)):
                raise AssertionError(f"volume_tdisf[group {g['name']}] "
                                     f"disagrees with its plain version: "
                                     f"{errs} > {bounds}")
            del args, calls, outs
    return recs


# K3 (solver/ldg_element.py): each entry at the shapes of the paths that
# launch it, one block each (d, solution points U, flux points Pf, elements
# E, F, the SGS model, the geometry as in GEOMETRY_K3, the gradient output
# at the flux points where the block has boundary faces)
K3_ROWS = [
    dict(name="tgv_re1600_160", D=3, U=125, Pf=150, E=32768, F=5, sgs=-1,
         geo="broadcast", bdy=False),
    dict(name="plain", D=3, U=125, Pf=150, E=4096, F=5, sgs=-1,
         geo="broadcast", bdy=False),
    dict(name="smag", D=3, U=125, Pf=150, E=4096, F=5, sgs=0,
         geo="broadcast", bdy=False),
    dict(name="rans", D=3, U=125, Pf=150, E=4096, F=6, sgs=-1,
         geo="broadcast", bdy=False),
    dict(name="channel", D=3, U=125, Pf=150, E=4096, F=5, sgs=0,
         geo="mixed", bdy=True),
    dict(name="mixed_quad", D=2, U=25, Pf=20, E=4608, F=4, sgs=-1,
         geo="broadcast", bdy=False),
    dict(name="mixed_tri", D=2, U=15, Pf=15, E=9216, F=4, sgs=-1,
         geo="full", bdy=False),
    dict(name="mixed3d_prism", D=3, U=18, Pf=39, E=8192, F=5, sgs=0,
         geo="full", bdy=True),
    dict(name="mixed3d_tet", D=3, U=10, Pf=24, E=24576, F=5, sgs=0,
         geo="full", bdy=True),
]
# the flux-point geometry kept at one column: a uniform mesh's, the
# channel's (wall distance and normals per element), a curved or
# unstructured block's (none)
GEOMETRY_K3 = {"broadcast": ("jg", "inv_det", "norm", "delta", "wdist"),
               "mixed": ("jg", "inv_det", "delta"), "full": ()}


def k3_inputs(r, dtype, device, seed=0):
    """Seeded operands of K3 row ``r``: at the flux points (tgf, u_f, jg,
    inv_det, norm, delta, wdist; the geometry cut to one column as
    GEOMETRY_K3 says) and at the solution points (tg, jg, inv_det)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    D, U, Pf, E, F = r["D"], r["U"], r["Pf"], r["E"], r["F"]
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    u = rng.random((F, E, Pf)) + 1.0
    u[D + 1] += 10.0
    if F == D + 3:
        u[D + 2] = KERNEL_PRM["mu"] * rng.uniform(-2.0, 20.0, (E, Pf))
    f = dict(tgf=t(rng.normal(size=(D, F, E, Pf)) * 0.5), u_f=t(u),
             jg=t(rng.random((D, D, E, Pf))),
             inv_det=t(0.5 + rng.random((E, Pf))),
             norm=t(rng.normal(size=(D, E, Pf))),
             delta=t(0.5 + rng.random((E, Pf))),
             wdist=t(0.5 * rng.random((E, Pf))))
    for k in GEOMETRY_K3[r["geo"]]:
        f[k] = f[k][..., :1, :].contiguous()
    col = (lambda a: a[..., :1]) if r["geo"] != "full" else (lambda a: a)
    up = (t(rng.normal(size=(D, U, F, E))),
          t(np.ascontiguousarray(col(rng.random((D, D, U, E))))),
          t(np.ascontiguousarray(col(0.5 + rng.random((U, E))))))
    return f, up


def phase_k3():
    """Each K3 row against its plain version on the card (f32 and f64, at
    KERNEL_TOL), both entries; in f32 each entry's time, the plain
    version's and its bound (the bytes it must move at 3.35 TB/s: each
    input read once, a column read once, each output written once).
    Returns {"k3 <entry>[<row>]": record}."""
    import dataclasses
    import torch
    from hifiles_tpu_torch.solver.ldg_element import (
        flux_point_qn, flux_point_qn_ref, solution_point_gradient,
        solution_point_gradient_ref)
    from hifiles_tpu_torch.solver.volume import VolumeParams, variant
    dev = torch.device("cuda", 0)
    recs = {}
    for r in K3_ROWS:
        prm = dataclasses.replace(VolumeParams(**KERNEL_PRM), inviscid=False,
                                  sgs=r["sgs"])
        key = variant(prm, r["F"], False, r["D"])
        for dtype in (torch.float32, torch.float64):
            f, up = k3_inputs(r, dtype, dev)
            sgs = r["sgs"] >= 0
            fargs = ([f[k] for k in ("tgf", "u_f", "jg", "inv_det",
                                     "norm")]
                     + [prm, f["delta"] if sgs else None,
                        f["wdist"] if sgs else None, None, r["bdy"]])
            cases = {
                "flux_point_qn": (lambda: flux_point_qn(*fargs),
                                  lambda: flux_point_qn_ref(*fargs)),
                "solution_point_gradient": (
                    lambda: solution_point_gradient(*up),
                    lambda: solution_point_gradient_ref(*up))}
            for entry, (kernel, plain) in cases.items():
                got, want = kernel(), plain()
                torch.cuda.synchronize()
                pairs = [(a, b) for a, b in zip(pairs_of(got),
                                                pairs_of(want))
                         if b is not None]
                err = max((a - b).abs().max().item() for a, b in pairs)
                scale = max(b.abs().max().item() for _, b in pairs)
                bound = KERNEL_TOL[str(dtype)[6:]] * max(scale, 1.0)
                name = f"k3 {entry}[{r['name']}]"
                shape = (f"D={r['D']} Pf={r['Pf']} E={r['E']} F={r['F']} "
                         f"geo={r['geo']} grad out={r['bdy']}"
                         if entry == "flux_point_qn" else
                         f"D={r['D']} U={r['U']} E={r['E']} F={r['F']}")
                what = key if entry == "flux_point_qn" else \
                    f"D{r['D']}F{r['F']}"
                line = (f"kernel {name} ({what}, {shape}) {str(dtype)[6:]}: "
                        f"max_abs_err {err:.3e} (bound {bound:.3e}, scale "
                        f"{scale:.3e})")
                if dtype == torch.float32:
                    ins = (fargs[:5] + fargs[6:8]) if entry == \
                        "flux_point_qn" else list(up)
                    nbytes = sum(t.numel() * t.element_size()
                                 for t in ins + pairs_of(got)
                                 if t is not None)
                    ms, plain_ms = cuda_ms(kernel), cuda_ms(plain)
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    line += (f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
                             f"moves {nbytes / 1e6:.3f} MB (bound "
                             f"{bytes_ms:.4f} ms at 3.35 TB/s, share "
                             f"{bytes_ms / ms:.3f})")
                    recs[name] = dict(max_abs_err=err, ms=ms,
                                      plain_ms=plain_ms, bound_ms=bytes_ms,
                                      share=bytes_ms / ms)
                log(line)
                if not err <= bound:
                    raise AssertionError(f"{name} disagrees with its plain "
                                         f"version: {err} > {bound}")
                del got, want, pairs
            del f, up, fargs, cases
    log(json.dumps({"k3 rows": recs}))
    return recs


def pairs_of(x):
    """An entry's outputs as a list."""
    return list(x) if isinstance(x, tuple) else [x]


def check_k3(name, s, runs):
    """Each K3 entry launched at least once per block on every one of
    ``runs`` RK stages of solver ``s`` when it is viscous and not scalar,
    never otherwise."""
    fns = [(k, launches_of(k)) for k in ("flux_point_qn",
                                         "solution_point_gradient")]
    on = bool(s.p.viscous) and s.p.equation == 0
    need = runs * len(s._blocks) if on else 0
    got = [f["launches"] for _, f in fns]
    log(f"slice {name} K3 launches: " + ", ".join(
        f"{k} {f['launches']} {f['by_variant']}" for k, f in fns)
        + f" (expected >= {need}" + ("" if on else ", none") + ")")
    if any(n < need for n in got) or (not on and any(got)):
        raise AssertionError(f"K3 on {name}: launches {got}, expected "
                             f"{'>= ' + str(need) if on else 'none'}")


# K4 (solver/common_flux.py): the interior common flux at the face planes
# of the paths that launch it (d, F, riemann_solve_type, viscous, the
# layout: a hex box (nx, ny, nz) with ny walls or not, its faces' planes
# (25, faces); or flat planes of `n` points in face runs of `nfp` (a mixed
# mesh); a shard of 16^3 hexes in z slabs, its halo faces last)
K4_ROWS = [
    dict(name="tgv_re1600_160", D=3, F=5, solver=3, box=(32, 32, 32)),
    dict(name="channel_retau395", D=3, F=5, solver=3, box=(32, 40, 32),
         walls=True),
    dict(name="plain", D=3, F=5, solver=3, box=(16, 16, 16)),
    dict(name="rans", D=3, F=6, solver=0, box=(16, 16, 16)),
    dict(name="plain_x4_shard", D=3, F=5, solver=3, box=(16, 16, 4),
         halo=True),
    dict(name="mixed", D=2, F=4, solver=3, flat=115200, nfp=5),
    dict(name="mixed3d", D=3, F=5, solver=0, flat=442368, nfp=6),
]


def hex_box_faces(nx, ny, nz, walls=False, halo=False, nfp=25):
    """Slot tables of the interior faces of a box of hexes, p = 4 (6 local
    faces of 25 points, 150 slots an element; slot = e*150 + face*25 +
    point), in the face order of the element-major build (x, y, z faces
    of each element), each face's l side the one with the smaller local
    face (orient_faces), its r side's points transposed; y periodic
    unless ``walls``; with ``halo`` the z faces of the bottom and top
    layers leave the box and come last, their r side elsewhere.  Returns
    (slot_l (25, C), slot_r (25, n_r), n_slots)."""
    import numpy as np
    q = int(round(nfp ** 0.5))
    pts = np.arange(nfp)
    tr = (pts % q) * q + pts // q
    e = lambda i, j, k: ((k % nz) * ny + (j % ny)) * nx + (i % nx)
    faces, halos = [], []
    for k in range(nz):
        for j in range(ny):
            for i in range(nx):
                me = e(i, j, k)
                # x: my +x face (2) against the neighbour's -x face (4)
                faces.append((me, 2, e(i + 1, j, k), 4))
                if not (walls and j == ny - 1):
                    faces.append((e(i, j + 1, k), 1, me, 3))
                if halo and k == nz - 1:
                    halos.append((me, 5))
                elif halo and k == 0:
                    halos.append((me, 0))
                    faces.append((e(i, j, k + 1), 0, me, 5))
                else:
                    faces.append((e(i, j, k + 1), 0, me, 5))
    f = np.array(faces)
    slot_l = f[:, 0] * 6 * nfp + f[:, 1] * nfp
    slot_r = f[:, 2] * 6 * nfp + f[:, 3] * nfp
    slot_l = slot_l[None, :] + pts[:, None]
    slot_r = slot_r[None, :] + tr[:, None]
    if halos:
        h = np.array(halos)
        slot_h = (h[:, 0] * 6 * nfp + h[:, 1] * nfp)[None, :] + pts[:, None]
        slot_l = np.concatenate([slot_l, slot_h], axis=1)
    return slot_l, slot_r, nx * ny * nz * 6 * nfp


def flat_faces(n, nfp, seed=0):
    """Slot tables of ``n`` interior points in flat planes (a mixed mesh):
    the slot space is runs of ``nfp`` slots, paired at random into faces
    ordered by their l run, the r run's points reversed.  Returns (slot_l
    (n,), slot_r (n,), n_slots)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    runs = rng.permutation(2 * n // nfp).reshape(-1, 2)
    runs.sort(axis=1)
    runs = runs[np.argsort(runs[:, 0])]
    pts = np.arange(nfp)
    slot_l = (runs[:, :1] * nfp + pts[None, :]).ravel()
    slot_r = (runs[:, 1:] * nfp + pts[None, ::-1]).ravel()
    return slot_l, slot_r, 2 * n


def k4_inputs(r, dtype, device, seed=0):
    """Seeded operands of K4 row ``r``: (u_l, u_r, qn_l, qn_r, norm,
    slot_l, slot_r, n_slots); states of a TGV at Mach 0.1 to 0.5, unit
    normals on the axes (a hex box) or anywhere (flat)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    D, F = r["D"], r["F"]
    if "box" in r:
        slot_l, slot_r, n_slots = hex_box_faces(
            *r["box"], walls=r.get("walls", False),
            halo=r.get("halo", False))
    else:
        slot_l, slot_r, n_slots = flat_faces(r["flat"], r["nfp"], seed)
    shape = slot_l.shape
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                  device=device)

    def states():
        rho = 1.0 + 0.1 * rng.random(shape)
        vel = rng.normal(size=(D,) + shape) * rng.uniform(0.1, 0.5, shape)
        u = np.empty((F,) + shape)
        u[0] = rho
        u[1:D + 1] = rho * vel
        u[D + 1] = (1.0 / 1.4) / 0.4 + 0.5 * rho * (vel ** 2).sum(0)
        if F == D + 3:
            u[D + 2] = rng.uniform(0.0, 0.01, shape)
        return u
    if "box" in r:
        n = np.zeros((D,) + shape)
        n[rng.integers(0, D, shape[-1]), :, np.arange(shape[-1])] = 1.0
    else:
        n = rng.normal(size=(D,) + shape)
        n /= np.linalg.norm(n, axis=0)
    idx = lambda a: torch.as_tensor(np.ascontiguousarray(a).ravel(),
                                    device=device)
    return (t(states()), t(states()),
            t(rng.normal(size=(F,) + shape) * 0.01),
            t(rng.normal(size=(F,) + shape) * 0.01), t(n), idx(slot_l),
            idx(slot_r), n_slots)


def phase_k4():
    """Each K4 row against its plain version on the card (f32 and f64, at
    KERNEL_TOL); in f32 the kernel's time, the plain version's and the
    bound: the face planes read once and the flux written once at 3.35
    TB/s (33 values a point viscous at d = 3, F = 5), the int64 slots'
    16 B a point besides.  Returns {"k4 [<row>]": record}."""
    import torch
    from hifiles_tpu_torch.solver.common_flux import (
        common_flux, common_flux_ref, variant)
    from hifiles_tpu_torch.solver.residual import ResidualConfig
    dev = torch.device("cuda", 0)
    recs = {}
    for r in K4_ROWS:
        cfg = ResidualConfig(equation=0, riemann_solve_type=r["solver"],
                             viscous=True, gamma=1.4, ldg_beta=0.5,
                             ldg_tau=0.0, n_fields=r["F"])
        for dtype in (torch.float32, torch.float64):
            args = k4_inputs(r, dtype, dev)
            u_l, slot_l, slot_r = args[0], args[5], args[6]
            written = torch.cat([slot_l, slot_r])
            want = common_flux_ref(*args, cfg)[:, written]
            scale = want.abs().max().item()
            bound = KERNEL_TOL[str(dtype)[6:]] * max(scale, 1.0)
            out = common_flux(*args, cfg)
            torch.cuda.synchronize()
            err = (out[:, written] - want).abs().max().item()
            del out
            name = f"k4 [{r['name']}]"
            rows = u_l.shape[1] if u_l.dim() == 3 else 1
            layout = (f"{tuple(u_l.shape[1:])} planes, n_r "
                      f"{slot_r.numel() // rows}")
            line = (f"kernel {name} ({variant(cfg, r['F'], r['D'])}, "
                    f"{layout}) {str(dtype)[6:]}: max_abs_err "
                    f"{err:.3e} (bound {bound:.3e}, scale {scale:.3e})")
            if dtype == torch.float32:
                elt = u_l.element_size()
                planes = sum(t.numel() for t in args[:5]) * elt + \
                    r["F"] * written.numel() * elt
                slots = written.numel() * 8
                ms = cuda_ms(lambda: common_flux(*args, cfg))
                plain_ms = cuda_ms(lambda: common_flux_ref(*args, cfg))
                bound_ms = planes / HBM_BYTES_PER_S * 1e3
                slots_ms = (planes + slots) / HBM_BYTES_PER_S * 1e3
                line += (f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
                         f"moves {planes / 1e6:.3f} MB of planes (bound "
                         f"{bound_ms:.4f} ms at 3.35 TB/s, share "
                         f"{bound_ms / ms:.3f}), {slots / 1e6:.3f} MB of "
                         f"slots besides (with them {slots_ms:.4f} ms, "
                         f"share {slots_ms / ms:.3f})")
                recs[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=bound_ms, share=bound_ms / ms,
                                  bound_with_slots_ms=slots_ms)
            log(line)
            if not err <= bound:
                raise AssertionError(f"{name} disagrees with its plain "
                                     f"version: {err} > {bound}")
            del args, want, written
    log(json.dumps({"k4 rows": recs}))
    return recs


def check_k4(name, s, runs):
    """K4 launched at least once per residual (block set of a card or
    shard) on every one of ``runs`` RK stages of solver ``s``."""
    need = runs
    f = launches_of("common_flux")
    got = f["launches"]
    log(f"slice {name} K4 launches: {got} {f['by_variant']} "
        f"(expected >= {need})")
    if got < need:
        raise AssertionError(f"K4 on {name}: launches {got}, expected >= "
                             f"{need}")


def phase_kernel():
    """Each variant of volume_tdisf against volume_tdisf_ref on the card;
    returns {name: record} with the f32 error and the kernel's and plain
    version's times on the variant's first geometry, and its bound."""
    import dataclasses
    import torch
    from hifiles_tpu_torch.solver.volume import (VolumeParams, variant,
                                                  volume_tdisf,
                                                  volume_tdisf_ref)
    dev = torch.device("cuda", 0)
    base = VolumeParams(**KERNEL_PRM)
    recs = {}
    for v in VARIANTS:
        prm = dataclasses.replace(base, **v["prm"])
        D, U, E = v.get("D", 3), v.get("U", 125), v.get("E", 4096)
        geos = v.get("geos", ("broadcast", "full"))
        v["key"] = variant(prm, v["F"], bool(v.get("extra")), D)
        for dtype in (torch.float32, torch.float64):
            u, grad, jg_full, delta_f, wdist_f, extra = volume_inputs(
                E, U, v["F"], D, dtype, dev)
            extra = extra if v.get("extra") else None
            for geo in geos:
                args = geometry_args(prm, geo, u, grad, jg_full, delta_f,
                                     wdist_f, extra)
                out = volume_tdisf(*args)
                ref = volume_tdisf_ref(*args)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
                bound = KERNEL_TOL[str(dtype)[6:]] * max(scale, 1.0)
                line = (f"kernel volume_tdisf[{v['name']}] ({v['key']}, "
                        f"D={D} U={U} E={E}) {str(dtype)[6:]} geo={geo}: "
                        f"max_abs_err {err:.3e} (bound {bound:.3e}, scale "
                        f"{scale:.3e})")
                if dtype == torch.float32 and geo == geos[0]:
                    ms = cuda_ms(lambda: volume_tdisf(*args))
                    plain_ms = cuda_ms(lambda: volume_tdisf_ref(*args))
                    flushed = None
                    if v["name"] in L2_FLUSHED:
                        flushed = [cuda_ms_flushed(
                            lambda: volume_tdisf(*args), write)
                            for write in (True, False)]
                    nbytes = volume_bytes(*args)
                    ops = volume_ops(args)
                    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
                    ops_ms = ops / F32_OPS_PER_S * 1e3
                    line += (f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms; "
                             f"moves {nbytes / 1e6:.3f} MB (bound "
                             f"{bytes_ms:.4f} ms at 3.35 TB/s, "
                             f"{nbytes / (ms * 1e-3) / 1e12:.3f} TB/s "
                             f"reached), {ops / 1e6:.1f} M ops (bound "
                             f"{ops_ms:.4f} ms at 67 TFLOP/s)")
                    if flushed is not None:
                        line += "".join(
                            f"; L2 flushed by a {how} {ms_:.4f} ms "
                            f"({bytes_ms / ms_:.3f} of the bytes bound)"
                            for how, ms_ in zip(("write", "read"), flushed))
                    recs[v["name"]] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=max(bytes_ms, ops_ms),
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations", library_ms=None)
                    if flushed is not None:
                        recs[v["name"]].update(l2_write_flushed_ms=flushed[0],
                                               l2_read_flushed_ms=flushed[1])
                log(line)
                if not err <= bound:
                    raise AssertionError(
                        f"volume_tdisf[{v['name']}] disagrees with its plain "
                        f"version: {err} > {bound}")
            del u, grad, jg_full, delta_f, wdist_f, extra
    return recs


def phase_small(counts):
    """The port on the card against the port on the CPU (f64, 2 steps) for
    each configuration of SMALL (4^3 p=3), of small_bounded(), of
    small_types(), of small_mixed(), of small_adv_diff() and of
    small_inlets(): the whole slice, kernel included, states at 1e-12
    relative (the running averages too), residual rows at 1e-10.  Adds
    each card run's launch counts to ``counts``."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.solver.turb_inlet import ReplayDraws
    cases = {name: (tgv_input(order=3, config=name, **attrs),
                    periodic_hex_mesh(4, 4, 4))
             for name, attrs in SMALL.items()}
    walled = small_bounded()
    inlets = small_inlets()
    bounded = (set(walled) | set(inlets)
               | {"mixed_channel_wm1", "prism_tet_wm", "advdiff_ad_wall"})
    cases.update(walled)
    cases.update(small_types())
    cases.update(small_mixed())
    cases.update(small_adv_diff())
    cases.update(inlets)
    for name, (p, mesh) in cases.items():
        gpu = make_solver(p, mesh, name, "cuda", torch.float64)
        cpu = make_solver(p, mesh, name, "cpu", torch.float64)
        if name in inlets:
            draws = numpy_draws(cpu.turb_inlet, 2)
            for s in (gpu, cpu):
                s.set_inlet_draws(ReplayDraws(draws, s.device, s.dtype))
        reset_k1()
        gpu.run(2, dt=p.dt)
        torch.cuda.synchronize()
        run_counts = launches_of()["by_variant"]
        if not gpu.run_path.endswith("captured"):
            raise AssertionError(f"{name}: run path {gpu.run_path!r}")
        cpu.run(2, dt=p.dt)
        ug, uc = flat(gpu.u), flat(cpu.u)
        err = np.abs(ug - uc).max() / np.abs(uc).max()
        rg, rc = gpu.residual_norm(1), cpu.residual_norm(1)
        # the wall-bounded rows are held against the largest row: their
        # small rows are differences of boundary and volume fluxes near
        # balance (the channels' z-momentum ~1e-15 of it, the wall-modelled
        # density row ~2e-5), which a 1e-15 change of the state moves by
        # up to 1e-8 of the row itself
        floor = np.abs(rc).max() if name in bounded else 0.0
        rerr = (np.abs(rg - rc) / np.maximum(np.abs(rc), floor)).max()
        aerr = 0.0
        if cpu.u_avg is not None:
            ag, ac = flat(gpu.u_avg), flat(cpu.u_avg)
            aerr = np.abs(ag - ac).max() / np.abs(ac).max()
        log(f"small {name} f64 {type_names(mesh)} E={mesh.n_cells} "
            f"p={p.order}, card vs CPU "
            f"after 2 steps: state rel err {err:.3e}, residual row rel err "
            f"{rerr:.3e}, averages rel err {aerr:.3e}; launches "
            f"{run_counts}")
        if not (np.isfinite(ug).all() and err < 1e-12 and rerr < 1e-10
                and aerr < 1e-12):
            raise AssertionError(f"{name}: port on the card disagrees with "
                                 "the port on the CPU")
        counts[name] = run_counts


def last_stage_residual(s, n_steps, dt):
    """The last RK45 stage's residual of step n_steps as (E, U, F) numpy
    per block, computed as tests/test_regression_reference.py:108-125 does
    with the port's RK45 coefficients: what the reference's residual
    monitor reports."""
    import torch
    from hifiles_tpu_torch.solver.step import RK45_A, RK45_B
    s.run(n_steps - 1, dt=dt)
    u, r = s.u_soa.clone(), torch.zeros_like(s.u_soa)
    for a, b in zip(RK45_A, RK45_B):
        rhs = s._rhs(u, None)
        r = a * r + dt * rhs
        u = u + b * r
    return s._to_numpy(rhs)


def phase_reference(counts):
    """The port on the card in f64 against the reference HiFiLES binary:
    the isentropic vortex's L2 error row (VORTEX_L2_GOLD, 1e-10 per entry)
    and the L1 monitor rows of the hex, tet, tri+quad and prism
    over-integration cases, of the curved quadratic hex and prism boxes
    and of the wall-modelled prism/tet channel (OVERINT_GOLD,
    TET_OVERINT_GOLD, MIX2D_OVERINT_GOLD, PRISM_OVERINT_GOLD,
    HEX20_CURVED_GOLD, PRISM15_CURVED_GOLD, PRISM_TET_WM_GOLD)."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import (RunInput, Solver, channel_prism_tet_mesh,
                                   periodic_hex_mesh, periodic_mixed_mesh_2d,
                                   periodic_prism_mesh, periodic_quad_mesh,
                                   periodic_tet_mesh)
    from hifiles_tpu_torch.mesh.generate import (periodic_curved_hex20_mesh,
                                                 periodic_curved_prism15_mesh)
    p = RunInput.from_deck(os.path.join(DECKS, "input_vortex_parity"))
    s = Solver(p, periodic_quad_mesh(16, 16, -5, 5, -5, 5), device="cuda",
               dtype=torch.float64)
    reset_k1()
    t0 = time.perf_counter()
    s.run(p.n_steps, dt=p.dt)
    torch.cuda.synchronize()
    counts["vortex_reference"] = launches_of()["by_variant"]
    err = np.sqrt(s.compute_error(2)[0])
    diff = np.abs(err - np.asarray(VORTEX_L2_GOLD))
    log(f"reference vortex 16^2 quads p=3 f64 {p.n_steps} steps "
        f"({time.perf_counter() - t0:.2f} s): L2 error "
        f"[{', '.join(f'{e:.16e}' for e in err)}], max |diff| to the "
        f"reference binary {diff.max():.3e} (gate 1e-10); launches "
        f"{counts['vortex_reference']}")
    if not diff.max() < 1e-10:
        raise AssertionError(f"vortex L2 error off the reference: {err}")

    pi = np.pi
    rows = [
        ("hex over-int 8^3", "input_tgv8_overint_25",
         lambda: periodic_hex_mesh(8, 8, 8), 25, OVERINT_GOLD,
         lambda g: np.full_like(g, 1e-5)),
        ("curved hex20 3^3", "input_hex20_curved_25",
         lambda: periodic_curved_hex20_mesh(3, 3, 3), 25, HEX20_CURVED_GOLD,
         lambda g: np.full_like(g, 1e-5)),
        ("curved prism15 3^3", "input_prism15_curved_25",
         lambda: periodic_curved_prism15_mesh(3, 3, 3), 25,
         PRISM15_CURVED_GOLD, lambda g: 2e-4 * np.maximum(0.05, g)),
        ("tet over-int 3^3", "input_tet_overint_25",
         lambda: periodic_tet_mesh(3, 3, 3), 25, TET_OVERINT_GOLD,
         lambda g: 2e-4 * np.maximum(0.05, g)),
        ("tri+quad over-int 6^2", "input_mix2d_overint_25",
         lambda: periodic_mixed_mesh_2d(6, 6, -pi, pi, -pi, pi), 25,
         MIX2D_OVERINT_GOLD, lambda g: 2e-3 * np.maximum(0.05, g)),
        ("prism over-int 4^3", "input_pri_overint_25",
         lambda: periodic_prism_mesh(4, 4, 4), 25, PRISM_OVERINT_GOLD,
         lambda g: 2e-4 * np.maximum(0.05, g)),
        ("prism/tet wall-model channel 4x4x(2+2)", "input_prism_tet_wm_25",
         lambda: channel_prism_tet_mesh(4, 4, 2, 2, x1=2.0, y1=1.0, z1=1.0),
         100, PRISM_TET_WM_GOLD, lambda g: np.full_like(g, 1e-5)),
    ]
    for name, deck, mesh, n_steps, gold, tol in rows:
        p = RunInput.from_deck(os.path.join(DECKS, deck))
        s = make_solver(p, mesh(), name, "cuda", torch.float64)
        t0 = time.perf_counter()
        res = s.residual_norm(1, last_stage_residual(s, n_steps, p.dt))
        gold = np.asarray(gold)
        tol = tol(gold)
        log(f"reference {name} p={p.order} f64 {n_steps} steps "
            f"({time.perf_counter() - t0:.2f} s): L1 row "
            f"[{', '.join(f'{r:.8e}' for r in res)}], |diff| / tol "
            f"{(np.abs(res - gold) / tol).max():.3f}")
        if not np.all(np.abs(res - gold) < tol):
            raise AssertionError(f"{name} row off the reference: {res}")


def slice_gate(name):
    """(golden row, rtol per row) of a slice: the row of TORCH_GOLDENS
    (`quad`, `tet`, `sem`, `advdiff`) at bench.RTOL, or bench.golden(name)
    (bench.GOLDENS at bench.GATE_RTOL's rtol, the `channel` at
    bench.CHANNEL_RTOL)."""
    if name in TORCH_GOLDENS:
        return TORCH_GOLDENS[name], [bench.RTOL] * len(TORCH_GOLDENS[name])
    return bench.golden(name)


def sem_draws():
    """The JAX package's draws for the `sem` slice's 20 steps (two uniform
    (1000, 3) arrays per step), in the order the inlet takes them."""
    import numpy as np
    with np.load(SEM_DRAWS) as f:
        if float(f["dt"]) != SEM_DT:
            raise AssertionError(f"{SEM_DRAWS} holds dt {float(f['dt'])}, "
                                 f"SEM_DT is {SEM_DT}")
        return [a for step in f["draws"] for a in step]


def phase_slice(card, name, counts):
    """One slice on the card at full width through the port's entry points
    (10 + 10 f32 steps, the bench protocol), gated row by row on
    slice_gate(name) (`advdiff` also its compute_error(2) rows, from the
    same run in f64; `sem`
    replaying the JAX package's draws, its initial state kept in
    IC_SNAPSHOTS); records its launch counts by variant in ``counts``
    and returns the solver and its deck."""
    import numpy as np
    import torch
    from hifiles_tpu_torch.solver.turb_inlet import ReplayDraws
    p, mesh = slice_case(name)
    t0 = time.perf_counter()
    s = make_solver(p, mesh, name, "cuda", torch.float32)
    if name == "sem":
        s.set_inlet_draws(ReplayDraws(sem_draws(), s.device, s.dtype))
        IC_SNAPSHOTS[name] = s.snapshot()
    torch.cuda.synchronize()
    dof = s.dof
    log(f"slice {name}: setup {time.perf_counter() - t0:.2f} s "
        f"({blocks_of(s)}, F={s.n_fields}, d={s.n_dims}, DOF {dof})")

    reset_k1()
    held = captured_run(s, 10, p.dt)
    t0 = time.perf_counter()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = s.residual_norm(1)
    k1 = read_k1(counts, name)
    log(f"slice {name}: run path {s.run_path!r}, capture "
        f"{s.capture_seconds:.3f} s, the graph holds {held / 2**20:.1f} MiB")

    gold, rtol = slice_gate(name)
    rel = np.abs(row - gold) / np.abs(gold)
    log(f"slice {name} residual row [{', '.join(f'{v:.12e}' for v in row)}]")
    log(f"slice {name} golden       {list(map(float, gold))}")
    log(f"slice {name} rel err per row {[float(f'{r:.3e}') for r in rel]} "
        f"(gate {rtol})")
    log(f"slice {name} rate {dof * s.n_stages * 10 / wall:.6e} "
        f"DOF*RK-stage/s over 10 steps ({wall:.4f} s) on [{card}]")
    log(f"slice {name} launches {k1[0]} {counts[name]}, segments {k1[1]}; "
        "by block " + ", ".join(f"U={U} E={E}: {n}" for (_, U, E), n in
                                counts[name + ":blocks"].items()))
    if not (np.isfinite(row).all() and np.all(rel < rtol)):
        raise AssertionError(f"{name} residual row off the golden: {row}")
    if name == "advdiff":
        # the same 10 + 10 steps in f64: the error against the analytic
        # wave
        s64 = make_solver(p, mesh, name, "cuda", torch.float64)
        s64.run(10, dt=p.dt)
        s64.run(10, dt=p.dt)
        err = s64.compute_error(2)[:, 0]
        del s64
        gold = np.asarray(TORCH_GOLDENS["advdiff_error"])
        rel = np.abs(err - gold) / np.abs(gold)
        log(f"slice advdiff f64 compute_error(2) rows (solution, gradient) "
            f"[{', '.join(f'{v:.12e}' for v in err)}], golden "
            f"{list(map(float, gold))}, rel err "
            f"{[float(f'{r:.3e}') for r in rel]} (gate {bench.RTOL})")
        if not (np.isfinite(err).all() and np.all(rel < bench.RTOL)):
            raise AssertionError(f"advdiff error rows off the golden: {err}")
    # every block's volume stage on every RK stage of the 20 steps, and
    # the monitor's (equation 1's scalar volume flux is plain torch)
    need = check_k1(name, k1, s, 10 * 2 * s.n_stages + 1)
    check_k3(name, s, 10 * 2 * s.n_stages + 1)
    check_k4(name, s, 10 * 2 * s.n_stages + 1)
    if name == "sem":
        wale = next(v["key"] for v in VARIANTS if v["name"] == "wale")
        if counts[name].get(wale, 0) < need[0]:
            raise AssertionError(f"volume_tdisf[wale] launched "
                                 f"{counts[name].get(wale, 0)} times on the "
                                 f"sem slice, expected >= {need[0]}")
    else:
        # `sem`'s replayed draws end at step 20: phase_sem holds its graph
        GRAPHS[name] = graph_vs_eager(card, name, s, p.dt)
    return s, p


def phase_sem(card, s, p):
    """The `sem` slice again from its initial state with the default
    draws (a torch.Generator on the card seeded with 0), 20 f32 steps,
    ungated: the state stays finite; its momentum differs from a twin
    with a laminar inlet (inlet_type 0) by more than 1e-8 and less than
    half the inflow velocity (tests/test_turb_inlet.py:56-75); the
    fluctuations of its last step carry a mass flux below 1e-6 of their
    scale.  Then the inlet update's device time per step, the inlet rows'
    extrapolation included.  The solver keeps the device draws."""
    import numpy as np
    import torch
    from hifiles_tpu_torch.solver.turb_inlet import DeviceDraws
    s.restore(IC_SNAPSHOTS.pop("sem"))
    s.set_inlet_draws(DeviceDraws(0, s.device, s.dtype))
    s.run(20, dt=p.dt)
    lam_p, mesh = slice_case("sem")
    lam_p.bc_list[1].inlet_type = 0
    lam = make_solver(lam_p, mesh, "sem", "cuda", torch.float32)
    if lam.turb_inlet is not None:
        raise AssertionError("the laminar twin built a turbulent inlet")
    lam.run(20, dt=p.dt)
    u, u_lam = s.u, lam.u
    diff = float(np.abs(u[..., 1:4] - u_lam[..., 1:4]).max())
    mf, scale = s.turb_inlet.mass_flux()
    log(f"sem device draws, 20 steps: state finite {np.isfinite(u).all()}; "
        f"max |momentum - laminar twin's| {diff:.6e} (gate (1e-8, "
        f"{0.5 * abs(p.u_c_ic):.6e})); inlet mass flux {mf:.6e} of "
        f"{scale:.6e} ({mf / scale:.3e}, gate 1e-6)")
    if not (np.isfinite(u).all() and 1e-8 < diff < 0.5 * abs(p.u_c_ic)
            and mf < 1e-6 * scale):
        raise AssertionError("sem with the device draws failed its checks")
    del lam
    GRAPHS["sem"] = graph_vs_eager(card, "sem", s, p.dt)
    ti, state = s.turb_inlet, s._ti_state
    ms = cuda_ms(lambda: ti.update(state, s._fpt_rows(s.u_soa), p.dt))
    rows = cuda_ms(lambda: s._fpt_rows(s.u_soa))
    log(f"sem inlet update {ms * 1e3:.2f} us per step on the card (of which "
        f"the flux-point extrapolation {rows * 1e3:.2f} us; {ti.n_eddy} "
        f"eddies, {ti.c.wdA.size} inlet points, distance tensor "
        f"3 x {ti.c.wdA.size} x {ti.n_eddy} x 3); on [{card}]")


def phase_channel(card, counts):
    """bench.py's `channel` case on the card through the port's entry
    points (bench.channel_case: the deck, 16^3 channel hexes, p=4, f32,
    10 + 10 steps), gated row by row (slice_gate); records
    its launch counts by variant in ``counts``; then, ungated, 40 steps
    more in 10-step chunks, logging whether the state stays finite (the
    sharded `channel`'s repeats restart from the IC for this reason).
    Returns the solver, back at its gated state, and its deck."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import Solver
    p, mesh = slice_case("channel")
    t0 = time.perf_counter()
    s = Solver(p, mesh, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"slice channel: setup {time.perf_counter() - t0:.2f} s "
        f"(E={s.block.n_eles}, U={s.ops.n_upts}, F={s.n_fields}, "
        f"boundary faces {s.block.bdy_bcid.size})")

    reset_k1()
    held = captured_run(s, 10, p.dt)
    t0 = time.perf_counter()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = s.residual_norm(1)
    launches, _ = read_k1(counts, "channel")
    log(f"slice channel: run path {s.run_path!r}, capture "
        f"{s.capture_seconds:.3f} s, the graph holds {held / 2**20:.1f} MiB")

    rate = s.dof * s.n_stages * 10 / wall
    gold, rtol = slice_gate("channel")
    rel = np.abs(row - gold) / np.abs(gold)
    mflux, ubulk, bf = s.inflow_massflux()
    avg_ok = bool(np.isfinite(s.u_avg).all())
    log(f"slice channel residual row [{', '.join(f'{v:.12e}' for v in row)}]")
    log(f"slice channel golden       {list(map(float, gold))}")
    log(f"slice channel rel err per row {[float(f'{r:.3e}') for r in rel]} "
        f"(gate {rtol})")
    log(f"slice channel rate {rate:.6e} DOF*RK-stage/s over 10 steps "
        f"({wall:.4f} s) on [{card}]")
    log(f"slice channel mass flux {mflux:.12e}, bulk velocity {ubulk:.12e}, "
        f"next body force {bf:.6e}; averages finite: {avg_ok}")
    log(f"slice channel launches {launches} {counts['channel']}")
    if not (np.isfinite(row).all() and np.all(rel < rtol)
            and avg_ok and np.isfinite(mflux)):
        raise AssertionError(f"channel residual row off the golden: {row}")
    smag = counts["channel"].get(
        "D3F5+inviscid+viscous+smagorinsky", 0)
    if smag < 2 * 10 * s.n_stages:
        raise AssertionError(f"volume_tdisf[smagorinsky] launched {smag} "
                             "times on the channel slice, expected >= "
                             f"{2 * 10 * s.n_stages}")
    check_k3("channel", s, 10 * 2 * s.n_stages + 1)
    check_k4("channel", s, 10 * 2 * s.n_stages + 1)
    GRAPHS["channel"] = graph_vs_eager(card, "channel", s, p.dt)
    gated = s.snapshot()
    for step in range(30, 61, 10):
        s.run(10, dt=p.dt)
        u = s.u_soa
        finite = bool(torch.isfinite(u).all())
        log(f"slice channel past its gate, step {step}: state finite "
            f"{finite}, max |u| {u.abs().max().item():.6e}, next body force "
            f"{s.inflow_massflux()[2]:.6e} (ungated)")
        if not finite:
            break
    s.restore(gated)
    return s, p


def state_vector(s):
    """A solver's state, and its running averages, as one tensor on the
    card."""
    import torch
    parts = []
    for x in (s.u_soa, s.u_avg_soa):
        if x is not None:
            parts += [q.reshape(-1) for q in getattr(x, "parts", [x])]
    return torch.cat(parts)


def graph_vs_eager(card, name, s, dt, n=10):
    """The graph phase for one cell: ``n`` captured steps held against
    ``n`` eager steps (``run(..., graph=False)``) from the same snapshot
    (bit for bit expected; gate 1e-6 * max|u| in f32, 1e-12 in f64, the
    running averages included); the device kernels of a replayed step
    against those of an eager step (within 1%), the volume kernel among
    them as often; the capture's time and what the graph holds.  The
    solver returns to its state at the call.  Returns the record."""
    import torch
    snap = s.snapshot()
    s.run(n, dt=dt, graph=False)
    eager = state_vector(s)
    s.restore(snap)
    s.run(n, dt=dt)
    captured = state_vector(s)
    path = s.run_path
    diff = float((captured - eager).abs().max())
    scale = float(eager.abs().max())
    exact = bool(torch.equal(captured, eager))
    for _ in range(2):
        k_e, k1_e = bench.step_kernels(s, dt, graph=False)
        k_g, k1_g = bench.step_kernels(s, dt, graph=True)
        if abs(k_g - k_e) <= 0.01 * k_e and k1_g == k1_e:
            break
        # the profiler has been seen to drop some of an eager step's
        # records on the H100; a second trace settles it
        log(f"graph {name}: traced kernels {k_g} replayed, {k_e} eager; "
            "traced again")
    s.restore(snap)
    tol = (1e-6 if s.dtype == torch.float32 else 1e-12) * scale
    rec = dict(diff=diff, scale=scale, exact=exact, eager=k_e / s.n_stages,
               replay=k_g / s.n_stages, k1_eager=k1_e, k1_replay=k1_g,
               capture_s=s.capture_seconds)
    log(f"graph {name}: {n} captured steps vs {n} eager from one snapshot: "
        f"max |diff| {diff:.3e} of max |u| {scale:.6e} (gate {tol:.3e}), "
        f"bit for bit {exact}; device kernels per RK stage replayed "
        f"{k_g / s.n_stages:.1f}, eager {k_e / s.n_stages:.1f} (gate 1%); "
        f"volume kernel per step replayed {k1_g}, eager {k1_e}; capture "
        f"{s.capture_seconds:.3f} s; run path {path!r}; on [{card}]")
    if not (torch.isfinite(captured).all() and diff <= tol
            and abs(k_g - k_e) <= 0.01 * k_e and k1_g == k1_e
            and path.endswith("captured")):
        raise AssertionError(f"graph {name}: the captured step differs from "
                             "the eager step")
    return rec


def captured_run(s, n, dt):
    """``s.run(n, dt)`` on the captured path, synchronised; returns the
    memory the run left reserved on the card once the allocator's cache
    is emptied: a first captured run's is the graph's pool."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    s.run(n, dt=dt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if not s.run_path.endswith("captured"):
        raise AssertionError(f"run path {s.run_path!r} on the card")
    return torch.cuda.memory_reserved() - before


def log_memory(phase):
    """The card's peak reserved memory so far, and the script's wall
    seconds, after a phase."""
    import torch
    log(f"wall after {phase}: {time.perf_counter() - T_START:.1f} s")
    log(f"memory after {phase}: max reserved "
        f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB, reserved now "
        f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB")


def phase_rates(card, runs, repeats=N_RATE_REPEATS):
    """bench.rates of ``runs`` (name -> (solver, deck)), captured and
    eager, logged with the card's name; returns its record."""
    out = bench.rates(runs, repeats)
    for name, rec in out.items():
        for mode, r in rec.items():
            log(f"rate {name} {mode}: median {r['median']:.6e} "
                f"[{r['quartiles'][0]:.6e}, {r['quartiles'][1]:.6e}] "
                f"DOF*RK-stage/s over {repeats} interleaved 10-step "
                f"repeats; {r['kernels']:.1f} device kernels per RK stage; "
                f"on [{card}]")
        log(f"rate {name}: captured / eager "
            f"{rec['captured']['median'] / rec['eager']['median']:.3f}")
    return out


def phase_bench(card, counts, plain_rate):
    """``python3 -m hifiles_tpu_torch.bench plain`` as a subprocess from
    the repository's root: its last stdout line, bench.py's JSON record of
    one configuration, gated, with no ``configs``, its captured median
    within 15% of ``plain_rate`` (this process's `plain` median); the
    volume kernel's launches it prints (into ``counts`` as path
    "bench"), at least those of its 10 + 10 steps and repeats."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "hifiles_tpu_torch.bench",
                          "plain"], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"hifiles_tpu_torch.bench plain exited "
                             f"{res.returncode}:\n{res.stdout[-2000:]}\n"
                             f"{res.stderr[-4000:]}")
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    launches = json.loads(re.search(
        r"^bench\[plain\] volume_tdisf launches: (.*)$", res.stderr,
        re.M).group(1))
    counts["bench"] = launches
    ns_key = next(v["key"] for v in VARIANTS if v["name"] == "ns")
    need = 5 * 10 * (2 + 2 * N_RATE_REPEATS)
    ratio = rec["value"] / plain_rate
    log(f"bench entry point: {rec}; {ratio:.3f} x this process's `plain` "
        f"captured median (gate 0.85-1.15); volume_tdisf launches "
        f"{launches} (>= {need}); process {wall:.1f} s; on [{card}]")
    for line in res.stderr.splitlines():
        if line.startswith("bench"):
            log(f"bench entry point stderr: {line}")
    if not (set(rec) == {"metric", "value", "unit", "vs_baseline", "gated"}
            and rec["gated"] is True and 0.85 < ratio < 1.15
            and launches.get(ns_key, 0) >= need):
        raise AssertionError(f"the bench entry point's record {rec} or "
                             f"launches {launches} fail their checks")


def run_driver(deck, outdir, *extra):
    """``python3 -m hifiles_tpu_torch deck --outdir outdir *extra`` on the
    card, as a subprocess from the repository's root: its stdout, and the
    volume kernel's launches by variant and the wall seconds by part that
    it prints."""
    res = subprocess.run([sys.executable, "-m", "hifiles_tpu_torch", deck,
                          "--outdir", outdir, *extra], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"driver on {deck} exited {res.returncode}:\n"
                             f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    read = lambda key: json.loads(re.search(rf"^{key}: (.*)$", res.stdout,
                                            re.M).group(1))
    return res.stdout, read("volume_tdisf launches"), read("wall seconds")


def history_rows(path):
    """history.plt's header lines and its rows as float arrays."""
    import numpy as np
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[:2], [np.array(line.split(), dtype=float)
                       for line in lines[2:]]


def check_driver_files(d, step):
    """The first driver run's files at ``step``: the .pvtu and its .vtu
    well-formed XML holding rho, vorticity and q_criterion; history.plt's
    header and 2 finite rows; the ASCII restart's header, element count
    and data rows.  Returns a description."""
    import xml.etree.ElementTree as ET
    import numpy as np
    name = f"Mesh_{step:09d}"
    ET.parse(os.path.join(d, name + ".pvtu"))
    vtu = ET.parse(os.path.join(d, name, name + "_p0000.vtu"))
    fields = {da.get("Name") for da in vtu.iter("DataArray")}
    if not {"rho", "vorticity", "q_criterion"} <= fields:
        raise AssertionError(f"vtu fields {sorted(fields - {None})}")
    for da in vtu.iter("DataArray"):
        if da.get("Name") in ("rho", "vorticity", "q_criterion"):
            vals = np.array(da.text.split(), dtype=float)
            if not (vals.size and np.isfinite(vals).all()):
                raise AssertionError(f"vtu field {da.get('Name')}")
    head, rows = history_rows(os.path.join(d, "history.plt"))
    if not (head[0].startswith("VARIABLES") and len(rows) == 2
            and all(np.isfinite(r).all() for r in rows)):
        raise AssertionError(f"history.plt: {head}, {len(rows)} rows")
    with open(os.path.join(d, f"Rest_{step:09d}_p0000.dat")) as f:
        lines = f.read().splitlines()
    E, U = int(lines[9]), int(lines[5])
    data = [x for x in lines[13:] if x]
    if not (lines[1] == "HEXAS" and len(data) == E * (U + 1)
            and float(lines[0]) > 0):
        raise AssertionError(f"restart file header {lines[:10]}")
    return (f"vtu fields {sorted(fields - {None})}, history {len(rows)} "
            f"rows, restart E={E} U={U} t={float(lines[0]):.6e}")


def phase_driver(card, api_solver, api_rate):
    """The port's entry point, ``python3 -m hifiles_tpu_torch <deck>``, on
    the `plain` case at full width: tgv_deck on periodic_hex_mesh(16, 16,
    16) written with the port's write_gambit (4,096 hexes, p=4, f32, 20
    steps, output at step 20), gated on bench.GOLDENS["plain"] as
    phase_slice gates the API run; its files parsed; its volume kernel
    launched; then a restart from its ASCII dump for 10 steps, whose
    iter-30 history row must equal an uninterrupted 30-step run's (rtol
    1e-5), that run profiling its first 10-step chunk for the launches per
    RK stage.  ``api_solver`` and ``api_rate`` are the API's `plain` run
    and its median rate, printed beside the driver's.  Returns the first
    run's history rows."""
    import numpy as np
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    d = os.path.join(ROOT, "build", "driver_tgv")
    d30 = os.path.join(ROOT, "build", "driver_tgv30")
    for x in (d, d30):
        shutil.rmtree(x, ignore_errors=True)
        os.makedirs(x)
    t0 = time.perf_counter()
    write_gambit(periodic_hex_mesh(16, 16, 16), os.path.join(d, "tgv16.neu"))
    log(f"driver: tgv16.neu written in {time.perf_counter() - t0:.3f} s")
    decks = {"run": tgv_deck("tgv16.neu"),
             "restart": tgv_deck("tgv16.neu", n_steps=10, restart_flag=1,
                                 restart_iter=20, n_restart_files=1),
             "whole": tgv_deck("tgv16.neu", n_steps=30, plot_freq=10**6,
                               restart_dump_freq=10**6)}
    for name, text in decks.items():
        with open(os.path.join(d, name + ".deck"), "w") as f:
            f.write(text)
    deck = lambda name: os.path.join(d, name + ".deck")

    t0 = time.perf_counter()
    out, launches, wall = run_driver(deck("run"), d)
    total = time.perf_counter() - t0
    if not re.search(r"^run path: SoA \(fast\) captured$", out, re.M):
        raise AssertionError("the driver's steps did not run captured")
    row = np.array(re.search(r"^iter +20 .*res: (.*)$", out, re.M)
                   .group(1).split(), dtype=float)
    gold, rtol = slice_gate("plain")
    rel = np.abs(row - gold) / np.abs(gold)
    log(f"driver plain iter-20 row [{', '.join(f'{v:.6e}' for v in row)}]")
    log(f"driver plain rel err per row {[float(f'{r:.3e}') for r in rel]} "
        f"(gate {rtol})")
    if not (np.isfinite(row).all() and np.all(rel < rtol)):
        raise AssertionError(f"driver's iter-20 row off the golden: {row}")
    log(f"driver plain files: {check_driver_files(d, 20)}")
    _, rows_first = history_rows(os.path.join(d, "history.plt"))
    ns_key = next(v["key"] for v in VARIANTS if v["name"] == "ns")
    log(f"driver plain volume_tdisf launches in its process: {launches}")
    if launches.get(ns_key, 0) <= 0:
        raise AssertionError(f"volume_tdisf[ns] ({ns_key}) not launched "
                             "by the driver")
    steps = wall["steps"]
    log(f"driver plain process {total:.3f} s; steps 11-20 {steps:.4f} s, "
        f"{steps / 50 * 1e3:.4f} ms per RK stage (steps 1-10, the first "
        f"chunk, {wall['first chunk']:.4f} s); the API's median "
        f"{api_solver.dof / api_rate * 1e3:.4f} ms per RK stage; on [{card}]")
    # the API on the mesh the driver read: Gambit's 12-digit coordinates
    # leave the geometry uniform only to ~1e-11, so the 1e-12 compression
    # test (residual_soa._uniform_column) keeps it per element
    import torch
    from hifiles_tpu_torch import Solver
    from hifiles_tpu_torch.mesh.gambit import read_gambit
    from hifiles_tpu_torch.solver.residual_soa import _uniform_column
    s = Solver(tgv_input(order=4), read_gambit(os.path.join(d, "tgv16.neu")),
               device="cuda", dtype=torch.float32)
    s.run(10, dt=s.p.dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(10, dt=s.p.dt)
    torch.cuda.synchronize()
    api_ms = (time.perf_counter() - t0) / 50 * 1e3
    uniform = _uniform_column(s.block.jginv_upts, 0) is not None
    log(f"driver plain: the API on the driver's Gambit mesh {api_ms:.4f} ms "
        f"per RK stage (steps 11-20; geometry compressed: {uniform}); on "
        f"[{card}]")
    del s
    out2, _, wall2 = run_driver(deck("restart"), d)
    for part, sec in list(wall.items()) + [("restart read",
                                            wall2["restart read"])]:
        log(f"driver plain wall {part}: {sec:.4f} s on [{card}]")
    _, rows_restart = history_rows(os.path.join(d, "history.plt"))
    out3, _, _ = run_driver(deck("whole"), d30, "--profile")
    _, rows_whole = history_rows(os.path.join(d30, "history.plt"))
    a, b = rows_restart[-1], rows_whole[-1]
    rel = np.abs(a[1:-1] - b[1:-1]) / np.abs(b[1:-1])
    log(f"driver restart at 20 -> iter {a[0]:.0f} history row "
        f"{a[1:-1].tolist()}; uninterrupted {b[1:-1].tolist()}; rel err "
        f"{rel.max():.3e} (gate 1e-5)")
    if not (a[0] == b[0] == 30 and np.all(rel < 1e-5)):
        raise AssertionError("restart continuation differs from the "
                             "uninterrupted run")
    with open(os.path.join(d30, "torch_trace")) as f:
        events = json.load(f)["traceEvents"]
    n_dev = sum(1 for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"))
    log(f"driver plain device kernels per RK stage {n_dev / 50:.1f} ({n_dev} "
        "device kernels, copies and memsets in its profiled second chunk: "
        "10 replayed steps of 5 stages and one monitor residual)")
    return rows_first


def small_sharded():
    """name -> (deck, mesh, shards) of the sharded card-vs-CPU runs: the
    4^3 p=3 TGV in 4 shards; the walled quad channel (8 x 4, p=3) in 7
    shards of unequal size; the forced LES channel's small twin (4 x 4 x 2,
    p=2) in 3; the 4^3 SEM duct (p=2) in 4, its draws one numpy stream;
    through ShardedMixedSolver the tri+quad box with Smagorinsky LES and
    the wall-modelled prism/tet channel of small_mixed(), in 4 each."""
    from hifiles_tpu_torch import channel_hex_mesh, periodic_hex_mesh
    mixed = small_mixed()
    return {
        "tgv x4": (tgv_input(order=3), periodic_hex_mesh(4, 4, 4), 4),
        "quad_channel x7": (quad_wall_input(), quad_wall_mesh(), 7),
        "channel x3": (channel_input(order=2), channel_hex_mesh(4, 4, 2), 3),
        "sem_duct x4": (les_duct_input(order=2, n_eddy=40), duct_mesh(4), 4),
        "mixed_les x4": mixed["mixed_les"] + (4,),
        "prism_tet_wm x4": mixed["prism_tet_wm"] + (4,),
    }


def make_sharded(p, mesh, n, device, dtype):
    """The port's ShardedSolver, or its ShardedMixedSolver for a mesh of
    several element types or of prisms, in ``n`` shards on ``device``
    (select_devices: "cuda" round-robin over the visible cards, "cuda:0"
    all on the first, as the one-card phases place them)."""
    import numpy as np
    from hifiles_tpu_torch import PRISM
    from hifiles_tpu_torch.parallel import (ShardedMixedSolver,
                                            ShardedSolver, select_devices)
    types = np.unique(mesh.ctype)
    mixed = types.size > 1 or int(types[0]) == PRISM
    return (ShardedMixedSolver if mixed else ShardedSolver)(
        p, mesh, devices=select_devices(n, device), dtype=dtype)


def phase_sharded_small(counts):
    """Each case of small_sharded() in f64 for 2 steps: its shards on the
    card against the same shards on the CPU and against the single-device
    solver on the card (Solver or MixedSolver), states held at
    1e-11 * max(scale, 1); the inlet case replays one numpy draw stream
    on all three.  Adds each card run's launch counts to ``counts``."""
    import numpy as np
    import torch
    from hifiles_tpu_torch.solver.turb_inlet import ReplayDraws
    f64 = torch.float64
    for name, (p, mesh, n) in small_sharded().items():
        gpu = make_sharded(p, mesh, n, "cuda:0", f64)
        cpu = make_sharded(p, mesh, n, "cpu", f64)
        one = make_solver(p, mesh, name, "cuda", f64)
        if one.turb_inlet is not None:
            draws = numpy_draws(one.turb_inlet, 2)
            for s in (gpu, cpu, one):
                s.set_inlet_draws(ReplayDraws(draws, s.device, s.dtype))
        reset_k1()
        gpu.run(2, dt=p.dt)
        torch.cuda.synchronize()
        vol = launches_of()
        run_counts = vol["by_variant"]
        k1 = (vol["launches"], vol["segments"])
        if not gpu.run_path.endswith("captured"):
            raise AssertionError(f"sharded {name}: run path "
                                 f"{gpu.run_path!r}")
        cpu.run(2, dt=p.dt)
        one.run(2, dt=p.dt)
        ug, uc = (flat(s.gather_u()) for s in (gpu, cpu))
        u1 = flat(one.u)
        scale = max(np.abs(uc).max(), 1.0)
        e_cpu = np.abs(ug - uc).max() / scale
        e_one = np.abs(ug - u1).max() / scale
        need = tuple(2 * gpu.n_stages * k for k in k1_per_stage(gpu))
        log(f"sharded small {name} f64 {type_names(mesh)} E={mesh.n_cells} "
            f"p={p.order}, shard sizes "
            f"{[sum(E for _, E in sh) for sh in gpu._shard_shapes]}: card vs "
            f"CPU shards {e_cpu:.3e}, vs the card's single-device solver "
            f"{e_one:.3e} (of max(scale, 1), bound 1e-11); launches "
            f"{run_counts}, segments {k1[1]}")
        if not (np.isfinite(ug).all() and e_cpu <= 1e-11 and e_one <= 1e-11
                and k1[0] >= need[0] and k1[1] >= need[1]):
            raise AssertionError(f"sharded {name}: card shards disagree with "
                                 "the CPU or the single-device run, or "
                                 f"volume_tdisf's (launches, segments) "
                                 f"{k1} < {need}")
        counts["sharded " + name] = run_counts


def phase_legs(counts):
    """The dry run of hifiles_tpu_torch.multichip on the card:
    dryrun_multichip(LEG_SHARDS, "cuda:0") in f64, the JAX package's eight
    legs at their dry-run shapes with every shard on the card (one
    whole-step capture a leg), then LEG_MORE_STEPS replayed steps of each,
    against the same legs on the CPU, state (and the channel's averages)
    at 1e-11 * max(scale, 1); the volume kernel launched once a stage
    carrying the leg's every shard, counted in ``counts`` under `legs`.
    Prints the phase's wall seconds."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import multichip
    t0 = time.perf_counter()
    f64 = torch.float64
    reset_k1()
    card = multichip.dryrun_multichip(LEG_SHARDS, "cuda:0", f64)
    for s in card.values():
        s.run(LEG_MORE_STEPS, dt=s.p.dt)
    torch.cuda.synchronize()
    k1 = read_k1(counts, "legs")
    t_card = time.perf_counter() - t0
    cpu = multichip.dryrun_multichip(LEG_SHARDS, "cpu", f64)
    for name, s in cpu.items():
        s.run(LEG_MORE_STEPS, dt=s.p.dt)
        g = card[name]
        ug, uc = flat(g.gather_u()), flat(s.gather_u())
        if g.u_avg_soa is not None:
            ug = np.concatenate([ug, g.gather_u_avg().ravel()])
            uc = np.concatenate([uc, s.gather_u_avg().ravel()])
        err = np.abs(ug - uc).max() / max(np.abs(uc).max(), 1.0)
        log(f"legs {name} f64: {g.mesh.n_cells} cells in {LEG_SHARDS} "
            f"shards, shard 0's blocks {g._shard_shapes[0]} (U, E); run "
            f"path {g.run_path!r}, capture {g.capture_seconds:.3f} s; card "
            f"vs CPU {err:.3e} (of max(scale, 1), bound 1e-11)")
        if not (g.run_path.endswith("captured") and g.captures == 1
                and np.isfinite(ug).all() and err <= 1e-11):
            raise AssertionError(f"legs {name}: the card's run disagrees "
                                 f"with the CPU's ({err}) or ran "
                                 f"{g.run_path!r}")
    wall = time.perf_counter() - t0
    need = sum((leg.steps + LEG_MORE_STEPS) for leg in multichip.LEGS.values())
    log(f"legs: {len(card)} legs on the card in {t_card:.1f} s, with the CPU "
        f"twins {wall:.1f} s; volume_tdisf launches {k1[0]}, segments "
        f"{k1[1]} (one launch a stage and leg: >= {need} x 5); by group "
        + ", ".join(f"{key} {list(shapes)}: {n}" for (key, shapes), n in
                    counts["legs:groups"].items()))
    if k1[0] < 5 * need or k1[1] < 5 * need * LEG_SHARDS:
        raise AssertionError(f"legs: volume_tdisf (launches, segments) {k1}, "
                             f"expected >= {(5 * need, 5 * need * LEG_SHARDS)}")


def phase_sharded(card, counts, plain):
    """The sharded cells of SHARDED_SLICES at full width, f32, all shards
    on the one card, through the API: 10 + 10 steps each, gated row by
    row as the single-device slice is (`channel` row 3 at 0.25); the
    volume kernel launched once at every RK stage (and the monitor's),
    carrying every shard's every block, counted per replay;
    each cell's graph against its eager step (graph_vs_eager); then their
    rates, captured and eager, beside single-device `plain` (``plain``:
    its solver and deck) in SHARDED_REPEATS interleaved repeats, and
    device kernels per RK stage; the `channel` repeats each start from
    its initial state: the deck's body
    force grows about 100-fold every 10 steps at bench.run_channel's dt,
    and scripts/shard_controls.py on an H100 read the single-device run
    non-finite by step 60 in f32 and by step 70 in f64, the 3 shards at the
    same steps (phase_channel logs the single-device f32 run's).  Records
    launch counts by variant and by block shape in ``counts``."""
    import numpy as np
    import torch
    runs = {"plain": plain}
    for cell, (name, n) in SHARDED_SLICES.items():
        p, mesh = slice_case(name)
        t0 = time.perf_counter()
        s = make_sharded(p, mesh, n, "cuda:0", torch.float32)
        if name == "channel":
            ic = s.snapshot()
        torch.cuda.synchronize()
        log(f"sharded {cell}: setup {time.perf_counter() - t0:.2f} s "
            f"({blocks_of(s)}; DOF {s.dof}; halo points per shard "
            f"{[t.slot_h.size for t in s.soa_tables]})")
        reset_k1()
        held = captured_run(s, 10, p.dt)
        t0 = time.perf_counter()
        s.run(10, dt=p.dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = s.residual_norm(1)
        k1 = read_k1(counts, cell)
        log(f"sharded {cell}: run path {s.run_path!r}, capture "
            f"{s.capture_seconds:.3f} s, the graph holds "
            f"{held / 2**20:.1f} MiB")
        gold, rtol = slice_gate(name)
        rel = np.abs(row - gold) / np.abs(gold)
        log(f"sharded {cell} residual row "
            f"[{', '.join(f'{v:.12e}' for v in row)}]; rel err per row "
            f"{[float(f'{r:.3e}') for r in rel]} (gate {rtol})")
        need = check_k1(cell, k1, s, 10 * 2 * s.n_stages + 1)
        log(f"sharded {cell} rate {s.dof * s.n_stages * 10 / wall:.6e} "
            f"DOF*RK-stage/s over 10 steps ({wall:.4f} s); volume_tdisf "
            f"launches {k1[0]}, segments {k1[1]} (stages + monitor, one "
            f"launch a stage carrying shards x blocks: {need}) "
            f"{counts[cell]}; by block "
            + ", ".join(f"U={U} E={E}: {k}" for (_, U, E), k in
                        counts[cell + ":blocks"].items()) + f"; on [{card}]")
        if not (np.isfinite(row).all() and np.all(rel < rtol)):
            raise AssertionError(f"sharded {cell} residual row off the "
                                 f"golden: {row}")
        GRAPHS[cell] = graph_vs_eager(card, cell, s, p.dt)
        if name == "channel":
            s.restore(ic)
        runs[cell] = (s, p)
    rates = phase_rates(card, runs, SHARDED_REPEATS)
    for cell in SHARDED_SLICES:
        for mode in ("captured", "eager"):
            ratio = (rates[cell][mode]["median"]
                     / rates["plain"][mode]["median"])
            log(f"sharded {cell}: {mode} rate {ratio:.3f} x single-device "
                f"plain's {mode} rate in the same turns")


def phase_driver_sharded(card, counts, rows_one):
    """``python3 -m hifiles_tpu_torch <deck> --devices DRIVER_SHARDS`` on
    phase 7's `plain` deck and Gambit file (f32, 20 steps, all shards on
    the card): its iter-20 row gated on bench.GOLDENS["plain"]; its
    history rows against phase 7's single-device run's ``rows_one``
    (iteration and time equal; the residual norms at rtol 1e-3 and the
    integral quantities at 1e-6, between what sound and faulty halos read
    in scripts/shard_controls.py on an H100: sound 3.4e-4 and 7.1e-8, the
    partner's points of each halo face reversed 8.0 and 5.1e-5, the
    receive buffers zeroed a NaN abort; a halo fault of the viscous flux
    alone stays under both, and phase 4's f64 cases hold it); its files
    parsed;
    its volume kernel launches (in ``counts``), wall seconds per part and,
    profiled, launches per RK stage."""
    import numpy as np
    d = os.path.join(ROOT, "build", "driver_tgv")
    d4 = os.path.join(ROOT, "build", "driver_tgv_shards")
    shutil.rmtree(d4, ignore_errors=True)
    os.makedirs(d4)
    shutil.copy(os.path.join(d, "run.deck"), d4)
    shutil.copy(os.path.join(d, "tgv16.neu"), d4)
    t0 = time.perf_counter()
    out, launches, wall = run_driver(os.path.join(d4, "run.deck"), d4,
                                     "--devices", str(DRIVER_SHARDS),
                                     "--device", "cuda:0",
                                     "--profile")
    total = time.perf_counter() - t0
    if not re.search(r"^run path: SoA \(fast\) captured$", out, re.M):
        raise AssertionError("the sharded driver's steps did not run "
                             "captured")
    row = np.array(re.search(r"^iter +20 .*res: (.*)$", out, re.M)
                   .group(1).split(), dtype=float)
    gold, rtol = slice_gate("plain")
    rel = np.abs(row - gold) / np.abs(gold)
    log(f"driver plain --devices {DRIVER_SHARDS} iter-20 row "
        f"[{', '.join(f'{v:.6e}' for v in row)}]; rel err per row "
        f"{[float(f'{r:.3e}') for r in rel]} (gate {rtol})")
    if not (re.search(rf"^shards: {DRIVER_SHARDS} on cuda:0 "
                      rf"x{DRIVER_SHARDS}$", out, re.M)
            and np.isfinite(row).all() and np.all(rel < rtol)):
        raise AssertionError(f"sharded driver's iter-20 row off the golden "
                             f"or its shards not on the card: {row}")
    log(f"driver plain --devices {DRIVER_SHARDS} files: "
        f"{check_driver_files(d4, 20)}")
    head, rows = history_rows(os.path.join(d4, "history.plt"))
    n_res = head[0].count('"res_')
    worst_res = worst_int = 0.0
    for a, b in zip(rows, rows_one):
        if a[0] != b[0] or a[-2] != b[-2]:
            raise AssertionError(f"history rows {a[:1]} / {b[:1]}: iteration "
                                 "or time differ")
        # the residual columns are log10 of the norms: compared as norms
        ra, rb = 10.0 ** a[1:1 + n_res], 10.0 ** b[1:1 + n_res]
        worst_res = max(worst_res, float((np.abs(ra - rb) / rb).max()))
        worst_int = max(worst_int, float(
            (np.abs(a[1 + n_res:-2] - b[1 + n_res:-2])
             / np.abs(b[1 + n_res:-2])).max()))
    log(f"driver plain --devices {DRIVER_SHARDS} history rows vs the "
        f"single-device run's: residual norms max rel diff {worst_res:.3e} "
        f"(gate 1e-3), integral quantities {worst_int:.3e} (gate 1e-6)")
    if not (len(rows) == len(rows_one) == 2 and worst_res < 1e-3
            and worst_int < 1e-6):
        raise AssertionError("sharded driver's history differs from the "
                             "single-device run's")
    ns_key = next(v["key"] for v in VARIANTS if v["name"] == "ns")
    counts["driver --devices"] = launches
    counts["driver --devices:blocks"] = {
        (key, U, E): k for key, U, E, k in json.loads(re.search(
            r"^volume_tdisf segments by shape: (.*)$", out, re.M).group(1))}
    counts["driver --devices:groups"] = {
        (key, tuple(map(tuple, shapes))): k
        for key, shapes, k in json.loads(re.search(
            r"^volume_tdisf launches by group: (.*)$", out, re.M).group(1))}
    segments = sum(counts["driver --devices:blocks"].values())
    # one launch a stage carrying the shards, 20 steps of 5 stages
    need = 20 * 5
    with open(os.path.join(d4, "torch_trace")) as f:
        events = json.load(f)["traceEvents"]
    n_dev = sum(1 for e in events if e.get("cat") in ("kernel", "gpu_memcpy",
                                                      "gpu_memset"))
    log(f"driver plain --devices {DRIVER_SHARDS}: process {total:.3f} s; "
        f"steps 11-20 {wall['steps']:.4f} s, "
        f"{wall['steps'] / 50 * 1e3:.4f} ms per RK stage; set-up "
        f"{wall['solver set-up']:.3f} s; volume_tdisf launches {launches} "
        f"(>= stages = {need}), segments {segments} (>= shards x stages = "
        f"{DRIVER_SHARDS * need}), by (variant, U, E) "
        f"{counts['driver --devices:blocks']}; {n_dev / 50:.1f} device "
        f"kernels per RK stage in its profiled second chunk (replays); on "
        f"[{card}]")
    if launches.get(ns_key, 0) < need or segments < DRIVER_SHARDS * need:
        raise AssertionError(f"volume_tdisf[ns] launched "
                             f"{launches.get(ns_key, 0)} times carrying "
                             f"{segments} segments by the sharded driver, "
                             f"expected >= {need} and "
                             f"{DRIVER_SHARDS * need}")


def phase_multicard(counts):
    """The multi-card paths of scripts/multicard_torch.py, when the machine
    shows more than one card: its cells (`plain` x4, `channel` x3,
    `mixed3d` x4, each card capturing its own shards' segments of the
    step, gated and held to the same shards on one card and to the eager
    step bit for bit, with their rates), its driver part (``--devices
    4`` on the cards, its history held to the single-device run's, its
    restart continued) and its legs part (the dry run's legs in 8 shards,
    several a card, bit for bit the same shards on one card and the eager
    step; their volume kernel launches in ``counts`` under `legs on 4
    cards`); any miss raises.  On one card, one line on stderr saying that
    the phase was not run."""
    import torch
    k = torch.cuda.device_count()
    if k < 2:
        print(f"chip_smoke: multicard phase not run: {k} visible card (it "
              "needs 2 or more)", file=sys.stderr, flush=True)
        return
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import multicard_torch
    for name in multicard_torch.card_names():
        log(f"multicard: card {name}")
    for rec in multicard_torch.run_cells():
        log(f"multicard {rec['cell']}: captured rate "
            f"{rec['rates'][rec['cell']]['captured']['median']:.6e} "
            f"DOF*RK-stage/s, the same shards on one card "
            f"{rec['rates'][rec['cell'] + ' on one card']['captured']['median']:.6e}")
    multicard_torch.run_driver_part()
    legs = {}
    multicard_torch.run_legs(legs)
    counts["legs on 4 cards"] = dict(legs["by_variant"])
    counts["legs on 4 cards:blocks"] = dict(legs["by_shape"])
    counts["legs on 4 cards:groups"] = dict(legs["by_group"])


def phase_diagnostics(card):
    """Card-vs-CPU f64 cases of the diagnostics the driver and writers
    read, each held at 1e-12 * max(scale, 1): compute_dt for dt_type 1
    and 2 (the viscous 4^3 p=3 hex box, a tet box, the tri+quad box
    through MixedSolver) and the state after 5 steps with it;
    gradient_fn on the hex box and the walled quad channel; sensor_fn on
    the `shock` configuration; compute_forces on the walled quad channel.
    Then the Couette case against the reference binary's rows, and, with
    h5py, an HDF5 restart round trip and a CGNS write."""
    import importlib.util
    import numpy as np
    import torch
    from hifiles_tpu_torch import (RunInput, Solver, periodic_hex_mesh,
                                   periodic_mixed_mesh_2d, periodic_tet_mesh)
    from hifiles_tpu_torch.io.forces import compute_forces
    f64 = torch.float64
    as_np = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))

    def held(name, got, want):
        got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
        err = np.abs(got - want).max()
        scale = np.abs(want).max()
        bound = 1e-12 * max(scale, 1.0)
        log(f"diagnostics {name} f64 card vs CPU: max abs err {err:.3e} "
            f"(bound {bound:.3e}, scale {scale:.3e})")
        if not (got.shape == want.shape and np.isfinite(got).all()
                and err <= bound):
            raise AssertionError(f"{name}: card disagrees with the CPU")

    def both(p, mesh, config=None, seed=0):
        """The card's and the CPU's solver from the same seeded state."""
        gpu = make_solver(p, mesh, config, "cuda", f64)
        cpu = make_solver(p, mesh, config, "cpu", f64)
        rng = np.random.default_rng(seed)
        u = tuple(a * (1.0 + 0.02 * rng.random(a.shape)) for a in
                  (cpu.u if isinstance(cpu.u, tuple) else (cpu.u,)))
        for s in (gpu, cpu):
            s.set_state(u, tuple(np.zeros_like(a) for a in u), 0.0)
        return gpu, cpu, u

    dt_cases = {
        "hex 4^3 p=3": lambda: (tgv_input(order=3), periodic_hex_mesh(4, 4,
                                                                      4)),
        "tet 2^3 p=3": lambda: (tgv_input(order=3), periodic_tet_mesh(2, 2,
                                                                      2)),
        "tri+quad 6^2 p=3": lambda: (bench.mixed_input(order=3),
                                     periodic_mixed_mesh_2d(6, 6, -10, 10,
                                                            -10, 10)),
    }
    for name, make in dt_cases.items():
        for dt_type in (1, 2):
            p, mesh = make()
            p.dt_type, p.CFL = dt_type, 0.5
            gpu, cpu, _ = both(p, mesh)
            held(f"compute_dt {name} dt_type {dt_type}",
                 as_np(gpu.compute_dt()), as_np(cpu.compute_dt()))
            for _ in range(5):
                gpu.run(1, dt=gpu.compute_dt())
                cpu.run(1, dt=cpu.compute_dt())
            held(f"{name} dt_type {dt_type} state after 5 CFL steps",
                 flat(gpu.u), flat(cpu.u))
    for name, (p, mesh) in {
            "gradient_fn hex 4^3 p=3": (tgv_input(order=3),
                                        periodic_hex_mesh(4, 4, 4)),
            "gradient_fn walled quad channel": (quad_wall_input(),
                                                quad_wall_mesh())}.items():
        gpu, cpu, u = both(p, mesh)
        held(name, gpu.gradient_fn(u[0]), cpu.gradient_fn(u[0]))
    gpu, cpu, u = both(tgv_input(order=3, config="shock"),
                       periodic_hex_mesh(4, 4, 4), "shock")
    held("sensor_fn shock 4^3 p=3", gpu.sensor_fn(u[0]), cpu.sensor_fn(u[0]))
    gpu, cpu, _ = both(quad_wall_input(), quad_wall_mesh())
    fg, fc = compute_forces(gpu), compute_forces(cpu)
    held("compute_forces walled quad channel",
         np.concatenate([fg[k].ravel() for k in sorted(fg)]),
         np.concatenate([fc[k].ravel() for k in sorted(fc)]))

    # the Couette case: the driver's error.dat solution row, and the
    # gradient row of the last RK stage's input state, the state the
    # reference binary's row is of (tests/test_regression_reference.py:
    # 289-302), against the goldens
    from hifiles_tpu_torch.convert import ufe_to_euf
    from hifiles_tpu_torch.driver import main as driver_main
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    from hifiles_tpu_torch.mesh.generate import ywall_channel_quad_mesh
    from hifiles_tpu_torch.solver.step import RK45_A, RK45_B
    d = os.path.join(ROOT, "build", "driver_couette")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    mesh = ywall_channel_quad_mesh(4, 4, 0.0, 2.0, 0.0, 1.0,
                                   bc_ymin="Isotherm_Fix",
                                   bc_ymax="Isotherm_Mov")
    write_gambit(mesh, os.path.join(d, "quad_couette.neu"))
    shutil.copy(os.path.join(DECKS, "input_couette_50"),
                os.path.join(d, "run.deck"))
    if driver_main([os.path.join(d, "run.deck"), "--f64", "--outdir",
                    d]) != 0:
        raise AssertionError("the driver failed on the Couette deck")
    row = np.loadtxt(os.path.join(d, "error.dat"))
    p = RunInput.from_deck(os.path.join(d, "run.deck"))
    s = Solver(p, mesh, device="cuda", dtype=f64)
    s.run(p.n_steps - 1, dt=p.dt)
    u, r = s.u_soa.clone(), torch.zeros_like(s.u_soa)
    for a, b in zip(RK45_A, RK45_B):
        u_in = u.clone()
        r = a * r + p.dt * s._rhs(u, None)
        u = u + b * r
    s.set_state(ufe_to_euf(u), np.zeros(ufe_to_euf(u).shape), s.time)
    grad_row = np.sqrt(s.compute_error(2, u_grad=ufe_to_euf(u_in))[1])
    for name, got, gold in (("error.dat solution row", row[:4],
                             COUETTE_SOL_GOLD),
                            ("gradient row (last stage's input)", grad_row,
                             COUETTE_GRAD_GOLD)):
        gold = np.asarray(gold)
        rel = np.abs(got - gold) / np.maximum(1.0, np.abs(gold))
        log(f"couette {name} [{', '.join(f'{v:.10e}' for v in got)}], "
            f"|diff| / max(1, |gold|) {rel.max():.3e} (gate 1e-6)")
        if not rel.max() < 1e-6:
            raise AssertionError(f"Couette {name} off the reference")
    log(f"couette error.dat gradient row (final state) "
        f"[{', '.join(f'{v:.10e}' for v in row[4:])}]")

    if importlib.util.find_spec("h5py") is None:
        log("diagnostics hdf5: h5py absent (HDF5 restart and CGNS not run; "
            "the ASCII restart and vtu checks ran)")
        return
    from hifiles_tpu_torch.io.cgns import read_cgns_summary, write_cgns
    from hifiles_tpu_torch.io.restart import read_restart, write_restart
    d = os.path.join(ROOT, "build", "driver_h5")
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    p, mesh = tgv_input(order=3), periodic_hex_mesh(4, 4, 4)
    p.diagnostic_fields = ["u", "pressure"]
    gpu, _, u = both(p, mesh)
    gpu.run(2, dt=p.dt)
    path = write_restart(d, gpu, step=2)
    back = Solver(p, mesh, device="cuda", dtype=f64)
    t = read_restart(path, back)
    zones = read_cgns_summary(write_cgns(gpu, d, 2))["zones"]
    if not (t == gpu.time and np.array_equal(back.u, gpu.u)
            and zones[0]["n_cells"] == 64):
        raise AssertionError("HDF5 restart or CGNS round trip failed")
    log(f"diagnostics hdf5: h5py present; HDF5 restart round trip exact "
        f"(t={t:.6e}), CGNS zone {zones[0]['n_vertices']} vertices, fields "
        f"{zones[0]['fields']}")


def phase_long_tgv(card, counts):
    """The TGV Re=1600 validation run on the card (scripts/
    validate_torch_tgv.py's validate: 16^3 hexes, p=4, f32, t = 0 -> 14,
    one capture and a replay for every other step, TKE every 0.05), every
    gate of its comparison with the JAX package's curve
    (validation/tgv_re1600.json), validate_tgv.py's PASS rule against the
    DNS peak among them; its volume kernel launches into ``counts``.
    Returns the record."""
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import validate_torch_tgv as vt
    rec = vt.validate(log=lambda i, t, k: log(
        f"long tgv_re1600: t = {t:.3f} tke {k:.9f}") if i % 80 == 0
        else None)
    k1 = read_k1(counts, "tgv_re1600")
    v = rec["vs_jax"]
    peak = (f"rel err {v['peak_rel_err']:.3e} (gate {vt.PEAK_RTOL}), time "
            f"off by {v['peak_time_diff']:.4f} (gate {vt.PEAK_T_TOL}); DNS "
            f"peak {rec['dns_peak_dissipation']:.6e} at "
            f"{rec['dns_peak_time']:.4f}: PASS rule "
            f"{v['checks']['dns_pass']}")
    log(f"long tgv_re1600 16^3 p=4 f32 to t = {rec['t_end']:.6f}: peak "
        f"dissipation {rec['peak_dissipation']:.6e} at t = "
        f"{rec['peak_time']:.4f} (JAX {v['jax_peak_dissipation']:.6e} at "
        f"{v['jax_peak_time']:.4f}; {peak}); RMS vs JAX over "
        f"{v['jax_samples']} samples {v['rms_vs_jax']:.4e} (gate "
        f"{v['rms_bound']:.4e}); laminar (t <= {vt.LAMINAR_T}, "
        f"{v['laminar_samples']} samples) max |diff| "
        f"{v['laminar_max_diff']:.4e} (gate {v['laminar_bound']:.4e}); "
        f"TKE(0) {v['tke0']:.14f} (rel err {v['tke0_rel_err']:.3e})")
    log(f"long tgv_re1600: {rec['steps']} steps in {rec['wall_seconds']:.2f}"
        f" s, mean {rec['dof_rk_stage_per_s']:.6e} DOF*RK-stage/s (TKE "
        f"read to the host every 100 steps included); run path "
        f"{rec['run_path']!r}, captures {rec['captures']}, replays "
        f"{rec['replays']}, volume kernel launches {k1[0]}; on [{card}]")
    if not v["ok"]:
        raise AssertionError(f"TGV validation failed its gates: "
                             f"{v['checks']}")
    return rec


def phase_long_sod(card, counts):
    """The Sod shock tube on the card (120 x 2 quads, p=2, HLLC, Persson
    sensor + filter, 1000 captured steps to t = 2 ms) in f64 and f32, each
    held to the exact solution as tests/test_shock_tube.py holds the JAX
    run (sod_check); the f64 state against the port's on the CPU (the same
    steps) within 1e-11 * max|u|; then without shock capture to step 2500
    in f64, which must go non-finite or under a density of 0.105 (the JAX
    test's signature).  The volume kernel's launches into ``counts``."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import Solver
    reset_k1()
    l1s = {}
    for dtype in (torch.float64, torch.float32):
        p = sod_input()
        s = Solver(p, sod_mesh(), device="cuda", dtype=dtype)
        t0 = time.perf_counter()
        s.run(SOD_STEPS, dt=p.dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ok, l1, means, nodal = sod_check(s, SOD_STEPS * p.dt)
        name = str(dtype)[6:]
        l1s[name] = l1
        log(f"long sod {name}: {SOD_STEPS} steps in {wall:.3f} s, run path "
            f"{s.run_path!r}, captures {s.captures}, replays {s.replays}; "
            f"L1 of the cell-mean "
            f"density vs exact {l1:.6e} (gate 0.02); cell means "
            f"[{means[0]:.6f}, {means[1]:.6f}] (gate (0.11, 1.05)); nodal "
            f"[{nodal[0]:.6f}, {nodal[1]:.6f}] (gate (0.115, 1.02)); on "
            f"[{card}]")
        if not (ok and s.run_path == "SoA (fast) captured"
                and s.captures == 1 and s.replays == SOD_STEPS - 1):
            raise AssertionError(f"Sod tube {name} failed its checks")
        if dtype == torch.float64:
            cpu = Solver(p, sod_mesh(), device="cpu", dtype=dtype)
            t0 = time.perf_counter()
            cpu.run(SOD_STEPS, dt=p.dt)
            cpu_wall = time.perf_counter() - t0
            uc = cpu.u
            err = float(np.abs(s.u - uc).max() / np.abs(uc).max())
            log(f"long sod f64 card vs CPU after {SOD_STEPS} steps: max "
                f"|diff| / max|u| {err:.3e} (gate 1e-11; the CPU run "
                f"{cpu_wall:.1f} s)")
            if not err <= 1e-11:
                raise AssertionError("Sod tube: card disagrees with the CPU")
    p = sod_input(shock_cap=0)
    s = Solver(p, sod_mesh(), device="cuda", dtype=torch.float64)
    s.run(SOD_NO_CAPTURE_STEPS, dt=p.dt)
    u = s.u
    finite = bool(np.isfinite(u).all())
    rho_min = float(np.nanmin(u[..., 0])) if finite else float("nan")
    log(f"long sod without shock capture, f64, {SOD_NO_CAPTURE_STEPS} steps:"
        f" state finite {finite}, min density {rho_min:.6f} (expected "
        f"non-finite or < 0.105); run path {s.run_path!r}, captures "
        f"{s.captures}, replays {s.replays}")
    if finite and not rho_min < 0.105:
        raise AssertionError("Sod tube without shock capture shows no "
                             "oscillations")
    if not (s.run_path == "SoA (fast) captured" and s.captures == 1
            and s.replays == SOD_NO_CAPTURE_STEPS - 1):
        raise AssertionError(f"Sod tube without shock capture: run path "
                             f"{s.run_path!r}, captures {s.captures}, "
                             f"replays {s.replays}")
    launches, _ = read_k1(counts, "sod")
    need = 5 * (2 * SOD_STEPS + SOD_NO_CAPTURE_STEPS)
    log(f"long sod: volume kernel launches {launches} {counts['sod']} "
        f"(expected {need})")
    if launches != need:
        raise AssertionError(f"volume_tdisf launched {launches} times on "
                             f"the Sod runs, expected {need}")
    return l1s


def phase_long_channel(card, counts):
    """The forced channel `channel_bf1` on the card (16^3 channel hexes,
    p=4, f32, body_force_type 1): its rows at step 20 gated on
    TORCH_GOLDENS["channel_bf1"] (CHANNEL_RTOL) and at step 100 on
    ["channel_bf1_100"] (CHANNEL_BF1_RTOL_100), 10-step chunks to step 100,
    then 100-step chunks to step 1000, all replays of one capture; after
    every chunk the state is finite and the forcing's own mass flux within
    MFLUX_BOUND of mdot0.  Returns the worst |mflux / mdot0 - 1|."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import Solver, channel_hex_mesh
    p = channel_bf1_input()
    s = Solver(p, channel_hex_mesh(16, 16, 16), device="cuda",
               dtype=torch.float32)
    mdot0 = p.body_force_mdot0
    reset_k1()
    worst, step = 0.0, 0
    t0 = time.perf_counter()
    while step < CHANNEL_BF1_STEPS:
        n = 10 if step < 100 else 100
        s.run(n, dt=p.dt)
        step += n
        finite = bool(torch.isfinite(s.u_soa).all())
        err = abs(s.mdot_old / mdot0 - 1.0)
        worst = max(worst, err)
        if step in (20, 100) or step % 200 == 0 or not finite \
                or not err <= MFLUX_BOUND:
            log(f"long channel_bf1 step {step}: state finite {finite}, "
                f"|mflux / mdot0 - 1| {err:.3e} (gate {MFLUX_BOUND})")
        if not (finite and err <= MFLUX_BOUND):
            raise AssertionError(f"channel_bf1 at step {step}: finite "
                                 f"{finite}, mass flux error {err}")
        if step in (20, 100):
            row = s.residual_norm(1)
            gold = np.asarray(TORCH_GOLDENS[
                "channel_bf1" if step == 20 else "channel_bf1_100"])
            rtol = bench.CHANNEL_RTOL if step == 20 else CHANNEL_BF1_RTOL_100
            rel = np.abs(row - gold) / np.abs(gold)
            log(f"long channel_bf1 step {step} residual row "
                f"[{', '.join(f'{v:.12e}' for v in row)}], rel err per "
                f"row {[float(f'{r:.3e}') for r in rel]} (gate {rtol})")
            if not (np.isfinite(row).all() and np.all(rel < rtol)):
                raise AssertionError(f"channel_bf1 step {step} row off the "
                                     f"golden: {row}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, _ = read_k1(counts, "channel_bf1")
    smag = counts["channel_bf1"].get("D3F5+inviscid+viscous+smagorinsky", 0)
    log(f"long channel_bf1: {step} steps in {wall:.2f} s (row and mass "
        f"flux reads included), run path {s.run_path!r}, captures "
        f"{s.captures}, replays {s.replays}; worst |mflux / mdot0 - 1| "
        f"{worst:.3e} (gate {MFLUX_BOUND}); volume kernel launches "
        f"{launches} {counts['channel_bf1']}; on [{card}]")
    if not (s.run_path == "SoA featured (fast) captured" and s.captures == 1
            and smag >= 5 * CHANNEL_BF1_STEPS):
        raise AssertionError(f"channel_bf1: run path {s.run_path!r}, "
                             f"captures {s.captures}, smagorinsky launches "
                             f"{smag}")
    return worst


def phase_long(card, counts):
    """Phase 8: the long runs, each through the port's captured Solver
    path on the card, each gate raising; their summaries."""
    sod = phase_long_sod(card, counts)
    worst = phase_long_channel(card, counts)
    rec = phase_long_tgv(card, counts)
    v = rec["vs_jax"]
    log(f"long summary: TGV to t = {rec['t_end']:.4f}, highest dissipation "
        f"{rec['peak_dissipation']:.6e} at t = {rec['peak_time']:.4f}, RMS "
        f"vs JAX {v['rms_vs_jax']:.4e}, laminar "
        f"max |diff| {v['laminar_max_diff']:.4e}, {rec['wall_seconds']:.1f} "
        f"s, mean {rec['dof_rk_stage_per_s']:.6e} DOF*RK-stage/s over "
        f"{rec['steps']} steps; Sod L1 f64 {sod['float64']:.6e} f32 "
        f"{sod['float32']:.6e}; channel_bf1 worst |mflux / mdot0 - 1| "
        f"{worst:.3e}; on [{card}]")
    return rec


def path_launches(counts, path, v):
    """(launches, segments) of kernel-record row ``v`` (a VARIANTS or a
    GROUPS entry) on the run of ``path``: for a group, the launches of
    its table; for a variant at one shape, the launches that carried that
    shape and its segments; on a run that kept only counts by variant,
    its launches of the variant, one segment each."""
    if "segs" in v:
        k = counts[path + ":groups"].get((v["key"], v["shapes"]), 0)
        return k, k * len(v["segs"])
    if path + ":blocks" not in counts:
        k = counts[path].get(v["key"], 0)
        return k, k
    U, E = v.get("U", 125), v.get("E", 4096)
    k = sum(n for (key, shapes), n in counts[path + ":groups"].items()
            if key == v["key"] and (U, E) in shapes)
    return k, counts[path + ":blocks"].get((v["key"], U, E), 0)


def main():
    global T_START
    t0 = T_START = time.perf_counter()
    card = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    recs = phase_kernel()
    recs.update(phase_groups())
    phase_k3()
    phase_k4()
    counts = {}
    log_memory("the kernel phase")
    phase_small(counts)
    phase_sharded_small(counts)
    log_memory("the small phases")
    phase_legs(counts)
    log_memory("the legs")
    phase_reference(counts)
    log_memory("the reference phase")
    runs = {name: phase_slice(card, name, counts) for name in SLICES}
    runs["channel"] = phase_channel(card, counts)
    log_memory("the TGV slices and the channel")
    # every cell's rates in the same turns, on the same host
    runs.update((name, phase_slice(card, name, counts))
                for name in NEW_SLICES + MIXED_SLICES + INLET_SLICES)
    phase_sem(card, *runs["sem"])
    log_memory("the other slices")
    rates = phase_rates(card, runs)
    phase_bench(card, counts, rates["plain"]["captured"]["median"])
    log_memory("the bench entry point")
    phase_sharded(card, counts, runs["plain"])
    log_memory("the sharded cells")
    rows_one = phase_driver(card, runs["plain"][0],
                            rates["plain"]["captured"]["median"])
    phase_driver_sharded(card, counts, rows_one)
    phase_diagnostics(card)
    log_memory("the driver and diagnostics")
    phase_multicard(counts)
    log_memory("the multi-card paths")
    phase_long(card, counts)
    log_memory("the long runs")
    for name, g in GRAPHS.items():
        log(f"graph summary {name}: captured vs eager max |diff| "
            f"{g['diff']:.3e} (bit for bit {g['exact']}); device kernels per "
            f"RK stage replayed {g['replay']:.1f}, eager {g['eager']:.1f}; "
            f"volume kernel per step {g['k1_replay']}; capture "
            f"{g['capture_s']:.3f} s")
    log(f"chip_smoke: phases 1-8 in {time.perf_counter() - t0:.1f} s")
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "hifiles_tpu", "bench")]
    if loaded:
        raise AssertionError(f"chip_smoke imported {sorted(loaded)[:5]}")
    import torch
    kernels, not_run_rows = [], []
    for v in VARIANTS + GROUPS:
        paths = v["path"] if isinstance(v["path"], tuple) else (v["path"],)
        grouped = "segs" in v
        name = f"group {v['name']}" if grouped else v["name"]
        # a path of several cards is not run on one card: a row of such
        # paths alone goes to the line of rows not run here, with its
        # times and bound
        not_run = [p for p in paths if p in MULTICARD_PATHS
                   and p + ":groups" not in counts]
        by_path = {path: path_launches(counts, path, v) for path in paths
                   if path not in not_run}
        for path, (k, _) in by_path.items():
            if k == 0:
                raise AssertionError(f"volume_tdisf[{name}] ({v['key']}) "
                                     f"not launched on the {path} run")
        shape = (dict(segments=[dict(U=U, E=E, geometry=geo)
                                for U, E, geo in v["segs"]]) if grouped
                 else dict(U=v.get("U", 125), E=v.get("E", 4096)))
        (kernels if by_path else not_run_rows).append(dict(
            name=f"volume_tdisf[{name}]", dims=v.get("D", 3),
            route="cuda",
            source="hifiles_tpu_torch/csrc/volume_tdisf.cu",
            replaces="hifiles_tpu/solver/pallas_kernels.py:101",
            shape=shape,
            launches=sum(k for k, _ in by_path.values()),
            segments=sum(n for _, n in by_path.values()),
            launches_by_path={p: k for p, (k, _) in by_path.items()},
            **(dict(not_run=not_run) if not_run else {}), **recs[name]))
    log(json.dumps({"kernel rows of paths not run here": not_run_rows}))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

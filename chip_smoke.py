#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hifiles_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the hand-written kernels from hifiles_tpu_torch/csrc
               and print ptxas's registers and spills per instantiation;
  3. kernel  - hold each variant of the volume kernel (d = 3 and d = 2)
               against its plain PyTorch version on the card at the main
               paths' shapes (f32 and f64, broadcast and full geometry),
               time both, and compute the least time the card could take
               (bytes moved at 3.35 TB/s, operations at 67 TFLOP/s f32);
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
               prism TGV box);
  5. reference - the isentropic vortex (16^2 quads, p=3, f64, 100 steps)
               against the reference binary's L2 error row, and the tet,
               tri+quad and prism over-integration cases and the
               wall-modelled prism/tet channel against its L1 residual
               rows;
  6. slices  - the `plain`, `smag`, `overint`, `rans` and `shock` cases of
               bench.py (TGV p=4 on 16^3 periodic hexes, f32) and its
               `channel` case (forced plane-channel LES on 16^3 hexes, p=4,
               f32, bench.run_channel) for 10 + 10 steps each, gated on
               bench.GOLDENS; the `quad` (bench.mixed_input's vortex, p=4,
               96^2 quads) and `tet` (the TGV deck, p=4, 12^3 Kuhn tets)
               slices gated on TORCH_GOLDENS; bench.py's `mixed` (the
               vortex on the 96^2 tri+quad box, p=4) and `mixed3d` (the
               wall-modelled prism/tet LES channel, p=2) cases through
               MixedSolver, gated on bench.GOLDENS; the kernels' launch
               counts read around each run; the rates of `quad`, `tet`,
               `mixed` and `mixed3d` beside `plain` from 8 interleaved
               10-step repeats, and their launches per RK stage;
  7. checks  - no module of JAX or of the JAX package was imported.
The last two lines are the kernel record and {"ok": true, "device": ...}.
The script imports nothing of JAX and nothing of the JAX package.
"""

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py's cross-platform gate for rows checked against the CPU golden
# (bench.GATE_RTOL holds the wider per-configuration entries)
GATE_RTOL = 5e-3
# kernel vs plain version: max-abs error bound relative to max(scale, 1);
# the two sum in different orders (see tests/test_pallas_volume.py: 2e-6)
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
N_TIMED = 20
# device-side sleep ahead of a timed window, ~0.1 s at the H100's clock:
# longer than the host takes to queue N_TIMED calls of either version
SLEEP_CYCLES = 200_000_000
SLICES = ["plain", "smag", "overint", "rans", "shock"]
CHANNEL_DECK = os.path.join(ROOT, "tests", "decks", "input_channel_les_bench")
# The channel's rows against bench.GOLDENS["channel"], row by row.  Row 3
# (z-momentum) is f32 rounding amplified: the uniform IC carries no
# z-momentum, and bench.py:77-78,108-112 records the row at 2.86e-4 (CPU
# golden), 2.73e-4 (TPU golden) and 2.3e-4 (an earlier CPU row).  On an
# H100 the f32 row reads 2.30e-4 from the IC and 2.68e-4 from the IC
# perturbed by 1e-7, and the f64 row 1.77e-4, while rows 0-2 and 4 stay
# within 3e-3.  So row 3 is held to the spread of the f32 rows, 0.25; a
# corrupted flux moves the rows by far more (bench.py:119-121).
CHANNEL_RTOL = [GATE_RTOL, GATE_RTOL, GATE_RTOL, 0.25, GATE_RTOL]
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
NEW_SLICES = ["quad", "tet"]
# bench.py's mixed-mesh cases, through MixedSolver, gated on bench.GOLDENS
MIXED_SLICES = ["mixed", "mixed3d"]
N_RATE_REPEATS = 8
# the card's published peaks (H100 SXM data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the card-vs-CPU runs: bench configurations plus the options no bench
# configuration reaches (WALE, the similarity flux, Sutherland viscosity)
SMALL = {"plain": {}, "smag": {}, "overint": {}, "rans": {}, "shock": {},
         "wale": dict(LES=1, SGS_model=1, C_s=0.1),
         "similarity": dict(LES=1, SGS_model=4, C_s=0.1),
         "sutherland": dict(fix_vis=0)}


def log(msg):
    print(msg, flush=True)


def tgv_input(order=4, config="plain", **attrs):
    """The TGV deck of bench.py:278-300 (testcases Taylor_Green_vortex) with
    bench.configure(config) and ``attrs`` applied before setup_params, as
    bench.py:297 does."""
    import numpy as np
    import bench
    from hifiles_tpu_torch.config.params import RunInput
    p = RunInput()
    p.equation = 0
    p.viscous = 1
    p.order = order
    p.ic_form = 7
    p.adv_type = 3                 # RK45, 5 stages
    p.riemann_solve_type = 3       # HLLC
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
    if config in SLICES:
        bench.configure(p, config)
    for k, v in attrs.items():
        setattr(p, k, v)
    p.setup_params()
    return p


def channel_input(order=4, wall_model=0):
    """The deck of bench.run_channel (bench.py:377-404) at ``order``; with
    ``wall_model`` its walls use that wall model."""
    from hifiles_tpu_torch.config.params import RunInput
    p = RunInput.from_deck(CHANNEL_DECK)
    p.order = order
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


def vortex_input(order=4):
    """bench.mixed_input()'s deck (bench.py:156-169): the 2-D viscous
    isentropic vortex, HLLC, dt 1e-4, built with the port's RunInput."""
    from hifiles_tpu_torch.config.params import RunInput
    p = RunInput()
    p.equation, p.viscous, p.order = 0, 1, order
    p.ic_form, p.test_case, p.adv_type = 0, 1, 3
    p.riemann_solve_type = 3           # HLLC
    p.dt_type, p.dt = 0, 1e-4
    p.mach_free_stream = 0.3
    p.dx_cyclic = p.dy_cyclic = 20.0
    p.mu_inf, p.rt_inf, p.c_sth = 1e-4, 1.0, 0.0
    p.fix_vis, p.prandtl = 1, 0.72
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


def quad_wall_mesh():
    """channel_quad_mesh(8, 4) on [0, 4] x [0, 1]: cyclic in x, walls at
    y = 0 and y = 1 (the groups of tests/test_residual_soa.py:154-157)."""
    from hifiles_tpu_torch import channel_quad_mesh
    mesh = channel_quad_mesh(8, 4, 0.0, 4.0, 0.0, 1.0, bc_x="Cyc",
                             bc_X="Cyc", bc_y="Wall")
    mesh.bc_id[mesh.bc_id == 1] = 0
    mesh.bc_names = ["Cyc", "unused", "Wall"]
    return mesh


def slice_case(name):
    """(deck, mesh) of a slice at full width: the bench TGV cases (p=4 on
    16^3 periodic hexes); `quad`, bench.mixed_input()'s vortex on the quad
    half of the `mixed` cell's 96^2 box (9,216 quads, p=4); `tet`,
    bench.run_tgv's TGV deck on 12^3 Kuhn tets (10,368 tets, p=4);
    `mixed` (bench.run_mixed, bench.py:322-342), the same vortex on the
    96^2 tri+quad box (4,608 quads and 9,216 tris, p=4); `mixed3d`
    (bench.run_mixed3d, bench.py:345-374), the deck
    tests/decks/input_prism_tet_wm_bench on channel_prism_tet_mesh(32, 32,
    4, 4): 8,192 prisms near the wall and 24,576 tets above, p=2."""
    from hifiles_tpu_torch import (RunInput, channel_prism_tet_mesh,
                                   periodic_hex_mesh, periodic_mixed_mesh_2d,
                                   periodic_quad_mesh, periodic_tet_mesh)
    if name in SLICES:
        return tgv_input(order=4, config=name), periodic_hex_mesh(16, 16, 16)
    if name == "quad":
        return vortex_input(order=4), periodic_quad_mesh(96, 96, -10, 10,
                                                         -10, 10)
    if name == "mixed":
        return vortex_input(order=4), periodic_mixed_mesh_2d(96, 96, -10, 10,
                                                             -10, 10)
    if name == "mixed3d":
        return (RunInput.from_deck(os.path.join(DECKS,
                                                "input_prism_tet_wm_bench")),
                channel_prism_tet_mesh(32, 32, 4, 4, x1=2.0, y1=1.0, z1=1.0))
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
    les, over = vortex_input(order=3), vortex_input(order=3)
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
        "tri": (vortex_input(order=3),
                periodic_tri_mesh(6, 6, -10, 10, -10, 10)),
        "tet_roem": (tgv_input(order=3, riemann_solve_type=2),
                     periodic_tet_mesh(2, 2, 2)),
        "tet_overint": (RunInput.from_deck(os.path.join(
            DECKS, "input_tet_overint_25")), periodic_tet_mesh(3, 3, 3)),
    }


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
    dict(name="ns", F=5, prm={}, path="plain"),
    dict(name="smagorinsky", F=5, prm=dict(sgs=0), path="smag"),
    dict(name="rans", F=6, prm={}, path="rans"),
    dict(name="overint_cubature", F=5, prm=dict(viscous=False), U=343,
         path="overint"),
    dict(name="viscous_only", F=5, prm=dict(inviscid=False),
         path="overint"),
    dict(name="wale", F=5, prm=dict(sgs=1), path="wale"),
    dict(name="added_flux", F=5, prm={}, extra=True, path="similarity"),
    dict(name="sutherland", F=5, prm=dict(fix_vis=0), path="sutherland"),
    # as the channel launches it: geometry and the SGS cutoff broadcast
    # (uniform hexes), the wall distance full (stride 1)
    dict(name="smagorinsky_mixed_stride", F=5, prm=dict(sgs=0),
         geos=("mixed",), path="channel"),
    # d = 2 at the `quad` slice's shapes (96^2 quads, p=4); the Smagorinsky
    # and SA variants run on the walled quad channels
    dict(name="ns_2d", D=2, F=4, prm={}, U=25, E=9216, path="quad"),
    dict(name="smagorinsky_2d", D=2, F=4, prm=dict(sgs=0), U=25, E=9216,
         path="quad_channel_wm1"),
    dict(name="rans_2d", D=2, F=5, prm={}, U=25, E=9216, path="quad_rans"),
    # the `tet` slice's launch: 12^3 Kuhn tets, p=4, geometry per element
    # (six orientations: nothing compresses)
    dict(name="ns_tet", F=5, prm={}, U=35, E=10368, geos=("full",),
         path="tet"),
    # the blocks of the mixed meshes, their launches told apart by shape
    # (volume_tdisf.by_shape): the `mixed` quads (uniform, broadcast
    # geometry) and tris (two orientations, full geometry), p=4; the
    # `mixed3d` prisms and tets with Smagorinsky LES (full geometry, SGS
    # cutoff and wall distance), p=2
    dict(name="mixed_quad", D=2, F=4, prm={}, U=25, E=4608, path="mixed",
         per_block=True),
    dict(name="mixed_tri", D=2, F=4, prm={}, U=15, E=9216, geos=("full",),
         path="mixed", per_block=True),
    dict(name="mixed3d_prism", F=5, prm=dict(sgs=0), U=18, E=8192,
         geos=("full",), path="mixed3d", per_block=True),
    dict(name="mixed3d_tet", F=5, prm=dict(sgs=0), U=10, E=24576,
         geos=("full",), path="mixed3d", per_block=True),
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
                cut = (lambda t: t[..., :1].contiguous()) \
                    if geo != "full" else (lambda t: t)
                cut_w = cut if geo != "mixed" else (lambda t: t)
                args = (u, grad if prm.viscous else None, cut(jg_full), prm,
                        cut(delta_f), cut_w(wdist_f), extra)
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
                    recs[v["name"]] = dict(
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=max(bytes_ms, ops_ms),
                        bound_by="bytes" if bytes_ms >= ops_ms
                        else "operations", library_ms=None)
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
    small_types() and of small_mixed(): the whole slice, kernel included,
    at 1e-10 relative (the running averages too).  Adds each card run's
    launch counts to ``counts``."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    cases = {name: (tgv_input(order=3, config=name, **attrs),
                    periodic_hex_mesh(4, 4, 4))
             for name, attrs in SMALL.items()}
    walled = small_bounded()
    bounded = set(walled) | {"mixed_channel_wm1", "prism_tet_wm"}
    cases.update(walled)
    cases.update(small_types())
    cases.update(small_mixed())
    for name, (p, mesh) in cases.items():
        gpu = make_solver(p, mesh, name, "cuda", torch.float64)
        cpu = make_solver(p, mesh, name, "cpu", torch.float64)
        volume_tdisf.by_variant.clear()
        gpu.run(2, dt=p.dt)
        torch.cuda.synchronize()
        run_counts = dict(volume_tdisf.by_variant)
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
        if not (np.isfinite(ug).all() and err < 1e-10 and rerr < 1e-10
                and aerr < 1e-10):
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
    and the L1 monitor rows of the tet, tri+quad and prism over-integration
    cases and of the wall-modelled prism/tet channel (TET_OVERINT_GOLD,
    MIX2D_OVERINT_GOLD, PRISM_OVERINT_GOLD, PRISM_TET_WM_GOLD)."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import (RunInput, Solver, channel_prism_tet_mesh,
                                   periodic_mixed_mesh_2d,
                                   periodic_prism_mesh, periodic_quad_mesh,
                                   periodic_tet_mesh)
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    p = RunInput.from_deck(os.path.join(DECKS, "input_vortex_parity"))
    s = Solver(p, periodic_quad_mesh(16, 16, -5, 5, -5, 5), device="cuda",
               dtype=torch.float64)
    volume_tdisf.by_variant.clear()
    t0 = time.perf_counter()
    s.run(p.n_steps, dt=p.dt)
    torch.cuda.synchronize()
    counts["vortex_reference"] = dict(volume_tdisf.by_variant)
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
    (`quad`, `tet`) or bench.GOLDENS, at bench.GATE_RTOL's rtol."""
    import bench
    gold = TORCH_GOLDENS.get(name) or bench.GOLDENS[name]
    return gold, [bench.GATE_RTOL.get(name, GATE_RTOL)] * len(gold)


def phase_slice(card, name, counts):
    """One slice on the card at full width through the port's entry points
    (10 + 10 f32 steps, the bench protocol), gated row by row on
    slice_gate(name); records its launch counts by variant in ``counts``
    and returns the solver and its deck."""
    import numpy as np
    import torch
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    p, mesh = slice_case(name)
    t0 = time.perf_counter()
    s = make_solver(p, mesh, name, "cuda", torch.float32)
    torch.cuda.synchronize()
    dof = s.dof
    log(f"slice {name}: setup {time.perf_counter() - t0:.2f} s "
        f"({blocks_of(s)}, F={s.n_fields}, d={s.n_dims}, DOF {dof})")

    volume_tdisf.launches = 0
    volume_tdisf.by_variant.clear()
    volume_tdisf.by_shape.clear()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = s.residual_norm(1)
    launches = volume_tdisf.launches
    counts[name] = dict(volume_tdisf.by_variant)
    counts[name + ":blocks"] = dict(volume_tdisf.by_shape)

    gold, rtol = slice_gate(name)
    rel = np.abs(row - gold) / np.abs(gold)
    log(f"slice {name} residual row [{', '.join(f'{v:.12e}' for v in row)}]")
    log(f"slice {name} golden       {list(map(float, gold))}")
    log(f"slice {name} rel err per row {[float(f'{r:.3e}') for r in rel]} "
        f"(gate {rtol})")
    log(f"slice {name} rate {dof * s.n_stages * 10 / wall:.6e} "
        f"DOF*RK-stage/s over 10 steps ({wall:.4f} s) on [{card}]")
    log(f"slice {name} launches {launches} {counts[name]}; by block "
        + ", ".join(f"U={U} E={E}: {n}" for (_, U, E), n in
                    counts[name + ":blocks"].items()))
    if not (np.isfinite(row).all() and np.all(rel < rtol)):
        raise AssertionError(f"{name} residual row off the golden: {row}")
    # every block's volume stage on every RK stage of the 20 steps
    need = (10 * 2 * s.n_stages * len(s._blocks)
            * (2 if name == "overint" else 1))
    if launches < need:
        raise AssertionError(f"volume_tdisf launched {launches} times on "
                             f"the {name} slice, expected >= {need}")
    return s, p


def phase_channel(card, counts):
    """bench.py's `channel` case on the card through the port's entry
    points (bench.run_channel: the deck, 16^3 channel hexes, p=4, f32,
    10 + 10 steps), gated row by row on bench.GOLDENS["channel"]; records
    its launch counts by variant in ``counts``."""
    import numpy as np
    import torch
    import bench
    from hifiles_tpu_torch import Solver, channel_hex_mesh
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    p = channel_input(order=4)
    mesh = channel_hex_mesh(16, 16, 16)
    t0 = time.perf_counter()
    s = Solver(p, mesh, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"slice channel: setup {time.perf_counter() - t0:.2f} s "
        f"(E={s.block.n_eles}, U={s.ops.n_upts}, F={s.n_fields}, "
        f"boundary faces {s.block.bdy_bcid.size})")

    volume_tdisf.launches = 0
    volume_tdisf.by_variant.clear()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = s.residual_norm(1)
    launches = volume_tdisf.launches
    counts["channel"] = dict(volume_tdisf.by_variant)

    rate = s.dof * s.n_stages * 10 / wall
    gold = np.asarray(bench.GOLDENS["channel"])
    rel = np.abs(row - gold) / np.abs(gold)
    mflux, ubulk, bf = s.inflow_massflux()
    avg_ok = bool(np.isfinite(s.u_avg).all())
    log(f"slice channel residual row [{', '.join(f'{v:.12e}' for v in row)}]")
    log(f"slice channel golden       {list(map(float, gold))}")
    log(f"slice channel rel err per row {[float(f'{r:.3e}') for r in rel]} "
        f"(gate {CHANNEL_RTOL})")
    log(f"slice channel rate {rate:.6e} DOF*RK-stage/s over 10 steps "
        f"({wall:.4f} s) on [{card}]")
    log(f"slice channel mass flux {mflux:.12e}, bulk velocity {ubulk:.12e}, "
        f"next body force {bf:.6e}; averages finite: {avg_ok}")
    log(f"slice channel launches {launches} {counts['channel']}")
    if not (np.isfinite(row).all() and np.all(rel < CHANNEL_RTOL)
            and avg_ok and np.isfinite(mflux)):
        raise AssertionError(f"channel residual row off the golden: {row}")
    smag = counts["channel"].get(
        "D3F5+inviscid+viscous+smagorinsky", 0)
    if smag < 2 * 10 * s.n_stages:
        raise AssertionError(f"volume_tdisf[smagorinsky] launched {smag} "
                             "times on the channel slice, expected >= "
                             f"{2 * 10 * s.n_stages}")
    return rate


def launches_per_stage(s, dt):
    """Device kernels (and memsets and copies) per RK stage over one traced
    step, counted by torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.run(1, dt=dt)
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    return sum(1 for ev in prof.events()
               if ev.device_type == cuda) / s.n_stages


def phase_rates(card, runs):
    """The rate of each of ``runs`` (name -> (solver, deck)): median and
    quartiles of N_RATE_REPEATS 10-step repeats, the slices taking turns so
    that both see the same host; then launches per RK stage."""
    import numpy as np
    import torch
    rates = {name: [] for name in runs}
    for _ in range(N_RATE_REPEATS):
        for name, (s, p) in runs.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run(10, dt=p.dt)
            torch.cuda.synchronize()
            rates[name].append(s.dof * s.n_stages
                               * 10 / (time.perf_counter() - t0))
    for name, (s, p) in runs.items():
        q1, med, q3 = np.percentile(rates[name], [25, 50, 75])
        log(f"rate {name}: median {med:.6e} [{q1:.6e}, {q3:.6e}] "
            f"DOF*RK-stage/s over {N_RATE_REPEATS} interleaved 10-step "
            f"repeats; {launches_per_stage(s, p.dt):.1f} launches per RK "
            f"stage; on [{card}]")
        if not np.isfinite(s.residual_norm(1)).all():
            raise AssertionError(f"{name} went non-finite in the repeats")


def main():
    card = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    recs = phase_kernel()
    counts = {}
    phase_small(counts)
    phase_reference(counts)
    runs = {name: phase_slice(card, name, counts) for name in SLICES}
    phase_channel(card, counts)
    # `plain` beside the new slices: the same host in the same turns
    runs = {"plain": runs["plain"]}
    runs.update((name, phase_slice(card, name, counts))
                for name in NEW_SLICES + MIXED_SLICES)
    phase_rates(card, runs)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "hifiles_tpu")]
    if loaded:
        raise AssertionError(f"chip_smoke imported {sorted(loaded)[:5]}")
    import torch
    kernels = []
    for v in VARIANTS:
        if v.get("per_block"):
            n = counts[v["path"] + ":blocks"].get(
                (v["key"], v["U"], v["E"]), 0)
        else:
            n = counts[v["path"]].get(v["key"], 0)
        if n == 0:
            raise AssertionError(f"volume_tdisf[{v['name']}] ({v['key']}) "
                                 f"not launched on the {v['path']} run")
        kernels.append(dict(
            name=f"volume_tdisf[{v['name']}]", dims=v.get("D", 3),
            route="cuda",
            source="hifiles_tpu_torch/csrc/volume_tdisf.cu",
            replaces="hifiles_tpu/solver/pallas_kernels.py:101",
            launches=n, **recs[v["name"]]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

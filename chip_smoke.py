#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hifiles_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the hand-written kernels from hifiles_tpu_torch/csrc
               and print ptxas's registers and spills per instantiation;
  3. kernel  - hold each variant of the volume kernel against its plain
               PyTorch version on the card at the main path's shapes (f32
               and f64, broadcast and full geometry), and time both;
  4. small   - the port on the card against the port on the CPU (f64, 2
               steps) for `plain` and each feature configuration (4^3 p=3),
               and for the wall-bounded ones: the channel's small twin, the
               wall-modelled channels and a ramped inflow/outflow duct;
  5. slices  - the `plain`, `smag`, `overint`, `rans` and `shock` cases of
               bench.py (TGV p=4 on 16^3 periodic hexes, f32) and its
               `channel` case (forced plane-channel LES on 16^3 hexes, p=4,
               f32, bench.run_channel) for 10 + 10 steps each, gated on
               bench.GOLDENS, with the kernels' launch counts read around
               each run;
  6. checks  - no JAX module was imported.
The last two lines are the kernel record and {"ok": true, "device": ...}.
The script imports nothing of JAX.
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
    from hifiles_tpu.config.params import RunInput
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
    from hifiles_tpu.config.params import RunInput
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
    from hifiles_tpu.config.params import (CYCLIC, SUB_IN_CHAR,
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
    }


def make_solver(p, mesh, config, device, dtype):
    """The port's Solver for a deck; for `rans`, nu~ is seeded at the
    free-stream level as bench.py:305-309 does (the TGV IC leaves it 0)."""
    from hifiles_tpu_torch import Solver
    s = Solver(p, mesh, device=device, dtype=dtype)
    if config == "rans":
        s.u_soa[:, -1] = p.mu_tilde_inf
    return s


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
# counts its launches, and the solution-point count at that launch.
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
]
# a viscous case whose viscous, SGS and SA terms are not lost in the
# inviscid flux's scale (SGS cutoff delta ~ 1, mu = 0.05)
KERNEL_PRM = dict(gamma=1.4, prandtl=0.72, mu=0.05, viscous=True,
                  rt_inf=1.0, c_sth=0.368, prandtl_t=0.9, C_s=0.1,
                  kappa=0.41)


def volume_inputs(E, U, F, dtype, device, seed=0):
    """Seeded operands at the main path's shapes: u (U, F, E) (for F = 6
    nu~/mu spans [-2, 20]: both psi branches and the mu_t clip), grad
    (3, U, F, E), jg (3, 3, U, E), delta and wdist (U, E) (both branches of
    the Smagorinsky wall limit), an added flux (3, U, F, E)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    u = rng.random((U, F, E)) + 1.0
    u[:, 4] += 10.0                    # positive internal energy
    if F == 6:
        u[:, 5] = KERNEL_PRM["mu"] * rng.uniform(-2.0, 20.0, (U, E))
    grad = rng.normal(size=(3, U, F, E)) * 0.5
    jg = rng.random((3, 3, U, E))
    delta = 0.5 + rng.random((U, E))
    wdist = 0.5 * rng.random((U, E))
    extra = rng.normal(size=(3, U, F, E)) * 0.1
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return [t(a) for a in (u, grad, jg, delta, wdist, extra)]


def phase_kernel(E):
    """Each variant of volume_tdisf against volume_tdisf_ref on the card;
    returns {name: record} with the f32 broadcast-geometry error and the
    kernel's and plain version's times."""
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
        U = v.get("U", 125)
        v["key"] = variant(prm, v["F"], bool(v.get("extra")))
        for dtype in (torch.float32, torch.float64):
            u, grad, jg_full, delta_f, wdist_f, extra = volume_inputs(
                E, U, v["F"], dtype, dev)
            extra = extra if v.get("extra") else None
            for geo in v.get("geos", ("broadcast", "full")):
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
                        f"U={U}) {str(dtype)[6:]} geo={geo}: max_abs_err "
                        f"{err:.3e} (bound {bound:.3e}, scale {scale:.3e})")
                if dtype == torch.float32 and geo != "full":
                    ms = cuda_ms(lambda: volume_tdisf(*args))
                    plain_ms = cuda_ms(lambda: volume_tdisf_ref(*args))
                    line += f" kernel {ms:.4f} ms plain {plain_ms:.4f} ms"
                    recs[v["name"]] = dict(max_abs_err=err, ms=ms,
                                           plain_ms=plain_ms)
                log(line)
                if not err <= bound:
                    raise AssertionError(
                        f"volume_tdisf[{v['name']}] disagrees with its plain "
                        f"version: {err} > {bound}")
            del u, grad, jg_full, delta_f, wdist_f, extra
    return recs


def phase_small(counts):
    """The port on the card against the port on the CPU (f64, 2 steps) for
    each configuration of SMALL (4^3 p=3) and of small_bounded(): the whole
    slice, kernel included, at 1e-10 relative (the running averages too).
    Adds each card run's launch counts to ``counts``."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    cases = {name: (tgv_input(order=3, config=name, **attrs),
                    periodic_hex_mesh(4, 4, 4))
             for name, attrs in SMALL.items()}
    bounded = small_bounded()
    cases.update(bounded)
    for name, (p, mesh) in cases.items():
        gpu = make_solver(p, mesh, name, "cuda", torch.float64)
        cpu = make_solver(p, mesh, name, "cpu", torch.float64)
        volume_tdisf.by_variant.clear()
        gpu.run(2, dt=p.dt)
        torch.cuda.synchronize()
        run_counts = dict(volume_tdisf.by_variant)
        cpu.run(2, dt=p.dt)
        ug, uc = gpu.u, cpu.u
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
            aerr = np.abs(gpu.u_avg - cpu.u_avg).max() / np.abs(
                cpu.u_avg).max()
        log(f"small {name} f64 E={mesh.n_cells} p={p.order}, card vs CPU "
            f"after 2 steps: state rel err {err:.3e}, residual row rel err "
            f"{rerr:.3e}, averages rel err {aerr:.3e}; launches "
            f"{run_counts}")
        if not (np.isfinite(ug).all() and err < 1e-10 and rerr < 1e-10
                and aerr < 1e-10):
            raise AssertionError(f"{name}: port on the card disagrees with "
                                 "the port on the CPU")
        counts[name] = run_counts


def phase_slice(card, name, counts):
    """One bench case on the card at full size, through the port's entry
    points; records its launch counts by variant in ``counts``."""
    import numpy as np
    import torch
    import bench
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    p = tgv_input(order=4, config=name)
    mesh = periodic_hex_mesh(16, 16, 16)
    t0 = time.perf_counter()
    s = make_solver(p, mesh, name, "cuda", torch.float32)
    torch.cuda.synchronize()
    log(f"slice {name}: setup {time.perf_counter() - t0:.2f} s "
        f"(E={s.block.n_eles}, U={s.ops.n_upts}, F={s.n_fields})")

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
    counts[name] = dict(volume_tdisf.by_variant)

    dof = mesh.n_cells * (p.order + 1) ** 3
    rate = dof * s.n_stages * 10 / wall
    gold = np.asarray(bench.GOLDENS[name])
    rtol = bench.GATE_RTOL.get(name, GATE_RTOL)
    rel = np.abs(row - gold) / np.abs(gold)
    log(f"slice {name} residual row {list(map(float, row))}")
    log(f"slice {name} golden       {list(map(float, gold))}")
    log(f"slice {name} worst rel err {rel.max():.3e} (gate {rtol})")
    log(f"slice {name} rate {rate:.6e} DOF*RK-stage/s over 10 steps "
        f"({wall:.4f} s) on [{card}]")
    log(f"slice {name} launches {launches} {counts[name]}")
    if not np.isfinite(row).all() or not rel.max() < rtol:
        raise AssertionError(f"{name} residual row off the golden: {row}")
    need = 10 * 2 * s.n_stages * (2 if name == "overint" else 1)
    if launches < need:
        raise AssertionError(f"volume_tdisf launched {launches} times on "
                             f"the {name} slice, expected >= {need}")
    return rate


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

    dof = mesh.n_cells * (p.order + 1) ** 3
    rate = dof * s.n_stages * 10 / wall
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
        "F5+inviscid+viscous+smagorinsky", 0)
    if smag < 2 * 10 * s.n_stages:
        raise AssertionError(f"volume_tdisf[smagorinsky] launched {smag} "
                             "times on the channel slice, expected >= "
                             f"{2 * 10 * s.n_stages}")
    return rate


def main():
    card = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    recs = phase_kernel(E=4096)
    counts = {}
    phase_small(counts)
    for name in SLICES:
        phase_slice(card, name, counts)
    phase_channel(card, counts)
    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("chip_smoke imported JAX")
    import torch
    kernels = []
    for v in VARIANTS:
        n = counts[v["path"]].get(v["key"], 0)
        if n == 0:
            raise AssertionError(f"volume_tdisf[{v['name']}] ({v['key']}) "
                                 f"not launched on the {v['path']} run")
        kernels.append(dict(
            name=f"volume_tdisf[{v['name']}]", route="cuda",
            source="hifiles_tpu_torch/csrc/volume_tdisf.cu",
            replaces="hifiles_tpu/solver/pallas_kernels.py:101",
            launches=n, **recs[v["name"]]))
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

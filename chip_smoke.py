#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hifiles_tpu_torch) on one GPU.

  python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero and
prints no result line):
  1. device  - require CUDA; print nvidia-smi's name and power limit;
  2. build   - compile the hand-written kernels from hifiles_tpu_torch/csrc;
  3. kernel  - hold each kernel against its plain PyTorch version on the
               card at the main path's shapes, and time both;
  4. slice   - the port on the card against the port on the CPU (f64, small
               box), then the `plain` case of bench.py (TGV p=4 on 16^3
               periodic hexes, viscous NS, HLLC, RK45, f32) for 10 + 10
               steps, gated on bench.GOLDENS["plain"], with the kernels'
               launch counts read around that run;
  5. checks  - no JAX module was imported.
The last two lines are the kernel record and {"ok": true, "device": ...}.
The script imports nothing of JAX.
"""

import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# bench.py's cross-platform gate for rows checked against the CPU golden
GATE_RTOL = 5e-3
# kernel vs plain version: max-abs error bound relative to max(scale, 1);
# the two sum in different orders (see tests/test_pallas_volume.py: 2e-6)
KERNEL_TOL = {"float32": 1e-5, "float64": 1e-12}
N_TIMED = 20


def log(msg):
    print(msg, flush=True)


def tgv_plain_input(order=4):
    """The `plain` deck of bench.py:278-300 (testcases Taylor_Green_vortex)."""
    import numpy as np
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
    p.setup_params()
    return p


def cuda_ms(fn, n=N_TIMED):
    """Median device time of fn() in ms over n launches, CUDA events."""
    import torch
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
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


def phase_build():
    from hifiles_tpu_torch import backend
    t0 = time.perf_counter()
    report = backend.build_kernels(force=True)
    log(f"build: {backend.LIB_PATH} in {time.perf_counter() - t0:.2f} s")
    for line in report.splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line):
            log(f"  ptxas: {line.strip()}")


def volume_inputs(E, U, dtype, device, seed=0):
    """Seeded state, gradient and adjugate planes at the main path's
    shapes: u (U, 5, E), grad (3, U, 5, E), jg (3, 3, U, E)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    u = rng.random((U, 5, E)) + 1.0
    u[:, 4] += 10.0                    # positive internal energy
    grad = rng.random((3, U, 5, E)) * 1e-2
    jg = rng.random((3, 3, U, E))
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(u), t(grad), t(jg)


def phase_kernel(U, E):
    """volume_tdisf against volume_tdisf_ref on the card; returns the record
    of the main path's case (f32, viscous, one broadcast geometry column)."""
    import torch
    from hifiles_tpu_torch.solver.volume import (volume_tdisf,
                                                  volume_tdisf_ref)
    dev = torch.device("cuda", 0)
    kw = dict(gamma=1.4, mu=1e-3, prandtl=0.72)
    main = None
    for dtype in (torch.float32, torch.float64):
        u, grad, jg_full = volume_inputs(E, U, dtype, dev)
        for geo in ("broadcast", "full"):
            jg = (jg_full[..., :1].contiguous() if geo == "broadcast"
                  else jg_full)
            for viscous in (True, False):
                g = grad if viscous else None
                out = volume_tdisf(u, g, jg, viscous=viscous, **kw)
                ref = volume_tdisf_ref(u, g, jg, viscous=viscous, **kw)
                torch.cuda.synchronize()
                err = (out - ref).abs().max().item()
                scale = ref.abs().max().item()
                bound = KERNEL_TOL[str(dtype)[6:]] * max(scale, 1.0)
                ms = cuda_ms(lambda: volume_tdisf(u, g, jg, viscous=viscous,
                                                  **kw))
                plain_ms = cuda_ms(lambda: volume_tdisf_ref(
                    u, g, jg, viscous=viscous, **kw))
                log(f"kernel volume_tdisf {str(dtype)[6:]} geo={geo} "
                    f"viscous={viscous}: max_abs_err {err:.3e} (bound "
                    f"{bound:.3e}, scale {scale:.3e}) kernel {ms:.4f} ms "
                    f"plain {plain_ms:.4f} ms")
                if not err <= bound:
                    raise AssertionError(
                        f"volume_tdisf disagrees with its plain version: "
                        f"{err} > {bound}")
                if (dtype == torch.float32 and geo == "broadcast"
                        and viscous):
                    main = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return main


def phase_slice_small():
    """The port on the card against the port on the CPU (f64, 4^3 p=3,
    2 steps): the whole slice, kernel included, at 1e-10 relative."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import Solver, periodic_hex_mesh
    p = tgv_plain_input(order=3)
    mesh = periodic_hex_mesh(4, 4, 4)
    gpu = Solver(p, mesh, device="cuda", dtype=torch.float64)
    cpu = Solver(p, mesh, device="cpu", dtype=torch.float64)
    gpu.run(2, dt=p.dt)
    cpu.run(2, dt=p.dt)
    ug, uc = gpu.u, cpu.u
    err = np.abs(ug - uc).max() / np.abs(uc).max()
    rg, rc = gpu.residual_norm(1), cpu.residual_norm(1)
    rerr = (np.abs(rg - rc) / np.abs(rc)).max()
    log(f"slice f64 4^3 p=3, card vs CPU after 2 steps: state rel err "
        f"{err:.3e}, residual row rel err {rerr:.3e}")
    if not (np.isfinite(ug).all() and err < 1e-10 and rerr < 1e-10):
        raise AssertionError("port on the card disagrees with the port on "
                             "the CPU")


def phase_slice(card, kernels):
    """The `plain` bench case on the card, through the port's entry
    points; returns the launch counts of the kernels during the run."""
    import numpy as np
    import torch
    import bench
    from hifiles_tpu_torch import Solver, periodic_hex_mesh
    p = tgv_plain_input(order=4)
    mesh = periodic_hex_mesh(16, 16, 16)
    t0 = time.perf_counter()
    s = Solver(p, mesh, device="cuda", dtype=torch.float32)
    torch.cuda.synchronize()
    log(f"slice plain: setup {time.perf_counter() - t0:.2f} s "
        f"(E={s.block.n_eles}, U={s.ops.n_upts})")

    for k in kernels:
        k.launches = 0
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s.run(10, dt=p.dt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    row = s.residual_norm(1)
    launches = {k.__name__: k.launches for k in kernels}

    dof = mesh.n_cells * (p.order + 1) ** 3
    rate = dof * s.n_stages * 10 / wall
    gold = np.asarray(bench.GOLDENS["plain"])
    rel = np.abs(row - gold) / np.abs(gold)
    log(f"slice plain residual row {list(map(float, row))}")
    log(f"slice plain golden       {list(map(float, gold))}")
    log(f"slice plain worst rel err {rel.max():.3e} (gate {GATE_RTOL})")
    log(f"slice plain rate {rate:.6e} DOF*RK-stage/s over 10 steps "
        f"({wall:.4f} s) on [{card}]")
    log(f"slice plain launches {launches}")
    if not np.isfinite(row).all() or not rel.max() < GATE_RTOL:
        raise AssertionError(f"plain residual row off the golden: {row}")
    for name, n in launches.items():
        if n < 10 * 2 * s.n_stages:
            raise AssertionError(f"{name} launched {n} times on the slice, "
                                 f"expected >= {10 * 2 * s.n_stages}")
    return launches


def main():
    card = phase_device()
    sys.path.insert(0, ROOT)
    phase_build()
    from hifiles_tpu_torch.solver.volume import volume_tdisf
    rec = phase_kernel(U=125, E=4096)
    phase_slice_small()
    launches = phase_slice(card, [volume_tdisf])
    if "jax" in sys.modules or any(m.startswith("jax.") for m in sys.modules):
        raise AssertionError("chip_smoke imported JAX")
    import torch
    kernels = [dict(
        name="volume_tdisf", route="cuda",
        source="hifiles_tpu_torch/csrc/volume_tdisf.cu",
        replaces="hifiles_tpu/solver/pallas_kernels.py:101",
        launches=launches["volume_tdisf"], **rec)]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Where the time goes in one of the port's bench cases on one GPU.

  python3 scripts/profile_torch_tgv.py [--config NAME] [--steps N] [--out DIR]
  python3 scripts/profile_torch_tgv.py --config NAME --count-ops

Runs a case of bench.py through hifiles_tpu_torch in f32: --config plain,
smag, overint, rans or shock (TGV p=4 on 16^3 periodic hexes; default
plain), channel (bench.run_channel: forced plane-channel LES, 16^3 hexes,
p=4), quad (bench.mixed_input's 2-D viscous vortex, p=4, on 96^2 periodic
quads), tet (the TGV deck, p=4, on 12^3 periodic Kuhn tets), mixed
(bench.run_mixed: the vortex on the 96^2 tri+quad box) or mixed3d
(bench.run_mixed3d: the wall-modelled prism/tet LES channel, p=2).

With --count-ops it runs one step on the CPU (no GPU needed), on a small
mesh of the same kind (the count does not depend on the element count),
and prints the kernel launches per RK stage the step would make on the
card: every aten op it dispatches that writes memory (views and empty
allocations launch nothing), the plain version of the volume kernel
counted as its one launch.  Otherwise it needs CUDA: it warms up
2 steps, then traces N steps (default 2) with torch.profiler.  Prints the device time per kernel class (GEMM, the hand
volume kernel, gathers/stores, other elementwise, and the boundary stage:
every kernel launched inside the boundary functions), the device busy share
of the traced wall time, the launches per RK stage, and the host syncs
(cudaStreamSynchronize, aten::item) inside the traced steps; writes the top
kernels and a chrome trace under --out (default profile_out/), and the host
ops that take the most self CPU time.  Needs CUDA.
"""

import argparse
import collections
import functools
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDARY = "boundary stage"
SYNC_EVENTS = ("cudaStreamSynchronize", "aten::item",
               "aten::_local_scalar_dense")


def kernel_class(name):
    n = name.lower()
    if "volume_tdisf" in n:
        return "volume kernel (hand CUDA)"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "cublas" in n:
        return "GEMM (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather / indexed store"
    return "other elementwise"


def annotate_boundary(bc_fns):
    """Run every method of the boundary functions inside a profiler range
    named BOUNDARY (the residual calls them once or twice per stage)."""
    import torch

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(BOUNDARY):
                return fn(*args, **kwargs)
        return inner
    for name in ("ghost_state", "ldg_solution", "inv_common_flux",
                 "visc_common_flux"):
        setattr(bc_fns, name, wrap(getattr(bc_fns, name)))


def breakdown(events):
    """(device us by class, kernel launches, host syncs, rows) from the
    profiler's events.  Every device event (kernel, memset, copy) counts
    once, classed by its name; a kernel that an op launched inside
    BOUNDARY is classed as the boundary stage instead.  Kernels launched
    outside any op (the hand kernel, through ctypes) are linked to no op
    and keep their name's class."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows = collections.defaultdict(lambda: [0.0, 0])
    bdy = collections.defaultdict(lambda: [0.0, 0])
    syncs = 0
    for ev in events:
        if ev.name in SYNC_EVENTS:
            syncs += 1
        if ev.device_type == cuda and ev.name != BOUNDARY:
            rows[ev.name][0] += ev.time_range.elapsed_us()
            rows[ev.name][1] += 1
        kernels = getattr(ev, "kernels", None) or []
        parent = ev if kernels else None
        while parent is not None and parent.name != BOUNDARY:
            parent = parent.cpu_parent
        if parent is not None:
            for k in kernels:
                bdy[k.name][0] += k.duration
                bdy[k.name][1] += 1
    by_class = collections.defaultdict(float)
    for name, (us, n) in rows.items():
        if name in bdy:
            by_class["boundary stage (plain torch)"] += bdy[name][0]
        by_class[kernel_class(name)] += us - bdy.get(name, (0.0,))[0]
    launches = sum(n for _, n in rows.values())
    return by_class, launches, syncs, rows


# --count-ops: a small mesh of each case's kind, from the port's module
# ``m`` (the TGV cases: 2^3 hexes)
SMALL_MESHES = {
    "channel": lambda m: m.channel_hex_mesh(2, 2, 2),
    "quad": lambda m: m.periodic_quad_mesh(8, 8, -10, 10, -10, 10),
    "tet": lambda m: m.periodic_tet_mesh(2, 2, 2),
    "mixed": lambda m: m.periodic_mixed_mesh_2d(8, 8, -10, 10, -10, 10),
    "mixed3d": lambda m: m.channel_prism_tet_mesh(4, 4, 2, 2, x1=2.0, y1=1.0,
                                                  z1=1.0),
}


def count_ops(s, dt):
    """Kernel launches per RK stage of one step of solver ``s`` on the CPU
    (see the module docstring)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import hifiles_tpu_torch.solver.volume as volume
    silent = ("empty", "empty_like", "empty_strided", "_local_scalar_dense")

    class Count(TorchDispatchMode):
        n = 0
        on = True

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            ret = func._schema.returns
            alias = ret[0].alias_info if ret else None
            if (Count.on and func.overloadpacket.__name__ not in silent
                    and (alias is None or alias.is_write)):
                Count.n += 1
            return func(*args, **(kwargs or {}))

    plain = volume.volume_tdisf_ref

    def one_launch(*args, **kwargs):
        Count.n += 1
        Count.on = False
        try:
            return plain(*args, **kwargs)
        finally:
            Count.on = True
    volume.volume_tdisf_ref = one_launch
    try:
        with Count():
            s.run(1, dt=dt)
    finally:
        volume.volume_tdisf_ref = plain
    return Count.n / s.n_stages


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="plain")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    ap.add_argument("--count-ops", action="store_true")
    args = ap.parse_args()

    import torch
    if not args.count_ops and not torch.cuda.is_available():
        raise SystemExit("profile_torch_tgv: CUDA is not available")
    sys.path.insert(0, ROOT)
    from chip_smoke import (MIXED_SLICES, NEW_SLICES, SLICES, channel_input,
                            make_solver, slice_case)
    import hifiles_tpu_torch as ht
    from torch.profiler import ProfilerActivity, profile

    names = SLICES + ["channel"] + NEW_SLICES + MIXED_SLICES
    if args.config not in names:
        raise SystemExit(f"profile_torch_tgv: --config one of {names}")
    if args.config == "channel":
        p, mesh = channel_input(order=4), ht.channel_hex_mesh(16, 16, 16)
    else:
        p, mesh = slice_case(args.config)
    if args.count_ops:
        mesh = SMALL_MESHES.get(args.config,
                                lambda m: m.periodic_hex_mesh(2, 2, 2))(ht)
    s = make_solver(p, mesh, args.config,
                    "cpu" if args.count_ops else "cuda", torch.float32)
    if args.count_ops:
        print(f"{args.config}: {count_ops(s, p.dt):.1f} launches per RK "
              "stage (aten ops dispatched on the CPU)")
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    if s._bc_fns is not None:
        annotate_boundary(s._bc_fns)
    s.run(2, dt=p.dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.run(args.steps, dt=p.dt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_class, launches, syncs, rows = breakdown(prof.events())
    busy = sum(by_class.values())
    # cross-check: the device time the profiler's own table reports (the
    # BOUNDARY range's device-side span is not a kernel)
    listed = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and ev.key != BOUNDARY)
    stages = args.steps * s.n_stages
    print(f"{args.config}: traced {args.steps} steps ({stages} RK stages): "
          f"wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% busy, "
          f"{100 * (1 - busy / wall_us):.1f}% idle)")
    print(f"per RK stage: wall {wall_us / stages:.1f} us, device "
          f"{busy / stages:.1f} us, {launches / stages:.1f} kernel launches")
    print(f"host syncs inside the traced steps: {syncs}; device events "
          f"{busy / 1e3:.3f} ms, the profiler's table {listed / 1e3:.3f} ms")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:30s} {us / stages:9.1f} us/stage "
              f"{100 * us / busy:5.1f}% of device time")
    # where the host's time goes: self CPU time per op name, per stage
    host = sorted(((ev.key, ev.self_cpu_time_total, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in host)
    print(f"host: {total / stages:.1f} us/stage of self CPU time in "
          f"{sum(r[2] for r in host) / stages:.1f} op calls; top ops:")
    for key, us, n in host[:8]:
        print(f"  {key:30s} {us / stages:9.1f} us/stage "
              f"{n / stages:6.1f} calls/stage")
    os.makedirs(args.out, exist_ok=True)
    top = os.path.join(args.out, f"profile_{args.config}_kernels.txt")
    with open(top, "w") as f:
        f.write(f"{card}\n")
        for key, (dev_us, count) in sorted(rows.items(),
                                           key=lambda kv: -kv[1][0]):
            f.write(f"{dev_us:12.1f} us {count:6d}x  {key}\n")
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"profile_{args.config}_trace.json"))
    print(f"kernel table: {top}")


if __name__ == "__main__":
    main()

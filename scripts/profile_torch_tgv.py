#!/usr/bin/env python3
"""Where the time goes in the port's bench cases on one GPU, eager and
captured.

  python3 scripts/profile_torch_tgv.py [--config NAME[:N] ...] [--steps N]
                                       [--out DIR] [--chrome]
  python3 scripts/profile_torch_tgv.py --config NAME[:N] ... --count-ops

Runs cases of bench.py through hifiles_tpu_torch in f32, one after the
other in one process: --config plain, smag, overint, rans or shock (TGV
p=4 on 16^3 periodic hexes; default plain), channel (bench.run_channel:
forced plane-channel LES, 16^3 hexes, p=4), quad (bench.mixed_input's 2-D
viscous vortex, p=4, on 96^2 periodic quads), tet (the TGV deck, p=4, on
12^3 periodic Kuhn tets), mixed (bench.run_mixed: the vortex on the 96^2
tri+quad box), mixed3d (bench.run_mixed3d: the wall-modelled prism/tet LES
channel, p=2), sem (the WALE LES duct with a 1000-eddy SEM inlet, 16^3
hexes, p=4, its draws from the card's generator), advdiff (the 3-D sine
wave, equation 1, 16^3 hexes, p=4), and at the shapes of the volume
kernel's record only: wale, similarity, sutherland (the TGV deck with
those options) and quad_channel_wm1, quad_rans (the walled quad channels,
p=4, on 96 x 96 quads).  NAME:N runs the case
element-sharded (parallel.ShardedSolver, or ShardedMixedSolver for the
mixed meshes) in N shards placed round-robin on the visible cards (on one
card all N there; on several each card captures its own segments of the
step), or on the CPU with --count-ops.  With shards on several cards it
also prints, per card, the device busy and idle share of the traced wall,
the microseconds per step the card waited on its peers (the gaps before
the peer copies that open a segment) and the peer copies' GB/s (the
bytes of the step's cuts over those copies' device time).

With --count-ops it runs one step on the CPU (no GPU needed), on a small
mesh of the same kind (the count does not depend on the element count),
and prints the kernel launches per RK stage the step would make on the
card: every aten op it dispatches that writes memory (views and empty
allocations launch nothing), the plain version of the volume kernel
counted as its launches (one per 16 blocks of a grouped call).
Otherwise it needs CUDA: per case, first for eager steps
(``run(..., graph=False)``), then for replays of the captured step, it
runs 2 untraced steps, then traces N steps (default 2) with
torch.profiler.  Prints the device time per kernel class (GEMM, the
hand volume kernel, gathers/stores, other elementwise, the boundary stage:
every kernel launched inside the boundary functions, and the turbulent
inlet: every kernel of its once-per-step update; a replay has no host ops,
so its kernels keep their names' classes), the device busy and idle share
of the traced wall time, the device kernels per RK stage (the kernel
nodes of a replayed step), and the host syncs (cudaStreamSynchronize,
aten::item) inside the traced steps; writes each trace's top kernels
(with --chrome its chrome trace too) under --out (default profile_out/),
the host ops that take the most self CPU time, and a JSON summary of
every case (profile_summary.json, and the last line).  Needs CUDA.
"""

import argparse
import collections
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BOUNDARY = "boundary stage"
INLET = "turbulent inlet"
# the profiler ranges whose kernels get a class of their own
RANGES = {BOUNDARY: "boundary stage (plain torch)",
          INLET: "turbulent inlet (plain torch)"}
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


def annotate(obj, names, label):
    """Run the methods ``names`` of ``obj`` inside a profiler range named
    ``label``: the boundary functions (the residual calls them once or
    twice per stage) in BOUNDARY, the inlet's update in INLET."""
    import torch

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return inner
    for name in names:
        setattr(obj, name, wrap(getattr(obj, name)))


def breakdown(events):
    """(device us by class, kernel launches, host syncs, rows) from the
    profiler's events.  Every device event (kernel, memset, copy) counts
    once, classed by its name; a kernel that an op launched inside one of
    RANGES is classed as that range instead.  Kernels launched outside any
    op (the hand kernel, through ctypes) are linked to no op and keep
    their name's class."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    rows = collections.defaultdict(lambda: [0.0, 0])
    ranged = {r: collections.defaultdict(float) for r in RANGES}
    syncs = 0
    for ev in events:
        if ev.name in SYNC_EVENTS:
            syncs += 1
        if ev.device_type == cuda and ev.name not in RANGES:
            rows[ev.name][0] += ev.time_range.elapsed_us()
            rows[ev.name][1] += 1
        kernels = getattr(ev, "kernels", None) or []
        parent = ev if kernels else None
        while parent is not None and parent.name not in RANGES:
            parent = parent.cpu_parent
        if parent is not None:
            for k in kernels:
                ranged[parent.name][k.name] += k.duration
    by_class = collections.defaultdict(float)
    for name, (us, n) in rows.items():
        for r, label in RANGES.items():
            if name in ranged[r]:
                by_class[label] += ranged[r][name]
                us -= ranged[r][name]
        by_class[kernel_class(name)] += us
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
    "sem": lambda m: __import__("chip_smoke").duct_mesh(2),
    "advdiff": lambda m: m.periodic_hex_mesh(2, 2, 2, -1, 1, -1, 1, -1, 1),
    "quad_channel_wm1": lambda m: __import__("chip_smoke").quad_wall_mesh(),
    "quad_rans": lambda m: __import__("chip_smoke").quad_wall_mesh(),
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

    plain = volume.volume_tdisf_many_ref

    def one_launch(calls, prm):
        Count.n += -(-len(calls) // volume.MAX_SEGMENTS)
        Count.on = False
        try:
            return plain(calls, prm)
        finally:
            Count.on = True
    volume.volume_tdisf_many_ref = one_launch
    try:
        with Count():
            s.run(1, dt=dt)
    finally:
        volume.volume_tdisf_many_ref = plain
    return Count.n / s.n_stages


# configurations only this script profiles, at the shapes of the volume
# kernel's record in chip_smoke.py (VARIANTS): the TGV deck, p=4 on 16^3
# hexes, with the options of chip_smoke.SMALL; the walled quad channels of
# chip_smoke.quad_wall_input at p=4 on 96 x 96 quads, dt 1e-6
OPTION_CASES = ("wale", "similarity", "sutherland", "quad_channel_wm1",
                "quad_rans")


def case(name, count_ops):
    """(deck, mesh) of configuration ``name`` (a small mesh of its kind
    with ``count_ops``)."""
    import chip_smoke as cs
    import hifiles_tpu_torch as ht
    if name in OPTION_CASES[:3]:
        p = cs.tgv_input(order=4, config=name, **cs.SMALL[name])
        mesh = ht.periodic_hex_mesh(16, 16, 16)
    elif name in OPTION_CASES:
        p = cs.quad_wall_input(rans=name == "quad_rans",
                               wall_model=int(name == "quad_channel_wm1"))
        p.order, p.dt = 4, 1e-6
        mesh = cs.quad_wall_mesh(nx=96, ny=96)
    else:
        p, mesh = cs.slice_case(name)
    if count_ops:
        mesh = SMALL_MESHES.get(name, lambda m: m.periodic_hex_mesh(2, 2, 2)
                                )(ht)
    return p, mesh


def sync_all():
    import torch
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def trace(s, dt, steps, graph):
    """Trace ``steps`` steps of ``s`` with torch.profiler (CPU and CUDA),
    captured (``graph``: replays) or eager, after 2 untraced steps of the
    same kind; returns (profiler, synchronised wall us)."""
    from torch.profiler import ProfilerActivity, profile
    s.run(2, dt=dt, graph=graph)
    sync_all()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.run(steps, dt=dt, graph=graph)
        sync_all()
        wall_us = (time.perf_counter() - t0) * 1e6
    return prof, wall_us


def per_card(s, prof, wall_us, steps):
    """With shards on several cards: per card, the device busy share of
    the traced wall, the us per step it waited on its peers (the gaps
    before the peer copies that open a segment: each such copy waits on
    the peers' events) and its peer copies' GB/s (the bytes the step's
    cuts copy to it over their device time).  None on one card."""
    import torch
    cards = list(dict.fromkeys(getattr(s, "devices", [s.device])))
    if len(cards) < 2:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    evs = collections.defaultdict(list)
    for ev in prof.events():
        if ev.device_type == cuda:
            evs[ev.device_index].append(
                (ev.time_range.start, ev.time_range.end, ev.name))
    cut_bytes = collections.Counter()
    for copies in (s._graph.cuts if s._graph is not None
                   and hasattr(s._graph, "cuts") else []):
        for src, _, _, kd in copies:
            cut_bytes[kd] += src.numel() * src.element_size()
    out = []
    for k, dev in enumerate(cards):
        rows = sorted(evs.get(dev.index, []))
        busy = sum(b - a for a, b, _ in rows)
        peer = lambda n: "PtoP" in n or "Peer" in n
        wait = copy_us = 0.0
        for i, (a, b, name) in enumerate(rows):
            if peer(name):
                copy_us += b - a
                if i > 0 and not peer(rows[i - 1][2]):
                    wait += max(0.0, a - rows[i - 1][1])
        out.append(dict(card=str(dev), busy_share=busy / wall_us,
                        idle_share=1 - busy / wall_us,
                        peer_wait_us_per_step=wait / steps,
                        peer_copy_us_per_step=copy_us / steps,
                        peer_copy_gb_s=(cut_bytes[k] * steps / copy_us / 1e3
                                        if copy_us else None)))
        print(f"  card {dev}: busy {100 * busy / wall_us:.1f}%, idle "
              f"{100 * (1 - busy / wall_us):.1f}% of the traced wall; "
              f"waiting on peers {wait / steps:.1f} us/step; peer copies "
              f"{copy_us / steps:.1f} us/step, {cut_bytes[k]} B/step"
              + (f", {cut_bytes[k] * steps / copy_us / 1e3:.2f} GB/s"
                 if copy_us else ""))
    return out


def report(name, mode, s, prof, wall_us, steps, out, card, chrome=False):
    """Print one trace's table (device time by class, busy and idle share
    of the traced wall, device kernels per RK stage, host syncs, the host
    ops with the most self CPU time) and write its kernel table (and with
    ``chrome`` its chrome trace) under ``out``; returns its summary."""
    import torch
    by_class, launches, syncs, rows = breakdown(prof.events())
    busy = sum(by_class.values())
    # cross-check: the device time the profiler's own table reports (the
    # BOUNDARY range's device-side span is not a kernel)
    listed = sum(getattr(ev, "self_device_time_total", 0.0)
                 for ev in prof.key_averages()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and ev.key != BOUNDARY)
    stages = steps * s.n_stages
    host = sorted(((ev.key, ev.self_cpu_time_total, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda r: -r[1])
    total = sum(r[1] for r in host)
    print(f"{name} {mode}: traced {steps} steps ({stages} RK stages): "
          f"wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% busy, "
          f"{100 * (1 - busy / wall_us):.1f}% idle)")
    print(f"{name} {mode} per RK stage: wall {wall_us / stages:.1f} us, "
          f"device {busy / stages:.1f} us, {launches / stages:.1f} device "
          f"kernels")
    print(f"{name} {mode}: host syncs inside the traced steps: {syncs}; "
          f"device events {busy / 1e3:.3f} ms, the profiler's table "
          f"{listed / 1e3:.3f} ms")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:30s} {us / stages:9.1f} us/stage "
              f"{100 * us / busy:5.1f}% of device time")
    print(f"{name} {mode} host: {total / stages:.1f} us/stage of self CPU "
          f"time in {sum(r[2] for r in host) / stages:.1f} op calls; top "
          "ops:")
    for key, us, n in host[:8]:
        print(f"  {key:30s} {us / stages:9.1f} us/stage "
              f"{n / stages:6.1f} calls/stage")
    tag = name.replace(" ", "_") + "_" + mode
    os.makedirs(out, exist_ok=True)
    top = os.path.join(out, f"profile_{tag}_kernels.txt")
    with open(top, "w") as f:
        f.write(f"{card}\n")
        for key, (dev_us, count) in sorted(rows.items(),
                                           key=lambda kv: -kv[1][0]):
            f.write(f"{dev_us:12.1f} us {count:6d}x  {key}\n")
    if chrome:
        prof.export_chrome_trace(os.path.join(out,
                                              f"profile_{tag}_trace.json"))
    print(f"kernel table: {top}")
    k1 = {k: (v[0] / stages, v[1] / stages) for k, v in rows.items()
          if "volume_tdisf" in k}
    return dict(wall_us_per_stage=wall_us / stages,
                busy_us_per_stage=busy / stages,
                idle_share=1 - busy / wall_us,
                kernels_per_stage=launches / stages,
                host_self_us_per_stage=total / stages,
                k1_us_per_stage=sum(v[0] for v in k1.values()),
                k1_launches_per_stage=sum(v[1] for v in k1.values()),
                by_class_us_per_stage={c: us / stages
                                       for c, us in by_class.items()})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", nargs="+", default=["plain"],
                    help="one or more of the configurations; NAME:N runs "
                    "NAME in N shards")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    ap.add_argument("--count-ops", action="store_true")
    ap.add_argument("--chrome", action="store_true",
                    help="also write each trace's chrome trace")
    args = ap.parse_args()

    import torch
    if not args.count_ops and not torch.cuda.is_available():
        raise SystemExit("profile_torch_tgv: CUDA is not available")
    sys.path.insert(0, ROOT)
    from chip_smoke import (INLET_SLICES, MIXED_SLICES, NEW_SLICES, SLICES,
                            make_sharded, make_solver)

    names = (SLICES + ["channel"] + NEW_SLICES + MIXED_SLICES + INLET_SLICES
             + list(OPTION_CASES))
    card = None
    if not args.count_ops:
        card = "; ".join(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines())
        print(card)
    summary = {}
    for item in args.config:
        config, _, n = item.partition(":")
        shards = int(n) if n else 0
        if config not in names:
            raise SystemExit(f"profile_torch_tgv: --config one of {names}")
        p, mesh = case(config, args.count_ops)
        device = "cpu" if args.count_ops else "cuda"
        if shards:
            s = make_sharded(p, mesh, shards, device, torch.float32)
        else:
            s = make_solver(p, mesh, config, device, torch.float32)
        name = config + (f" x{shards}" if shards else "")
        if args.count_ops:
            print(f"{name}: {count_ops(s, p.dt):.1f} launches per RK "
                  "stage (aten ops dispatched on the CPU)")
            continue
        for fns in getattr(s, "shard_bc_fns", [s._bc_fns]):
            if fns is not None:
                annotate(fns, ("ghost_state", "ldg_solution",
                               "inv_common_flux", "visc_common_flux"),
                         BOUNDARY)
        if s.turb_inlet is not None:
            annotate(s.turb_inlet, ("update",), INLET)
        summary[name] = {"card": card}
        for mode in ("eager", "captured"):
            prof, wall_us = trace(s, p.dt, args.steps, mode == "captured")
            summary[name][mode] = report(name, mode, s, prof, wall_us,
                                         args.steps, args.out, card,
                                         args.chrome)
            cards = per_card(s, prof, wall_us, args.steps)
            if cards is not None:
                summary[name][mode]["cards"] = cards
        e, c = summary[name]["eager"], summary[name]["captured"]
        print(f"{name}: captured / eager wall per stage "
              f"{c['wall_us_per_stage'] / e['wall_us_per_stage']:.3f}, "
              f"device kernels {c['kernels_per_stage']:.1f} / "
              f"{e['kernels_per_stage']:.1f}")
        s.release_graph()
        del s
    if summary:
        path = os.path.join(args.out, "profile_summary.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=1)
        print("summary: " + json.dumps(summary))


if __name__ == "__main__":
    main()

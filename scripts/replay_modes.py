#!/usr/bin/env python3
"""Device time of replayed steps before and after a torch.profiler session.

  python3 scripts/replay_modes.py [CONFIG ...] [--out FILE]

For each of bench.py's configurations named (default: all eight), in a
process of its own on the card: the configuration's solver at full width
(hifiles_tpu_torch.bench.case, f32), 10 steps (the step captured as a CUDA
graph), then the device time of 10 replays of the captured step queued
behind a device-side sleep (so that the host's launches stay off the
critical path), 4 times; then one torch.profiler session (CUDA activity)
around one eager step; then the same 4 readings again, and the device
kernels of one replayed step (a second profiler session).  Prints one JSON
line per configuration (ms per 10 replays before and after, the host's ms
to launch them, kernels per step) and writes them all to FILE.

On an H100 the replays of one captured step have been read at two device
times, the longer about 0.35 us per kernel over the shorter, a process
moving from the longer to the shorter at moments that neither the
profiler session nor the time since set-up predicted; this script reads
which one each configuration runs at, before and after the session.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLEEP_CYCLES = 400_000_000


def replays(s, n=10, k=4):
    """k readings of (device ms, host ms) of n replays of ``s``'s captured
    step behind a device-side sleep, each from the same state."""
    import torch
    snap = s.snapshot()
    out = []
    for _ in range(k):
        s.restore(snap)
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        t0 = time.perf_counter()
        for _ in range(n):
            s._graph.replay()
        host = time.perf_counter() - t0
        b.record()
        b.synchronize()
        out.append((a.elapsed_time(b), 1e3 * host))
    s.restore(snap)
    return out


def child(name):
    """One configuration's readings as a dict."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from hifiles_tpu_torch import bench
    c = bench.case(name)
    s = bench.make_solver(name, c, torch.device("cuda"), torch.float32)
    s.run(10, dt=c.p.dt)
    torch.cuda.synchronize()
    before = replays(s)
    with profile(activities=[ProfilerActivity.CUDA]):
        s.run(1, dt=c.p.dt, graph=False)
        torch.cuda.synchronize()
    after = replays(s)
    kernels, _ = bench.step_kernels(s, c.p.dt)
    return dict(config=name, kernels_per_step=kernels,
                before_ms=[round(d, 3) for d, _ in before],
                after_ms=[round(d, 3) for d, _ in after],
                host_before_ms=[round(h, 3) for _, h in before],
                host_after_ms=[round(h, 3) for _, h in after],
                us_per_kernel_diff=round(1e3 * (min(d for d, _ in before)
                                                - min(d for d, _ in after))
                                         / (10 * kernels), 4),
                device=torch.cuda.get_device_name(0))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "replay_modes.json"))
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.child:
        print(json.dumps(child(args.child)), flush=True)
        return
    from hifiles_tpu_torch import bench
    names = args.configs or bench.ALL_CONFIGS
    rows = []
    for name in names:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", name], cwd=ROOT, text=True,
                             capture_output=True, timeout=600)
        if res.returncode != 0:
            raise SystemExit(f"{name}: exit {res.returncode}\n"
                             f"{res.stderr[-3000:]}")
        rows.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)


if __name__ == "__main__":
    main()

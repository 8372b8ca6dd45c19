#!/usr/bin/env python3
"""Where the time goes in one of the port's bench cases on one GPU.

  python3 scripts/profile_torch_tgv.py [--config NAME] [--steps N] [--out DIR]

Runs a TGV p=4 16^3 case of bench.py (--config plain, smag, overint, rans
or shock; default plain) through hifiles_tpu_torch in f32, warms up 2 steps, then traces N steps (default 2) with
torch.profiler.  Prints the device time per kernel class (GEMM, the hand
volume kernel, gathers/stores, other elementwise), the device busy share of
the traced wall time, and the launches per RK stage; writes the top kernels
and a chrome trace under --out (default profile_out/).  Needs CUDA.
"""

import argparse
import collections
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_class(name):
    n = name.lower()
    if "volume_tdisf" in n:
        return "volume kernel (hand CUDA)"
    if "gemm" in n or "cutlass" in n or "xmma" in n or "cublas" in n:
        return "GEMM (cuBLAS)"
    if "index" in n or "gather" in n or "scatter" in n:
        return "gather / indexed store"
    return "other elementwise"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default="plain")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_tgv: CUDA is not available")
    sys.path.insert(0, ROOT)
    from chip_smoke import SLICES, make_solver, tgv_input
    from hifiles_tpu_torch import periodic_hex_mesh
    from torch.profiler import ProfilerActivity, profile

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    if args.config not in SLICES:
        raise SystemExit(f"profile_torch_tgv: --config one of {SLICES}")
    p = tgv_input(order=4, config=args.config)
    s = make_solver(p, periodic_hex_mesh(16, 16, 16), args.config, "cuda",
                    torch.float32)
    s.run(2, dt=p.dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.run(args.steps, dt=p.dt)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    by_class = collections.defaultdict(float)
    launches = 0
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        if dev_us <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_class[kernel_class(ev.key)] += dev_us
        launches += ev.count
        rows.append((dev_us, ev.count, ev.key))
    busy = sum(by_class.values())
    stages = args.steps * s.n_stages
    print(f"{args.config}: traced {args.steps} steps ({stages} RK stages): wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f}% busy, "
          f"{100 * (1 - busy / wall_us):.1f}% idle)")
    print(f"per RK stage: wall {wall_us / stages:.1f} us, device "
          f"{busy / stages:.1f} us, {launches / stages:.1f} kernel launches")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:28s} {us / stages:9.1f} us/stage "
              f"{100 * us / busy:5.1f}% of device time")
    os.makedirs(args.out, exist_ok=True)
    top = os.path.join(args.out, f"profile_{args.config}_kernels.txt")
    with open(top, "w") as f:
        f.write(f"{card}\n")
        for dev_us, count, key in sorted(rows, reverse=True):
            f.write(f"{dev_us:12.1f} us {count:6d}x  {key}\n")
    prof.export_chrome_trace(os.path.join(args.out,
                                          f"profile_{args.config}_trace.json"))
    print(f"kernel table: {top}")


if __name__ == "__main__":
    main()

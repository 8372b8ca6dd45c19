#!/usr/bin/env python3
"""Controls behind two gates of chip_smoke.py's sharded phases, on one GPU.

  python3 scripts/shard_controls.py [--steps 100] [--out DIR] [--device cpu]

1. channel: bench.run_channel's deck (forced plane-channel LES, 16^3
   channel hexes, p=4) through the single-device Solver and through
   ShardedSolver in 3 shards on the card, in f32 and in f64, stepped side
   by side from the same initial state in 10-step chunks to --steps.  Per
   chunk: whether each state is finite, its L1 residual row, the mass flux
   through the inflow plane and the body force the next step applies, and
   the sharded row's largest relative difference from the single-device
   one.  Tells whether the deck leaves its gate's neighbourhood past its 20
   gated f32 steps on one device too, or only sharded.
2. halo faults: chip_smoke's driver deck (`plain`: TGV p=4 on 16^3 hexes,
   f32, 20 steps, history at 10 and 20) through ``python -m
   hifiles_tpu_torch`` in this process, single-device, with ``--devices 4``,
   and with ``--devices 4`` under each fault of FAULTS injected into shard
   0's receive buffers.  Each sharded history is held against the
   single-device one as chip_smoke.phase_driver_sharded holds it: the
   largest relative difference of the residual norms and of the integral
   quantities.  The sound run and the faulty ones bracket that gate.
3. the same faults in chip_smoke's small sharded `tgv x4` case (4^3 TGV,
   p=3, f64, 2 steps), held to the single-device Solver as
   chip_smoke.phase_sharded_small holds it (1e-11 of max(scale, 1)).

Prints one line per reading and writes them all as JSON to
``<out>/shard_controls.json`` (--out, default profile_out/).  Needs CUDA; with ``--device cpu`` it runs
part 3 alone, on the CPU (``<out>/shard_controls_cpu.json``).
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# the faults put into shard 0's receive buffers, one per driver run:
# both receive buffers zeroed; only the qn (viscous flux) buffer zeroed;
# the partner's flux points of every halo face taken in reverse order
FAULTS = ("zeroed", "qn zeroed", "reversed")


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def channel_control(n_steps, card, device="cuda", case=None):
    """Part 1 on ``device`` (``case``: the (deck, mesh), by default the
    full-width `channel`); returns its readings."""
    import numpy as np
    import torch
    from hifiles_tpu_torch import Solver
    out = []
    for dtype in (torch.float32, torch.float64):
        p, mesh = case() if case else cs.slice_case("channel")
        runs = {"single": Solver(p, mesh, device=device, dtype=dtype),
                "x3": cs.make_sharded(p, mesh, 3, device, dtype)}
        alive = dict.fromkeys(runs, True)
        for step in range(10, n_steps + 1, 10):
            rows = {}
            for name, s in runs.items():
                if not alive[name]:
                    continue
                s.run(10, dt=p.dt)
                _sync(device)
                u = cs.flat(s.gather_u() if name == "x3" else s.u)
                finite = bool(np.isfinite(u).all())
                row = s.residual_norm(1) if finite else None
                mflux, _, bf = s.inflow_massflux() if finite else (
                    float("nan"),) * 3
                alive[name] = finite
                rows[name] = row
                rec = dict(part="channel", dtype=str(dtype)[6:], run=name,
                           step=step, finite=finite,
                           row=None if row is None else row.tolist(),
                           mass_flux=mflux, body_force=bf,
                           max_abs_u=float(np.abs(u).max()) if finite
                           else None)
                out.append(rec)
                cs.log(f"channel {rec['dtype']} {name} step {step}: finite "
                       f"{finite}; L1 row "
                       + ("-" if row is None else
                          "[" + ", ".join(f"{v:.6e}" for v in row) + "]")
                       + f"; mass flux {mflux:.9e}; next body force "
                       f"{bf:.6e}")
            if rows.get("single") is not None and rows.get("x3") is not None:
                rel = float((np.abs(rows["x3"] - rows["single"])
                             / np.abs(rows["single"])).max())
                out.append(dict(part="channel", dtype=str(dtype)[6:],
                                step=step, rows_rel_diff=rel))
                cs.log(f"channel {str(dtype)[6:]} step {step}: x3 row vs "
                       f"single-device row, max rel diff {rel:.3e}")
            if not any(alive.values()):
                break
        del runs
    cs.log(f"channel control on [{card}]")
    return out


def _inject(kind):
    """Wrap ShardedLoop._exchange so that shard 0's receive buffers carry
    the fault ``kind``; returns the original to put back."""
    import torch
    from hifiles_tpu_torch.parallel.soa_sharding import ShardedLoop
    orig = ShardedLoop._exchange
    calls = [0]

    def exchange(self, bufs):
        recv = orig(self, bufs)
        # a viscous residual exchanges twice: the solution, then qn
        which = ("solution", "qn")[calls[0] % 2]
        calls[0] += 1
        r = recv[0]
        if kind == "zeroed" or (kind == "qn zeroed" and which == "qn"):
            recv[0] = torch.zeros_like(r)
        elif kind == "reversed" and which == "solution":
            nfp = int(self.base.ops.n_fpts_per_face[0])
            recv[0] = r.view(r.shape[0], -1, nfp).flip(-1).reshape(
                r.shape[0], -1)
        return recv
    ShardedLoop._exchange = exchange
    return orig


def halo_control(card, device="cuda", n=16, order=4):
    """Part 2 on ``device``, the TGV on n^3 hexes at ``order``; returns
    its readings."""
    import numpy as np
    from hifiles_tpu_torch import periodic_hex_mesh
    from hifiles_tpu_torch.driver import main as driver_main
    from hifiles_tpu_torch.mesh.gambit import write_gambit
    from hifiles_tpu_torch.parallel.soa_sharding import ShardedLoop
    d = os.path.join(ROOT, "build", "shard_controls")
    os.makedirs(d, exist_ok=True)
    write_gambit(periodic_hex_mesh(n, n, n), os.path.join(d, "tgv.neu"))
    with open(os.path.join(d, "run.deck"), "w") as f:
        f.write(cs.tgv_deck("tgv.neu", order=order, plot_freq=10**6,
                            restart_dump_freq=10**6))

    def run(name, *extra):
        o = os.path.join(d, name.replace(" ", "_"))
        os.makedirs(o, exist_ok=True)
        hist = os.path.join(o, "history.plt")
        if os.path.exists(hist):
            os.remove(hist)
        err = None
        try:
            driver_main([os.path.join(d, "run.deck"), "--outdir", o,
                         "--device", device, *extra])
        except FloatingPointError as e:
            err = str(e)
        rows = cs.history_rows(hist)[1] if os.path.exists(hist) else []
        return rows, err

    one, _ = run("single")
    head = cs.history_rows(os.path.join(d, "single", "history.plt"))[0]
    n_res = head[0].count('"res_')
    out = []
    for kind in (None,) + FAULTS:
        orig = _inject(kind) if kind else None
        try:
            rows, err = run(f"x4 {kind or 'sound'}", "--devices", "4")
        finally:
            if orig is not None:
                ShardedLoop._exchange = orig
        worst_res = worst_int = float("nan")
        if len(rows) == len(one) and not err:
            worst_res = worst_int = 0.0
            for a, b in zip(rows, one):
                ra, rb = 10.0 ** a[1:1 + n_res], 10.0 ** b[1:1 + n_res]
                worst_res = max(worst_res, float((np.abs(ra - rb) / rb).max()))
                worst_int = max(worst_int, float(
                    (np.abs(a[1 + n_res:-2] - b[1 + n_res:-2])
                     / np.abs(b[1 + n_res:-2])).max()))
        rec = dict(part="halo", fault=kind or "none", rows=len(rows),
                   aborted=err, residual_norms_rel_diff=worst_res,
                   integral_rel_diff=worst_int)
        out.append(rec)
        cs.log(f"halo fault {kind or 'none'}: {len(rows)} history rows"
               + (f" (driver aborted: {err})" if err else "")
               + f"; residual norms max rel diff {worst_res:.3e}, integral "
               f"quantities {worst_int:.3e} against the single-device run")
    cs.log(f"halo control on [{card}]")
    return out


def small_control(device):
    """Part 3 on ``device``: chip_smoke's small sharded `tgv x4` case (the
    4^3 TGV, p=3, f64, 2 steps, 4 shards) sound and under each fault of
    FAULTS, held to the single-device Solver as phase_sharded_small holds
    it; returns its readings."""
    import numpy as np
    import torch
    f64 = torch.float64
    p, mesh, n = cs.small_sharded()["tgv x4"]
    one = cs.make_solver(p, mesh, "tgv x4", device, f64)
    one.run(2, dt=p.dt)
    u1 = cs.flat(one.u)
    out = []
    for kind in (None,) + FAULTS:
        orig = _inject(kind) if kind else None
        try:
            s = cs.make_sharded(p, mesh, n, device, f64)
            s.run(2, dt=p.dt)
        finally:
            if orig is not None:
                from hifiles_tpu_torch.parallel.soa_sharding import \
                    ShardedLoop
                ShardedLoop._exchange = orig
        err = float(np.abs(cs.flat(s.gather_u()) - u1).max()
                    / max(np.abs(u1).max(), 1.0))
        out.append(dict(part="small", fault=kind or "none", rel_err=err))
        cs.log(f"small tgv x4 f64 fault {kind or 'none'}: state against the "
               f"single-device solver {err:.3e} of max(scale, 1) (bound "
               f"1e-11) on {device}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch
    if args.device == "cpu":
        recs, card = small_control("cpu"), "cpu"
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "shard_controls_cpu.json"),
                  "w") as f:
            json.dump(dict(card=card, readings=recs), f, indent=1)
        return
    if not torch.cuda.is_available():
        raise SystemExit("shard_controls: needs CUDA (or --device cpu)")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cs.log(card)
    t0 = time.perf_counter()
    recs = channel_control(args.steps, card)
    recs += halo_control(card)
    recs += small_control("cuda")
    cs.log(f"shard_controls: {time.perf_counter() - t0:.1f} s")
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "shard_controls.json"), "w") as f:
        json.dump(dict(card=card, readings=recs), f, indent=1)


if __name__ == "__main__":
    main()

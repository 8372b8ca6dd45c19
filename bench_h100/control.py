"""The readings that the limits of check.py are set from:

  python3 -m bench_h100.control --workload NAME --seeds S1 S2 ... [--out F]

For each seed, in one process: the program's checked steps and monitor row
through the window's calls (as a run's set-up makes them, on one solver
built once: ``set_state`` restarts it), the float64 reference, and the
lower-precision control, the reference in the program's place computed in
float32 with its operator products in TF32 (the configuration states
float32 with TF32 off).  Prints each seed's compared numbers for the
program and the control (and writes them as JSON to ``--out``).  The
benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import numpy as np
import torch

from . import check, inputs, program, spec
from .reference import advance, physics


def readings(cell, seeds, device="cuda"):
    """{"program": [numbers per seed], "control": [...]}."""
    deck = cell.deck()
    phys = physics(deck)
    box = inputs.box_of(cell.config)
    nodes = np.polynomial.legendre.leggauss(phys["order"] + 1)[0]
    dev = torch.device("cuda", 0) if device == "cuda" else "cpu"
    K = len(phys["average_fields"])
    out = {"program": [], "control": [], "seeds": list(seeds)}
    with tempfile.TemporaryDirectory() as work:
        prog = program.Program(deck, inputs.mesh_arrays(box), cell.chips,
                               work, program.Spans(), device)
        for seed in seeds:
            u0 = inputs.initial_state(cell.config, cell.traffic, phys, box,
                                      nodes, seed)
            u0 = u0.astype(np.float32).astype(np.float64)
            prog.set_state(u0)
            prog.steps(check.CHECKED_STEPS)
            got = dict(row=prog.monitor(check.CHECKED_STEPS),
                       ke=prog.integrals.get("kineticenergy"),
                       u=prog.state(u0.shape),
                       avg=prog.averages((K,) + u0.shape[1:]) if K else None)
            ref = advance(deck, box, u0, check.CHECKED_STEPS, dev)
            ctl = advance(deck, box, u0, check.CHECKED_STEPS, dev,
                          torch.float32, tf32=True)
            for key, res in (("program", got), ("control", ctl)):
                nums = check.numbers(u0, res, ref, phys["average_fields"])
                out[key].append(nums)
                print(f"{cell.name} seed {seed} {key}: "
                      + " ".join(f"{k} {v!r}" for k, v in nums.items()),
                      flush=True)
                per = check.fields(res["u"], ref["u"], u0)
                rows = np.abs(res["row"] - ref["row"]) / np.abs(ref["row"])
                print(f"  by field (gap, departure): "
                      f"{[(float(f'{a:.3g}'), float(f'{b:.3g}')) for a, b in per]}"
                      f"; row gaps {[float(f'{x:.3g}') for x in rows]}",
                      flush=True)
        prog.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m bench_h100.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load(), args.workload)
    if not torch.cuda.is_available():
        print("bench_h100.control: no CUDA device", file=sys.stderr)
        return 2
    res = readings(cell, args.seeds)
    for key in ("program", "control"):
        for name in res[key][0]:
            vals = [r[name] for r in res[key]]
            print(f"{cell.name} {key} {name}: min {min(vals)!r} "
                  f"max {max(vals)!r}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

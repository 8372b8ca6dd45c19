#!/usr/bin/env python3
"""The volume kernel's record of two checkouts of the repository, in turns
on one GPU: one checkout's kernels against another's at the same shapes.

  python3 scripts/k1_turns.py --parent DIR --change DIR [--out FILE]

Each turn runs, in its own process from the checkout's root,
chip_smoke.py's phase_device, phase_build (the checkout's kernels, built
from its sources into its own build/) and phase_kernel (and
phase_groups where the checkout has it), in the order parent, change,
change, parent.  Prints, per kernel-record row, each checkout's median
time over its two turns, the bytes bound and the share of it reached,
and the change's time over the parent's; writes every turn's records
and the card's name and power limit to ``--out`` (default
profile_out/k1_turns.json) as JSON.  Needs CUDA.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURN_SECONDS = 600
TURN = ("import json, sys; sys.path.insert(0, '.'); import chip_smoke as c; "
        "c.phase_device(); c.phase_build(); r = c.phase_kernel(); "
        "r.update(c.phase_groups() if hasattr(c, 'phase_groups') else {}); "
        "print('K1_RECORDS ' + json.dumps(r))")


def turn(root, timeout=TURN_SECONDS):
    """One process's kernel records from checkout ``root``."""
    res = subprocess.run([sys.executable, "-c", TURN], cwd=root,
                         capture_output=True, text=True, timeout=timeout)
    sys.stdout.write(res.stdout)
    sys.stderr.write(res.stderr[-4000:])
    if res.returncode != 0:
        raise SystemExit(f"k1_turns: the turn in {root} failed "
                         f"({res.returncode})")
    line = next(l for l in res.stdout.splitlines()
                if l.startswith("K1_RECORDS "))
    return json.loads(line[len("K1_RECORDS "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--change", required=True)
    ap.add_argument("--out", default=os.path.join(ROOT, "profile_out",
                                                  "k1_turns.json"))
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card)
    order = ["parent", "change", "change", "parent"]
    turns = [(who, turn(getattr(args, who))) for who in order]
    rows = {}
    for who, recs in turns:
        for name, r in recs.items():
            row = rows.setdefault(name, dict(bound_ms=r["bound_ms"],
                                             parent=[], change=[]))
            row[who].append(r["ms"])
    print(f"[{card}] median ms of two turns each (parent, change, change, "
          "parent); share = bytes bound / ms")
    for name, row in rows.items():
        med = {w: statistics.median(row[w]) if row[w] else None
               for w in ("parent", "change")}
        row.update(parent_ms=med["parent"], change_ms=med["change"])
        cells = [f"{name:40s} bound {row['bound_ms']:.4f}"]
        for w in ("parent", "change"):
            if med[w] is not None:
                share = row["bound_ms"] / med[w]
                cells.append(f"{w} {med[w]:.4f} ({share:.2f})")
        if med["parent"] and med["change"]:
            ratio = med["change"] / med["parent"]
            cells.append(f"change / parent {ratio:.3f}")
        print("  ".join(cells))
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(dict(card=card, order=order, rows=rows,
                       turns=[dict(checkout=w, records=r) for w, r in turns]),
                  f, indent=1)
    print(f"k1_turns: {args.out}")


if __name__ == "__main__":
    main()

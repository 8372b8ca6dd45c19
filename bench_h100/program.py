"""The system under test: hifiles_tpu_torch, driven as its own entry point
drives it.

``Program`` turns a configuration into the program's own inputs (its deck
parsed by its parser, the benchmark's mesh arrays in its MeshData) and its
solver on the run's cards.  Its ``steps`` and ``monitor`` are the
benchmark's copy of the chunk loop of hifiles_tpu_torch/driver.py
(:173-229): per chunk the time step (``compute_dt``), the steps (``run``,
replays of the captured step), a wait for the cards, the gather of a
sharded state into the single-card twin (``sync_twin``), the monitor row
(``HistoryWriter.write``: the residual norms and the integral quantities)
and, with body forcing, the mass-flux line.  Each runs inside a host span
of the benchmark's own (``Spans``), the layer boundaries the per-layer
metrics read.

This module and the harness import nothing of the JAX package; the
program's state crosses as numpy arrays.
"""

from __future__ import annotations

import contextlib
import gc
import os
import time

import numpy as np
import torch

import hifiles_tpu_torch as ht
from hifiles_tpu_torch.config.params import RunInput
from hifiles_tpu_torch.io.history import HistoryWriter
from hifiles_tpu_torch.mesh.core import MeshData
from hifiles_tpu_torch.parallel import ShardedSolver, select_devices


class Spans:
    """Host spans (name, start, end) on the host clock, and, while a
    profiler runs, the same spans as its ranges ``bench.<name>``."""

    def __init__(self):
        self.spans = []
        self.profiling = False

    @contextlib.contextmanager
    def span(self, name):
        rf = (torch.profiler.record_function(f"bench.{name}")
              if self.profiling else contextlib.nullcontext())
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.spans.append((name, t0, time.perf_counter()))


def deck_text(deck: dict) -> str:
    """The deck as the program's input file."""
    return "".join(f"{k} {v}\n" for k, v in deck.items())


def to_program(u):
    """A benchmark state (K, Ez, Ey, Ex, kz, ky, kx) -> the program's
    (E, U, K) layout."""
    K, Ez, Ey, Ex, *pts = u.shape
    return np.ascontiguousarray(
        u.reshape(K, Ez * Ey * Ex, int(np.prod(pts))).transpose(1, 2, 0))


def from_program(a, shape):
    """The program's (E, U, K) array -> a benchmark state of ``shape``."""
    return np.ascontiguousarray(np.asarray(a).transpose(2, 0, 1)).reshape(
        shape)


class Program:
    """The program's solver of one configuration on ``chips`` cards, with
    the deck file and history written under ``workdir``; ``device`` "cpu"
    (the tests') puts it on the CPU instead."""

    def __init__(self, deck: dict, mesh: dict, chips: int, workdir: str,
                 spans: Spans, device="cuda"):
        path = os.path.join(workdir, "deck")
        with open(path, "w") as f:
            f.write(deck_text(deck))
        self.p = RunInput.from_deck(path)
        self.mesh = MeshData(ctype=np.full(mesh["c2v"].shape[0], ht.HEX,
                                           dtype=np.int64), **mesh)
        self.spans = spans
        self.chips = chips
        self.on_card = device == "cuda"
        self.cards = ([torch.device("cuda", k) for k in range(chips)]
                      if self.on_card else [])
        self.sync()
        t0 = time.perf_counter()
        if chips > 1:
            self.solver = ShardedSolver(self.p, self.mesh,
                                        devices=select_devices(chips, device),
                                        dtype=torch.float32)
            self.io = self.solver.base
        else:
            self.solver = self.io = ht.Solver(self.p, self.mesh,
                                              device=device,
                                              dtype=torch.float32)
        self.sync()
        self.init_s = time.perf_counter() - t0
        self.hist = HistoryWriter(os.path.join(workdir, "history.plt"),
                                  self.io)
        self.massflux_path = os.path.join(workdir, "massflux.dat")
        self.rows, self.integrals = [], {}

    def sync(self):
        """Wait for every card of the run."""
        for dev in self.cards:
            torch.cuda.synchronize(dev)

    def set_state(self, u):
        """Start from the benchmark's state (5, Ez, Ey, Ex, kz, ky, kx)."""
        a = to_program(u)
        self.solver.set_state(a, np.zeros_like(a), 0.0)

    def state(self, shape):
        """The program's state in the benchmark's layout, float64."""
        s = self.solver
        u = s.gather_u() if self.chips > 1 else s.u
        return from_program(u, shape).astype(np.float64)

    def averages(self, shape):
        """The running averages in the benchmark's layout, or None."""
        s = self.solver
        a = s.gather_u_avg() if self.chips > 1 else s.u_avg
        return None if a is None else from_program(a, shape).astype(
            np.float64)

    def steps(self, n):
        """``n`` steps as the driver runs a chunk, and the host seconds the
        ``run`` call took to return (before the cards finish)."""
        sp = self.spans.span
        with sp("compute_dt"):
            dt = self.solver.compute_dt()
        with sp("run"):
            t0 = time.perf_counter()
            self.solver.run(n, dt=dt)
            issued = time.perf_counter() - t0
            self.sync()
        return issued

    def monitor(self, i):
        """The driver's monitor after step ``i``: the twin gathered (on
        several cards), the history row, the mass-flux line.  Returns the
        row's residual norms (its integrals are left in ``integrals``);
        raises FloatingPointError on a non-finite row, as the driver
        aborts."""
        sp = self.spans.span
        if self.chips > 1:
            with sp("sync_twin"):
                self.solver.sync_twin()
        with sp("monitor"):
            row = self.hist.write(i)
        res = np.asarray(row["residual"], dtype=np.float64)
        self.rows.append(res)
        self.integrals = {k: row[k] for k in self.p.integral_quantities}
        if self.p.forcing:
            with sp("massflux"):
                mf = self.io.inflow_massflux()
                with open(self.massflux_path, "a") as fh:
                    fh.write(f"{i}, {mf[0]:.15g}, {mf[1]:.15g}, "
                             f"{mf[2]:.15g}\n")
        return res

    def peak_bytes(self):
        """The highest max_memory_allocated over the run's cards (None
        off the card)."""
        if not self.cards:
            return None
        return max(torch.cuda.max_memory_allocated(d) for d in self.cards)

    def close(self):
        """Free the solver and every card's cached memory."""
        self.solver = self.io = self.hist = None
        gc.collect()
        for d in self.cards:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()

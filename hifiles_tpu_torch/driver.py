"""Run driver: ``python -m hifiles_tpu_torch <input_file>``, the
``bin/HiFiLES <input_file>`` analog (ref:src/HiFiLES.cpp:41-343).

Port of hifiles_tpu/driver.py (:17-250), step for step: it reads a
reference-format deck and its Gambit or Gmsh mesh, builds the port's Solver
(or MixedSolver for mixed and prism meshes) on the card, and runs the outer
time loop in chunks between output events, with CFL time steps, residual
monitoring, history, ParaView/Tecplot/CGNS plots, probes, forces, restart
dumps and the final analytic-error report, printing the same lines and
writing the same files as the JAX driver.  Its own options:
``--device cuda|cpu`` (the card unless the CPU is asked for), ``--f64``
(float64; float32 otherwise) and ``--profile`` (a torch.profiler chrome
trace in ``<outdir>/torch_trace`` of the second chunk, replays of the
captured step, or of the first when it is the only one).  On the card
every chunk runs through the solver's captured step (BlockLoop.run; its
``run_path`` is printed after the first chunk); the monitor, the writers,
compute_dt, gradient_fn, sensor_fn and residual_norm run eagerly between
chunks.  ``--devices N``
runs the mesh as N shards (parallel.ShardedSolver, or
parallel.ShardedMixedSolver for mixed and prism meshes) placed by
parallel.select_devices on the cards of ``--device`` (round-robin, each
card capturing its own segments of the step; all on one card with
``--device cuda:0``), or on the CPU with ``--device cpu``; the timed
parts wait for every card; the writers read the single-device twin,
into which the shards' state is gathered (driver.py:52-62, :85-131 of the
JAX package), and a restart is scattered back onto the shards.  A deck with
``restart_ascii`` restarts from the ASCII file the run dumps
(``Rest_<iter>_p0000.dat``), where the JAX driver reads only the HDF5 one;
the reference reads both.
"""

from __future__ import annotations

import json
import os
import sys
import time

from . import tracing

USAGE = ("usage: python -m hifiles_tpu_torch <input_file> [--f64] "
         "[--outdir D] [--profile] [--device cuda|cpu] [--devices N]")


def load_mesh(run_input, deck_dir: str):
    """The deck's mesh_file, relative to the deck's directory unless
    absolute: Gambit (.neu) or Gmsh (.msh)."""
    from .mesh.gambit import read_gambit

    path = run_input.mesh_file
    if not os.path.isabs(path):
        path = os.path.join(deck_dir, path)
    if path.endswith(".neu"):
        return read_gambit(path)
    if path.endswith(".msh"):
        from .mesh.gmsh import read_gmsh
        return read_gmsh(path)
    raise ValueError(f"unknown mesh format: {path}")


# the parts of the ``wall seconds`` line and the span each reads; the
# driver's ``monitor`` span holds the twin's sync and the history writer's
# own ``monitor`` span, which adds nothing to the aggregate inside it
WALL_SPANS = {"mesh read": "mesh_read", "solver set-up": "solver_setup",
              "restart read": "restart_read", "first chunk": "first_chunk",
              "steps": "steps", "monitor": "monitor", "tecplot": "tecplot",
              "cgns": "cgns", "vtu": "vtu", "restart write": "restart_write"}


def wall_seconds() -> dict:
    """The ``wall seconds`` line's parts that ran: their spans' aggregate
    seconds, in the order the parts come in a run."""
    totals = tracing.record()["totals"]
    return {part: totals[name][1] * 1e-9 for part, name in WALL_SPANS.items()
            if name in totals}


def launch_lines() -> list:
    """The hand kernels' launch lines, from the record (tracing): each
    kernel's launches by variant, and for a kernel of segments (the volume
    kernel) its segments by shape and its launches by group."""
    lines = []
    for name, c in tracing.record()["launches"].items():
        lines.append(f"{name} launches: " + json.dumps(c["by_variant"]))
        if "by_shape" in c:
            lines.append(f"{name} segments by shape: " + json.dumps(
                [[*k, n] for k, n in c["by_shape"].items()]))
            lines.append(f"{name} launches by group: " + json.dumps(
                [[key, shapes, n]
                 for (key, shapes), n in c["by_group"].items()]))
    return lines


def _option(argv, name, default):
    """The value after ``name`` in argv, or ``default``."""
    return argv[argv.index(name) + 1] if name in argv else default


def main(argv=None):
    """Run the deck named by argv[0]; returns the exit code.  Besides the
    JAX driver's lines it prints the volume kernel's launches by variant
    and by (variant, U, E), K3's two entries' launches by variant, and the
    wall seconds of each part of the run
    (mesh read, solver set-up, restart read, the first chunk of steps, the
    later steps, monitor, plots, restart write), the steps synchronised
    with the card: the aggregates of the program's spans (tracing), which
    the run starts empty.  With ``--profile`` the trace shows every span
    as a range ``hf.<name>``."""
    import numpy as np
    import torch

    from . import PRISM
    from .config.params import RunInput
    from .io.history import HistoryWriter
    from .io.restart import read_restart, restart_filename, write_restart
    from .io.vtu import write_vtu

    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print(USAGE)
        return 1
    deck_path = argv[0]
    dtype = torch.float64 if "--f64" in argv else torch.float32
    profile = "--profile" in argv
    outdir = _option(argv, "--outdir", ".")
    device = _option(argv, "--device", "cuda")
    # the `mpirun -np N bin/HiFiLES` analog (ref:src/HiFiLES.cpp:62-65)
    n_dev = int(_option(argv, "--devices", 0))
    os.makedirs(outdir, exist_ok=True)
    tracing.reset()
    span = tracing.span

    t_start = time.time()
    p = RunInput.from_deck(deck_path)
    with span("mesh_read"):
        mesh = load_mesh(p, os.path.dirname(os.path.abspath(deck_path)))
    print(f"mesh: {mesh.n_cells} cells, {mesh.n_verts} vertices, "
          f"boundaries {mesh.bc_names}")

    # pure-prism meshes run through MixedSolver, as the JAX driver routes
    # them (driver.py:75-84: prism tri and quad faces differ in size)
    cts_present = np.unique(mesh.ctype)
    mixed = cts_present.size > 1 or int(cts_present[0]) == PRISM
    with span("solver_setup"):
        if n_dev:
            from .parallel import (ShardedMixedSolver, ShardedSolver,
                                   select_devices)
            sharded = ShardedMixedSolver if mixed else ShardedSolver
            solver = sharded(p, mesh, devices=select_devices(n_dev, device),
                             dtype=dtype)
            io_solver = solver.base
        elif mixed:
            from .solver.multiblock import MixedSolver
            solver = io_solver = MixedSolver(p, mesh, device=device,
                                             dtype=dtype)
        else:
            from .solver.solver import Solver
            solver = io_solver = Solver(p, mesh, device=device, dtype=dtype)
    on_card = solver.device.type == "cuda"

    def wait_cards():
        """Wait for every card the solver's shards sit on."""
        for dev in dict.fromkeys(getattr(solver, "devices",
                                         [solver.device])):
            torch.cuda.synchronize(dev)
    print(f"solver: order {p.order}, {solver.n_fields} fields, "
          f"{solver.dof} DOF/field"
          + (f", {n_dev} devices" if n_dev else ""))

    def sync():
        """The solver the writers read: the single-device twin holding
        the shards' gathered state, clock and featured carry, so that a
        sharded run's files are a single-device run's (driver.py:
        109-131); the solver itself otherwise."""
        return solver.sync_twin() if n_dev else solver

    if p.restart_flag:
        with span("restart_read"):
            if p.restart_ascii:
                from .io.restart import read_restart_ascii
                path = os.path.join(outdir, f"Rest_{p.restart_iter:09d}"
                                    "_p0000.dat")
                t = read_restart_ascii(path, io_solver)
            else:
                path = restart_filename(outdir, p.restart_iter)
                t = read_restart(path, io_solver)
        print(f"restarted from {path} at t={t}")
        if p.patch:
            # patch applied on restart too (ref:src/solver.cpp:321-482);
            # MixedSolver and the sharded solvers refuse patched decks
            # when they are built
            from .solver.ics import apply_patch
            solver.set_state(
                apply_patch(p, solver.block.pos_upts,
                            np.asarray(solver.u, dtype=np.float64)),
                np.zeros_like(solver.u), t)
        if n_dev:
            # distribute the restart state onto the shards
            solver.scatter_u(io_solver.u)
            solver.time = t
        i0 = p.restart_iter
    else:
        i0 = 0

    hist = HistoryWriter(os.path.join(outdir, "history.plt"), io_solver)
    probes = None
    if p.probe:
        from .io.probes import setup_probes
        probes = setup_probes(p, io_solver, outdir)
    events = sorted({p.monitor_res_freq, p.plot_freq, p.restart_dump_freq,
                     getattr(p, "probe_freq", 0) or 0})
    chunk = max(1, min(e for e in events if e > 0))

    # torch.profiler trace of one chunk, the JAX driver's jax.profiler
    # slot (view with perfetto or chrome://tracing): the second, whose
    # steps are replays of the step the first captured
    prof = None
    profile_at = (i0 + (chunk if p.n_steps > chunk else 0) if profile
                  else None)

    i = i0
    while i < i0 + p.n_steps:
        n = min(chunk, i0 + p.n_steps - i)
        if i == profile_at:
            from torch.profiler import ProfilerActivity
            acts = [ProfilerActivity.CPU]
            if on_card:
                acts.append(ProfilerActivity.CUDA)
                wait_cards()
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        # the first chunk also pays the process's first launches
        with span("steps" if i > i0 else "first_chunk"):
            # ShardedMixedSolver takes its dt from the twin, as the JAX
            # driver does (driver.py:171-174)
            solver.run(n, dt=(solver.compute_dt()
                              if hasattr(solver, "compute_dt")
                              else sync().compute_dt()))
            if on_card:
                wait_cards()
        if i == i0:
            print(f"run path: {solver.run_path}")
        i += n
        if i % p.monitor_res_freq == 0 or i == i0 + p.n_steps:
            with span("monitor"):
                sync()
                row = hist.write(i)
            res = row["residual"]
            # NaN abort (ref:src/output.cpp:2268-2275 HistoryOutput)
            if not np.isfinite(res).all():
                raise FloatingPointError(
                    f"NaN residual at iteration {i}; aborting "
                    f"(ref CheckStopConditions behavior)")
            res_s = " ".join(f"{r:.6e}" for r in res)
            print(f"iter {i:8d}  t={solver.time:.6e}  res: {res_s}")
            if p.forcing:
                # mass-flux history of the body-forced inflow plane
                # (ref:src/eles.cpp:5430-5453 massflux.dat)
                mf = io_solver.inflow_massflux()
                if mf is not None:
                    with open(os.path.join(outdir, "massflux.dat"),
                              "a") as fh:
                        fh.write(f"{i}, {mf[0]:.15g}, {mf[1]:.15g}, "
                                 f"{mf[2]:.15g}\n")
            if p.calc_force:
                from .io.forces import write_force_file
                write_force_file(sync(), outdir, i)
                print(f"         force: "
                      + " ".join(f"{x:.6e}" for x in row["force"]))
        if (p.calc_force and 0 < p.monitor_cp_freq < 2**31 - 1
                and i % p.monitor_cp_freq == 0):
            # cp-distribution dumps at their own cadence
            # (ref:src/HiFiLES.cpp monitor_cp_freq)
            from .io.forces import write_force_file
            write_force_file(sync(), outdir, i)
        if probes is not None and getattr(p, "probe_freq", 0) \
                and i % p.probe_freq == 0:
            probes.append(sync(), i)
        if p.plot_freq and i % p.plot_freq == 0:
            if p.write_type == 1:
                from .io.tecplot import write_tec
                with span("tecplot"):
                    write_tec(sync(), outdir, i)
            elif p.write_type == 2:
                from .io.cgns import write_cgns
                with span("cgns"):
                    write_cgns(sync(), outdir, i)
            else:
                with span("vtu"):
                    write_vtu(sync(), outdir, i)
        if prof is not None and i - profile_at >= n:
            if on_card:
                wait_cards()
            prof.stop()
            prof.export_chrome_trace(os.path.join(outdir, "torch_trace"))
            prof = None
            print(f"profiler trace written to {outdir}/torch_trace")
        if p.restart_dump_freq and i % p.restart_dump_freq == 0:
            with span("restart_write"):
                if p.restart_ascii:
                    from .io.restart import write_restart_ascii
                    write_restart_ascii(outdir, sync(), step=i)
                else:
                    write_restart(outdir, sync(), step=i)
                if getattr(solver, "turb_inlet", None) is not None \
                        and solver.turb_inlet.inlet_type == 2:
                    # the eddies' dump, which no run reads back: the JAX
                    # driver never calls read_sem_restart either
                    from .io.restart import write_sem_restart
                    write_sem_restart(outdir, i, solver.turb_inlet,
                                      solver._ti_state, p)

    if p.test_case:
        err = sync().compute_error()
        norm = np.sqrt(err) if p.error_norm_type == 2 else err
        row = list(norm[0])
        if p.viscous:
            # gradient-error row appended like the reference
            # (ref:src/output.cpp:2144-2157)
            row += list(norm[1])
        print("final error vs analytic:", " ".join(f"{e:.10e}" for e in row))
        with open(os.path.join(outdir, "error.dat"), "a") as f:
            f.write(" ".join(f"{e:.10e}" for e in row) + "\n")

    for line in launch_lines():
        print(line)
    print("wall seconds: " + json.dumps(wall_seconds()))
    print(f"total wall time {time.time() - t_start:.1f}s")
    return 0

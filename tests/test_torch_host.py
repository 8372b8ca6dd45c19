"""Host setup of the PyTorch port (hifiles_tpu_torch): the copied numpy host
modules give arrays identical to the JAX package's, and the port imports
and builds a solver with JAX imports blocked."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu import HEX
from hifiles_tpu.config.params import CYCLIC
from hifiles_tpu.mesh.core import build_faces
from hifiles_tpu.mesh.generate import periodic_hex_mesh
from hifiles_tpu.ops.operators import build_tensor_ops
from hifiles_tpu.solver import elements as jax_elements
from hifiles_tpu.solver import ics as jax_ics

from hifiles_tpu_torch.solver import elements as port_elements
from hifiles_tpu_torch.solver import ics as port_ics

sys.path.insert(0, os.path.dirname(__file__))
from test_face_path import tgv_input  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n,order", [(3, 2), (4, 3)])
def test_element_block_and_ic_identical(n, order):
    p = tgv_input()
    p.order = order
    mesh = periodic_hex_mesh(n, n, n)
    dc = np.array([p.dx_cyclic, p.dy_cyclic, p.dz_cyclic])
    conn = build_faces(mesh, {0: CYCLIC}, dc)
    ops = build_tensor_ops(HEX, order, p.upts_type_hexa, p.vcjh_scheme_hexa,
                           p.eta_hexa)
    bj = jax_elements.build_element_block(mesh, conn, ops, delta_cyclic=dc)
    bt = port_elements.build_element_block(mesh, conn, ops, delta_cyclic=dc)
    n_arrays = 0
    for fld in dataclasses.fields(bj):
        a, b = getattr(bj, fld.name), getattr(bt, fld.name)
        if isinstance(a, np.ndarray):
            assert isinstance(b, np.ndarray), fld.name
            assert a.dtype == b.dtype and np.array_equal(a, b), fld.name
            n_arrays += 1
        elif fld.name != "ops":
            assert a == b, fld.name
    assert n_arrays > 10
    nF = p.n_fields_for(3)
    u_j = jax_ics.initial_condition(p, bj.pos_upts, nF)
    u_t = port_ics.initial_condition(p, bt.pos_upts, nF)
    assert u_j.shape == (n ** 3, (order + 1) ** 3, nF)
    assert np.array_equal(u_j, u_t)


def test_over_int_block_identical():
    """The over-integration geometry (cubature adjugates, interpolation and
    projection operators) of the port's block equals the JAX package's."""
    p = tgv_input()
    mesh = periodic_hex_mesh(3, 3, 3)
    dc = np.array([p.dx_cyclic, p.dy_cyclic, p.dz_cyclic])
    conn = build_faces(mesh, {0: CYCLIC}, dc)
    ops = build_tensor_ops(HEX, 3, p.upts_type_hexa, p.vcjh_scheme_hexa,
                           p.eta_hexa)
    kw = dict(delta_cyclic=dc, over_int_order=5)
    bj = jax_elements.build_element_block(mesh, conn, ops, **kw)
    bt = port_elements.build_element_block(mesh, conn, ops, **kw)
    for name in ("jginv_over", "opp_over", "over_filter"):
        a, b = getattr(bj, name), getattr(bt, name)
        assert a is not None and np.array_equal(a, b), name
    assert bt.jginv_over.shape == (27, 6 ** 3, 3, 3)


_NO_JAX = r"""
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "hifiles_tpu", "bench"):
            raise ImportError("import blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import hifiles_tpu_torch as ht
from chip_smoke import (channel_input, duct_mesh, make_solver,
                        mixed_channel_mesh, mixed_wall_mesh,
                        periodic_tri_mesh, quad_wall_input, tgv_input)
from hifiles_tpu_torch.bench import mixed_input as vortex_input
for name in ("plain", "smag", "overint", "rans", "shock"):
    p = tgv_input(order=2, config=name)
    s = make_solver(p, ht.periodic_hex_mesh(3, 3, 3), name, "cpu",
                    torch.float64)
    s.run(1, dt=p.dt)
    assert np.isfinite(s.residual_norm(1)).all(), name
for wall_model in (0, 1):
    p = channel_input(order=2, wall_model=wall_model)
    s = ht.Solver(p, ht.channel_hex_mesh(3, 4, 2), device="cpu",
                  dtype=torch.float64)
    assert s.block.bdy_slot.size and s._bc_fns is not None
    s.run(1, dt=p.dt)
    assert np.isfinite(s.residual_norm(1)).all(), wall_model
    assert np.isfinite(s.u_avg).all() and np.isfinite(s.inflow_massflux()).all()
for mesh, p in ((ht.periodic_quad_mesh(3, 3, -10, 10, -10, 10),
                 vortex_input(order=2)),
                (periodic_tri_mesh(3, 3, -10, 10, -10, 10),
                 vortex_input(order=2)),
                (ht.periodic_tet_mesh(2, 2, 2), tgv_input(order=2))):
    s = ht.Solver(p, mesh, device="cpu", dtype=torch.float64)
    s.run(1, dt=p.dt)
    assert np.isfinite(s.residual_norm(1)).all(), int(mesh.ctype[0])
for mesh, p in ((ht.periodic_mixed_mesh_2d(3, 3, -10, 10, -10, 10),
                 vortex_input(order=2)),
                (mixed_wall_mesh(4, 2), quad_wall_input(wall_model=1)),
                (ht.channel_prism_tet_mesh(2, 2, 1, 1), ht.RunInput.from_deck(
                    sys.argv[1] + "/tests/decks/input_prism_tet_wm_25")),
                (ht.periodic_prism_mesh(2, 2, 2), tgv_input(order=2))):
    s = ht.MixedSolver(p, mesh, device="cpu", dtype=torch.float64)
    s.run(1, dt=p.dt)
    assert np.isfinite(s.residual_norm(1)).all(), s.cts
assert {"hifiles_tpu_torch.solver.multiblock",
        "hifiles_tpu_torch.solver.residual_mixed_soa"} <= set(sys.modules)
# turbulent inlets (SEM and white noise, the default device draws) and
# advection-diffusion, on Solver and MixedSolver
from chip_smoke import adv_diff_input, les_duct_input, les_input
for inlet_type in (1, 2):
    s = ht.Solver(les_input(inlet_type), ht.channel_quad_mesh(
        4, 2, 0.0, 2.0, 0.0, 1.0), device="cpu", dtype=torch.float64)
    assert s.turb_inlet.inlet_type == inlet_type
    s.run(2, dt=1e-5)
    assert np.isfinite(s.residual_norm(1)).all(), inlet_type
s = ht.Solver(les_duct_input(order=1, n_eddy=8), duct_mesh(2), device="cpu",
              dtype=torch.float64)
s.run(1, dt=1e-5)
assert np.isfinite(s.residual_norm(1)).all()
s = ht.MixedSolver(les_input(2), mixed_channel_mesh(), device="cpu",
                   dtype=torch.float64)
s.run(1, dt=1e-5)
assert np.isfinite(s.residual_norm(1)).all()
for mesh in (ht.periodic_quad_mesh(3, 3, -1, 1, -1, 1),
             ht.periodic_hex_mesh(2, 2, 2, -1, 1, -1, 1, -1, 1)):
    p = adv_diff_input(order=2, dims=mesh.n_dims)
    s = ht.Solver(p, mesh, device="cpu", dtype=torch.float64)
    s.run(2, dt=p.dt)
    assert np.isfinite(s.compute_error(2)).all()
s = ht.MixedSolver(adv_diff_input(order=2, dims=2), ht.periodic_mixed_mesh_2d(
    2, 2, -1, 1, -1, 1), device="cpu", dtype=torch.float64)
s.run(1, dt=1e-3)
assert np.isfinite(s.residual_norm(1)).all()
assert "hifiles_tpu_torch.solver.turb_inlet" in sys.modules
# element-sharded runs: ShardedSolver (TGV, a SEM channel) and
# ShardedMixedSolver (tri+quad box) on CPU shards
from hifiles_tpu_torch.parallel import (ShardedMixedSolver, ShardedSolver,
                                        select_devices)
for p, mesh, n in ((tgv_input(order=2), ht.periodic_hex_mesh(3, 3, 2), 3),
                   (les_input(2), ht.channel_quad_mesh(4, 2, 0.0, 2.0, 0.0,
                                                       1.0), 2)):
    s = ShardedSolver(p, mesh, devices=select_devices(n, "cpu"))
    s.run(1, dt=p.dt if p.dt_type == 0 else 1e-5)
    assert np.isfinite(s.norm_residual(1)).all() and s.u.shape[0] == n
s = ShardedMixedSolver(vortex_input(order=2), ht.periodic_mixed_mesh_2d(
    3, 3, -10, 10, -10, 10), devices=select_devices(2, "cpu"))
s.run(1, dt=1e-4)
assert np.isfinite(s.norm_residual(1)).all()
# the run chunk's capture seam with a stand-in that captures on the CPU
# (a capture runs nothing: the solver returns to its snapshot)
class CpuGraph:
    def __init__(self, solver):
        self.solver = solver
    def warm_up(self, body):
        body()
    def capture(self, body):
        snap = self.solver.snapshot()
        body()
        self.solver.restore(snap)
    def replay(self, body):
        body()
    def release(self):
        pass
p = tgv_input(order=2)
a, b = (ht.Solver(p, ht.periodic_hex_mesh(3, 3, 3), device="cpu",
                  dtype=torch.float64) for _ in range(2))
a._step_graph = lambda device, gens: CpuGraph(a)
a.run(3, dt=p.dt)
b.run(3, dt=p.dt, graph=False)
assert a.run_path == "SoA (fast) captured" and b.run_path.endswith("eager")
assert torch.equal(a.u_soa, b.u_soa)
assert "hifiles_tpu_torch.solver.graph" in sys.modules
# python -m hifiles_tpu_torch on a tiny deck: 2 steps of the TGV on 3^3
# hexes, p=1, with plots, history and an ASCII restart
import os, runpy, tempfile
from chip_smoke import tgv_deck
from hifiles_tpu_torch.mesh.gambit import write_gambit
d = tempfile.mkdtemp()
write_gambit(ht.periodic_hex_mesh(3, 3, 3), os.path.join(d, "box.neu"))
with open(os.path.join(d, "run.deck"), "w") as f:
    f.write(tgv_deck("box.neu", order=1, n_steps=2, monitor_res_freq=1,
                     plot_freq=2, restart_dump_freq=2))
for out, extra in (("out", []), ("out2", ["--devices", "2"])):
    sys.argv = ["hifiles_tpu_torch", os.path.join(d, "run.deck"),
                "--device", "cpu", "--outdir", os.path.join(d, out), *extra]
    try:
        runpy.run_module("hifiles_tpu_torch", run_name="__main__")
    except SystemExit as e:
        assert e.code == 0, e.code
    assert sorted(os.listdir(os.path.join(d, out))) == [
        "Mesh_000000002", "Mesh_000000002.pvtu", "Rest_000000002_p0000.dat",
        "history.plt"], os.listdir(os.path.join(d, out))
assert {"hifiles_tpu_torch.driver", "hifiles_tpu_torch.io.vtu",
        "hifiles_tpu_torch.io.history", "hifiles_tpu_torch.io.restart",
        "hifiles_tpu_torch.parallel.soa_sharding"} <= set(sys.modules)
# the long runs' entry points at toy sizes: the TGV validation script's
# run and comparison, chip_smoke.py's Sod tube and type-1 forced channel
import chip_smoke
sys.path.insert(0, os.path.join(chip_smoke.ROOT, "scripts"))
import validate_torch_tgv as vt
rec = vt.validate(order=1, n1=2, t_end=0.2, device="cpu", dtype=torch.float64)
assert len(rec["t"]) == 4 and np.isfinite(rec["dissipation"]).all()
assert set(rec["vs_jax"]["checks"]) >= {"laminar", "rms", "tke0"}
from chip_smoke import channel_bf1_input, sod_check, sod_input
p = sod_input()
s = ht.Solver(p, ht.channel_quad_mesh(12, 1, 0.0, 10.0, 0.0, 0.2, bc_x="L",
                                      bc_X="R"), device="cpu",
              dtype=torch.float64)
s.run(3, dt=p.dt)
assert len(sod_check(s, 3 * p.dt)) == 4 and np.isfinite(s.u).all()
p = channel_bf1_input(order=1)
s = ht.Solver(p, ht.channel_hex_mesh(2, 2, 2), device="cpu",
              dtype=torch.float64)
s.run(2, dt=p.dt)
assert p.body_force_type == 1 and np.isfinite(s.mdot_old)
# the benchmark entry point: one configuration at a toy size, and main's
# refusal of a name it does not know
from hifiles_tpu_torch import bench
r = bench.run_config("mixed", device="cpu", repeats=1, steps=1, order=1, n=2)
assert r["value"] > 0 and np.isfinite(r["row"]).all() and not r["gated"]
try:
    bench.main(["--device"])
    raise AssertionError("bench.main took an option")
except SystemExit:
    pass
# the multi-device dry run: its eight legs in 2 shards on the CPU, and
# its command line's refusal of anything but a shard count
from hifiles_tpu_torch import multichip
legs = multichip.dryrun_multichip(2, "cpu")
assert list(legs) == list(multichip.LEGS) and all(
    s.run_path.startswith("SoA") for s in legs.values())
try:
    multichip.main(["--devices"])
    raise AssertionError("multichip.main took an option")
except SystemExit:
    pass
blocked = ("jax", "jaxlib", "hifiles_tpu", "bench")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_blocked():
    """The port builds and steps the plain, smag, overint, rans and shock
    Solvers, the walled, forced, averaged channel (with and without a wall
    model), a quad, a tri and a tet Solver, and MixedSolvers on a tri+quad
    box, a wall-modelled tri+quad channel, a wall-modelled prism/tet
    channel and a prism box; SEM and white-noise inlets on quad and hex
    Solvers and a tri+quad MixedSolver; advection-diffusion on quads, hexes
    and tri+quads; element-sharded runs (a ShardedSolver TGV and SEM
    channel, a ShardedMixedSolver tri+quad box); a run chunk through the
    capture seam with a stand-in graph; and runs ``python -m
    hifiles_tpu_torch`` on a tiny deck on the CPU, single-device and with
    ``--devices 2``; and the long runs' entry points at toy sizes
    (scripts/validate_torch_tgv.py's validate, chip_smoke.py's Sod tube
    and type-1 forced channel), the benchmark entry point
    hifiles_tpu_torch.bench and the multi-device dry run
    hifiles_tpu_torch.multichip, with every import of JAX, of the JAX
    package hifiles_tpu and of the root bench.py refused."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _NO_JAX, ROOT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout

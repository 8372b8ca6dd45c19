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
        if name.split(".")[0] in ("jax", "jaxlib", "hifiles_tpu"):
            raise ImportError("import blocked: " + name)
        return None

sys.meta_path.insert(0, BlockJax())
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
torch.set_num_threads(1)
import hifiles_tpu_torch as ht
from chip_smoke import (channel_input, make_solver, mixed_wall_mesh,
                        periodic_tri_mesh, quad_wall_input, tgv_input,
                        vortex_input)
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
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "hifiles_tpu"))
assert not loaded, loaded
print("NO_JAX_OK")
"""


def test_port_runs_with_jax_blocked():
    """The port builds and steps the plain, smag, overint, rans and shock
    Solvers, the walled, forced, averaged channel (with and without a wall
    model), a quad, a tri and a tet Solver, and MixedSolvers on a tri+quad
    box, a wall-modelled tri+quad channel, a wall-modelled prism/tet
    channel and a prism box, with every import of JAX and of the JAX
    package hifiles_tpu refused."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _NO_JAX, ROOT],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout

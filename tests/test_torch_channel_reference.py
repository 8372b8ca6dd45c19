"""The port on the benchmark's channel at Re_tau = 395
(bench_h100/configs/channel_retau395.json, traffic mon50) against the
benchmark's plain reference (bench_h100/reference: plain PyTorch, nothing
of the port or of JAX), on the CPU in float64, the deck shrunk to p = 2
on a 3 x 4 x 2 box: the residual to 1e-11 of its scale, three steps with
the forcing and the averages, the L1 row and the kinetic energy, at the
tolerances of bench_h100/tests/test_h100_reference.py.  The comparison
sees each piece of the channel's physics: the port with C_s = 0, without
the adiabatic walls' gradient correction or without the forcing fails
it."""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

import hifiles_tpu_torch as ht
from hifiles_tpu_torch.config.params import RunInput
from hifiles_tpu_torch.io.history import integral_quantities
from hifiles_tpu_torch.mesh.core import MeshData
from hifiles_tpu_torch.solver import bc

from bench_h100 import inputs, program
from bench_h100.reference import advance, physics
from bench_h100.reference.fr_hex import FRHex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "bench_h100")
STEPS = 3

torch.set_num_threads(1)


def toy():
    """(configuration, traffic, deck): the cell at p = 2 on 3 x 4 x 2
    hexes of the same box, its perturbation at 5%."""
    with open(os.path.join(BENCH, "configs", "channel_retau395.json")) as f:
        conf = json.load(f)
    with open(os.path.join(BENCH, "traffic", "mon50.json")) as f:
        traffic = json.load(f)
    conf["mesh"]["n"] = [3, 4, 2]
    conf["deck"]["order"] = "2"
    traffic["perturbation"] = dict(traffic["perturbation"], amplitude=0.05)
    return conf, traffic, {**conf["deck"], **traffic["deck"]}


def start(conf, traffic, deck, seed=7):
    ph = physics(deck)
    box = inputs.box_of(conf)
    nodes = np.polynomial.legendre.leggauss(ph["order"] + 1)[0]
    u0 = inputs.initial_state(conf, traffic, ph, box, nodes, seed)
    return ph, box, u0.astype(np.float32).astype(np.float64)


def port_run(deck, box, u0):
    """The port on the CPU in float64: its residual at u0, and after
    STEPS steps its state, averages, L1 row and kinetic energy."""
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "deck"), "w") as f:
            f.write(program.deck_text(deck))
        p = RunInput.from_deck(os.path.join(d, "deck"))
    mesh = inputs.mesh_arrays(box)
    s = ht.Solver(p, MeshData(ctype=np.full(mesh["c2v"].shape[0], ht.HEX),
                              **mesh), device="cpu", dtype=torch.float64)
    a = program.to_program(u0)
    s.set_state(a, np.zeros_like(a), 0.0)
    rhs = program.from_program(s._to_numpy(s._rhs(s.u_soa, None))[0],
                               u0.shape)
    s.run(STEPS, dt=p.dt)
    K = len(p.average_fields)
    return dict(rhs=rhs, u=program.from_program(s.u, u0.shape),
                avg=program.from_program(s.u_avg, (K,) + u0.shape[1:]),
                row=s.residual_norm(1),
                ke=integral_quantities(s, p.integral_quantities)[
                    "kineticenergy"])


def agreement(got, rhs, ref, u0):
    """Which of the port's outputs meet the reference's, each at
    test_h100_reference.py's tolerance."""
    scale = np.abs(rhs).max(axis=tuple(range(1, 7)))
    inc = [np.abs(ref["u"][f] - u0[f]).max() for f in range(5)]
    return dict(
        rhs=np.abs(got["rhs"] - rhs).max() / scale.min() < 1e-11,
        u=all(np.abs(got["u"][f] - ref["u"][f]).max() <= 1e-9 * inc[f]
              for f in range(5)),
        row=np.allclose(got["row"], ref["row"], rtol=1e-11, atol=0.0),
        ke=np.isclose(got["ke"], ref["ke"], rtol=1e-13, atol=0.0),
        avg=np.allclose(got["avg"], ref["avg"], rtol=1e-12, atol=1e-12))


def no_adiabatic_correction(self, u_r, grad_l, norm):
    """bc.BCFunctions.boundary_gradients without the adiabatic walls'
    removal of the wall-normal internal-energy gradient."""
    return [list(g) for g in grad_l]


# fault -> (deck keys of the port's run, whether to drop the correction)
FAULTS = {"sound": ({}, False),
          "no_sgs": ({"C_s": "0.0"}, False),
          "no_adiabatic_correction": ({}, True),
          "no_forcing": ({"body_forcing": "0"}, False)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_port_meets_the_reference_and_each_fault_fails(fault, monkeypatch):
    conf, traffic, deck = toy()
    ph, box, u0 = start(conf, traffic, deck)
    assert ph["les"] and ph["forcing"] and len(ph["average_fields"]) == 5
    rhs = FRHex(box, ph, "cpu").residual(torch.as_tensor(u0)).numpy()
    ref = advance(deck, box, u0, STEPS, "cpu")
    assert ref["ke"] is not None and ref["avg"] is not None
    keys, drop = FAULTS[fault]
    if drop:
        monkeypatch.setattr(bc.BCFunctions, "boundary_gradients",
                            no_adiabatic_correction)
    got = port_run({**deck, **keys}, box, u0)
    ok = agreement(got, rhs, ref, u0)
    if fault == "sound":
        assert all(ok.values()), ok
    else:
        assert not all(ok.values()), ok



def test_wall_clusters_give_the_one_tree_distance():
    """The wall distance from one KD-tree a wall cluster
    (elements.wall_clusters: the toy channel's two walls) is the single
    tree's over every wall point, on the solution and flux points."""
    from scipy.spatial import cKDTree
    from hifiles_tpu_torch.solver.elements import wall_clusters
    from hifiles_tpu_torch.solver.solver import wall_points
    conf, _, deck = toy()
    box = inputs.box_of(conf)
    with tempfile.TemporaryDirectory() as d:
        with open(os.path.join(d, "deck"), "w") as f:
            f.write(program.deck_text(deck))
        p = RunInput.from_deck(os.path.join(d, "deck"))
    mesh = inputs.mesh_arrays(box)
    s = ht.Solver(p, MeshData(ctype=np.full(mesh["c2v"].shape[0], ht.HEX),
                              **mesh), device="cpu", dtype=torch.float64)
    b = s.block
    wall = wall_points(b.bdy_slot, b.bdy_mask, b.bdy_bcid, b.pos_fpts,
                       s._bc_flags, 3)
    assert wall.shape == (2 * 3 * 2 * 9, 3)
    parts = wall_clusters(wall)
    assert sorted(np.unique(c[:, 1]).tolist() for c in parts) == [[0.0],
                                                                   [2.0]]
    one = cKDTree(wall)
    for pts, got in ((b.pos_upts, b.wall_dist_upts),
                     (b.pos_fpts, b.wall_dist_fpts)):
        want = one.query(pts.reshape(-1, 3))[0]
        assert np.array_equal(got.reshape(-1), want)
        assert got.min() >= 0.0 and 0.5 < got.max() <= 1.0
    # a cloud without a wide empty slab stays whole
    rng = np.random.default_rng(0)
    assert len(wall_clusters(rng.random((500, 3)))) == 1

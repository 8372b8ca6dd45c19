"""The plain reference against the program, on the CPU in float64 at toy
sizes (p = 2 on boxes of 2-4 hexes a side): the residual, three steps with
forcing and averages, the monitor row; and the lower-precision control
(the reference in float32 with TF32 operator products) failing the
comparison there, where the program in float32 passes."""

import copy
import tempfile

import numpy as np
import pytest
import torch

from bench_h100 import check, inputs, program, spec
from bench_h100.reference import advance, physics
from bench_h100.reference.fr_hex import FRHex

CHANNEL = "channel_deck.mon25"
SIZES = {"tgv_re1600_160.mon50": [2, 2, 2], CHANNEL: [3, 2, 2]}


def bench():
    """BENCHMARK.json with a cell of the test channel deck
    (channel_deck.json here: walls, wall distances, Smagorinsky, forcing
    and averages), which no cell of the benchmark runs."""
    b = copy.deepcopy(spec.load())
    b["configs"].append({"name": "channel_deck",
                         "file": "bench_h100/tests/channel_deck.json"})
    b["workloads"].append({"name": CHANNEL, "config": "channel_deck",
                           "traffic": "mon25", "chips": 1})
    return b


def toy(cell_name):
    """The cell at p = 2 on a toy box, a larger perturbation."""
    cell = spec.Cell(bench(), cell_name)
    cell.config["mesh"]["n"] = SIZES[cell_name]
    cell.config["deck"]["order"] = "2"
    cell.traffic["perturbation"] = dict(cell.traffic["perturbation"],
                                        amplitude=0.05)
    return cell


def program_run(cell, u0, dtype, steps):
    """The program on the CPU in ``dtype``: its residual at u0, and after
    ``steps`` steps its state, averages, L1 row and monitor integrals."""
    import hifiles_tpu_torch as ht
    from hifiles_tpu_torch.config.params import RunInput
    from hifiles_tpu_torch.io.history import integral_quantities
    from hifiles_tpu_torch.mesh.core import MeshData
    box = inputs.box_of(cell.config)
    with tempfile.TemporaryDirectory() as d:
        with open(d + "/deck", "w") as f:
            f.write(program.deck_text(cell.deck()))
        p = RunInput.from_deck(d + "/deck")
    mesh = inputs.mesh_arrays(box)
    s = ht.Solver(p, MeshData(ctype=np.full(mesh["c2v"].shape[0], ht.HEX),
                              **mesh), device="cpu", dtype=dtype)
    a = program.to_program(u0)
    s.set_state(a, np.zeros_like(a), 0.0)
    r = program.from_program(s._to_numpy(s._rhs(s.u_soa, None))[0],
                             u0.shape)
    s.run(steps, dt=p.dt)
    K = len(p.average_fields)
    avg = (program.from_program(s.u_avg, (K,) + u0.shape[1:])
           if K else None)
    ints = integral_quantities(s, p.integral_quantities)
    return dict(rhs=r, u=program.from_program(s.u, u0.shape), avg=avg,
                row=s.residual_norm(1), ke=ints.get("kineticenergy"))


def start(cell, seed=5):
    ph = physics(cell.deck())
    box = inputs.box_of(cell.config)
    nodes = np.polynomial.legendre.leggauss(ph["order"] + 1)[0]
    u0 = inputs.initial_state(cell.config, cell.traffic, ph, box, nodes,
                              seed)
    return ph, box, u0.astype(np.float32).astype(np.float64)


@pytest.mark.parametrize("name", sorted(SIZES))
def test_reference_is_the_program_in_float64(name):
    cell = toy(name)
    ph, box, u0 = start(cell)
    got = program_run(cell, u0, torch.float64, 3)
    fr = FRHex(box, ph, "cpu")
    rhs = fr.residual(torch.as_tensor(u0)).numpy()
    scale = np.abs(rhs).max(axis=tuple(range(1, 7)), keepdims=True)
    assert np.abs(got["rhs"] - rhs).max() / scale.min() < 1e-11
    ref = advance(cell.deck(), box, u0, 3, "cpu")
    for f in range(5):
        inc = np.abs(ref["u"][f] - u0[f]).max()
        assert np.abs(got["u"][f] - ref["u"][f]).max() <= 1e-9 * inc
    np.testing.assert_allclose(got["row"], ref["row"], rtol=1e-11)
    assert (got["ke"] is None) is (ref["ke"] is None)
    if ref["ke"] is not None:
        np.testing.assert_allclose(got["ke"], ref["ke"], rtol=1e-13)
    if ref["avg"] is not None:
        np.testing.assert_allclose(got["avg"], ref["avg"], rtol=1e-12,
                                   atol=1e-12)


def test_positions_and_mesh_are_the_programs():
    """The benchmark's mesh arrays are the program's generators', and its
    solution points the program's, in the state's layout."""
    import hifiles_tpu_torch as ht
    for name, gen in (("tgv_re1600_160.mon50",
                       lambda: ht.periodic_hex_mesh(2, 3, 4)),
                      (CHANNEL, lambda: ht.channel_hex_mesh(2, 3, 4))):
        cell = toy(name)
        cell.config["mesh"]["n"] = [2, 3, 4]
        box = inputs.box_of(cell.config)
        mine, theirs = inputs.mesh_arrays(box), gen()
        for key, val in mine.items():
            want = getattr(theirs, key)
            if key == "xv":
                np.testing.assert_allclose(val, want, atol=1e-14)
            else:
                assert np.array_equal(np.asarray(val), np.asarray(want)), key


@pytest.mark.parametrize("name", sorted(SIZES))
def test_control_fails_where_the_program_passes(name):
    """At toy sizes: the program in float32 reads every number far under
    the cell's limit, the control over it on at least one."""
    cell = toy(name)
    ph, box, u0 = start(cell, seed=11)
    ref = advance(cell.deck(), box, u0, check.CHECKED_STEPS, "cpu")
    got = program_run(cell, u0, torch.float32, check.CHECKED_STEPS)
    ctl = advance(cell.deck(), box, u0, check.CHECKED_STEPS, "cpu",
                  torch.float32, tf32=True)
    limits = cell.config["limits"]
    fields = ph["average_fields"]
    sound = check.numbers(u0, got, ref, fields)
    low = check.numbers(u0, ctl, ref, fields)
    assert check.verdict(sound, limits), sound
    assert not check.verdict(low, limits), low
    assert ("ke" in sound) is (name != CHANNEL)

"""The volume kernel's grouped launch on the CPU (hifiles_tpu_torch/solver/
volume.py): volume_tdisf_many against the per-call plain version, its
refusals, volume_tdisf_groups' gathering by device and variant, and the
residual's volume request: one grouped call per RK stage for the blocks
of a mixed mesh and for every shard of a sharded mixed run on one device,
each block still counted by shape.  The kernel's own arithmetic on the
host is tests/test_torch_kernel_source.py; on the card, chip_smoke.py."""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu.mesh.generate import periodic_mixed_mesh_2d

from hifiles_tpu_torch import MixedSolver, tracing
from hifiles_tpu_torch.convert import mesh_from, run_input_from
from hifiles_tpu_torch.parallel import ShardedMixedSolver, select_devices
from hifiles_tpu_torch.solver import volume as V

sys.path.insert(0, os.path.dirname(__file__))
from test_mixed import vortex_input  # noqa: E402
from test_torch_mixed_sharding import prism_tet_wm  # noqa: E402

torch.set_num_threads(1)

@pytest.fixture(autouse=True)
def zero_counters():
    """The counting stand-in counts on the kernel's counters, which the
    CPU tests elsewhere expect at 0: set them back after each test."""
    yield
    tracing.reset()


def launches():
    """The volume kernel's launch counts in the program's record."""
    return tracing.record()["launches"]["volume_tdisf"]


BASE = V.VolumeParams(gamma=1.4, prandtl=0.72, mu=0.05, viscous=True,
                      prandtl_t=0.9, C_s=0.1, kappa=0.41)
VARIANTS = {
    "ns": (5, {}, False),
    "smagorinsky": (5, dict(sgs=V.SGS_SMAGORINSKY), False),
    "wale": (5, dict(sgs=V.SGS_WALE), False),
    "rans": (6, {}, False),
    "added_flux": (5, {}, True),
    "inviscid": (5, dict(viscous=False), False),
}


def call(U, E, d, F, seed, dtype=torch.float64, geo="full", add=False,
         device="cpu"):
    """A seeded VolumeCall of one block; ``geo`` "broadcast" gives jg,
    delta and wdist one column."""
    rng = np.random.default_rng(seed)
    u = rng.random((U, F, E)) + 1.0
    u[:, d + 1] += 10.0
    if F == d + 3:
        u[:, d + 2] = BASE.mu * rng.uniform(-2.0, 20.0, (U, E))
    E_g = 1 if geo == "broadcast" else E
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)
    return V.VolumeCall(
        t(u), t(rng.normal(size=(d, U, F, E)) * 0.5),
        t(rng.random((d, d, U, E_g))), t(0.5 + rng.random((U, E_g))),
        t(0.5 * rng.random((U, E_g))),
        t(rng.normal(size=(d, U, F, E)) * 0.1) if add else None)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_many_matches_per_call_plain_version(name):
    """Blocks of different U, E and geometry in one call, each equal to
    its own plain version; volume_tdisf is the one-call case."""
    F, kw, add = VARIANTS[name]
    prm = dataclasses.replace(BASE, **kw)
    calls = [call(7, 33, 3, F, 1, add=add), call(4, 300, 3, F, 2,
                                                 geo="broadcast", add=add),
             call(5, 16, 3, F, 3, add=add)]
    outs = V.volume_tdisf_many(calls, prm)
    assert len(outs) == len(calls)
    for c, got in zip(calls, outs):
        want = V.volume_tdisf_ref(c.u, c.grad, c.jg, prm, c.delta, c.wdist,
                                  c.extra)
        assert torch.equal(got, want)
        assert torch.equal(V.volume_tdisf(c.u, c.grad, c.jg, prm, c.delta,
                                          c.wdist, c.extra), want)


def test_many_counts_nothing_on_the_cpu():
    tracing.reset()
    V.volume_tdisf_many([call(3, 8, 3, 5, 0), call(3, 9, 3, 5, 1)], BASE)
    f = launches()
    assert (f["launches"], f["segments"], len(f["by_shape"]),
            len(f["by_group"])) == (0, 0, 0, 0)


MIXED = {
    "dtype": lambda: [call(3, 8, 3, 5, 0),
                      call(3, 8, 3, 5, 1, dtype=torch.float32)],
    "device": lambda: [call(3, 8, 3, 5, 0), call(3, 8, 3, 5, 1,
                                                 device="meta")],
    "dims": lambda: [call(3, 8, 3, 5, 0), call(3, 8, 2, 5, 1)],
    "fields": lambda: [call(3, 8, 3, 5, 0), call(3, 8, 3, 6, 1)],
    "variant": lambda: [call(3, 8, 3, 5, 0), call(3, 8, 3, 5, 1, add=True)],
}


@pytest.mark.parametrize("kind", sorted(MIXED))
def test_many_refuses_mixed_calls(kind):
    """One launch is one variant on one device in one dtype: anything
    else raises, and nothing runs."""
    with pytest.raises(ValueError, match="volume_tdisf_many"):
        V.volume_tdisf_many(MIXED[kind](), BASE)


def test_many_refuses_no_calls():
    with pytest.raises(ValueError, match="no calls"):
        V.volume_tdisf_many([], BASE)


def test_groups_gather_by_variant(monkeypatch):
    """volume_tdisf_groups: one volume_tdisf_many per (device, dtype,
    parameters, variant) over every request, each request given back its
    own outputs in order."""
    seen = []
    many = V.volume_tdisf_many

    def spy(calls, prm):
        seen.append((len(calls), prm))
        return many(calls, prm)
    monkeypatch.setattr(V, "volume_tdisf_many", spy)
    smag = dataclasses.replace(BASE, sgs=V.SGS_SMAGORINSKY)
    reqs = [V.VolumeRequest([call(4, 10 + k, 3, 5, k),
                             call(3, 20 + k, 3, 5, 10 + k, add=True)], BASE)
            for k in range(3)]
    reqs.append(V.VolumeRequest([call(4, 7, 3, 5, 20)], smag))
    outs = V.volume_tdisf_groups(reqs)
    assert sorted(seen, key=lambda x: (x[0], x[1].sgs)) == \
        [(1, smag), (3, BASE), (3, BASE)]
    for req, got in zip(reqs, outs):
        assert len(got) == len(req.calls)
        for c, o in zip(req.calls, got):
            assert torch.equal(o, V.volume_tdisf_ref(
                c.u, c.grad, c.jg, req.prm, c.delta, c.wdist, c.extra))


def counting_plain(monkeypatch):
    """A plain version of the grouped call that counts each call as one
    launch of its blocks (the card's launches on the CPU); returns the
    list of the calls' sizes."""
    plain = V.volume_tdisf_many_ref
    sizes = []

    def counted(calls, prm):
        sizes.append(len(calls))
        tracing.launch("volume_tdisf", V.call_variant(calls[0], prm),
                       [(c.u.shape[0], c.u.shape[2]) for c in calls])
        return plain(calls, prm)
    monkeypatch.setattr(V, "volume_tdisf_many_ref", counted)
    tracing.reset()
    return sizes


def mixed_box():
    return MixedSolver(run_input_from(vortex_input(order=2, viscous=1)),
                       mesh_from(periodic_mixed_mesh_2d(4, 4, -10, 10, -10,
                                                        10)), device="cpu")


def sharded_prism_tet():
    p, mesh = prism_tet_wm()
    return ShardedMixedSolver(run_input_from(p), mesh_from(mesh),
                              devices=select_devices(4, "cpu"))


@pytest.mark.parametrize("make, blocks", [(mixed_box, 2),
                                          (sharded_prism_tet, 8)],
                         ids=["mixed", "mixed3d_x4"])
def test_residual_stage_issues_one_grouped_call(monkeypatch, make, blocks):
    """One residual evaluation issues one grouped volume call on the
    device, carrying every block of every shard; by_shape counts each."""
    s = make()
    sizes = counting_plain(monkeypatch)
    sums, _ = s._monitor_residual(1)
    assert np.isfinite(sums).all()
    f = launches()
    assert sizes == [blocks] and f["launches"] == 1 and \
        f["segments"] == blocks
    assert sum(f["by_shape"].values()) == blocks
    want = {(U, E) for U, E in ((b.ops.n_upts, b.n_eles)
                                for b in s._blocks)}
    assert {(U, E) for _, U, E in f["by_shape"]} == want
    assert len(f["by_variant"]) == 1


def test_over_integration_issues_two_grouped_calls(monkeypatch):
    """Over-integrated, a residual evaluation of 4 shards issues two
    grouped volume calls, each carrying every shard's block: the inviscid
    flux at the cubature points, then the viscous flux at the solution
    points, two variants."""
    from hifiles_tpu.mesh.generate import periodic_hex_mesh
    from hifiles_tpu_torch.parallel import ShardedSolver
    from test_face_path import tgv_input
    p = tgv_input()
    p.order, p.over_int, p.over_int_order = 2, 1, 4
    s = ShardedSolver(run_input_from(p), mesh_from(periodic_hex_mesh(4, 2,
                                                                     2)),
                      devices=select_devices(4, "cpu"))
    sizes = counting_plain(monkeypatch)
    sums, _ = s._monitor_residual(1)
    assert np.isfinite(sums).all()
    f = launches()
    assert sizes == [4, 4] and f["launches"] == 2 and f["segments"] == 8
    assert sorted(f["by_variant"]) == ["D3F5+inviscid", "D3F5+viscous"]
    assert {U for _, U, _ in f["by_shape"]} == {27, 125}

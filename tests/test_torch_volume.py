"""Volume stage of the PyTorch port (hifiles_tpu_torch/solver/volume.py):
the plain version against the JAX package's Pallas kernel
(pallas_kernels.volume_tdisf_fm, interpret mode on CPU), and the wrapper's
CPU dispatch.  The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from hifiles_tpu.solver import pallas_kernels as pk

from hifiles_tpu_torch.solver.volume import volume_tdisf, volume_tdisf_ref

torch.set_num_threads(1)

E, U, F, D = 8, 125, 5, 3
KW = dict(gamma=1.4, mu=1e-3, prandtl=0.72)


def inputs(seed=0):
    """Port-layout inputs: u (U, F, E), grad (d, U, F, E), jg (d, d, U, E)."""
    rng = np.random.default_rng(seed)
    u = rng.random((U, F, E)) + 1.0
    u[:, 4] += 10.0                      # positive internal energy
    grad = rng.random((D, U, F, E)) * 1e-2
    jg = rng.random((D, D, U, E))
    return u.astype(np.float32), grad.astype(np.float32), \
        jg.astype(np.float32)


@pytest.mark.parametrize("viscous", [False, True])
@pytest.mark.parametrize("geo", ["full", "broadcast"])
def test_volume_ref_matches_pallas(viscous, geo, monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call",
                        lambda *a, **k: orig(*a, interpret=True, **k))
    u, grad, jg = inputs()
    if geo == "broadcast":
        jg = np.ascontiguousarray(jg[..., :1])
    jg_e = np.broadcast_to(jg, (D, D, U, E))
    # Pallas layout: u (5, E, U), grad (15, E, U) [field*3+dim],
    # jg (9, E, U) [l*3+m]
    u_fm = np.transpose(u, (1, 2, 0))
    g_fm = np.transpose(grad, (2, 0, 3, 1)).reshape(F * D, E, U)
    if not viscous:
        g_fm = np.zeros_like(g_fm)
    jg_fm = np.transpose(jg_e, (0, 1, 3, 2)).reshape(D * D, E, U)
    out_fm = np.asarray(pk.volume_tdisf_fm(
        u_fm, g_fm, jg_fm, viscous=viscous, tile=4, **KW))
    # (15, E, U) [l*5+i] -> (d, U, F, E)
    want = np.transpose(out_fm.reshape(D, F, E, U), (0, 3, 1, 2))

    got = volume_tdisf_ref(torch.from_numpy(u),
                           torch.from_numpy(grad) if viscous else None,
                           torch.from_numpy(jg), viscous=viscous, **KW)
    assert got.dtype == torch.float32 and got.shape == (D, U, F, E)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("viscous", [False, True])
def test_wrapper_dispatches_plain_on_cpu(viscous):
    u, grad, jg = (torch.from_numpy(a) for a in inputs(seed=1))
    g = grad if viscous else None
    before = volume_tdisf.launches
    got = volume_tdisf(u, g, jg, viscous=viscous, **KW)
    want = volume_tdisf_ref(u, g, jg, viscous=viscous, **KW)
    assert torch.equal(got, want)
    assert volume_tdisf.launches == before == 0


def test_wrapper_rejects_bad_inputs():
    u, grad, jg = (torch.from_numpy(a) for a in inputs())
    with pytest.raises(ValueError):
        volume_tdisf(u[:, :4], grad, jg, viscous=True, **KW)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad[:, :, :4], jg, viscous=True, **KW)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg[..., :3], viscous=True, **KW)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad.double(), jg, viscous=True, **KW)
    with pytest.raises(ValueError):
        volume_tdisf(u.transpose(0, 2).contiguous().transpose(0, 2), grad,
                     jg, viscous=True, **KW)
    assert volume_tdisf.launches == 0

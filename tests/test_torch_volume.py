"""Volume stage of the PyTorch port (hifiles_tpu_torch/solver/volume.py):
the plain version against the JAX package's Pallas kernel
(pallas_kernels.volume_tdisf_fm, interpret mode on CPU) on the kernel's own
coverage, and for every option the Pallas kernel lacks (SA field,
Sutherland viscosity, SGS flux, inviscid part off, added flux) against the
same algebra composed from the JAX plane functions of residual_soa.py, at
d = 3 and d = 2 (quads and tris); and
the wrapper's CPU dispatch and input checks.  The CUDA kernel itself is
held against the plain version on the card by chip_smoke.py."""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from jax.experimental import pallas as pl

from hifiles_tpu.solver import pallas_kernels as pk
from hifiles_tpu.solver import residual_soa as jrs

from hifiles_tpu_torch import tracing
from hifiles_tpu_torch.solver.volume import (SGS_NONE, SGS_SMAGORINSKY,
                                              SGS_WALE, VolumeParams,
                                              volume_tdisf, volume_tdisf_ref)

torch.set_num_threads(1)


def launched():
    """The volume kernel's launches in the program's record."""
    return tracing.record()["launches"]["volume_tdisf"]["launches"]

E, U, F, D = 8, 125, 5, 3
KW = dict(gamma=1.4, mu=1e-3, prandtl=0.72)
PRM = {v: VolumeParams(viscous=v, **KW) for v in (False, True)}


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
                           torch.from_numpy(jg), PRM[viscous])
    assert got.dtype == torch.float32 and got.shape == (D, U, F, E)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("viscous", [False, True])
def test_wrapper_dispatches_plain_on_cpu(viscous):
    u, grad, jg = (torch.from_numpy(a) for a in inputs(seed=1))
    g = grad if viscous else None
    before = launched()
    got = volume_tdisf(u, g, jg, PRM[viscous])
    want = volume_tdisf_ref(u, g, jg, PRM[viscous])
    assert torch.equal(got, want)
    assert launched() == before == 0


def test_wrapper_rejects_bad_inputs():
    u, grad, jg = (torch.from_numpy(a) for a in inputs())
    prm = PRM[True]
    with pytest.raises(ValueError):
        volume_tdisf(u[:, :4], grad, jg, prm)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad[:, :, :4], jg, prm)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg[..., :3], prm)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad.double(), jg, prm)
    with pytest.raises(ValueError):
        volume_tdisf(u.transpose(0, 2).contiguous().transpose(0, 2), grad,
                     jg, prm)
    assert launched() == 0


# ----------------------------------------------------------------------
# the options beyond the Pallas kernel, against the JAX plane functions
# ----------------------------------------------------------------------

VARIANTS = {
    "euler_f6": dict(F=6, prm=dict(viscous=False)),
    "ns_sutherland": dict(prm=dict(fix_vis=0)),
    "rans": dict(F=6),
    "rans_sutherland": dict(F=6, prm=dict(fix_vis=0)),
    "smagorinsky": dict(prm=dict(sgs=SGS_SMAGORINSKY)),
    "wale": dict(prm=dict(sgs=SGS_WALE)),
    "rans_wale": dict(F=6, prm=dict(sgs=SGS_WALE)),
    "viscous_part_only": dict(prm=dict(inviscid=False, sgs=SGS_WALE)),
    "inviscid_part_f6": dict(F=6, prm=dict(viscous=False)),
    "added_flux": dict(extra=True, prm=dict(sgs=SGS_SMAGORINSKY)),
}
FEATURE_KW = dict(gamma=1.4, prandtl=0.72, mu=1e-3, viscous=True,
                  rt_inf=0.8, c_sth=0.368, prandtl_t=0.9, C_s=0.1,
                  kappa=0.41)


def feature_inputs(F, geo, extra, seed=5, d=D):
    """f64 inputs at dimension d: u (U, F, E) with chi = nu~/mu in [-2, 20]
    for F = d + 3 (both branches of psi and the clip of mu_t), grad, jg,
    delta and wdist (both branches of the Smagorinsky wall limit) and an
    added flux."""
    rng = np.random.default_rng(seed)
    u = rng.random((U, F, E)) + 1.0
    u[:, d + 1] += 10.0
    if F == d + 3:
        u[:, d + 2] = 1e-3 * rng.uniform(-2.0, 20.0, (U, E))
    grad = rng.normal(size=(d, U, F, E)) * 1e-1
    ne = 1 if geo == "broadcast" else E
    jg = rng.random((d, d, U, ne))
    delta = 0.1 + 0.2 * rng.random((U, ne))
    wdist = 0.2 * rng.random((U, ne))
    xf = rng.normal(size=(d, U, F, E)) * 1e-2 if extra else None
    return u, grad, jg, delta, wdist, xf


def jax_volume(u, grad, jg, prm, delta, wdist, xf):
    """The volume stage of residual_soa.py:1094-1139 composed from the JAX
    plane functions: inviscid rows (_normal_flux_p along each unit axis),
    visc_flux_p, sgs_flux_p, the added flux, then adj(J); d from jg."""
    F = u.shape[1]
    D = jg.shape[0]
    up = [jnp.asarray(u[:, i]) for i in range(F)]
    one, zero = jnp.ones_like(up[0]), jnp.zeros_like(up[0])
    fl = [jrs._normal_flux_p(up, [one if k == m else zero for k in range(D)],
                             D, prm.gamma) if prm.inviscid
          else [zero] * F for m in range(D)]
    if prm.viscous:
        gr = [[jnp.asarray(grad[l][:, i]) for i in range(F)]
              for l in range(D)]
        fv = jrs.visc_flux_p(
            up, gr, D, gamma=prm.gamma, prandtl=prm.prandtl,
            mu_inf=prm.mu, rt_inf=prm.rt_inf, c_sth=prm.c_sth,
            fix_vis=prm.fix_vis, rans=F == D + 3, prandtl_t=prm.prandtl_t,
            c_v1=prm.c_v1, omega=prm.omega)
        if prm.sgs != SGS_NONE:
            fs = jrs.sgs_flux_p(up, gr, jnp.asarray(delta),
                                jnp.asarray(wdist), D, sgs_model=prm.sgs,
                                C_s=prm.C_s, gamma=prm.gamma,
                                prandtl_t=prm.prandtl_t, kappa=prm.kappa)
            fv = [[a + b for a, b in zip(fv[m], fs[m])] for m in range(D)]
        fl = [[a + b for a, b in zip(fl[m], fv[m])] for m in range(D)]
    if xf is not None:
        fl = [[a + xf[m][:, i] for i, a in enumerate(fl[m])]
              for m in range(D)]
    return np.stack([np.stack([np.asarray(
        sum(jg[l, m] * fl[m][i] for m in range(D))) for i in range(F)],
        axis=1) for l in range(D)])


@pytest.mark.parametrize("geo", ["full", "broadcast"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_volume_ref_options_match_jax_planes(variant, geo):
    v = VARIANTS[variant]
    F = v.get("F", 5)
    prm = dataclasses.replace(VolumeParams(**FEATURE_KW), **v.get("prm", {}))
    u, grad, jg, delta, wdist, xf = feature_inputs(F, geo, v.get("extra"))
    want = jax_volume(u, grad, jg, prm, delta, wdist, xf)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = volume_tdisf(t(u), t(grad), t(jg), prm, t(delta), t(wdist), t(xf))
    assert got.shape == want.shape == (D, U, F, E)
    scale = np.abs(want).max()
    assert np.isfinite(want).all() and scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * max(scale, 1.0))
    assert launched() == 0


@pytest.mark.parametrize("geo", ["full", "broadcast"])
@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["ns"])
def test_volume_ref_2d_matches_jax_planes(variant, geo):
    """The d = 2 volume stage (quads and tris: F = 4, or 5 with the SA
    field) against the JAX plane functions called with d = 2."""
    v = VARIANTS.get(variant, {})
    F = 5 if v.get("F") == 6 else 4
    prm = dataclasses.replace(VolumeParams(**FEATURE_KW), **v.get("prm", {}))
    u, grad, jg, delta, wdist, xf = feature_inputs(F, geo, v.get("extra"),
                                                   d=2)
    want = jax_volume(u, grad, jg, prm, delta, wdist, xf)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = volume_tdisf(t(u), t(grad), t(jg), prm, t(delta), t(wdist), t(xf))
    assert got.shape == want.shape == (2, U, F, E)
    scale = np.abs(want).max()
    assert np.isfinite(want).all() and scale > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * max(scale, 1.0))
    assert launched() == 0


def test_wrapper_rejects_bad_2d_inputs():
    """At d = 2 (read from jg) u takes 4 or 5 fields and grad and the added
    flux carry 2 dimension planes."""
    u, grad, jg, delta, wdist, xf = (
        torch.from_numpy(a) for a in feature_inputs(4, "full", True, d=2))
    prm = VolumeParams(**FEATURE_KW)
    volume_tdisf(u, grad, jg, prm, extra=xf)
    with pytest.raises(ValueError):
        volume_tdisf(torch.cat([u, u[:, :2]], 1), None, jg,
                     VolumeParams(viscous=False))
    with pytest.raises(ValueError):
        volume_tdisf(u, torch.cat([grad, grad[:1]]), jg, prm)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg[:, :1].contiguous(), prm)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, prm, extra=torch.cat([xf, xf[:1]]))
    assert launched() == 0


def test_volume_ref_options_change_the_flux():
    """Each option moves the flux well above the tolerance above, so the
    parity cases check what they are named for."""
    u, grad, jg, delta, wdist, xf = feature_inputs(6, "full", True)
    t = torch.from_numpy
    base = VolumeParams(**FEATURE_KW)
    ref = volume_tdisf_ref(t(u), t(grad), t(jg), base, t(delta), t(wdist))
    for opts in (dict(fix_vis=0), dict(sgs=SGS_SMAGORINSKY),
                 dict(sgs=SGS_WALE), dict(inviscid=False)):
        other = volume_tdisf_ref(t(u), t(grad), t(jg),
                                 dataclasses.replace(base, **opts),
                                 t(delta), t(wdist))
        assert (other - ref).abs().max() > 1e-6 * ref.abs().max(), opts
    f5 = volume_tdisf_ref(t(u[:, :5].copy()), t(grad[:, :, :5].copy()),
                          t(jg), base)
    assert (f5 - ref[:, :, :5]).abs().max() > 1e-6 * ref.abs().max()


def test_wrapper_rejects_bad_feature_inputs():
    u, grad, jg, delta, wdist, xf = (
        torch.from_numpy(a) for a in feature_inputs(5, "full", True))
    prm = dataclasses.replace(VolumeParams(**FEATURE_KW),
                              sgs=SGS_SMAGORINSKY)
    volume_tdisf(u, grad, jg, prm, delta, wdist, xf)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, prm, None, wdist)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, prm, delta[:-1].contiguous(), wdist)
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, prm, delta, wdist[:, :3].contiguous())
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, prm, delta, wdist, xf[:, :, :4].contiguous())
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, prm, delta, wdist.float())
    with pytest.raises(ValueError):
        volume_tdisf(u, grad, jg, dataclasses.replace(prm, sgs=7), delta,
                     wdist)
    with pytest.raises(ValueError):
        volume_tdisf(torch.cat([u, u[:, :2]], 1), None, jg,
                     VolumeParams(viscous=False))
    assert launched() == 0

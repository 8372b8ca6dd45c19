"""The volume kernel K1's least time on the card, from its launch's shapes.

A copy of chip_smoke.py's K1 bound arithmetic (HBM_BYTES_PER_S,
F32_OPS_PER_S, volume_bytes, volume_ops): the bytes are each operand read
once and the (d, U, F, E) transformed flux written once; the operations are
the output elements of every elementwise arithmetic op of the volume
term's plain algebra, counted by dispatch.  Here the algebra counted is
the reference's (reference/fr_hex.py: the inviscid, viscous and
Smagorinsky fluxes at the solution points, and the transform to reference
axes, d x d products a point), so that the count is the same whatever
implements the volume term.  The bound is the larger of bytes over the
card's bandwidth and operations over its f32 rate; a share is bound over
the measured time.
"""

from __future__ import annotations

import torch

# NVIDIA's H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# the elementwise aten ops whose output elements count as operations
ARITH_OPS = {"add", "sub", "rsub", "mul", "div", "neg", "abs", "sqrt",
             "pow", "exp", "log1p", "logaddexp", "maximum", "minimum",
             "clamp", "where", "reciprocal", "ge", "gt", "le", "lt"}


def k1_bytes(U, E, F=5, d=3, viscous=True, sgs=False, geo_cols=1,
             wdist_cols=1, itemsize=4):
    """Bytes one K1 segment must move: u (U, F, E), the gradient (d, U, F,
    E) when viscous, the adjugate (d, d, U, geo_cols), with the SGS model
    the filter width (U, geo_cols) and the wall distance (U, wdist_cols),
    and the (d, U, F, E) output.  ``geo_cols`` is 1 where every element's
    geometry is the same (the program compresses it), E otherwise."""
    n = U * F * E + d * d * U * geo_cols + d * U * F * E
    if viscous:
        n += d * U * F * E
        if sgs:
            n += U * geo_cols + U * wdist_cols
    return n * itemsize


def k1_ops(U, E, sgs=False):
    """Operations of the volume term on (U, E) points: the reference's
    flux algebra and the transform, counted on a few points by dispatch
    and scaled to U * E."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from .reference.fr_hex import FRHex

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            if name in ARITH_OPS and hasattr(out, "numel"):
                Count.n += out.numel()
            return out
    pts = 64
    fr = FRHex.__new__(FRHex)
    fr.ph = dict(gamma=1.4, prandtl=0.72, mu=1e-3, C_s=0.1, kappa=0.41,
                 prandtl_t=0.9)
    fr.delta = 0.1
    g = torch.Generator().manual_seed(0)
    u = [torch.rand(pts, generator=g) + 1.0 for _ in range(5)]
    u[4] = u[4] + 10.0
    grad = [[torch.randn(pts, generator=g) for _ in range(5)]
            for _ in range(3)]
    jg = [[torch.rand(pts, generator=g) for _ in range(3)] for _ in range(3)]
    wd = torch.rand(pts, generator=g) if sgs else None
    with Count():
        fv = fr.viscous(u, grad, range(3), wd)
        flux = [[a + b for a, b in zip(fr.inviscid(u, m), fv[m])]
                for m in range(3)]
        # tdisf_l = sum_m adj(J)_lm F_m for every field
        [[sum(jg[l][m] * flux[m][f] for m in range(3)) for f in range(5)]
         for l in range(3)]
    return Count.n / pts * U * E


def k1_bound_ms(U, E, sgs=False, walls=False):
    """(bound ms, "bytes" or "operations") of one K1 launch of a box of
    E equal hexes at U points each in f32: the geometry compressed to one
    column, the wall distance one column a element in a channel."""
    nbytes = k1_bytes(U, E, sgs=sgs, wdist_cols=E if walls else 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = k1_ops(U, E, sgs) / F32_OPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms,
                                                           "operations")

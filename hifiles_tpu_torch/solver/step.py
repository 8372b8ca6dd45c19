"""Low-storage time integrators on tensors (ref:src/eles.cpp:1080-1265,
ref:data/RK_coeff.dat).

Port of hifiles_tpu/solver/step.py.  adv_type codes: 0 forward Euler,
1 SSP-RK24(2N*), 2 SSP-RK34(2N), 3 RK45(2N) Carpenter-Kennedy,
4 SSP-RK414(2N) Niegemann.  Each stage calls the spatial residual once;
the updates around it run in the tracing part step.update.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing

# Carpenter-Kennedy RK45(2N) (ref:data/RK_coeff.dat adv_type==3)
RK45_A = np.array([
    0.0,
    -567301805773.0 / 1357537059087.0,
    -2404267990393.0 / 2016746695238.0,
    -3550918686646.0 / 2091501179385.0,
    -1275806237668.0 / 842570457699.0])
RK45_B = np.array([
    1432997174477.0 / 9575080441755.0,
    5161836677717.0 / 13612068292357.0,
    1720146321549.0 / 2090206949498.0,
    3134564353537.0 / 4481467310338.0,
    2277821191437.0 / 14882151754819.0])

# Niegemann SSP-RK414(2N) (ref:data/RK_coeff.dat adv_type==4)
RK414_A = np.array([
    0.0, -0.7188012108672410, -0.7785331173421570, -0.0053282796654044,
    -0.8552979934029281, -3.9564138245774565, -1.5780575380587385,
    -2.0837094552574054, -0.7483334182761610, -0.7032861106563359,
    0.0013917096117681, -0.0932075369637460, -0.9514200470875948,
    -7.1151571693922548])
RK414_B = np.array([
    0.0367762454319673, 0.3136296607553959, 0.1531848691869027,
    0.0030097086818182, 0.3326293790646110, 0.2440251405350864,
    0.3718879239592277, 0.6204126221582444, 0.1524043173028741,
    0.0760894927419266, 0.0077604214040978, 0.0024647284755382,
    0.0780348340049386, 5.5059777270269628])

N_STAGES = {0: 1, 1: 4, 2: 4, 3: 5, 4: 14}


def _axpy(y, x, a):
    """y += a * x in place: a Python float as add_'s alpha, anything else
    (a dt buffer: 0-d, or a local dt (1, 1, E) broadcast along the
    elements) through addcmul_, which reads it on the device, so that a
    step captured in a CUDA graph takes a new dt without a new capture."""
    if isinstance(a, (int, float)):
        return y.add_(x, alpha=a)
    return y.addcmul_(x, a)


def make_step_fn(residual_fn, adv_type: int, post_stage=None):
    """Build step(u, reg, dt) -> (u, reg) advancing one full time step.

    ``residual_fn(u)`` returns the stage rhs, -div_tconf/detjac plus any
    source (ref:src/eles.cpp:1095-1247), as a new tensor.  The step
    updates ``u``
    (and, for the 2N schemes, ``reg``) IN PLACE and returns them: the JAX
    step builds new arrays, here the state and register are each held
    once.  ``reg`` may be None for the first step of a 2N scheme.
    ``post_stage(u)``, e.g. shock capture, runs after every stage update and
    must update ``u`` in place.  Coefficients stay Python floats, so an f32
    state stays f32.  ``dt`` is a float, or a tensor in the state's dtype
    that broadcasts against it (0-d, as the JAX chunk's dt_j, solver.py:
    618-626; the per-element local dt as a (1, 1, E) plane, as the JAX
    chunk reshapes it, solver.py:302-303).  ``u`` and
    ``reg`` may be any object with these in-place tensor methods, e.g. the
    per-shard state of an element-sharded run (soa_sharding.ShardState,
    which always comes with its register)."""
    ps = post_stage if post_stage is not None else (lambda u: u)

    def update():
        return tracing.part("step.update")

    if adv_type == 0:
        def step(u, reg, dt):
            k = residual_fn(u)
            with update():
                ps(_axpy(u, k, dt))
            return u, reg
        return step

    if adv_type == 1:  # SSP-RK24 (ref:src/eles.cpp:1117-1170)
        def step(u, reg, dt):
            with update():
                u0 = u.clone()
            for _ in range(3):
                k = residual_fn(u)
                with update():
                    ps(_axpy(u, k, dt / 3.0))
            k = residual_fn(u)
            with update():
                ps(_axpy(u.mul_(0.75).add_(u0, alpha=0.25), k, dt / 4.0))
            return u, reg
        return step

    if adv_type == 2:  # SSP-RK34 (ref:src/eles.cpp:1172-1220)
        def step(u, reg, dt):
            with update():
                u0 = u.clone()
            for _ in range(2):
                k = residual_fn(u)
                with update():
                    ps(_axpy(u, k, dt / 2.0))
            k = residual_fn(u)
            with update():
                ps(_axpy(u.div_(3.0).add_(u0, alpha=2.0 / 3.0), k, dt / 6.0))
            k = residual_fn(u)
            with update():
                ps(_axpy(u, k, dt / 2.0))
            return u, reg
        return step

    if adv_type in (3, 4):  # 2N-register schemes (ref:src/eles.cpp:1229-1257)
        A = [float(a) for a in (RK45_A if adv_type == 3 else RK414_A)]
        Bc = [float(b) for b in (RK45_B if adv_type == 3 else RK414_B)]

        def step(u, reg, dt):
            # A[0] == 0 clears the register at the first stage, as the JAX
            # step's reg * 0.0 does
            with update():
                r = u.new_zeros(u.shape) if reg is None else reg
            for a, b in zip(A, Bc):
                k = residual_fn(u)
                with update():
                    _axpy(r.mul_(a), k, dt)
                    ps(u.add_(r, alpha=b))
            return u, r
        return step

    raise ValueError(f"adv_type {adv_type} not implemented")

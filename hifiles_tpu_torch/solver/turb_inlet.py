"""Turbulent inflow generation on torch: white noise and the synthetic eddy
method (SEM).

Port of hifiles_tpu/solver/turb_inlet.py (the reference's LES inlet,
ref:src/bdy_inters.cpp:1140-2320, ref:include/turbinlet.h).
``inlet_host_setup`` (:70-177) is numpy and copied verbatim: the eddy box in
generator coordinates (cylindrical (r, theta, x) in 3-D, ref:src/funcs.cpp:
2937-2958; Cartesian (y, 0, x) in 2-D), the length scale, the inlet's area
weights and the initial eddies from ``np.random.default_rng(seed)``.  The
per-step update (``make_fluc_core``, :180-303) runs in torch on the
solver's device: advection by the area-averaged inlet velocity, wrap and
recycle in generator coordinates, the nearest of the three theta-images
by distance magnitude, the tent form function, the diagonal
Reynolds-stress rescale and the zero-mass-flux correction.  As in the JAX
package, the reference's Cholesky rescale, applied there with the last
point's factor (a latent bug, r_ij being diagonal), is applied per point.

The random draws come from a draw object with ``normal(shape)`` and
``uniform(shape)`` (and ``get_state``/``set_state``).  The JAX package
draws with ``jax.random`` from a key in its scan carry (:241-242,
:258-265, key :318); the port consumes draws in exactly that order and
count (white noise: one normal (Fin, nfp, d) per step; SEM: two uniforms
(n_eddy, 3) per step, even when no eddy leaves the box).  ``DeviceDraws``,
a torch.Generator on the solver's device seeded from the same seed, is the
default; ``ReplayDraws`` replays given arrays, so that the port computes
what JAX computes from the same numbers.  The inlet state is (eddy
positions, signs, draw object).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..config.params import SUB_IN_CHAR, SUB_IN_SIMP, SUP_IN

INFLOW_FLAGS = (SUB_IN_SIMP, SUB_IN_CHAR, SUP_IN)
C_MU = 0.09  # k-eps constant (ref:include/turbinlet.h:8)


def inlet_host_setup(run_input, block, seed: int = 0):
    """Host-side inlet constants: eddy box geometry, length scale, area
    weights, initial eddies.  Everything here is a *global* quantity
    (computed over the whole inlet plane), shared verbatim by sharded runs.

    Returns None when no boundary group requests a turbulent inlet
    (inlet_type 0 everywhere) — mirroring ref:src/solver.cpp:111-118 which
    only updates inlets with inlet.type != 0."""
    bcs = run_input.bc_list
    inlet_bcs = [b for b in bcs
                 if b.flag in INFLOW_FLAGS and b.inlet_type != 0]
    if not inlet_bcs:
        return None
    c = SimpleNamespace()
    c.itype = inlet_bcs[0].inlet_type
    c.mode = inlet_bcs[0].mode
    vis_y = inlet_bcs[0].vis_y
    c.turb_1 = inlet_bcs[0].turb_1
    c.turb_2 = inlet_bcs[0].turb_2
    c.n_eddy = n_eddy = max(int(inlet_bcs[0].n_eddy), 1)

    d = c.d = block.ops.n_dims
    Pf = block.ops.n_fpts
    inlet_ids = {i for i, b in enumerate(bcs)
                 if b.flag in INFLOW_FLAGS and b.inlet_type != 0}
    c.in_faces = np.array([f for f, bid in enumerate(block.bdy_bcid)
                           if int(bid) in inlet_ids], dtype=np.int64)
    slots = c.slots = block.bdy_slot[c.in_faces]          # (Fin, nfp)
    mask = c.mask = block.bdy_mask[c.in_faces] \
        if block.bdy_mask is not None else np.ones(slots.shape)
    pos = block.pos_fpts[slots]                           # (Fin, nfp, d)
    c.norm = block.norm_fpts[slots]
    # mixed meshes pass a facade with PER-SLOT weight / cell-size tables
    # (the global slot space has no uniform Pf; see multiblock._TIFacade)
    if getattr(block, "slot_wq", None) is not None:
        wq = block.slot_wq[slots]
    else:
        wq = block.ops.fpt_weights[slots % Pf]
    c.wdA = wq * block.tdA_fpts[slots] * mask             # (Fin, nfp)
    c.total_area = float(c.wdA.sum())                     # ref::2103-2131

    # --- eddy length scale (ref:src/eles.cpp:6023-6070): the largest
    # inflow-element cell size, floor for the k-eps scale
    if getattr(block, "slot_ls", None) is not None:
        ls_min = float(block.slot_ls[slots[mask > 0]].max()) \
            if mask.any() else 0.0
    else:
        in_eles = np.unique(slots[mask > 0] // Pf)
        ref_vol = {1: 4.0, 4: 8.0, 0: 2.0, 2: 4.0 / 3.0, 3: 4.0}[
            block.ops.ele_type]
        max_detjac = float(block.detjac_upts[in_eles].max()) \
            if in_eles.size else 0.0
        ls_min = (run_input.filter_ratio
                  * (ref_vol * max_detjac) ** (1.0 / d)
                  / (run_input.order + 1.0))
    if c.mode == 0 and c.turb_2 > 0:
        ls = max(ls_min, C_MU ** 0.75 * c.turb_1 ** 1.5 / c.turb_2)
    else:
        ls = ls_min        # mode 1 wall-distance scale: reference stub
    c.ls = max(ls, 1e-12)

    # --- bounding box in generator coordinates (ref::1519-1627)
    pos3 = np.zeros(pos.shape[:-1] + (3,))
    pos3[..., :d] = pos
    c.pos3 = pos3
    pflat = pos3[mask > 0]
    if d == 3:
        gen = np.stack([np.sqrt(pflat[:, 1]**2 + pflat[:, 2]**2),
                        np.arctan2(pflat[:, 1], pflat[:, 2]),
                        pflat[:, 0]], axis=-1)
    else:
        # 2-D: (y tangential, 0, x axial)
        gen = np.stack([pflat[:, 1], np.zeros(pflat.shape[0]),
                        pflat[:, 0]], axis=-1)
    box_min = gen.min(axis=0)
    box_max = gen.max(axis=0)
    box_min[2] -= c.ls
    box_max[2] += c.ls
    box_min[0] += vis_y          # no eddies in the viscous sublayer
    box_max[0] -= vis_y
    if d == 2:
        box_min[1], box_max[1] = -0.5, 0.5   # unit depth
    box_dim = np.maximum(box_max - box_min, 1e-12)
    if d == 3:
        box_vol = ((box_max[0]**2 - box_min[0]**2) * box_dim[1] / 2
                   * box_dim[2])              # cyl volume (ref::1622-1624)
    else:
        box_vol = box_dim[0] * box_dim[2]
    c.box_min, c.box_max, c.box_dim = box_min, box_max, box_dim
    c.alpha = float(np.sqrt(max(box_vol, 1e-30) / n_eddy))  # ref::1771

    c.uvw_ref = run_input.uvw_ref if np.isfinite(
        getattr(run_input, "uvw_ref", np.nan)) and run_input.uvw_ref > 0 \
        else 1.0

    # initial eddies: uniform in the box, random signs (ref::1629-1666)
    rng = np.random.default_rng(seed)
    gen0 = box_min + rng.random((n_eddy, 3)) * box_dim
    if d == 3:
        eddy0 = np.stack([gen0[:, 2], gen0[:, 0] * np.sin(gen0[:, 1]),
                          gen0[:, 0] * np.cos(gen0[:, 1])], axis=-1)
    else:
        eddy0 = np.stack([gen0[:, 2], gen0[:, 0],
                          np.zeros(n_eddy)], axis=-1)
    c.eddy0 = eddy0
    c.sgn0 = np.where(rng.random((n_eddy, 3)) < 0.5, -1.0, 1.0)
    c.seed = seed
    return c


# ----------------------------------------------------------------------
# draws
# ----------------------------------------------------------------------

class DeviceDraws:
    """Standard normal and uniform [0, 1) draws from a torch.Generator on
    ``device``, seeded with ``seed``; its state is the generator's.  A time
    step captured in a CUDA graph registers ``gen`` with the graph, so
    that every replay draws new numbers and the state follows them."""

    def __init__(self, seed, device, dtype):
        self.device, self.dtype = torch.device(device), dtype
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, device=self.device,
                           dtype=self.dtype)

    def uniform(self, shape):
        return torch.rand(shape, generator=self.gen, device=self.device,
                          dtype=self.dtype)

    def get_state(self):
        return self.gen.get_state()

    def set_state(self, state):
        self.gen.set_state(state)


class ReplayDraws:
    """Given arrays handed out in order, one per ``normal`` or ``uniform``
    call, each checked against the shape asked for; its state is the
    number of arrays handed out.

    A solver's time loop calls ``stage`` before every step, outside the
    step: it copies that step's arrays into buffers on the device, which
    ``normal`` and ``uniform`` then hand out in turn, so that the step,
    captured in a CUDA graph or not, reads its draws without a copy from
    the host.  Without ``stage`` each call uploads its array."""

    def __init__(self, arrays, device, dtype):
        self.arrays = list(arrays)
        self.device, self.dtype = torch.device(device), dtype
        self.i = 0
        self._staged, self._turn = None, 0

    def _take(self, shape):
        if self.i >= len(self.arrays):
            raise IndexError(f"ReplayDraws: all {len(self.arrays)} draws "
                             "used")
        a = self.arrays[self.i]
        if tuple(a.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws: draw {self.i} has shape "
                             f"{tuple(a.shape)}, asked for {tuple(shape)}")
        self.i += 1
        return torch.as_tensor(np.array(a), dtype=self.dtype)

    def stage(self, shapes):
        """Copy the next arrays, one per shape of ``shapes`` (one step's
        draws in the order the step takes them), into the buffers that
        ``normal`` and ``uniform`` hand out from now on."""
        if self._staged is None:
            self._staged = [torch.empty(tuple(sh), dtype=self.dtype,
                                        device=self.device) for sh in shapes]
        for buf, sh in zip(self._staged, shapes, strict=True):
            buf.copy_(self._take(sh))
        self._turn = 0

    def _next(self, shape):
        if self._staged is None:
            return self._take(shape).to(self.device)
        buf = self._staged[self._turn % len(self._staged)]
        if tuple(buf.shape) != tuple(shape):
            raise ValueError(f"ReplayDraws: staged draw of shape "
                             f"{tuple(buf.shape)}, asked for {tuple(shape)}")
        self._turn += 1
        return buf

    normal = uniform = _next

    def get_state(self):
        return self.i

    def set_state(self, state):
        self.i = int(state)


# ----------------------------------------------------------------------
# the per-step update
# ----------------------------------------------------------------------

def _cyl_of(pos):
    """cart -> (r, theta, x) (ref:src/funcs.cpp:2937-2947)."""
    return torch.stack([torch.sqrt(pos[..., 1] ** 2 + pos[..., 2] ** 2),
                        torch.atan2(pos[..., 1], pos[..., 2]),
                        pos[..., 0]], dim=-1)


def _cart_of(cyl):
    """(r, theta, x) -> cart (ref:src/funcs.cpp:2948-2958)."""
    return torch.stack([cyl[..., 2],
                        cyl[..., 0] * torch.sin(cyl[..., 1]),
                        cyl[..., 0] * torch.cos(cyl[..., 1])], dim=-1)


def make_fluc_core(c, bc_fns, device, dtype):
    """The per-step inlet update over the whole inlet plane
    (turb_inlet.py:180-303 of the JAX package).

    Returns ``core(state, u_in, dt)`` -> (new_state, fl (Fin, nfp, d),
    rou (Fin, nfp)): ``u_in`` the inlet points' solution as F planes
    (1, Fin*nfp); ``bc_fns`` the boundary functions of the inlet points
    (one plane column per point), whose inviscid ghost state gives the
    mean inlet state (ref::1993-2027)."""
    d = c.d
    itype, mode = c.itype, c.mode
    n_eddy = c.n_eddy
    Fin, nfp = c.wdA.shape
    total_area = c.total_area
    alpha, uvw_ref = c.alpha, c.uvw_ref
    turb_1 = c.turb_1
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    box_min, box_max, box_dim = f(c.box_min), f(c.box_max), f(c.box_dim)
    ls = torch.full((3,), c.ls, dtype=dtype, device=device)[:d]
    theta_step = f([0.0, c.box_dim[1], 0.0])
    pos3, wdA, mask = f(c.pos3), f(c.wdA), f(c.mask)
    norm = list(f(c.norm).reshape(1, -1, d).unbind(-1))   # d x (1, Fin*nfp)

    def to_gen(cart):
        if d == 3:
            return _cyl_of(cart)
        return torch.stack([cart[..., 1], torch.zeros_like(cart[..., 0]),
                            cart[..., 0]], dim=-1)

    def from_gen(gen):
        if d == 3:
            return _cart_of(gen)
        return torch.stack([gen[..., 2], gen[..., 0],
                            torch.zeros_like(gen[..., 0])], dim=-1)

    def tent(dist):
        """Product tent form function (ref::2198-2214)."""
        inside = torch.all(dist < ls, dim=-1)
        form = torch.prod((1.0 - dist / ls) / torch.sqrt(2.0 / 3.0 * ls),
                          dim=-1)
        return torch.where(inside, form, 0.0)

    def core(state, u_in, dt):
        """One per-step inlet update (ref::1351-1444 update_les_inlet)."""
        eddy_pos, sgn, draws = state
        # mean inlet state from the inviscid ghost (ref::1993-2027)
        u_r = bc_fns.ghost_state(u_in, norm, 0)
        rou = u_r[0].view(Fin, nfp)
        vel = torch.stack([u_r[1 + m].view(Fin, nfp) for m in range(d)],
                          dim=-1) / rou[..., None]

        if itype == 1:
            # white-noise inlet (ref::1460-1477)
            fl = draws.normal((Fin, nfp, d))
        else:
            # convection speed = area-averaged inlet velocity (ref::2059-2101)
            vel_c = torch.einsum("fq,fqk->k", wdA, vel) / total_area
            vel_c3 = torch.zeros(3, dtype=dtype, device=device)
            vel_c3[:d] = vel_c
            eddy_pos = eddy_pos + vel_c3 * dt             # ref::1677-1694
            # wrap + recycle (ref::1697-1757): wrapped coords keep their
            # wrapped value, the others re-randomize; signs re-randomize
            g = to_gen(eddy_pos)                          # (N, 3)
            below = g < box_min
            above = g > box_max
            wrapped = torch.where(below, g + box_dim,
                                  torch.where(above, g - box_dim, g))
            out = torch.any(below | above, dim=-1)        # (N,)
            rand_g = box_min + draws.uniform((n_eddy, 3)) * box_dim
            rand_sgn = torch.where(draws.uniform((n_eddy, 3)) < 0.5,
                                   -1.0, 1.0).to(dtype)
            g_new = torch.where(below | above, wrapped,
                                torch.where(out[:, None], rand_g, g))
            sgn = torch.where(out[:, None], rand_sgn, sgn)
            eddy_pos = from_gen(g_new)

            # tent-function fluctuations, theta-periodic images in 3-D;
            # nearest image chosen by distance MAGNITUDE like the reference
            # (ref::2134-2219 cal_fluc)
            imgs = [eddy_pos]
            if d == 3:
                gc = to_gen(eddy_pos)
                imgs += [from_gen(gc + s * theta_step) for s in (1.0, -1.0)]
            dists = torch.stack(
                [torch.abs(pos3[:, :, None, :] - img[None, None, :, :])
                 for img in imgs])                        # (I, Fin, nfp, N, 3)
            mags = torch.sum(dists * dists, dim=-1)       # (I, Fin, nfp, N)
            best = torch.argmin(mags, dim=0)
            dist = torch.take_along_dim(dists, best[None, ..., None],
                                        dim=0)[0]
            form = tent(dist[..., :d])                    # (Fin, nfp, N)
            fl = torch.einsum("fqn,nk->fqk", form, sgn[:, :d]) * alpha

        fl = fl / uvw_ref                                 # ref::1396-1401
        # diagonal Reynolds-stress rescale (ref::1861-1889, :2029-2057)
        if mode == 0:
            rii = torch.full_like(rou, 2.0 / 3.0 * turb_1)[..., None]
        else:
            ubar = torch.sqrt(torch.sum(vel * vel, dim=-1))
            rii = ((turb_1 * ubar) ** 2)[..., None]
        fl = fl * torch.sqrt(rii)
        # zero mean mass flux (ref::1891-1990 correct_mass)
        mf = torch.sum(wdA * fl[..., 0] * rou)
        fl = torch.cat([(fl[..., 0] - mf / (total_area * rou))[..., None],
                        fl[..., 1:]], dim=-1)
        fl = fl * mask[..., None]
        return (eddy_pos, sgn, draws), fl, rou

    return core


class TurbInlet:
    """The turbulent inlet of a solver (turb_inlet.py:46-53, :306-336 of
    the JAX package): ``update(state, uf2, dt)`` reads the inlet points
    from the flux-point rows ``uf2`` (F, S) and returns the new state and
    the fluctuations (d, *plane) on the boundary planes of the residual's
    face stage, zero away from the inlet."""

    def __init__(self, c, core, slots, dst, valid, plane_shape, n_plane,
                 device, dtype, draws):
        self.inlet_type, self.n_eddy, self.in_faces = c.itype, c.n_eddy, \
            c.in_faces
        self.c, self._core = c, core
        self._slots = torch.as_tensor(slots.reshape(-1), device=device)
        self._dst = torch.as_tensor(dst, device=device)
        self._valid = torch.as_tensor(valid, device=device)
        self._plane_shape, self._n_plane = tuple(plane_shape), n_plane
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        self.init_state = (f(c.eddy0), f(c.sgn0), draws)
        # the shapes of one step's draws, in the order they are taken
        self.draw_shapes = ([c.wdA.shape + (c.d,)] if c.itype == 1
                            else [(c.n_eddy, 3)] * 2)
        self.last = None

    def update(self, state, uf2, dt):
        F = uf2.shape[0]
        u_in = uf2.index_select(1, self._slots).view(F, 1, -1).unbind(0)
        state, fl, rou = self._core(state, u_in, dt)
        d = fl.shape[-1]
        self.last = (fl, rou)
        fluc = fl.new_zeros((d, self._n_plane))
        fluc.index_copy_(1, self._dst,
                         fl.reshape(-1, d).index_select(0, self._valid).T)
        return state, fluc.view(d, *self._plane_shape)

    def mass_flux(self):
        """(|sum wdA fl_0 rho|, sum wdA |fl_0| rho) of the last update, on
        the host: the mass flux the fluctuations carry through the inlet,
        and its scale."""
        fl, rou = self.last
        w = torch.as_tensor(self.c.wdA, dtype=fl.dtype, device=fl.device)
        return (float(torch.sum(w * fl[..., 0] * rou).abs()),
                float(torch.sum(w * fl[..., 0].abs() * rou)))


def build_turb_inlet(run_input, block, bc_fns_of, plane_index, plane_shape,
                     device, dtype, seed: int = 0, slots=None):
    """The inlet over the full inlet plane (turb_inlet.py:306-336 of the
    JAX package), or None without one.  ``block`` is an element block or a
    facade with the same tables (multiblock._TIFacade); ``bc_fns_of(bcid)``
    builds the boundary functions of plane columns with the groups
    ``bcid``; ``plane_index`` (Fb, nfp) gives each boundary face point's
    flat index in the residual's boundary planes, shaped ``plane_shape``
    (-1 at a padded point); ``slots`` (Fin, nfp) the columns of the rows
    that ``update`` reads holding the inlet points (default: their slots
    in ``block``).  It draws from a DeviceDraws seeded with ``seed``."""
    c = inlet_host_setup(run_input, block, seed)
    if c is None:
        return None
    nfp = c.slots.shape[1]
    bcid = np.repeat(block.bdy_bcid[c.in_faces], nfp)    # a column per point
    core = make_fluc_core(c, bc_fns_of(bcid), device, dtype)
    draws = DeviceDraws(c.seed, device, dtype)
    idx = plane_index[c.in_faces].reshape(-1)
    valid = np.nonzero(idx >= 0)[0]
    return TurbInlet(c, core, c.slots if slots is None else slots,
                     idx[valid], valid, plane_shape,
                     int(np.prod(plane_shape)), device, dtype, draws)

"""Plain PyTorch reference: flux reconstruction on a structured box of
axis-aligned hexahedra, written for the benchmark from the method's
definition, with no kernel, no table of faces and nothing of the program.

The scheme is the one a configuration states (HiFiLES's FR/VCJH on hexes):
Gauss-Legendre solution points, p + 1 a direction; the DG correction
functions (VCJH with eta = 0); the compressible Navier-Stokes equations
with a constant viscosity; HLLC with Roe-averaged wave speeds at the
faces; LDG for the viscous terms (common solution and flux one-sided by
``ldg_beta``, penalty ``ldg_tau``); Carpenter-Kennedy RK45 in 2N storage.
The channel adds adiabatic no-slip walls at the box's two y faces, the
Smagorinsky SGS model with its wall-distance limit, the bulk forcing of
the -x plane's mass flux and running averages of five fields.

Every element of the box is the same axis-aligned brick, so a derivative
along x is the 1-D operator along each element's x points, scaled by
2 / h_x, and a face couples an element with its neighbour along one axis.
The state is (F, Ez, Ey, Ex, kz, ky, kx): field, element indices, point
indices, x fastest.  ``tf32`` rounds both operands of every operator
product to TF32's 10-bit mantissa, as a tensor core does; it is the
lower-precision control's arithmetic.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.polynomial import legendre as leg

# Carpenter & Kennedy (1994), RK45 in 2N storage, solution 3
RK45_A = (0.0, -567301805773.0 / 1357537059087.0,
          -2404267990393.0 / 2016746695238.0,
          -3550918686646.0 / 2091501179385.0,
          -1275806237668.0 / 842570457699.0)
RK45_B = (1432997174477.0 / 9575080441755.0,
          5161836677717.0 / 13612068292357.0,
          1720146321549.0 / 2090206949498.0,
          3134564353537.0 / 4481467310338.0,
          2277821191437.0 / 14882151754819.0)

# direction d -> its element axis and its point axis in a state (F, Ez,
# Ey, Ex, kz, ky, kx); a face array drops the point axis, a plane the F
ELEM = {0: 3, 1: 2, 2: 1}
PT = {0: 6, 1: 5, 2: 4}


def to_tf32(x):
    """f32 values rounded to the nearest TF32 value (10 mantissa bits)."""
    i = x.contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def lagrange(x, nodes):
    """(len(x), n): the Lagrange basis of ``nodes`` at ``x``."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    out = np.ones((x.size, nodes.size))
    for j, xj in enumerate(nodes):
        for m, xm in enumerate(nodes):
            if m != j:
                out[:, j] *= (x - xm) / (xj - xm)
    return out


def dlagrange(x, nodes):
    """(len(x), n): the basis's derivatives at ``x``."""
    x = np.atleast_1d(np.asarray(x, dtype=np.float64))
    n = nodes.size
    out = np.zeros((x.size, n))
    for j in range(n):
        for k in range(n):
            if k == j:
                continue
            term = np.full(x.size, 1.0 / (nodes[j] - nodes[k]))
            for m in range(n):
                if m not in (j, k):
                    term *= (x - nodes[m]) / (nodes[j] - nodes[m])
            out[:, j] += term
    return out


def dg_correction(x, order):
    """(g_L'(x), g_R'(x)): the DG correction functions' derivatives, the
    right Radau polynomial (P_p + P_{p+1}) / 2 and its mirror."""
    dP = lambda k: leg.Legendre.basis(k).deriv()(x)
    right = 0.5 * (dP(order) + dP(order + 1))
    left = 0.5 * (-1.0) ** order * (dP(order) - dP(order + 1))
    return left, right


def kinetic_energy(u, h, tf32=False):
    """The monitor's kinetic energy of the state ``u`` (a tensor (5, Ez,
    Ey, Ex, kz, ky, kx), in its own precision): rho |v|^2 / 2 integrated
    over a box of hexes of sides ``h`` by the solution points' Gauss
    quadrature, a product of the weights and the integrand (both rounded
    to TF32 for the control)."""
    w1 = leg.leggauss(u.shape[-1])[1]
    w = torch.as_tensor(np.einsum("i,j,k->ijk", w1, w1, w1)
                        * np.prod(h) / 8.0, dtype=u.dtype, device=u.device)
    q = 0.5 * (u[1] * u[1] + u[2] * u[2] + u[3] * u[3]) / u[0]
    if tf32:
        q, w = to_tf32(q), to_tf32(w)
    return float((q * w).sum())


class Box:
    """A box of nx x ny x nz equal hexes from ``lo`` to ``hi``, periodic
    along every axis but y when ``walls`` (then no-slip at both y faces)."""

    def __init__(self, n, lo, hi, walls):
        self.n, self.lo, self.hi = tuple(n), np.asarray(lo, float), \
            np.asarray(hi, float)
        self.h = (self.hi - self.lo) / np.asarray(self.n)
        self.walls = bool(walls)

    def coords(self, d, xi):
        """(n_d, len(xi)): coordinate d of the points ``xi`` of every
        element along axis d."""
        edges = np.linspace(self.lo[d], self.hi[d], self.n[d] + 1)
        return (edges[:-1, None]
                + 0.5 * (np.asarray(xi)[None, :] + 1.0) * self.h[d])


class FRHex:
    """The scheme on ``box`` with the dimensionless parameters ``phys``
    (reference.deck.physics), in ``dtype`` on ``device``."""

    def __init__(self, box: Box, phys: dict, device, dtype=torch.float64,
                 tf32=False):
        self.box, self.ph = box, phys
        self.tf32 = tf32
        p = phys["order"]
        self.nodes, weights = leg.leggauss(p + 1)
        t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        self.D = t(dlagrange(self.nodes, self.nodes))
        self.eL = t(lagrange(-1.0, self.nodes)[0])
        self.eR = t(lagrange(1.0, self.nodes)[0])
        gl, gr = dg_correction(self.nodes, p)
        self.gL, self.gR = t(gl), t(gr)
        self.scale = [2.0 / box.h[d] for d in range(3)]
        # the -x plane's quadrature weights (kz, ky) times its area factor
        self.w_plane = t(np.outer(weights, weights) * box.h[1] * box.h[2]
                         / 4.0)
        if phys["les"]:
            # Deardorff's cutoff length times the filter ratio; the wall
            # distance of every solution point and face point
            self.delta = (phys["filter_ratio"] * np.prod(box.h) ** (1 / 3)
                          / (p + 1))
            self.wd_u = t(self._wall_distance(None))
            self.wd_f = {d: t(self._wall_distance(d)) for d in range(3)}

    # -- operators -----------------------------------------------------
    def _mm(self, a, b):
        """a @ b, both operands rounded to TF32 for the control."""
        if self.tf32:
            a, b = to_tf32(a), to_tf32(b)
        return a @ b

    def along(self, M, x, d):
        """The matrix M (n, n) applied along direction d's point axis of a
        state-shaped x."""
        y = self._mm(x.movedim(PT[d], -1), M.T)
        return y.movedim(-1, PT[d])

    def face(self, x, d, side):
        """A state-shaped x at the faces of every element normal to d: the
        point axis of d contracted with the left (side 0) or right (1)
        extrapolation."""
        e = self.eL if side == 0 else self.eR
        return self._mm(x.movedim(PT[d], -1), e[:, None])[..., 0]

    def lift(self, jump, d, side):
        """A face array spread over the element by the correction
        function's derivative along d."""
        g = self.gL if side == 0 else self.gR
        return self._mm(jump.unsqueeze(-1), g[None, :]).movedim(-1, PT[d])

    @staticmethod
    def neighbours(right_face, left_face, d):
        """(minus, plus) side values at each element's right face normal to
        d: its own right value and its +d neighbour's left value."""
        return right_face, torch.roll(left_face, -1, dims=ELEM[d])

    def _wall_distance(self, d):
        """Nearest distance to the wall faces' flux points, whose x and z
        are the solution points' and y the box's two y ends: at the
        solution points (d None), (Ez, Ey, Ex, kz, ky, kx), or at the
        points of the faces normal to d, whose point axis of d holds the
        (left, right) ends."""
        b = self.box
        r2 = []
        for k in range(3):
            pts = b.coords(k, self.nodes if k != d else [-1.0, 1.0])
            if k == 1:
                r2.append(np.minimum((pts - b.lo[1]) ** 2,
                                     (pts - b.hi[1]) ** 2))
            else:
                wall = b.coords(k, self.nodes).ravel()
                r2.append(np.abs(pts[..., None] - wall).min(axis=-1) ** 2)
        return np.sqrt(r2[2][:, None, None, :, None, None]
                       + r2[1][None, :, None, None, :, None]
                       + r2[0][None, None, :, None, None, :])

    # -- physics on lists of field planes --------------------------------
    def prims(self, u):
        rho = u[0]
        v = [u[1 + m] / rho for m in range(3)]
        q2 = v[0] * v[0] + v[1] * v[1] + v[2] * v[2]
        p = (self.ph["gamma"] - 1.0) * (u[4] - 0.5 * rho * q2)
        return rho, v, q2, p

    def inviscid(self, u, d):
        """The inviscid flux along d."""
        rho, v, _, p = self.prims(u)
        return [u[1 + d]] + [u[1 + i] * v[d] + (p if i == d else 0.0)
                             for i in range(3)] + [(u[4] + p) * v[d]]

    def viscous(self, u, g, dirs, wd=None):
        """The viscous flux along each direction of ``dirs`` from the state
        planes ``u`` and the gradient planes g[l][f], signed as part of the
        total flux (inviscid + this), plus the Smagorinsky flux where LES
        and ``wd`` (the wall distance) is given: {d: [F planes]}."""
        ph = self.ph
        mu, gam = ph["mu"], ph["gamma"]
        rho, v, q2, _ = self.prims(u)
        inte = u[4] / rho - 0.5 * q2
        dv = [[(g[l][1 + i] - v[i] * g[l][0]) / rho for l in range(3)]
              for i in range(3)]
        de = [(g[l][4] - (0.5 * q2 + inte) * g[l][0]) / rho
              - sum(v[i] * dv[i][l] for i in range(3)) for l in range(3)]
        div = dv[0][0] + dv[1][1] + dv[2][2]
        sgs = wd is not None
        if sgs:
            S = [[0.5 * (dv[i][l] + dv[l][i]) for l in range(3)]
                 for i in range(3)]
            Smod = torch.sqrt(2.0 * sum(S[i][l] * S[i][l] for i in range(3)
                                        for l in range(3)))
            lim = torch.clamp(wd * wd * ph["kappa"] ** 2,
                              max=(ph["C_s"] * self.delta) ** 2)
            mu_t = rho * lim * Smod
            tr = (S[0][0] + S[1][1] + S[2][2]) / 3.0
        out = {}
        for d in dirs:
            tau = [mu * (dv[i][d] + dv[d][i])
                   - (2.0 / 3.0 * mu * div if i == d else 0.0)
                   for i in range(3)]
            f = [torch.zeros_like(rho)] + [-x for x in tau] + [
                -(sum(v[i] * tau[i] for i in range(3))
                  + mu * gam / ph["prandtl"] * de[d])]
            if sgs:
                mom = [-2.0 * mu_t * (S[i][d] - (tr if i == d else 0.0))
                       for i in range(3)]
                f[1:4] = [a + b for a, b in zip(f[1:4], mom)]
                f[4] = f[4] + (-gam * mu_t / ph["prandtl_t"] * de[d]
                               + sum(v[k] * mom[k] for k in range(3)))
            out[d] = f
        return out

    def hllc(self, ul, ur, d, sign=1.0):
        """The HLLC flux through a face of normal sign * e_d, with
        Roe-averaged wave speeds (Toro's star states)."""
        gam = self.ph["gamma"]
        n = [sign if m == d else 0.0 for m in range(3)]

        def side(u):
            rho, v, _, p = self.prims(u)
            vn = v[d] * sign
            fn = ([rho * vn] + [u[1 + m] * vn + p * n[m] for m in range(3)]
                  + [(u[4] + p) * vn])
            return rho, vn, p, fn
        rl, vl, pl, fl = side(ul)
        rr, vr, pr, fr = side(ur)
        hl, hr = (ul[4] + pl) / rl, (ur[4] + pr) / rr
        sq = torch.sqrt(rr / rl)
        w = 1.0 / (sq + 1.0)
        vm = w * (vl + sq * vr)
        hm = w * (hl + sq * hr)
        am = torch.sqrt((gam - 1.0) * (hm - 0.5 * vm * vm))
        SL, SR = vm - am, vm + am
        Ss = ((pr - pl + rl * vl * (SL - vl) - rr * vr * (SR - vr))
              / (rl * (SL - vl) - rr * (SR - vr)))

        def star(S, u, fn, rho, vn, p):
            k = 1.0 / (S - Ss)
            pre = p + rho * (S - vn) * (Ss - vn)
            return ([Ss * (S * u[0] - fn[0]) * k]
                    + [(Ss * (S * u[1 + m] - fn[1 + m]) + S * pre * n[m]) * k
                       for m in range(3)]
                    + [(Ss * (S * u[4] - fn[4]) + S * pre * Ss) * k])
        fsl = star(SL, ul, fl, rl, vl, pl)
        fsr = star(SR, ur, fr, rr, vr, pr)
        return [torch.where(SL >= 0, a, torch.where(Ss >= 0, b,
                            torch.where(SR >= 0, c, e)))
                for a, b, c, e in zip(fl, fsl, fsr, fr)]

    def wall_states(self, ub):
        """At a wall face, from the element's own face state ``ub``: the
        inviscid ghost state (the velocity mirrored) and the LDG common
        solution (the wall at rest, the element's density and
        pressure)."""
        rho, v, q2, p = self.prims(ub)
        gam = self.ph["gamma"]
        zero = torch.zeros_like(rho)
        ghost = ([rho] + [-rho * x for x in v]
                 + [p / (gam - 1.0) + 0.5 * rho * q2])
        return ghost, [rho, zero, zero, zero, p / (gam - 1.0)]

    def wall_flux(self, ub, ghost, common, g, d, sign):
        """The total flux along +e_d at a wall face of outward normal
        sign * e_d: HLLC against the ghost state, plus the viscous flux of
        the common solution whose gradient g[l][f] (the element's) loses
        its wall-normal internal-energy part (adiabatic), minus the LDG
        penalty against the element's state."""
        fn = self.hllc(ub, ghost, d, sign)
        rho, mom = common[0], common[1:4]
        vsq = sum(m * m for m in mom)
        inte = (common[4] - 0.5 * vsq / rho) / rho
        grho = [g[j][0] for j in range(3)]
        gvel = [[(g[j][1 + i] - grho[j] * (mom[i] / rho)) / rho
                 for j in range(3)] for i in range(3)]
        gE = [g[j][4] for j in range(3)]
        ginte = [gE[j] - (inte * grho[j] + 0.5 * (vsq / rho ** 2) * grho[j]
                          + sum(mom[i] * gvel[i][j] for i in range(3)))
                 for j in range(3)]
        gn = ginte[d] * sign
        g = [g[j][:4] + [gE[j] - (gn * sign if j == d else 0.0)]
             for j in range(3)]
        fv = self.viscous(common, g, (d,))[d]
        tau = self.ph["ldg_tau"]
        # the outward normal flux, and the flux along +e_d
        return torch.stack([sign * (a + sign * b - tau * (c - e))
                            for a, b, c, e in zip(fn, fv, common, ub)])

    # -- the residual ----------------------------------------------------
    def residual(self, u):
        """du/dt of the state (F, Ez, Ey, Ex, kz, ky, kx), without the
        body force."""
        ph = self.ph
        beta, tau = ph["ldg_beta"], ph["ldg_tau"]
        walled = lambda d: self.box.walls and d == 1
        uL = [self.face(u, d, 0) for d in range(3)]
        uR = [self.face(u, d, 1) for d in range(3)]
        wall = {}
        if self.box.walls:
            ax = ELEM[1]
            for key, x, sign in (("top", uR[1].select(ax, -1), 1.0),
                                 ("bot", uL[1].select(ax, 0), -1.0)):
                ub = list(x.unbind(0))
                ghost, common = self.wall_states(ub)
                wall[key] = (ub, ghost, common, sign)
        # 1. the LDG common solution and the corrected gradient
        grad = []
        for d in range(3):
            um, up = self.neighbours(uR[d], uL[d], d)
            uc = 0.5 * (um + up) - beta * (um - up)
            ucR, ucL = uc, torch.roll(uc, 1, dims=ELEM[d])
            if walled(d):
                ucR, ucL = ucR.clone(), ucL.clone()
                ucR.select(ELEM[d], -1).copy_(torch.stack(wall["top"][2]))
                ucL.select(ELEM[d], 0).copy_(torch.stack(wall["bot"][2]))
            tg = (self.along(self.D, u, d) + self.lift(ucL - uL[d], d, 0)
                  + self.lift(ucR - uR[d], d, 1))
            grad.append(tg * self.scale[d])
        up_ = list(u.unbind(0))
        gp = [list(g.unbind(0)) for g in grad]
        # 2. the viscous flux at the solution points, every direction
        fvs = self.viscous(up_, gp, range(3),
                           self.wd_u if ph["les"] else None)
        del gp
        rhs = torch.zeros_like(u)
        for d in range(3):
            fx = torch.stack([a + b for a, b in zip(self.inviscid(up_, d),
                                                    fvs.pop(d))])
            # 3. the common flux at the faces normal to d
            gL = [list(self.face(g, d, 0).unbind(0)) for g in grad]
            gR = [list(self.face(g, d, 1).unbind(0)) for g in grad]
            wdL = wdR = None
            if ph["les"]:
                wdL = self.wd_f[d].select(PT[d] - 1, 0)
                wdR = self.wd_f[d].select(PT[d] - 1, 1)
            fvL = torch.stack(self.viscous(list(uL[d].unbind(0)), gL, (d,),
                                           wdL)[d])
            fvR = torch.stack(self.viscous(list(uR[d].unbind(0)), gR, (d,),
                                           wdR)[d])
            um, upl = self.neighbours(uR[d], uL[d], d)
            vm, vp = self.neighbours(fvR, fvL, d)
            fc = (torch.stack(self.hllc(list(um.unbind(0)),
                                        list(upl.unbind(0)), d))
                  + (0.5 + beta) * vm + (0.5 - beta) * vp
                  + tau * (um - upl))
            fcR, fcL = fc, torch.roll(fc, 1, dims=ELEM[d])
            if walled(d):
                ax = ELEM[d] - 1
                fcR, fcL = fcR.clone(), fcL.clone()
                for key, out, g, idx in (("top", fcR, gR, -1),
                                         ("bot", fcL, gL, 0)):
                    ub, ghost, common, sign = wall[key]
                    gw = [[x.select(ax, idx) for x in row] for row in g]
                    out.select(ELEM[d], idx).copy_(
                        self.wall_flux(ub, ghost, common, gw, d, sign))
            # 4. the FR divergence along d
            div = (self.along(self.D, fx, d)
                   + self.lift(fcL - self.face(fx, d, 0), d, 0)
                   + self.lift(fcR - self.face(fx, d, 1), d, 1))
            rhs -= self.scale[d] * div
        return rhs

    # -- the run ---------------------------------------------------------
    def mass_flux(self, u):
        """(density, x-momentum) integrated over the -x plane x = lo, the
        inflow plane of the bulk forcing, from the first elements' faces."""
        planes = self.face(u[:2], 0, 0).select(ELEM[0], 0)  # (2,Ez,Ey,kz,ky)
        return (planes * self.w_plane[None, None, None]).sum(dim=(1, 2, 3, 4))

    def initial(self, u):
        """The run's carry at the state u: the RK register, the clock of
        the averages, the averages and the forcing's mass-flux memory."""
        ph = self.ph
        return dict(u=u.clone(), reg=torch.zeros_like(u), t=0.0,
                    avg=(torch.zeros((len(ph["average_fields"]),)
                                     + u.shape[1:], dtype=u.dtype,
                                     device=u.device)
                         if ph["average_fields"] else None),
                    mdot=ph["bf_mdot0"])

    def step(self, run):
        """One time step of ``run`` (initial()), in place."""
        ph = self.ph
        dt, u, reg = ph["dt"], run["u"], run["reg"]
        force = None
        if ph["forcing"]:
            rho_int, mflux = self.mass_flux(u).tolist()
            if ph["bf_type"] == 1:
                bf = (ph["bf_mdot0"] - mflux) / (ph["bf_area"] * dt)
            else:
                bf = ((ph["bf_mdot0"] - 2.0 * mflux + run["mdot"])
                      / (ph["bf_area"] * dt))
            run["mdot"] = mflux
            force = (bf, bf * (mflux / rho_int if rho_int else 0.0))
        for a, b in zip(RK45_A, RK45_B):
            k = self.residual(u)
            if force is not None:
                k[1] += force[0]
                k[4] += force[1]
            reg = a * reg + dt * k
            u = u + b * reg
        run["u"], run["reg"] = u, reg
        run["t"] += dt
        if run["avg"] is not None:
            t_rel = run["t"] - ph["spinup"]
            cur = torch.stack([{"rho_average": u[0],
                                "u_average": u[1] / u[0],
                                "v_average": u[2] / u[0],
                                "w_average": u[3] / u[0],
                                "e_average": u[4] / u[0]}[f]
                               for f in ph["average_fields"]])
            if t_rel <= dt:
                run["avg"] = cur
            else:
                run["avg"] = ((t_rel - dt) / t_rel * run["avg"]
                              + dt / t_rel * cur)
        return run

    def residual_row(self, u):
        """The monitor's L1 residual row: the mean |du/dt| of each field
        over every solution point, without the body force."""
        r = self.residual(u)
        return (r.abs().sum(dim=tuple(range(1, 7))) / r[0].numel()).tolist()

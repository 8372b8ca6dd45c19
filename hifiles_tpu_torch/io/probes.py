"""Probe subsystem (ref:src/probe_input.cpp): point-set generators
(line / circle / cone / cube / explicit), owning-cell location (calc_p2c
analogs, ref per-type calc_p2c e.g. ref:src/eles_quads.cpp:1303-1396),
solution sampling (opp_probe, ref:src/eles.cpp:3625-3633), and HDF5 probe
files with an unlimited time axis (ref:src/output.cpp:1549-1752).

Copied from hifiles_tpu/io/probes.py (lines 1-453) unchanged but for this
paragraph.  The branches for element-sharded solvers read the port's
parallel.ShardedSolver (its single-device twin ``base``, ``owner`` and
``pad_mask`` (n, El), and ``u``, the state padded to (n, El, U, F) on the
host: a sample reads only the probes' elements) and ShardedMixedSolver
(``base`` and the per-type ``gather_u``).
"""

from __future__ import annotations

import os

import numpy as np

from ..mesh.shape import shape_basis, shape_dbasis


def probe_line(p0, p1, n: int) -> np.ndarray:
    """(ref:src/probe_input.cpp:743-797 set_probe_line)."""
    t = np.linspace(0.0, 1.0, n)[:, None]
    return np.asarray(p0)[None, :] * (1 - t) + np.asarray(p1)[None, :] * t


def probe_circle(center, radius, n: int, normal=(0, 0, 1)) -> np.ndarray:
    """Points on a circle (ref:src/probe_input.cpp:798-933)."""
    center = np.asarray(center, dtype=np.float64)
    d = center.size
    theta = np.linspace(0, 2 * np.pi, n, endpoint=False)
    if d == 2:
        return center + radius * np.stack([np.cos(theta), np.sin(theta)],
                                          axis=1)
    nrm = np.asarray(normal, dtype=np.float64)
    nrm /= np.linalg.norm(nrm)
    a = np.array([1.0, 0.0, 0.0])
    if abs(nrm @ a) > 0.9:
        a = np.array([0.0, 1.0, 0.0])
    t1 = np.cross(nrm, a)
    t1 /= np.linalg.norm(t1)
    t2 = np.cross(nrm, t1)
    return (center[None] + radius * (np.cos(theta)[:, None] * t1[None]
                                     + np.sin(theta)[:, None] * t2[None]))


def probe_cone(p0, p1, r0: float, r1: float, n_layers: int,
               n_per_layer: int) -> np.ndarray:
    """Rings along the axis p0->p1 with linearly varying radius
    (ref:src/probe_input.cpp:934-1063)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    axis = p1 - p0
    out = []
    for i in range(n_layers):
        t = i / max(n_layers - 1, 1)
        out.append(probe_circle(p0 + t * axis, r0 + t * (r1 - r0),
                                n_per_layer, normal=axis))
    return np.concatenate(out)


def probe_cube(origin, lengths, n_per_dim) -> np.ndarray:
    """Regular lattice in a box (ref:src/probe_input.cpp:1064-1079)."""
    origin = np.asarray(origin, dtype=np.float64)
    lengths = np.asarray(lengths, dtype=np.float64)
    axes = [np.linspace(0, L, n) for L, n in zip(lengths, n_per_dim)]
    grids = np.meshgrid(*axes, indexing="ij")
    return origin + np.stack([g.ravel() for g in grids], axis=1)


def _inside_ref(ct, r, tol_r: float = 1e-6):
    """Is reference coordinate r inside element type ct's domain?"""
    if ct in (1, 4):     # quad / hex
        return np.all(np.abs(r) <= 1 + tol_r)
    if ct == 0:          # tri: r,s >= -1, r+s <= 0
        return (r >= -1 - tol_r).all() and r.sum() <= tol_r
    if ct == 2:          # tet: r,s,t >= -1, r+s+t <= -1
        return (r >= -1 - tol_r).all() and r.sum() <= -1 + tol_r
    if ct == 3:          # prism: tri in (r,s), |z| <= 1
        return ((r[:2] >= -1 - tol_r).all()
                and r[0] + r[1] <= tol_r and abs(r[2]) <= 1 + tol_r)
    raise NotImplementedError


def locate_points(mesh, pts: np.ndarray, tol: float = 1e-8):
    """Find the owning element and reference coordinates of each point by
    Newton-inverting the shape mapping over bounding-box candidates,
    per element type — mixed meshes run one pass per type with that
    type's shape basis, like the reference's per-type calc_p2c
    (ref:src/probe_input.cpp:1190-1204 set_loc_probepts).

    Returns (ele (n,), ref (n, d)); ele = -1 when a point is outside the
    local mesh; ele indexes the mesh's GLOBAL cell numbering."""
    from ..solver.elements import mesh_shape_points
    d = mesh.n_dims
    ele_out = -np.ones(pts.shape[0], dtype=np.int64)
    ref_out = np.zeros((pts.shape[0], d))
    ctype = np.asarray(mesh.ctype)
    for ct in sorted(int(c) for c in np.unique(ctype)):
        sel = np.flatnonzero(ctype == ct)
        spts, n_spts = mesh_shape_points(mesh, sel)  # (E_ct, n_spts, d)
        lo = spts.min(axis=1) - tol
        hi = spts.max(axis=1) + tol
        for ip, x in enumerate(pts):
            if ele_out[ip] >= 0:
                continue
            cands = np.where(np.all((x >= lo) & (x <= hi), axis=1))[0]
            for e in cands:
                r = np.zeros(d) if ct != 0 else np.full(d, -1.0 / 3.0)
                ok = False
                for _ in range(30):
                    sb = shape_basis(ct, r[None], n_spts)[0]
                    pos = sb @ spts[e]
                    res = pos - x
                    if np.abs(res).max() < tol:
                        ok = True
                        break
                    J = np.einsum("sj,si->ij",
                                  shape_dbasis(ct, r[None], n_spts)[0],
                                  spts[e])
                    r = r - np.linalg.solve(J, res)
                    r = np.clip(r, -1.5, 1.5)
                if ok and _inside_ref(ct, r):
                    ele_out[ip] = sel[e]
                    ref_out[ip] = r
                    break
    return ele_out, ref_out


class ProbeSet:
    """A located probe set with its sampling operator."""

    def __init__(self, solver, pts: np.ndarray, fields: list[str]):
        self.pts = np.asarray(pts, dtype=np.float64)
        self.fields = fields
        # a ShardedSolver carries its single-device setup as .base (its own
        # .mesh is the device Mesh) and exposes the global-order solution
        # via gather_u() (ref:src/output.cpp:1549-1752 probes are written
        # by global probe index across ranks)
        host = getattr(solver, "base", solver)
        self.ele, ref = locate_points(host.mesh, self.pts)
        self.owned = np.where(self.ele >= 0)[0]
        self.solver = solver
        # mixed-type solvers (MixedSolver / ShardedMixedSolver) carry a
        # per-type blocks dict; group the owned probes by owning element
        # type and build one interpolation operator per type, like the
        # reference's per-type set_opp_probe
        # (ref:src/probe_input.cpp:1190-1204, ref:src/eles.cpp:3625-3633)
        blocks = getattr(host, "blocks", None)
        self._per_ct = None
        self.opp = None
        if isinstance(blocks, dict):
            sels = host.mt.sels if hasattr(host, "mt") else host.sels
            mesh = host.mesh
            loc_of = np.zeros(mesh.n_cells, dtype=np.int64)
            for ct in host.cts:
                loc_of[sels[ct]] = np.arange(sels[ct].size)
            ctype = np.asarray(mesh.ctype)
            self._per_ct = []
            for ti, ct in enumerate(host.cts):
                rows = np.flatnonzero(ctype[self.ele[self.owned]] == ct)
                if rows.size == 0:
                    continue
                eles = loc_of[self.ele[self.owned[rows]]]
                opp = blocks[ct].ops.interp_to(ref[self.owned[rows]])
                self._per_ct.append((ti, rows, eles, opp))
        else:
            # opp_probe: one interpolation row per owned probe
            self.opp = host.ops.interp_to(ref[self.owned]) \
                if self.owned.size else np.zeros((0, host.ops.n_upts))
        # ShardedSolver: precompute owner slots of the probe elements so
        # each sample pulls ONLY those elements off the device mesh
        # instead of gathering the full global state per probe write
        self._owner_slots = None
        if (self._per_ct is None and hasattr(solver, "owner")
                and self.owned.size):
            flat = np.asarray(solver.owner).reshape(-1)
            real = np.asarray(solver.pad_mask).reshape(-1) > 0
            pos = np.full(solver.n_eles, -1, dtype=np.int64)
            pos[flat[real]] = np.flatnonzero(real)
            self._owner_slots = pos[self.ele[self.owned]]

    def sample(self) -> np.ndarray:
        """(n_owned, n_out_fields) current probe values."""
        s = getattr(self.solver, "base", self.solver)
        if self._per_ct is not None:
            u = (self.solver.gather_u() if hasattr(self.solver, "gather_u")
                 else self.solver.u)
            nf = s.n_fields
            vals = np.zeros((self.owned.size, nf))
            for ti, rows, eles, opp in self._per_ct:
                ub = np.asarray(u[ti], dtype=np.float64)
                vals[rows] = np.einsum("pu,puf->pf", opp, ub[eles])
        elif self._owner_slots is not None:
            u_dev = self.solver.u           # (n, El, U, F) sharded
            n, El = u_dev.shape[:2]
            sel = u_dev.reshape(n * El, *u_dev.shape[2:])[self._owner_slots]
            vals = np.einsum("pu,puf->pf", self.opp,
                             np.asarray(sel, dtype=np.float64))
        else:
            u = (self.solver.gather_u().astype(np.float64)
                 if hasattr(self.solver, "gather_u")
                 else np.asarray(self.solver.u, dtype=np.float64))
            vals = np.einsum("pu,puf->pf", self.opp,
                             u[self.ele[self.owned]])
        nd = s.n_dims
        out = []
        for name in self.fields:
            if name == "rho":
                out.append(vals[:, 0])
            elif name in ("u", "v", "w"):
                ax = {"u": 0, "v": 1, "w": 2}[name]
                out.append(vals[:, 1 + ax] / vals[:, 0])
            elif name == "energy":
                out.append(vals[:, nd + 1])
            elif name == "specific_total_energy":
                # ref:src/output.cpp:1516-1521 disu(n_dims+1)/disu(0)
                out.append(vals[:, nd + 1] / vals[:, 0])
            elif name == "pressure":
                ke = 0.5 * np.sum(vals[:, 1:1 + nd] ** 2, axis=1) / vals[:, 0]
                out.append((s.p.gamma - 1.0) * (vals[:, nd + 1] - ke))
            else:
                raise ValueError(f"unknown probe field '{name}'")
        return np.stack(out, axis=1)


class ProbeHDF5Writer:
    """HDF5 probe file with unlimited, chunk-appended time axis
    (ref:src/output.cpp:1549-1752, ref:src/probe_input.cpp:68-180)."""

    def __init__(self, path: str, probe_set: ProbeSet):
        import h5py
        self.path = path
        self.ps = probe_set
        n = probe_set.owned.size
        nf = len(probe_set.fields)
        with h5py.File(path, "w") as f:
            f.create_dataset("coords", data=probe_set.pts[probe_set.owned])
            f.attrs["fields"] = np.array(probe_set.fields, dtype="S16")
            f.create_dataset("time", (0,), maxshape=(None,), dtype="f8",
                             chunks=(16,))
            f.create_dataset("data", (0, n, nf), maxshape=(None, n, nf),
                             dtype="f8", chunks=(16, max(n, 1), nf))

    def append(self, time: float):
        import h5py
        vals = self.ps.sample()
        with h5py.File(self.path, "a") as f:
            nt = f["time"].shape[0]
            f["time"].resize((nt + 1,))
            f["time"][nt] = time
            f["data"].resize((nt + 1,) + f["data"].shape[1:])
            f["data"][nt] = vals


class ProbeASCIIWriter:
    """Per-point ASCII probe files, the reference's non-HDF5 probe output
    mode (ref:src/output.cpp:1403-1548 write_probe_ascii): one
    ``<set_dir>/probe_<k>.dat`` per owned probe point, each append adding
    one row of ``time field0 field1 ...`` in %20.10e columns.  Viscous NS
    rows are re-dimensionalized with the deck's reference scales exactly
    as the reference does (time*time_ref, rho*rho_ref, u*uvw_ref,
    p*p_ref, e*uvw_ref^2)."""

    def __init__(self, path: str, probe_set: ProbeSet):
        self.dir = path
        self.ps = probe_set
        os.makedirs(path, exist_ok=True)
        s = getattr(probe_set.solver, "base", probe_set.solver)
        p = s.p
        self._redim = bool(p.viscous) and p.equation == 0
        self._tref = p.time_ref if self._redim else 1.0
        scale = {"rho": p.rho_ref, "u": p.uvw_ref, "v": p.uvw_ref,
                 "w": p.uvw_ref, "pressure": p.p_ref,
                 "specific_total_energy": p.uvw_ref ** 2,
                 "energy": p.p_ref}
        self._scales = np.array(
            [scale.get(f, 1.0) if self._redim else 1.0
             for f in probe_set.fields])
        # truncate (mode w) at setup like the reference's fresh run
        for k in range(probe_set.owned.size):
            open(os.path.join(path, f"probe_{k}.dat"), "w").close()

    def append(self, time: float):
        vals = self.ps.sample() * self._scales[None, :]
        t = time * self._tref
        for k in range(vals.shape[0]):
            with open(os.path.join(self.dir, f"probe_{k}.dat"), "a") as f:
                f.write("".join(f"{v:20.10e}"
                                for v in (t, *vals[k])) + "\n")


# ----------------------------------------------------------------------
# probe script (ref:src/probe_input.cpp:278-741 read_probe_script):
#   volume NAME { cube ( ox oy oz  nx ny nz  dx dy dz ) ... }
#   surface NAME { circle ( cx cy cz  ox oy oz  r n_layer )
#                  cone ( cx cy cz  ox oy oz  r0 r1 n_r  len n_l ) }
#   line NAME ( x0 y0 z0  x1 y1 z1  init_incre n_pts )
#   point ( x y z )

def probe_line_growth(p0, p1, init_incre: float, n_pts: int) -> np.ndarray:
    """Line probes with geometric spacing; the growth rate solves
    L = h (g^(n-1) - 1)/(g - 1) by Newton iteration
    (ref:src/probe_input.cpp:743-796 set_probe_line)."""
    p0 = np.asarray(p0, dtype=np.float64)
    p1 = np.asarray(p1, dtype=np.float64)
    L = float(np.linalg.norm(p1 - p0))
    n = n_pts
    if abs(L / init_incre - (n - 1)) < 1e-12:
        s = np.linspace(0.0, 1.0, n)
    else:
        g = 0.1 if L / init_incre < n - 1 else 5.0
        for _ in range(200):
            fx = L - init_incre * (g ** (n - 1) - 1.0) / (g - 1.0)
            jac = init_incre * ((n - 2.0) * g ** n - (n - 1.0) * g ** (n - 1)
                                + g) / ((g - 1.0) ** 2 * g)
            dg = fx / jac
            g += dg
            if abs(dg) <= 1e-10:
                break
        s = init_incre * (g ** np.arange(n, dtype=np.float64) - 1.0) \
            / (g - 1.0) / L
    return p0[None, :] + s[:, None] * (p1 - p0)[None, :]


def read_probe_script(path: str, n_dims: int):
    """Parse the reference's probe script into [(name, points)] sets."""
    import re
    toks = re.findall(r"[{}()]|[^\s{}()]+", open(path).read())
    i = 0
    out = []

    def num():
        nonlocal i
        v = float(toks[i])
        i += 1
        return v

    def expect(t):
        nonlocal i
        if toks[i] != t:
            raise ValueError(f"probe script syntax: expected {t!r}, "
                             f"got {toks[i]!r}")
        i += 1

    n_point = 0
    while i < len(toks):
        kwd = toks[i]
        i += 1
        if kwd == "volume":
            name = toks[i]
            i += 1
            expect("{")
            pts = []
            while toks[i] != "}":
                sub = toks[i]
                i += 1
                expect("(")
                if sub == "cube":
                    org = np.array([num() for _ in range(3)])
                    nxyz = np.array([int(num()) for _ in range(3)])
                    dxyz = np.array([num() for _ in range(3)])
                    grid = np.stack(np.meshgrid(
                        *[org[k] + dxyz[k] * np.arange(max(nxyz[k], 1))
                          for k in range(3)], indexing="ij"),
                        axis=-1).reshape(-1, 3)
                    pts.append(grid[:, :n_dims])
                else:
                    raise ValueError(f"volume sub-shape {sub!r}")
                expect(")")
            i += 1      # '}'
            out.append((name, np.concatenate(pts)))
        elif kwd == "surface":
            name = toks[i]
            i += 1
            expect("{")
            pts = []
            while toks[i] != "}":
                sub = toks[i]
                i += 1
                expect("(")
                cent = np.array([num() for _ in range(3)])
                ori = np.array([num() for _ in range(3)])
                if sub == "circle":
                    r = num()
                    n_layer = int(num())
                    pts.append(probe_circle(cent[:n_dims], r,
                                            4 * n_layer, normal=ori))
                elif sub == "cone":
                    r0, r1 = num(), num()
                    n_r = int(num())
                    length = num()
                    n_l = int(num())
                    p1 = cent + ori / max(np.linalg.norm(ori), 1e-30) \
                        * length
                    pts.append(probe_cone(cent, p1, r0, r1, n_l,
                                          max(4 * n_r, 8)))
                else:
                    raise ValueError(f"surface sub-shape {sub!r}")
                expect(")")
            i += 1
            out.append((name, np.concatenate(pts)))
        elif kwd == "line":
            name = toks[i]
            i += 1
            expect("(")
            p0 = np.array([num() for _ in range(3)])[:n_dims]
            p1 = np.array([num() for _ in range(3)])[:n_dims]
            h0 = num()
            npt = int(num())
            expect(")")
            out.append((name, probe_line_growth(p0, p1, h0, npt)))
        elif kwd == "point":
            expect("(")
            xyz = np.array([num() for _ in range(3)])[:n_dims]
            expect(")")
            out.append((f"point_{n_point}", xyz[None, :]))
            n_point += 1
        else:
            raise ValueError(f"probe script keyword {kwd!r}")
    return out


class ProbeManager:
    """All probe sets + their HDF5 writers; driver calls append()."""

    def __init__(self, sets):
        self.sets = sets       # list of (name, ProbeSet, writer)

    def append(self, solver, step: int):
        for _, __, writer in self.sets:
            writer.append(solver.time)


def setup_probes(run_input, solver, outdir: str) -> ProbeManager:
    """Build probe sets from the deck (ref:src/probe_input.cpp:51-66 setup:
    probe=1 reads probe_source_file as a script; probe=2 takes the vertices
    of a gambit mesh as probe locations)."""
    p = run_input
    fields = p.probe_fields or ["rho", "u", "pressure"]
    if p.probe == 2:
        from ..mesh.gambit import read_gambit
        m = read_gambit(p.probe_source_file)
        sets_pts = [("mesh_probes", m.xv.copy())]
    else:
        sets_pts = read_probe_script(
            p.probe_source_file, getattr(solver, "base", solver).n_dims)
    sets = []
    ascii_mode = bool(getattr(p, "probe_ascii", 0))
    for name, pts in sets_pts:
        ps = ProbeSet(solver, pts, fields)
        if ascii_mode:
            writer = ProbeASCIIWriter(os.path.join(outdir, name), ps)
        else:
            writer = ProbeHDF5Writer(os.path.join(outdir, f"{name}.h5"), ps)
        sets.append((name, ps, writer))
    return ProbeManager(sets)

"""Element-sharded runs of one element type: ShardedSolver.

Port of hifiles_tpu/parallel/sharding.py.  The host part is numpy and
copied: the partitions (``_contiguous_partition`` :74-81,
``_spectral_partition`` :84-136, ``graph_partition`` :139-204 with the
port's native.partition_native, ``_refine_partition`` :207-267).
ShardedSolver cuts its shards' flat slot tables
(soa_sharding.ShardSoaTables) from the face lists of
soa_sharding.shard_faces, without the JAX package's padded layout.
``ShardedSolver`` is the counterpart of :433-761 and :992-1408 on one
controller (soa_sharding.ShardedLoop); the slot residual (:763-990) has no
counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import PRISM, tracing
from .. import native
from ..solver.bc import make_bc_functions
from ..solver.residual_soa import block_wm_index
from ..solver.solver import Solver, cfl_dt
from .soa_sharding import ShardSoaTables, ShardedLoop, ShardState, \
    shard_block, shard_faces


def _contiguous_partition(n_eles: int, n_shards: int) -> np.ndarray:
    """Near-balanced contiguous chunks; the first ``n_eles % n_shards``
    shards get one extra element."""
    base, extra = divmod(n_eles, n_shards)
    sizes = base + (np.arange(n_shards) < extra)
    return np.repeat(np.arange(n_shards), sizes)


def _spectral_partition(conn, n_cells: int, n_shards: int):
    """Recursive spectral bisection on the element-adjacency Laplacian
    (Fiedler-vector median splits), exact +-1 balance via proportional
    split sizes.  Returns None when scipy or the eigensolver fails."""
    try:
        import scipy.sparse as sp
        import scipy.sparse.linalg as spl
    except Exception:                         # pragma: no cover
        return None
    rows = np.concatenate([conn.int_ele_l, conn.int_ele_r])
    cols = np.concatenate([conn.int_ele_r, conn.int_ele_l])
    A = sp.coo_matrix((np.ones(rows.size), (rows, cols)),
                      shape=(n_cells, n_cells)).tocsr()
    base, extra = divmod(n_cells, n_shards)
    targets = base + (np.arange(n_shards) < extra)

    part = np.empty(n_cells, dtype=np.int64)

    def split(idx, p0, p1):
        """Assign parts [p0, p1) to the cells idx."""
        if p1 - p0 == 1:
            part[idx] = p0
            return
        nh = (p1 - p0) // 2
        h = int(targets[p0:p0 + nh].sum())
        k = idx.size
        if k <= 2:
            order = np.arange(k)
        else:
            sub = A[idx][:, idx]
            deg = np.asarray(sub.sum(1)).ravel()
            L = sp.diags(deg) - sub
            try:
                # deterministic start vector: ARPACK's default v0 draws
                # from the global numpy RNG
                v0 = np.random.default_rng(k).standard_normal(k)
                vals, vecs = spl.eigsh(L.asfptype(), k=2, which="SM",
                                       tol=1e-6, maxiter=5000, v0=v0)
                order = np.argsort(vecs[:, np.argsort(vals)[1]])
            except Exception:                 # pragma: no cover
                order = np.arange(k)          # degenerate: id split
        split(idx[order[:h]], p0, p0 + nh)
        split(idx[order[h:]], p0 + nh, p1)

    try:
        split(np.arange(n_cells), 0, n_shards)
    except Exception:                         # pragma: no cover
        return None
    return part


def graph_partition(conn, n_cells: int, n_shards: int) -> np.ndarray:
    """Balanced low-cut element partition from the face-adjacency graph
    (the reference calls ParMETIS for this, ref:src/geometry.cpp:
    1040-1200): recursive spectral bisection when scipy is present, else
    a greedy-BFS grower (native hf_partition, with a numpy fallback);
    both get a Kernighan-Lin move/swap refinement pass."""
    pairs = np.stack([conn.int_ele_l, conn.int_ele_r], axis=1)
    both = np.concatenate([pairs, pairs[:, ::-1]])
    order = np.argsort(both[:, 0], kind="stable")
    both = both[order]
    counts = np.bincount(both[:, 0], minlength=n_cells)
    xadj = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    adjncy = both[:, 1].astype(np.int64)
    part = _spectral_partition(conn, n_cells, n_shards)
    if part is None:
        part = native.partition_native(xadj, adjncy, n_shards)
    if part is None:
        # numpy fallback: the same greedy max-gain grower
        import heapq
        part = -np.ones(n_cells, dtype=np.int64)
        base, extra = divmod(n_cells, n_shards)
        for p in range(n_shards):
            target = base + (1 if p < extra else 0)
            filled = 0
            gain = np.zeros(n_cells, dtype=np.int64)
            heap: list[tuple[int, int]] = []

            def absorb(c, p=p):
                nonlocal filled
                part[c] = p
                filled += 1
                for nb in adjncy[xadj[c]:xadj[c + 1]]:
                    if part[nb] < 0:
                        gain[nb] += 1
                        heapq.heappush(heap, (-gain[nb], int(nb)))

            while filled < target:
                pick = -1
                while heap:
                    g, c = heapq.heappop(heap)
                    if part[c] < 0 and gain[c] == -g:
                        pick = c
                        break
                if pick < 0:
                    unass = np.where(part < 0)[0]
                    degs = [np.sum(part[adjncy[xadj[c]:xadj[c + 1]]] < 0)
                            for c in unass]
                    pick = int(unass[int(np.argmin(degs))])
                absorb(pick)
    part = _refine_partition(xadj, adjncy, np.asarray(part), n_shards)
    # never do worse than the KL-refined contiguous split
    cut = np.sum(part[conn.int_ele_l] != part[conn.int_ele_r])
    contig = _refine_partition(xadj, adjncy,
                               _contiguous_partition(n_cells, n_shards),
                               n_shards)
    if np.sum(contig[conn.int_ele_l] != contig[conn.int_ele_r]) < cut:
        part = contig
    sizes = np.bincount(part, minlength=n_shards)
    if sizes.max() - sizes.min() > 1:
        raise AssertionError(f"unbalanced partition: {sizes}")
    return part


def _refine_partition(xadj, adjncy, part, n_shards, max_passes=20):
    """Kernighan-Lin-style refinement: single moves with positive cut gain
    (balance permitting) plus balance-preserving pairwise swaps across cut
    edges."""
    n = part.size
    sizes = np.bincount(part, minlength=n_shards)
    lo, hi = n // n_shards, -(-n // n_shards)
    edge_src = np.repeat(np.arange(n), np.diff(xadj))

    def move_gain(c, dst):
        """Cut reduction from moving c to part dst."""
        nbp = part[adjncy[xadj[c]:xadj[c + 1]]]
        return int(np.sum(nbp == dst)) - int(np.sum(nbp == part[c]))

    for _ in range(max_passes):
        moved = False
        # big meshes: only the cut-front elements can move
        if n > 20000:
            front = np.unique(edge_src[part[edge_src] != part[adjncy]])
        else:
            front = range(n)
        # 1. positive-gain single moves (balance permitting)
        for c in front:
            pc = part[c]
            nbrs = adjncy[xadj[c]:xadj[c + 1]]
            nbp = part[nbrs]
            if nbp.size == 0 or (nbp == pc).all():
                continue
            for dst in np.unique(nbp[nbp != pc]):
                if (sizes[pc] > lo and sizes[dst] < hi
                        and move_gain(c, int(dst)) > 0):
                    part[c] = int(dst)
                    sizes[pc] -= 1
                    sizes[int(dst)] += 1
                    moved = True
                    break
        # 2. balance-preserving pairwise swaps across the current cut
        for a in front:
            pa = part[a]
            nbrs_a = adjncy[xadj[a]:xadj[a + 1]]
            for b in nbrs_a:
                pb = part[b]
                if pb == pa:
                    continue
                # the shared edge stays cut either way, but move_gain
                # counts it as gained on both sides: -2
                g = move_gain(a, pb) + move_gain(int(b), pa) - 2
                if g > 0:
                    part[a], part[b] = pb, pa
                    moved = True
                    break
        if not moved:
            break
    return part


def _shard_sides(shard_of, loc_of, Pf, n_fpts_per_face):
    """shard_faces' ``side`` and ``gslots`` for one element type of Pf flux
    points an element: a face side's shard and slots local to it (element
    ``loc_of`` there), and its slots in the whole mesh (sharding.py:
    285-297)."""
    n_fpts_per_face = np.asarray(n_fpts_per_face, dtype=np.int64)
    fpt_off = np.concatenate([[0], np.cumsum(n_fpts_per_face)])

    def side(e_old, locf, perm=None):
        s, e_loc = int(shard_of[e_old]), int(loc_of[e_old])
        j = np.arange(int(n_fpts_per_face[locf])) if perm is None else perm
        return s, e_loc * Pf + fpt_off[locf] + j

    def gslots(e_old, locf):
        return (e_old * Pf + fpt_off[locf]
                + np.arange(int(n_fpts_per_face[locf])))
    return side, gslots


def _unsupported(p, mesh) -> list:
    """What ShardedSolver does not run: prisms and mixed meshes, which
    ShardedMixedSolver runs, and ``patch``, which the JAX ShardedSolver
    leaves unapplied (its initial state is the unpatched initial
    condition, sharding.py:656-658)."""
    missing = []
    types = np.unique(mesh.ctype)
    if types.size > 1 or int(types[0]) == PRISM:
        missing.append("mixed element types or prisms (use "
                       "hifiles_tpu_torch.parallel.ShardedMixedSolver)")
    if p.patch:
        missing.append("patch (the JAX ShardedSolver leaves its initial "
                       "state unpatched)")
    return missing


class ShardedSolver(ShardedLoop):
    """A single-type (quad, tri, hex or tet) solver whose elements are cut
    into ``len(devices)`` shards, shard s on ``devices[s]`` (several may
    share a device; parallel.select_devices places them), driven by one
    controller.  ``partition``: each element's shard (an array), or
    "graph" for graph_partition; near-balanced contiguous chunks by
    default.  ``base`` is the single-device Solver on ``devices[0]`` that
    the shards are cut from, the twin that the writers read; ``owner``
    and ``pad_mask`` (n, El) give each shard's elements padded as the JAX
    package pads them (clones of the shard's first element), and ``u``
    the state in that padded (n, El, U, F) layout, on the host."""

    @tracing.traced("setup")
    def __init__(self, run_input, mesh, devices, dtype=torch.float64,
                 partition=None):
        missing = _unsupported(run_input, mesh)
        if missing:
            raise NotImplementedError("hifiles_tpu_torch ShardedSolver: "
                                      + ", ".join(missing))
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        with tracing.span("setup.twin"):
            base = Solver(run_input, mesh, device=devices[0], dtype=dtype)
        block, ops, conn = base.block, base.ops, base.conn
        E, Pf = block.n_eles, ops.n_fpts
        with tracing.span("setup.shards"):
            if isinstance(partition, str):
                if partition != "graph":
                    raise ValueError(f"partition {partition!r}")
                partition = graph_partition(conn, E, n)
            shard_of = (np.asarray(partition) if partition is not None
                        else _contiguous_partition(E, n))
            sizes = np.bincount(shard_of, minlength=n)
            if sizes.size != n or sizes.min() == 0:
                raise ValueError(f"ShardedSolver: every one of {n} shards "
                                 f"needs an element; partition sizes "
                                 f"{sizes}")
            El = int(sizes.max())
            # owner[s, i] = the element of shard s's i-th local slot; below
            # El padded with clones of its first element (sharding.py:
            # 463-480)
            order = np.argsort(shard_of, kind="stable")
            loc_of = np.empty(E, dtype=np.int64)
            owner = np.empty((n, El), dtype=np.int64)
            pad_mask = np.zeros((n, El))
            off = 0
            for s in range(n):
                mine = order[off:off + sizes[s]]
                off += sizes[s]
                loc_of[mine] = np.arange(sizes[s])
                owner[s, :sizes[s]] = mine
                owner[s, sizes[s]:] = mine[0]
                pad_mask[s, :sizes[s]] = 1.0
            self.owner, self.pad_mask, self.sizes = owner, pad_mask, sizes
            self.n_eles, self.El = E, El
        with tracing.span("setup.peers"):
            side, gslots = _shard_sides(shard_of, loc_of, Pf,
                                        ops.n_fpts_per_face)
            ints_s, bdys_s, halos_s = shard_faces(conn, n, side,
                                                  block.pos_fpts, gslots)

        with tracing.span("setup.shards"):
            nfp = int(ops.n_fpts_per_face[0])
            subs, tables, bc_fns, wm_index = [], [], [], []
            for s, dev in enumerate(devices):
                ids, bdys = owner[s, :sizes[s]], bdys_s[s]
                sub = shard_block(block, ids, bdys)
                subs.append([(0, ids, sub)])
                tables.append(ShardSoaTables(ints_s[s], bdys, halos_s[s],
                                             sizes[s] * Pf, sub.norm_fpts,
                                             face=(Pf, nfp)))
                fns = (make_bc_functions(run_input, sub, base.rcfg, dev,
                                         dtype) if bdys else None)
                bc_fns.append(fns)
                wm_index.append(block_wm_index(fns))
            self._setup_shards(base, devices, subs, tables, bc_fns,
                               wm_index)
            self._owners = [owner]
            self._h_ref = [torch.as_tensor(sub[0][2].h_ref, dtype=dtype,
                                           device=dev)
                           for sub, dev in zip(subs, devices)]
            self._setup_sharded_inlet(block, bdys_s, nfp)
        with tracing.span("setup.initial_state"):
            self.set_state(base.u, np.zeros_like(base.u), 0.0)

    def _setup_sharded_inlet(self, block, bdys_s, nfp):
        """The turbulent inlet over the whole inlet plane on the
        controller's device, as the single-device one (one draw stream,
        its plane sums over every shard: the JAX make_fluc_core's psum,
        sharding.py:600-654): it reads the inlet points gathered from the
        shards, and its fluctuations, laid out as the shards' boundary
        planes end to end, go back to each shard in its residual
        (``_shard_fluc``)."""
        self._fluc_cols = []
        plane_index = -np.ones((block.bdy_bcid.size, nfp), dtype=np.int64)
        start = 0
        for bdys in bdys_s:
            Fb = len(bdys)
            for k, (_, _, f) in enumerate(bdys):
                plane_index[f] = start + np.arange(nfp) * Fb + k
            self._fluc_cols.append((start, Fb))
            start += nfp * Fb
        inlet = self.base.turb_inlet
        self._in_slots = [None] * self.n_shards
        slots = None
        if inlet is not None:
            in_faces = set(int(f) for f in inlet.in_faces)
            col, pos = {}, 0
            for s, (bdys, dev) in enumerate(zip(bdys_s, self.devices)):
                mine = [(sl, f) for sl, _, f in bdys if f in in_faces]
                for sl, f in mine:
                    col[f] = pos + np.arange(nfp)
                    pos += nfp
                if mine:
                    self._in_slots[s] = torch.as_tensor(
                        np.concatenate([sl for sl, _ in mine]), device=dev)
            slots = np.stack([col[int(f)] for f in inlet.in_faces])
        self._setup_inlet(block, plane_index, (start,), self._inlet_rows,
                          slots=slots)

    def _inlet_parts(self, u):
        """(shard, the flux-point rows (F, n) of its inlet points) of each
        shard that has some, on its device."""
        for s, (res, idx) in enumerate(zip(self._shard_res, self._in_slots)):
            if idx is not None:
                yield s, res.flux_point_rows(self._part_views(u, s)
                                             ).index_select(1, idx)

    def _inlet_rows(self, u):
        """The flux-point rows (F, points) of the inlet's points, gathered
        from the shards onto the controller's device."""
        return torch.cat([r.to(self.device) for _, r in self._inlet_parts(u)],
                         dim=1)

    def _card_inlet_rows(self, copies):
        """``_inlet_rows`` in a multi-card step, before its cut: each
        shard's inlet rows, those of shards on other cards than the
        controller's copied into persistent buffers, with the copies that
        bring them to the controller's card appended to ``copies``.
        Returns the parts to concatenate after the cut."""
        rows = []
        for s, r in self._inlet_parts(self.u_soa):
            k = self._card_of[s]
            if k != 0:
                src = self._cbuf(("rows", s), r, k)
                dst = self._cbuf(("rows in", s), r, 0)
                src.copy_(r)
                copies.append((src, k, dst, 0))
                r = dst
            rows.append(r)
        return rows

    def _card_scatter_fluc(self):
        """``_shard_fluc`` in a multi-card step, once per step after the
        inlet's update: each shard's part of the fluctuations, sent by a
        cut to the shards on other cards than the controller's, held in
        ``_card_fluc`` for the step's stages."""
        d, nfp = self._fluc.shape[0], self.base.block.bdy_slot.shape[1]
        copies, self._card_fluc = [], []
        for s, (start, Fb) in enumerate(self._fluc_cols):
            part = self._fluc[:, start:start + nfp * Fb]
            k = self._card_of[s]
            if Fb and k != 0:
                src = self._cbuf(("fluc", s), part, 0)
                dst = self._cbuf(("fluc in", s), part, k)
                src.copy_(part)
                copies.append((src, 0, dst, k))
                part = dst
            self._card_fluc.append(part.view(d, nfp, Fb) if Fb else None)
        if copies:
            self._cstep.cut(copies)

    def _shard_fluc(self, fluc, s):
        """Shard s's part (d, nfp, Fb_s) of the inlet's fluctuations on its
        device, or None when it has no boundary face."""
        start, Fb = self._fluc_cols[s]
        if Fb == 0:
            return None
        nfp = self.base.block.bdy_slot.shape[1]
        return fluc[:, start:start + nfp * Fb].view(
            fluc.shape[0], nfp, Fb).to(self.devices[s])

    # ------------------------------------------------------------------
    def _state_out(self, arrays):
        """Per-sub-block arrays -> the padded (n, El, U, K) layout."""
        return super()._state_out(arrays)[0]

    def gather_u(self) -> np.ndarray:
        """The state (E, U, F) in the mesh's element order."""
        return super().gather_u()[0]

    def gather_u_avg(self):
        """The running averages (E, U, K) in element order, or None."""
        ua = super().gather_u_avg()
        return None if ua is None else ua[0]

    @tracing.traced("compute_dt")
    def compute_dt(self):
        """The time step (sharding.py:1221-1276 of the JAX package):
        dt_type 0 the deck's dt; else the CFL limit per element on each
        shard (solver.cfl_dt): dt_type 1 its minimum over every shard as a
        0-d tensor on the controller's device; dt_type 2 the per-element
        steps as an (n, El) tensor there, the padding slots 0, which
        ``run`` takes as a local dt.  Equation 1 takes dt_type 0 only."""
        p = self.p
        if p.dt_type == 0:
            return p.dt
        self._check_cfl_dt()
        dts = [cfl_dt(p, v, h, self.n_dims)
               for v, h in zip(self._views(self.u_soa), self._h_ref)]
        if p.dt_type == 1:
            return torch.stack([x.min().to(self.device) for x in dts]).min()
        out = torch.zeros((self.n_shards, self.El), dtype=self.dtype,
                          device=self.device)
        for s, x in enumerate(dts):
            out[s, :x.numel()] = x.to(self.device)
        return out

    def _local_dt(self, dt):
        """A per-element dt, (E,) in element order or (n, El) padded as
        compute_dt gives it -> (a ShardState of (1, 1, E_s) planes, its
        minimum, 0-d on the controller's device)."""
        dt = torch.as_tensor(dt, dtype=self.dtype, device=self.device)
        if dt.shape == (self.n_eles,):
            dt = dt[torch.as_tensor(self.owner, device=self.device)]
        if dt.shape != (self.n_shards, self.El):
            raise ValueError(f"local dt of shape {tuple(dt.shape)}; the run "
                             f"has {self.n_eles} elements in "
                             f"{self.n_shards} shards of at most {self.El}")
        parts = [dt[s, :n].view(1, 1, n).to(dev)
                 for s, (n, dev) in enumerate(zip(self.sizes, self.devices))]
        dt_min = torch.stack([x.min().to(self.device) for x in parts]).min()
        return ShardState(parts), dt_min

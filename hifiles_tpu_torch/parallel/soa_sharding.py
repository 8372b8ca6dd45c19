"""Element-sharded runs on the flat slot tables: one controller, N shards.

The halo machinery of hifiles_tpu/parallel/soa_sharding.py (:1-21,
:473-479, :570-578, :703-710, :750-765) and mixed_soa_sharding.py, on the
port's flat slot tables.  Each shard holds its elements as sub-blocks of
the single-device blocks, unpadded, on its own torch device, and one
controller process drives every shard.  A face whose two elements live
on different shards is a halo face, the third face class of the shard's
tables beside the interior and boundary faces: each side evaluates it
one-sided, its own side as L with its own outward normal, as the
reference's mpi_inters does.  The face stage of every shard stops at the
two halo exchanges (residual_soa.make_face_residual's ``stages``): the
flux-point states, then the element-side normal viscous flux qn; and
once at its volume stage, where the controller launches the volume
kernel once per card for the blocks of all its shards.  A shard
receives from shard ``(s - o) % n`` for each ring offset ``o``, each
buffer moved with ``Tensor.to(device, non_blocking=True)``, which is the
tensor itself when both shards share a device; so N shards on one card
run exactly the code of N cards.  The JAX package's face groups, pools,
``sel`` encoding and padding clones exist for shard_map's one static shape
and have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..solver.elements import match_fpts_grouped
from ..solver.residual_soa import (BlockStages, FaceArrays, Physics,
                                   check_coverage, make_face_residual,
                                   orient_faces)
from ..solver.solver import BlockLoop
from ..solver.volume import VolumeRequest, volume_tdisf_groups


def shard_faces(conn, n, side, pf_flat, gslots):
    """Every face of ``conn`` classified per shard (sharding.py:299-322 and
    mixed_sharding.py:148-200 of the JAX package): ``side(ele, locf,
    perm=None)`` gives a face side's shard and its shard-local slots (in
    the order ``perm`` when given), ``gslots(ele, locf)`` its slots in a
    global slot space whose flux-point positions are ``pf_flat``.  Returns
    per shard the interior faces [(slots_l, slots_r)], the boundary faces
    [(slots, group id, boundary face index)] and the halo faces [(own
    slots, ring offset, partner's slots on its shard)], the partner's
    points paired with the own ones point by point (match_fpts_grouped),
    listed in receive order: by ring offset, then in face order."""
    Fi = conn.int_ele_l.size
    gls = [gslots(conn.int_ele_l[f], conn.int_locf_l[f]) for f in range(Fi)]
    grs = [gslots(conn.int_ele_r[f], conn.int_locf_r[f]) for f in range(Fi)]
    luts = match_fpts_grouped(pf_flat, gls, grs)
    ints = [[] for _ in range(n)]
    bdys = [[] for _ in range(n)]
    halos = [[] for _ in range(n)]
    for f in range(Fi):
        s_l, sl = side(conn.int_ele_l[f], conn.int_locf_l[f])
        s_r, sr = side(conn.int_ele_r[f], conn.int_locf_r[f], luts[f])
        if s_l == s_r:
            ints[s_l].append((sl, sr))
        else:
            halos[s_l].append((sl, (s_l - s_r) % n, sr))
            halos[s_r].append((sr, (s_r - s_l) % n, sl))
    for f in range(conn.bdy_ele.size):
        s, sl = side(conn.bdy_ele[f], conn.bdy_locf[f])
        bdys[s].append((sl, int(conn.bdy_bcid[f]), f))
    halos = [sorted(h, key=lambda x: x[1]) for h in halos]
    return ints, bdys, halos


def shard_block(block, eles, bdy=()):
    """The sub-block of element block ``block`` holding its elements
    ``eles`` in that order: the per-element geometry gathered, the flux
    point slots renumbered e_local*Pf + fpt, and the boundary faces
    ``bdy`` [(local slots, group id, ...)] as its boundary tables (its
    interior tables stay empty: the shard's face tables hold them)."""
    E, Pf = block.n_eles, block.ops.n_fpts
    nfp = int(block.ops.n_fpts_per_face.max())
    eles = np.asarray(eles, dtype=np.int64)
    per_ele = lambda a: None if a is None else a[eles]
    per_slot = lambda a: None if a is None else \
        a.reshape((E, Pf) + a.shape[1:])[eles].reshape((-1,) + a.shape[1:])
    rows = np.zeros((len(bdy), nfp), dtype=np.int64)
    mask = np.zeros((len(bdy), nfp))
    for k, (sl, *_rest) in enumerate(bdy):
        rows[k, :sl.size] = sl
        mask[k, :sl.size] = 1.0
    empty = np.zeros((0, nfp), dtype=np.int64)
    return dataclasses.replace(
        block, n_eles=eles.size, pos_upts=per_ele(block.pos_upts),
        detjac_upts=per_ele(block.detjac_upts),
        jginv_upts=per_ele(block.jginv_upts),
        pos_fpts=per_slot(block.pos_fpts), tdA_fpts=per_slot(block.tdA_fpts),
        norm_fpts=per_slot(block.norm_fpts),
        detjac_fpts=per_slot(block.detjac_fpts),
        jginv_fpts=per_slot(block.jginv_fpts),
        int_slot_l=empty, int_slot_r=empty, int_mask=None,
        bdy_slot=rows, bdy_mask=mask,
        bdy_bcid=np.array([b[1] for b in bdy], dtype=np.int64),
        slot_src=None, slot_sign=None,
        pos_vol_cubpts=per_ele(block.pos_vol_cubpts),
        detjac_vol_cubpts=per_ele(block.detjac_vol_cubpts),
        h_ref=per_ele(block.h_ref), jginv_over=per_ele(block.jginv_over),
        wall_dist_upts=per_ele(block.wall_dist_upts),
        wall_dist_fpts=per_slot(block.wall_dist_fpts))


class ShardSoaTables:
    """The flat slot tables of one shard's faces (residual_soa.FaceArrays
    reads them), from its faces of ``shard_faces``: the interior
    ``slot_l``/``slot_r``, the boundary ``slot_b`` and the halo faces'
    own side ``slot_h`` with ``recv_idx``, each halo point's column in
    the receive buffer, which holds the partners' points face by face in
    receive order.  With ``face`` = (Pf, nfp) (one element type, uniform
    faces) the planes are (nfp, faces), the interior faces oriented as
    SoaTables orients them (orient_faces) and the normals compressed where
    uniform; without it (a mixed mesh) they are flat point axes as in
    MixedSoaTables, the L side as given.  ``halo_parts[o]``: the partner
    slots that the shard receives at ring offset ``o``; ``send`` (set by
    ``link_shards``): the slots whose values the shard sends."""

    def __init__(self, ints, bdys, halos, n_slots, norm_fpts, face=None):
        self.norm_fpts = norm_fpts
        self.compress = face is not None
        own = [h[0] for h in halos]
        if face is None:
            cat = lambda xs: (np.concatenate(xs) if xs
                              else np.zeros(0, dtype=np.int64))
            self.slot_l = cat([a for a, _ in ints])
            self.slot_r = cat([b for _, b in ints])
            self.slot_b = cat([b[0] for b in bdys])[None, :]
            self.slot_h = cat(own)
            self.recv_idx = np.arange(self.slot_h.size)
        else:
            Pf, nfp = face
            rows = lambda xs: (np.stack(xs) if xs
                               else np.zeros((0, nfp), dtype=np.int64))
            L, R = orient_faces(rows([a for a, _ in ints]),
                                rows([b for _, b in ints]), Pf, nfp)
            H = rows(own)
            self.slot_l = np.ascontiguousarray(L.T)
            self.slot_r = np.ascontiguousarray(R.T)
            self.slot_b = np.ascontiguousarray(rows([b[0] for b in bdys]).T)
            self.slot_h = np.ascontiguousarray(H.T)
            self.recv_idx = np.ascontiguousarray(
                np.arange(H.size).reshape(H.shape).T)
        check_coverage([self.slot_l, self.slot_r, self.slot_b, self.slot_h],
                       n_slots)
        self.halo_parts = {}
        for _, o, partner in halos:
            self.halo_parts.setdefault(o, []).append(partner)
        self.halo_parts = {o: np.concatenate(v)
                           for o, v in self.halo_parts.items()}
        self.send = None


def link_shards(tables):
    """Set each shard's ``send``, the partner slots every receiver wants
    from it, ring offset after ring offset; returns per receiver the plan
    of its receive buffer, [(sending shard, start, end)] in ring-offset
    order: the slice of that shard's send buffer to append (the JAX
    ppermute of each offset, soa_sharding.py:473-479)."""
    n = len(tables)
    offsets = sorted({o for T in tables for o in T.halo_parts})
    where = [{} for _ in range(n)]
    for t in range(n):
        parts, pos = [], 0
        for o in offsets:
            part = tables[(t + o) % n].halo_parts.get(o)
            if part is None:
                continue
            where[t][o] = (pos, pos + part.size)
            parts.append(part)
            pos += part.size
        tables[t].send = (np.concatenate(parts) if parts
                          else np.zeros(0, dtype=np.int64))
    return [[((s - o) % n, *where[(s - o) % n][o])
             for o in offsets if o in tables[s].halo_parts]
            for s in range(n)]


class ShardState:
    """The state of an element-sharded run: one tensor per shard on that
    shard's device (``parts``), with the in-place tensor methods that
    step.make_step_fn applies to a state, applied shard by shard."""

    def __init__(self, parts):
        self.parts = list(parts)

    def clone(self):
        return ShardState(p.clone() for p in self.parts)

    def copy_(self, x):
        """Copy ShardState ``x`` part by part, or one tensor (a 0-d dt)
        into every part."""
        xs = x.parts if isinstance(x, ShardState) else [x] * len(self.parts)
        for p, q in zip(self.parts, xs, strict=True):
            p.copy_(q)
        return self

    def add_(self, x, alpha=1.0):
        for p, q in zip(self.parts, x.parts):
            p.add_(q, alpha=alpha)
        return self

    def mul_(self, a):
        for p in self.parts:
            p.mul_(a)
        return self

    def div_(self, a):
        for p in self.parts:
            p.div_(a)
        return self

    def addcmul_(self, x, a):
        """self += x * a, ``a`` a ShardState that broadcasts (a local dt)."""
        for p, q, r in zip(self.parts, x.parts, a.parts):
            p.addcmul_(q, r)
        return self

    def __truediv__(self, a):
        return ShardState(p / a for p in self.parts)


def _advance(gen, recv):
    """The next message of a shard's residual ``gen`` (a send buffer or
    a volume request) after it takes ``recv`` (the receive buffer or the
    volume outputs), or None once its residual is done."""
    try:
        return gen.send(recv)
    except StopIteration:
        return None


class ShardedLoop(BlockLoop):
    """BlockLoop over the shards of an element-sharded run: its blocks are
    every shard's sub-blocks, shard by shard, each on its shard's device,
    and its state a ShardState whose part s holds shard s's sub-blocks
    end to end (as a single-type shard's one (U, F, E_s) tensor).  The
    time loop, the featured carry and the diagnostics are BlockLoop's;
    the right-hand side drives every shard's face stage through the halo
    exchanges.  ``base`` is the single-device twin (Solver or MixedSolver)
    whose blocks the shards cut: the layout of ``gather_u``,
    ``scatter_u`` and ``set_state`` is its ``u``; ``soa_tables`` and
    ``shard_bc_fns`` hold each shard's ShardSoaTables and boundary
    functions."""

    def _setup_shards(self, base, devices, subs, tables, bc_fns, wm_index):
        """``subs[s]``: shard s's sub-blocks as (base block index, element
        indices in that block, sub-block); ``tables[s]``, ``bc_fns[s]``,
        ``wm_index[s]``: its ShardSoaTables, boundary functions and the
        wall-model index of make_face_residual."""
        for k in ("p", "mesh", "dtype", "n_dims", "n_fields", "delta_cyclic",
                  "_bc_flags", "conn", "rcfg", "_bc_fns"):
            setattr(self, k, getattr(base, k))
        self.base, self.device = base, devices[0]
        self.devices, self.n_shards = list(devices), len(devices)
        self.turb_inlet = self._ti_state = self._fluc = None
        self.soa_tables, self._recv = tables, link_shards(tables)
        self.shard_bc_fns = bc_fns
        ph = Physics(self.rcfg, self.n_dims)
        self._shard_res, self._shard_shapes = [], []
        for s, dev in enumerate(self.devices):
            stages = [BlockStages(b, ph, dev, self.dtype)
                      for _, _, b in subs[s]]
            self._shard_res.append(make_face_residual(
                stages, FaceArrays(tables[s], dev, self.dtype), ph,
                bc_fns[s], wm_index[s]))
            self._shard_shapes.append([(b.ops.n_upts, b.n_eles)
                                       for _, _, b in subs[s]])
        self._place = [(i, ids) for sub in subs for i, ids, _ in sub]
        blocks = [b for sub in subs for _, _, b in sub]
        sels = [base._sels[i][ids] for i, ids in self._place]
        devs = [dev for dev, sub in zip(self.devices, subs) for _ in sub]
        self._setup_loop(blocks, sels, self._shard_rhs, devs)

    # ------------------------------------------------------------------
    def _part_views(self, x, s, K=None):
        """Shard s's sub-blocks' (U_t, K, E_t) views of ShardState x."""
        K = self.n_fields if K is None else K
        flat, out, o = x.parts[s].view(-1), [], 0
        for U, E in self._shard_shapes[s]:
            out.append(flat[o:o + U * K * E].view(U, K, E))
            o += U * K * E
        return tuple(out)

    def _views(self, x, K=None):
        return tuple(v for s in range(self.n_shards)
                     for v in self._part_views(x, s, K))

    def _alloc(self, K=None):
        K = self.n_fields if K is None else K
        parts = []
        for dev, shapes in zip(self.devices, self._shard_shapes):
            if len(shapes) == 1:
                U, E = shapes[0]
                parts.append(torch.empty((U, K, E), dtype=self.dtype,
                                         device=dev))
            else:
                parts.append(torch.empty(sum(U * K * E for U, E in shapes),
                                         dtype=self.dtype, device=dev))
        return ShardState(parts)

    def _exchange(self, bufs):
        """Each shard's receive buffer from the shards' send buffers
        (C, n_send): the slices of its plan, moved to its device and
        concatenated in ring-offset order."""
        out = []
        for s, (plan, dev) in enumerate(zip(self._recv, self.devices)):
            parts = [bufs[t][:, a:b].to(dev, non_blocking=True)
                     for t, a, b in plan]
            out.append(torch.cat(parts, dim=1) if parts else bufs[s][:, :0])
        return out

    def _shard_rhs(self, u, ramp, fluc=None):
        """The right-hand side of ShardState ``u``: every shard's residual
        run to its next halo exchange or volume request, the exchange or
        the shards' grouped volume launches, and so on to the end.
        ``ramp``, a 0-d tensor on the controller's device, and ``fluc``
        (``_shard_fluc``; only a single-type run has an inlet) reach each
        shard on its device."""
        out = self._alloc()
        gens = []
        for s, (res, dev) in enumerate(zip(self._shard_res, self.devices)):
            fl = None if fluc is None else self._shard_fluc(fluc, s)
            gens.append(res.stages(
                self._part_views(u, s), fl,
                None if ramp is None else ramp.to(dev),
                out=self._part_views(out, s)))
        msgs = [next(g) for g in gens]
        while msgs[0] is not None:
            if isinstance(msgs[0], VolumeRequest):
                # every shard's volume stage, one launch per card
                recv = volume_tdisf_groups(msgs)
            else:
                recv = self._exchange(msgs)
            msgs = [_advance(g, r) for g, r in zip(gens, recv)]
        return out

    # ------------------------------------------------------------------
    def _split(self, arrays):
        """The twin's per-block (E_t, U_t, K) arrays (a single block's may
        come bare) -> each sub-block's, in state order."""
        arrays = arrays if isinstance(arrays, (tuple, list)) else (arrays,)
        return tuple(np.asarray(arrays[i])[ids] for i, ids in self._place)

    def _gather(self, arrays):
        """Per-sub-block (E, U, K) arrays -> the twin's per-block ones."""
        out = [None] * len(self.base._blocks)
        for (i, ids), a in zip(self._place, arrays):
            if out[i] is None:
                n = self.base._shapes[i][1]
                out[i] = np.empty((n,) + a.shape[1:], dtype=a.dtype)
            out[i][ids] = a
        return tuple(out)

    def set_state(self, u, reg, time: float, **kw) -> None:
        """BlockLoop.set_state with the state, register and averages in
        the twin's layout (per block, a single block's bare)."""
        if kw.get("u_avg") is not None:
            kw["u_avg"] = self._split(kw["u_avg"])
        super().set_state(self._split(u), self._split(reg), time, **kw)

    def _state_out(self, arrays):
        """Per-sub-block arrays -> per base block the (n, El_t, U_t, K)
        layout of the JAX package, each shard's elements padded with
        clones of its first one (``_owners``)."""
        return tuple(a[o] for a, o in zip(self._gather(arrays),
                                           self._owners))

    def gather_u(self):
        """The state in the twin's layout, per block (E_t, U_t, F) in the
        order of its ``u`` (sharding.py:1338-1346, mixed_sharding.py:
        1075-1083 of the JAX package)."""
        return self._gather(self._to_numpy(self.u_soa))

    def gather_u_avg(self):
        """The running averages in the twin's layout, or None."""
        if self.u_avg_soa is None:
            return None
        return self._gather(self._to_numpy(self.u_avg_soa,
                                           len(self.p.average_fields)))

    def scatter_u(self, u) -> None:
        """Inverse of gather_u: the state ``u`` in the twin's layout onto
        the shards (sharding.py:1360-1368)."""
        self.u_soa.copy_(self._from_numpy(self._split(u)))

    def _global_dt_rk(self):
        """What the RK update takes for a global dt: a 0-d copy on each
        shard's device."""
        return ShardState(torch.zeros((), dtype=self.dtype, device=dev)
                          for dev in self.devices)

    def sync_twin(self):
        """The twin ``base`` holding this run's state, clock and featured
        carry (the JAX driver's sync, driver.py:109-131), for the writers
        and monitors that read it."""
        u = self._gather(self._to_numpy(self.u_soa))      # per block
        self.base.set_state(
            u, tuple(np.zeros_like(a) for a in u), self.time,
            iter_k=float(self._k), mdot_old=float(self._mdot_old),
            t_sim=float(self._t_sim), u_avg=self.gather_u_avg())
        return self.base

    def save_checkpoint(self, directory: str, step: int) -> str:
        """The HDF5 restart file of the gathered state, the layout of a
        single-device run's (sharding.py:1375-1389), and the SEM eddies'
        dump beside it."""
        from ..io.restart import write_restart, write_sem_restart
        out = write_restart(directory, self.sync_twin(), step=step)
        if self.turb_inlet is not None and self.turb_inlet.inlet_type == 2:
            write_sem_restart(directory, step, self.turb_inlet,
                              self._ti_state, self.p)
        return out

    def load_checkpoint(self, path: str) -> float:
        """Read a restart file into the twin and scatter it onto the
        shards (sharding.py:1391-1408); returns its time."""
        from ..io.restart import read_restart
        t = read_restart(path, self.base)
        self.scatter_u(self.base.u)
        self.time = t
        return t

    # the JAX sharded solvers' name (sharding.py:1278-1312): BlockLoop's
    # norms over every shard's sub-blocks
    norm_residual = BlockLoop.residual_norm

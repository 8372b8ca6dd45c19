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
buffer moved with ``Tensor.to(device, non_blocking=True)`` in the eager
loop, which is the tensor itself when both shards share a device.  With
shards on several cards a captured run cuts the step at its exchanges
(parallel/cards.py): each card captures its own segments, and the
buffers that cross cards go by peer copies between persistent buffers
(``ShardedLoop._card_exchange``).  The JAX package's face groups, pools,
``sel`` encoding and padding clones exist for shard_map's one static shape
and have no counterpart here.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import tracing
from ..solver.elements import match_fpts_grouped
from ..solver.graph import CudaCards
from ..solver.residual_soa import (BlockStages, FaceArrays, Physics,
                                   check_coverage, make_face_residual,
                                   orient_faces)
from ..solver.solver import BlockLoop
from ..solver.volume import (VolumeRequest, captured_launches, count_replay,
                             volume_tdisf_groups)
from .cards import CardStep


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
        self._block_shard = [s for s, sub in enumerate(subs) for _ in sub]
        # the cards: each distinct device, the controller's first; with
        # shards on several, ``run`` captures each card's segments of the
        # step (parallel/cards.py) through ``_card_backend`` (a test may
        # set stand-ins with their own card map)
        self._cards = list(dict.fromkeys(self.devices))
        self._card_of = [self._cards.index(d) for d in self.devices]
        self._card_backend = None
        self._cstep = self._reps = None
        self._cbufs, self._card_fluc = {}, None
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
        shard on its device; in a multi-card step, from the card's replica
        of the ramp counter and the fluctuations sent to it at the step's
        start (``_card_scatter_fluc``), and the exchanges are cuts."""
        out = self._alloc()
        cs = self._cstep
        gens = []
        for s, (res, dev) in enumerate(zip(self._shard_res, self.devices)):
            if cs is None:
                fl = None if fluc is None else self._shard_fluc(fluc, s)
                rp = None if ramp is None else ramp.to(dev)
            else:
                fl = None if fluc is None else self._card_fluc[s]
                rp = (None if ramp is None
                      else self._reps["k"][self._card_of[s]])
            gens.append(res.stages(self._part_views(u, s), fl, rp,
                                   out=self._part_views(out, s)))
        msgs = [next(g) for g in gens]
        while msgs[0] is not None:
            if isinstance(msgs[0], VolumeRequest):
                # every shard's volume stage, one launch per card
                with tracing.part("residual.volume"):
                    recv = volume_tdisf_groups(msgs)
            else:
                with tracing.part("residual.halo"):
                    recv = (self._exchange(msgs) if cs is None
                            else self._card_exchange(msgs))
            msgs = [_advance(g, r) for g, r in zip(gens, recv)]
        return out

    # ------------------------------------------------------------------
    # shards on several cards: the step captured per card, cut at its
    # cross-card points (parallel/cards.py)
    def _n_cards(self):
        return len(self._cards)

    def _block_card(self, i):
        return self._card_of[self._block_shard[i]]

    def _cbuf(self, key, like, k):
        """The persistent buffer ``key`` shaped as ``like`` on card k: a
        cut's source or destination, allocated by the warm-up step, never
        inside a capture (a peer reads it across every replay)."""
        buf = self._cbufs.get(key)
        if buf is None:
            if self._cstep.mode == "capture":
                raise RuntimeError(f"multi-card step: buffer {key} first "
                                   "asked for inside a capture")
            buf = self._cbufs[key] = torch.empty(
                like.shape, dtype=like.dtype, device=self._cards[k])
        return buf

    def _card_exchange(self, msgs):
        """``_exchange`` as a cut: each part that crosses cards copied into
        its persistent send buffer (the halo slot alternating from one
        exchange to the next), peer-copied at the cut into its receive
        buffer on the receiving card; parts between shards of one card
        taken as ``_exchange`` takes them."""
        cs = self._cstep
        slot = cs.next_slot()
        copies, parts_of = [], []
        for s, plan in enumerate(self._recv):
            ks, parts = self._card_of[s], []
            for t, a, b in plan:
                part, kt = msgs[t][:, a:b], self._card_of[t]
                if kt != ks:
                    src = self._cbuf(("halo", slot, t, s), part, kt)
                    dst = self._cbuf(("halo in", slot, t, s), part, ks)
                    src.copy_(part)
                    copies.append((src, kt, dst, ks))
                    part = dst
                parts.append(part)
            parts_of.append(parts)
        if copies:
            cs.cut(copies)
        return [torch.cat(parts, dim=1) if parts else msgs[s][:, :0]
                for s, parts in enumerate(parts_of)]

    def _card_replicas(self):
        """Each card's copies of the step's scalars, refreshed from the
        controller's (card 0's are the buffers themselves): dt (its
        minimum), the ramp counter, the averaging time and the forcing's
        mass-flux memory; and its body-force column and unit columns.
        Every card advances its copies as the controller advances its own,
        with the same arithmetic on the same values, so that no scalar
        crosses a card inside the step."""
        n = len(self._cards)
        if self._reps is None:
            zero = lambda x, k: torch.zeros_like(x, device=self._cards[k])
            bufs = dict(dt=self._dt_s, k=self._k, t_sim=self._t_sim,
                        mdot=self._mdot_old)
            self._reps = {name: [x] + [zero(x, k) for k in range(1, n)]
                          for name, x in bufs.items()}
            if self._forcing:
                self._reps["bf"] = [self._bf] + [zero(self._bf, k)
                                                 for k in range(1, n)]
                self._reps["e"] = [self._force_e] + [
                    tuple(e.to(self._cards[k]) for e in self._force_e)
                    for k in range(1, n)]
        for name in ("dt", "k", "t_sim", "mdot"):
            first = self._reps[name][0]
            for x in self._reps[name][1:]:
                x.copy_(first)

    def _bf_on(self, i, v):
        if self._cstep is None:
            return super()._bf_on(i, v)
        return self._reps["bf"][self._block_card(i)]

    def _step_body(self):
        """One step: BlockLoop's, or in a multi-card step the same program
        with its cross-card points as cuts."""
        if self._cstep is None:
            return super()._step_body()
        cs, dt = self._cstep, self._dt_s
        with tracing.part("step.pre"):
            if self._pre_step is not None:
                self._pre_step(self.u_soa)
            copies, rows, parts = [], None, None
            if self.turb_inlet is not None:
                rows = self._card_inlet_rows(copies)
            if self._forcing:
                parts = self._card_force_parts(copies)
            if copies:
                cs.cut(copies)
            if self.turb_inlet is not None:
                pos, sgn, _ = self._ti_state
                (new_pos, new_sgn, _), fluc = self.turb_inlet.update(
                    self._ti_state, torch.cat(rows, dim=1), dt)
                if new_pos is not pos:
                    pos.copy_(new_pos)
                    sgn.copy_(new_sgn)
                self._fluc.copy_(fluc)
                self._card_scatter_fluc()
            if self._forcing:
                self._card_body_force(parts)
        self._step(self.u_soa, self.reg_soa, self._dt_rk)
        if self._featured:
            with tracing.part("step.post"):
                reps = self._reps
                for t_sim, k, dt_k in zip(reps["t_sim"], reps["k"],
                                          reps["dt"]):
                    t_sim += dt_k
                    k += 1.0
                if self._avg:
                    self._card_average()

    def _card_force_parts(self, copies):
        """The forcing's plane integrals, each block's on its card in a
        persistent buffer, and the copies that give every card every
        block's (the JAX psum, sharding.py:1081-1082)."""
        views, parts = self._views(self.u_soa), {}
        for i, W, _, _ in self._force:
            ki = self._block_card(i)
            part = (W[:, None] * views[i][:, :2]).sum(dim=(0, 2))
            src = parts[i] = self._cbuf(("force", i), part, ki)
            src.copy_(part)
            for k in range(len(self._cards)):
                if k != ki:
                    copies.append((src, ki, self._cbuf(("force in", i, k),
                                                       part, k), k))
        return parts

    def _card_body_force(self, parts):
        """``_body_force`` on every card from every block's integrals,
        summed in block order as the controller sums them: the card's
        body-force column and mass-flux memory."""
        reps = self._reps
        for k in range(len(self._cards)):
            acc = None
            for i, _, _, _ in self._force:
                part = (parts[i] if self._block_card(i) == k
                        else self._cbufs[("force in", i, k)])
                acc = part if acc is None else acc + part
            reps["bf"][k].copy_(self._force_column(
                acc, reps["dt"][k], reps["mdot"][k], reps["e"][k]))

    def _card_average(self):
        """``_average`` with each card's copies of the averaging time and
        dt."""
        reps, coef = self._reps, {}
        for i, (u, avg) in enumerate(zip(
                self._views(self.u_soa),
                self._views(self.u_avg_soa, len(self.p.average_fields)))):
            k = self._block_card(i)
            if k not in coef:
                dt = reps["dt"][k]
                t_rel = reps["t_sim"][k] - self.p.spinup_time
                coef[k] = (t_rel <= dt, (t_rel - dt) / t_rel, dt / t_rel)
            self._average_block(u, avg, lambda: coef[k])

    def _make_run_chunk(self):
        """BlockLoop's chunk with every shard on one card; with shards on
        several, ``chunk(n_steps)``: one warm-up step, then the step
        captured per card (CardStep) and replayed, the cards' copies of
        the step's scalars refreshed first.  None on the CPU."""
        if len(self._cards) == 1:
            return super()._make_run_chunk()
        backend = self._card_backend
        if backend is None:
            if self.device.type != "cuda":
                return None
            backend = self._card_backend = CudaCards(self._cards)
        draws = None if self._ti_state is None else self._ti_state[2]
        key = (self._dt_kind, draws)
        if self._graph is not None and self._graph_key != key:
            self.release_graph()

        def chunk(n_steps):
            left = n_steps
            self._card_replicas()
            if self._graph is None and left > 0:
                with tracing.span("run.warm_up"):
                    gen = getattr(draws, "gen", None)
                    g = CardStep(backend, self, len(self._cards),
                                 [] if gen is None else [gen])
                    self._stage_draws()
                    g.warm_up(self._step_body)
                left -= 1
                with tracing.span("run.capture") as self._capture_span:
                    self._graph_launches = captured_launches(
                        lambda: g.capture(self._step_body))
                self._graph, self._graph_key = g, key
                self.captures += 1
                # a stand-in's capture runs the program and returns the
                # state; the copies follow it
                self._card_replicas()
            with tracing.span("run.replays"):
                for _ in range(left):
                    self._stage_draws()
                    self._graph.replay(self._step_body)
                    count_replay(self._graph_launches)
            self.replays += left
        return chunk

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

    @tracing.traced("sync_twin")
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

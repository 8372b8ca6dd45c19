"""Element-sharded runs of mixed-element and prism meshes:
ShardedMixedSolver.

Port of hifiles_tpu/parallel/mixed_sharding.py (:36-1094) on one
controller (soa_sharding.ShardedLoop), without its slot residual
(:574-828): every shard owns a near-balanced contiguous share of each
element type (:70-106), its types' sub-blocks side by side in a local slot
space, and the face stage of the mixed residual on that space, cut from
the single-device twin's global slot space (MixedMeshTables) with the halo
faces as a third face class.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..solver.bc import use_wm_of, wall_models_on
from ..solver.elements import MixedMeshTables
from ..solver.multiblock import (MixedSolver, build_mixed_wm_tables,
                                 mixed_bc_functions)
from ..solver.residual_mixed_soa import mixed_wm_index
from .soa_sharding import ShardSoaTables, ShardedLoop, shard_block, \
    shard_faces


class ShardedMixedSolver(ShardedLoop):
    """A MixedSolver whose elements are cut into ``len(devices)`` shards,
    shard s on ``devices[s]``, driven by one controller.  ``base`` is the
    single-device MixedSolver on ``devices[0]``, the twin the writers read
    and the driver takes its time step from (this solver, as the JAX one,
    has no compute_dt, hifiles_tpu/driver.py:171-174); ``gather_u`` gives
    the per-type (E_t, U_t, F) tuple of its ``u``; ``has_wm`` says
    whether a shard has wall-model tables.  Turbulent inlets
    raise, as in the JAX package (mixed_sharding.py:458-462)."""

    @tracing.traced("setup")
    def __init__(self, run_input, mesh, devices, dtype=torch.float64):
        if run_input.bc_list and run_input.LES and any(
                getattr(b, "inlet_type", 0) for b in run_input.bc_list):
            raise NotImplementedError(
                "hifiles_tpu_torch ShardedMixedSolver: turbulent inlets "
                "(SEM/white noise) on mixed-type meshes (the JAX "
                "ShardedMixedSolver refuses them)")
        devices = [torch.device(d) for d in devices]
        n = len(devices)
        with tracing.span("setup.twin"):
            base = MixedSolver(run_input, mesh, device=devices[0],
                               dtype=dtype)
        mt, cts = base.mt, base.cts
        ops_by_ct = base.ops_by_ct

        with tracing.span("setup.shards"):
            # per-type near-balanced contiguous partition over each type's
            # elements in ``sels`` order (mixed_sharding.py:77-106)
            loc_idx = np.zeros(mesh.n_cells, dtype=np.int64)
            shard_of_tl, eloc_of_tl, self.sizes_ct = {}, {}, {}
            self.owner_ct, self.pad_ct, self.E_loc = {}, {}, {}
            for ct in cts:
                sel = mt.sels[ct]
                loc_idx[sel] = np.arange(sel.size)
                q, extra = divmod(sel.size, n)
                sizes = q + (np.arange(n) < extra)
                cum = np.concatenate([[0], np.cumsum(sizes)])
                tl = np.arange(sel.size)
                shard_of_tl[ct] = np.searchsorted(cum, tl, side="right") - 1
                eloc_of_tl[ct] = tl - cum[shard_of_tl[ct]]
                El = int(sizes.max())
                owner = np.zeros((n, El), dtype=np.int64)
                pad = np.zeros((n, El))
                for s in range(n):
                    owner[s, :sizes[s]] = np.arange(cum[s], cum[s + 1])
                    owner[s, sizes[s]:] = cum[s] if sizes[s] else 0
                    pad[s, :sizes[s]] = 1.0
                self.sizes_ct[ct], self.owner_ct[ct] = sizes, owner
                self.pad_ct[ct], self.E_loc[ct] = pad, El

            # each shard's local slot space: its types' sub-blocks in cts
            # order, those with no element left out
            fpt_off = {ct: np.concatenate(
                [[0], np.cumsum(ops_by_ct[ct].n_fpts_per_face)]) for ct in cts}
            present = [[ct for ct in cts if self.sizes_ct[ct][s] > 0]
                       for s in range(n)]
            off_local = []
            for s in range(n):
                off, offs = 0, {}
                for ct in present[s]:
                    offs[ct] = off
                    off += int(self.sizes_ct[ct][s]) * ops_by_ct[ct].n_fpts
                off_local.append((offs, off))

        with tracing.span("setup.peers"):
            def side(ele, locf, perm=None):
                ct = int(mesh.ctype[ele])
                tl = int(loc_idx[ele])
                s, e = int(shard_of_tl[ct][tl]), int(eloc_of_tl[ct][tl])
                nfp = int(ops_by_ct[ct].n_fpts_per_face[locf])
                sl = (off_local[s][0][ct] + e * ops_by_ct[ct].n_fpts
                      + fpt_off[ct][locf] + np.arange(nfp))
                return s, (sl if perm is None else sl[perm])

            def gslots(ele, locf):
                ct = int(mesh.ctype[ele])
                nfp = int(ops_by_ct[ct].n_fpts_per_face[locf])
                return (mt.slot_off[ct] + loc_idx[ele] * ops_by_ct[ct].n_fpts
                        + fpt_off[ct][locf] + np.arange(nfp))

            ints, bdys, halos = shard_faces(base.conn, n, side, mt.pos_fpts,
                                            gslots)
            self.n_halo = max(len(h) for h in halos)

        with tracing.span("setup.shards"):
            nfp_max = mt.bdy_slot.shape[1]
            subs, tables, bc_fns, wm_index = [], [], [], []
            self.has_wm = False
            for s, dev in enumerate(devices):
                sub = {}
                for ct in present[s]:
                    ids = self.owner_ct[ct][s, :self.sizes_ct[ct][s]]
                    sub[ct] = (cts.index(ct), ids, shard_block(mt.blocks[ct],
                                                               ids))
                subs.append([sub[ct] for ct in present[s]])
                mt_s = _shard_mixed_tables(present[s], {ct: b for ct, (_, _, b)
                                                        in sub.items()},
                                           off_local[s], bdys[s], nfp_max)
                wm = (build_mixed_wm_tables(mt_s, use_wm_of(run_input,
                                                            mt_s.bdy_bcid))
                      if wall_models_on(run_input, mt_s.bdy_bcid) else None)
                self.has_wm |= wm is not None
                fns = (mixed_bc_functions(run_input, mt_s, base.rcfg, dev,
                                          dtype, wm) if bdys[s] else None)
                tables.append(ShardSoaTables(ints[s], bdys[s], halos[s],
                                             mt_s.n_slots, mt_s.norm_fpts))
                bc_fns.append(fns)
                wm_index.append(mixed_wm_index(mt_s, wm, dev))
            self._setup_shards(base, devices, subs, tables, bc_fns, wm_index)
            self._owners = [self.owner_ct[ct] for ct in cts]
        with tracing.span("setup.initial_state"):
            self.set_state(base.u, tuple(np.zeros_like(a)
                                         for a in base.u), 0.0)


def _shard_mixed_tables(cts, blocks, offs, bdys, nfp_max):
    """A MixedMeshTables of one shard's sub-blocks in its local slot
    space, with its boundary faces, for the boundary functions and the
    wall-model tables (multiblock.mixed_bc_functions,
    build_mixed_wm_tables); it holds no interior tables."""
    slot_off, n_slots = offs
    cat = lambda name: np.concatenate([getattr(blocks[ct], name)
                                       for ct in cts])
    bdy_slot = np.zeros((len(bdys), nfp_max), dtype=np.int64)
    bdy_mask = np.zeros((len(bdys), nfp_max))
    for k, (sl, _, _) in enumerate(bdys):
        bdy_slot[k, :sl.size] = sl
        bdy_mask[k, :sl.size] = 1.0
    return MixedMeshTables(
        cts=list(cts), blocks=blocks, sels=None, slot_off=slot_off,
        n_slots=n_slots, pos_fpts=cat("pos_fpts"), tdA_fpts=cat("tdA_fpts"),
        norm_fpts=cat("norm_fpts"), detjac_fpts=cat("detjac_fpts"),
        jginv_fpts=cat("jginv_fpts"), int_slot_l=None, int_slot_r=None,
        int_mask=None, bdy_slot=bdy_slot,
        bdy_bcid=np.array([b[1] for b in bdys], dtype=np.int64),
        bdy_mask=bdy_mask, slot_src=None, slot_sign=None)

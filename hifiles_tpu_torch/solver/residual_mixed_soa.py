"""Mixed-element-type SoA residual on torch: per-type (U_t, F, E_t) blocks
on one flat global slot space.

Port of hifiles_tpu/solver/residual_mixed_soa.py::make_mixed_residual_soa
(:282-865).  Each element type keeps its elements-minor block, and its
volume stages (the GEMMs and the hand volume kernel, volume.volume_tdisf)
run per block as on a single-type mesh.  The face stage runs once, on the
blocks' flux-point rows side by side: per type the opp_0 extrapolation
gives (F, E_t*Pf_t) rows, and concatenated in ``cts`` order these are
exactly MixedMeshTables' global slot numbering (slot_off[ct] +
loc*Pf_t + fpt, elements.py).  The masked points of every interior and
boundary face form one flat point axis, whatever the faces' sizes (tri and
quad faces of prisms; nfp 15 and 25 at p=4), read with index_select and
written back with index_copy_, each slot exactly once.  The JAX module's
TPU machinery (the face-shape pools and groups, the sel encoding and the
run caps) has no counterpart: the flat tables need neither groups nor a
group cap.

The boundary side works on the same flat axis: one plane column per
boundary point, each carrying its face's group, wall-model flag and
distance (multiblock.mixed_bc_functions).
"""

from __future__ import annotations

import numpy as np
import torch

from .elements import MixedMeshTables
from .residual import ResidualConfig
from .residual_soa import (BlockStages, FaceArrays, Physics, check_coverage,
                           config_missing, make_face_residual)


def bdy_point_faces(mt: MixedMeshTables) -> np.ndarray:
    """The boundary face of each boundary point, in the flat point order
    of MixedSoaTables.slot_b (face by face, the points of a face in
    order)."""
    return np.nonzero(mt.bdy_mask > 0)[0]


class MixedSoaTables:
    """Flat point tables of a mixed mesh's faces in its global slot space.

    ``slot_l``/``slot_r`` (Ni,): the paired flux points of the interior
    faces, the L side as MixedMeshTables gives it (the JAX mixed path
    swaps no sides, residual_mixed_soa.py:110-132); ``slot_b`` (1, Nb):
    the boundary points.  The face planes are flat, and the face normals
    are per point (nothing compresses)."""

    compress = False

    def __init__(self, mt: MixedMeshTables):
        ml = mt.int_mask > 0
        self.slot_l = mt.int_slot_l[ml]
        self.slot_r = mt.int_slot_r[ml]
        self.slot_b = mt.bdy_slot[mt.bdy_mask > 0][None, :]
        check_coverage([self.slot_l, self.slot_r, self.slot_b], mt.n_slots)
        self.norm_fpts = mt.norm_fpts


def make_mixed_residual_soa(mt: MixedMeshTables, cfg: ResidualConfig, device,
                            dtype, bc_fns=None, wm_tables=None):
    """Build residual(us, fluc=None, ramp=None, out=None) over the per-type
    (U_t, F, E_t) states ``us`` (a sequence in ``mt.cts`` order) -> the
    per-type right-hand sides, written into ``out`` if given.  ``bc_fns``
    (multiblock.mixed_bc_functions) gives the boundary points' common
    values; ``wm_tables`` (multiblock.build_mixed_wm_tables) the
    wall-model input points.  Raises NotImplementedError, naming the
    cause, for configurations the port does not cover yet."""
    blocks = [mt.blocks[ct] for ct in mt.cts]
    d = blocks[0].ops.n_dims
    missing = config_missing(cfg, d, blocks, mt.bdy_slot.size > 0, bc_fns)
    if missing:
        raise NotImplementedError("hifiles_tpu_torch mixed residual: not "
                                  "ported yet: " + ", ".join(missing))
    ph = Physics(cfg, d)
    FA = FaceArrays(MixedSoaTables(mt), device, dtype)
    stages = [BlockStages(b, ph, device, dtype) for b in blocks]
    # the blocks' rows side by side are MixedMeshTables' slot numbering
    offs = np.cumsum([0] + [k.n_slots for k in stages])
    assert [int(offs[i]) for i in range(len(blocks))] == \
        [mt.slot_off[ct] for ct in mt.cts] and offs[-1] == mt.n_slots
    wm_index = None
    if wm_tables is not None:
        # per type: the boundary points of its wall-modelled faces, and
        # each point's element and solution point (its face's)
        per_ct, _ = wm_tables
        face = bdy_point_faces(mt)
        t = lambda a: torch.as_tensor(a, device=device)
        wm_index = []
        for ct in mt.cts:
            faces, ele, upt = per_ct[ct]
            row = -np.ones(mt.bdy_bcid.size, dtype=np.int64)
            row[faces] = np.arange(faces.size)
            cols = np.nonzero(row[face] >= 0)[0]
            j = row[face[cols]]
            wm_index.append((t(cols), t(ele[j]), t(upt[j])) if cols.size
                            else (None, None, None))
    return make_face_residual(stages, FA, ph, bc_fns, wm_index)

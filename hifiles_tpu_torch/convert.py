"""Exchange between the JAX package and the port.

The JAX solver exposes its state as (E, U, F) arrays, and its MixedSolver
as a tuple of (E_t, U_t, F) arrays, one per element type in ``sels``
order; the port steps elements-minor (U, F, E) states.  ``run_input_from`` and ``mesh_from`` turn
the JAX package's RunInput and MeshData into the port's own copies of those
types, attribute by attribute (numpy arrays copied), without importing the
JAX package: the port's Solver takes only its own types.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .config.deck import Deck
from .config.params import BCParams, RunInput
from .mesh.core import MeshData


def _copy_attrs(src, dst):
    """Every instance attribute of ``src`` (dataclass fields and the ones
    set on it later, e.g. by a deck's setup) onto ``dst``; numpy arrays
    and lists are copied, so the two objects share no mutable state."""
    for name, val in vars(src).items():
        setattr(dst, name, copy.deepcopy(val))
    return dst


def run_input_from(p) -> RunInput:
    """The port's RunInput equal to another package's RunInput ``p``
    (its boundary list and parsed deck included)."""
    out = RunInput()
    for name, val in vars(p).items():
        if name == "bc_list":
            val = [_copy_attrs(bc, BCParams(name=bc.name)) for bc in val]
        elif name == "_deck" and val is not None:
            deck = Deck("", name=val.name)
            deck._lines = copy.deepcopy(val._lines)
            val = deck
        else:
            val = copy.deepcopy(val)
        setattr(out, name, val)
    return out


def mesh_from(mesh) -> MeshData:
    """The port's MeshData equal to another package's MeshData ``mesh``."""
    return _copy_attrs(mesh, MeshData(n_dims=mesh.n_dims, xv=None, c2v=None,
                                      c2n_v=None, ctype=None, bc_id=None))


def euf_to_ufe(a, device, dtype):
    """One (E, U, F) numpy array -> a (U, F, E) tensor."""
    return torch.as_tensor(
        np.ascontiguousarray(np.transpose(np.asarray(a), (1, 2, 0))),
        dtype=dtype, device=device)


def state_from_numpy(u_euf, reg_euf, device, dtype):
    """(E, U, F) numpy state and RK register -> (U, F, E) tensors."""
    return euf_to_ufe(u_euf, device, dtype), euf_to_ufe(reg_euf, device,
                                                         dtype)


def ufe_to_euf(t):
    """One (U, F, E) tensor -> (E, U, F) numpy."""
    return np.ascontiguousarray(t.detach().cpu().numpy().transpose(2, 0, 1))


def state_to_numpy(u_ufe, reg_ufe):
    """(U, F, E) tensors -> (E, U, F) numpy state and RK register."""
    return ufe_to_euf(u_ufe), ufe_to_euf(reg_ufe)


def states_from_numpy(us, device, dtype):
    """A mixed state, (E_t, U_t, F) arrays per element type (e.g. the JAX
    MixedSolver's ``u``) -> a tuple of (U_t, F, E_t) tensors."""
    return tuple(euf_to_ufe(a, device, dtype) for a in us)


def states_to_numpy(ts):
    """(U_t, F, E_t) tensors per element type -> (E_t, U_t, F) numpy."""
    return tuple(ufe_to_euf(t) for t in ts)

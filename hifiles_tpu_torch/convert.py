"""State exchange between the JAX package and the port.

The JAX solver exposes its state as (E, U, F) arrays; the port steps an
elements-minor (U, F, E) state.  The element block needs no conversion:
both packages build it with the same numpy host code.
"""

from __future__ import annotations

import numpy as np
import torch


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

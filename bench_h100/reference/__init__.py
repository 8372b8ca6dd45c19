"""The benchmark's plain reference of the program: ``fr_hex`` (the scheme
on a structured box of hexes, plain PyTorch) and ``deck`` (its reading of
a configuration's deck).  It imports nothing of the program or of JAX and
takes nothing the program made: it is handed the deck, the box and the
initial state the benchmark made, and works out everything else itself.
"""

from __future__ import annotations

import numpy as np
import torch

from .deck import physics
from .fr_hex import Box, FRHex, kinetic_energy


def advance(deck: dict, box: Box, u0, steps: int, device, dtype=torch.float64,
            tf32=False) -> dict:
    """The state after ``steps`` steps from ``u0`` (numpy, (5, Ez, Ey, Ex,
    kz, ky, kx)), the monitor's L1 residual row there, its kinetic energy
    where the deck's monitor integrates it (else None), and the running
    averages (or None), as float64 numpy; ``dtype`` and ``tf32`` set the
    arithmetic (the lower-precision control: float32 with TF32 operator
    products, and so its kinetic energy's quadrature)."""
    ph = physics(deck)
    fr = FRHex(box, ph, device, dtype, tf32)
    with torch.no_grad():
        run = fr.initial(torch.as_tensor(u0, dtype=dtype, device=device))
        for _ in range(steps):
            fr.step(run)
        row = fr.residual_row(run["u"])
        out = dict(u=run["u"].double().cpu().numpy(),
                   row=np.asarray(row, dtype=np.float64),
                   ke=(kinetic_energy(run["u"], box.h, tf32)
                       if "kineticenergy" in ph["integrals"] else None),
                   avg=None if run["avg"] is None
                   else run["avg"].double().cpu().numpy())
    del run, fr
    return out

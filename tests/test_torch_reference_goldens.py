"""The reference HiFiLES binary's goldens that the PyTorch port
(hifiles_tpu_torch) holds on the CPU at f64, at the tolerances of
tests/test_regression_reference.py: the iter-25 L1 monitor row of the
8^3 hex box with over-integration (OVERINT_GOLD, :318-330) and of the
curved quadratic cells, 20-node serendipity hexes through Solver
(HEX20_CURVED_GOLD, :418-430) and 15-node prisms through MixedSolver
(PRISM15_CURVED_GOLD, :439-452).  The residual row is the last RK stage's,
as the reference's monitor reports it (chip_smoke.last_stage_residual)."""

import os
import sys

import numpy as np
import pytest
import torch

from hifiles_tpu.config.params import RunInput
from hifiles_tpu.mesh.generate import (periodic_curved_hex20_mesh,
                                       periodic_curved_prism15_mesh,
                                       periodic_hex_mesh)

import hifiles_tpu_torch
from hifiles_tpu_torch.convert import mesh_from, run_input_from

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(__file__)))
from chip_smoke import last_stage_residual  # noqa: E402
from test_regression_reference import (HEX20_CURVED_GOLD,  # noqa: E402
                                       OVERINT_GOLD, PRISM15_CURVED_GOLD)

torch.set_num_threads(1)

DECKS = os.path.join(os.path.dirname(__file__), "decks")

GOLDENS = {
    "overint_hex8": (hifiles_tpu_torch.Solver, "input_tgv8_overint_25",
                     lambda: periodic_hex_mesh(8, 8, 8), OVERINT_GOLD,
                     lambda g: np.full_like(g, 1e-5)),
    "hex20_curved": (hifiles_tpu_torch.Solver, "input_hex20_curved_25",
                     lambda: periodic_curved_hex20_mesh(3, 3, 3),
                     HEX20_CURVED_GOLD, lambda g: np.full_like(g, 1e-5)),
    "prism15_curved": (hifiles_tpu_torch.MixedSolver,
                       "input_prism15_curved_25",
                       lambda: periodic_curved_prism15_mesh(3, 3, 3),
                       PRISM15_CURVED_GOLD,
                       lambda g: 2e-4 * np.maximum(0.05, g)),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_reference_golden(case):
    """The L1 monitor row against the reference binary's, f64."""
    cls, deck, mesh, gold, tol = GOLDENS[case]
    p = RunInput.from_deck(os.path.join(DECKS, deck))
    s = cls(run_input_from(p), mesh_from(mesh()), device="cpu")
    res = s.residual_norm(1, last_stage_residual(s, 25, p.dt))
    gold = np.asarray(gold)
    assert np.all(np.abs(res - gold) < tol(gold)), \
        (case, list(res), list(gold))

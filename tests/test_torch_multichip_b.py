"""The multi-device dry run of the port on the CPU in f64, continued from
tests/test_torch_multichip.py (whose helpers it takes): the channel,
tri+quad and prism/tet legs after 3 steps against the JAX package's
ShardedSolver and ShardedMixedSolver on the conftest's 8 virtual CPU
devices, within 1e-10 * max(scale, 1) (the channel's averages too), and
the channel, p1, tri+quad and prism/tet legs' steps, 8 shards on 4
stand-in cards captured per card, against their eager sharded steps, bit
for bit."""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_multichip import leg_against_jax, leg_segmented  # noqa

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["channel", "mixed", "mixed3d"])
def test_leg_matches_jax_sharded(name):
    leg_against_jax(name)


@pytest.mark.parametrize("name", ["channel", "p1", "mixed", "mixed3d"])
def test_leg_segmented_step_equals_eager(name, monkeypatch):
    leg_segmented(name, monkeypatch)

"""Element-sharded runs: ShardedSolver and ShardedMixedSolver, one
controller driving N shards of the mesh (soa_sharding.py), and
``select_devices``, which places the shards on the cards."""

from __future__ import annotations

import torch

from ..backend import select_device
from .mixed_sharding import ShardedMixedSolver
from .sharding import ShardedSolver

__all__ = ["ShardedMixedSolver", "ShardedSolver", "select_devices"]


def select_devices(n_shards: int, device="cuda") -> list:
    """The device of each of ``n_shards`` shards, the counterpart of the
    JAX package's provision_devices (hifiles_tpu/parallel/__init__.py:
    8-38): "cuda" places them round-robin over the visible cards,
    "cuda:i" all on card i, several shards to a card when there are more
    shards than cards; "cpu" puts them on the CPU, which only an explicit
    "cpu" selects.  Raises when CUDA is asked for and missing; the
    placement is printed."""
    if n_shards < 1:
        raise ValueError(f"--devices {n_shards}: at least one shard")
    dev = select_device(device)
    if dev.type == "cuda" and torch.device(device).index is None:
        k = torch.cuda.device_count()
        devices = [torch.device("cuda", s % k) for s in range(n_shards)]
    else:
        devices = [dev] * n_shards
    print(f"shards: {n_shards} on "
          + ", ".join(f"{d} x{devices.count(d)}"
                      for d in dict.fromkeys(devices)))
    return devices

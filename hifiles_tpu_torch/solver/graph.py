"""One time step captured as a CUDA graph: the port's compiled run chunk.

The JAX package runs its steps through one program compiled per chunk,
``jax.jit(self._make_run_chunk(), ...)`` (hifiles_tpu/solver/solver.py:273,
a ``lax.scan`` over the steps, :289-319 and :380-482; MixedSolver's chunk
at multiblock.py:724-840).  Eager PyTorch issues every kernel of a step
from Python, 154 to 5,028 launches per RK stage, and the card waits on the
host.  ``CudaStepGraph`` records one whole step once
(``torch.cuda.CUDAGraph``: the aten kernels, the cuBLAS GEMMs and the hand
volume kernel, launched through ctypes on the capturing stream) and
launches it again with one call per step.

A capture runs nothing: the kernels are recorded with the addresses of
their operands, so the step must read and write buffers that outlive the
capture and are never rebound (solver.BlockLoop's step buffers), and it
must make no host sync, which would break the capture; the capture runs
under ``torch.cuda.set_sync_debug_mode("error")`` to name the op that
does.  Random draws from a registered ``torch.Generator`` advance on
every replay.  Each graph keeps its intermediates in a memory pool of its
own until ``release``.
"""

from __future__ import annotations

import torch


class CudaStepGraph:
    """The capture and replay of one step on ``device``, its draws from
    the ``generators`` registered with the graph.  ``warm_up(body)`` runs
    the step eagerly on the capture stream (its first launches load the
    kernels' modules and cuBLAS's workspace for that stream);
    ``capture(body)`` records it; ``replay()`` launches it on the current
    stream."""

    def __init__(self, device, generators=()):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)

    def warm_up(self, body):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            body()
        current.wait_stream(self.stream)

    def capture(self, body):
        with torch.cuda.graph(self.graph, stream=self.stream):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                body()
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    def replay(self):
        self.graph.replay()

    def release(self):
        self.graph.reset()

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
does.  Nor may Python's cycle collector run inside it: PyTorch no
longer collects garbage before a capture, and a dead cycle (an earlier
solver and its graph) collected mid-capture frees CUDA objects there,
from destructors that only warn of a CUDA error, and the capture then
fails at its end; ``quiet_collector`` keeps the collector off until the
capture ends.  Random draws from a registered ``torch.Generator`` advance on
every replay.  Each graph keeps its intermediates in a memory pool of its
own until ``release``.  ``count_nodes`` reads the node count of the graph
being captured (the kernel library's hft_graph_nodes), which the
program's tracing reads inside a capture so that each part of the step
(tracing.part) knows its nodes.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc

import torch

from ..backend import kernel_library


@contextlib.contextmanager
def quiet_collector():
    """Keep Python's cycle collector off until the block ends (a
    capture: see the module's docstring)."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class CudaStepGraph:
    """The capture and replay of one step on ``device``, its draws from
    the ``generators`` registered with the graph.  ``warm_up(body)`` runs
    the step eagerly on the capture stream (its first launches load the
    kernels' modules and cuBLAS's workspace for that stream);
    ``capture(body)`` records it; ``replay()`` launches it on the current
    stream; ``count_nodes()``, inside a capture, reads the graph's node
    count so far."""

    def __init__(self, device, generators=()):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)

    def count_nodes(self):
        """The node count of the graph the capture stream records."""
        fn = kernel_library().hft_graph_nodes
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_longlong
        n = fn(self.stream.cuda_stream)
        if n < 0:
            raise RuntimeError(f"hft_graph_nodes: {n} (the stream is not "
                               "capturing, or a CUDA error)")
        return n

    def warm_up(self, body):
        current = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            body()
        current.wait_stream(self.stream)

    def capture(self, body):
        with quiet_collector(), torch.cuda.graph(self.graph,
                                                 stream=self.stream):
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


_PEERS = set()


def enable_peers(devices):
    """Enable peer access between every ordered pair of the cards
    ``devices`` (once per pair and process, in the kernel library's
    runtime: the cards' primary contexts, which PyTorch uses too) and print
    the access matrix; raises where a pair has none, since a copy between
    them would be staged through the host."""
    lib = kernel_library()
    lib.hft_peer_enable.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hft_peer_enable.restype = ctypes.c_int
    idx = [torch.device(d).index for d in devices]
    todo = [(a, b) for a in idx for b in idx
            if a != b and (a, b) not in _PEERS]
    if not todo:
        return
    for a, b in todo:
        with torch.cuda.device(a):
            rc = lib.hft_peer_enable(a, b)
        if rc != 1:
            raise RuntimeError(f"card {a} cannot read card {b}'s memory "
                               f"(hft_peer_enable: {rc}): no peer access, "
                               "so the halo copies would go through the "
                               "host")
        _PEERS.add((a, b))
    rows = ["".join("x" if a == b or (a, b) in _PEERS else "."
                    for b in idx) for a in idx]
    print(f"peer access between cards {idx}: {' '.join(rows)}")


class CudaCards:
    """The cards of a multi-card step (parallel.cards.CardStep): on each
    card a capture stream and one memory pool (``graph_pool_handle``)
    shared by all its segments' graphs, which are captured one after
    another and replayed in that order, so the pool's blocks pass safely
    from one segment to the next; events; and the peer copies of the
    halos, issued through the kernel library on the destination card's
    stream (a memcpy node of the graph being captured there).  Peer
    access is enabled for every pair on construction (enable_peers)."""

    rerun = None

    def __init__(self, devices):
        from .volume import _library
        self.devices = [torch.device(d) for d in devices]
        enable_peers(self.devices)
        for dev in self.devices:
            _library(dev)    # hft_volume_prepare, before any capture
        self.streams = [torch.cuda.Stream(d) for d in self.devices]
        self.pools = [torch.cuda.graph_pool_handle() for _ in self.devices]
        self._saved = None
        self._copy = kernel_library().hft_peer_copy
        self._copy.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_size_t,
                               ctypes.c_void_p]
        self._copy.restype = ctypes.c_int

    def current(self, k):
        return torch.cuda.current_stream(self.devices[k])

    def event(self):
        return torch.cuda.Event()

    def graph(self, k, generators=()):
        g = torch.cuda.CUDAGraph()
        for gen in generators:
            g.register_generator_state(gen)
        return g

    def sync(self):
        for dev in self.devices:
            torch.cuda.synchronize(dev)

    def enter(self, capture):
        """Make each card's capture stream its current stream (after the
        work on the current ones), with host syncs refused and the cycle
        collector off while ``capture``."""
        self._saved = [torch.cuda.current_stream(d) for d in self.devices]
        for dev, s, cur in zip(self.devices, self.streams, self._saved):
            s.wait_stream(cur)
            with torch.cuda.device(dev):
                torch.cuda.set_stream(s)
        self._mode = torch.cuda.get_sync_debug_mode()
        self._quiet = None
        if capture:
            self._quiet = quiet_collector()
            self._quiet.__enter__()
            torch.cuda.set_sync_debug_mode("error")

    def leave(self):
        torch.cuda.set_sync_debug_mode(self._mode)
        if self._quiet is not None:
            self._quiet.__exit__(None, None, None)
            self._quiet = None
        for dev, s, cur in zip(self.devices, self.streams, self._saved):
            with torch.cuda.device(dev):
                torch.cuda.set_stream(cur)
            cur.wait_stream(s)
        self._saved = None

    def begin(self, k, graph):
        with torch.cuda.device(self.devices[k]):
            graph.capture_begin(pool=self.pools[k],
                                capture_error_mode="relaxed")

    def end(self, k, graph):
        with torch.cuda.device(self.devices[k]):
            graph.capture_end()

    def copy(self, dst, kd, src, ks):
        """``src`` (card ``ks``) into ``dst`` (card ``kd``), contiguous
        tensors of one size, on card kd's current stream: a
        cudaMemcpyAsync between the cards' unified addresses (the
        library's hft_peer_copy), a memcpy node when the stream captures,
        over NVLink."""
        dd = self.devices[kd]
        with torch.cuda.device(dd):
            rc = self._copy(
                dst.data_ptr(), dd.index, src.data_ptr(),
                dst.numel() * dst.element_size(),
                torch.cuda.current_stream(dd).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"peer copy {self.devices[ks]} -> {dd} "
                               f"failed: CUDA error {rc}")

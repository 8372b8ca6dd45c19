"""The program's own spans and counters, on the host clock that
``time.perf_counter_ns`` reads.

``span(name)`` times a block of the program.  Spans nest: each records
its name, its parent and its start and end in nanoseconds.  The record
lives in memory and is bounded: a per-name aggregate (count, total ns,
max ns) that is never evicted, and a ring of the last ``RING`` spans
with their parents.  A span opened inside an open span of its own name
(the driver's ``monitor`` around the history writer's) goes into the
ring but not into the aggregate, which already times it.

While a torch.profiler session is active, a span also opens a profiler
range ``hf.<name>``, so that a profiler's timeline, the device trace's
clock, shows the program's spans over the device operations.  The range
is a function-scope one (``_RecordFunctionFast``): the profiler shows it
on the host's timeline only, where ``record_function``'s user annotation
also lays a copy of itself over the card's timeline, which a reader of
the device operations would count as one.  Whether a profiler is active
is one attribute read; without one a span creates no range and no CUDA
event and never waits for the card.

``part(name)`` is a span around a part of the step that a CUDA graph
captures: a replay runs no host code, so a replayed operation can only be
told apart by its place in the graph.  While a capture is in progress
(``capture(count_nodes)``, which the step graph opens around the
captured step), a part also reads the graph's node count at its start
and end; on one stream each captured operation depends on the one before
it, so the parts' node ranges, in order, say which part each device
operation of a replay belongs to.  Each capture is kept with its node
count (also the counter ``captured_nodes``) and its parts' ranges.
Parts do not nest, and no part stays open across a ``yield`` of the
residual's stage generator.

The program's counters sit in the record too (``counters``:
``captured_nodes``; ``boundary_faces``, the boundary faces of the step's
face stage, set by ``counter`` at set-up), and so do the launches of the
hand kernels (``launches``).  A kernel module registers each of its
kernels (``kernel``); every launch of one (backend.call, the one place
that calls a kernel's C entry) counts by its variant, and K1's launches
also by the shapes of the segments they carry (``launch``).  A launch
inside a capture runs nothing: it is kept with the capture, whose context
gives the capture's launches, and each replay of the captured step
counts them (``replay``).  The captures and replays of a run are counted
on the solver (``captures``, ``replays``).

The record is the process's: the program is single-threaded, and the
spans of one thread nest.  ``record()`` reads it, ``reset()`` empties it
(``reset(launches_only=True)`` zeroes the launch counts alone).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import time

import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

RING = 4096        # spans kept with their parents
CAPTURES = 64      # captures kept with their parts' node ranges

_perf_ns = time.perf_counter_ns

Span = collections.namedtuple("Span", "id name parent start_ns end_ns")
Span.__doc__ = """One closed span: its sequence number, name, its
parent's sequence number (None at the top), start and end (ns)."""


class _Record:
    """The spans, aggregates, counters and captures of the process."""

    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.totals = {}            # name -> [count, total ns, max ns]
        self.counters = {}
        self.captures = collections.deque(maxlen=CAPTURES)
        self.stack = []             # the open spans, innermost last
        self.next_id = 0
        self.capture = None         # (count_nodes, parts) while capturing
        self.kernels = {}           # name -> (number, segments)
        self.launches = {}          # name -> its launch counts
        self.held = None            # a capture's launch counts, capturing


_rec = _Record()


class _Open:
    """An open span; its ``start_ns`` and ``end_ns`` stay readable after
    it closes."""

    __slots__ = ("name", "is_part", "id", "parent", "start_ns", "end_ns",
                 "nested", "range", "node0")

    def __init__(self, name, is_part=False):
        self.name, self.is_part = name, is_part

    @property
    def seconds(self):
        return (self.end_ns - self.start_ns) * 1e-9

    def __enter__(self):
        r = _rec
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _RecordFunctionFast("hf." + self.name)
            self.range.__enter__()
        stack = r.stack
        self.parent = stack[-1].id if stack else None
        self.nested = any(s.name == self.name for s in stack)
        self.id = r.next_id
        r.next_id += 1
        stack.append(self)
        self.node0 = (r.capture[0]() if self.is_part and r.capture
                      else None)
        self.start_ns = _perf_ns()
        return self

    def __exit__(self, *exc):
        end = self.end_ns = _perf_ns()
        r = _rec
        if self.node0 is not None and r.capture is not None:
            r.capture[1].append((self.name, self.node0, r.capture[0]()))
        r.stack.pop()
        r.ring.append(Span(self.id, self.name, self.parent, self.start_ns,
                           end))
        if not self.nested:
            agg = r.totals.get(self.name)
            ns = end - self.start_ns
            if agg is None:
                r.totals[self.name] = [1, ns, ns]
            else:
                agg[0] += 1
                agg[1] += ns
                if ns > agg[2]:
                    agg[2] = ns
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str) -> _Open:
    """A context manager timing its block as the span ``name``; ``as``
    gives the span, whose ``seconds`` read its length once closed."""
    return _Open(name)


def part(name: str) -> _Open:
    """A span around a part of the captured step (see the module's
    docstring): inside a capture it also records the part's node range."""
    return _Open(name, True)


def traced(name: str):
    """Decorate a function to run inside the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with _Open(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def counter(name: str, value) -> None:
    """Set the program's counter ``name`` to ``value``."""
    _rec.counters[name] = value


@contextlib.contextmanager
def capture(count_nodes):
    """Around the capture of a step graph, while the stream captures:
    ``count_nodes()`` reads the node count of the graph being captured
    (the kernel library's hft_graph_nodes on the card; a stand-in on the
    CPU).  Inside, each part records its node range; at the end the
    graph's node count is read, and the capture kept with its parts'
    ranges (``record()["captures"]``) and its count as the counter
    ``captured_nodes``.  A capture that raises is not kept, and with
    ``count_nodes`` None (a graph that cannot count) nothing is.  Either
    way the hand kernels' launches inside are not counted but held: the
    context gives them, for ``replay``."""
    r = _rec
    parts, held = [], {}
    saved = r.capture, r.held
    if count_nodes is not None:
        r.capture = (count_nodes, parts)
    r.held = held
    start = _perf_ns()
    try:
        yield held
        nodes = None if count_nodes is None else count_nodes()
    finally:
        r.capture, r.held = saved
    if count_nodes is not None:
        r.captures.append(dict(start_ns=start, nodes=nodes, parts=parts))
        r.counters["captured_nodes"] = nodes


def _zero(segments):
    """A kernel's launch counts at 0: ``launches`` and ``by_variant``;
    with ``segments``, also ``segments``, ``by_shape`` ((variant, U, E) of
    each segment) and ``by_group`` ((variant, its segments' sorted (U, E))
    of each launch)."""
    c = dict(launches=0, by_variant=collections.Counter())
    if segments:
        c.update(segments=0, by_shape=collections.Counter(),
                 by_group=collections.Counter())
    return c


def kernel(name: str, number: int, segments: bool = False) -> None:
    """Register the hand kernel ``name``, K<number> of the port's kernels
    (``record()["launches"]`` lists them by number, then in the order
    registered), whose launches carry segments when ``segments``."""
    _rec.kernels[name] = (number, segments)
    _rec.launches.setdefault(name, _zero(segments))


def launch(name: str, variant: str, shapes=None) -> None:
    """Count one launch of the registered kernel ``name`` computing
    ``variant``, with the (U, E) of its segments ``shapes`` for a kernel
    of segments; inside a capture, hold it with the capture instead."""
    r = _rec
    held = r.held
    if held is None:
        c = r.launches[name]
    else:
        c = held.get(name)
        if c is None:
            c = held[name] = _zero(r.kernels[name][1])
    c["launches"] += 1
    c["by_variant"][variant] += 1
    if shapes is not None:
        c["segments"] += len(shapes)
        c["by_shape"].update((variant, U, E) for U, E in shapes)
        c["by_group"][(variant, tuple(sorted(shapes)))] += 1


def replay(held) -> None:
    """Count one replay of a captured step: the launches ``held`` that its
    capture's context gave."""
    for name, h in held.items():
        c = _rec.launches[name]
        for key, n in h.items():
            if isinstance(n, int):
                c[key] += n
            else:
                c[key].update(n)


def record() -> dict:
    """A copy of the record: ``spans``, the ring's closed spans (Span,
    oldest first); ``totals``, name -> (count, total ns, max ns);
    ``counters``; ``captures``, each a dict of its ``start_ns``,
    ``nodes`` (the graph's node count at the capture's end) and
    ``parts``, [(part, first node, end node)] in capture order;
    ``launches``, kernel -> its launch counts (``_zero``'s keys, the
    counters as dicts), every registered kernel in order."""
    r = _rec
    order = sorted(r.launches, key=lambda k: r.kernels[k][0])
    return dict(spans=list(r.ring),
                totals={k: tuple(v) for k, v in r.totals.items()},
                counters=dict(r.counters),
                captures=[dict(c, parts=list(c["parts"]))
                          for c in r.captures],
                launches={k: {key: n if isinstance(n, int) else dict(n)
                              for key, n in r.launches[k].items()}
                          for k in order})


def reset(launches_only: bool = False) -> None:
    """Empty the record; spans still open are recorded when they close.
    With ``launches_only``, zero the hand kernels' launch counts alone and
    keep the spans, counters and captures (set-up's among them)."""
    r = _rec
    if not launches_only:
        r.ring.clear()
        r.totals.clear()
        r.counters.clear()
        r.captures.clear()
    for name, (_, segments) in r.kernels.items():
        r.launches[name] = _zero(segments)

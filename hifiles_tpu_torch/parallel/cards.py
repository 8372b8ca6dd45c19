"""Shards on several cards, captured on each card: the step of an
element-sharded run cut at its cross-card points.

The JAX package runs a sharded step as one compiled program across its
devices (``ShardedSolver``'s jitted ``lax.scan`` inside ``shard_map``,
hifiles_tpu/parallel/sharding.py:1179-1263), the halos moving by
``lax.ppermute`` (soa_sharding.py:474-478) and the forcing's plane sums
by ``lax.psum`` (sharding.py:1081-1082).  One CUDA graph cannot take work
from another card's stream, so the port cuts the step at its cross-card
points (``CardStep.cut``): the two halo exchanges of every RK stage, and
on a featured run the forcing's plane sums (each card sums every block's
part itself, in block order, so no column goes back) and the inlet's
rows and fluctuations.  Between two cuts each card's work is one segment,
captured on that card's capture stream into a graph of its own; all of a
card's segments share one memory pool.  At a cut the copies from card to
card are peer copies over NVLink, recorded at the start of the receiving
card's next segment; their sources and destinations are persistent step
buffers (never temporaries of a pool), written by the program just
before the cut.

A replay issues, segment by segment, on every card: its waits, its graph,
one event record.  The host makes no sync and runs ahead of the cards.
How the hazards are handled:
  * when a wait binds: ``cudaStreamWaitEvent`` waits for the record the
    host had issued when it made the call, so the host issues segment j
    (and its record) on every card before any card's segment j+1; one
    event per card and segment, no event nodes inside the graphs (with
    mutual waits a card launched first would wait on its peer's record
    from the step before);
  * read after write: segment j+1 on a card waits on segment j of every
    card it receives from at cut j;
  * write after read: a source buffer written in segment j (the one that
    cut j ends) was last read by its receivers at the start of the
    segment after its previous cut; segment j waits on those readers'
    events too, explicitly, whether or not the ring's symmetry already
    orders them (``card_waits``);
  * one wait per neighbouring card and segment: of the events a segment
    needs from one card it waits on the latest, which follows the others
    on that card's stream; never on its own card's, which its stream
    orders.
The cards are given by a backend: graph.CudaCards on the card; a test
gives stand-ins with ``rerun``, under which a replay runs the program
again and the cuts issue the schedule of the segment they end.
"""

from __future__ import annotations


def card_waits(cuts, n_cards):
    """The waits of each segment of a step cut by ``cuts`` (per cut, its
    copies as (source key, source card, destination card)): per segment j
    (0 .. len(cuts)) and card k, [(card r, segment i)], the events of the
    other cards that segment j on card k waits on, latest per card.  An
    event of a segment at or after j is the previous step's record."""
    n_seg = len(cuts) + 1
    waits = [[{} for _ in range(n_cards)] for _ in range(n_seg)]
    uses = {}
    for c, copies in enumerate(cuts):
        for key, ks, kd in copies:
            uses.setdefault(key, {}).setdefault(c, set()).add(kd)

    def need(j, k, r, i):
        if r == k:
            return
        # the previous step's records (i >= j) come before this step's
        order = (0, i) if i < j else (-1, i)
        have = waits[j][k].get(r)
        if have is None or order > have[0]:
            waits[j][k][r] = (order, i)

    for j in range(n_seg):
        # read after write: the copies at the start of segment j
        if j > 0:
            for _, ks, kd in cuts[j - 1]:
                need(j, kd, ks, j - 1)
        # write after read: the sources segment j writes for cut j
        if j < len(cuts):
            for key, ks, _ in cuts[j]:
                cs = sorted(uses[key])
                prev = [c for c in cs if c < j]
                p = prev[-1] if prev else cs[-1]
                for r in uses[key][p]:
                    need(j, ks, r, p + 1)
    return [[sorted((r, i) for r, (_, i) in w.items()) for w in seg]
            for seg in waits]


class CardStep:
    """The captured step of a run whose shards sit on several cards.

    ``backend`` gives the cards (graph.CudaCards, or a test's stand-ins);
    ``owner`` is the solver whose ``_step_body`` runs the program and
    calls ``cut`` at each cross-card point while this step drives it
    (``owner._cstep``); ``generators`` (card 0's) are registered with card
    0's graphs.  ``warm_up(body)`` runs the program eagerly on the capture
    streams, every card synchronised at each cut; ``capture(body)``
    records each card's segments; ``replay()`` issues them."""

    def __init__(self, backend, owner, n_cards, generators=()):
        self.backend, self.owner, self.n = backend, owner, n_cards
        self.generators = list(generators)
        self.mode = None
        self.graphs = [[] for _ in range(n_cards)]
        self.cuts = []
        self.waits = None
        self.events = None
        self.halo = 0

    # ------------------------------------------------------------------
    def _drive(self, mode, body, capture=False):
        self.mode, self.halo = mode, 0
        self.owner._cstep = self
        self.backend.enter(capture)
        try:
            if capture:
                self._begin()
            body()
        finally:
            if capture:
                self._end()
            self.backend.leave()
            self.mode = None
            self.owner._cstep = None

    def warm_up(self, body):
        self._drive("warm", body)
        self.backend.sync()

    def capture(self, body):
        self.cuts = []
        self._drive("capture", body, capture=True)
        self.waits = card_waits([[(id(src), ks, kd) for src, ks, _, kd in c]
                                 for c in self.cuts], self.n)
        self.events = [[self.backend.event() for _ in self.waits]
                       for _ in range(self.n)]

    def _begin(self):
        for k in range(self.n):
            g = self.backend.graph(k, self.generators if k == 0 else ())
            self.graphs[k].append(g)
            self.backend.begin(k, g)

    def _end(self):
        """End every card's capture, even after one fails (a capture left
        open would refuse the process's next host copies)."""
        err = None
        for k in range(self.n):
            try:
                self.backend.end(k, self.graphs[k][-1])
            except Exception as e:       # noqa: BLE001 - raised below
                err = err or e
        if err is not None:
            raise err

    def next_slot(self):
        """The halo buffers' slot of the next exchange: alternating."""
        self.halo += 1
        return (self.halo - 1) % 2

    def cut(self, copies):
        """A cross-card point of the program: ``copies`` [(src, card,
        dst, card)] of persistent contiguous buffers of one size each,
        the sources written since the last cut, to be read after it."""
        for src, ks, dst, kd in copies:
            if not (src.is_contiguous() and dst.is_contiguous()
                    and src.shape == dst.shape and src.dtype == dst.dtype
                    and ks != kd):
                raise ValueError("CardStep.cut: a copy needs contiguous "
                                 "buffers of one shape on two cards")
        if self.mode == "capture":
            self._end()
            self.cuts.append(list(copies))
            self._begin()
        elif self.mode == "warm":
            self.backend.sync()
        elif self.mode == "rerun":
            self._issue(self.j)
            self.j += 1
        else:
            raise RuntimeError("CardStep.cut outside a driven step")
        for src, ks, dst, kd in copies:
            self.backend.copy(dst, kd, src, ks)
        if self.mode == "warm":
            self.backend.sync()

    # ------------------------------------------------------------------
    def _issue(self, j):
        """Segment j on every card: its waits, its graph, its record."""
        b = self.backend
        for k in range(self.n):
            stream = b.current(k)
            for r, i in self.waits[j][k]:
                stream.wait_event(self.events[r][i])
            self.graphs[k][j].replay()
            self.events[k][j].record(stream)

    def replay(self, body=None):
        """One step: every segment issued on every card in order (under a
        stand-in backend's ``rerun``, the program ``body`` runs again and
        each cut issues the segment it ends)."""
        if self.backend.rerun is None:
            for j in range(len(self.waits)):
                self._issue(j)
            return

        def again():
            self.j = 0
            body()
            self._issue(self.j)
        self.backend.rerun(lambda: self._drive("rerun", again))

    def host_calls(self):
        """Per replayed step: graph launches, event records and waits."""
        segs = len(self.waits)
        return dict(segments=segs, launches=segs * self.n,
                    records=segs * self.n,
                    waits=sum(len(w) for seg in self.waits for w in seg))

    def release(self):
        for gs in self.graphs:
            for g in gs:
                g.reset()
        self.graphs = [[] for _ in range(self.n)]

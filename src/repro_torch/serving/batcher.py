"""Host-side request coalescing: the port's own copy of the JAX
package's ``serving/engine.py::HostBatcher`` (the port's
``serving/engine.py`` holds the token-serving engine on top of it)."""

from __future__ import annotations

import collections

__all__ = ["HostBatcher"]


class HostBatcher:
    """Host-side request coalescer shared by the serving engines.

    A FIFO of (kind, item) ops drained either one at a time (slot-at-a-time
    admission, ServeEngine) or as contiguous same-kind blocks of at most
    ``max_block`` items (the streaming engine's ingestion scheduler, via
    the size-counted ``next_block``).  FIFO order is
    preserved across kinds — an op never jumps an earlier op of a
    different kind — which is what makes batched ingestion equivalent to
    replaying the sequential stream (CF additivity does the rest).

    Threading contract: ``push`` is safe from any thread (a single
    GIL-atomic deque append), but draining (``pop_one``/``next_block``)
    must be serialized by the caller — the streaming engine drains from
    its poll thread only, ServeEngine from its serve thread.
    """

    def __init__(self, max_block: int = 512):
        self.max_block = int(max_block)
        # unsynchronized: deque append/popleft are GIL-atomic — push is
        # any-thread, drain is caller-serialized (see class docstring)
        self._q: collections.deque = collections.deque()
        self.pushed = 0  # unsynchronized: best-effort counter
        self.blocks = 0  # unsynchronized: best-effort counter

    def push(self, item, kind: str = "default"):
        self._q.append((kind, item))
        self.pushed += 1

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)

    def pop_one(self):
        """Oldest item (its kind is dropped — single-kind callers)."""
        _, item = self._q.popleft()
        return item

    def next_block(self, limit: int | None = None, size=None):
        """Pop the longest prefix run of same-kind ops whose total size
        fits min(max_block, limit).  ``size`` maps an item to its cost
        (default 1 per request; the clustering engine passes a
        points-per-request counter).  The first op always pops, so a
        single oversized request forms its own block rather than
        deadlocking.  Returns (kind, [items...])."""
        cap = self.max_block if limit is None else min(self.max_block, int(limit))
        kind, first = self._q.popleft()
        items = [first]
        count = size(first) if size else 1
        while self._q and self._q[0][0] == kind:
            nxt = self._q[0][1]
            s = size(nxt) if size else 1
            if count + s > cap:
                break
            self._q.popleft()
            items.append(nxt)
            count += s
        self.blocks += 1
        return kind, items

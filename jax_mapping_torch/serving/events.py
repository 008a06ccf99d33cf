"""Fan-out push channel for map-revision events.

A copy of the JAX package's `serving/events.py` (pure Python).

The `/map-events` route's backbone: the mapper's tick thread emits one
small event per map-revision advance; every connected client (SSE
stream or long-poll) owns a BOUNDED queue. A slow client's queue drops
its OLDEST event on overflow (drop-to-latest backpressure) — revisions
are cumulative (a client that missed revision N learns everything it
needs from N+1), so dropping old events loses no information, and no
client can ever pin server memory. The same bounded-wait contract as
the HTTP plane's 503-degraded path: every wait here takes a timeout.

Lock discipline (analysis/ B1-B3): `EventChannel._lock` only guards the
subscriber list; delivery happens OUTSIDE it on a snapshot, so emitting
never holds one lock while taking another client's (no cross-client
ordering edges, nothing foreign invoked under a lock).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional


class EventSubscription:
    """One client's bounded event mailbox."""

    def __init__(self, depth: int):
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._queue: collections.deque = collections.deque()
        self._depth = max(1, int(depth))
        self._closed = False
        self.n_dropped = 0

    def offer(self, event: Any) -> None:
        """Enqueue; on overflow drop the OLDEST event (drop-to-latest)."""
        with self._lock:
            if self._closed:
                return
            if len(self._queue) >= self._depth:
                self._queue.popleft()
                self.n_dropped += 1
            self._queue.append(event)
            self._not_empty.notify()

    def next(self, timeout_s: float) -> Optional[Any]:
        """Pop the oldest pending event, or None on timeout/close."""
        deadline = time.monotonic() + max(0.0, timeout_s)
        with self._lock:
            while not self._queue:
                if self._closed:
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._not_empty.wait(timeout=remaining)
            return self._queue.popleft()

    def pending(self) -> int:
        with self._lock:
            return len(self._queue)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()


class EventChannel:
    """Register/unregister client queues; fan events out to all."""

    def __init__(self, depth: int):
        self.depth = depth
        self._lock = threading.Lock()
        self._subs: List[EventSubscription] = []
        self.n_events = 0
        self.n_clients_peak = 0
        #: Drops inherited from CLOSED subscriptions: the exported
        #: counter must stay monotonic (Prometheus rate() reads any
        #: decrease as a counter reset), so a disconnecting client's
        #: drops fold in here instead of vanishing with its queue.
        self._n_dropped_closed = 0

    def subscribe(self) -> EventSubscription:
        sub = EventSubscription(self.depth)
        with self._lock:
            self._subs.append(sub)
            self.n_clients_peak = max(self.n_clients_peak, len(self._subs))
        return sub

    def unsubscribe(self, sub: EventSubscription) -> None:
        sub.close()
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)
                self._n_dropped_closed += sub.n_dropped

    def emit(self, event: Any) -> None:
        """Deliver to every subscriber. The subscriber list is
        snapshotted under the channel lock and delivery happens outside
        it — per-queue locks are leaves, never nested."""
        with self._lock:
            subs = list(self._subs)
            self.n_events += 1
        for sub in subs:
            sub.offer(event)

    def n_clients(self) -> int:
        with self._lock:
            return len(self._subs)

    def n_dropped_total(self) -> int:
        with self._lock:
            subs = list(self._subs)
            closed = self._n_dropped_closed
        return closed + sum(s.n_dropped for s in subs)

    def close_all(self) -> None:
        """Shutdown hook: wake and close every subscriber so bounded
        SSE/long-poll loops exit promptly."""
        with self._lock:
            subs = list(self._subs)
        for sub in subs:
            sub.close()

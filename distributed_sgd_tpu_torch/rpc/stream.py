"""The shared deadline wheel (the JAX package's rpc/stream.py ``Wheel``).

One lazy daemon thread fires items at their absolute ``time.monotonic``
deadlines, kept in a heap: one push per watch, and a wake-up only when
the head moves earlier.  The master's heartbeat (core/master.py
``_heartbeat_loop``) schedules each worker's next probe on it.  The JAX
module's streaming transport (``FitStreamClient``, DSGD_STREAM) is
ROADMAP.md Queue A [A8] 3.4 and not here.
"""

from __future__ import annotations

import heapq
import threading
import time


class Wheel:
    """Items fire on the wheel's thread, so they must not block: flip an
    event, push to a deque.  An item is a callable (fired as ``item()``)
    or an object with ``_expire()``.  The thread dies after 5 s with
    nothing to watch, and the next watch starts it again."""

    def __init__(self, name: str = "deadline-wheel"):
        self._name = name
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._running = False

    def watch(self, deadline: float, item) -> None:
        with self._cv:
            self._seq += 1
            head = self._heap[0][0] if self._heap else None
            heapq.heappush(self._heap, (deadline, self._seq, item))
            if not self._running:
                self._running = True
                threading.Thread(target=self._run, daemon=True, name=self._name).start()
                self._cv.notify()
            elif head is None or deadline < head:
                # the sleeping thread's wait already covers a later deadline
                self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    if not self._cv.wait(timeout=5.0) and not self._heap:
                        self._running = False
                        return
                due, _, item = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(timeout=due - now)
                    continue
                heapq.heappop(self._heap)
            try:
                if callable(item):
                    item()
                else:
                    item._expire()
            except Exception:  # noqa: BLE001 - one item must not kill the wheel
                pass

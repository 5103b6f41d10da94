"""Per-key ordered execution lanes.

Parity: the reference pins each request's output callbacks to one of 128
single-thread pools so token deltas for a request are delivered in order
while different requests proceed concurrently (`scheduler.h:127-133`,
`scheduler.cpp:349-356,542-556`). Same design: N single-worker lanes; a
request is pinned to lane ``hash(service_request_id) % N`` at registration
and unpinned at finish.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Optional


class _Lane(threading.Thread):
    def __init__(self, idx: int):
        super().__init__(name=f"output-lane-{idx}", daemon=True)
        self.q: "queue.Queue[Optional[Callable[[], None]]]" = queue.Queue()
        self.start()

    def run(self) -> None:
        while True:
            task = self.q.get()
            if task is None:
                return
            try:
                task()
            except Exception:  # noqa: BLE001 — a bad callback must not kill the lane
                import logging

                logging.getLogger(__name__).exception("output lane task failed")


class OrderedExecutor:
    """N single-worker lanes; tasks submitted with the same key run in FIFO
    order on the same thread."""

    def __init__(self, num_lanes: int = 16):
        if num_lanes <= 0:
            raise ValueError("num_lanes must be positive")
        self._lanes = [_Lane(i) for i in range(num_lanes)]

    @property
    def num_lanes(self) -> int:
        return len(self._lanes)

    def lane_for(self, key: str) -> int:
        return hash(key) % len(self._lanes)

    def submit(self, key: str, task: Callable[[], None]) -> None:
        self.submit_to_lane(self.lane_for(key), task)

    def submit_to_lane(self, lane_idx: int, task: Callable[[], None]) -> None:
        self._lanes[lane_idx].q.put(task)

    def shutdown(self) -> None:
        for lane in self._lanes:
            lane.q.put(None)
        for lane in self._lanes:
            lane.join(timeout=5)

    def drain(self, timeout: float = 5.0) -> None:
        """Block until all currently queued tasks have run (test helper)."""
        import time

        done = threading.Barrier(len(self._lanes) + 1)

        def _mark():
            try:
                done.wait(timeout)
            except threading.BrokenBarrierError:
                pass

        for lane in self._lanes:
            lane.q.put(_mark)
        try:
            done.wait(timeout)
        except threading.BrokenBarrierError:
            pass

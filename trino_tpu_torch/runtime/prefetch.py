"""Background prefetch for the scan feed.

Reference role: execution/executor/TaskExecutor.java's overlap of IO-bound
split reads with compute — here a feed thread runs host-side page decode,
padding, and `jax.device_put` of batch k+1 while the main thread's XLA step
for batch k executes (device dispatch is async, so the two genuinely
overlap).  SURVEY.md §7's feed/step/drain pipeline.
"""

from __future__ import annotations

import contextvars
import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


def eager_prefetch(source: Iterable, depth: int = 2) -> Iterator:
    """Like prefetch_iter but the producer thread starts NOW, not at the
    first next() — the pipeline-parallelism seam (reference: §2.7(4)
    build/probe overlap): a probe side wrapped eagerly decodes and feeds
    while the join's build side is still indexing on device.

    Shares prefetch_iter's producer (stop Event + finally-drain), so an
    abandoned consumer (LIMIT, planning failure after the join visit) stops
    the thread instead of leaving it blocked on a full queue."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def run():
        try:
            for item in source:
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as e:  # propagate to consumer
            q.put((_SENTINEL, e))
            return
        q.put(_SENTINEL)

    # the producer runs in the caller's context, so a spill store that a
    # wave stream upstream creates there registers with the statement
    t = threading.Thread(
        target=contextvars.copy_context().run, args=(run,), daemon=True,
        name="eager-prefetch",
    )
    t.start()

    def drain():
        try:
            while True:
                item = q.get()
                if item is _SENTINEL:
                    return
                if (
                    isinstance(item, tuple)
                    and len(item) == 2
                    and item[0] is _SENTINEL
                ):
                    raise item[1]
                yield item
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    return drain()


def prefetch_iter(source: Iterable, depth: int = 2) -> Iterator:
    """Iterate `source` in a daemon thread, keeping up to `depth` results
    ready.  Exceptions in the producer re-raise at the consuming point."""
    q: queue.Queue = queue.Queue(maxsize=max(1, depth))
    stop = threading.Event()

    def run():
        try:
            for item in source:
                if stop.is_set():
                    return
                q.put(item)
        except BaseException as e:  # propagate to consumer
            q.put((_SENTINEL, e))
            return
        q.put(_SENTINEL)

    t = threading.Thread(
        target=contextvars.copy_context().run, args=(run,), daemon=True,
        name="scan-prefetch",
    )
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _SENTINEL:
                raise item[1]
            yield item
    finally:
        stop.set()
        # drain so a blocked producer can observe `stop` and exit
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass

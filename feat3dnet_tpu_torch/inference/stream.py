"""The stream loop that the throughput entry points share
(`InferencePipeline.extract_many`, `SegmentationPipeline.segment_many`).

Units are prepared in `prep_workers` threads (host padding, pinned
buffers, uploads queued), the main thread queues each prepared unit on the
card without a host sync, and once `depth` units are queued it reads back
the oldest: the host's preparation and read-back overlap the card's work.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, List

from feat3dnet_tpu_torch.utils.profiling import span


def run_units(units: Iterable[Any], prep: Callable[[int, Any], Any],
              enqueue: Callable[[int, Any], Any], finish: Callable[[Any], List[Any]],
              depth: int, prep_workers: int, wait_span: str,
              first_here: bool = False) -> List[Any]:
    """The results of every unit in order. Units are taken from `units` in
    this thread, one each time a prep is submitted (`depth +
    prep_workers` ahead of the read-back); `prep(i, unit)` runs in a worker
    thread, `enqueue(i, prepped)` in this one (no host sync), then
    `finish(pending)` (the read-back: a list of results) once `depth`
    units are queued, and for the rest at the end. The wait for a unit's
    prep runs inside the span `wait_span`. first_here: the first unit is
    prepped (inside that span) and queued in this thread before any worker
    starts: the card idles until it is queued, and a hand-off to a worker
    and back would add two thread wake-ups to that wait. The workers are
    not joined on return: every prep has ended by then."""
    results: List[Any] = []
    inflight: deque = deque()
    it = enumerate(units)
    here = next(it, None) if first_here else None
    if here is not None:
        with span(wait_span):
            prepped = prep(*here)
        inflight.append(enqueue(here[0], prepped))
    pool = ThreadPoolExecutor(max_workers=prep_workers)
    try:
        futs: deque = deque()

        def submit_next():
            i, unit = next(it, (None, None))
            if unit is not None:
                futs.append((i, pool.submit(prep, i, unit)))

        for _ in range(depth + prep_workers - len(inflight)):
            submit_next()
        if len(inflight) >= depth:
            results.extend(finish(inflight.popleft()))
        while futs:
            i, fut = futs.popleft()
            with span(wait_span):
                prepped = fut.result()
            submit_next()
            inflight.append(enqueue(i, prepped))
            if len(inflight) >= depth:
                results.extend(finish(inflight.popleft()))
        while inflight:
            results.extend(finish(inflight.popleft()))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    return results

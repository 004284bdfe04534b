"""Profiling helpers (port of feat3dnet_tpu/utils/profiling.py).

* `time_function`: logs the wall time of each call (the reference's
  utils.py:5-15 decorator).
* `device_trace`: a `torch.profiler` trace (CPU, and CUDA where there is a
  card) written into a directory as a Chrome trace, viewable in Perfetto
  or chrome://tracing.
* `timed_device_call`: median seconds per call, synchronised with the card
  when the output lies on it.
"""
from __future__ import annotations

import contextlib
import functools
import logging
import os
import time
from typing import Callable, Iterator, List

import numpy as np
import torch


def time_function(fn: Callable) -> Callable:
    """Log the wall time of each call to `feat3dnet_tpu_torch.timing`."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        logging.getLogger("feat3dnet_tpu_torch.timing").debug(
            "%s took %.3f s", fn.__name__, time.perf_counter() - t0)
        return out

    return wrapper


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block (CPU activity, and CUDA where a card is present)
    and write `trace_<ms since epoch>.json` into log_dir. Yields the
    profiler, whose `key_averages()` sum the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{int(time.time() * 1e3)}.json"))


def _tensors(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _tensors(o)]
    return []


def _sync(out) -> None:
    for t in _tensors(out):
        if t.is_cuda:
            torch.cuda.synchronize(t.device)


def timed_device_call(fn: Callable, *args, repeats: int = 5) -> float:
    """Median seconds per call of fn(*args) on the host clock, after one
    warm-up call; each call waits for the card when an output lies on it."""
    _sync(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        _sync(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))

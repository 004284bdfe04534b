"""Profiling helpers (port of feat3dnet_tpu/utils/profiling.py).

* `span`, `spanned`: the program's own named ranges on torch.profiler's
  clock (below).
* `device_trace`: a `torch.profiler` trace of every thread (CPU, and CUDA
  where there is a card) written into a directory as a Chrome trace,
  viewable in Perfetto or chrome://tracing.
* `timed_device_call`: median seconds per call, synchronised with the card
  when the output lies on it.

Spans. Each stage of the three entry paths and each kernel wrapper runs
inside a `torch.profiler.record_function` range named `f3d.<path>.<stage>`
(`f3d.extract.*`, `f3d.serve.*`, `f3d.train.*`, `f3d.data.*`) or, for the
wrappers, `f3d.k<n>.<kernel>`. Under a profiler the device's activity
lies on the same clock, so each gap of the device can be put down to the
stage the host was in. Parents are given by nesting on one thread. A
span that carries an id (an extraction unit, a request, a training step)
is named `<name>#<id>`, so that one unit's spans on different threads can
be matched: the profiler keeps a range's name but not its argument
string. With no profiler running a span costs one read of torch's
process-wide flag `torch.autograd.profiler._is_profiler_enabled` and opens
nothing. That flag, and not the calling thread's profiler state
(`torch.autograd._profiler_enabled()`), is the gate: the thread state
reads off on a worker thread (the extraction's prep thread, the training
feed's) and on every thread under a profile of all threads.
"""
from __future__ import annotations

import contextlib
import functools
import os
import time
from typing import Callable, Iterator, List, Optional

import numpy as np
import torch

_OFF = contextlib.nullcontext()


def _range(name: str, uid: Optional[int]):
    return torch.profiler.record_function(name if uid is None else f"{name}#{uid}")


def span(name: str, uid: Optional[int] = None):
    """A context: the range `name` (`name#uid` with an id) while a torch
    profiler runs, else a shared no-op."""
    if not torch.autograd.profiler._is_profiler_enabled:
        return _OFF
    return _range(name, uid)


def spanned(name: str) -> Callable:
    """Decorator: each call of the function runs inside `span(name)`."""

    def wrap(fn: Callable) -> Callable:
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not torch.autograd.profiler._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _range(name, None):
                return fn(*args, **kwargs)

        return call

    return wrap


def _every_thread():
    """The profiler's setting that records every thread (worker threads'
    ranges and ops too), where this torch has it; else None."""
    try:
        return torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    except (AttributeError, TypeError):
        return None


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on every thread (CPU activity, and CUDA where a
    card is present) and write `trace_<ms since epoch>.json` into log_dir.
    Yields the profiler, whose `key_averages()` sum the events by name."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities,
                                experimental_config=_every_thread()) as prof:
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

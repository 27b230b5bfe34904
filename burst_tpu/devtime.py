"""Blocked-on-device time accounting and the all-host mode.

The reference prints wall-clock phase timers (burst.c:1916-1925, 5162).
Every device result in this codebase is fetched through `fetch`, one
batched `jax.device_get` placed directly after its dispatch chain;
timing those blocking fetches measures the dispatch-to-ready window of
each chain. That is the time the host waited on the device, not the
device's busy time (a profiler trace gives that).

BURST_TPU_HOST=1 makes `device_ok()` False: pure-CPU execution through
the host kernels (kernels/host.py) that never touches, or initializes,
a device backend.

Usage:
    with devtime.track() as acc:
        aligner.align_batch(...)
    acc["s"]   # seconds blocked on device fetches
    acc["n"]   # number of batched fetches

Tracking is off by default and costs one `is None` check per fetch.
"""
from __future__ import annotations

import contextlib
import os
import time

_acc = None


def device_ok() -> bool:
    """False under BURST_TPU_HOST=1: dispatch sites must route to the
    host kernels."""
    return os.environ.get("BURST_TPU_HOST", "") in ("", "0")


def fetch(tree):
    """jax.device_get with blocked-time accounting. In the all-host
    mode every chunk is already numpy and passes through untouched."""
    if not device_ok():
        return tree
    import jax

    if _acc is None:
        return jax.device_get(tree)
    t0 = time.perf_counter()
    out = jax.device_get(tree)
    _acc["s"] += time.perf_counter() - t0
    _acc["n"] += 1
    return out


@contextlib.contextmanager
def track():
    """Accumulate blocked-on-device seconds for fetches in this scope."""
    global _acc
    prev = _acc
    _acc = {"s": 0.0, "n": 0}
    try:
        yield _acc
    finally:
        _acc = prev

"""The device timer the port's measurements share: the autotuner's sweeps
(``kernels/autotune.py``), ``chip_smoke.py``'s ``[time]`` lines and
``compare_kernels.py``.

Calls are enqueued behind a ``torch.cuda._sleep`` kernel, so the CUDA
events around them time the card running them back to back, not the host
issuing them: a kernel of a few microseconds is timed as the card runs it,
without the launch gaps that set a back-to-back host loop's time."""
from __future__ import annotations

import time

import torch


def device_ms(fn, min_ms: float = 30.0):
    """Mean device milliseconds per call with the host ahead of the card,
    and whether it stayed ahead.  Where the sleep ran out before the host
    had enqueued the last call (the start event had passed), the run is
    made again with half the calls and twice the sleep; after five runs the
    last one's time comes back with ``False``.  Where enqueueing took as
    long as the sleep itself, the calls waited for the card (a host read
    inside them): no longer sleep puts the host ahead, so that run's time
    comes back at once with ``False``."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = max(time.perf_counter() - t0, 1e-6) * 1e3  # ms, host and card
    n = max(3, min(200, int(min_ms / once)))
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for attempt in range(5):
        # ~2e6 cycles per ms at the card's boost clock (a lower clock only
        # makes the sleep longer), twice the host's n enqueues and more
        sleep_ms = 2 ** (attempt + 1) * n * once + 1.0
        torch.cuda._sleep(int(2e6 * sleep_ms))
        start.record()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        ahead = not start.query()
        torch.cuda.synchronize()
        if ahead or enqueue_ms >= sleep_ms:
            break
        n = max(3, n // 2)
    return start.elapsed_time(end) / n, ahead

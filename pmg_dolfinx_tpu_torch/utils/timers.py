"""Named wall-clock timers with a `list_timings`-style report.

Port of `pmg_dolfinx_tpu.utils.timers`. CUDA kernels run asynchronously,
so a Timer around GPU work measures the enqueue unless it synchronizes:
``sync=True`` calls `torch.cuda.synchronize()` at scope entry and exit
(when CUDA is in use in this process).
"""

import time
from collections import defaultdict
from contextlib import ContextDecorator

import torch

_records = defaultdict(lambda: [0, 0.0])  # name -> [count, total_seconds]


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer(ContextDecorator):
    """``with Timer("name"):`` or ``@Timer("name")`` scope timer."""

    def __init__(self, name: str, sync: bool = False):
        self.name = name
        self.sync = sync

    def __enter__(self):
        if self.sync:
            _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync:
            _sync()
        dt = time.perf_counter() - self._t0
        rec = _records[self.name]
        rec[0] += 1
        rec[1] += dt
        return False

    @property
    def elapsed(self):
        return time.perf_counter() - self._t0


def list_timings(print_fn=print):
    """Print the aggregated timing table."""
    if not _records:
        print_fn("no timings recorded")
        return
    width = max(len(n) for n in _records) + 2
    print_fn(f"{'timer'.ljust(width)} {'count':>7} {'total[s]':>10} {'avg[s]':>10}")
    for name in sorted(_records):
        count, total = _records[name]
        print_fn(
            f"{name.ljust(width)} {count:>7d} {total:>10.4f} {total / max(count, 1):>10.4f}"
        )


def reset_timings():
    """Forget every recorded timing."""
    _records.clear()

"""Slope-based timing: the median per-apply slope between two rep counts.

Port of `pmg_dolfinx_tpu.utils.measure`. ``run(n)`` performs ``n`` reps
and returns only when they have finished (on the GPU: a
``torch.cuda.synchronize()`` or a scalar read back at its end); the slope
between two rep counts subtracts the launch and read-back overhead out.
"""

import time

SPREAD_TARGET = 0.10
MAX_SAMPLES = 25


def measure(run, lo, hi, min_samples=7):
    """Median per-apply slope between rep counts ``lo < hi``, plus its
    spread.

    Spread = (q3 - q1) / median over the collected slope samples; keeps
    sampling until it drops below `SPREAD_TARGET` or `MAX_SAMPLES` is
    hit. Non-positive slopes (host jitter above the compute delta) carry
    no signal and are dropped; RuntimeError when too few remain.
    """
    run(lo)
    run(hi)  # warm both rep counts (first-call builds and caches)
    slopes = []
    while True:
        for _ in range(min_samples if not slopes else 4):
            t0 = time.perf_counter()
            run(lo)
            t_lo = time.perf_counter() - t0
            t0 = time.perf_counter()
            run(hi)
            t_hi = time.perf_counter() - t0
            slopes.append((t_hi - t_lo) / (hi - lo))
        s = sorted(x for x in slopes if x > 0)
        n = len(s)
        if n >= 3:
            med = s[n // 2]
            spread = (s[(3 * n) // 4] - s[n // 4]) / med
            if spread <= SPREAD_TARGET or len(slopes) >= MAX_SAMPLES:
                return med, spread
        elif len(slopes) >= MAX_SAMPLES:
            raise RuntimeError(
                "measure: host jitter swamped the timing signal "
                f"({len(slopes)} samples, {n} positive slopes)"
            )

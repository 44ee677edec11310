#!/usr/bin/env python3
"""The serving kernels and steppers alone: `chip_smoke.py` phases 10 and
11 (61^3, p=6), on one NVIDIA GPU, optionally against another checkout.

    python3 tools/serving_bench_torch.py [OTHER_CHECKOUT] [--no-path]

Builds this checkout's `csrc/kron_packed.cu`, then runs phase 10 (both
kernels against their plain versions at B = 1, 8, 64, device time beside
the bound, kernels and host us per call, launch plans) and phase 11 (the
five serving steppers: L2 error, steps/s, profiled busy and kernels per
step). With ``OTHER_CHECKOUT``, that checkout's package (imported under
an alias, its kernels built from its own sources) is timed in the same
process in turns, as `chip_smoke.py --parent` does. ``--no-path`` skips
phase 11.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", nargs="?", help="root of the other checkout")
    ap.add_argument("--no-path", action="store_true",
                    help="phase 10 only")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("serving_bench_torch: needs an NVIDIA GPU")
    import subprocess

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    from pmg_dolfinx_tpu_torch.ops import kron_packed as kp

    t0 = time.perf_counter()
    kp.load_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s")
    for line in kp.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("    " + line.strip())
    parent = cs.load_parent(args.other)
    t0 = cs.phase("10. serving kernel parity vs plain torch: 61^3, p=6")
    cs.packed_parity(parent)
    cs.done(t0)
    if not args.no_path:
        t0 = cs.phase("11. serving path: heat CN and wave at 61^3, p=6")
        cs.serving_path(parent)
        cs.done(t0)


if __name__ == "__main__":
    main()

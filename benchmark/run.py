#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload ring24_1080p.scan --seed 7 \\
        --seconds 30 --trace 0

Set-up (the seeded render on the card, the pinned copies, the calibration,
the kernel library's build or load, one warm pass of the cell's path) is
timed as ``setup_s``; then requests run back to back for ``--seconds``;
then the program's state is freed and every answer of the window is
compared with the plain reference. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each compared number
beside its limit); the compared numbers are also the last lines of standard
error. Exits non-zero and prints no result without enough CUDA cards, or if
JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

THREADS = 2  # the host's intra-op threads in a run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from benchmark import harness

    chips = harness.cell_of(harness.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    # One process with few threads: idle intra-op workers spinning on the
    # host's cores slow the thread that launches the kernels.
    torch.set_num_threads(THREADS)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), T_START)
    loaded = harness.banned_modules()
    if loaded:
        print(f"loaded in this process: {loaded}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The readings the limits of ``benchmark/limits/<cell>.json`` are set
from: for each seed, the compared numbers of the program (every distinct
input of the cell's mix run once through the timed path, no window) and of
the control (the reference put in the program's place, in bfloat16). The
benchmark's own runs never run this.

    python3 benchmark/readings.py --workload ring24_1080p.scan \\
        --seeds 1,2,3 [--control-only] [--out readings.jsonl]

Prints one JSON line a seed."""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def readings(workload: str, seed: int, device=None, overrides=None,
             program: bool = True) -> dict:
    """One seed's program and control numbers of ``workload``; without
    ``program`` the control's alone, which needs the inputs and one card
    whatever the cell's count."""
    import torch

    from benchmark import harness

    man = harness.manifest()
    cell = harness.cell_of(man, workload)
    config = harness.merge(harness.config_of(cell["config"]),
                           (overrides or {}).get("config"))
    traffic = harness.merge(harness.traffic_of(cell["traffic"]),
                            (overrides or {}).get("traffic"))
    dev = torch.device(device or "cuda")
    ctx = harness.Context(cell, config, traffic, seed, False,
                          [dev] * (cell["chips"] if program else 1))
    driver = harness.driver_of(traffic).Driver(ctx)
    t0 = time.perf_counter()
    row = dict(workload=workload, seed=seed)
    if program:
        driver.setup()
        answers = [driver.request(i, timed=False)
                   for i in range(driver.distinct_inputs())]
        driver.release()
        row["program"] = {k: c["value"]
                          for k, c in driver.check(answers).items()}
    else:
        driver.prepare_inputs()
    row["control"] = driver.control()
    row["seconds"] = time.perf_counter() - t0
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out")
    ap.add_argument("--control-only", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    for s in args.seeds.split(","):
        row = readings(args.workload, int(s),
                       program=not args.control_only)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The comparison that decides ``correct``, shown to fail: each cell driven
through the harness on the host CPU at a small size (the look for a card
skipped), once sound and once with each fault its timed path can have
planted underneath, and its control (the reference in bfloat16 in the
program's place) read against the limits. A last test runs the command
itself on a card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness
from benchmark.readings import readings
from benchmark.tests.conftest import SCAN_TINY

SCAN = "ring24_1080p.scan"
SEED = 2 ** 31 + 17


def run(cell, overrides, fault=None, seconds=0.5):
    return harness.run(cell, SEED, seconds, False, time.perf_counter(),
                       device="cpu", overrides=overrides, fault=fault)


def over_limit(checks) -> list[str]:
    return [k for k, c in checks.items() if c["value"] > c["limit"]]


@pytest.fixture(scope="module")
def scan_sound():
    return run(SCAN, SCAN_TINY)


def test_scan_sound_run_is_correct(scan_sound):
    assert scan_sound["correct"], scan_sound["checks"]
    assert list(scan_sound)[-1] == "checks"
    assert set(scan_sound["metrics"]) == {"scan_cloud_s", "setup_s"}


@pytest.mark.parametrize("fault", ["altered", "half", "stale"])
def test_scan_fault_is_not_correct(fault):
    # A stale answer is the previous scan's, from the window's first scan
    # on (the last warm-up scan was of the other ring).
    got = run(SCAN, SCAN_TINY, fault)
    assert not got["correct"] and over_limit(got["checks"]), got["checks"]


def test_scan_control_is_not_correct():
    row = readings(SCAN, SEED, "cpu", SCAN_TINY, program=False)
    limits = json.loads((harness.BENCH / "limits" / f"{SCAN}.json")
                        .read_text())["limits"]
    assert any(row["control"][k] > v for k, v in limits.items()), row


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
def test_command_on_a_card(trace):
    """The command as the benchmark's check runs it, one short window."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, str(harness.BENCH / "run.py"), "--workload", SCAN,
         "--seed", str(SEED), "--seconds", "3", "--trace", str(trace)],
        capture_output=True, text=True, timeout=360, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"

"""Settings of the benchmark's own tests: the ``card`` marker, and tiny
rigs and settings that let the cells' drivers run on the host CPU."""

import os

import pytest

TINY_RIG = {"proj_width": 256, "proj_height": 128, "cam_width": 160,
            "cam_height": 96}
# The scan cell at a size the CPU holds: six stops, lighter registration.
SCAN_TINY = {"config": {
    "rig": TINY_RIG, "turntable": {"stops": 6},
    "scan": {"merge": {"ransac_iterations": 8192, "max_points": 2048,
                       "final_max_points": 8192}}}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a host without one")


@pytest.fixture(autouse=True, scope="session")
def _threads():
    import torch

    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // workers))

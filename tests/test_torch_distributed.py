"""The port's ``parallel/distributed.py``: two real processes over
``gloo`` (as tests/test_distributed.py runs two JAX processes), the no-op
without an environment, and a partial environment as an error."""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = r"""
import torch
import torch.distributed as dist

from structured_light_for_3d_model_replication_tpu_torch.parallel import (
    distributed,
)

assert distributed.initialize_from_env(device="cpu") is True
assert distributed.initialize_from_env(device="cpu") is True  # idempotent
pid, nproc = distributed.world()
assert nproc == 2, nproc
assert dist.get_backend() == "gloo", dist.get_backend()
local = torch.full((2,), float(pid + 1), dtype=torch.float32)
gathered = [torch.empty(2) for _ in range(nproc)]
dist.all_gather(gathered, local)        # rank 0: 1s, rank 1: 2s
total = float(torch.cat(gathered).sum())
assert total == 6.0, total
print(f"OK rank={pid} total={total}", flush=True)
dist.destroy_process_group()
"""

_ENV_NAMES = ("SL_COORDINATOR", "SL_NUM_PROCESSES", "SL_PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_cpu_collective():
    port = _free_port()
    env_base = {k: v for k, v in os.environ.items() if k not in _ENV_NAMES}
    env_base.update({
        "SL_COORDINATOR": f"127.0.0.1:{port}",
        "SL_NUM_PROCESSES": "2",
        "PYTHONPATH": os.pathsep.join(
            [os.getcwd()] + os.environ.get("PYTHONPATH", "").split(
                os.pathsep)),
    })
    procs = []
    for rank in range(2):
        env = dict(env_base, SL_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"OK rank={rank} total=6.0" in out


def test_initialize_noop_without_env(monkeypatch):
    from structured_light_for_3d_model_replication_tpu_torch.parallel import (
        distributed,
    )

    monkeypatch.setattr(distributed, "_initialized", False)
    for var in _ENV_NAMES:
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize_from_env(device="cpu") is False
    assert distributed.world() == (0, 1)


@pytest.mark.parametrize("coordinator", [
    {"SL_COORDINATOR": "127.0.0.1:1"},
    {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"},
])
def test_partial_env_is_an_error(monkeypatch, coordinator):
    from structured_light_for_3d_model_replication_tpu_torch.parallel import (
        distributed,
    )

    monkeypatch.setattr(distributed, "_initialized", False)
    for var in _ENV_NAMES:
        monkeypatch.delenv(var, raising=False)
    for k, v in coordinator.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="misconfiguration"):
        distributed.initialize_from_env(device="cpu")

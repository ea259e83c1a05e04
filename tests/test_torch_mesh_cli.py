"""The port's CLI on a mesh: ``torch.distributed.run`` with two ranks on
the CPU (gloo), each rank one machine; every rank prints the same ids and
the job exits 0.  The run is under a chaos plan, whose realized faults the
CLI checks against the result's ``degraded`` and ``haircut``."""

import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("extra", [
    ["--fault-rate", "0.3", "--engine", "fused"],
], ids=["data2"])
def test_cli_under_torchrun_agrees_on_every_rank(extra):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-addr", "127.0.0.1", "--master-port",
         str(_free_port()), "-m", "repro_torch.launch.select", "--device",
         "cpu", "--n", "2048", "--k", "8", "--d", "16", "--use-kernel",
         *extra], env=env, capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    ids = re.findall(r"\[select rank=(\d)\] ids=(\[[^\]]*\])", out.stdout)
    assert sorted(r for r, _ in ids) == ["0", "1"]
    assert ids[0][1] == ids[1][1] and ids[0][1] != "[]"
    assert len(re.findall(r"degraded=1", out.stdout)) == 2

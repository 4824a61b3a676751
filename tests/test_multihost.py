"""2-process multi-host (DCN) smoke test — parallel/multihost.py exercised
across REAL process boundaries (VERDICT r1 item 9).

Spawns two Python processes, each with 2 virtual CPU devices, that join a
jax.distributed coordinator and run the DP flow helper over the 4-device
global mesh; each checks its addressable shards against the unsharded flow.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed_dp(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(repo, "tests", "multihost_worker.py")
    port = _free_port()
    env = dict(os.environ)
    # The workers select the CPU platform themselves; drop this process's
    # virtual-device flag so each worker sets its own count.
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=repo,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))
    for p, out in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{out}"
        assert "MULTIHOST_OK" in out, out

"""Two-process ``jax.distributed`` smoke test (VERDICT round-1 item 8).

The virtual 8-device mesh used everywhere else is single-process; this test
spawns 2 REAL Python processes (2 virtual CPU devices each, 4 global),
initializes ``parallel.distributed.initialize`` with process_count=2, and
runs a cross-process psum plus one frame-parallel ``process_frames_dp``
step -- the multi-host branches nothing in-process can reach.  No
accelerator needed (the standard CPU+gloo fake-multihost recipe).
"""

import socket
import subprocess
import sys
from pathlib import Path

import pytest

WORKER = Path(__file__).parent / "_distributed_worker.py"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_smoke():
    coord = f"127.0.0.1:{_free_port()}"
    nproc = 2
    procs = [
        subprocess.Popen(
            [sys.executable, str(WORKER), coord, str(nproc), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in range(nproc)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=480)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-3000:]}"
        assert f"WORKER_OK pid={pid}" in out, out[-3000:]
        assert "SOLVERS_OK" in out, out[-3000:]
        assert "MESH_SCAN_OK" in out, out[-3000:]
    # Both processes computed the same global psum.
    psums = {line.split("psum=")[1].split()[0]
             for out in outs for line in out.splitlines()
             if "WORKER_OK" in line}
    assert len(psums) == 1, psums

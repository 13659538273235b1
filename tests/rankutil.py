"""Multi-rank harness for the port's distributed tests
(``tests/test_torch_{sharded,fl_oac}.py``).

``run_jax`` runs a script of the JAX package in a subprocess with 8
placeholder host devices (the main test process keeps its one-device
view), ``run_python`` any script in a fresh interpreter, and
``run_ranks`` a script of the port in ``world`` processes, one gloo rank
each on the CPU, joined by a ``FileStore`` under a directory of the
test's own.  Each passes the script its arguments, gives it one thread,
waits with a timeout and fails with the end of its error output.  A
rank's script runs after ``RANK_PRELUDE``, which joins the group and
leaves ``RANK``, ``WORLD``, ``torch`` and ``dist`` defined.
"""

from __future__ import annotations

import os
import subprocess
import sys
from typing import List, Sequence

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))

RANK_PRELUDE = r"""
import os
import torch
import torch.distributed as dist
torch.set_num_threads(1)
RANK, WORLD = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=RANK, world_size=WORLD)
"""


def _env(extra: dict) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=SRC, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               JAX_PLATFORMS="cpu", **extra)
    return env


def run_python(code: str, args: Sequence[str] = (), timeout: int = 300,
               env: dict = None) -> str:
    """Run ``code`` in a fresh interpreter; its stdout."""
    out = subprocess.run([sys.executable, "-c", code, *args],
                         capture_output=True, text=True, timeout=timeout,
                         env=_env(env or {}))
    assert out.returncode == 0, f"stderr:\n{out.stderr[-4000:]}"
    return out.stdout


def run_jax(code: str, args: Sequence[str] = (), timeout: int = 300,
            devices: int = 8) -> str:
    """Run ``code`` with ``devices`` placeholder host devices; its stdout."""
    return run_python(code, args, timeout, {
        "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"})


def run_ranks(code: str, world: int, workdir: str,
              args: Sequence[str] = (), timeout: int = 300) -> List[str]:
    """Run ``RANK_PRELUDE + code`` as ``world`` gloo ranks; their
    stdouts.  Every rank is stopped if one fails or the time runs out."""
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK_PRELUDE + code, *args],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env({"RANK": str(r), "WORLD_SIZE": str(world),
                  "STORE": store})) for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            stdout, stderr = p.communicate(timeout=timeout)
            assert p.returncode == 0, (f"rank {r} exited {p.returncode}:\n"
                                       f"{stderr[-4000:]}")
            outs.append(stdout)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs

"""Spawns a gloo group of CPU ranks for the port's distributed tests.

``spawn(world, case, out_dir)`` starts ``world`` processes of
``tests/_torch_dist_worker.py`` with the environment ``torchrun`` would
set (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), waits for
them and raises with their output if one fails.  The workers import
torch and the port only (no JAX), write their results under ``out_dir``
and leave the comparisons to the test.
"""
import math
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_dist_worker.py")


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
               LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="localhost",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1",
               PYTHONPATH=os.path.join(ROOT, "src") + os.pathsep
               + env.get("PYTHONPATH", ""))
    return env


def run_ranks(world: int, argv, timeout: float = 600.0):
    """Run ``argv`` once a rank; returns the ranks' (rc, output) pairs."""
    port = free_port()
    procs = [subprocess.Popen(argv, env=rank_env(r, world, port), cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append((p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def spawn(world: int, case: str, out_dir: str, timeout: float = 600.0):
    outs = run_ranks(world, [sys.executable, WORKER, case, str(out_dir)],
                     timeout)
    bad = [(r, rc, out) for r, (rc, out) in enumerate(outs) if rc != 0]
    if bad:
        r, rc, out = bad[0]
        raise RuntimeError(f"rank {r} of {case} exited {rc}:\n{out[-6000:]}")
    return outs


def jax_cpu_mesh(shape, axes):
    """A JAX mesh over CPU devices for the reference's side of a parity
    test; skips without JAX or with too few CPU devices."""
    import numpy as np
    import pytest
    jax = pytest.importorskip("jax")
    devs = jax.devices("cpu")
    n = math.prod(shape)
    if len(devs) < n:
        pytest.skip(f"the reference's mesh needs {n} CPU devices "
                    "(XLA_FLAGS=--xla_force_host_platform_device_count=8)")
    return jax.sharding.Mesh(np.array(devs[:n]).reshape(shape), axes)

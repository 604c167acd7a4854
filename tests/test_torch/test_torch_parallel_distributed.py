"""The port's multi-process bootstrap (``parallel/distributed.py``) and
the parallel package's isolation, on the CPU.

As in tests/test_parallel/test_distributed.py: the single-process path is
a no-op, a 1-process group joins in a subprocess (the smallest world
``torch.distributed`` accepts) through every spelling of the address, and
a join with nothing listening raises within its timeout.
"""

import os
import socket
import subprocess
import sys
import textwrap

import pytest
import torch

from pyrayt_tpu_torch.parallel import distributed
from pyrayt_tpu_torch.parallel.distributed import initialize_distributed, is_distributed

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LAUNCH_VARS = distributed._ADDR_VARS + distributed._NPROC_VARS + distributed._PID_VARS + (
    "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


@pytest.fixture()
def clean_env(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(script, env_extra=None, timeout=120):
    env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                          text=True, timeout=timeout, env=env, cwd=ROOT)


def test_single_process_noop(clean_env):
    assert initialize_distributed() is False
    assert is_distributed() is False
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("how", ["argument", "jax_env", "torchrun_env", "file"])
def test_one_process_group_joins_in_a_subprocess(tmp_path, how):
    port = free_port()
    args, env = "", {}
    if how == "argument":
        args = f'coordinator_address="localhost:{port}", num_processes=1, process_id=0'
    elif how == "jax_env":
        env = {"JAX_COORDINATOR_ADDRESS": f"localhost:{port}", "JAX_NUM_PROCESSES": "1",
               "JAX_PROCESS_ID": "0"}
    elif how == "torchrun_env":
        env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port), "WORLD_SIZE": "1",
               "RANK": "0"}
    else:
        args = f'coordinator_address="file://{tmp_path / "store"}", num_processes=1'
    out = run(f"""
        import torch.distributed as dist
        from pyrayt_tpu_torch.parallel import default_mesh
        from pyrayt_tpu_torch.parallel.distributed import initialize_distributed, is_distributed

        joined = initialize_distributed({args})
        # one process: a group of size 1 -> not distributed, but the join ran
        assert dist.is_initialized() and dist.get_world_size() == 1 and not joined
        assert dist.get_backend() == "gloo"
        assert initialize_distributed() is False  # idempotent
        mesh = default_mesh(device="cpu")
        assert mesh.shape == {{"hosts": 1, "rays": 1}} and mesh.rank == 0
        dist.destroy_process_group()
        print("JOIN-OK")
    """, env)
    assert "JOIN-OK" in out.stdout, out.stderr[-2000:]


def test_a_join_with_nothing_listening_raises(clean_env):
    clean_env.setenv("WORLD_SIZE", "2")
    clean_env.setenv("RANK", "1")
    clean_env.setenv("JAX_COORDINATOR_ADDRESS", "localhost:1")  # nothing there
    with pytest.raises(Exception):
        initialize_distributed(initialization_timeout=2)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("env,message", [
    ({"WORLD_SIZE": "2", "RANK": "0"}, "no coordinator address"),
    ({"MASTER_ADDR": "localhost", "MASTER_PORT": "1", "WORLD_SIZE": "2"}, "no process id"),
])
def test_an_incomplete_launch_raises(clean_env, env, message):
    for name, value in env.items():
        clean_env.setenv(name, value)
    with pytest.raises(ValueError, match=message):
        initialize_distributed()


def test_the_backend_follows_the_device(clean_env):
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed._pick_backend(None, 4) == "gloo"
    clean_env.setattr(torch.cuda, "is_available", lambda: True)
    clean_env.setattr(torch.cuda, "device_count", lambda: 4)
    assert distributed._pick_backend(None, 4) == "nccl"
    clean_env.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="share 1 CUDA device"):
        distributed._pick_backend(None, 2)  # never a silent switch to gloo
    assert distributed._pick_backend("gloo", 2) == "gloo"
    clean_env.setenv("LOCAL_WORLD_SIZE", "1")  # one rank per node, each with its card
    assert distributed._pick_backend(None, 2) == "nccl"


def test_importing_the_package_loads_no_jax():
    out = run("""
        import sys
        import pyrayt_tpu_torch.parallel
        import pyrayt_tpu_torch.parallel.distributed, pyrayt_tpu_torch.parallel.mesh
        import pyrayt_tpu_torch.parallel.surfaces, pyrayt_tpu_torch.parallel.trace
        import pyrayt_tpu_torch.parallel.objective
        bad = [m for m in sys.modules if m == "jax" or m.startswith(("jax.", "pyrayt_tpu."))
               or m == "pyrayt_tpu"]
        print("LOADED", bad)
    """)
    assert "LOADED []" in out.stdout, out.stdout + out.stderr[-2000:]


# the port's names without a JAX counterpart (API.md, "Differences from
# `pyrayt_tpu`"): the sharded design objective and its rays
PORT_ONLY = ("build_sharded_objective", "shard_sources")


def test_the_package_exports_the_jax_package_names():
    import pyrayt_tpu.parallel as j_parallel
    import pyrayt_tpu_torch.parallel as t_parallel

    assert sorted(t_parallel.__all__) == sorted(list(j_parallel.__all__) + list(PORT_ONLY))
    assert all(hasattr(t_parallel, name) for name in t_parallel.__all__)

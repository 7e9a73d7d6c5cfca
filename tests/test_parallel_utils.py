"""parallel/mesh helpers, distributed single-process behavior, and the
device-prefetch pipeline."""

import numpy as np

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core import distributed
from vit_grid_model_tpu.core.config import MeshConfig
from vit_grid_model_tpu.data.pipeline import device_prefetch
from vit_grid_model_tpu.parallel import mesh as meshlib


def test_pad_to_multiple():
    batch = {"a": np.arange(10).reshape(5, 2), "b": np.ones((5,))}
    padded, real = meshlib.pad_to_multiple(batch, 4)
    assert real == 5
    assert padded["a"].shape == (8, 2)
    # padding repeats the last row
    np.testing.assert_array_equal(padded["a"][5], padded["a"][4])
    same, real = meshlib.pad_to_multiple(batch, 5)
    assert same["a"].shape == (5, 2) and real == 5


def test_mesh_shapes_and_shard():
    mesh = meshlib.make_mesh(MeshConfig(data=4, model=2))
    assert dict(mesh.shape) == {"data": 4, "model": 2}
    batch = {"x": np.ones((8, 3), np.float32)}
    sharded = meshlib.shard_batch(mesh, batch)
    assert sharded["x"].sharding.spec == jax.sharding.PartitionSpec("data")


def test_distributed_single_process():
    distributed.initialize()          # no coordinator: silent no-op
    assert distributed.is_primary()
    assert distributed.local_batch_slice(8) == slice(0, 8)


def test_two_process_distributed():
    """An actual 2-process jax.distributed run (CPU, localhost coordinator):
    both processes join, local_batch_slice feeds disjoint shards, and a
    cross-host jit reduction returns the global sum."""
    import json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(worker))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env, text=True)
        for pid in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=180)
        assert p.returncode == 0, f"worker failed:\n{out}\n{err}"
        outs.append(json.loads(out.strip().splitlines()[-1]))

    by_pid = {o["pid"]: o for o in outs}
    assert by_pid[0]["process_count"] == by_pid[1]["process_count"] == 2
    assert by_pid[0]["is_primary"] and not by_pid[1]["is_primary"]
    assert by_pid[0]["slice"] == [0, 4] and by_pid[1]["slice"] == [4, 8]
    # sum(0..7) reduced across the two hosts' disjoint shards
    assert by_pid[0]["sum"] == by_pid[1]["sum"] == 28.0


def test_device_prefetch_order_and_laziness():
    puts = []

    def put(b):
        puts.append(b)
        return b * 10

    out = list(device_prefetch(iter([1, 2, 3]), put))
    assert out == [10, 20, 30]
    assert puts == [1, 2, 3]
    assert list(device_prefetch(iter([]), put)) == []


def test_mesh_subset_of_devices():
    """Review fix: --data_parallel k for k < device count builds a k-device
    sub-mesh instead of failing the coverage check."""
    devs = jax.devices()[:2]
    mesh = meshlib.make_mesh(MeshConfig(data=2, model=1), devices=devs)
    assert dict(mesh.shape) == {"data": 2, "model": 1}


def test_mesh_for_cli_batch_divisibility():
    import pytest

    with pytest.raises(ValueError, match="divide"):
        meshlib.mesh_for_cli(8, batch_size=3)
    mesh = meshlib.mesh_for_cli(8, batch_size=16)
    assert dict(mesh.shape) == {"data": 8, "model": 1}

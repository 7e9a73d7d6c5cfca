"""Device mesh construction and sharding rules.

The reference's entire inter-device story is single-process
``torch.nn.DataParallel`` (``evaluation_vit.py:107``): replicate the module,
scatter the batch, gather outputs.  The counterpart here is a named
``jax.sharding.Mesh`` plus ``NamedSharding`` annotations consumed by ``jit``
— GSPMD inserts all collectives (gradient psum, output gather), which XLA
hands to NCCL over NVLink between the cards of a host, and the same code
scales across hosts via ``jax.distributed.initialize``.  The mesh shape
follows the algorithm (data x model), not the interconnect.

Axes:
* ``data``  — batch (and the fused B*L lead axis): pure data parallelism,
  the reference-parity axis;
* ``model`` — attention heads / channels: optional tensor parallelism the
  reference never had (32 heads, ``maxvit.py:111``, split cleanly).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from vit_grid_model_tpu.core.config import MeshConfig


def make_mesh(cfg: MeshConfig = MeshConfig(),
              devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    model = max(1, cfg.model)
    data = cfg.data if cfg.data > 0 else n // model
    if data * model != n:
        raise ValueError(
            f"mesh {data}x{model} does not cover {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, cfg.axis_names)


def mesh_for_cli(data_parallel: int,
                 batch_size: Optional[int] = None) -> Mesh:
    """The CLIs' shared ``--data_parallel`` contract in one place: ``-1`` =
    all devices, ``k > 0`` = a k-device subset, as a pure data mesh.
    ``batch_size``, when given, is validated to divide over the data axis
    up front — device_put otherwise fails with an obscure error."""
    devs = jax.devices()[:data_parallel] if data_parallel > 0 else None
    mesh = make_mesh(MeshConfig(data=data_parallel, model=1), devices=devs)
    print(f"mesh: {dict(mesh.shape)}")
    if batch_size is not None and batch_size % mesh.shape["data"] != 0:
        raise ValueError(
            f"batch_size {batch_size} must divide over the mesh data axis "
            f"({mesh.shape['data']} devices)")
    return mesh


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading batch axis across 'data'; everything else local."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def param_sharding(mesh: Mesh, params, tensor_parallel: bool = False):
    """Sharding pytree for the parameters.

    Default: fully replicated (DataParallel-equivalent).  With
    ``tensor_parallel`` and a >1 'model' axis, the attention projection
    matrices split across heads: qkv on the output feature axis, the output
    projection on the input feature axis — the classic Megatron pairing, so
    the only collective per attention layer is the psum XLA inserts after
    ``to_out``.
    """
    if not tensor_parallel or mesh.shape["model"] == 1:
        return jax.tree.map(lambda _: replicated(mesh), params)

    def rule(path, leaf):
        keys = [str(getattr(p, "key", "")) for p in path]
        if "to_qkv" in keys and keys[-1] == "w":
            return NamedSharding(mesh, P(None, "model"))
        if "to_out" in keys and keys[-1] == "w":
            return NamedSharding(mesh, P("model", None))
        if ("q_norm" in keys or "k_norm" in keys) and keys[-1] == "gamma":
            return NamedSharding(mesh, P("model", None, None))
        if "rel_pos_bias" in keys and keys[-1] == "table":
            return NamedSharding(mesh, P(None, "model"))
        return replicated(mesh)

    return jax.tree_util.tree_map_with_path(rule, params)


def shard_batch(mesh: Mesh, batch):
    """Place a host numpy batch into the device layout, batch-axis sharded."""
    s = batch_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, s), batch)


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis to a device-count multiple (eval keeps
    ``drop_last=False`` like the reference, ``evaluation_vit.py:138``).
    Returns (padded_batch, real_count)."""
    import numpy as np

    def pad(x):
        b = x.shape[0]
        rem = (-b) % multiple
        if rem == 0:
            return x
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)

    first = jax.tree.leaves(batch)[0]
    return jax.tree.map(pad, batch), first.shape[0]

"""Test harness setup: run everything on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without any accelerator ('test
multi-node without a cluster', SURVEY.md §4).  Tests that need a GPU carry
the ``gpu`` marker and skip here (see the ``gpu`` fixture)."""

import os
import sys

import numpy as np
import pytest

# CPU unless the caller names platforms (on a card:
# JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

# An accelerator's default matmul precision may round f32 operands (TF32 on
# an H100); golden-activation parity vs torch needs true f32 accumulation.
jax.config.update("jax_default_matmul_precision", "highest")

# Set the platform and device count through jax.config as well: it wins
# over an environment that pre-registers another platform, so the
# multi-device sharding tests run on 8 virtual CPU devices.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_num_cpu_devices", 8)

# The entry points keep a persistent compile cache in the checkout
# (``core/jaxcache.py``); test runs write nothing there.
jax.config.update("jax_enable_compilation_cache", False)

REFERENCE_SRC = "/root/reference/src"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_SRC)


def add_reference_to_path():
    """Make the reference torch implementation importable for
    golden-activation parity tests.  Patches the pieces that assume a GPU
    box: ``.cuda()`` no-ops on CPU, the interactive-debugger imports
    (``metnet3.py:11``) are stubbed, and ``xarray`` (absent in this image)
    is backed by a minimal shim over our NetCDF reader."""
    if REFERENCE_SRC not in sys.path:
        sys.path.insert(0, REFERENCE_SRC)
    import types

    import torch

    torch.Tensor.cuda = lambda self, *a, **k: self
    if not hasattr(np, "Inf"):
        np.Inf = np.inf   # reference predates numpy 2 (``dataset.py:79``)
    for name in ("ipdb",):
        if name not in sys.modules:
            mod = types.ModuleType(name)
            mod.set_trace = lambda *a, **k: None
            sys.modules[name] = mod
    if "xarray" not in sys.modules:
        try:
            import xarray  # noqa: F401
        except ImportError:
            from scipy.io import netcdf_file

            class _Var:
                def __init__(self, values):
                    self.values = values

            class _FakeDataset:
                def __init__(self, path):
                    self._path = path

                def __getitem__(self, var):
                    with netcdf_file(self._path, "r", mmap=False) as f:
                        # scipy returns big-endian; torch needs native order
                        arr = np.array(f.variables[var][:])
                        return _Var(np.ascontiguousarray(
                            arr, dtype=arr.dtype.newbyteorder("=")))

                def __enter__(self):
                    return self

                def __exit__(self, *a):
                    return False

            mod = types.ModuleType("xarray")
            mod.open_dataset = _FakeDataset
            sys.modules["xarray"] = mod


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none.  Decided when the
    test runs, never at import, so every worker collects the same tests."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card: python -m pytest -m gpu)")
    return devices[0]

"""Device-memory exhaustion guard (``utils/hbm.py``): classification and rewrap."""

import pytest

from vit_grid_model_tpu.utils.hbm import is_oom_error, oom_guard


def test_is_oom_error_classification():
    assert is_oom_error(RuntimeError(
        "RESOURCE_EXHAUSTED: Attempting to reserve 12.6G at the bottom of "
        "memory. That was not possible."))
    assert is_oom_error(ValueError("XLA: Out of memory allocating buffer"))
    assert not is_oom_error(ValueError("shape mismatch"))
    assert not is_oom_error(KeyboardInterrupt())
    # non-XLA errors that merely mention memory must NOT be classified
    # (advisor r4: a loader IOError would be rewrapped as a memory failure)
    assert not is_oom_error(IOError("mmap failed: out of memory"))
    assert not is_oom_error(RuntimeError("Attempting to reserve a worker"))


def test_oom_guard_rewraps_with_context():
    with pytest.raises(RuntimeError) as ei:
        with oom_guard("flagship inference", 256):
            raise RuntimeError(
                "RESOURCE_EXHAUSTED: <three pages of buffer assignment>")
    msg = str(ei.value)
    assert "flagship inference" in msg
    assert "batch_size=256" in msg
    # the message names the device's own memory limit, not a constant
    assert "available to this process" in msg
    assert "hbm_envelope" in msg
    assert isinstance(ei.value.__cause__, RuntimeError)   # chained


def test_oom_guard_passes_other_errors():
    with pytest.raises(ValueError, match="shape mismatch"):
        with oom_guard("x", 1):
            raise ValueError("shape mismatch")

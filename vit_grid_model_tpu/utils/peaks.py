"""Published peak rates of the accelerators the benchmarks divide by.

One table, keyed by ``jax.Device.device_kind``.  A device that is not in the
table is an error, not a default: a utilization against the wrong peak is a
wrong number.  Rates are dense (no sparsity) and assume the card's full
power limit; a card set below it cannot hold its top clock under load, so
every benchmark prints the power limit beside the share.
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys


@dataclasses.dataclass(frozen=True)
class DevicePeaks:
    bf16_flops: float          # FLOP/s, bf16 tensor cores
    tf32_flops: float          # FLOP/s, f32 matmuls at default precision
    f32_flops: float           # FLOP/s, f32 outside the tensor cores
    mem_bytes_per_s: float     # device-memory bandwidth
    source: str

    def matmul_peak(self, dtype: str, precision: str) -> float:
        """The peak a forward of ``dtype`` at matmul ``precision`` runs
        against: bf16 (and int8 convs, judged on the bf16 flop basis) on the
        bf16 rate; float32 at "highest" on the f32 rate, otherwise TF32."""
        if dtype in ("bfloat16", "int8"):
            return self.bf16_flops
        return self.f32_flops if precision == "highest" else self.tf32_flops


_H100_SXM = DevicePeaks(
    bf16_flops=989e12, tf32_flops=495e12, f32_flops=67e12,
    mem_bytes_per_s=3.35e12,
    source="NVIDIA H100 Tensor Core GPU data sheet, H100 SXM, dense rates")

PEAKS = {
    "NVIDIA H100 80GB HBM3": _H100_SXM,
}


def peaks_for(device_kind: str) -> DevicePeaks:
    """The peaks of ``device_kind``; raises for a device not in the table."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its "
            f"data-sheet rates to vit_grid_model_tpu/utils/peaks.py "
            f"(known: {sorted(PEAKS)})") from None


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the first card, read
    by a child process that does not import JAX; raises when there is no
    ``nvidia-smi`` or it fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def accelerator_fields(what: str) -> dict:
    """The device fields every benchmark result carries: platform, device
    kind, device count and the card's name and power limit.  Exits the
    process (non-zero, no result) when JAX finds no accelerator: a
    measurement path never falls back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform == "cpu":
        sys.exit(f"{what}: no accelerator found (JAX sees only the CPU); "
                 f"this measures a device")
    return {"platform": devices[0].platform,
            "device_kind": devices[0].device_kind,
            "device_count": len(devices),
            "card": card_name_and_power_limit()}

"""Device-time breakdown of the ``--fast`` forward from a profiler trace.

Compiles the shipped 12hr forward in fast mode (bf16, fused lead stem,
host-prepared NHWC input) at batch B, times single calls ended by
``jax.block_until_ready`` with the profiler off, then traces a few calls
with ``jax.profiler`` and reduces the trace to:

* the device time of every op, attributed to the ``jax.named_scope`` it was
  traced under (``models/maxvit.py`` names ``block_attn`` and
  ``grid_attn``) through the op metadata of the compiled HLO;
* the block- and grid-attention device time per forward and their share of
  the forward's summed kernel time;
* the device busy time (union of kernel intervals) per forward.

XLA's CUDA graphs (command buffers) are turned off for the whole run, so
each kernel shows in the trace under its own HLO op; the timed calls run
the same program.  Prints one JSON line and writes the top ops to
``<out>/trace_forward.json``.  Needs an accelerator; on the CPU it exits
non-zero.

Usage:  python benchmarks/trace_forward.py [--batch 32] [--out trace_out]
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPES = ("block_attn", "grid_attn")
NO_COMMAND_BUFFERS = "--xla_gpu_enable_command_buffer="
_COMPUTATION = re.compile(r"^\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$")
_INSTRUCTION = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=")
_OP_NAME = re.compile(r'op_name="([^"]*)"')
_CALLED = re.compile(r"(?:calls|to_apply|body|condition)=\{?([^}\s]+(?:,\s*%[\w.\-]+)*)")


def scope_of(op_name: str) -> str:
    for s in SCOPES:
        if f"/{s}/" in f"/{op_name}/":
            return s
    return "other"


def hlo_op_scopes(hlo_text: str) -> dict:
    """Instruction name -> named scope, for every instruction of an HLO
    module's text.  An instruction's scope is the most common scope among
    its own ``op_name`` metadata and that of every instruction in the
    computations it calls (a fusion carries its ops' names only inside its
    fused computation)."""
    own, calls, members = {}, {}, collections.defaultdict(list)
    comp = None
    for line in hlo_text.splitlines():
        m = _INSTRUCTION.match(line)
        if m:
            name = m.group(1)
            own[name] = _OP_NAME.findall(line)
            called = []
            for group in _CALLED.findall(line):
                called += [c.strip().lstrip("%") for c in group.split(",")]
            calls[name] = called
            if comp is not None:
                members[comp].append(name)
            continue
        m = _COMPUTATION.match(line)
        if m:
            comp = m.group(1)

    memo = {}

    def names(instr, depth=0):
        if instr in memo:
            return memo[instr]
        out = list(own.get(instr, ()))
        if depth < 8:
            for c in calls.get(instr, ()):
                for member in members.get(c, ()):
                    out += names(member, depth + 1)
        memo[instr] = out
        return out

    scopes = {}
    for instr in own:
        counts = collections.Counter(scope_of(n) for n in names(instr))
        scopes[instr] = counts.most_common(1)[0][0] if counts else None
    return scopes


def reduce_trace(path: str, op_scopes: dict, n_calls: int) -> dict:
    """Device events of one ``.xplane.pb`` reduced to per-forward times;
    ``op_scopes`` maps HLO instruction names to scopes (``hlo_op_scopes``)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    by_scope = collections.Counter()
    by_op = collections.Counter()
    op_scope = {}
    intervals = []
    unmatched = 0
    for plane in data.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                stats = dict(ev.stats)
                op = str(stats.get("hlo_op", ev.name))
                scope = op_scopes.get(op)
                if scope is None:
                    unmatched += 1
                    scope = scope_of(" ".join(str(v) for v in stats.values()))
                by_scope[scope] += ev.duration_ns
                by_op[op] += ev.duration_ns
                op_scope[op] = scope
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            busy += b - max(a, end)
            end = b
    kernel_sum = sum(by_scope.values())
    if not kernel_sum:
        raise RuntimeError(f"no device events in {path}")
    per_call = 1e-6 / n_calls                      # ns over calls -> ms
    return {
        "kernel_ms_per_forward": kernel_sum * per_call,
        "busy_ms_per_forward": busy * per_call,
        "scope_ms_per_forward": {s: v * per_call
                                 for s, v in by_scope.items()},
        "attention_share_of_kernel_time": (
            (by_scope["block_attn"] + by_scope["grid_attn"]) / kernel_sum),
        "device_events": len(intervals),
        "events_without_hlo_scope": unmatched,
        "top_ops": [{"op": op, "scope": op_scope[op],
                     "ms_per_forward": v * per_call}
                    for op, v in by_op.most_common(40)],
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--trace_calls", type=int, default=3)
    ap.add_argument("--out", type=str, default="trace_out",
                    help="directory for the trace and its reduction")
    args = ap.parse_args(argv)

    # CUDA graphs ("command buffers") show in a trace as one op that hides
    # the kernels inside; trace the forward with them off, and say so
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " " + NO_COMMAND_BUFFERS).strip()
    from vit_grid_model_tpu.core.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from vit_grid_model_tpu.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu.data.assembly import model_input_to_nhwc
    from vit_grid_model_tpu.models.metnet3 import metnet3_apply, metnet3_init
    from vit_grid_model_tpu.utils.peaks import accelerator_fields

    device = accelerator_fields("trace_forward")

    cfg = dataclasses.replace(
        shipped_12hr_model_config(pm25_mean=22.5, pm25_std=15.5),
        compute_dtype="bfloat16", fuse_lead_stem=True, nhwc_input=True)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    B = args.batch
    rng = np.random.default_rng(1)
    x = model_input_to_nhwc(
        rng.random((B, 25, 24, 82, 67), dtype=np.float32) * 50.0,
        cfg.pad_multiple, jnp.bfloat16).copy()
    ts = np.tile(np.asarray([2023.0, 1.0, 15.0, 6.0], np.float32),
                 (B, 25, 1))
    params, x, ts = jax.device_put((params, x, ts))

    def forward(p, xx, tt):
        return metnet3_apply(p, xx, tt, cfg)

    t0 = time.perf_counter()
    compiled = jax.jit(forward).lower(params, x, ts).compile()
    compile_s = time.perf_counter() - t0
    for _ in range(3):
        jax.block_until_ready(compiled(params, x, ts))
    times = []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(params, x, ts))
        times.append(time.perf_counter() - t0)

    trace_dir = os.path.join(args.out, "trace_forward")
    jax.profiler.start_trace(trace_dir)
    for _ in range(args.trace_calls):
        jax.block_until_ready(compiled(params, x, ts))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    red = reduce_trace(path, hlo_op_scopes(compiled.as_text()),
                       args.trace_calls)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "trace_forward.json"), "w") as f:
        json.dump(red, f, indent=1)
    top = red.pop("top_ops")
    print(json.dumps({
        "metric": "fast_forward_trace",
        "batch": B,
        "wall_ms_median": float(np.median(times)) * 1e3,
        "wall_ms_min": min(times) * 1e3,
        "compile_s": compile_s,
        **red,
        "top_op": top[0],
        "xla_flags": os.environ["XLA_FLAGS"],
        **device,
    }))


if __name__ == "__main__":
    main()

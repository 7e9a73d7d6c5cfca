"""vit_grid_model_tpu — a JAX/XLA framework with the capabilities of the
reference ``jhsk777/VIT-Grid-Model``, run on NVIDIA GPUs.

The framework ingests CMAQ chemical-transport simulation output over an 82x67
Korean-peninsula grid, runs a MaxViT-based encoder-decoder (MetNet-3 style) to
produce multi-horizon PM2.5 re-analysis fields, and evaluates them with the
reference's full metric suite.  Everything in the compute path is functional
JAX compiled by XLA; parameters are plain pytrees; multi-chip scaling
is expressed with ``jax.sharding.Mesh`` + ``jit`` shardings rather than
replicated-module wrappers.

Layout:
    core/        config, pytree/param utilities, checkpointing, torch import
    ops/         functional NHWC primitives (conv, norms, attention, windows)
    models/      MaxViT backbone, MetNet3 (+ station-image variant),
                 legacy LSTM/attention station models, SimVP, normalizers
    data/        CMAQ cycle/lead arithmetic, readers, dataset variants,
                 synthetic fixtures, prefetching input pipeline
    parallel/    device mesh construction and sharding rules
    train/       Focal-R loss and the jit-ed training loop
    evaluation/  vectorized metric engine + byte-compatible log writer
    cli/         signature-compatible command-line entry points
"""

__version__ = "0.1.0"

from vit_grid_model_tpu.core import config as config  # noqa: F401

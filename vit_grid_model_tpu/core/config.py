"""Frozen configuration dataclasses for the framework.

The reference drives everything through argparse flags
(``evaluation_vit.py:694-721``); here the same surface is captured in frozen
dataclasses so configs are hashable (usable as jit static args) and
self-documenting.  The CLI layer converts argparse namespaces into these.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """The CMAQ grid geometry (reference: ``evaluation_vit.py:89``)."""

    height: int = 82
    width: int = 67

    @property
    def cells(self) -> int:
        return self.height * self.width


@dataclasses.dataclass(frozen=True)
class MetNet3Config:
    """Architecture config of the MaxViT MetNet3 grid model.

    Field defaults mirror the reference constructor defaults
    (``metnet3.py:192-219``) with the shipped 12hr run's values for the
    required fields (``logs/test_simulation_vit_model_12hr.log:1``).
    """

    # (window_size, n_variables, height, width) == input_size_sample
    window_size: int = 25          # input_dim + output_dim (13 + 12)
    n_variables: int = 24          # 6 species x 4 daily init cycles
    input_height: int = 82
    input_width: int = 67

    n_start_channels: int = 128    # hidden_dim
    end_lead_time: int = 12        # output_dim

    lead_time_emb_dim: int = 2
    model_time_emb_dim: int = 1
    concat_time_to_input: bool = True

    pm25: bool = True
    pm10: bool = False
    pm25_boundaries: Tuple[float, ...] = (15.0, 35.0, 75.0)
    pm10_boundaries: Tuple[float, ...] = (15.0, 35.0, 75.0)
    pm25_mean: float = 0.0
    pm25_std: float = 1.0

    resnet_block_depth: int = 2
    direct_regional: bool = False
    ignore_backbone: bool = False
    # class-logits PM2.5 head (the documented training contract,
    # ``metnet3.py:432-490``) instead of the live 1-channel regression head
    pm25_class_head: bool = False

    # MaxViT backbone
    vit_block_depth: Tuple[int, ...] = (1,)
    n_heads: int = 32
    dim_head: int = 32
    vit_window_size: int = 7
    mbconv_expansion_rate: int = 4
    mbconv_shrinkage_rate: float = 0.25
    dropout: float = 0.1
    num_register_tokens: int = 4
    normalization_method: str = "Standard"

    # Channel indices of the four daily-cycle PM2.5 planes that get
    # standardized inside forward (reference quirk, ``metnet3.py:362``).
    pm25_channel_indices: Tuple[int, ...] = (4, 10, 16, 22)

    # Extra station-observation image channel (MetNet3_with_stn_imgs,
    # ``metnet3.py:701`` normalizes channel 24 when this is set).
    stn_img_channel: Optional[int] = None

    # Execution knobs (additive; no reference equivalent).
    pad_multiple: int = 14         # pad() target multiple (``metnet3.py:324``)
    compute_dtype: str = "float32"  # "bfloat16" for throughput mode
    # Compute the shared (lead-independent) part of the stem conv once per
    # sample instead of once per (sample, lead).  Exact up to float
    # re-association; disable for bit-level parity testing.
    fuse_lead_stem: bool = False
    # Inference only: fold MBConv's three BatchNorms into the adjacent conv
    # weights (``ops/nn.py::fold_bn_into_conv``) — removes three elementwise
    # passes over the 4x-expanded hidden activations.  Equivalent up to one
    # float re-association per channel (equivalence-tested); off by default
    # so the parity path keeps the reference's separate-BN numerics
    # (``maxvit.py:87-97``).
    fold_bn_eval: bool = False
    # Input arrives HOST-PREPARED in the device layout: (B, Hp, Wp, T*C)
    # channels-last, already zero-padded to pad_multiple and already in
    # compute_dtype, PM channels still raw (standardization stays
    # in-forward, reference quirk ``metnet3.py:362``).  Skips the
    # (B,T,C,H,W)->NHWC relayout on the device by letting the host
    # assembler emit this layout directly (its native stack is already
    # channels-last; ``data/assembly.py::sim_stack_to_nhwc_input``).
    # Bit-exact vs the bf16-staged (B,T,C,H,W) path (tests/test_nhwc_input.py).
    # Covers every variant incl. stn_img_channel (the station-image channel
    # rides the fused T*C axis; host side: assembly.model_input_to_nhwc).
    nhwc_input: bool = False
    # Inference only: run the resnet1/resnet2 3x3 convs through int8
    # (per-output-channel weights, static calibrated per-tensor activation
    # scales — ``ops/quantize.py``).  Requires params carrying int8
    # sidecars (``quantize_metnet3_int8``); params without sidecars fall
    # back to the float path conv-by-conv.  Accuracy-gated in
    # ``bench.py --dtype int8``.
    int8_convs: bool = False

    @property
    def n_input_channels(self) -> int:
        return self.window_size * self.n_variables

    @property
    def cond_dim(self) -> int:
        return self.lead_time_emb_dim

    @property
    def depth_tuple(self) -> Tuple[int, ...]:
        d = self.vit_block_depth
        return (d,) if isinstance(d, int) else tuple(d)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Dataset assembly parameters (reference: ``dataset.py`` ctor args and
    ``evaluation_vit.py:694-721`` argparse surface)."""

    input_dim: int = 13
    output_dim: int = 12
    prev_len: int = 13
    feat_dim: int = 12             # station feature dim; feat_dim//2 = 6 species
    grid: GridConfig = GridConfig()

    data_path: str = "../preprocessed_data_from_2016"
    sim_data_path: str = "../../short_term/nier_preprocessed/CMAQ"
    analysis_data_path: str = "../analysis/CMAQ"

    @property
    def species_per_cycle(self) -> int:
        return self.feat_dim // 2

    @property
    def block_channels(self) -> int:
        """Channels per timestep in the stacked CMAQ tensor:
        6 species x 4 cycles + 4 lead-time scalars (``dataset.py:734``)."""
        return self.species_per_cycle * 4 + 4

    @property
    def total_steps(self) -> int:
        return self.input_dim + self.output_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters.  The reference ships no training loop
    (SURVEY.md §3.5); Focal-R is the documented objective (README.md:16)."""

    learning_rate: float = 3e-4
    weight_decay: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 100_000
    batch_size: int = 4
    grad_clip_norm: float = 1.0
    focal_gamma: float = 1.0       # Focal-R activation exponent
    focal_beta: float = 0.2        # scaling of |error| inside the focal weight
    focal_focusing: str = "canonical"  # canonical (2*sigma-1)^g | sigmoid
                                   # (legacy [0.5,1) form; see losses.py)
    loss: str = "focal_r"          # focal_r | mse | mae | huber
    ema_decay: float = 0.0         # >0: keep an EMA copy of params
                                   # (TrainState.ema_params), saved as
                                   # {model_name}_ema.npz
    seed: int = 0
    remat: bool = False            # jax.checkpoint the backbone


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout.  The reference's only parallelism is
    single-process DataParallel (``evaluation_vit.py:107``); here the same
    capability (and beyond) is a named mesh consumed by jit shardings."""

    data: int = -1                 # -1: all remaining devices
    model: int = 1                 # tensor-parallel size (attention heads)
    axis_names: Tuple[str, ...] = ("data", "model")


def shipped_12hr_model_config(pm25_mean: float, pm25_std: float) -> MetNet3Config:
    """Config of the shipped ``simulation_vit_model_12hr.pkt`` run
    (``logs/test_simulation_vit_model_12hr.log:1``)."""
    return MetNet3Config(
        window_size=25,
        n_variables=24,
        n_start_channels=128,
        end_lead_time=12,
        pm25_mean=pm25_mean,
        pm25_std=pm25_std,
    )

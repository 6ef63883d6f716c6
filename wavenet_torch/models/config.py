"""WaveNet model configuration (counterpart of ``wavenet_tpu/models/config.py``).

Field names mirror the keys of the reference's ``wavenet_params.json``, so
config files load unmodified via :func:`WaveNetConfig.from_json`, and the
``CONFIGS`` presets are the same as the JAX package's.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

# The reference repo's default dilation schedule: 1..512, five stacks.
DEFAULT_DILATIONS: Tuple[int, ...] = tuple([2 ** i for i in range(10)] * 5)


@dataclasses.dataclass(frozen=True)
class WaveNetConfig:
    """Hyperparameters of one WaveNet network (shape-defining only)."""

    filter_width: int = 2
    sample_rate: int = 16000
    dilations: Tuple[int, ...] = DEFAULT_DILATIONS
    residual_channels: int = 32
    dilation_channels: int = 32
    skip_channels: int = 512
    quantization_channels: int = 256
    use_biases: bool = True
    scalar_input: bool = False
    initial_filter_width: int = 32
    # Global conditioning: speaker embedding.
    gc_channels: Optional[int] = None
    gc_cardinality: Optional[int] = None
    # Local conditioning feature dim (post-upsampling) and learned
    # upsampling refinement width (0 = off).
    lc_channels: Optional[int] = None
    lc_refine_width: int = 0
    # "float32" or "bfloat16" (bf16 matmul operands and activations,
    # float32 params): the model and training take both; generation runs
    # at float32 whatever this says, as the JAX package's does (bf16
    # weights are the decode's own option, ``weight_dtype``).
    compute_dtype: str = "float32"
    remat: bool = False
    use_pallas_stack: bool = False
    pallas_stack_version: int = 3
    # Filter+gate as one conv with [fw, R, 2D] weights (same numerics).
    merged_filter_gate: bool = True

    def __post_init__(self):
        object.__setattr__(self, "dilations", tuple(self.dilations))
        if (self.gc_channels is None) != (self.gc_cardinality is None):
            raise ValueError(
                "gc_channels and gc_cardinality must be set together "
                f"(got {self.gc_channels=}, {self.gc_cardinality=})")
        if self.lc_refine_width and self.lc_channels is None:
            raise ValueError("lc_refine_width requires lc_channels")
        if self.lc_refine_width < 0 or (self.lc_refine_width
                                        and self.lc_refine_width % 2 == 0):
            raise ValueError("lc_refine_width must be 0 (off) or odd, got "
                             f"{self.lc_refine_width}")

    # -- derived -----------------------------------------------------------

    @property
    def gc_enabled(self) -> bool:
        return self.gc_channels is not None

    @property
    def lc_enabled(self) -> bool:
        return self.lc_channels is not None

    @property
    def num_layers(self) -> int:
        return len(self.dilations)

    @property
    def input_channels(self) -> int:
        return 1 if self.scalar_input else self.quantization_channels

    @property
    def receptive_field(self) -> int:
        from wavenet_torch.utils.receptive_field import (
            calculate_receptive_field)
        return calculate_receptive_field(
            self.filter_width, self.dilations, self.scalar_input,
            self.initial_filter_width)

    # -- (de)serialization -------------------------------------------------

    _JSON_KEYS = (
        "filter_width", "sample_rate", "dilations", "residual_channels",
        "dilation_channels", "skip_channels", "quantization_channels",
        "use_biases", "scalar_input", "initial_filter_width",
        "lc_channels", "lc_refine_width",
    )

    @classmethod
    def from_json(cls, path_or_dict, **overrides) -> "WaveNetConfig":
        """Load from a reference-format wavenet_params.json file or dict.

        Unknown keys are ignored; ``overrides`` win (how the CLIs inject
        --gc_channels / --gc_cardinality).
        """
        if isinstance(path_or_dict, dict):
            raw = dict(path_or_dict)
        else:
            with open(path_or_dict) as f:
                raw = json.load(f)
        kwargs = {k: raw[k] for k in cls._JSON_KEYS if k in raw}
        kwargs.update(overrides)
        return cls(**kwargs)

    def to_json_dict(self) -> dict:
        return {k: (list(v) if isinstance(v, tuple) else v)
                for k, v in ((key, getattr(self, key))
                             for key in self._JSON_KEYS)}


def tiny_config(**kw) -> WaveNetConfig:
    """10 layers (dilations 1..512), 16 residual / 32 skip channels."""
    d = dict(dilations=tuple(2 ** i for i in range(10)),
             residual_channels=16, dilation_channels=16, skip_channels=32,
             quantization_channels=256)
    d.update(kw)
    return WaveNetConfig(**d)


def paper_config(**kw) -> WaveNetConfig:
    """30 layers (3 stacks of 1..512), 32 residual / 512 skip channels."""
    d = dict(dilations=tuple([2 ** i for i in range(10)] * 3),
             residual_channels=32, dilation_channels=32, skip_channels=512)
    d.update(kw)
    return WaveNetConfig(**d)


def gc_config(**kw) -> WaveNetConfig:
    """paper + 109-speaker VCTK global conditioning."""
    d = dict(dilations=tuple([2 ** i for i in range(10)] * 3),
             residual_channels=32, dilation_channels=32, skip_channels=512,
             gc_channels=32, gc_cardinality=109)
    d.update(kw)
    return WaveNetConfig(**d)


def wide_config(**kw) -> WaveNetConfig:
    """64 residual / 1024 skip channels, scalar input."""
    d = dict(dilations=tuple([2 ** i for i in range(10)] * 3),
             residual_channels=64, dilation_channels=64, skip_channels=1024,
             scalar_input=True, initial_filter_width=32)
    d.update(kw)
    return WaveNetConfig(**d)


def sharded_config(**kw) -> WaveNetConfig:
    """80 layers, 256 residual channels — the model-sharded config."""
    d = dict(dilations=tuple([2 ** i for i in range(10)] * 8),
             residual_channels=256, dilation_channels=256, skip_channels=512)
    d.update(kw)
    return WaveNetConfig(**d)


CONFIGS = {
    "tiny": tiny_config,
    "paper": paper_config,
    "gc": gc_config,
    "wide": wide_config,
    "sharded": sharded_config,
}

"""The port's copy of the ``svol_tpu/config.py`` fields this slice reads.

Same names and defaults as the JAX package's ``DataConfig``/``ModelConfig``
(the flagship configuration), plus its ``num_queries`` check. Only the
svanet head over the ResNet backbone with the conv7 stem and sine positions
is ported; other values raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict


@dataclass
class DataConfig:
    num_frames: int = 32
    num_input_sketches: int = 1
    image_size: int = 224


@dataclass
class ModelConfig:
    sketch_head: str = "svanet"
    backbone: str = "resnet"
    hidden_dim: int = 256
    nheads: int = 8
    num_layers: int = 2
    num_queries: int = 320
    num_queries_per_frame: int = 10
    n_input_proj: int = 2
    cmt_dim_feedforward: int = 2048
    video_position_embedding: str = "sine"
    aux_loss: bool = True
    num_classes: int = 2
    # hand-written CUDA kernels: the gated sketch->video op and the unmasked
    # video/query self-attention (ops/kernels/)
    use_pallas_attention: bool = False
    use_flash_attention: bool = True
    resnet_stem: str = "conv7"
    compute_dtype: str = "bfloat16"


@dataclass
class SvolConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        m, d = self.model, self.data
        if m.num_queries != d.num_frames * m.num_queries_per_frame:
            raise ValueError(
                f"num_queries ({m.num_queries}) must equal num_frames "
                f"({d.num_frames}) * num_queries_per_frame ({m.num_queries_per_frame}); "
                "the reference asserts the same (matcher.py:56)."
            )
        for name, got, ported in (
            ("sketch_head", m.sketch_head, "svanet"),
            ("backbone", m.backbone, "resnet"),
            ("resnet_stem", m.resnet_stem, "conv7"),
            ("video_position_embedding", m.video_position_embedding, "sine"),
        ):
            if got != ported:
                raise NotImplementedError(
                    f"{name}={got!r} is not ported yet (only {ported!r})")
        if m.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SvolConfig":
        return cls(data=DataConfig(**d.get("data", {})),
                   model=ModelConfig(**d.get("model", {})))

"""The port's copy of the ``svol_tpu/config.py`` fields it reads.

Same names and defaults as the JAX package's ``DataConfig``/``ModelConfig``/
``LossConfig``/``TrainConfig`` (the flagship configuration), plus its
checks. Only the svanet head over the ResNet backbone with the conv7 stem
or over the ViT-B/16 backbone (serving only), sine positions, the
per-frame matcher with the on-device solver, AdamW with StepLR, and int8
serving of the ResNet trunk and the flash self-attention are ported; other
values raise.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class DataConfig:
    bs: int = 16
    num_frames: int = 32
    num_input_sketches: int = 1
    image_size: int = 224
    # static-shape cap on boxes per frame; the per-frame matcher needs it
    # equal to num_queries_per_frame (losses/matcher.py checks the shapes)
    max_boxes_per_frame: int = 10


@dataclass
class ModelConfig:
    sketch_head: str = "svanet"
    # 'resnet' | 'vit' (ViT-B/16; serving only in the port so far)
    backbone: str = "resnet"
    hidden_dim: int = 256
    nheads: int = 8
    num_layers: int = 2
    num_queries: int = 320
    num_queries_per_frame: int = 10
    # dropout before the Linear of each input-projection layer (train only)
    input_dropout: float = 0.4
    n_input_proj: int = 2
    # the other heads' transformer dropout; the svanet path reads none
    dropout: float = 0.1
    cmt_dim_feedforward: int = 2048
    video_position_embedding: str = "sine"
    aux_loss: bool = True
    num_classes: int = 2
    # hand-written CUDA kernels: the gated sketch->video op and the unmasked
    # video/query self-attention (ops/kernels/)
    use_pallas_attention: bool = False
    use_flash_attention: bool = True
    # int8 serving path (ops/quant.py): the ResNet convs run int8 products
    # with per-output-channel weight scales and per-tensor activation
    # scales, dynamic or calibrated. Eval only: train mode keeps float
    # convs. None | 'int8'
    quantize: Optional[str] = None
    # with quantize='int8': the flash self-attention runs its QK and PV
    # products in int8 too (ops/kernels/flash_attention_int8.py)
    quantize_attention: bool = False
    resnet_stem: str = "conv7"
    compute_dtype: str = "bfloat16"
    moe_experts: int = 0


@dataclass
class LossConfig:
    matcher: str = "per_frame_matcher"
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 1.0
    set_cost_class: float = 2.0
    eos_coef: float = 0.1
    aux_loss: bool = True
    # the exact Hungarian solve on the card (ops/hungarian.py)
    hungarian_impl: str = "on_device"
    # solve final + aux matching as one (layers * B * T)-wide LSAP
    merged_matcher: bool = False


@dataclass
class TrainConfig:
    seed: int = 1
    lr: float = 1e-4
    lr_drop_step: int = 20_000
    wd: float = 1e-4
    optimizer: str = "adamw"
    scheduler: str = "steplr"
    # global-norm gradient clipping; 0.0 = off
    grad_clip_norm: float = 0.0
    # ema <- d * ema + (1 - d) * params after each step; 0.0 = off
    ema_decay: float = 0.0
    freeze_backbone: bool = False


@dataclass
class EvalConfig:
    # static-scale int8: collect activation scales from this many dataset
    # batches before the run (0 = dynamic scales; needs quantize='int8').
    # The export and eval CLIs that read it are not ported, so only 0 is
    # taken; calibrate with ops.quant.calibrate_scales on batches you give.
    calibration_batches: int = 0


@dataclass
class SvolConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def __post_init__(self) -> None:
        self.validate()

    def validate(self) -> None:
        m, d, l, t = self.model, self.data, self.loss, self.train
        if m.num_queries != d.num_frames * m.num_queries_per_frame:
            raise ValueError(
                f"num_queries ({m.num_queries}) must equal num_frames "
                f"({d.num_frames}) * num_queries_per_frame ({m.num_queries_per_frame}); "
                "the reference asserts the same (matcher.py:56)."
            )
        if m.backbone not in ("resnet", "vit"):
            raise ValueError(f"unknown backbone {m.backbone!r}")
        for name, got, ported in (
            ("sketch_head", m.sketch_head, "svanet"),
            ("resnet_stem", m.resnet_stem, "conv7"),
            ("video_position_embedding", m.video_position_embedding, "sine"),
            ("matcher", l.matcher, "per_frame_matcher"),
            ("hungarian_impl", l.hungarian_impl, "on_device"),
            ("optimizer", t.optimizer, "adamw"),
            ("scheduler", t.scheduler, "steplr"),
        ):
            if got != ported:
                raise NotImplementedError(
                    f"{name}={got!r} is not ported yet (only {ported!r})")
        if m.moe_experts > 1:
            raise NotImplementedError("moe_experts > 1 is not ported yet")
        if t.freeze_backbone:
            raise NotImplementedError("freeze_backbone is not ported yet")
        if self.eval.calibration_batches > 0:
            raise NotImplementedError(
                "calibration_batches > 0 is not ported yet (it calibrates from the "
                "dataset); calibrate with ops.quant.calibrate_scales instead")
        if m.quantize in ("", "none", "None"):
            m.quantize = None
        if m.quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {m.quantize!r}")
        if m.quantize and m.backbone != "resnet":
            raise ValueError("--quantize supports ResNet backbones only")
        if m.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"unknown compute_dtype {m.compute_dtype!r}")
        if not 0.0 <= m.input_dropout < 1.0:
            raise ValueError("input_dropout must be in [0, 1)")
        if t.grad_clip_norm < 0:
            raise ValueError("grad_clip_norm must be >= 0 (0 = off)")
        if not 0.0 <= t.ema_decay < 1.0:
            raise ValueError("ema_decay must be in [0, 1) (0 = off)")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "SvolConfig":
        return cls(data=DataConfig(**d.get("data", {})),
                   model=ModelConfig(**d.get("model", {})),
                   loss=LossConfig(**d.get("loss", {})),
                   train=TrainConfig(**d.get("train", {})),
                   eval=EvalConfig(**d.get("eval", {})))

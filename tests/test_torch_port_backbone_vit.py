"""The port's ViT-B/16 serving slice against the JAX package, on the CPU.

* LayerNorm: the port's ``layer_norm_reference`` (what its wrapper and its
  ``FusedLayerNorm`` run on a CPU tensor) against the JAX package's Pallas
  ``fused_layer_norm`` in interpret mode and its ``layer_norm_reference``.
* (B, L, D) attention: the port's ``attention_bld_reference`` (the CPU
  route of ``flash_attention_bld``) against the JAX ``flash_attention_bld``
  in interpret mode and ``attention_reference`` applied per head slice.
* The ViT encoder at a small width, both sides with flash attention on.
* The whole model with ``backbone="vit"``: the JAX ViT is ViT-B/16 at any
  image size, so exactly one test builds the full-width pair (171 M
  parameters), at 32 px, T = 2, B = 1, with the flagship head shrunk as in
  test_torch_port_model.py. The JAX side runs its plain attention path
  (held equal to its kernel path at 2e-5 by
  tests/test_model_forward.py::test_vit_flash_attention_matches_einsum),
  the port its default kernel routes, which on the CPU are the plain
  versions.
* The config: ViT serving taken, int8 and training refused.

Weights are numpy draws carried over by ``convert_jax_variables``.
"""
import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from svol_tpu.config import DataConfig, ModelConfig, SvolConfig
from svol_tpu.models import build_model
from svol_tpu.models.backbone import ViTBackbone as JaxViTBackbone
from svol_tpu.models.vit import ViT as JaxViT
from svol_tpu.ops.pallas.flash_attention import attention_reference as jax_attention
from svol_tpu.ops.pallas.flash_attention import flash_attention_bld as jax_flash_bld
from svol_tpu.ops.pallas.layer_norm import fused_layer_norm as jax_fused_ln
from svol_tpu.ops.pallas.layer_norm import layer_norm_reference as jax_ln_reference
from svol_tpu_torch.config import DataConfig as PortData
from svol_tpu_torch.config import ModelConfig as PortModel
from svol_tpu_torch.config import SvolConfig as PortConfig
from svol_tpu_torch.models.model import SketchLocalizationModel
from svol_tpu_torch.models.vit import ViT
from svol_tpu_torch.ops.kernels.flash_attention import (
    attention_bld_reference,
    flash_attention_bld,
    flash_self_attention_bld,
)
from svol_tpu_torch.ops.kernels.layer_norm import (
    FusedLayerNorm,
    fused_layer_norm,
    layer_norm_reference,
)
from svol_tpu_torch.train.state import create_train_state
from svol_tpu_torch.train.steps import make_predict_fn, make_train_step
from svol_tpu_torch.utils.jax_weights import convert_jax_variables
from test_torch_port_model import SMALL, abstract_init, jax_predict_from, torch_batch
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
D_VIT = 768


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bfloat16 spacing at |x| (8 significant bits)."""
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def assert_close(got: torch.Tensor, want: np.ndarray, dtype: str, atol: float,
                 rtol: float = 0.0):
    """f32: within ``atol + rtol |want|``. bf16: within one bf16 ulp of the
    output plus that f32 tolerance: each side rounds its f32 result once, so
    they may land one ulp apart, and the f32 results differ only in the
    order of their sums (and, for LayerNorm, in the last bits of rsqrt),
    which is more than an ulp only for outputs near zero."""
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    else:
        excess = np.abs(got - want) - bf16_ulp(want) - atol - rtol * np.abs(want)
        assert excess.max() <= 0, f"beyond one bf16 ulp by {excess.max()}"


def torch_from_jax(x) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32)))


def ln_against_jax(x: np.ndarray, w, b, dtype: str, eps: float) -> None:
    """The port's LayerNorm routes on ``x`` (cast to ``dtype``) against the
    JAX kernel (interpret mode) and the JAX reference. f32: 1e-6 plus four
    f32 ulps of the output (2^-21 relative): the two frameworks' row means
    differ by up to 3 ulps (their sums over 768 values run in other orders)
    and their rsqrt by up to 2, which at normalized outputs of up to ~7
    reaches 1.4e-6 (the JAX kernel and the JAX reference themselves differ
    by up to 9.5e-7)."""
    xj = jnp.asarray(x, jnp.dtype(dtype))
    wants = [np.asarray(f(xj, w, b, eps), np.float32)
             for f in (jax_fused_ln, jax_ln_reference)]
    xt = torch_from_jax(xj).to(TORCH_DTYPES[dtype])
    wt, bt = torch.from_numpy(w), torch.from_numpy(b)
    module = FusedLayerNorm(x.shape[-1], eps)
    module.load_state_dict({"weight": wt, "bias": bt})
    before = fused_layer_norm.launches
    with torch.no_grad():
        gots = [layer_norm_reference(xt, wt, bt, eps),
                fused_layer_norm(xt, wt, bt, eps), module(xt)]
    assert fused_layer_norm.launches == before  # a CPU tensor takes the plain version
    for got in gots:
        assert got.dtype == xt.dtype and got.shape == xt.shape
        for want in wants:
            assert_close(got, want, dtype, atol=1e-6, rtol=2.0 ** -21)


@pytest.mark.parametrize("eps", [1e-12, 1e-6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(7, D_VIT), (2, 300, D_VIT)],
                         ids=["7rows", "600rows"])
def test_layer_norm_matches_jax(shape, dtype, eps):
    """600 rows: above the Pallas kernel's 512-row block, so it pads."""
    rng = np.random.default_rng(len(shape))
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    w = rng.uniform(0.5, 1.5, shape[-1]).astype(np.float32)
    b = rng.normal(scale=0.2, size=shape[-1]).astype(np.float32)
    ln_against_jax(x, w, b, dtype, eps)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_near_constant_rows_match_jax(dtype):
    """Rows where E[x^2] - E[x]^2 (flax's fast variance) cancels: c + k d
    with k in {-1, 0, 1} summing to zero, so that every partial sum, the
    mean (exactly c) and the squared deviations are exact in f32 whatever
    the order; then a constant row (variance 0: the output is the bias).
    In f32 the second row's variance (2/3) 2^-40 is of eps's size."""
    rng = np.random.default_rng(3)
    k = rng.permutation(np.repeat(np.array([-1.0, 0.0, 1.0], np.float32), D_VIT // 3))
    rows = ([(0.5, 2.0 ** -14), (2.0 ** -9, 2.0 ** -20)] if dtype == "float32"
            else [(0.5, 2.0 ** -8)])
    x = np.stack([c + k * d for c, d in rows] + [np.full(D_VIT, 3.0)]).astype(np.float32)
    w = rng.uniform(0.5, 1.5, D_VIT).astype(np.float32)
    b = rng.normal(scale=0.2, size=D_VIT).astype(np.float32)
    assert np.array_equal(np.asarray(jnp.asarray(x, jnp.dtype(dtype)), np.float32), x)
    ln_against_jax(x, w, b, dtype, 1e-12)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,heads", [((2, 17, 128), 2), ((3, 5, 64), 4)],
                         ids=["d64", "d16"])
def test_attention_bld_matches_jax(shape, heads, dtype):
    """f32 at the repo's attention tolerance, 2e-5
    (tests/test_torch_parity.py); bf16 within one bf16 ulp plus that."""
    rng = np.random.default_rng(shape[1])
    jdt = jnp.dtype(dtype)
    q, k, v = (jnp.asarray(rng.standard_normal(shape), jdt) for _ in range(3))
    d = shape[2] // heads
    scale = d ** -0.5
    kernel = jax_flash_bld(q, k, v, scale, heads, True)
    per_head = jnp.concatenate(
        [jax_attention(q[..., h * d:(h + 1) * d], k[..., h * d:(h + 1) * d],
                       v[..., h * d:(h + 1) * d], scale) for h in range(heads)], axis=-1)
    qt, kt, vt = (torch_from_jax(t).to(TORCH_DTYPES[dtype]) for t in (q, k, v))
    before = flash_attention_bld.launches
    gots = (attention_bld_reference(qt, kt, vt, scale, heads),
            flash_self_attention_bld(qt, kt, vt, scale, heads))
    assert flash_attention_bld.launches == before  # a CPU tensor takes the plain version
    for got in gots:
        assert got.dtype == qt.dtype and got.shape == qt.shape
        for want in (kernel, per_head):
            assert_close(got, np.asarray(want, np.float32), dtype, atol=2e-5)


def fill(shapes, rng):
    """float32 numpy draws for an abstract flax tree, uniform with the
    variance of: kernels N(0, 1/fan_in), LayerNorm scales 1 + N(0, 0.01),
    query embeddings N(0, 1), everything else (biases, the CLS token,
    positions) N(0, 0.01). Uniform float32 draws, scaled in place: the
    full-width tree's 171 M values take a fraction of a second."""
    out = {}
    for path, leaf in flatten_dict(shapes).items():
        name, shape = path[-1], leaf.shape
        val = rng.random(shape, dtype=np.float32)
        val -= np.float32(0.5)
        val *= np.float32(12.0 ** 0.5)
        if name == "kernel" or name.endswith("_kernel"):
            val *= np.float32(np.prod(shape[:-1]) ** -0.5)
        elif name == "query_embed":
            pass
        else:
            val *= np.float32(0.1)
            if name == "scale":
                val += np.float32(1.0)
        out[path] = val
    return unflatten_dict(out)


SMALL_VIT = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128,
                 patch_size=16, image_size=32)


@pytest.mark.parametrize("port_flash", [True, False], ids=["port_kernels", "port_einsum"])
@pytest.mark.parametrize("cls_only", [False, True], ids=["all_rows", "cls_only"])
def test_small_vit_matches_jax(cls_only, port_flash):
    """ViT(hidden 64, 2 layers, 4 heads, MLP 128) at 32 px against the JAX
    ViT with flash attention (interpret mode), f32 at 2e-5 on the hidden
    state and the pre-LN state; the port with its kernel routes (plain on
    the CPU) and with its head-major einsum path."""
    jvit = JaxViT(use_flash=True, final_ln_cls_only=cls_only, **SMALL_VIT)
    images = np.random.default_rng(5).uniform(size=(3, 32, 32, 3)).astype(np.float32)
    params = fill(abstract_init(jvit, images), np.random.default_rng(6))
    hidden, pre_ln = jax.jit(jvit.apply)(params, images)
    port = ViT(use_flash=port_flash, final_ln_cls_only=cls_only, **SMALL_VIT).eval()
    port.load_state_dict(convert_jax_variables(params), strict=True)
    with torch.no_grad():
        got_hidden, got_pre = port(torch.from_numpy(images))
    assert got_hidden.shape == hidden.shape == (3, 1 if cls_only else 5, 64)
    np.testing.assert_allclose(got_hidden.numpy(), np.asarray(hidden), atol=2e-5, rtol=0)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(pre_ln), atol=2e-5, rtol=0)


T, K, IMG = 2, 2, 32


def test_full_width_vit_model_matches_jax():
    """The flagship head (shrunk as test_torch_port_model.py shrinks it)
    over the full-width ViT-B/16 backbone, f32, B = 1: backbone features,
    outputs and the predict path's scores and boxes at the full-model
    tolerance, 1e-4 (tests/test_full_model_parity.py). Its only full-width
    pair: built here, kept out of the shared reference cache, and freed
    before the test returns."""
    data = dict(num_frames=T, image_size=IMG)
    jax_model = build_model(SvolConfig(
        data=DataConfig(max_boxes_per_frame=K, **data),
        model=ModelConfig(**dict(SMALL, backbone="vit", use_flash_attention=False))))
    rng = np.random.default_rng(7)
    batch = {
        "src_sketch": rng.integers(0, 256, (1, 1, IMG, IMG, 3), dtype=np.uint8),
        "src_video": rng.integers(0, 256, (1, T, IMG, IMG, 3), dtype=np.uint8),
        "src_sketch_mask": np.ones((1, 1), np.float32),
        "src_video_mask": np.ones((1, T), np.float32),
    }
    variables = fill(abstract_init(jax_model, **batch), np.random.default_rng(8))

    def forward(v, b):
        out, st = jax_model.apply(
            v, **b, capture_intermediates=lambda m, _: isinstance(m, JaxViTBackbone),
            mutable=["intermediates"])
        feats = st["intermediates"]["backbone"]["__call__"][0]
        return (out, feats) + jax_predict_from(out, v, b)

    out, feats, scores, boxes = jax.tree.map(
        np.asarray, jax.jit(forward)(variables, batch))

    state = convert_jax_variables(variables)
    n_leaves = len(flatten_dict(variables["params"]))
    del variables
    with torch.device("meta"):
        port = SketchLocalizationModel(PortConfig(data=PortData(**data),
                                                  model=PortModel(**dict(SMALL, backbone="vit"))))
    assert set(state) == set(port.state_dict()) and len(state) == n_leaves
    # every parameter comes from the JAX tree (nothing left on "meta")
    port.load_state_dict(state, strict=True, assign=True)
    port.eval()
    del state
    assert sum(p.numel() for p in port.parameters()) > 1.7e8
    tb = torch_batch(batch)
    with torch.no_grad():
        sk, vid = port.backbone(tb["src_sketch"].float() / 255.0,
                                tb["src_video"].float() / 255.0)
        got = port(**tb)
    got_scores, got_boxes = make_predict_fn(port)(tb)
    del port
    gc.collect()

    assert sk.shape == (1, 1, D_VIT) and vid.shape == (1, T, D_VIT)
    np.testing.assert_allclose(sk.numpy(), feats[0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(vid.numpy(), feats[1], atol=1e-4, rtol=0)
    for key in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        np.testing.assert_allclose(got[key].numpy(), out[key], atol=1e-4, rtol=0,
                                   err_msg=key)
    np.testing.assert_allclose(got_scores.numpy(), scores, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_boxes.numpy(), boxes, atol=1e-4, rtol=0)


def vit_cfg(**model):
    return PortConfig(data=PortData(num_frames=T, image_size=IMG),
                      model=PortModel(**dict(SMALL, backbone="vit", **model)))


@pytest.mark.parametrize("case", ["serving", "int8", "train_step", "train_state"])
def test_config_takes_vit_serving_and_refuses_the_rest(case):
    """``backbone="vit"`` is taken for serving; with int8 it raises the JAX
    config's ValueError; training it raises until its slice is ported."""
    if case == "serving":
        cfg = vit_cfg()
        assert PortConfig.from_dict(cfg.to_dict()).model.backbone == "vit"
    elif case == "int8":
        with pytest.raises(ValueError, match="ResNet backbones only"):
            vit_cfg(quantize="int8")
    elif case == "train_step":
        with pytest.raises(NotImplementedError, match="ViT"):
            make_train_step(vit_cfg(), criterion=None)
    else:
        with pytest.raises(NotImplementedError, match="ViT"):
            create_train_state(vit_cfg(), model=None, device="cpu")

"""The port's flagship predict path against the JAX package, module by module
and end to end, in float32 on the CPU.

One small configuration (ResNet-34/18 as they are, 64 px frames -> 4
tokens per frame, T=2, hidden 32, 4 heads, 2 layers, 2 queries per frame,
FFN 64) with flash and gated attention on: the JAX side runs its Pallas
kernels in interpret mode, the port its plain versions. Weights are drawn
with numpy into the flax variable tree and carried over by
``convert_jax_variables``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax.traverse_util import flatten_dict, unflatten_dict

from svol_tpu.config import DataConfig, ModelConfig, SvolConfig
from svol_tpu.models import build_model
from svol_tpu.models.backbone import ResNetBackbone as JaxResNetBackbone
from svol_tpu.models.layers import MultiheadAttention as JaxMHA
from svol_tpu.models.layers import TransformerMLP as JaxMLP
from svol_tpu.models.positional import PositionEmbeddingSine as JaxSine
from svol_tpu.train.steps import make_predict_fn as jax_make_predict_fn
from svol_tpu_torch.config import DataConfig as PortData
from svol_tpu_torch.config import ModelConfig as PortModel
from svol_tpu_torch.config import SvolConfig as PortConfig
from svol_tpu_torch.models.layers import MultiheadAttention, TransformerMLP
from svol_tpu_torch.models.model import SketchLocalizationModel
from svol_tpu_torch.models.positional import PositionEmbeddingSine
from svol_tpu_torch.train.steps import make_predict_fn
from svol_tpu_torch.utils.jax_weights import convert_jax_variables
from torch_port_reference_cache import shared
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

T, K, IMG, B, HID, HEADS = 2, 2, 64, 2, 32, 4
SMALL = dict(hidden_dim=HID, nheads=HEADS, num_layers=2, num_queries=T * K,
             num_queries_per_frame=K, cmt_dim_feedforward=64,
             compute_dtype="float32", use_flash_attention=True,
             use_pallas_attention=True)


def fill_variables(shapes, rng):
    """numpy draws for every leaf of an abstract flax variable tree, scaled
    so activations stay O(1) through the ResNet."""
    out = {}
    for path, leaf in flatten_dict(shapes).items():
        name, shape = path[-1], leaf.shape
        if name == "kernel" or name.endswith("_kernel"):
            fan_in = int(np.prod(shape[:-1]))
            val = rng.normal(size=shape) * fan_in ** -0.5
        elif name == "var":
            val = rng.uniform(0.5, 1.5, size=shape)
        elif name == "scale":
            val = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "query_embed":
            val = rng.normal(size=shape)
        else:  # biases, BN means
            val = 0.1 * rng.normal(size=shape)
        out[path] = np.asarray(val, np.float32)
    return unflatten_dict(out)


def jax_predict_from(out, variables, batch):
    """The JAX package's ``make_predict_fn`` on outputs already computed
    (its apply hands them back), so that the model is traced once."""
    return jax_make_predict_fn(lambda *_, **__: out)(variables, batch)


def abstract_init(module, *args, **kwargs):
    return jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))


def make_batch(rng):
    video_mask = np.ones((B, T), np.float32)
    video_mask[1, -1] = 0.0  # a padded frame
    return {
        "src_sketch": rng.integers(0, 256, (B, 1, IMG, IMG, 3), dtype=np.uint8),
        "src_video": rng.integers(0, 256, (B, T, IMG, IMG, 3), dtype=np.uint8),
        "src_sketch_mask": np.ones((B, 1), np.float32),
        "src_video_mask": video_mask,
    }


def jax_inputs():
    """The small model's weights (numpy draws into the flax variable tree)
    and a batch, shared with test_torch_port_int8.py."""
    model = build_model(jax_config())
    batch = make_batch(np.random.default_rng(0))
    return {"variables": fill_variables(abstract_init(model, **batch),
                                        np.random.default_rng(1)),
            "batch": batch}


def jax_config(**model):
    return SvolConfig(data=DataConfig(num_frames=T, max_boxes_per_frame=K,
                                      image_size=IMG),
                      model=ModelConfig(**dict(SMALL, **model)))


def jax_predict_reference(inputs):
    """The JAX model's outputs, backbone features, scores and boxes on
    ``inputs``, as numpy."""
    model = build_model(jax_config())

    def forward(v, b):
        out, state = model.apply(
            v, **b, capture_intermediates=lambda m, _: isinstance(m, JaxResNetBackbone),
            mutable=["intermediates"])
        feats = state["intermediates"]["backbone"]["__call__"][0]
        return (out, feats) + jax_predict_from(out, v, b)

    out, feats, scores, boxes = jax.jit(forward)(inputs["variables"], inputs["batch"])
    return {
        "out": jax.tree.map(np.asarray, out),
        "feats": [np.asarray(f) for f in feats],
        "scores": np.asarray(scores), "boxes": np.asarray(boxes),
    }


# Each reference is built by one xdist worker per run and loaded by the
# others (tests/torch_port_reference_cache.py).
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return shared(tmp_path_factory, "small_model_jax_inputs", jax_inputs)


@pytest.fixture(scope="module")
def port(inputs):
    """The port model with the JAX weights, and its state dict."""
    port_cfg = PortConfig(data=PortData(num_frames=T, image_size=IMG),
                          model=PortModel(**SMALL))
    model = SketchLocalizationModel(port_cfg).eval()
    state = convert_jax_variables(inputs["variables"])
    model.load_state_dict(state, strict=True)
    return model, state


@pytest.fixture(scope="module")
def pair(tmp_path_factory, inputs, port):
    """The JAX model's outputs and the converted port model."""
    ref = shared(tmp_path_factory, "small_model_jax_predict",
                 lambda: jax_predict_reference(inputs))
    return dict(ref, **inputs, port=port[0], state=port[1])


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_convert_jax_variables_covers_every_port_parameter(inputs, port):
    model, state = port
    expected = dict(model.state_dict())
    assert set(state) == set(expected)
    n_leaves = sum(len(flatten_dict(inputs["variables"][c]))
                   for c in ("params", "batch_stats"))
    assert len(state) == n_leaves
    for name, t in state.items():
        assert t.shape == expected[name].shape, name
    # Dense (in, out) -> Linear (out, in); conv HWIO -> OIHW
    p = flatten_dict(inputs["variables"]["params"], sep="/")
    np.testing.assert_array_equal(
        state["head.class_embed.weight"].numpy(), p["head/class_embed/kernel"].T)
    np.testing.assert_array_equal(
        state["backbone.video_backbone.conv1.weight"].numpy(),
        p["backbone/video_backbone/conv1/kernel"].transpose(3, 2, 0, 1))


def test_backbone_features_match_jax_with_uint8_fold(pair):
    tb = torch_batch(pair["batch"])
    with torch.no_grad():
        sk, vid = pair["port"].backbone(
            tb["src_sketch"].float(), tb["src_video"].float(),
            sketch_scale=1 / 255, video_scale=1 / 255)
    want_sk, want_vid = pair["feats"]
    assert vid.shape == (B, T * 4, 512) and sk.shape == (B, 1, 512)
    # ~36 f32 convolutions summed in another order (XLA vs oneDNN)
    np.testing.assert_allclose(sk.numpy(), want_sk, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(vid.numpy(), want_vid, atol=1e-4, rtol=1e-4)


def test_predict_path_matches_jax(pair):
    tb = torch_batch(pair["batch"])
    with torch.no_grad():
        out = pair["port"](**tb)
    scores, boxes = make_predict_fn(pair["port"])(tb)
    # the whole forward in f32: the full-model tolerance of
    # tests/test_full_model_parity.py
    for key in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        np.testing.assert_allclose(out[key].numpy(), pair["out"][key],
                                   atol=1e-4, rtol=0, err_msg=key)
    np.testing.assert_allclose(scores.numpy(), pair["scores"], atol=1e-4, rtol=0)
    np.testing.assert_allclose(boxes.numpy(), pair["boxes"], atol=1e-4, rtol=0)


def test_bfloat16_forward_stays_near_float32(pair):
    """The bf16 compute path (bf16 logits fast path of the masked
    cross-attention, bf16 convolutions) runs and stays within bf16 reach of
    the f32 result."""
    cfg = PortConfig(data=PortData(num_frames=T, image_size=IMG),
                     model=PortModel(**dict(SMALL, compute_dtype="bfloat16")))
    port16 = SketchLocalizationModel(cfg).eval()
    port16.load_state_dict(pair["state"], strict=True)
    scores, boxes = make_predict_fn(port16)(torch_batch(pair["batch"]))
    assert torch.isfinite(scores).all() and torch.isfinite(boxes).all()
    # bf16 keeps 8 bits of mantissa through ~40 layers of activations
    np.testing.assert_allclose(scores.numpy(), pair["scores"], atol=5e-2, rtol=0)
    np.testing.assert_allclose(boxes.numpy(), pair["boxes"], atol=5e-2, rtol=0)


@pytest.mark.parametrize("masked", [False, True])
def test_multihead_attention_matches_jax(masked):
    rng = np.random.default_rng(2)
    Lq, Lk = 5, 7
    x = lambda L: rng.normal(size=(3, L, HID)).astype(np.float32)
    q, k, v = x(Lq), x(Lk), x(Lk)
    mask = None
    if masked:
        mask = np.zeros((3, Lk), bool)
        mask[0, -2:] = True
        mask[2, :] = True  # a fully padded row: uniform weights, not NaN
    jmha = JaxMHA(d_model=HID, num_heads=HEADS, dtype=jnp.float32)
    variables = fill_variables(
        abstract_init(jmha, q, k, v, key_padding_mask=mask, need_weights=False),
        np.random.default_rng(3))
    want, _ = jmha.apply(variables, q, k, v, key_padding_mask=mask,
                         need_weights=False)
    mha = MultiheadAttention(HID, HEADS)
    mha.load_state_dict(convert_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = mha(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                  None if mask is None else torch.from_numpy(mask))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_multihead_attention_bf16_fast_path_matches_jax():
    """Under bf16 the masked cross-attention keeps its logits in bf16, fills
    masked ones with bf16's finite minimum, and takes max and sum in f32."""
    rng = np.random.default_rng(6)
    x = lambda L: rng.normal(size=(3, L, HID)).astype(np.float32)
    q, k, v = x(5), x(7), x(7)
    mask = np.zeros((3, 7), bool)
    mask[0, -2:] = True
    mask[2, :] = True  # fully padded: uniform weights, not NaN
    jmha = JaxMHA(d_model=HID, num_heads=HEADS, dtype=jnp.bfloat16)
    variables = fill_variables(
        abstract_init(jmha, q, k, v, key_padding_mask=mask, need_weights=False),
        np.random.default_rng(7))
    want, _ = jmha.apply(variables, q, k, v, key_padding_mask=mask,
                         need_weights=False)
    mha = MultiheadAttention(HID, HEADS)
    mha.load_state_dict(convert_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = mha(*(torch.from_numpy(t).bfloat16() for t in (q, k, v)),
                  torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    # XLA and torch round bf16 at slightly different points (fused vs
    # separate ops): allow 4 bf16 ulps (2^-6 relative) plus the same absolute
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2 ** -6, rtol=2 ** -6)


def test_transformer_mlp_uses_tanh_gelu_like_flax():
    rng = np.random.default_rng(4)
    x = 2.0 * rng.normal(size=(2, 6, HID)).astype(np.float32)
    jmlp = JaxMLP(hidden_features=64, out_features=HID)
    variables = fill_variables(abstract_init(jmlp, x), np.random.default_rng(5))
    want = np.asarray(jmlp.apply(variables, x))
    mlp = TransformerMLP(HID, 64, HID)
    mlp.load_state_dict(convert_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = mlp(torch.from_numpy(x))
        exact_erf = mlp.fc2(F.gelu(mlp.fc1(torch.from_numpy(x))))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the erf GELU, torch's default, would drift past that tolerance
    assert np.abs(exact_erf.numpy() - want).max() > 1e-4


def test_sine_position_embedding_interleaves_like_jax():
    mask = np.ones((2, 12), bool)
    mask[1, 8:] = False
    want = np.asarray(JaxSine(num_pos_feats=HID).apply({}, None, jnp.asarray(mask)))
    got = PositionEmbeddingSine(num_pos_feats=HID)(torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)

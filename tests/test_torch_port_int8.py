"""The port's int8 serving path against the JAX package, on the CPU:
weight and activation quantization, the int8 convolution and
``QuantizableConv``'s three modes, the int8 attention, calibration, the
int8 eval forward of the small model (static and dynamic scales), the
export round trip, and float convs in train mode.

The small configuration is test_torch_port_model.py's (ResNet-34/18 as
they are, 64 px frames, T=2, hidden 32, 4 heads, 2 layers, FFN 64, B=2)
with ``quantize='int8'`` and ``quantize_attention=True``. The JAX side runs
its Pallas kernels in interpret mode, the port its plain versions, which its
wrappers take for CPU tensors. The JAX model's outputs are computed once
per test run (tests/torch_port_reference_cache.py).

What is exact and what is not: quantized tensors, scales and int32
accumulators are the same bits on both sides (float32 division and
rounding half to even in the same order), so an int8 convolution's output
is too. The attention's softmax is not: exp differs by ulps between XLA and
torch, and the row sum runs in another order.

    JAX_PLATFORMS=cpu PYTHONPATH=.:tests python -c \
        "import conftest, test_torch_port_int8 as t; t.int8_readings()"

prints the readings behind the model-level tolerances (``int8_readings``),
under the tests' own JAX settings (conftest.py, imported first).
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svol_tpu.models import build_model
from svol_tpu.models.resnet import QuantizableConv as JaxQuantizableConv
from svol_tpu.ops import quant as jax_quant
from svol_tpu.ops.pallas import flash_attention as jax_flash
from svol_tpu_torch import serving
from svol_tpu_torch.config import DataConfig as PortData
from svol_tpu_torch.config import ModelConfig as PortModel
from svol_tpu_torch.config import SvolConfig as PortConfig
from svol_tpu_torch.models.model import SketchLocalizationModel
from svol_tpu_torch.models.resnet import QuantizableConv
from svol_tpu_torch.ops import quant
from svol_tpu_torch.ops.kernels.flash_attention_int8 import (
    attention_int8,
    attention_int8_reference,
    flash_attention_int8,
    quant_sym,
)
from svol_tpu_torch.train.steps import make_predict_fn
from svol_tpu_torch.utils.jax_weights import convert_jax_variables, port_state_to_jax_numpy
from test_torch_port_model import (  # noqa: F401  (inputs, port: fixtures)
    IMG,
    SMALL,
    T,
    inputs,
    port,
    jax_config,
    jax_predict_from,
    torch_batch,
)
from torch_port_reference_cache import shared
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

U = 2.0 ** -24  # float32 unit roundoff


def jax_int8_model():
    return build_model(jax_config(quantize="int8", quantize_attention=True))


def jax_calibration(inputs):
    """The JAX int8 model's calibrated scales on the small model's batch."""
    scales = jax_quant.calibrate_scales(jax_int8_model(), inputs["variables"],
                                        [inputs["batch"]], max_batches=1)
    return jax.tree.map(np.asarray, scales)


def jax_int8_outputs(inputs, scales=None):
    """The JAX int8 model's outputs and predictions, with dynamic
    activation scales or with the static ``scales``, as numpy."""
    model = jax_int8_model()
    variables = inputs["variables"]
    if scales is not None:
        variables = {**variables, "quant": scales}

    @jax.jit
    def forward(v, b):
        out = model.apply(v, **b, train=False)
        return (out,) + jax_predict_from(out, v, b)

    out, scores, boxes = forward(variables, inputs["batch"])
    return {"out": jax.tree.map(np.asarray, out),
            "scores": np.asarray(scores), "boxes": np.asarray(boxes)}


# Each reference is built by one xdist worker per run and loaded by the
# others; the weights and batch are test_torch_port_model.py's (``inputs``).
@pytest.fixture(scope="module")
def jax_scales(tmp_path_factory, inputs):
    return shared(tmp_path_factory, "int8_jax_scales", lambda: jax_calibration(inputs))


@pytest.fixture(scope="module")
def jax_dynamic(tmp_path_factory, inputs):
    return shared(tmp_path_factory, "int8_jax_dynamic", lambda: jax_int8_outputs(inputs))


@pytest.fixture(scope="module")
def jax_static(tmp_path_factory, inputs, jax_scales):
    return shared(tmp_path_factory, "int8_jax_static",
                  lambda: jax_int8_outputs(inputs, jax_scales))


def port_model(variables, quantize="int8", **model):
    cfg = PortConfig(data=PortData(num_frames=T, image_size=IMG),
                     model=PortModel(**dict(SMALL, quantize=quantize,
                                            quantize_attention=quantize is not None,
                                            **model)))
    m = SketchLocalizationModel(cfg).eval()
    m.load_state_dict(convert_jax_variables(variables), strict=True)
    return m, cfg


def port_outputs(model, batch):
    """The eval forward's outputs, and the predict path's scores and boxes
    taken from those outputs, so that the model runs once."""
    tb = torch_batch(batch)
    with torch.no_grad():
        out = model(**tb)
    scores, boxes = make_predict_fn(lambda **_: out)(tb)
    return {"out": out, "scores": scores, "boxes": boxes}


# The port's int8 models, each built and run once per worker.
@pytest.fixture(scope="module")
def port_dynamic(inputs):
    model, cfg = port_model(inputs["variables"])
    return dict(port_outputs(model, inputs["batch"]), model=model, cfg=cfg)


@pytest.fixture(scope="module")
def port_static(inputs, jax_scales):
    """The port's int8 model given the JAX package's calibrated scales."""
    model, cfg = port_model(inputs["variables"])
    quant.load_quant_scales(model, convert_jax_variables({"quant": jax_scales}))
    return dict(port_outputs(model, inputs["batch"]), model=model, cfg=cfg)


@pytest.fixture(scope="module")
def calibrated(inputs):
    """The port's int8 model calibrated by the port on the small batch, and
    its scales (no input dropout, for the train-mode test)."""
    model, cfg = port_model(inputs["variables"], input_dropout=0.0)
    scales = quant.calibrate_scales(model, [torch_batch(inputs["batch"])])
    return {"model": model, "cfg": cfg, "scales": scales}


# ------------------------------------------------------- quantization


def test_quantize_weights_and_quant_sym_match_jax():
    rng = np.random.default_rng(0)
    k = (rng.normal(size=(3, 3, 16, 24)) * 0.1).astype(np.float32)
    k[..., 5] = 0.0  # an all-zero channel: the 1e-8 floor of the scale
    want_q, want_s = jax_quant.quantize_weights(jnp.asarray(k))
    got_q, got_s = quant.quantize_weights(torch.from_numpy(k.transpose(3, 2, 0, 1)))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy().transpose(2, 3, 1, 0), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))

    x = (rng.normal(size=(2, 40, 32)) * 3).astype(np.float32)
    for amax in (None, np.float32(2.5)):  # dynamic, and a static amax that clips
        want_q, want_s = jax_flash._quant_sym(jnp.asarray(x), amax)
        got_q, got_s = quant_sym(torch.from_numpy(x),
                                 None if amax is None else torch.tensor(amax))
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
        assert got_s.item() == float(want_s)
    assert np.abs(got_q.numpy()).max() == 127


# (cin, features, kernel, stride, padding, kernel_scale, uint8 pixels in)
CONV_CASES = {
    "strided": (16, 24, 3, 2, 1, 1.0, False),
    "padded": (16, 24, 3, 1, 1, 1.0, False),
    "downsample": (16, 24, 1, 2, 0, 1.0, False),
    "stem": (3, 64, 7, 2, 3, 1.0 / 255.0, True),
}


@pytest.mark.parametrize("case", list(CONV_CASES))
def test_quantizable_conv_int8_matches_jax(case):
    """Dynamic, calibration and static modes of ``QuantizableConv``. With
    the same int8 tensors and scales, the int32 accumulators and so the
    outputs are the same bits; calibration returns the exact float output,
    which the two frameworks sum in another order (f32 tolerance)."""
    cin, feat, ks, stride, pad, kscale, pixels = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    x = (rng.integers(0, 256, (2, 17, 17, cin)).astype(np.float32) if pixels
         else rng.normal(size=(2, 17, 17, cin)).astype(np.float32))
    k = (rng.normal(size=(ks, ks, cin, feat)) * (ks * ks * cin) ** -0.5).astype(np.float32)
    jconv = JaxQuantizableConv(feat, (ks, ks), strides=(stride, stride), padding=pad,
                               quantize="int8")
    conv = QuantizableConv(cin, feat, ks, stride, pad, quantize="int8").eval()
    conv.weight.data = torch.from_numpy(k.transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).contiguous(
        memory_format=torch.channels_last)
    nhwc = lambda y: y.detach().numpy().transpose(0, 2, 3, 1)
    params = {"params": {"kernel": jnp.asarray(k)}}

    want = jconv.apply(params, jnp.asarray(x), kernel_scale=kscale)
    np.testing.assert_array_equal(nhwc(conv(xt, kernel_scale=kscale)), np.asarray(want))

    want_f, calib = jconv.apply(params, jnp.asarray(x), kernel_scale=kscale,
                                mutable=["quant"])
    conv.calibrating = True
    got_f = conv(xt, kernel_scale=kscale)
    conv.calibrating = False
    assert conv.amax.item() == float(calib["quant"]["amax"])
    np.testing.assert_allclose(nhwc(got_f), np.asarray(want_f), atol=1e-5, rtol=1e-5)

    static = np.float32(0.5 * float(calib["quant"]["amax"]))  # clips the top half
    conv.amax = torch.tensor(static)
    want = jconv.apply({**params, "quant": {"amax": jnp.asarray(static)}},
                       jnp.asarray(x), kernel_scale=kscale)
    np.testing.assert_array_equal(nhwc(conv(xt, kernel_scale=kscale)), np.asarray(want))


def test_card_int8_product_layout_gives_the_same_accumulators():
    """The card's int8 product is an im2col (channels padded to a multiple
    of 8) times the kernel in the same column order; here the same
    matrices go through an int64 matmul and must equal the CPU's exact
    float64 convolution."""
    rng = np.random.default_rng(3)
    for (cin, feat, ks, stride, pad, _, _) in CONV_CASES.values():
        xq = torch.from_numpy(rng.integers(-127, 128, (2, cin, 13, 13), dtype=np.int8))
        xq = xq.contiguous(memory_format=torch.channels_last)
        wq = torch.from_numpy(rng.integers(-127, 128, (feat, cin, ks, ks), dtype=np.int8))
        cols = quant.im2col(xq, (ks, ks), stride, pad)
        assert cols.shape[1] % 8 == 0 and cols.dtype == torch.int8
        w = quant.im2col_weight(wq)
        want = quant.conv_i32(xq, wq, stride, pad)
        got = (cols.long() @ w.long().t()).view(2, want.shape[2], want.shape[3], feat)
        torch.testing.assert_close(got.permute(0, 3, 1, 2).int(), want, atol=0, rtol=0)


# ---------------------------------------------------------- attention


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("length", [40, 96])
def test_int8_attention_matches_jax(length, static):
    """The plain version against ``_pallas_forward_int8(interpret=True)``.

    Quantized q/k/v and the int32 logits are exact. Per row the outputs are
    acc * sv / (127 * denom) with acc an int32 sum of wq * v: acc is exact
    unless a weight round(e * 127) flips, and denom, a sum of L positive
    terms each within 2 ulps (exp), differs by at most (L + 2) u relative
    (u = 2^-24); with the four roundings of scale and product on each side,
    every element is within (L + 10) u of the JAX value, relatively. Where
    e * 127 lies within 1e-4 of a half (an exp ulp is 3e-5 there), the two
    may round it apart: a row with n such weights may further move by
    n * sv / denom, one step of acc."""
    rng = np.random.default_rng(length + static)
    q, k, v = ((rng.normal(size=(2, length, 32)) * 2).astype(np.float32) for _ in range(3))
    amax = (np.float32(5.0), np.float32(6.0), np.float32(4.5)) if static else None
    scale = 32 ** -0.5
    want = np.asarray(jax_flash._pallas_forward_int8(
        *map(jnp.asarray, (q, k, v)), scale, True,
        static_amax=None if amax is None else tuple(map(jnp.asarray, amax))))
    got = flash_attention_int8(*map(torch.from_numpy, (q, k, v)), scale,
                               None if amax is None else tuple(map(torch.tensor, amax)))
    assert got.dtype == torch.float32 and got.shape == want.shape

    # the flip allowance, from an exact recomputation in numpy
    (qq, sq), (kq, sk), (vq, sv) = (
        (np.asarray(t[0]), np.float32(t[1])) for t in
        (jax_flash._quant_sym(jnp.asarray(x), None if amax is None else amax[i])
         for i, x in enumerate((q, k, v))))
    logits = np.einsum("bqd,bkd->bqk", qq.astype(np.int64), kq.astype(np.int64))
    s = logits.astype(np.float32) * (sq * sk * np.float32(scale))
    e = np.exp((s - s.max(-1, keepdims=True)).astype(np.float64))
    t = e * 127.0
    near_half = (np.abs(t - np.floor(t) - 0.5) < 1e-4).sum(-1, keepdims=True)
    limit = (length + 10) * U * np.abs(want) + near_half * sv / e.sum(-1, keepdims=True)
    err = np.abs(got.numpy() - want)
    assert (err <= limit).all(), float((err / np.maximum(limit, 1e-30)).max())


def test_int8_attention_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    qq, kq, vq = (torch.from_numpy(rng.integers(-127, 128, (2, 24, 32), dtype=np.int8))
                  for _ in range(3))
    before = attention_int8.launches
    ls = torch.tensor([1e-3], dtype=torch.float32)
    out = attention_int8(qq, kq, vq, ls)
    assert attention_int8.launches == before and out.dtype == torch.float32
    torch.testing.assert_close(out, attention_int8_reference(qq, kq, vq, ls), atol=0, rtol=0)


# -------------------------------------------------------- model level


def test_calibration_matches_jax(calibrated, jax_scales):
    """Every conv's and attention's abs-max, under the flax names. They are
    maxima of float32 activations that the two frameworks compute with
    their own convolution algorithms, whose rounding grows with depth (the
    ResNet features agree to 1e-4, test_torch_port_model.py): about 50 of
    the 68 differ, by up to 1.5e-6 relative at the deepest video convs
    (``int8_readings``), hence rtol 4e-6."""
    scales = calibrated["scales"]
    want = convert_jax_variables({"quant": jax_scales})
    assert set(scales) == set(want) and len(want) == 68  # 36 + 20 convs, 4 x 3 attention
    for key, w in want.items():
        np.testing.assert_allclose(scales[key].numpy(), w.numpy(), rtol=4e-6, atol=0,
                                   err_msg=key)
    # the scales map back to the flax tree's names
    back = port_state_to_jax_numpy(scales)["quant"]
    assert jax.tree.structure(back) == jax.tree.structure(jax_scales)


OUTPUT_KEYS = ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes")

# Port int8 against JAX int8 at the model level, per mode.
#
# Static (the JAX package's calibrated scales in both): every int8 tensor,
# scale and int32 accumulator is the same bits on both sides (the tests
# above), and each conv's float input is too, so what differs is the float
# rounding of the layers between (linear, LayerNorm, softmax, the attention's
# exp): 6.0e-7 on the logits when this was set (``int8_readings``). 1e-4
# leaves that room for another machine's float rounding, and sits well
# under any int8 fault the model would show: dynamic scales in place of the
# calibrated ones move the port's logits by 3.7e-2, and float attention at
# either flash site in place of int8 by 4.7e-3 (video self-attention) and
# 7.0e-3 (query self-attention; both with the port's own calibration).
#
# Dynamic: a conv's dynamic scale is its input's abs-max, and where float
# rounding moves an element of a quantized input across a half step of the
# int8 grid, the two sides round it apart. One such flip changes later
# activations by a quantization step's product, which flips more elements
# downstream: the outputs then differ as two draws of int8 rounding noise
# do, up to the size of int8's own effect on the model (0.029-0.033 on the
# logits here; the JAX suite bounds int8 against float at 0.5,
# tests/test_quantize.py). When this was set the dynamic mode had such a
# cascade: 0.031 on the logits, 0.013 on the scores.
INT8_MODEL_ATOL = {"static": 1e-4, "dynamic": 0.05}


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_int8_forward_matches_jax(request, port, mode):
    """The small model's int8 eval forward and predict path against the
    JAX int8 model's, with dynamic scales or the JAX calibrated ones; int8
    is on: the outputs moved from the float model's; and static scales are
    used: they moved from the port's dynamic-scale outputs."""
    got = request.getfixturevalue(f"port_{mode}")
    want = request.getfixturevalue(f"jax_{mode}")
    atol = INT8_MODEL_ATOL[mode]
    tb = torch_batch(request.getfixturevalue("inputs")["batch"])
    with torch.no_grad():
        float_out = port[0](**tb)  # the float model with the same weights
    for key in OUTPUT_KEYS:
        np.testing.assert_allclose(got["out"][key].numpy(), want["out"][key],
                                   atol=atol, rtol=0, err_msg=key)
        assert (got["out"][key] - float_out[key]).abs().max() > 1e-3, key
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=atol, rtol=0)
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], atol=atol, rtol=0)
    if mode == "static":
        dynamic = request.getfixturevalue("port_dynamic")["out"]
        for key in OUTPUT_KEYS:
            assert (got["out"][key] - dynamic[key]).abs().max() > 10 * atol, key


@pytest.mark.parametrize("site", ["content_self_attn", "token_self_attn"])
def test_int8_attention_serves_each_flash_site(inputs, calibrated, site):
    """Both flash sites (the video self-attention and the query
    self-attention, in every layer) take the int8 attention: with static
    scales, running one of them in float moves the logits by far more than
    the static comparison with JAX allows (4.7e-3 and 7.0e-3 against 1e-4
    when this was set, ``int8_readings``)."""
    static = port_outputs(calibrated["model"], inputs["batch"])
    model = copy.deepcopy(calibrated["model"])
    switched = [name for name, m in model.named_modules()
                if name.endswith(site) and getattr(m, "flash_int8", False)]
    assert len(switched) == SMALL["num_layers"]
    for name in switched:
        model.get_submodule(name).flash_int8 = False
    out = port_outputs(model, inputs["batch"])["out"]
    moved = (out["pred_logits"] - static["out"]["pred_logits"]).abs().max()
    assert moved > 10 * INT8_MODEL_ATOL["static"], float(moved)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
def test_export_round_trip_serves_the_live_int8_predict(request, tmp_path, mode):
    """The exported artifact's predict equals the live one: with no scales
    (dynamic), or with the port's calibrated ones (static)."""
    inputs = request.getfixturevalue("inputs")
    if mode == "static":
        live = request.getfixturevalue("calibrated")
        live = dict(live, **port_outputs(live["model"], inputs["batch"]))
    else:
        live = request.getfixturevalue("port_dynamic")
    out = serving.export_model(live["cfg"], live["model"].state_dict(),
                               str(tmp_path / "export"), batch_size=2)
    predict, meta = serving.load_exported(out, device="cpu")
    assert meta["quantize"] == "int8"
    saved = torch.load(os.path.join(out, serving.ARTIFACT_FILE), weights_only=True)
    assert len(quant.quant_scales(saved)) == (68 if mode == "static" else 0)
    scores, boxes = predict(inputs["batch"])
    np.testing.assert_array_equal(scores, live["scores"].numpy())
    np.testing.assert_array_equal(boxes, live["boxes"].numpy())


def test_train_mode_keeps_float_convs_and_exact_attention(inputs, calibrated):
    """A train-mode forward with ``quantize='int8'`` (and calibrated
    scales present) equals the float model's, bit for bit."""
    float_model, _ = port_model(inputs["variables"], quantize=None, input_dropout=0.0)
    int8_model = copy.deepcopy(calibrated["model"])
    assert len(quant.quant_scales(int8_model.state_dict())) == 68
    tb = torch_batch(inputs["batch"])
    outs = []
    for m in (float_model.train(), int8_model.train()):
        with torch.no_grad():
            outs.append(m(**tb))
    for key in outs[0]:
        torch.testing.assert_close(outs[1][key], outs[0][key], atol=0, rtol=0)


def int8_readings():
    """The readings behind the model-level tolerances: how far the port's
    calibrated abs-maxes sit from the JAX ones; per output, the port's int8
    forward against the JAX int8 forward beside int8's own effect (the JAX
    float forward against the JAX int8 one); and how far the port's
    static-scale logits move with dynamic scales or with float attention at
    one flash site."""
    from test_torch_port_model import jax_inputs

    torch.set_num_threads(1)  # as the tests run (torch_port_threads.py)
    inputs = jax_inputs()
    scales = jax_calibration(inputs)
    model, _ = port_model(inputs["variables"])
    got = quant.calibrate_scales(model, [torch_batch(inputs["batch"])])
    want = convert_jax_variables({"quant": scales})
    rel = {k: abs(got[k].item() - w.item()) / w.item() for k, w in want.items()}
    worst = max(rel, key=rel.get)
    print(f"calibration: {sum(r > 0 for r in rel.values())} of {len(rel)} abs-maxes differ, "
          f"worst {rel[worst]:.3e} relative ({worst})")
    jax_float = build_model(jax_config()).apply(inputs["variables"], **inputs["batch"])
    port_out = {}
    for mode, jax8 in (("dynamic", jax_int8_outputs(inputs)),
                       ("static", jax_int8_outputs(inputs, scales))):
        model, _ = port_model(inputs["variables"])
        if mode == "static":
            quant.load_quant_scales(model, want)
        got = port_out[mode] = dict(port_outputs(model, inputs["batch"]), model=model)
        for key in OUTPUT_KEYS:
            drift = np.abs(got["out"][key].numpy() - jax8["out"][key]).max()
            effect = np.abs(np.asarray(jax_float[key]) - jax8["out"][key]).max()
            print(f"{mode:8} {key:12} port int8 - JAX int8 {drift:.3e}; "
                  f"JAX float - JAX int8 {effect:.3e}")
        print(f"{mode:8} scores       port int8 - JAX int8 "
              f"{np.abs(got['scores'].numpy() - jax8['scores']).max():.3e}")
    logits = lambda o: o["out"]["pred_logits"]
    print(f"port static - port dynamic, logits "
          f"{(logits(port_out['static']) - logits(port_out['dynamic'])).abs().max():.3e}")
    # the port's own calibration, as test_int8_attention_serves_each_flash_site
    model, _ = port_model(inputs["variables"])
    quant.calibrate_scales(model, [torch_batch(inputs["batch"])])
    static = dict(port_outputs(model, inputs["batch"]), model=model)
    for site in ("content_self_attn", "token_self_attn"):
        model = copy.deepcopy(static["model"])
        for name, m in model.named_modules():
            if name.endswith(site):
                m.flash_int8 = False
        moved = (logits(port_outputs(model, inputs["batch"])) - logits(static)).abs().max()
        print(f"float attention at {site}: logits move {moved:.3e}")

"""The modules of the port's train step against the JAX package, in
float32 on the CPU: the LSAP solver, the flash and gated backwards, box
ops, matcher and criterion, dropout, the train-state entry point and the
config. The model-level checks (train-mode forward, gradients, a 3-step
trajectory) are in test_torch_port_train_step.py.

Sizes follow test_torch_port_model.py's small configuration (T=2, K=2,
64 px, B=2, hidden 32, 4 heads, 2 layers, FFN 64). The JAX side runs its
Pallas kernels in interpret mode (flash forward and backward, the gated
op; the LSAP through `_solve_dense_pallas(interpret=True)` where named),
the port its plain versions, which is what its wrappers take for CPU
tensors. Inputs are numpy draws handed to both sides.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from svol_tpu.config import DataConfig, LossConfig, ModelConfig, SvolConfig, TrainConfig
from svol_tpu.losses.criterion import build_criterion as jax_build_criterion
from svol_tpu.losses.matcher import match_per_frame as jax_match_per_frame
from svol_tpu.losses.matcher import match_per_frame_stacked as jax_match_stacked
from svol_tpu.ops import boxes as jax_boxes
from svol_tpu.ops.hungarian import _solve_dense_pallas
from svol_tpu.ops.hungarian import hungarian as jax_hungarian
from svol_tpu.ops.hungarian import masked_cost_matrix as jax_masked_cost
from svol_tpu.ops.pallas.flash_attention import flash_attention as jax_flash
from svol_tpu.ops.pallas.gated_attention import gated_cross_attention
from svol_tpu.train.state import make_optimizer as jax_make_optimizer
from svol_tpu_torch import config as port_config
from svol_tpu_torch.data.synthetic import sample_train_batch
from svol_tpu_torch.losses.criterion import build_criterion
from svol_tpu_torch.losses.matcher import match_per_frame, match_per_frame_stacked
from svol_tpu_torch.models.layers import InputProjection
from svol_tpu_torch.models.model import SketchLocalizationModel
from svol_tpu_torch.ops import boxes
from svol_tpu_torch.ops.hungarian import hungarian, masked_cost_matrix, solve_dense_reference
from svol_tpu_torch.ops.kernels.flash_attention import (
    attention_backward_reference,
    flash_attention,
    flash_attention_backward,
)
from svol_tpu_torch.ops.kernels.gated_attention import gated_attention
from svol_tpu_torch.ops.kernels.lsap import lsap
from svol_tpu_torch.train.state import clip_by_global_norm, create_train_state, global_norm
from svol_tpu_torch.train.steps import make_train_step
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

T, K, IMG, B, HID, HEADS = 2, 2, 64, 2, 32, 4
SMALL = dict(hidden_dim=HID, nheads=HEADS, num_layers=2, num_queries=T * K,
             num_queries_per_frame=K, cmt_dim_feedforward=64,
             compute_dtype="float32", use_flash_attention=True,
             use_pallas_attention=True, input_dropout=0.0)
LR_DROP = 2


def jax_cfg(**loss):
    return SvolConfig(data=DataConfig(num_frames=T, max_boxes_per_frame=K,
                                      image_size=IMG, bs=B),
                      model=ModelConfig(**SMALL), loss=LossConfig(**loss),
                      train=TrainConfig(lr_drop_step=LR_DROP))


def port_cfg(**loss):
    return port_config.SvolConfig(
        data=port_config.DataConfig(num_frames=T, max_boxes_per_frame=K,
                                    image_size=IMG, bs=B),
        model=port_config.ModelConfig(**SMALL),
        loss=port_config.LossConfig(**loss),
        train=port_config.TrainConfig(lr_drop_step=LR_DROP))


# ---------------------------------------------------------------- LSAP


def _lsap_case(name, rng):
    if name == "square":
        return rng.normal(size=(64, 10, 10)).astype(np.float32), None
    if name == "rectangular":
        return rng.uniform(size=(32, 4, 10)).astype(np.float32), None
    if name == "ties":
        return rng.integers(0, 3, size=(64, 10, 10)).astype(np.float32), None
    valid = np.arange(10) < rng.integers(0, 11, size=(64, 1))
    return rng.uniform(size=(64, 10, 10)).astype(np.float32), valid


@pytest.mark.parametrize("case", ["square", "rectangular", "ties", "masked"])
def test_lsap_reference_matches_scipy_and_jax(case):
    cost, valid = _lsap_case(case, np.random.default_rng(10))
    if valid is not None:
        cost = np.asarray(jax.jit(jax_masked_cost)(cost, valid))
    got = solve_dense_reference(torch.from_numpy(cost.copy())).numpy()
    assert got.dtype == np.int32
    # the same solver, term for term: identical to both JAX formulations
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_hungarian)(cost)))
    pallas = jax.jit(functools.partial(_solve_dense_pallas, interpret=True))
    np.testing.assert_array_equal(got, np.asarray(pallas(cost)))
    for w in range(cost.shape[0]):
        if valid is not None:
            # the pairs on real columns are scipy's rectangular solution
            real = cost[w][:, valid[w]]
            rows, cols = linear_sum_assignment(real)
            want = {(r, int(np.flatnonzero(valid[w])[c])) for r, c in zip(rows, cols)}
            assert {(r, c) for r, c in enumerate(got[w]) if valid[w][c]} == want
            continue
        rows, cols = linear_sum_assignment(cost[w])
        if case == "ties":
            # several assignments are optimal: scipy breaks ties its own way
            # (so does the JAX solver); the total cost is the optimum
            np.testing.assert_allclose(cost[w][rows, got[w]].sum(),
                                       cost[w][rows, cols].sum(), rtol=0, atol=1e-5)
            assert len(set(got[w])) == len(got[w])
        else:
            np.testing.assert_array_equal(got[w], cols)


def test_masked_cost_matrix_pads_on_the_real_cost_scale_like_jax():
    rng = np.random.default_rng(11)
    cost = rng.normal(size=(3, 2, 5, 5)).astype(np.float32)
    valid = rng.uniform(size=(3, 2, 5)) < 0.5
    valid[0, 0] = False  # no real target: pad of 1
    got = masked_cost_matrix(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_masked_cost)(cost, valid)))
    assert (got[0, 0] == 1.0).all()


def test_lsap_wrapper_takes_plain_version_on_cpu():
    cost = torch.from_numpy(np.random.default_rng(12).normal(size=(2, 3, 4, 4)).astype(np.float32))
    before = lsap.launches
    got = hungarian(cost)
    assert lsap.launches == before
    assert got.shape == (2, 3, 4) and got.dtype == torch.int32
    torch.testing.assert_close(got, solve_dense_reference(cost.reshape(6, 4, 4)).reshape(2, 3, 4))


# ---------------------------------------------------- kernel backwards


@pytest.mark.parametrize("bh,length", [(8, 40), (2, 200)])
def test_flash_backward_reference_matches_jax_vjp(bh, length):
    rng = np.random.default_rng(13)
    q, k, v, g = (rng.normal(size=(bh, length, 32)).astype(np.float32) for _ in range(4))
    scale = 32 ** -0.5
    want = jax.jit(lambda *a: jax.vjp(
        lambda a, b, c: jax_flash(a, b, c, scale, True), *a[:3])[1](a[3]))(q, k, v, g)
    got = attention_backward_reference(*(torch.from_numpy(x) for x in (q, k, v, g)), scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, rtol=0, err_msg=name)

    # the autograd path on the CPU: the plain forward, then the plain backward
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    launches = (flash_attention.launches, flash_attention_backward.launches)
    flash_attention(qt, kt, vt, scale).backward(torch.from_numpy(g))
    assert (flash_attention.launches, flash_attention_backward.launches) == launches
    for name, t, b in zip(("dq", "dk", "dv"), (qt, kt, vt), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(b), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_gated_backward_matches_jax_vjp():
    rng = np.random.default_rng(14)
    Bg, L, D = 2, 12, HID
    args = [rng.normal(size=s).astype(np.float32) for s in
            ((Bg, 1, D), (Bg, L, D), (Bg, L, D), (D, D), (D,), (D, D), (D,))]
    cot = (rng.normal(size=(Bg, L)).astype(np.float32),
           rng.normal(size=(Bg, L, D)).astype(np.float32))
    want = jax.jit(lambda args, cot: jax.vjp(
        lambda *a: gated_cross_attention(*a, HEADS), *args)[1](cot))(args, cot)
    ts = [torch.from_numpy(a).requires_grad_() for a in args]
    att, out = gated_attention(*ts, HEADS)
    torch.autograd.backward((att, out), tuple(torch.from_numpy(c) for c in cot))
    names = ("sketch", "k_input", "mem", "wq", "bq", "wk", "bk")
    for name, t, w in zip(names, ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5, rtol=0,
                                   err_msg=name)


# ------------------------------------------------- matcher, criterion


def _predictions(rng, layers=2):
    logits = rng.normal(size=(layers, B, T * K, 2)).astype(np.float32)
    raw = rng.normal(size=(layers, B, T * K, 4)).astype(np.float32)
    return logits, (1 / (1 + np.exp(-raw))).astype(np.float32)


def _targets(seed):
    batch = sample_train_batch(port_cfg(), B, seed=seed)
    assert 0 < batch["box_valid"].sum() < batch["box_valid"].size
    return batch["boxes"], batch["box_valid"]


def test_boxes_match_jax():
    rng = np.random.default_rng(15)
    a = rng.uniform(0.1, 0.9, size=(3, 5, 4)).astype(np.float32)
    b = rng.uniform(0.1, 0.9, size=(3, 6, 4)).astype(np.float32)
    xa = boxes.box_cxcywh_to_xyxy(torch.from_numpy(a))
    xb = boxes.box_cxcywh_to_xyxy(torch.from_numpy(b))
    np.testing.assert_allclose(boxes.box_xyxy_to_cxcywh(xa).numpy(), a, atol=1e-6)

    @jax.jit
    def jax_side(a, b):
        ja, jb = jax_boxes.box_cxcywh_to_xyxy(a), jax_boxes.box_cxcywh_to_xyxy(b)
        return (jax_boxes.box_area(ja), *jax_boxes.box_iou(ja, jb),
                jax_boxes.generalized_box_iou(ja, jb))

    area, jiou, junion, giou = jax_side(a, b)
    np.testing.assert_allclose(boxes.box_area(xa).numpy(), np.asarray(area), atol=1e-6)
    iou, union = boxes.box_iou(xa, xb)
    np.testing.assert_allclose(iou.numpy(), np.asarray(jiou), atol=1e-6)
    np.testing.assert_allclose(union.numpy(), np.asarray(junion), atol=1e-6)
    np.testing.assert_allclose(boxes.generalized_box_iou(xa, xb).numpy(), np.asarray(giou),
                               atol=1e-6)


@pytest.mark.parametrize("stacked", [False, True])
def test_matcher_assignments_identical_to_jax(stacked):
    logits, pboxes = _predictions(np.random.default_rng(16))
    tb, tv = _targets(1)
    t = lambda x: torch.from_numpy(x)
    if stacked:
        got = match_per_frame_stacked(t(logits), t(pboxes), t(tb), t(tv))
        want = jax.jit(jax_match_stacked)(logits, pboxes, tb, tv)
    else:
        got = match_per_frame(t(logits[0]), t(pboxes[0]), t(tb), t(tv))
        want = jax.jit(jax_match_per_frame)(logits[0], pboxes[0], tb, tv)
    np.testing.assert_array_equal(got.tgt_index.numpy(), np.asarray(want.tgt_index))
    np.testing.assert_array_equal(got.matched.numpy(), np.asarray(want.matched))
    assert got.matched.any() and not got.matched.all()


@pytest.mark.parametrize("merged", [False, True])
def test_criterion_and_log_view_match_jax(merged):
    logits, pboxes = _predictions(np.random.default_rng(17))
    tb, tv = _targets(2)
    outputs = {"pred_logits": logits[-1], "pred_boxes": pboxes[-1],
               "aux_logits": logits[:-1], "aux_boxes": pboxes[:-1]}
    jcrit = jax_build_criterion(jax_cfg(merged_matcher=merged))
    order = []  # the criterion's key order, which a jitted result sorts

    def jax_losses(outputs, targets):
        losses = jcrit(outputs, targets)
        order.extend(losses)
        return losses

    want = jax.jit(jax_losses)(outputs, {"boxes": tb, "box_valid": tv})
    crit = build_criterion(port_cfg(merged_matcher=merged))
    got = crit({k: torch.from_numpy(v) for k, v in outputs.items()},
               {"boxes": torch.from_numpy(tb), "box_valid": torch.from_numpy(tv)})
    assert list(got) == order
    assert "loss_label_0" in got and "cardinality_error_0" in got
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-4,
                                   rtol=0, err_msg=k)
    assert crit.weight_dict == jcrit.weight_dict
    wview, jview = crit.weighted_log_view(got), jcrit.weighted_log_view(want)
    for k in jview:
        np.testing.assert_allclose(wview[k].numpy(), np.asarray(jview[k]), atol=1e-4,
                                   rtol=0, err_msg=k)


# --------------------------------------------- dropout, entry, config


def test_dropout_draws_from_the_generator_in_train_mode_only():
    proj = InputProjection(16, 8, n_layers=2, dropout=0.4)
    x = torch.randn(3, 5, 16, generator=torch.Generator().manual_seed(0))
    gen = lambda s: torch.Generator().manual_seed(s)
    rng_state = torch.get_rng_state()
    with torch.no_grad():
        a, b, c = (proj.train()(x, gen(s)) for s in (1, 1, 2))
        torch.testing.assert_close(a, b, atol=0, rtol=0)  # same seed, same masks
        assert not torch.equal(a, c)
        # the masks scale kept inputs by 1 / (1 - rate) and zero the rest
        normed = proj.proj0.norm(x)
        keep = torch.rand(x.shape, generator=gen(1)) < 0.6
        want = torch.nn.functional.linear(
            torch.where(keep, normed / 0.6, torch.zeros(())),
            proj.proj0.linear.weight, proj.proj0.linear.bias)
        torch.testing.assert_close(proj.proj0(x, gen(1)), torch.relu(want))
        with pytest.raises(ValueError, match="Generator"):
            proj(x)
        e1, e2 = proj.eval()(x), proj(x, gen(3))  # eval: no dropout at all
        torch.testing.assert_close(e1, e2, atol=0, rtol=0)
    assert torch.equal(torch.get_rng_state(), rng_state)  # global RNG untouched


@pytest.mark.parametrize("max_norm", [0.5, 50.0])
def test_clip_by_global_norm_matches_optax(max_norm):
    rng = np.random.default_rng(18)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(max_norm).update(grads, None)
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = global_norm(got)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
    clip_by_global_norm(got, max_norm, norm)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_adamw_steplr_matches_optax():
    """The port's AdamW + StepLR against the JAX package's optax chain, in
    float64 over 4 steps across the lr drop, on gradients from 1e-9 to 1
    (Adam's eps, 1e-8, matters at the small end). The JAX schedule yields
    its lr in float32 (1e-4 to 2.5e-8 relative), which bounds the agreement
    at ~3e-12: hence 1e-11, far below a slip in the decoupled weight decay
    (lr * wd * p, ~1e-8 p) or in the moments."""
    cfg = port_cfg()
    rng = np.random.default_rng(19)
    shapes = ((4, 3), (5,))
    params = [rng.normal(size=s) for s in shapes]
    grads = [[rng.normal(size=s) * 10.0 ** rng.uniform(-9, 0, size=s) for s in shapes]
             for _ in range(4)]
    module = torch.nn.ParameterList(torch.nn.Parameter(torch.from_numpy(p)) for p in params)
    state = create_train_state(cfg, module, device="cpu")
    with jax.enable_x64(True):
        tx = jax_make_optimizer(jax_cfg())
        want = [jnp.asarray(p) for p in params]
        opt = tx.init(want)
        for n, g in enumerate(grads):
            updates, opt = tx.update([jnp.asarray(x) for x in g], opt, want)
            want = optax.apply_updates(want, updates)
            for p, x in zip(module, g):
                p.grad = torch.from_numpy(x)
            state.optimizer.step()
            state.scheduler.step()
            for p, w in zip(module, want):
                np.testing.assert_allclose(p.detach().numpy(), np.asarray(w), atol=1e-11,
                                           rtol=0, err_msg=f"step {n}")


def test_ema_shadow_follows_the_parameters():
    cfg = port_cfg()
    cfg.train.ema_decay = 0.9
    model = SketchLocalizationModel(cfg)
    state = create_train_state(cfg, model, torch.Generator().manual_seed(0), device="cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert all(torch.equal(state.ema_params[n], p) for n, p in before.items())
    batch = {k: torch.from_numpy(v) for k, v in sample_train_batch(cfg, B, seed=3).items()}
    make_train_step(cfg, build_criterion(cfg))(state, batch)
    assert not torch.equal(state.ema_params["head.class_embed.weight"],
                           before["head.class_embed.weight"])
    for n, p in model.named_parameters():
        torch.testing.assert_close(state.ema_params[n], 0.9 * before[n] + 0.1 * p.detach())


def test_train_state_entry_requires_the_card_unless_told(monkeypatch):
    cfg = port_cfg()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        create_train_state(cfg, SketchLocalizationModel(cfg))


@pytest.mark.parametrize("section,field,value", [
    ("loss", "matcher", "video_matcher"), ("train", "optimizer", "sgd"),
    ("train", "scheduler", "reducelronplateau"), ("train", "freeze_backbone", True),
    ("model", "moe_experts", 4), ("eval", "calibration_batches", 1)])
def test_config_refuses_what_is_not_ported(section, field, value):
    cfg = port_cfg()
    setattr(getattr(cfg, section), field, value)
    with pytest.raises(NotImplementedError):
        cfg.validate()


@pytest.mark.parametrize("value,accepted", [("int8", "int8"), ("none", None),
                                            ("int4", ValueError)])
def test_config_takes_int8_serving_and_refuses_other_modes(value, accepted):
    """``quantize`` as the JAX config takes it: int8 (ported with the
    serving slice), a spelling of no quantization, or an error."""
    cfg = port_cfg()
    cfg.model.quantize, cfg.model.quantize_attention = value, True
    if accepted is ValueError:
        with pytest.raises(ValueError, match="quantize"):
            cfg.validate()
        return
    cfg.validate()
    assert cfg.model.quantize == accepted
    again = port_config.SvolConfig.from_dict(cfg.to_dict())
    assert again.model.quantize == accepted and again.model.quantize_attention

"""The port's train step against the JAX package at the model level: the
train-mode forward and its BatchNorm statistics, the loss and every
parameter's gradient, and a 3-step AdamW + StepLR trajectory of
``make_train_step`` against the JAX package's.

The configuration is test_torch_port_train.py's (test_torch_port_model.py's
small one: ResNet-34/18 as they are, 64 px frames, T=2, K=2, hidden 32, 4
heads, 2 layers, FFN 64, B=2) with flash and gated attention on and input
dropout off. The JAX side runs its Pallas kernels in interpret mode, the
port its plain versions. Weights are numpy draws carried over by
``convert_jax_variables``; batches come from the port's
``sample_train_batch`` and go to both sides as numpy arrays. The reference
runs in float64 (see ``jax_reference``) and compiles once: the forward's
outputs and statistics are those of the first train step.

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_port_train_step.py

prints the float32 readings behind the float64 choice: for every
parameter leaf where the two frameworks' float32 gradients differ beyond
the gradient tolerance, each one's distance from the float64 JAX gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from svol_tpu.losses.criterion import build_criterion as jax_build_criterion
from svol_tpu.models import build_model
from svol_tpu.train.state import TrainState as JaxTrainState
from svol_tpu.train.state import make_optimizer as jax_make_optimizer
from svol_tpu.train.steps import make_train_step as jax_make_train_step
from svol_tpu_torch.data.synthetic import sample_train_batch, to_device
from svol_tpu_torch.losses.criterion import build_criterion
from svol_tpu_torch.models.model import SketchLocalizationModel
from svol_tpu_torch.train.state import create_train_state
from svol_tpu_torch.train.steps import make_train_step
from svol_tpu_torch.utils.jax_weights import convert_jax_variables, port_state_to_jax_numpy
from test_torch_port_model import abstract_init, fill_variables
from test_torch_port_train import B, jax_cfg, port_cfg
from torch_port_reference_cache import load_or_compute, shared
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

N_STEPS = 3
INPUTS = ("src_sketch", "src_video", "src_sketch_mask", "src_video_mask")
OUT = "out/"  # metric keys that carry the forward's outputs (_KeepOutputs)
GRAD_ATOL, GRAD_RTOL = 2e-4, 1e-3  # tests/test_full_model_parity.py's


def tree(x):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(x).items()}


class _KeepOutputs:
    """The JAX criterion, which also hands the model's outputs to the step's
    metrics (``out/<key>``, outside the gradient), so that one compiled
    train step yields the train-mode forward too."""

    def __init__(self, criterion):
        self.criterion = criterion

    def __call__(self, outputs, targets):
        losses = dict(self.criterion(outputs, targets))
        losses.update({OUT + k: jax.lax.stop_gradient(v) for k, v in outputs.items()})
        return losses

    def weighted_log_view(self, losses):
        return self.criterion.weighted_log_view(losses)


def jax_trajectory(variables, batches, compute_dtype):
    """N_STEPS of the JAX package's production train step from
    ``variables``, one batch each: [(params, batch_stats, metrics)] after
    every step, the first step's gradients and its forward's outputs.

    Its AdamW sits behind a pass-through stage that keeps the step's
    gradients in the optimizer state. The JAX LSAP solver's loops are
    written for 32-bit indices, so under x64 it is handed its float32 cost
    in a 32-bit trace, as it is in float32."""
    import svol_tpu.losses.matcher as jax_matcher

    solver = jax_matcher.hungarian

    def hungarian_32(cost):
        with jax.enable_x64(False):
            return solver(cost.astype(jnp.float32))

    jax_matcher.hungarian = hungarian_32
    try:
        with jax.enable_x64(compute_dtype == "float64"):
            cfg = jax_cfg()
            cfg.model.compute_dtype = compute_dtype
            model = build_model(cfg)
            keep = optax.GradientTransformation(
                init=lambda params: jax.tree.map(jnp.zeros_like, params),
                update=lambda updates, state, params=None: (updates, updates))
            # the step returns running statistics in the compute dtype:
            # start from them so that it compiles once
            state = jax.jit(lambda params, stats: JaxTrainState.create(
                apply_fn=model.apply, params=params,
                tx=optax.chain(keep, jax_make_optimizer(cfg)),
                batch_stats=jax.tree.map(lambda x: x.astype(compute_dtype), stats)))(
                    variables["params"], variables["batch_stats"])
            step = jax_make_train_step(cfg, _KeepOutputs(jax_build_criterion(cfg)),
                                       donate=False)
            side = {"trajectory": []}
            for batch in batches:
                state, metrics = step(state, batch, jax.random.PRNGKey(0))
                side.setdefault("out", {k[len(OUT):]: np.asarray(v)
                                        for k, v in metrics.items() if k.startswith(OUT)})
                side.setdefault("grads", tree(state.opt_state[0]))
                side["trajectory"].append((
                    tree(state.params), tree(state.batch_stats),
                    {k: float(v) for k, v in metrics.items() if not k.startswith(OUT)}))
            return side
    finally:
        jax_matcher.hungarian = solver


def jax_inputs():
    """The weights (numpy draws into the flax tree) and the batches."""
    batches = [sample_train_batch(port_cfg(), B, seed=20 + i) for i in range(N_STEPS)]
    variables = fill_variables(
        abstract_init(build_model(jax_cfg()), **{k: batches[0][k] for k in INPUTS}),
        np.random.default_rng(21))
    return {"variables": variables, "batches": batches}


def jax_reference():
    """Weights, batches and the JAX package's float64 trajectory on them
    (its parameters stay float32; the criterion, matcher and the attention
    softmax keep their float32 casts).

    Why float64: in float32 a few ReLU inputs of the ResNets land within
    rounding of zero, each framework gates them its own way, and train-mode
    BatchNorm over 4 frames spreads each flip over its channel, so the two
    float32 gradients differ far beyond the gradient tolerance in the
    backbone leaves at and below a flip (the readings: this file's
    ``__main__``). In float64 the gates agree and every tolerance holds.
    The port's float32 forward and its float32 gradients outside the
    backbones are held to this reference as well."""
    inputs = jax_inputs()
    side = jax_trajectory(inputs["variables"], inputs["batches"], "float64")
    side.update(inputs)
    return side


def prefetch_references(directory):
    """What the two fixtures below compute, into ``directory``: started
    ahead of them in a child process (tests/torch_port_reference_cache.py)."""
    inputs = load_or_compute(directory, "train_step_jax_inputs", jax_inputs)[0]
    load_or_compute(directory, "train_step_jax_trajectory",
                    lambda: jax_trajectory(inputs["variables"], inputs["batches"],
                                           "float64"))


# Each reference is built once per run, by the child process above or by
# one xdist worker, and loaded by the others
# (tests/torch_port_reference_cache.py).
@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return shared(tmp_path_factory, "train_step_jax_inputs", jax_inputs)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, inputs):
    trajectory = shared(tmp_path_factory, "train_step_jax_trajectory",
                        lambda: jax_trajectory(inputs["variables"], inputs["batches"],
                                               "float64"))
    return dict(trajectory, **inputs)


def port_model(variables, float64=False):
    model = SketchLocalizationModel(port_cfg())
    model.load_state_dict(convert_jax_variables(variables), strict=True)
    if float64:
        model.double()
        model.dtype = torch.float64
    return model


def double(batch):
    return {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}


def port_loss_and_grads(variables, batch, float64):
    """The port's first-step losses (weighted log view) and gradients, in
    the flax tree's names."""
    model = port_model(variables, float64).train()
    batch = to_device(batch, "cpu")
    if float64:
        batch = double(batch)
    out = model(**{k: batch[k] for k in INPUTS})
    criterion = build_criterion(port_cfg())
    losses = criterion(out, {"boxes": batch["boxes"], "box_valid": batch["box_valid"]})
    losses["loss_overall"].backward()
    grads = tree(port_state_to_jax_numpy(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    return {k: float(v.detach()) for k, v in criterion.weighted_log_view(losses).items()}, grads


def _in_backbone(key: str) -> bool:
    return key.startswith("backbone/")


def test_train_mode_forward_and_batch_stats_match_jax(jax_side):
    """The port's float32 train-mode forward against the JAX reference's
    first train step."""
    model = port_model(jax_side["variables"]).train()
    batch = to_device(jax_side["batches"][0], "cpu")
    with torch.no_grad():
        out = model(**{k: batch[k] for k in INPUTS})
    for key in ("pred_logits", "pred_boxes", "aux_logits", "aux_boxes"):
        # the full-model tolerance (tests/test_full_model_parity.py)
        np.testing.assert_allclose(out[key].numpy(), jax_side["out"][key],
                                   atol=1e-4, rtol=0, err_msg=key)
    # BatchNorm: batch mean and biased variance, ra = 0.9 ra + 0.1 stat.
    # Deep layers' statistics carry the float32 activations' error (~1e-5
    # relative), hence rtol 1e-4; an unbiased variance over the 16 values
    # of a layer4 channel would be off by 0.1 * var / 15 (~7e-3), a
    # momentum slip by far more.
    stats = tree(port_state_to_jax_numpy(model.state_dict())["batch_stats"])
    want_stats = jax_side["trajectory"][0][1]
    assert set(stats) == set(want_stats)
    for key, want in want_stats.items():
        np.testing.assert_allclose(stats[key], want, atol=1e-5, rtol=1e-4, err_msg=key)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_loss_and_gradients_match_jax(jax_side, dtype):
    """The first step's losses and gradients, as the JAX train step takes
    them (value_and_grad of the criterion's loss_overall). In float64 every
    leaf; the port's float32 gradients on every leaf outside the ResNets,
    whose gradients never pass a backbone ReLU (see jax_reference)."""
    logged, grads = port_loss_and_grads(jax_side["variables"], jax_side["batches"][0],
                                        dtype == "float64")
    for key, want in jax_side["trajectory"][0][2].items():
        if key != "grad_norm":
            np.testing.assert_allclose(logged[key], want, atol=1e-4, rtol=0, err_msg=key)
    assert set(grads) == set(jax_side["grads"])
    for key, want in jax_side["grads"].items():
        if dtype == "float64" or not _in_backbone(key):
            np.testing.assert_allclose(grads[key], want, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=key)


def _zero_gradient(key: str) -> bool:
    """Leaves whose exact gradient is zero, so that both sides hold only
    rounding: every softmax attention's key bias (adding one constant to
    all of a query's logits leaves the softmax unchanged), and the first
    layer's query self-attention q/k projections (the query stream starts
    at zeros, so its values are zero and its weights do not matter)."""
    return (key.endswith(("k_proj/bias", "k_proj_bias"))
            or "layer0/token_self_attn/q_proj" in key
            or "layer0/token_self_attn/k_proj" in key)


# Each step's update (parameters after minus before) is compared on every
# element whose gradient has been real at every step so far (|g| >= 1e-6,
# tests/test_optimizer_parity.py's rounding level, and outside the
# parameters' mask below): to 1e-6 (1% of lr) beyond half a float32
# spacing of the JAX parameter, which rounds its p + u. An element at rounding level moves by +-lr decided by rounding, and
# from the second step on those moves shift the gradients a little: where an
# element's Adam ratio m / sqrt(v) nearly cancels, its update then follows
# (69 and 714 of 2e7 elements beyond 1e-6 at steps 1 and 2, worst 1.4e-5;
# 0 at step 0, worst 1.6e-7). The optimizer's own arithmetic is held to
# optax in float64 by test_torch_port_train.py::test_adamw_steplr_matches_optax.
UPDATE_ATOL = 1e-6
UPDATE_OUTLIERS = 1e-4  # of the compared elements, from the second step on


def test_adamw_steplr_trajectory_matches_jax(jax_side):
    """3 train steps from the same weights, a different batch each, the lr
    drop after step 2, in float64 (see jax_reference): each step's update
    (above), and the parameters with tests/test_optimizer_parity.py's rule:
    within 1e-4, or within 2.5e-4 per step on elements whose gradient has
    been at rounding level, which must stay under 0.01% of the total.
    Rounding level is here 1e-6 of the leaf's largest gradient, and all of a
    leaf whose exact gradient is zero (``_zero_gradient``)."""
    cfg = port_cfg()
    model = port_model(jax_side["variables"], float64=True)
    state = create_train_state(cfg, model, device="cpu")
    step = make_train_step(cfg, build_criterion(cfg))
    noise, real = {}, {}
    relied = 0  # elements inside the mask and outside the 1e-4 tolerance
    lrs = []
    # port minus JAX parameters before the step (equal at the start): the
    # difference of the two updates is this difference's change
    gap = {}
    for n, (batch, (want_p, want_s, want_m)) in enumerate(
            zip(jax_side["batches"], jax_side["trajectory"])):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state, metrics = step(state, double(to_device(batch, "cpu")))
        assert state.step == n + 1
        assert set(metrics) == set(want_m)
        for key, want in want_m.items():
            # grad_norm, a norm of the gradients, to the gradient
            # tolerance's 1e-3 relative (it is ~900 here, and after two
            # steps inherits the masked elements' drift)
            np.testing.assert_allclose(
                float(metrics[key]), want, atol=1e-4,
                rtol=GRAD_RTOL if key == "grad_norm" else 0, err_msg=f"step {n}: {key}")
        exported = port_state_to_jax_numpy(model.state_dict())
        grads = tree(port_state_to_jax_numpy(
            {name: p.grad for name, p in model.named_parameters()})["params"])
        params = tree(exported["params"])
        assert set(params) == set(want_p)
        compared = outliers = 0
        for key, want in want_p.items():
            g = np.abs(grads[key])
            top = g.max()
            noise[key] = noise.get(key, False) | (g < 1e-6 * top) | _zero_gradient(key)
            real[key] = real.get(key, True) & (g >= 1e-6 * max(1.0, top)) & ~noise[key]
            compared += int(real[key].sum())
            diff = params[key] - want
            off = np.abs(diff - gap.get(key, 0.0))
            beyond = (off > UPDATE_ATOL) & real[key]
            if beyond.any():  # then allow the JAX p + u its float32 rounding
                off = off[beyond] - 0.5 * np.spacing(np.abs(want[beyond]))
                outliers += int((off > UPDATE_ATOL).sum())
                assert n > 0 or (off <= UPDATE_ATOL).all(), \
                    f"step 0: {key}: update off by {off.max():.2e}"
            gap[key] = diff
            diff = np.abs(diff)
            far = diff > 1e-4
            ok = ~far | (noise[key] & (diff <= 2.5e-4 * (n + 1)))
            assert ok.all(), f"step {n}: {key}: worst {diff[~ok].max():.2e}"
            relied += int(far.sum())
        assert compared > 0.5 * sum(m.size for m in noise.values())
        assert outliers <= UPDATE_OUTLIERS * compared, f"step {n}: {outliers} of {compared}"
        stats = tree(exported["batch_stats"])
        for key, want in want_s.items():
            np.testing.assert_allclose(stats[key], want, atol=1e-4, rtol=0,
                                       err_msg=f"step {n}: {key}")
        # a broken optimizer cannot hide in the mask: hardly any element
        # needs it
        assert relied < 1e-4 * sum(m.size for m in noise.values()), relied
    assert lrs == pytest.approx([1e-4, 1e-4, 1e-5], rel=1e-12)


def test_weights_round_trip_through_the_flax_names(inputs):
    state = convert_jax_variables(inputs["variables"])
    back = port_state_to_jax_numpy(state)
    for coll in ("params", "batch_stats"):
        got, want = tree(back[coll]), tree(inputs["variables"][coll])
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def float32_readings():
    """Per leaf where the two float32 gradients differ beyond the gradient
    tolerance: its size, the largest gradient, and each float32 gradient's
    largest distance from the other and from the float64 JAX gradient."""
    ref = jax_reference()
    jax32 = jax_trajectory(ref["variables"], ref["batches"][:1], "float32")["grads"]
    _, port32 = port_loss_and_grads(ref["variables"], ref["batches"][0], False)
    print(f"{'leaf':<58} {'size':>7} {'max|g64|':>9} {'port-jax':>9} "
          f"{'port-g64':>9} {'jax-g64':>9}")
    for key, g64 in ref["grads"].items():
        a, b = port32[key], jax32[key]
        if not np.allclose(a, b, atol=GRAD_ATOL, rtol=GRAD_RTOL):
            dist = lambda x, y: float(np.abs(x - y).max())
            print(f"{key:<58} {g64.size:>7} {np.abs(g64).max():>9.3e} {dist(a, b):>9.3e} "
                  f"{dist(a, g64):>9.3e} {dist(b, g64):>9.3e}")


if __name__ == "__main__":
    import conftest  # noqa: F401  (the CPU platform and compile cache)

    float32_readings()

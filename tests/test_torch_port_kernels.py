"""The port's kernel modules against the JAX package's Pallas kernels, and
the port's import hygiene.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
its Pallas kernels in interpret mode, as the JAX package's own tests do.
The CUDA kernels themselves are held against these plain versions on the
card by chip_smoke.py.
"""
import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svol_tpu.ops.pallas import flash_attention as jax_flash
from svol_tpu.ops.pallas.gated_attention import gated_cross_attention
from svol_tpu_torch.ops.kernels.flash_attention import (
    attention_reference,
    flash_attention,
    threads_per_row,
)
from svol_tpu_torch.ops.kernels.gated_attention import (
    gated_attention,
    gated_attention_reference,
)
from torch_port_reference_cache import prefetch_costly_references  # noqa: F401
from torch_port_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("bh,length,packed", [(8, 40, True), (2, 600, False)])
def test_attention_reference_matches_jax_flash(bh, length, packed):
    # L=40 packs 8 batch-heads per grid step (_kernel_packed); L=600 has a
    # 1.44 MB f32 logits tile, above the 1 MB packing limit, so it takes the
    # one-head _kernel
    assert (jax_flash._block_bh(bh, length, length) > 1) == packed
    rng = np.random.default_rng(length)
    q, k, v = (rng.normal(size=(1, bh, length, 8)).astype(np.float32)
               for _ in range(3))
    scale = 8 ** -0.5
    want = np.asarray(jax_flash.flash_self_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale))[0]
    got = attention_reference(torch.from_numpy(q[0]), torch.from_numpy(k[0]),
                              torch.from_numpy(v[0]), scale)
    # f32 sums in another order: the tolerance of tests/test_torch_parity.py
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


def test_flash_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.normal(size=(4, 24, 32)).astype(np.float32))
               for _ in range(3))
    before = flash_attention.launches
    out = flash_attention(q, k, v, 32 ** -0.5)
    assert flash_attention.launches == before
    torch.testing.assert_close(out, attention_reference(q, k, v, 32 ** -0.5),
                               atol=0, rtol=0)


def test_flash_launch_shape_follows_sequence_length():
    # the flagship's query self-attention (L = 320) splits each query row
    # over 4 threads; the video self-attention (L = 1568) keeps one
    assert threads_per_row(320, 320) == 4
    assert threads_per_row(1568, 1568) == 1


def _gated_inputs(seed, B=2, L=50, D=32):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    bound = (6.0 / (2 * D)) ** 0.5
    w = lambda: rng.uniform(-bound, bound, size=(D, D)).astype(np.float32)
    return (f(B, 1, D), f(B, L, D), f(B, L, D), w(), 0.1 * f(D), w(),
            0.1 * f(D))


def test_gated_reference_matches_jax_kernel():
    args = _gated_inputs(0)
    want_att, want_out = gated_cross_attention(*map(jnp.asarray, args),
                                               num_heads=4)
    got_att, got_out = gated_attention_reference(
        *map(torch.from_numpy, args), num_heads=4)
    # the Pallas kernel reduces heads through a head-indicator matmul, the
    # plain version through an einsum: f32 sums in another order
    np.testing.assert_allclose(got_att.numpy(), np.asarray(want_att), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_out.numpy(), np.asarray(want_out), atol=1e-5, rtol=0)


def test_gated_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _gated_inputs(1)]
    before = gated_attention.launches
    att, out = gated_attention(*args, num_heads=4)
    assert gated_attention.launches == before
    ref_att, ref_out = gated_attention_reference(*args, num_heads=4)
    torch.testing.assert_close(att, ref_att, atol=0, rtol=0)
    torch.testing.assert_close(out, ref_out, atol=0, rtol=0)


def _port_sources():
    pkg = os.path.join(REPO, "svol_tpu_torch")
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_port_imports_no_jax_flax_or_svol_tpu():
    banned = ("jax", "jaxlib", "flax", "svol_tpu")
    offenders = []
    sources = list(_port_sources())
    assert len(sources) > 10
    names = {os.path.relpath(p, REPO) for p in sources}
    assert {"svol_tpu_torch/ops/quant.py",
            "svol_tpu_torch/ops/kernels/flash_attention_int8.py",
            "svol_tpu_torch/ops/kernels/layer_norm.py",
            "svol_tpu_torch/models/vit.py"} <= names
    for path in sources:
        with open(path) as f:
            tree = ast.parse(f.read(), filename=path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in banned:
                    offenders.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert not offenders, offenders


def test_importing_the_port_loads_no_jax():
    code = ("import sys, svol_tpu_torch.cli.serve, svol_tpu_torch.utils.jax_weights, "
            "svol_tpu_torch.train.steps, svol_tpu_torch.train.state, "
            "svol_tpu_torch.losses.criterion, svol_tpu_torch.ops.hungarian, "
            "svol_tpu_torch.data.synthetic, svol_tpu_torch.ops.quant, "
            "svol_tpu_torch.ops.kernels.flash_attention_int8, "
            "svol_tpu_torch.models.vit, svol_tpu_torch.ops.kernels.layer_norm; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'svol_tpu')]; print(bad); assert not bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

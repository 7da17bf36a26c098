"""Convert the JAX package's ``{"params", "batch_stats", "quant"}`` tree
into the port's ``state_dict``.

The port names its submodules after the flax tree, so the mapping is
mechanical: the tree path joined by dots is the parameter name, and only
the leaf name and layout change:

    Dense  kernel (in, out)       -> weight (out, in)
    Conv   kernel HWIO            -> weight OIHW
    LayerNorm / BatchNorm scale   -> weight;  bias -> bias
    BatchNorm mean / var          -> running_mean / running_var
    quant amax / amax_q/k/v       -> the same name, a float32 scalar buffer
                                     (calibrated int8 scales)
    everything else (the gated op's raw q/k projections, query_embed,
    the ViT's cls_token and pos_embed)
                                  -> the same name and layout

Leaves are numpy arrays (or anything ``np.asarray`` takes); the result
loads with ``load_state_dict(strict=True)`` (into a model built with
``quantize='int8'`` whose scale buffers ``ops.quant.load_quant_scales``
has set, when the tree holds ``quant``). ``port_state_to_jax_numpy``
maps a port ``state_dict`` back into the flax tree's names and layouts, so
that the two can be compared leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from svol_tpu_torch.ops.quant import SCALE_NAMES

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (str(key),))
        else:
            yield prefix + (str(key),), val


def convert_jax_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    state: Dict[str, torch.Tensor] = {}
    for path, leaf in _leaves(variables.get("params", {})):
        arr = np.asarray(leaf, dtype=np.float32)
        *mod, name = path
        if name == "kernel" and arr.ndim == 2:
            name, arr = "weight", arr.T
        elif name == "kernel" and arr.ndim == 4:
            name, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif name == "scale":
            name = "weight"
        state[".".join(mod + [name])] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, leaf in _leaves(variables.get("batch_stats", {})):
        *mod, name = path
        if name not in _STATS:
            raise KeyError(f"unexpected batch statistic {'/'.join(path)}")
        state[".".join(mod + [_STATS[name]])] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    for path, leaf in _leaves(variables.get("quant", {})):
        if path[-1] not in SCALE_NAMES:
            raise KeyError(f"unexpected quant leaf {'/'.join(path)}")
        state[".".join(path)] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return state


def port_state_to_jax_numpy(state: Mapping[str, torch.Tensor]) -> Dict[str, Dict]:
    """The reverse of ``convert_jax_variables``: a port ``state_dict`` ->
    ``{"params": ..., "batch_stats": ...}`` (and ``"quant"`` where it holds
    calibrated scales) nested dicts of float32 numpy arrays under the flax
    tree's names and layouts."""
    stats = {v: k for k, v in _STATS.items()}
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for key, t in state.items():
        *mod, name = key.split(".")
        arr = t.detach().float().cpu().numpy()
        if name in SCALE_NAMES:
            coll = "quant"
        elif name in stats:
            coll, name = "batch_stats", stats[name]
        else:
            coll = "params"
            if name == "weight" and arr.ndim == 2:
                name, arr = "kernel", arr.T
            elif name == "weight" and arr.ndim == 4:
                name, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif name == "weight":
                name = "scale"
        node = out.setdefault(coll, {})
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(arr)
    return out

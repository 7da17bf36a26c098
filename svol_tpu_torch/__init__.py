"""PyTorch/CUDA port of svol_tpu for one NVIDIA H100.

The JAX package ``svol_tpu`` is the reference this port is held against
(tests/test_torch_port_*.py); the port imports nothing from it. Kernels the
JAX package wrote in Pallas are hand-written CUDA C++ for sm_90a under
``csrc/``, built at first use (``ops/kernels/build.py``).

Entry points (``serving.load_exported``, ``cli.serve.start_server``,
``train.state.create_train_state``) run on the card unless the caller passes
``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card; without CUDA that raises instead of
    silently running on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU")
        device = "cuda"
    return torch.device(device)

"""Batched exact LSAP: W problems of (R, C) costs, R <= C, -> (W, R) int32
col4row, the column assigned to each row.

Port of svol_tpu/ops/hungarian.py::_solve_dense_pallas (body
``_solve_dense_t``): the shortest-augmenting-path Jonker-Volgenant solver
that scipy's ``linear_sum_assignment`` implements, with the JAX solver's
finite 1e30 "infinity" and first-index argmin ties, so assignments equal
scipy's. The kernel, ``csrc/lsap.cu``, runs one warp per problem for
C <= 32; ``solve_dense_reference`` is the plain PyTorch version.
"""
from __future__ import annotations

import ctypes

import torch

from svol_tpu_torch.ops.kernels import build

BIG = 1e30  # finite "infinity": no inf - inf = nan in the dual updates
MAX_COLS = 32  # one warp lane per column


def solve_dense_reference(cost: torch.Tensor, count_trips: bool = False):
    """Plain PyTorch version of ``_solve_dense_t``, batch first: the same f32
    arithmetic in the same order. The while loops run their bound of trips
    (C per Dijkstra search, R per augmentation) with finished problems
    frozen, which gives the same final state without a data-dependent host
    branch. With ``count_trips`` also returns each problem's number of
    Dijkstra trips that did work, (W,) int64: the solve's data-dependent
    operation count."""
    W, R, C = cost.shape
    if R > C:
        raise ValueError(f"LSAP needs rows <= cols, got {R} x {C}")
    dev = cost.device
    cost = cost.float()
    w_idx = torch.arange(W, device=dev)
    rows = torch.arange(R, device=dev)
    cols = torch.arange(C, device=dev)
    u = torch.zeros(W, R, device=dev)
    v = torch.zeros(W, C, device=dev)
    row4col = torch.full((W, C), -1, dtype=torch.long, device=dev)
    col4row = torch.full((W, R), -1, dtype=torch.long, device=dev)
    big = torch.full((), BIG, device=dev)
    trips = torch.zeros(W, dtype=torch.long, device=dev)
    for cur in range(R):
        shortest = torch.full((W, C), BIG, device=dev)
        path = torch.full((W, C), -1, dtype=torch.long, device=dev)
        vcol = torch.zeros(W, C, dtype=torch.bool, device=dev)
        vrow = torch.zeros(W, R, dtype=torch.bool, device=dev)
        i = torch.full((W,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros(W, device=dev)
        sink = torch.full((W,), -1, dtype=torch.long, device=dev)
        for _ in range(C):
            active = sink < 0
            trips += active
            vrow |= (rows == i[:, None]) & active[:, None]
            cost_i = cost[w_idx, i]  # (W, C)
            u_i = u[w_idx, i]
            reduced = min_val[:, None] + cost_i - u_i[:, None] - v
            better = (reduced < shortest) & ~vcol & active[:, None]
            shortest = torch.where(better, reduced, shortest)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(vcol, big, shortest)
            j = masked.argmin(dim=1)  # the first index among ties
            min_val = torch.where(active, masked[w_idx, j], min_val)
            vcol |= (cols == j[:, None]) & active[:, None]
            r4c_j = row4col[w_idx, j]
            unassigned = r4c_j < 0
            sink = torch.where(active & unassigned, j, sink)
            i = torch.where(active & ~unassigned, r4c_j, i)

        # dual updates (scipy rectangular_lsap.cpp)
        is_cur = rows == cur
        u = torch.where(is_cur, u + min_val[:, None], u)
        sh_c4r = torch.where(col4row >= 0,
                             shortest.gather(1, col4row.clamp(min=0)),
                             torch.zeros((), device=dev))
        u = torch.where(vrow & ~is_cur, u + (min_val[:, None] - sh_c4r), u)
        v = torch.where(vcol, v - (min_val[:, None] - shortest), v)

        # augment along the alternating path back to cur
        j = sink
        done = torch.zeros(W, dtype=torch.bool, device=dev)
        for _ in range(R):
            act = ~done
            i = path[w_idx, j.clamp(min=0)]
            row4col = torch.where((cols == j[:, None]) & act[:, None],
                                  i[:, None], row4col)
            nxt = col4row[w_idx, i.clamp(min=0)]
            col4row = torch.where((rows == i[:, None]) & act[:, None],
                                  j[:, None], col4row)
            j = torch.where(act, nxt, j)
            done |= i == cur
    return (col4row.int(), trips) if count_trips else col4row.int()


def lsap(cost: torch.Tensor) -> torch.Tensor:
    """(W, R, C) float32 costs -> (W, R) int32 col4row. CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    if cost.device.type == "cpu":
        return solve_dense_reference(cost)
    if cost.device.type != "cuda":
        raise ValueError(f"lsap: unsupported device {cost.device}")
    if cost.dtype != torch.float32:
        raise TypeError(f"lsap: costs must be float32, got {cost.dtype}")
    if cost.dim() != 3:
        raise ValueError(f"lsap: costs must be (W, R, C), got {tuple(cost.shape)}")
    W, R, C = cost.shape
    if W == 0 or R == 0 or R > C or C > MAX_COLS:
        raise ValueError(f"lsap: needs 0 < R <= C <= {MAX_COLS} and W > 0, "
                         f"got W={W}, R={R}, C={C}")
    if not cost.is_contiguous():
        raise ValueError("lsap: costs must be contiguous")
    lib = _lib()
    out = torch.empty((W, R), dtype=torch.int32, device=cost.device)
    rc = lib.svol_lsap(cost.data_ptr(), out.data_ptr(), W, R, C,
                       torch.cuda.current_stream(cost.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("lsap launch failed: " + lib.svol_error_string(rc).decode())
    lsap.launches += 1
    return out


lsap.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load("lsap")
    if not getattr(lib, "_svol_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.svol_lsap.argtypes = [p, p, i, i, i, p]
        lib.svol_lsap.restype = i
        lib.svol_error_string.argtypes = [i]
        lib.svol_error_string.restype = ctypes.c_char_p
        lib._svol_typed = True
    return lib

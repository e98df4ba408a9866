"""Argument checks shared by the CUDA kernel wrappers, their launch
counts, and the empty launch their times are read against."""
from __future__ import annotations

import ctypes
import threading

import torch

from ..dist.compression import GUARD_SLACK
from . import _build

ROW_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# 1 + GUARD_SLACK, the factor every lower-bound site applies; ctypes rounds
# it to f32 as PyTorch rounds the same Python float
SLACK_FACTOR = 1.0 + GUARD_SLACK


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, route: str | None = None) -> None:
    """Add one to a wrapper's ``launches`` (and to its ``routes[route]``).
    The sharded fan-out's worker threads launch at once, and ``+=`` on an
    attribute is a read, an add and a write, so the update holds a lock."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if route is not None:
            wrapper.routes[route] += 1


def check_tensor(name: str, t: torch.Tensor, dtypes, ndim: int,
                 device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} has dtype {t.dtype}, expected one of "
                         f"{tuple(dtypes)}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def vector_rows(points: torch.Tensor) -> int:
    """1 when every row starts on a 16-byte boundary, so the kernels may
    read rows 16 bytes a lane."""
    row_bytes = points.shape[1] * points.element_size()
    return int(row_bytes % 16 == 0 and points.data_ptr() % 16 == 0)


def check_metric(metric: str) -> int:
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric {metric!r}")
    return int(metric == "l2")


def code_vec(codes: torch.Tensor) -> int:
    """The bytes an int8 kernel's lane may read from a code row at once: 16
    when every row starts on a 16-byte boundary, 4 on a 4-byte boundary
    (``__dp4a`` words), else 1."""
    d, ptr = codes.shape[1], codes.data_ptr()
    for vec in (16, 4):
        if d % vec == 0 and ptr % vec == 0:
            return vec
    return 1


def empty_launch(blocks: int, threads: int, device) -> None:
    """Launch an empty kernel (``empty_launch`` in
    ``gatherdist/csrc/gatherdist_int8.cu``) on ``blocks`` blocks of
    ``threads`` threads, on the current stream of ``device``: the launch
    floor of a route's grid, whichever kernel's. It counts as no launch of
    any kernel."""
    lib = _build.load("gatherdist_int8")
    fn = lib.empty_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = torch.device(device)
    with torch.cuda.device(dev):
        rc = fn(blocks, threads, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "gatherdist_int8", rc)

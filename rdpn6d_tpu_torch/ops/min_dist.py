"""Pairwise min squared distance: the CUDA kernel and its plain version.

Counterpart of ``rdpn6d_tpu/ops/pallas_kernels.py`` (``min_dist2_pallas``,
``min_dist2``, ``adi_distance``). For each row of a, the minimum over the
rows of b of |a - b|^2, batched over a leading axis: a [B,N,D], b [B,M,D]
-> [B,N] float32 (2-D inputs are the case B = 1 and give [N]).

``min_dist2`` picks by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch ``csrc/min_dist2.cu`` (built with nvcc at
first use) or raise. Both compute the direct form sum_d (a_d - b_d)^2 in
float32; the kernel's source note says why not the expanded
|a|^2 - 2 a.b + |b|^2 the TPU kernel uses.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

KERNEL = "min_dist2"
_PLAIN_BUDGET = 1 << 24   # elements of one [B, N, chunk] temporary


def min_dist2_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the direct form over chunks of b rows.
    a [B,N,D], b [B,M,D] float32 -> [B,N]."""
    B, N, D = a.shape
    M = b.shape[1]
    chunk = max(1, _PLAIN_BUDGET // max(1, B * N))
    best = torch.full((B, N), float("inf"), dtype=torch.float32,
                      device=a.device)
    for lo in range(0, M, chunk):
        bc = b[:, lo:lo + chunk]
        d2 = (a[:, :, None, 0] - bc[:, None, :, 0]) ** 2
        for d in range(1, D):
            d2 = d2 + (a[:, :, None, d] - bc[:, None, :, d]) ** 2
        best = torch.minimum(best, d2.amin(-1))
    return best


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device != b.device:
        raise ValueError(f"min_dist2: a on {a.device}, b on {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"min_dist2: float32 inputs required, got "
                        f"{a.dtype} and {b.dtype}")
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] \
            or a.shape[2] != b.shape[2]:
        raise ValueError(f"min_dist2: expected a [B,N,D], b [B,M,D]; got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.shape[1] == 0:
        raise ValueError("min_dist2: b has no rows")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("min_dist2: inputs must be contiguous")


def min_dist2_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. a [B,N,D], b [B,M,D]
    float32 contiguous CUDA tensors -> [B,N]."""
    _check(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"min_dist2_cuda: CUDA tensors required, got "
                         f"{a.device}")
    lib, _ = cuda_build.load(KERNEL)
    B, N, D = a.shape
    M = b.shape[1]
    if D > lib.min_dist2_max_d():
        raise ValueError(f"min_dist2: D={D} > {lib.min_dist2_max_d()}")
    if B > 65535:
        raise ValueError(f"min_dist2: B={B} exceeds the grid's y limit")
    out = torch.empty((B, N), dtype=torch.float32, device=a.device)
    if B == 0 or N == 0:
        return out
    fn = lib.min_dist2_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, M, D,
                 stream)
    if err != 0:
        lib.min_dist2_error_string.restype = ctypes.c_char_p
        lib.min_dist2_error_string.argtypes = [ctypes.c_int]
        msg = lib.min_dist2_error_string(err).decode()
        raise RuntimeError(f"min_dist2 kernel launch failed: {msg} ({err})")
    cuda_build.count_launch(KERNEL)
    return out


def min_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """For each a-row the min squared distance to any b-row.

    a [N,D], b [M,D] -> [N], or a [B,N,D], b [B,M,D] -> [B,N]; float32.
    CPU tensors take the plain version, CUDA tensors the kernel."""
    flat = a.dim() == 2
    if flat:
        a, b = a[None], b[None]
    _check(a, b)
    if a.device.type == "cpu":
        out = min_dist2_plain(a, b)
    elif a.device.type == "cuda":
        out = min_dist2_cuda(a, b)
    else:
        raise ValueError(f"min_dist2: no kernel for device {a.device}")
    return out[0] if flat else out

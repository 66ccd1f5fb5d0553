"""Pairwise min squared distance: the CUDA kernel and its plain version.

Counterpart of ``rdpn6d_tpu/ops/pallas_kernels.py`` (``min_dist2_pallas``,
``min_dist2``, ``adi_distance``). For each row of a, the minimum over the
rows of b of |a - b|^2, batched over a leading axis: a [B,N,D], b [B,M,D]
-> [B,N] float32 (2-D inputs are the case B = 1 and give [N]).

``min_dist2`` picks by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch ``csrc/min_dist2.cu`` (built with nvcc at
first use) or raise. Both compute the direct form sum_d (a_d - b_d)^2 in
float32; the kernel's source note says why not the expanded
|a|^2 - 2 a.b + |b|^2 the TPU kernel uses. Both propagate NaN as
``jnp.min`` does: a NaN distance makes its row's result NaN.

``launch_plan`` sets the kernel's grid from the shapes and the card's SM
count; one ``min_dist2`` call runs one device kernel, or two where the plan
splits b's rows over blocks (the distance kernel, then a combine kernel),
and counts one launch either way.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import cuda_build

KERNEL = "min_dist2"
_PLAIN_BUDGET = 1 << 24   # elements of one [B, N, chunk] temporary

THREADS = 128            # a block's threads (kThreads in the source)
ROWS_PER_THREAD = 8      # a-rows a thread keeps in registers, D = 3 (kRows)
MIN_BLOCKS_PER_SM = 4    # below this many blocks an SM, the grid under-fills
MIN_SPLIT_ROWS = 64      # b-rows a split keeps at least
BALANCE_SLACK = 0.02     # evenness over the SMs worth fewer splits
GRID_LIMIT = 2**31 - 1   # blocks of a 1-D grid


@dataclass(frozen=True)
class LaunchPlan:
    """How the kernel covers a [B,N,D] x [B,M,D] problem: a 1-D grid of
    ``blocks`` blocks of ``threads`` threads. Block (batch, split, tile)
    owns a-rows ``a_rows(tile)`` of its batch item (thread t keeps rows
    tile*threads*rows_per_thread + r*threads + t, r < rows_per_thread, in
    registers) and b-rows ``b_range(split)``. With ``splits`` > 1 each split
    writes its minima to a [splits,B,N] scratch that a second kernel
    reduces."""

    B: int
    N: int
    M: int
    rows_per_thread: int
    threads: int
    splits: int
    split_rows: int      # b-rows of each split; the last one takes the rest

    @property
    def tiles(self) -> int:
        return -(-self.N // (self.threads * self.rows_per_thread))

    @property
    def blocks(self) -> int:
        return self.B * self.tiles * self.splits

    def block(self, i: int) -> tuple[int, int, int]:
        """(batch, split, tile) of block ``i``, as the kernel reads it."""
        return i // self.tiles // self.splits, \
            (i // self.tiles) % self.splits, i % self.tiles

    def a_rows(self, tile: int) -> np.ndarray:
        per = self.threads * self.rows_per_thread
        rows = tile * per + np.arange(per).reshape(
            self.rows_per_thread, self.threads)   # [r, t]
        return rows[rows < self.N]

    def b_range(self, split: int) -> tuple[int, int]:
        lo = split * self.split_rows
        return lo, min(self.M, lo + self.split_rows)


def _balance(blocks: int, sm_count: int) -> float:
    """Share of the card's issue slots equal blocks keep busy: the busiest
    SM holds ceil(blocks / sm_count) of them."""
    return blocks / (sm_count * -(-blocks // sm_count))


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, N: int, M: int, D: int, sm_count: int) -> LaunchPlan:
    """The grid for a [B,N,D] x [B,M,D] call on a card of ``sm_count`` SMs.

    D = 3 takes the register-tiled path: ``ROWS_PER_THREAD`` a-rows a
    thread, ``B * ceil(N / (THREADS * ROWS_PER_THREAD))`` blocks before any
    split. Where that is below ``MIN_BLOCKS_PER_SM`` blocks an SM (and b has
    rows for two splits of ``MIN_SPLIT_ROWS``), b's rows are split over
    blocks: between the fewest splits that fill the SMs and twice as many,
    the fewest whose equal blocks spread over the SMs within
    ``BALANCE_SLACK`` of the most even spread. Any other D takes the plain
    path: one a-row a thread, never split."""
    if D != 3:
        plan = LaunchPlan(B, N, M, 1, THREADS, 1, M)
    else:
        base = B * -(-N // (THREADS * ROWS_PER_THREAD))
        want = MIN_BLOCKS_PER_SM * sm_count
        most = max(1, M // MIN_SPLIT_ROWS)
        splits = 1
        if base < want and most > 1:
            least = min(-(-want // base), most)
            cands = range(least, min(2 * least, most) + 1)
            top = max(_balance(base * s, sm_count) for s in cands)
            splits = next(s for s in cands if _balance(base * s, sm_count)
                          >= top - BALANCE_SLACK)
        rows = -(-M // splits)
        plan = LaunchPlan(B, N, M, ROWS_PER_THREAD, THREADS, -(-M // rows),
                          rows)
    if plan.blocks > GRID_LIMIT:
        raise ValueError(f"min_dist2: {plan.blocks} blocks exceed the grid's "
                         f"limit of {GRID_LIMIT}")
    return plan


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
    return _launch(a, b)


def _launch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``min_dist2_cuda`` past its checks."""
    lib, _ = cuda_build.load(KERNEL)
    B, N, D = a.shape
    M = b.shape[1]
    if D > lib.min_dist2_max_d():
        raise ValueError(f"min_dist2: D={D} > {lib.min_dist2_max_d()}")
    out = torch.empty((B, N), dtype=torch.float32, device=a.device)
    if B == 0 or N == 0:
        return out
    index = a.device.index
    plan = launch_plan(B, N, M, D, cuda_build.sm_count(index))
    scratch = torch.empty((plan.splits, B, N), dtype=torch.float32,
                          device=a.device) if plan.splits > 1 else None
    fn = lib.min_dist2_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
    # the C entry point makes the device current itself, and the raw stream
    # handle skips building a torch.cuda.Stream: both cut the host's time a
    # call, which bounds a burst of the eval's small launches
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
             None if scratch is None else scratch.data_ptr(), B, N, M, D,
             plan.rows_per_thread, plan.threads, plan.splits, plan.split_rows,
             index, torch._C._cuda_getCurrentRawStream(index))
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
        out = _launch(a, b)
    else:
        raise ValueError(f"min_dist2: no kernel for device {a.device}")
    return out[0] if flat else out

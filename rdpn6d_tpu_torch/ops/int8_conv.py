"""The W8A8 convolution of int8 serving: activation quantization and the
int8 convolution, each a CUDA kernel with its plain version.

Counterpart of ``rdpn6d_tpu/models/quant.py`` (``quantize_symmetric`` and
the arithmetic of ``Int8Conv``): the JAX package runs the contraction as an
XLA int8 convolution with int32 accumulation; the port runs it in
``csrc/int8_conv.cu`` on Hopper's int8 tensor cores.

- ``quantize_act`` turns NCHW bfloat16/float32 activations into NHWC int8
  with the channels zero-padded to a multiple of ``CIN_ALIGN``, and returns
  the scale per sample [B] float32: the dynamic per-sample absmax, a
  static calibrated scalar, or, per channel, the static scalar of the
  SmoothQuant-balanced activation (x divided by t[c] * s).
- ``bn_relu_quantize`` does the same to relu(bn(y)), an eval BatchNorm
  folded into float32 (mean, mul, bias), with an optional skip appended on
  the channel axis: one pass where the head ran a BN, a ReLU, a concat and
  ``quantize_act`` (the JAX package's XLA fuses the static requantize into
  the BN and ReLU before it, ``rdpn6d_tpu/models/quant.py:47-55``). The BN
  is flax's ``_normalize`` as XLA computes it: fma(y - mean, mul, bias) in
  float32, one rounding, then the model's dtype.
- ``int8_conv`` convolves that with int8 weights [N, kh, kw, Cp] (scale per
  output channel) and returns NCHW in the model's dtype. On the card it is
  an implicit GEMM on ``wgmma``; ``int8_conv_plan`` picks its tile width,
  ring depth, shared memory and grid, which the launcher checks.

Both pick by the tensors' device: CPU tensors take the plain version, CUDA
tensors launch the kernel (built with nvcc at first use) or raise. Every
float op runs in float32 in the JAX package's order, so the kernel, the
plain version and the JAX package agree bit for bit, NaN included: a NaN
in a sample makes its dynamic scale NaN, and a NaN quantizes to 0, as XLA
converts it. The plain convolution is exact: it runs in float64 on the
int8 values (the int32 sum reaches ~4.6e7, past float32's 2^24 but far
below float64's 2^53).
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import cuda_build

LIBRARY = "int8_conv"          # csrc/int8_conv.cu holds the entry points
CONV = "int8_conv"             # the names their launches are counted under
QUANTIZE = "quantize_act"
BN_RELU_QUANTIZE = "bn_relu_quantize"
CIN_ALIGN = 32                 # kCinAlign in the source: one k-tile
MODES = {"dynamic": 0, "static": 1, "per_channel": 2}
_OUT_DTYPES = (torch.bfloat16, torch.float32)

# the conv kernel's launch (constants of csrc/int8_conv.cu)
TILE_M = 128                   # kBM: output pixels a block, 2 warpgroups
SLAB_BYTES = 128               # kBK: bytes of K a ring stage holds
# the ring's stages for each tile width the source instantiates
# (INT8_CONV_PLANS): as deep as shared memory allows, 128 wide with two
# blocks an SM
STAGES = {256: 4, 128: 3, 64: 4}
SMEM_LIMIT = 232_448           # dynamic shared memory a block may have
GRID_X_LIMIT = 2**31 - 1
GRID_Y_LIMIT = 65_535
H100_SMS = 132


@dataclass(frozen=True)
class ConvPlan:
    """How the kernel covers an M x N output (M = B Ho Wo pixels, N output
    channels): blocks of ``TILE_M`` x ``bn`` on a ``grid`` of
    (ceil(M / TILE_M), ceil(N / bn)), K through a ring of ``stages`` slabs
    of ``SLAB_BYTES`` in ``smem_bytes`` of dynamic shared memory."""

    bn: int
    stages: int
    smem_bytes: int
    grid: tuple[int, int]


@functools.lru_cache(maxsize=1024)
def int8_conv_plan(B: int, Ho: int, Wo: int, N: int, K: int,
                   sm_count: int = H100_SMS,
                   bn: int | None = None) -> ConvPlan:
    """The launch plan of ``int8_conv`` for B x Ho x Wo output pixels, N
    output channels and K = kh kw Cp bytes of reduction, on a card of
    ``sm_count`` SMs. The tile width is the narrowest of 64, 128 and 256
    that holds N (256 past it), halved while the grid would leave SMs
    without a block, so each im2col row is gathered once where N <= 256
    and the card fills where M is small. ``bn`` forces another
    implemented width (for timing and tests)."""
    if min(B, Ho, Wo, N) < 1 or K < 1 or K % CIN_ALIGN:
        raise ValueError(f"int8_conv_plan: no plan for B={B} Ho={Ho} "
                         f"Wo={Wo} N={N} K={K}")
    m_tiles = -(-(B * Ho * Wo) // TILE_M)
    if bn is None:
        bn = next((w for w in (64, 128) if N <= w), 256)
        while bn > 64 and m_tiles * -(-N // bn) < sm_count:
            bn //= 2
    if bn not in STAGES:
        raise ValueError(f"int8_conv_plan: no {bn}-wide tile (one of "
                         f"{sorted(STAGES)})")
    stages = STAGES[bn]
    plan = ConvPlan(bn, stages, stages * (TILE_M + bn) * SLAB_BYTES,
                    (m_tiles, -(-N // bn)))
    if plan.grid[0] > GRID_X_LIMIT or plan.grid[1] > GRID_Y_LIMIT:
        raise ValueError(f"int8_conv_plan: grid {plan.grid} exceeds the "
                         f"card's limits")
    return plan


def padded_channels(c: int) -> int:
    return -(-c // CIN_ALIGN) * CIN_ALIGN


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127, divided in float32. The divisor is a tensor
    on amax's device: CUDA's division by a Python scalar multiplies by its
    reciprocal, which rounds differently."""
    return amax.clamp_min(1e-12) / torch.full((), 127.0,
                                              device=amax.device)


def _to_int8(v: torch.Tensor) -> torch.Tensor:
    """round(v) clipped to ±127 as int8, NaN to 0 (XLA's conversion; a
    cast of NaN is left undefined by PyTorch)."""
    return torch.clamp(torch.round(v), -127, 127).nan_to_num(0.0).to(
        torch.int8)


def quantize_symmetric(x: torch.Tensor, dim=None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization: (q int8, scale float32) with x ~= q *
    scale. ``dim``: the dims reduced for the scale (None: per tensor),
    kept as size 1."""
    xf = x.float()
    amax = xf.abs().amax() if dim is None else xf.abs().amax(dim=dim,
                                                             keepdim=True)
    scale = _scale_of(amax)
    return _to_int8(xf / scale), scale


def pack_weight(wq: torch.Tensor) -> torch.Tensor:
    """int8 OIHW -> the kernel's [N, kh, kw, Cp], channels zero-padded."""
    n, c, kh, kw = wq.shape
    out = torch.zeros(n, kh, kw, padded_channels(c), dtype=torch.int8,
                      device=wq.device)
    out[..., :c] = wq.permute(0, 2, 3, 1)
    return out


def _act_scale(x: torch.Tensor, mode: str,
               amax: torch.Tensor | None) -> torch.Tensor:
    """s [B] float32: max(amax, 1e-12) / 127 with amax per sample (dynamic)
    or the given scalar."""
    if mode == "dynamic":
        a = x.float().abs().amax(dim=(1, 2, 3))
    else:
        a = amax.float().reshape(()).expand(x.shape[0])
    return _scale_of(a)


def quantize_act_plain(x: torch.Tensor, mode: str,
                       amax: torch.Tensor | None = None,
                       t: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``quantize_act`` (same arguments)."""
    B, C, H, W = x.shape
    s = _act_scale(x, mode, amax)
    d = s[:, None, None, None]
    if mode == "per_channel":
        d = t.float()[None, :, None, None] * d   # t * s first (quant.py:127)
    q = _to_int8(x.float() / d)
    xq = torch.zeros(B, H, W, padded_channels(C), dtype=torch.int8,
                     device=x.device)
    xq[..., :C] = q.permute(0, 2, 3, 1)
    return xq, s


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """a * b + c of float32 tensors, rounded once to float32 (CUDA's
    ``__fmaf_rn``). The float64 product is exact; the float64 sum is made
    round-to-odd from its TwoSum error, so its rounding to float32 is the
    exact value's (53 >= 24 + 2 bits); a plain float64 sum then a cast
    would round twice."""
    p = a.double() * b.double()
    cc = c.double()
    s = p + cc
    bb = s - p
    err = (p - (s - bb)) + (cc - bb)
    inexact = (err != 0) & s.isfinite()
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s)
    return torch.where(inexact & even, torch.nextafter(s, toward), s).float()


def bn_relu_plain(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                  bias: torch.Tensor, skip: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """relu(fma(y - mean, mul, bias)) in y's dtype, with ``skip`` (in y's
    dtype) appended on the channel axis: what ``bn_relu_quantize``
    quantizes, in its order. The ReLU keeps NaN, as ``jnp.maximum``."""
    d = y.float() - mean.float()[:, None, None]
    z = fma_f32(d, mul.float()[:, None, None],
                bias.float()[:, None, None]).to(y.dtype)
    z = torch.where(z.isnan(), z, z.clamp_min(0))
    return z if skip is None else torch.cat([z, skip.to(y.dtype)], dim=1)


def bn_relu_quantize_plain(y: torch.Tensor, mean: torch.Tensor,
                           mul: torch.Tensor, bias: torch.Tensor, mode: str,
                           amax: torch.Tensor | None = None,
                           t: torch.Tensor | None = None,
                           skip: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``bn_relu_quantize`` (same arguments)."""
    return quantize_act_plain(bn_relu_plain(y, mean, mul, bias, skip), mode,
                              amax, t)


def _check_act(x, mode, amax, t, name="quantize_act", channels=None) -> None:
    """``channels``: those t covers (default x's)."""
    if mode not in MODES:
        raise ValueError(f"{name}: mode {mode!r} not in {list(MODES)}")
    if x.dim() != 4 or x.dtype not in _OUT_DTYPES:
        raise ValueError(f"{name}: expected NCHW bfloat16/float32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if mode != "dynamic" and (amax is None or amax.numel() != 1
                              or amax.device != x.device):
        raise ValueError(f"{name}: mode {mode!r} needs a scalar amax "
                         f"on {x.device}")
    channels = x.shape[1] if channels is None else channels
    if mode == "per_channel" and (t is None or t.shape != (channels,)
                                  or t.device != x.device):
        raise ValueError(f"{name}: per_channel needs t of shape "
                         f"({channels},) on {x.device}")


def _check_bn(y, mean, mul, bias, skip) -> None:
    c1 = y.shape[1] if y.dim() == 4 else -1
    for v in (mean, mul, bias):
        if v.shape != (c1,) or v.dtype != torch.float32 \
                or v.device != y.device:
            raise ValueError(f"bn_relu_quantize: expected float32 mean, mul "
                             f"and bias of shape ({c1},) on {y.device}; got "
                             f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if skip is not None and (
            skip.dim() != 4 or skip.dtype not in _OUT_DTYPES
            or skip.device != y.device or skip.shape[0] != y.shape[0]
            or skip.shape[2:] != y.shape[2:]):
        raise ValueError(f"bn_relu_quantize: skip {skip.dtype} "
                         f"{tuple(skip.shape)} on {skip.device} does not "
                         f"match y {tuple(y.shape)} on {y.device}")


def _launch_quantizer(name: str, argtypes: list, y: torch.Tensor,
                      channels: int, mode: str, amax, t, args):
    """Allocate xq [B,H,W,Cp], sx [B] (and the dynamic mode's scratch) for
    a quantizer of ``channels`` channels and call the library function
    ``name`` (ctypes ``argtypes``) with ``args(xq, sx, scratch, amax,
    t)``; ``y`` sets B, H, W and the device. Returns (xq, sx, the error
    code, the library)."""
    B, _, H, W = y.shape
    dev = y.device
    xq = torch.empty(B, H, W, padded_channels(channels), dtype=torch.int8,
                     device=dev)
    sx = torch.empty(B, dtype=torch.float32, device=dev)
    scratch = torch.zeros(B, dtype=torch.int32, device=dev) \
        if mode == "dynamic" else None
    a = None if amax is None else amax.float().reshape(1).contiguous()
    tt = None if mode != "per_channel" else t.float().contiguous()
    lib, _ = cuda_build.load(LIBRARY)
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
    return xq, sx, fn(*args(xq, sx, scratch, a, tt)), lib


def _ptr(v):
    return None if v is None else v.data_ptr()


def _quantize_act_launch(x: torch.Tensor, mode: str,
                         amax: torch.Tensor | None,
                         t: torch.Tensor | None
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the quantize kernel (after the absmax kernel in the dynamic
    mode) on the current stream, arguments checked by ``quantize_act``;
    one counted launch."""
    x = x.contiguous()
    B, C, H, W = x.shape
    dev = x.device

    def tail(xq, sx, scratch, a, tt):
        return [_ptr(x), int(x.dtype == torch.bfloat16), MODES[mode],
                _ptr(a), _ptr(tt), _ptr(scratch), _ptr(xq), _ptr(sx), B, C,
                H, W, xq.shape[3], dev.index,
                torch._C._cuda_getCurrentRawStream(dev.index)]

    P, I = ctypes.c_void_p, ctypes.c_int
    xq, sx, err, lib = _launch_quantizer(
        "int8_quantize_launch", [P, I, I] + [P] * 5 + [I] * 6 + [P], x, C,
        mode, amax, t, tail)
    _raise_on(lib, err, QUANTIZE)
    cuda_build.count_launch(QUANTIZE)
    return xq, sx


def quantize_act(x: torch.Tensor, mode: str,
                 amax: torch.Tensor | None = None,
                 t: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,C,H,W] bfloat16/float32 -> (xq [B,H,W,Cp] int8, sx [B] float32)
    with x ~= xq * sx (per channel: xq * t[c] * sx).

    ``mode``: "dynamic" (sx the sample's absmax / 127), "static" (``amax``
    the calibrated scalar absmax) or "per_channel" (``amax`` the scalar
    max_c(act_amax_c / t_c) of the smoothed activation, ``t`` [C] the
    SmoothQuant factors). CPU tensors take the plain version, CUDA tensors
    the kernel."""
    _check_act(x, mode, amax, t)
    if x.device.type == "cpu":
        return quantize_act_plain(x, mode, amax, t)
    if x.device.type == "cuda":
        return _quantize_act_launch(x, mode, amax, t)
    raise ValueError(f"quantize_act: no kernel for device {x.device}")


def _bn_relu_quantize_launch(y, mean, mul, bias, mode, amax, t, skip
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the fused quantize kernel (after the absmax kernel in the
    dynamic mode) on the current stream, arguments checked by
    ``bn_relu_quantize``; one counted launch."""
    y = y.contiguous()
    if skip is not None:
        skip = skip.to(y.dtype).contiguous()
    B, C1, H, W = y.shape
    C2 = 0 if skip is None else skip.shape[1]
    dev = y.device
    consts = [v.contiguous() for v in (mean, mul, bias)]

    def tail(xq, sx, scratch, a, tt):
        return [_ptr(y), _ptr(skip), *map(_ptr, consts),
                int(y.dtype == torch.bfloat16), MODES[mode], _ptr(a),
                _ptr(tt), _ptr(scratch), _ptr(xq), _ptr(sx), B, C1, C2, H, W,
                xq.shape[3], dev.index,
                torch._C._cuda_getCurrentRawStream(dev.index)]

    P, I = ctypes.c_void_p, ctypes.c_int
    xq, sx, err, lib = _launch_quantizer(
        "int8_bn_relu_quantize_launch", [P] * 5 + [I, I] + [P] * 5 + [I] * 7
        + [P], y, C1 + C2, mode, amax, t, tail)
    _raise_on(lib, err, BN_RELU_QUANTIZE)
    cuda_build.count_launch(BN_RELU_QUANTIZE)
    return xq, sx


def bn_relu_quantize(y: torch.Tensor, mean: torch.Tensor, mul: torch.Tensor,
                     bias: torch.Tensor, mode: str,
                     amax: torch.Tensor | None = None,
                     t: torch.Tensor | None = None,
                     skip: torch.Tensor | None = None
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_act`` of relu(fma(y - mean, mul, bias)), rounded to y's
    dtype, with ``skip`` [B,C2,H,W] (cast to y's dtype, no BN or ReLU)
    appended on the channel axis: y [B,C1,H,W] bfloat16/float32, mean, mul,
    bias [C1] float32 (``BatchNorm2d.folded``); ``mode``, ``amax`` and
    ``t`` [C1 + C2] as ``quantize_act``'s. Returns (xq [B,H,W,Cp] int8,
    sx [B] float32). CPU tensors take the plain version, CUDA tensors the
    kernel."""
    _check_act(y, mode, amax, t, BN_RELU_QUANTIZE,
               y.shape[1] + (0 if skip is None else skip.shape[1])
               if y.dim() == 4 else None)
    _check_bn(y, mean, mul, bias, skip)
    if y.device.type == "cpu":
        return bn_relu_quantize_plain(y, mean, mul, bias, mode, amax, t, skip)
    if y.device.type == "cuda":
        return _bn_relu_quantize_launch(y, mean, mul, bias, mode, amax, t,
                                        skip)
    raise ValueError(f"bn_relu_quantize: no kernel for device {y.device}")


def conv_out_size(size: int, k: int, stride: int, padding: int) -> int:
    return (size + 2 * padding - k) // stride + 1


def int8_conv_plain(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                    sw: torch.Tensor, stride: int, padding: int,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The plain PyTorch version of ``int8_conv`` (same arguments): the
    int32 sum exactly, as a float64 convolution of the int8 values
    (rounded, so that no algorithm's rounding of an exact integer can
    truncate it)."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   wq.permute(0, 3, 1, 2).double(), None, stride,
                   padding).round().to(torch.int32)
    scale = sx.float()[:, None, None, None] * sw.float()[None, :, None, None]
    return (acc.float() * scale).to(out_dtype)


def _check_conv(xq, sx, wq, sw, stride, padding, out_dtype) -> None:
    if xq.dtype != torch.int8 or wq.dtype != torch.int8 or xq.dim() != 4 \
            or wq.dim() != 4 or xq.shape[3] != wq.shape[3] \
            or xq.shape[3] % CIN_ALIGN:
        raise ValueError(f"int8_conv: expected xq [B,H,W,Cp] and wq "
                         f"[N,kh,kw,Cp] int8 with Cp a multiple of "
                         f"{CIN_ALIGN}; got {xq.dtype} {tuple(xq.shape)} and "
                         f"{wq.dtype} {tuple(wq.shape)}")
    if sx.shape != (xq.shape[0],) or sw.shape != (wq.shape[0],) \
            or sx.dtype != torch.float32 or sw.dtype != torch.float32:
        raise ValueError(f"int8_conv: expected float32 sx [B] and sw [N]; "
                         f"got {tuple(sx.shape)} and {tuple(sw.shape)}")
    if len({xq.device, sx.device, wq.device, sw.device}) != 1:
        raise ValueError("int8_conv: inputs on different devices")
    if out_dtype not in _OUT_DTYPES:
        raise ValueError(f"int8_conv: out_dtype {out_dtype} not in "
                         f"{_OUT_DTYPES}")
    if stride < 1 or padding < 0 or min(
            conv_out_size(xq.shape[1], wq.shape[1], stride, padding),
            conv_out_size(xq.shape[2], wq.shape[2], stride, padding)) < 1:
        raise ValueError(f"int8_conv: stride {stride} padding {padding} "
                         f"leave no output for {tuple(xq.shape)}")


def _int8_conv_launch(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
                      sw: torch.Tensor, stride: int, padding: int,
                      out_dtype: torch.dtype,
                      plan: ConvPlan | None = None) -> torch.Tensor:
    """Launch the convolution kernel on the current stream by ``plan``
    (default: ``int8_conv_plan``'s; tests and ``time_int8.py`` force the
    other widths), arguments checked by ``int8_conv``; one counted
    launch."""
    xq, wq = xq.contiguous(), wq.contiguous()
    sx, sw = sx.contiguous(), sw.contiguous()
    B, H, W, Cp = xq.shape
    N, kh, kw, _ = wq.shape
    Ho = conv_out_size(H, kh, stride, padding)
    Wo = conv_out_size(W, kw, stride, padding)
    dev = xq.device
    out = torch.empty(B, N, Ho, Wo, dtype=out_dtype, device=dev)
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_conv: xq and wq must be 16-byte aligned")
    if plan is None:
        plan = int8_conv_plan(B, Ho, Wo, N, kh * kw * Cp,
                              cuda_build.sm_count(dev.index))
    lib, _ = cuda_build.load(LIBRARY)
    fn = lib.int8_conv_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 13 \
            + [ctypes.c_void_p] + [ctypes.c_int] * 5
    err = fn(xq.data_ptr(), sx.data_ptr(), wq.data_ptr(), sw.data_ptr(),
             out.data_ptr(), int(out_dtype == torch.bfloat16), B, H, W, Cp,
             N, kh, kw, stride, padding, Ho, Wo, dev.index,
             torch._C._cuda_getCurrentRawStream(dev.index), plan.bn,
             plan.stages, plan.smem_bytes, *plan.grid)
    _raise_on(lib, err, CONV)
    cuda_build.count_launch(CONV)
    return out


def int8_conv(xq: torch.Tensor, sx: torch.Tensor, wq: torch.Tensor,
              sw: torch.Tensor, stride: int, padding: int,
              out_dtype: torch.dtype) -> torch.Tensor:
    """xq [B,H,W,Cp] int8 (scale sx [B]) ⊛ wq [N,kh,kw,Cp] int8 (scale sw
    [N]), zero padding ``padding`` on each side -> [B,N,Ho,Wo] in
    ``out_dtype``: float(acc) * (sx[b] * sw[n]). CPU tensors take the plain
    version, CUDA tensors the kernel."""
    _check_conv(xq, sx, wq, sw, stride, padding, out_dtype)
    if xq.device.type == "cpu":
        return int8_conv_plain(xq, sx, wq, sw, stride, padding, out_dtype)
    if xq.device.type == "cuda":
        return _int8_conv_launch(xq, sx, wq, sw, stride, padding, out_dtype)
    raise ValueError(f"int8_conv: no kernel for device {xq.device}")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        lib.int8_conv_error_string.restype = ctypes.c_char_p
        lib.int8_conv_error_string.argtypes = [ctypes.c_int]
        msg = lib.int8_conv_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} ({err})")

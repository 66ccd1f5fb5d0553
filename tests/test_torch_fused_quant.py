"""The fused BN + ReLU (+ concat) + quantize of the int8 head on the CPU:
``ops/int8_conv.bn_relu_quantize_plain`` against the JAX package's BN ->
relu -> concatenate -> quantize, its round-once FMA against exact
rational arithmetic, and the CUDA kernel's tile (``csrc/int8_conv.cu``
``quantize_kernel``: the ring's swizzled layout, the thread map and the
out tile) emulated in numpy.

Tolerances: xq and sx bit-equal to JAX's (tolerance 0; JAX's BN, relu
and concatenate jitted, its quantizer op by op), given JAX's
folded multiplier rsqrt(var + eps) * scale (XLA's CPU rsqrt is not
correctly rounded; the port rounds its own once from float64): XLA
computes the BN as fma(y - mean, mul, bias), one rounding, and so does
the plain version. The FMA: equal to the correctly rounded value of the
exact a * b + c. The emulation: bit-equal to the plain version, and no
two lanes of a warp on one shared-memory bank with different words.
"""

import os
import re
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from rdpn6d_tpu.models.quant import quantize_symmetric as j_qsym
from rdpn6d_tpu_torch.models.norm import BatchNorm2d
from rdpn6d_tpu_torch.ops import int8_conv as ic
from rdpn6d_tpu_torch.ops.int8_conv import (
    bn_relu_quantize,
    bn_relu_quantize_plain,
    fma_f32,
)

MODES = ["dynamic", "static", "per_channel"]
SRC = os.path.join(os.path.dirname(ic.__file__), os.pardir, "csrc",
                   "int8_conv.cu")


# ------------------------------------------------------------ against JAX

def _jax_fused(dtype, mode):
    """JAX's BN -> relu -> concatenate -> quantize as the head and
    ``Int8Conv`` run it (heads.py:70-84, quant.py:127, :140 and :32): the
    BN, relu and concatenate jitted, the quantizer op by op as
    ``Int8Conv``'s code reads. Under jit XLA rewrites the scale's
    ``/ 127.0`` into a product by the rounded 1 / 127, 1 ulp off at some
    absmaxes; the port divides, as the code does. Also returns the folded
    multiplier XLA computes."""
    bn = fnn.BatchNorm(use_running_average=True, momentum=0.9, dtype=dtype,
                       param_dtype=jnp.float32)

    @jax.jit
    def bn_relu_cat(v, y, skip):
        x = jax.nn.relu(bn.apply(v, y))
        if skip is not None:
            x = jnp.concatenate([x, skip.astype(x.dtype)], axis=-1)
        return x

    def fused(v, y, skip, amax, t):
        x = bn_relu_cat(v, y, skip)
        if mode == "dynamic":
            xq, sx = j_qsym(x, axis=(1, 2, 3))
            return xq, sx.reshape(-1)
        s = jnp.maximum(amax, 1e-12) / 127.0
        d = t * s if mode == "per_channel" else s
        xq = jnp.clip(jnp.round(x.astype(jnp.float32) / d), -127,
                      127).astype(jnp.int8)
        return xq, jnp.full((x.shape[0],), s)

    @jax.jit
    def mul(v):
        return jax.lax.rsqrt(v["batch_stats"]["var"] + bn.epsilon) \
            * v["params"]["scale"]

    return fused, mul


def _case(C1, C2, seed, nan=False):
    rng = np.random.RandomState(seed)
    v = {"params": {"scale": (rng.randn(C1) * 1.3).astype(np.float32),
                    "bias": (rng.randn(C1) * 0.5).astype(np.float32)},
         "batch_stats": {"mean": (rng.randn(C1) * 0.6).astype(np.float32),
                         "var": (rng.rand(C1) * 2 + 0.02).astype(
                             np.float32)}}
    y = (rng.randn(2, 7, 9, C1) * rng.uniform(0.3, 3, C1)
         + rng.randn(C1)).astype(np.float32)
    skip = None if not C2 else np.maximum(
        rng.randn(2, 7, 9, C2) * rng.uniform(0.1, 2, C2), 0).astype(
        np.float32)
    if nan:
        y[0, 3, 4, 1] = np.nan
        if skip is not None:
            skip[1, 2, 5, 0] = -np.nan
    return v, y, skip


def _port_bn(v, mul):
    bn = BatchNorm2d(len(mul))
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(v["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(v["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(v["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(v["batch_stats"]["var"]))
    mean, own_mul, bias = bn.eval().folded()
    return mean, torch.from_numpy(np.asarray(mul)), bias, own_mul


def _nchw(x, dtype):
    return None if x is None else torch.from_numpy(
        np.ascontiguousarray(x.transpose(0, 3, 1, 2))).to(dtype)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C1,C2,nan", [(40, 0, False), (40, 24, False),
                                       (33, 8, True), (16, 0, True)])
def test_plain_matches_jax(mode, dtype, C1, C2, nan):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    v, y, skip = _case(C1, C2, C1 * 7 + C2 + nan, nan)
    # the model's activations are in its dtype on both sides
    y = np.asarray(jnp.asarray(y, jdt).astype(jnp.float32))
    rng = np.random.RandomState(C1 + C2)
    t = (rng.rand(C1 + C2) + 0.3).astype(np.float32)
    amax = np.float32(2.5)
    fused, jmul = _jax_fused(jdt, mode)
    mul = np.asarray(jmul(v))
    xq_j, sx_j = fused(v, jnp.asarray(y, jdt),
                       None if skip is None else jnp.asarray(skip, jdt),
                       amax, t)
    mean, mul_t, bias, own_mul = _port_bn(v, mul)
    xq, sx = bn_relu_quantize_plain(
        _nchw(y, tdt), mean, mul_t, bias, mode, torch.tensor(amax),
        torch.from_numpy(t) if mode == "per_channel" else None,
        _nchw(skip, tdt))
    C = C1 + C2
    assert xq.shape == (2, 7, 9, ic.padded_channels(C))
    np.testing.assert_array_equal(xq[..., :C].numpy(), np.asarray(xq_j))
    assert not xq[..., C:].any()
    np.testing.assert_array_equal(sx.numpy(), np.asarray(sx_j))
    # the entry point takes the plain version on the CPU
    got = bn_relu_quantize(
        _nchw(y, tdt), mean, mul_t, bias, mode, torch.tensor(amax),
        torch.from_numpy(t) if mode == "per_channel" else None,
        _nchw(skip, tdt))
    assert torch.equal(got[0], xq) and torch.equal(got[1].nan_to_num(7.0),
                                                   sx.nan_to_num(7.0))
    # the port's own multiplier is correctly rounded: at most an
    # ulp from XLA's, where it differs
    ulp = np.abs(own_mul.numpy().view(np.int32) - mul.view(np.int32))
    assert ulp.max() <= 1
    if nan:
        assert int(xq[0, 3, 4, 1]) == 0
        assert bool(sx[0].isnan()) == (mode == "dynamic")


def test_refusals():
    y = torch.randn(1, 4, 3, 3)
    ok = (torch.zeros(4), torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="mean, mul"):
        bn_relu_quantize(y, torch.zeros(3), *ok[1:], "dynamic")
    with pytest.raises(ValueError, match="skip"):
        bn_relu_quantize(y, *ok, "dynamic", skip=torch.randn(1, 2, 4, 3))
    with pytest.raises(ValueError, match="per_channel needs t of shape"):
        bn_relu_quantize(y, *ok, "per_channel", torch.tensor(1.0),
                         torch.ones(4), skip=torch.randn(1, 2, 3, 3))
    with pytest.raises(ValueError, match="scalar amax"):
        bn_relu_quantize(y, *ok, "static")


# ------------------------------------------------------------ the FMA

def _round_f32(x: Fraction) -> np.float32:
    """The float32 nearest the exact x, ties to even."""
    f = np.float32(float(x))           # within an ulp of the answer
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(err)
    picks = [c for c, e in zip(cands, err) if e == best]
    if len(picks) > 1:
        picks = [c for c in picks if int(np.array(c).view(np.int32)) % 2 == 0]
    return picks[0]


def test_fma_rounds_once():
    """A seeded sample over 20 binades and signs, with exact cancellations,
    plus a case built so that the float64 sum lands on a float32 midpoint:
    a = 2^-12 + 2^-30, b = 2^-12 - 2^-30, c = 1 + 2^-23 (a b + c is just
    below the midpoint c + 2^-24; the sum rounded to float64 then to
    float32 gives the even neighbour above, the wrong one)."""
    rng = np.random.RandomState(0)
    n = 4000
    a = (rng.randn(n) * 2.0 ** rng.randint(-10, 10, n)).astype(np.float32)
    b = (rng.randn(n) * 2.0 ** rng.randint(-10, 10, n)).astype(np.float32)
    c = (rng.randn(n) * 2.0 ** rng.randint(-10, 10, n)).astype(np.float32)
    c[:200] = -(a[:200].astype(np.float64) * b[:200]).astype(np.float32)
    hard = np.array([[2.0 ** -12 + 2.0 ** -30, 2.0 ** -12 - 2.0 ** -30,
                      1 + 2.0 ** -23]], np.float32).T
    a, b, c = (np.concatenate([v, h]) for v, h in zip((a, b, c), hard))
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(x)) * Fraction(float(y))
                                + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert naive[-1] != want[-1] and got[-1] == np.float32(1 + 2.0 ** -23)


# ------------------------------------------------ the kernel's tile, in numpy

def _consts():
    with open(SRC) as f:
        text = f.read()
    env = {}
    for name in ("kQPix", "kQCh", "kQStages", "kQThreads", "kQPad",
                 "kQSwzShift", "kQSwzMask", "kCinAlign"):
        m = re.search(rf"constexpr int {name} = (\d+);", text)
        assert m, f"{name} not found in {SRC}"
        env[name] = int(m.group(1))
    # the thread map and the swizzle emulated below, as the source has them
    assert "q = lane & 7, pp = (tid >> 5) * 4 + (lane >> 3);" in text
    assert "return j ^ ((ch >> kQSwzShift) & kQSwzMask);" in text
    assert "uint8_t* o = otile + px * opitch + st * kQCh + 4 * q;" in text
    return env


def _bank_conflicts(addrs: np.ndarray, width: int) -> int:
    """The extra shared-memory wavefronts of one warp access (32 byte
    addresses, ``width`` bytes each): 4-byte accesses in one pass, 8-byte
    ones a half-warp at a time; a bank serving two different words is a
    conflict."""
    extra = 0
    groups = [addrs] if width == 4 else [addrs[:16], addrs[16:]]
    for g in groups:
        words = {w for a in g for w in range(a // 4, (a + width) // 4)}
        banks = {}
        for w in words:
            banks.setdefault(w % 32, set()).add(w)
        extra += max(len(v) for v in banks.values()) - 1
    return extra


def _emulate(y, skip, xq_plain, elem, vec):
    """The kernel's data movement for every block: the stages through the
    ring (cp.async chunks, or scalar loads, at the swizzled offsets), each
    thread's pair reads, the out tile's words and the 16-byte stores.
    Element values are carried as their (channel, pixel) ids and the int8
    value taken from the plain version's xq at that id, so a misplaced
    byte shows. Returns (xq, bank conflicts of the reads, of the
    writes)."""
    k = _consts()
    pix, nch, thr = k["kQPix"], k["kQCh"], k["kQThreads"]
    B, C1, P = y.shape
    C2 = 0 if skip is None else skip.shape[1]
    C = C1 + C2
    Cp = xq_plain.shape[-1]
    kv = 16 // elem
    row_bytes = pix * elem

    def swz(j, ch):
        return j ^ ((ch >> k["kQSwzShift"]) & k["kQSwzMask"])

    out = np.zeros_like(xq_plain)
    opitch = Cp + k["kQPad"]
    conflicts = [0, 0]
    for b in range(B):
        for p0 in range(0, P, pix):
            npx = min(pix, P - p0)
            otile = np.zeros(pix * opitch, np.int16) - 1   # -1: unwritten
            for st in range(Cp // nch):
                # the ring buffer as element slots: (channel, pixel) ids
                ring = np.full((nch * row_bytes // elem, 2), -1)
                for ch in range(nch):
                    c = st * nch + ch
                    for px in range(pix):
                        ok = c < C and px < npx
                        if vec:   # a chunk copies or zero-fills as a whole
                            ok = c < C and (px // kv) * kv < npx
                        slot = (ch * row_bytes + swz(px // kv, ch) * 16
                                + (px % kv) * elem) // elem
                        assert ring[slot, 0] == -1
                        ring[slot] = (c, p0 + px) if ok else (-2, -2)
                reads, writes = [], []
                for tid in range(thr):
                    lane, warp = tid & 31, tid >> 5
                    q, pp = lane & 7, warp * 4 + (lane >> 3)
                    px = 2 * pp
                    words = [0, 0]
                    for i in range(4):
                        ch = 4 * q + i
                        c = st * nch + ch
                        addr = ch * row_bytes + swz(px // kv, ch) * 16 \
                            + (px % kv) * elem
                        reads.append((warp, i, addr))
                        if c >= C:
                            continue
                        for e in range(2):
                            got = tuple(ring[addr // elem + e])
                            if p0 + px + e < P:
                                assert got == (c, p0 + px + e), (got, c)
                                v = int(xq_plain[b, p0 + px + e, c]) & 0xFF
                                words[e] |= v << (8 * i)
                    for e in range(2):
                        off = (px + e) * opitch + st * nch + 4 * q
                        writes.append((warp, e, off))
                        for n in range(4):
                            otile[off + n] = (words[e] >> (8 * n)) & 0xFF
                ring_bytes = k["kQStages"] * nch * row_bytes
                for sel, acc, width, base in ((0, reads, 2 * elem, 0),
                                              (1, writes, 4, ring_bytes)):
                    by = {}
                    for warp, i, a in acc:
                        by.setdefault((warp, i), []).append(base + a)
                    conflicts[sel] += sum(
                        _bank_conflicts(np.array(v), width)
                        for v in by.values())
            tile = otile.reshape(pix, opitch)[:npx, :Cp]
            assert (tile >= 0).all()
            out[b, p0:p0 + npx] = tile.astype(np.uint8).view(np.int8)
    return out, conflicts[0], conflicts[1]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C1,C2,H,W,vec", [
    (40, 24, 8, 16, True),      # a partial channel stage; 2 pixel tiles
    (33, 0, 5, 24, True),       # 120 pixels: the last tile partial
    (20, 9, 3, 7, False),       # 21 pixels: scalar loads
    (64, 32, 2, 32, True)])     # the head's shape, cut
def test_kernel_tile_emulation_matches_plain(dtype, C1, C2, H, W, vec):
    """The emulated kernel gives the plain version's xq bit for bit at
    ragged channel counts, partial pixel tiles and both load paths, and
    its shared-memory reads and word stores are free of bank conflicts."""
    elem = 2 if dtype == torch.bfloat16 else 4
    assert vec == ((H * W) % (16 // elem) == 0)
    g = torch.Generator().manual_seed(C1 + H)
    y = (torch.randn(2, C1, H, W, generator=g) * 2).to(dtype)
    skip = None if not C2 else torch.randn(2, C2, H, W, generator=g).to(
        dtype)
    mean, bias = torch.randn(C1, generator=g), torch.randn(C1, generator=g)
    mul = torch.rand(C1, generator=g) + 0.5
    xq, _ = bn_relu_quantize_plain(y, mean, mul, bias, "dynamic", skip=skip)
    got, read_conflicts, write_conflicts = _emulate(
        y.reshape(2, C1, H * W), None if skip is None
        else skip.reshape(2, C2, H * W), xq.reshape(2, H * W, -1).numpy(),
        elem, vec)
    np.testing.assert_array_equal(got, xq.reshape(2, H * W, -1).numpy())
    assert read_conflicts == 0 and write_conflicts == 0

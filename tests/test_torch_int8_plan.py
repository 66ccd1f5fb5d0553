"""The int8 convolution kernel's launch plan and its shared-memory layout,
on the CPU.

``csrc/int8_conv.cu`` cannot run here, so what surrounds its ``wgmma``
instructions is emulated in numpy with the constants, the loader's shared
offset and the descriptor's fields read from the source: the ring of K
slabs filled by ``cp.async`` chunks (landing as late as the kernel's
``cp.async.wait_group`` allows, read as late as its ``wgmma.wait_group``
and barriers allow), the descriptor reads of wgmma's canonical K-major
layouts (PTX ISA, "Matrix Descriptor Format" and "Shared Memory Matrix
Layout": without swizzle, core matrices of 8 rows x 16 bytes, LBO the step
between core matrices along K and SBO between 8-row groups along M or N;
with a 32-, 64- or 128-byte swizzle, rows of that many bytes whose 16-byte
chunks are permuted by the row, SBO between 8-row groups), the accumulator
fragment of ``wgmma.m64nNk32.s32``, and the staged epilogue. The emulated
output must equal ``int8_conv_plain`` bit for bit, so a swapped LBO/SBO, a
wrong swizzle or core-matrix order, a short ring or a wrong fragment map
fails here before a chip run.
"""

import os
import re

import numpy as np
import pytest
import torch

from rdpn6d_tpu_torch.ops import int8_conv as ic

SRC = os.path.join(os.path.dirname(ic.__file__), os.pardir, "csrc",
                   "int8_conv.cu")
CONSTS = ("kBM", "kBK", "kKStep", "kConvThreads", "kChunk", "kLayoutType",
          "kLBO", "kSBO", "kEpiChannels", "kEpiPitch")
SMEM_ADDR = 0x400          # where the ring starts in the emulated window


def _c_expr(expr: str) -> str:
    """A C integer expression of the source as Python (``/`` truncates)."""
    return expr.replace("/", "//")


def _source():
    """The kernel's constants, implemented plans, descriptor fields and
    the loader's shared offset, read from the source."""
    with open(SRC) as f:
        text = f.read()
    env = {}
    for name in CONSTS:
        m = re.search(rf"constexpr int {name} = ([^;]+);", text)
        assert m, f"{name} not found in {SRC}"
        env[name] = eval(_c_expr(m.group(1)), {}, dict(env))
    plans = re.search(r"#define INT8_CONV_PLANS\(X\) (.+)", text).group(1)
    env["plans"] = tuple((int(a), int(b)) for a, b in
                         re.findall(r"X\((\d+), (\d+)\)", plans))
    desc = re.search(r"uint64_t smem_desc\(uint32_t addr\) \{(.+?)\n\}",
                     text, re.S).group(1)
    env["desc_fields"] = {int(shift): name for name, shift in re.findall(
        r"\((k\w+) >> 4\) << (\d+)", desc)}
    env["desc_type"] = re.search(r"\(uint64_t\)(k\w+) << 62",
                                 desc).group(1)
    env["dst"] = re.search(r"const uint32_t dst = ([^;]+);",
                           text).group(1)
    # the descriptors' advance a k32 step, in 16-byte units
    steps = re.search(r"Wgmma<BN>::mma\(acc, da \+ s \* \(([^)]+)\), "
                      r"db \+ s \* \(([^)]+)\)\)", text)
    env["step_a"], env["step_b"] = (eval(_c_expr(e), {}, dict(env))
                                    for e in steps.groups())
    # the ring's protocol: slabs loaded ahead (prologue and loop) and the
    # cp.async groups left pending at a slab's wait, as kStages minus these
    env["ahead"] = int(re.search(r"for \(int s = 0; s < kStages - (\d+);",
                                 text).group(1))
    env["next"] = int(re.search(r"const int next = kt \+ kStages - (\d+);",
                                text).group(1))
    env["wait"] = int(re.search(r"cp_async_wait<kStages - (\d+)>\(\);",
                                text).group(1))
    return env


SRC_ENV = _source()


def _desc(addr: int, env) -> int:
    """The kernel's smem_desc: start address, and the constants at the
    shifts the source puts them, in 16-byte units."""
    d = (addr & 0x3FFFF) >> 4
    for shift, name in env["desc_fields"].items():
        d |= (env[name] >> 4) << shift
    return d | env[env["desc_type"]] << 62


def _read(smem: np.ndarray, desc: int, rows: int) -> np.ndarray:
    """What wgmma reads for a K-major operand of ``rows`` x 32 bytes
    through ``desc``. Layout type 0 (no swizzle): byte (row, k) at start +
    (row / 8) SBO + (k / 16) LBO + (row % 8) 16 + k % 16. Types 3, 2 and 1
    (the 32-, 64- and 128-byte swizzles, w bytes a row): a = start + (row
    / 8) SBO + (row % 8) w + k, then the 16-byte chunk bits of a XORed with
    the bits above 128 bytes (``Swizzle<log2(w / 16), 4, 3>``)."""
    start = (desc & 0x3FFF) << 4
    lbo = ((desc >> 16) & 0x3FFF) << 4
    sbo = ((desc >> 32) & 0x3FFF) << 4
    row = np.arange(rows)[:, None]
    k = np.arange(32)[None, :]
    kind = desc >> 62
    if kind == 0:
        return smem[start + (row // 8) * sbo + (k // 16) * lbo
                    + (row % 8) * 16 + k % 16]
    bits = {3: 1, 2: 2, 1: 3}[kind]
    a = start + (row // 8) * sbo + (row % 8) * (16 << bits) + k
    return smem[a ^ (((a >> 7) & ((1 << bits) - 1)) << 4)]


def _emulate(xq, sx, wq, sw, stride, pad, plan, env=SRC_ENV):
    """int8_conv as the kernel computes it, block by block, in numpy;
    float32 output [B, N, Ho, Wo]."""
    B, H, W, Cp = xq.shape
    N, kh, kw, _ = wq.shape
    Ho = (H + 2 * pad - kh) // stride + 1
    Wo = (W + 2 * pad - kw) // stride + 1
    hw, M, K = Ho * Wo, B * Ho * Wo, kh * kw * Cp
    BM, BK, threads = env["kBM"], env["kBK"], env["kConvThreads"]
    BN, S = plan.bn, plan.stages
    a_bytes, stage_bytes = BM * BK, (BM + BN) * BK
    rows_pass = threads // (BK // env["kChunk"])
    pass_bytes = rows_pass // 8 * env["kSBO"]
    KT = -(-K // BK)
    xflat = xq.reshape(-1).view(np.uint8)
    wflat = wq.reshape(N, K).view(np.uint8)
    out = np.full((B, N, hw), np.nan, np.float32)
    tid = np.arange(threads)
    kc, r = tid % (BK // env["kChunk"]), tid // (BK // env["kChunk"])
    dst = eval(_c_expr(env["dst"]), {}, dict(env, r=r, kc=kc))
    lane16 = np.arange(16)
    assert plan.grid == (-(-M // BM), -(-N // BN))
    for bx in range(plan.grid[0]):
        for by in range(plan.grid[1]):
            m0, n0 = bx * BM, by * BN
            smem = np.full(SMEM_ADDR + S * stage_bytes, 0xA5, np.uint8)
            # the loader's per-thread state, advanced a slab per load
            k = kc * env["kChunk"]
            c, kx, ky = k.copy(), np.zeros_like(k), np.zeros_like(k)

            def settle():
                while (c >= Cp).any():
                    over = c >= Cp
                    c[over] -= Cp
                    kx[over] += 1
                    wrap = over & (kx == kw)
                    kx[wrap] = 0
                    ky[wrap] += 1

            settle()
            groups = []          # committed cp.async groups: [(addr, bytes)]

            def load(stage):
                base = SMEM_ADDR + stage * stage_bytes + dst
                k_ok = k < K
                chunks = []
                for i in range(BM // rows_pass):
                    m = m0 + r + i * rows_pass
                    b = np.where(m < M, m // hw, 0)
                    p = np.where(m < M, m % hw, 0)
                    iy = (p // Wo) * stride - pad + ky
                    ix = (p % Wo) * stride - pad + kx
                    ok = k_ok & (m < M) & (iy >= 0) & (iy < H) & (ix >= 0) \
                        & (ix < W)
                    src = np.where(ok, ((b * H + iy) * W + ix) * Cp + c, 0)
                    data = np.where(ok[:, None], xflat[src[:, None] + lane16],
                                    0)
                    chunks.append((base + i * pass_bytes, data))
                for j in range(BN // rows_pass):
                    n = n0 + r + j * rows_pass
                    ok = k_ok & (n < N)
                    data = np.where(
                        ok[:, None],
                        wflat[np.where(ok, n, 0)[:, None],
                              np.where(ok, k, 0)[:, None] + lane16], 0)
                    chunks.append((base + a_bytes + j * pass_bytes, data))
                k[:] += BK
                c[:] += BK
                settle()
                return chunks

            def land(upto):
                while len(landed) < upto:
                    for addr, data in groups[len(landed)]:
                        assert len(np.unique(addr)) == len(addr)
                        smem[addr[:, None] + lane16] = data
                    landed.append(True)

            landed = []
            acc = np.zeros((2, 64, BN), np.int64)   # per warpgroup
            pending = []         # wgmma groups issued, not yet read

            def operands(kt):
                """What the wgmmas of slab kt read: per warpgroup and k32
                step, A (64 x 32) and B (BN x 32)."""
                st = SMEM_ADDR + (kt % S) * stage_bytes
                ops = []
                for wg in range(2):
                    da = _desc(st + wg * (64 // 8) * env["kSBO"], env)
                    db = _desc(st + a_bytes, env)
                    for s in range(BK // env["kKStep"]):
                        ops.append((wg,
                                    _read(smem, da + s * env["step_a"], 64),
                                    _read(smem, db + s * env["step_b"], BN)))
                return ops

            def retire(kt, early):
                """The wgmmas of slab kt, read at issue and again as late as
                the protocol lets them run: both reads must agree."""
                for (wg, a, bm), (_, a0, b0) in zip(operands(kt), early):
                    assert np.array_equal(a, a0) and np.array_equal(bm, b0), \
                        f"slab {kt}'s buffer changed while its wgmmas ran"
                    acc[wg] += a.view(np.int8).astype(np.int64) \
                        @ bm.view(np.int8).astype(np.int64).T

            for s in range(S - env["ahead"]):
                groups.append(load(s) if s < KT else [])
            for kt in range(KT):
                # cp.async.wait_group: all but the newest groups land
                land(len(groups) - (S - env["wait"]))
                # the barrier: every warpgroup's wgmmas of slab kt - 2 are
                # done (wait_group 1 in iteration kt - 1); later ones may
                # still be reading
                while pending and pending[0][0] <= kt - 2:
                    retire(*pending.pop(0))
                pending.append((kt, operands(kt)))
                nxt = kt + S - env["next"]
                groups.append(load(nxt % S) if nxt < KT else [])
            land(len(groups))
            while pending:
                retire(*pending.pop(0))
            # the fragment of wgmma.m64nBNk32.s32: thread t of warpgroup wg
            # (warp w = t / 32 % 4, lane) holds acc[4 j + 2 h + e] at row
            # 16 w + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e
            t = np.arange(threads)
            wg, warp, lane = t // 128, t // 32, t % 32
            frow = 64 * wg + 16 * (warp % 4) + lane // 4
            fcol = 2 * (lane % 4)
            i = np.arange(BN // 2)
            j, h, e = i // 4, i % 4 // 2, i % 2
            frag = acc[wg[:, None], (frow[:, None] - 64 * wg[:, None])
                       + 8 * h, 8 * j + fcol[:, None] + e]
            # staged epilogue: kEpiChannels channels a pass through shared
            # memory, int32 [channel][pixel] with a pitch of kEpiPitch
            E, pitch = env["kEpiChannels"], env["kEpiPitch"]
            pix = m0 + np.arange(BM)
            b_of, p_of = pix // hw, pix % hw
            for cc in range(BN // E):
                if n0 + cc * E >= N:
                    break
                stage = np.full(E * pitch, -1, np.int64)
                jj = np.arange(E // 8)
                v = np.arange(4)
                col = 8 * jj[:, None] + fcol[:, None, None] + v % 2
                row = frow[:, None, None] + 8 * (v // 2)
                idx = col * pitch + row
                assert len(np.unique(idx)) == idx.size == E * BM
                stage[idx.reshape(-1)] = frag[
                    :, 4 * (cc * E // 8 + jj)[:, None] + v].reshape(-1)
                n = n0 + cc * E + np.arange(E)
                ok_n, ok_m = n < N, pix < M
                vals = stage.reshape(E, pitch)[:, :BM].astype(np.float32)
                scale = sx[np.where(ok_m, b_of, 0)][None, :] \
                    * sw[np.where(ok_n, n, 0)][:, None]
                y = vals * scale.astype(np.float32)
                nn, mm = np.meshgrid(np.nonzero(ok_n)[0],
                                     np.nonzero(ok_m)[0], indexing="ij")
                out[b_of[mm], n[nn], p_of[mm]] = y[nn, mm]
    return out.reshape(B, N, Ho, Wo)


def _inputs(B, H, W, C, N, k, seed):
    rng = np.random.RandomState(seed)
    cp = ic.padded_channels(C)
    xq = np.zeros((B, H, W, cp), np.int8)
    xq[..., :C] = rng.randint(-127, 128, (B, H, W, C))
    wq = np.zeros((N, k, k, cp), np.int8)
    wq[..., :C] = rng.randint(-127, 128, (N, k, k, C))
    sx = (rng.rand(B) * 0.02 + 1e-3).astype(np.float32)
    sw = (rng.rand(N) * 0.002 + 1e-4).astype(np.float32)
    return xq, sx, wq, sw


def test_source_constants_match_the_wrapper():
    assert SRC_ENV["kBM"] == ic.TILE_M and SRC_ENV["kBK"] == ic.SLAB_BYTES
    assert SRC_ENV["plans"] == tuple(ic.STAGES.items())
    assert sorted(SRC_ENV["desc_fields"]) == [16, 32]


# (B, H, W, C_in, N, k, stride, pad): a ragged M with a tile across
# samples, a K tail (K = 288 is 2.25 slabs, 9 taps of Cp 32, four a
# slab), a 1x1 kernel with K = 32 (a quarter slab), C_in 40 (Cp 64),
# stride 2, and N past a tile
EMULATED = [(3, 7, 9, 8, 24, 3, 1, 1), (2, 9, 13, 32, 40, 1, 1, 0),
            (2, 6, 7, 40, 70, 3, 2, 1), (1, 5, 5, 16, 130, 3, 2, 1)]


@pytest.mark.parametrize("bn", sorted(ic.STAGES))
@pytest.mark.parametrize("shape", EMULATED,
                         ids=lambda s: "x".join(map(str, s)))
def test_emulated_kernel_equals_plain(shape, bn):
    B, H, W, C, N, k, stride, pad = shape
    xq, sx, wq, sw = _inputs(B, H, W, C, N, k, sum(shape))
    Ho = (H + 2 * pad - k) // stride + 1
    Wo = (W + 2 * pad - k) // stride + 1
    plan = ic.int8_conv_plan(B, Ho, Wo, N, k * k * xq.shape[3], bn=bn)
    got = _emulate(xq, sx, wq, sw, stride, pad, plan)
    ref = ic.int8_conv_plain(torch.from_numpy(xq), torch.from_numpy(sx),
                             torch.from_numpy(wq), torch.from_numpy(sw),
                             stride, pad, torch.float32).numpy()
    assert np.array_equal(got, ref)


def test_emulation_catches_a_swapped_descriptor():
    """LBO and SBO swapped in the descriptor (the loader unchanged): the
    reads land on other chunks and the sums differ."""
    env = dict(SRC_ENV, desc_fields={
        16: SRC_ENV["desc_fields"][32], 32: SRC_ENV["desc_fields"][16]})
    xq, sx, wq, sw = _inputs(3, 7, 9, 8, 24, 3, 0)
    plan = ic.int8_conv_plan(3, 7, 9, 24, 288)
    got = _emulate(xq, sx, wq, sw, 1, 1, plan, env)
    ref = ic.int8_conv_plain(torch.from_numpy(xq), torch.from_numpy(sx),
                             torch.from_numpy(wq), torch.from_numpy(sw),
                             1, 1, torch.float32).numpy()
    assert not np.array_equal(got, ref)


def _plan_shapes():
    """(B, Ho, Wo, N, K) of every int8 conv shape of chip_smoke.py's phase
    12 and of the card tests."""
    import chip_smoke
    from test_torch_cuda import INT8_CONV_SHAPES

    shapes = [s[1:] for s in chip_smoke.INT8_SHAPES] + list(INT8_CONV_SHAPES)
    out = set()
    for B, H, W, C, N, k, stride, pad in shapes:
        out.add((B, ic.conv_out_size(H, k, stride, pad),
                 ic.conv_out_size(W, k, stride, pad), N,
                 k * k * ic.padded_channels(C)))
    return sorted(out)


@pytest.mark.parametrize("B,Ho,Wo,N,K", _plan_shapes())
def test_plan_covers_the_shape(B, Ho, Wo, N, K):
    plan = ic.int8_conv_plan(B, Ho, Wo, N, K)
    gx, gy = plan.grid
    M = B * Ho * Wo
    assert (gx - 1) * ic.TILE_M < M <= gx * ic.TILE_M
    assert (gy - 1) * plan.bn < N <= gy * plan.bn
    assert ic.STAGES[plan.bn] == plan.stages
    assert plan.smem_bytes == plan.stages * (ic.TILE_M + plan.bn) \
        * ic.SLAB_BYTES
    assert SRC_ENV["kEpiChannels"] * SRC_ENV["kEpiPitch"] * 4 \
        <= plan.smem_bytes <= ic.SMEM_LIMIT
    assert gx <= ic.GRID_X_LIMIT and gy <= ic.GRID_Y_LIMIT


def test_plan_widths():
    # lm13's head at the serving batch: one 256-wide tile, each im2col row
    # gathered once
    for K in (2880, 2304):
        assert ic.int8_conv_plan(16, 64, 64, 256, K).bn == 256
    assert ic.int8_conv_plan(16, 64, 64, 64, 576).bn == 64
    assert ic.int8_conv_plan(16, 48, 48, 128, 576).bn == 128
    # too few tiles to fill 132 SMs: narrower tiles, more blocks
    assert ic.int8_conv_plan(16, 8, 8, 512, 2304).bn == 64
    assert ic.int8_conv_plan(16, 64, 64, 256, 2880, sm_count=1024).bn == 128
    with pytest.raises(ValueError):
        ic.int8_conv_plan(16, 64, 64, 256, 2880, bn=32)
    with pytest.raises(ValueError):
        ic.int8_conv_plan(1, 1, 1, 65_535 * 256 + 1, 32)
    with pytest.raises(ValueError):
        ic.int8_conv_plan(1, 1, 1, 8, 40)

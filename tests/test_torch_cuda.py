"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain versions on the card, and the entry points' default device.

They skip where there is no card. This file imports neither jax nor the
JAX package, so it also runs on a machine without them:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from rdpn6d_tpu_torch.ops import cuda_build
from rdpn6d_tpu_torch.ops.min_dist import min_dist2, min_dist2_plain


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,n,m,d", [(1, 7, 5, 3), (1, 300, 700, 3),
                                     (3, 129, 1000, 5), (16, 4096, 4096, 3)])
def test_min_dist2_kernel_matches_plain(card, B, n, m, d):
    g = torch.Generator().manual_seed(n + m)
    a = torch.randn(B, n, d, generator=g).to(card)
    b = torch.randn(B, m, d, generator=g).to(card)
    before = cuda_build.LAUNCHES.get("min_dist2", 0)
    out = min_dist2(a, b)
    torch.cuda.synchronize()
    assert cuda_build.LAUNCHES["min_dist2"] == before + 1
    ref = min_dist2_plain(a, b)
    # direct form on both sides; FMA contraction moves a few ulps
    scale = float((a * a).sum(-1).max() + (b * b).sum(-1).max())
    assert float((out - ref).abs().max()) <= 1e-6 * scale
    if B == 1:
        flat = min_dist2(a[0], b[0])
        assert flat.shape == (n,)
        torch.testing.assert_close(flat, out[0], rtol=0, atol=0)


@pytest.mark.cuda
def test_min_dist2_kernel_refuses_bad_input(card):
    a = torch.randn(4, 3, device=card)
    with pytest.raises(TypeError):
        min_dist2(a.half(), a.half())
    with pytest.raises(ValueError):
        min_dist2(a, torch.randn(5, 3))           # CPU b
    with pytest.raises(ValueError):
        min_dist2(torch.randn(4, 9, device=card),
                  torch.randn(5, 9, device=card))       # D > kernel max


@pytest.mark.cuda
def test_adi_on_card_matches_cpu(card):
    from rdpn6d_tpu_torch.evaluation.pose_error import adi

    rng = np.random.RandomState(0)
    q, _ = np.linalg.qr(rng.randn(6, 3, 3))
    R = torch.from_numpy((q * np.sign(np.linalg.det(q))[:, None, None])
                         .astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.5, 1.0, (6, 3)).astype(np.float32))
    pts = torch.from_numpy((rng.rand(6, 2000, 3) * 0.1).astype(np.float32))
    before = cuda_build.LAUNCHES.get("min_dist2", 0)
    on_card = adi(R.to(card), t.to(card), R.flip(0).to(card), t.to(card),
                  pts.to(card)).cpu()
    assert cuda_build.LAUNCHES["min_dist2"] == before + 1
    torch.testing.assert_close(on_card, adi(R, t, R.flip(0), t, pts),
                               rtol=0, atol=1e-6)


@pytest.mark.cuda
def test_default_device_is_cuda(card):
    from rdpn6d_tpu_torch.utils.device import resolve_device

    assert resolve_device(None).type == "cuda"

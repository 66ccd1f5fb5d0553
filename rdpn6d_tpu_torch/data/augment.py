"""Colour augmentation of the RGB crops, batched over ROIs.

Counterpart of ``rdpn6d_tpu/data/augment.py``: the same declarative
``AugOp`` pipelines (``code``, ``aae``, ``aae_weak``, ``lm``, ``roi10d``,
``none``; ``data.color_aug_ops`` overrides the named one) and the same
arithmetic op for op: the 7-tap Gaussian blur (the identity below sigma
1e-3, edge padding, the vertical pass first), add / multiply / contrast
with a value shared or per channel, channel inversion, coarse dropout
(a cell grid resized to the image by ``jax.image.resize``'s nearest rule,
half-pixel centres), saturation, brightness, gray contrast and PCA
lighting; each op's result clipped to 0..255 only where the op is on.

The JAX package draws inside the function from a PRNG key; here the draws
are an input, so tests can feed the JAX package's. ``draw_aug_params``
makes one set per ROI (each op's on-flag and its values, as torch
tensors), ``color_augment`` applies them to [B, H, W, 3] at once: the
number of launches does not grow with B.

``lighting`` (the ``roi10d`` pipeline) takes the eigenvectors of each
crop's 3x3 colour covariance. Their signs are not fixed by the math:
LAPACK and cuSOLVER may pick either, and a rounding of the covariance can
flip LAPACK's choice. The JAX package keeps LAPACK's; here each
eigenvector's largest component is made positive, so the card and the
CPU agree. The noise is symmetric, so the distribution is the same.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class AugOp:
    kind: str                       # blur | add | invert | multiply | contrast
    prob: float = 0.5               # | dropout | saturation | brightness_mul
    lo: float = 0.0                 # | contrast_gray | lighting
    hi: float = 1.0
    per_channel: float = 0.0        # probability of a value per channel


# the strong ops of the shipped "code" strings (lmo, ycbv, mp6d)
CODE_AUG: tuple[AugOp, ...] = (
    AugOp("blur", prob=0.5, lo=0.0, hi=1.2),
    AugOp("add", prob=0.5, lo=-25.0, hi=25.0, per_channel=0.3),
    AugOp("invert", prob=0.3, lo=0.2, hi=0.2, per_channel=1.0),
    AugOp("multiply", prob=0.5, lo=0.6, hi=1.4, per_channel=0.5),
    AugOp("multiply", prob=0.5, lo=0.6, hi=1.4),
    AugOp("contrast", prob=0.5, lo=0.5, hi=2.2, per_channel=0.3),
)
# the AAE family: the strong ops with coarse dropout (p 0.2, 5% cells)
AAE_AUG: tuple[AugOp, ...] = (
    AugOp("dropout", prob=0.5, lo=0.2, hi=0.05),
) + CODE_AUG
AAE_WEAK_AUG: tuple[AugOp, ...] = (
    AugOp("dropout", prob=0.4, lo=0.1, hi=0.05),
    AugOp("blur", prob=0.5, lo=0.0, hi=1.0),
    AugOp("add", prob=0.5, lo=-20.0, hi=20.0, per_channel=0.3),
    AugOp("invert", prob=0.4, lo=0.2, hi=0.2, per_channel=1.0),
    AugOp("multiply", prob=0.5, lo=0.7, hi=1.4, per_channel=0.8),
    AugOp("multiply", prob=0.5, lo=0.7, hi=1.4),
    AugOp("contrast", prob=0.5, lo=0.5, hi=2.0, per_channel=0.3),
)
# lm13's code string: the weak ops without the dropout
LM_AUG: tuple[AugOp, ...] = AAE_WEAK_AUG[1:]
# ROI10D's AugmentRGB: always-on jitters and PCA lighting (lo = its std)
ROI10D_AUG: tuple[AugOp, ...] = (
    AugOp("saturation", prob=1.0, lo=0.95, hi=1.05),
    AugOp("brightness_mul", prob=1.0, lo=0.99, hi=1.01),
    AugOp("contrast_gray", prob=1.0, lo=0.95, hi=1.05),
    AugOp("lighting", prob=1.0, lo=0.3, hi=0.3),
)
DEFAULT_AUG: tuple[AugOp, ...] = AAE_AUG

_PIPELINES: dict[str, tuple[AugOp, ...]] = {
    "code": CODE_AUG,
    "aae": AAE_AUG,
    "aae_weak": AAE_WEAK_AUG,
    "lm": LM_AUG,
    "roi10d": ROI10D_AUG,
    "none": (),
}
_GRAY = (0.299, 0.587, 0.114)


def get_aug_pipeline(name: str) -> tuple[AugOp, ...]:
    """The named pipeline (``data.color_aug_type``)."""
    try:
        return _PIPELINES[name.lower()]
    except KeyError:
        raise ValueError(f"unknown color_aug_type {name!r}; "
                         f"options: {sorted(_PIPELINES)}") from None


def config_ops(color_aug_ops: tuple, color_aug_type: str
               ) -> tuple[AugOp, ...]:
    """``data.color_aug_ops`` (AugOps, or their fields as dicts, as a JSON
    opt gives them) when set, else the named pipeline."""
    if color_aug_ops:
        return tuple(op if isinstance(op, AugOp) else AugOp(**op)
                     for op in color_aug_ops)
    return get_aug_pipeline(color_aug_type)


def dropout_grid_size(op: AugOp, size: tuple[int, int]) -> tuple[int, int]:
    return max(int(size[0] * op.hi), 1), max(int(size[1] * op.hi), 1)


def draw_aug_params(ops: tuple[AugOp, ...], batch: int,
                    generator: torch.Generator | None = None,
                    size: tuple[int, int] = (256, 256),
                    device: torch.device | str | None = None
                    ) -> list[dict[str, torch.Tensor]]:
    """One set of draws a ROI for each op: ``on`` [B] bool and ``value``:
    the blur sigma, the saturation / brightness / gray-contrast factor
    [B]; the add / multiply / contrast value [B, 3] (one value copied to
    the channels unless the op's per-channel draw came up); the invert
    flips [B, 3] bool; the dropout cells [B, h, w] bool for images of
    ``size``; the lighting noise [B, 3] (already times its std)."""
    if device is None:
        device = generator.device if generator is not None else "cpu"

    def rand(*shape):
        return torch.rand(shape, generator=generator, device=device)

    def uniform(op, *shape):
        return op.lo + (op.hi - op.lo) * rand(*shape)

    params = []
    for op in ops:
        on = rand(batch) < op.prob
        if op.kind in ("blur", "saturation", "brightness_mul",
                       "contrast_gray"):
            value = uniform(op, batch)
        elif op.kind in ("add", "multiply", "contrast"):
            per = rand(batch) < op.per_channel
            value = torch.where(per[:, None], uniform(op, batch, 3),
                                uniform(op, batch)[:, None].expand(-1, 3))
        elif op.kind == "invert":
            value = rand(batch, 3) < op.lo
        elif op.kind == "dropout":
            value = rand(batch, *dropout_grid_size(op, size)) < op.lo
        elif op.kind == "lighting":
            value = torch.randn((batch, 3), generator=generator,
                                device=device) * op.lo
        else:
            raise ValueError(f"unknown colour aug op {op.kind!r}")
        params.append({"on": on, "value": value})
    return params


def draw_color_aug(ops: tuple[AugOp, ...], batch: int, prob: float,
                   generator: torch.Generator | None = None,
                   size: tuple[int, int] = (256, 256),
                   device: torch.device | str | None = None) -> dict:
    """A train batch's colour-aug draws, in the form
    ``preprocess_rois_grouped``'s ``aug_params`` takes: ``apply`` [B] bool,
    each ROI's Bernoulli(``prob``) (``data.color_aug_prob``), drawn first,
    then ``ops``, ``draw_aug_params``'s."""
    if device is None:
        device = generator.device if generator is not None else "cpu"
    apply = torch.rand(batch, generator=generator, device=device) < prob
    return {"apply": apply,
            "ops": draw_aug_params(ops, batch, generator, size, device)}


def _gaussian_kernel(sigma: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """[B] sigmas -> [B, 2*radius+1] normalized taps; the identity kernel
    below sigma 1e-3."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=sigma.device)
    k = torch.exp(-0.5 * (x[None] / sigma.clamp_min(1e-3)[:, None]) ** 2)
    k = torch.where(sigma[:, None] < 1e-3, (x == 0).float()[None], k)
    return k / k.sum(dim=1, keepdim=True)


def _sep_conv(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """[B, H, W, C] convolved with each ROI's symmetric taps [B, T] along H
    then W, edges padded by replication ('valid' over the padded image)."""
    pad = k.shape[1] // 2
    H, W = img.shape[1], img.shape[2]
    x = torch.cat([img[:, :1].expand(-1, pad, -1, -1), img,
                   img[:, -1:].expand(-1, pad, -1, -1)], dim=1)
    x = sum(x[:, j:j + H] * k[:, j, None, None, None]
            for j in range(k.shape[1]))
    x = torch.cat([x[:, :, :1].expand(-1, -1, pad, -1), x,
                   x[:, :, -1:].expand(-1, -1, pad, -1)], dim=2)
    return sum(x[:, :, j:j + W] * k[:, j, None, None, None]
               for j in range(k.shape[1]))


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")``'s source index of each output
    index: floor((i + 0.5) * n_in / n_out) in float32."""
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * n_in / n_out).long()


def _apply_op(img: torch.Tensor, op: AugOp, value: torch.Tensor
              ) -> torch.Tensor:
    """img [B, H, W, 3] in 0..255 -> the op's unclipped result."""
    gray = torch.tensor(_GRAY, dtype=img.dtype, device=img.device)
    if op.kind == "blur":
        return _sep_conv(img, _gaussian_kernel(value))
    if op.kind == "add":
        return img + value[:, None, None, :]
    if op.kind == "multiply":
        return img * value[:, None, None, :]
    if op.kind == "invert":
        return torch.where(value[:, None, None, :], 255.0 - img, img)
    if op.kind == "contrast":
        return (img - 127.5) * value[:, None, None, :] + 127.5
    if op.kind == "dropout":
        H, W = img.shape[1], img.shape[2]
        rows = _nearest_index(H, value.shape[1], img.device)
        cols = _nearest_index(W, value.shape[2], img.device)
        mask = value[:, rows][:, :, cols].to(img.dtype)
        return img * (1.0 - mask[..., None])
    if op.kind == "saturation":
        gs = img @ gray
        a = value[:, None, None, None]
        return img * a + (1.0 - a) * gs[..., None]
    if op.kind == "brightness_mul":
        return img * value[:, None, None, None]
    if op.kind == "contrast_gray":
        gs = (img @ gray).mean(dim=(1, 2))
        a = value[:, None, None, None]
        return img * a + (1.0 - a) * gs[:, None, None, None]
    if op.kind == "lighting":
        flat = img.reshape(img.shape[0], -1, 3) / 255.0
        xm = flat - flat.mean(dim=1, keepdim=True)
        cov = xm.transpose(1, 2) @ xm / (flat.shape[1] - 1)
        eigval, eigvec = torch.linalg.eigh(cov)
        big = eigvec.abs().argmax(dim=1, keepdim=True)
        eigvec = eigvec * torch.sign(torch.gather(eigvec, 1, big))
        shift = (eigvec @ (eigval * value)[..., None])[..., 0]
        return img + 255.0 * shift[:, None, None, :]
    raise ValueError(f"unknown colour aug op {op.kind!r}")


def color_augment(img: torch.Tensor, params: list[dict[str, torch.Tensor]],
                  ops: tuple[AugOp, ...] = DEFAULT_AUG) -> torch.Tensor:
    """The pipeline ``ops`` with the draws ``params`` (``draw_aug_params``)
    on [B, H, W, 3] float32 images in 0..255: op after op, each result
    clipped to 0..255 where the op is on, the input kept where it is off."""
    if len(params) != len(ops):
        raise ValueError(f"{len(params)} sets of draws for {len(ops)} ops")
    for op, p in zip(ops, params):
        out = _apply_op(img, op, p["value"].to(img.device))
        on = p["on"].to(img.device)[:, None, None, None]
        img = torch.where(on, out.clamp(0.0, 255.0), img)
    return img

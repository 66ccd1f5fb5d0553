"""``csrc/roi_crop.cu`` ``roi_crop``: the least time of one launch.

Bytes: the outputs written once, B (S² 6 + O² 5) float32; each source
pixel that the launch's bilinear taps reach read once (its RGB and its
depth), the frame's coordinate axes, K and each ROI's scalars.
Operations: 96 float32 operations an input-crop pixel (four planes of
four taps weighted and blended, the normalisation, the back-projection,
a division counted as one) against the card's 33.5e12 float32
instructions a second. The larger of the two, in seconds; the bound of
``PERF.md``'s kernel table (``chip_smoke.roi_crop_bound``).
"""

import torch

KERNEL = "roi_crop_kernel"
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
OPS_PER_PIXEL = 96


def taps(center: torch.Tensor, scale: torch.Tensor, frame_idx: torch.Tensor,
         S: int, F: int, H: int, W: int) -> int:
    """The source pixels the launch's taps reach, each counted once."""
    grid = torch.arange(S, dtype=torch.float32) - S / 2
    step = scale.float()[:, None] / S
    hit = torch.zeros(F, H, W, dtype=torch.bool)
    for b in range(center.shape[0]):
        axes = []
        for axis, n in ((1, H), (0, W)):
            x0 = torch.floor(center[b, axis].float() + grid * step[b]).long()
            k = torch.cat([x0, x0 + 1])
            m = torch.zeros(n, dtype=torch.bool)
            m[k[(k >= 0) & (k < n)]] = True
            axes.append(m)
        hit[int(frame_idx[b])] |= axes[0][:, None] & axes[1][None, :]
    return int(hit.sum())


def bound_s(s: dict) -> float:
    B, S, O = len(s["scale"]), s["S"], s["O"]
    px = taps(s["center"], s["scale"], s["frame_idx"], S, s["F"], s["H"],
              s["W"])
    in_bytes = px * (3 * s["rgb_bytes"] + s["depth_bytes"]) \
        + (s["H"] + s["W"]) * 4 + s["F"] * 10 * 4 + B * 20
    out_bytes = B * (S * S * 6 + O * O * 5) * 4
    return max((in_bytes + out_bytes) / HBM_BYTES_PER_S,
               B * S * S * OPS_PER_PIXEL / FP32_INSTR_PER_S)

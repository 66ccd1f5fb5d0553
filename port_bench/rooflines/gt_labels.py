"""``csrc/region_label.cu`` ``gt_labels``: the least time of one launch.

Per output pixel (B O²): its nearest tap of the packed masks (1 B) and
the float16 xyz (6 B) read, three float32 masks, the region id and the
float32 coordinate written (28 B); per ROI its keypoints, rotation,
extent, centre, scale and offset. Operations: per (pixel, keypoint) 7
float32 instructions of the nearest-keypoint search. The larger, in
seconds (``chip_smoke``'s ``gt_labels`` bound).
"""

KERNEL = "gt_labels_kernel"
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
INSTR_PER_PAIR = 7


def bound_s(s: dict) -> float:
    B, O, K = s["B"], s["O"], s["K"]
    pixels = B * O * O
    nbytes = pixels * (1 + 6 + 3 * 4 + 4 + 12) \
        + B * (K * 3 + 9 + 3 + 2 + 1) * 4
    return max(nbytes / HBM_BYTES_PER_S,
               pixels * K * INSTR_PER_PAIR / FP32_INSTR_PER_S)

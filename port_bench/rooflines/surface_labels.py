"""``csrc/region_label.cu`` ``surface_labels``: the least time of one
launch.

Per output pixel (B O²): its taps of the depth (4 B) and the packed masks
(1 B) read, the masks, trunc, region id and coordinate written (24 B);
per ROI its keypoints, K, rotation, translation, extent, centre, scale,
frame and factor. Operations: per (pixel, keypoint) 7 float32
instructions. The larger, in seconds (``chip_smoke``'s
``surface_labels`` bound).
"""

KERNEL = "surface_labels_kernel"
HBM_BYTES_PER_S = 3.35e12
FP32_INSTR_PER_S = 67e12 / 2
INSTR_PER_PAIR = 7
BYTES_PER_PIXEL = 29


def bound_s(s: dict) -> float:
    B, O, K = s["B"], s["O"], s["K"]
    pixels = B * O * O
    nbytes = pixels * BYTES_PER_PIXEL \
        + B * ((K * 3 + 9 + 9 + 3 + 3 + 2 + 1) * 4 + 8)
    return max(nbytes / HBM_BYTES_PER_S,
               pixels * K * INSTR_PER_PAIR / FP32_INSTR_PER_S)

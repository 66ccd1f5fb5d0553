"""``csrc/int8_conv.cu`` ``int8_conv``: the least time of one launch.

Operations: 2 M N K int8 (M = B Ho Wo, K = k² C) against the card's
1979e12 int8 operations a second. Bytes: the int8 activations and
weights with channels padded to 32, the two scale vectors, and the
bfloat16 output, each once. The larger, in seconds
(``chip_smoke.int8_conv_bound``).
"""

KERNEL = "int8_conv_kernel"
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
CIN_ALIGN = 32


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def bound_s(s: dict) -> float:
    B, H, W, C, N = s["B"], s["H"], s["W"], s["C"], s["N"]
    k, st, pad = s["k"], s["stride"], s["pad"]
    Ho, Wo = out_size(H, k, st, pad), out_size(W, k, st, pad)
    cp = -(-C // CIN_ALIGN) * CIN_ALIGN
    ops = 2.0 * B * Ho * Wo * N * k * k * C
    nbytes = B * H * W * cp + N * k * k * cp + 4 * (B + N) \
        + 2 * B * N * Ho * Wo
    return max(ops / INT8_OPS_PER_S, nbytes / HBM_BYTES_PER_S)

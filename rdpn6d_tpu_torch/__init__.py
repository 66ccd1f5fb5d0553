"""rdpn6d_tpu_torch — the PyTorch/CUDA port of ``rdpn6d_tpu`` for NVIDIA
Hopper (H100).

It keeps the JAX package's layout and names, so each module's counterpart
is found at the same path under ``rdpn6d_tpu/``:

    geometry/    rotations, allocentric<->egocentric, camera model
    ops/         ROI warp, torch-convention resizes, region gather, and the
                 hand-written CUDA kernels (``min_dist2``) with their plain
                 PyTorch versions
    models/      ResNet trunk, PointNet fusion, dense head, Patch-PnP, RDPN
    data/        eval-half ROI preprocessing, per-class assets
    engine/      the serving ``Predictor``
    evaluation/  ADD / ADI / re / te / proj pose errors
    utils/       device resolution, flax-tree -> state_dict weight carrier
    csrc/        CUDA C++ sources, built with nvcc at first use

The package imports torch and numpy only: never jax, never ``rdpn6d_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

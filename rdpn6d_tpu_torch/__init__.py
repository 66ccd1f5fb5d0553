"""rdpn6d_tpu_torch — the PyTorch/CUDA port of ``rdpn6d_tpu`` for NVIDIA
Hopper (H100).

It keeps the JAX package's layout and names, so each module's counterpart
is found at the same path under ``rdpn6d_tpu/``:

    geometry/    rotations, allocentric<->egocentric, camera model
    ops/         ROI warp, torch-convention resizes, region gather, and the
                 hand-written CUDA kernels (``min_dist2``) with their plain
                 PyTorch versions
    models/      ResNet trunk, PointNet fusion, dense head, Patch-PnP, RDPN
    data/        ROI preprocessing, per-class assets, dataset refs, BOP
                 split records, detections, PLY/JSON/CSV IO, the PNG codec,
                 the eval decoder, synthetic fixtures
    engine/      the serving ``Predictor``, the ``Trainer``, checkpoints,
                 the inference driver and the split eval runner
    evaluation/  pose errors, the ``PoseEvaluator``, recall/AUC scoring,
                 recall curves, BOP19 MSSD/MSPD and average recalls
    utils/       device resolution, flax-tree -> state_dict weight carrier
    csrc/        CUDA C++ sources, built with nvcc at first use
    main.py      the CLI (``--eval-only``)

The package imports torch and numpy only: never jax, never ``rdpn6d_tpu``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

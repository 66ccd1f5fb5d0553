"""The benchmark's plain reference of ``rdpn6d_tpu_torch``.

A frozen copy of the port's plain PyTorch paths, in the port's own
layout so its relative imports stand: the config schema, the geometry,
the plain versions of the crop (``ops/roi_crop.py``) and the label
kernels (``ops/gt_labels.py``, ``ops/surface_labels.py``), the colour
augmentation and the grouped preprocessing (``data/``), the model
(``models/``), the losses, Ranger under flat_and_anneal (``solver/``),
and the one-process train and eval steps (``parallel/train_step.py``).
It imports nothing of ``rdpn6d_tpu_torch``, ``rdpn6d_tpu`` or ``jax``
and takes nothing the program made: the benchmark hands it the config's
opts, its own seeded state dict and its own inputs, and it works out
again every crop, label, scale and update. Departures from the port: no
CUDA kernel, no remat, no process group, ConvPnPNet only, and the int8
head as ``models/quant.py``'s emulation at a given bit width.
``precision.py`` holds the control's lower precision.
"""

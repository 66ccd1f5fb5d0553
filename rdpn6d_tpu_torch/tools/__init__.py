"""The user-facing tools, counterparts of the JAX package's ``tools/``
scripts: ``python -m rdpn6d_tpu_torch.tools.<name>`` with the flags of
``tools/<name>.py`` (and ``--device``, ``cuda`` by default, where one
computes on a device).

  * ``eval_split``: a checkpoint on a test split (``run_eval``).
  * ``score_csv``: a BOP19 result CSV against a split's GT, no model.
  * ``fuse_detections``: detection JSONs fused, best score per object.
  * ``strip_checkpoint``: a checkpoint without its optimizer state.
  * ``compute_fps``: the FPS keypoints of a dataset's models.
  * ``convert_checkpoint``: a reference RDPN6D ``.pth`` or a JAX
    ``params.pkl`` to the port's checkpoint directory.
"""

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
  * ``make_mini_bop``: the mini rehearsal dataset, rendered.
  * ``gen_xyz_crop``: the GT xyz crops of a split, rendered.
  * ``overfit_synth``: train on N rendered views and score every serving
    mode on them.
  * ``int8_gate_sweep``: ``overfit_synth``'s int8 modes over seeds.
  * ``rehearse_protocol``: ``make_mini_bop`` through training, eval and
    BOP19 scoring, each step a subprocess.
  * ``train_so_family``: one single-object model per object of a
    dataset.
  * ``bench_train``: train-step throughput, MFU and its decomposition;
    ``--remat``, and ``--grouped-ab`` (two calls against the fused step).
  * ``bench_int8``: the serving forward in bf16 and the int8 modes.
  * ``bench_bn``: the trunk's and the head's forward, train against eval.
  * ``bench_layout``: the trunk's forward in three input memory layouts.
  * ``bench_input``: the flat and grouped input paths' poses/s and bytes.
  * ``bench_cli_step``: the training CLI's iteration split by stage.
  * ``bench_score_scale``: BOP19 scoring and the recall tables at 5000
    targets.
"""

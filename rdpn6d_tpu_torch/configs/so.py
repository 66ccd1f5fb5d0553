"""Parametric single-object (SO) experiments.

The port's own copy of the JAX package's ``configs/so.py``: one module in
place of the reference's per-object config families. The dataset and the
object come as a variant suffix of the config path:

    python -m rdpn6d_tpu_torch.main \\
        --config-file rdpn6d_tpu_torch/configs/so.py:tudl/can

Splits per family, as the reference SO configs have them:
  lm     train = image_set/{obj}_train.txt + 1k imgn renders
  lmo    train = all LM real images of the object + 10% PBR
  ycbv   train = per-object real + 75% PBR
  mp6d   train/test = per-object index over the 20 real scenes
  tless  train = the object's own train_primesense scene + 30% PBR
  tudl   train = the object's train_real scene + 10% PBR
  itodd/icbin/hb  PBR-only train, the last two PBR scenes held out as the
         validation split
Splits are resolved through the port's ``data/bop`` registry and objects
through ``data/refs``.
"""

from __future__ import annotations

from rdpn6d_tpu_torch.config import Config

# dataset -> (train template(s), (train2 template, ratio) | None,
#             test template, total_epochs)
_FAMILIES = {
    "lm": (["lm_{obj}_train", "lm_imgn_{obj}_train_1k_per_obj"],
           None, "lm_{obj}_test", 160),
    "lmo": (["lm_real_{obj}_all"], ("lmo_pbr_{obj}_train", 0.1),
            "lmo_bop_test", 80),
    "ycbv": (["ycbv_{obj}_train_real"], ("ycbv_{obj}_train_pbr", 0.75),
             "ycbv_{obj}_test", 20),
    "mp6d": (["mp6d_{obj}_train"], None, "mp6d_{obj}_test", 20),
    "tless": (["tless_real_{obj}_train"], ("tless_pbr_{obj}_train", 0.3),
              "tless_bop_test", 80),
    "tudl": (["tudl_real_{obj}_train"], ("tudl_pbr_{obj}_train", 0.1),
             "tudl_bop_test", 80),
    "itodd": (["itodd_pbr_{obj}_train"], None, "itodd_pbr_{obj}_test", 80),
    "icbin": (["icbin_pbr_{obj}_train"], None, "icbin_pbr_{obj}_test", 20),
    "hb": (["hb_pbr_{obj}_train"], None, "hb_pbr_{obj}_test", 80),
}


def get_config(variant: str) -> Config:
    try:
        dataset, obj = variant.split("/", 1)
        train_t, train2, test_t, epochs = _FAMILIES[dataset]
    except (ValueError, KeyError):
        raise ValueError(
            f"SO variant must be '<dataset>/<obj>' with dataset in "
            f"{sorted(_FAMILIES)}; got {variant!r}") from None

    from rdpn6d_tpu_torch.data.bop import get_split
    from rdpn6d_tpu_torch.data.refs import get_ref

    ref = get_ref(dataset)
    if obj not in ref.objects:
        raise ValueError(f"{dataset} has no object {obj!r}; "
                         f"objects: {ref.objects}")
    train = [t.format(obj=obj) for t in train_t]
    test = test_t.format(obj=obj)
    t2_name = train2[0].format(obj=obj) if train2 is not None else None
    for name in (*train, test, *([t2_name] if t2_name else [])):
        get_split(name)  # an unknown split fails here, not at train time

    opts = [
        f'data.train_datasets={[str(t) for t in train]!r}'.replace("'", '"'),
        f'data.test_datasets=["{test}"]',
        "data.color_aug_prob=0.8",
        'data.color_aug_type="code"',
        "data.change_bg_prob=0.5",
        "data.truncate_fg=true",
        # one class: no class-aware heads, as the reference SO configs
        "head.num_classes=1",
        "backbone.rot_concat=true",
        "head.rot_class_aware=false",
        "head.mask_class_aware=false",
        "head.region_class_aware=false",
        f"solver.total_epochs={epochs}",
        'backbone.pretrained="torchvision://resnet34"',
        f'train.output_dir="output/{dataset}SO/{obj}"',
    ]
    if train2 is not None:
        opts += [
            f'data.train2_datasets=["{t2_name}"]',
            f"data.train2_ratio={train2[1]}",
        ]
    return Config(exp_name=f"{dataset}SO_{obj}").apply_opts(opts)

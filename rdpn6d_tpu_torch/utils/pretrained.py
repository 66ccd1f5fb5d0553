"""ImageNet-pretrained trunk weights: resolve ``backbone.pretrained`` to a
local file, loudly, and load a torchvision ResNet ``state_dict`` into the
model's hand-written trunk.

The port's own copy of ``rdpn6d_tpu/utils/torch_convert.py``'s
``resolve_pretrained`` and ``load_pretrained_backbone``. A
``torchvision://resnetNN`` spec is searched for as ``resnetNN*.pth`` in
``$RDPN6D_PRETRAINED_DIR``, ``$TORCH_HOME/hub/checkpoints`` and
``<$RDPN6D_DATA_ROOT>/pretrained``, in that order; nothing is downloaded,
and a missing file raises ``FileNotFoundError`` rather than train from
scratch. The trunk's module names are torchvision's, so the file's keys
load as they are under ``backbone.``.
"""

from __future__ import annotations

import glob
import os

import torch
from torch import nn


def resolve_pretrained(spec: str, depth: int = 34) -> str:
    """``backbone.pretrained`` -> a local .pth path ("" for "")."""
    if not spec:
        return ""
    if "://" in spec:
        scheme, name = spec.split("://", 1)
        if scheme != "torchvision":
            raise ValueError(f"unknown pretrained scheme {scheme!r} "
                             f"(supported: torchvision://, local paths)")
        search = [
            os.environ.get("RDPN6D_PRETRAINED_DIR", ""),
            os.path.join(os.environ.get(
                "TORCH_HOME", os.path.expanduser("~/.cache/torch")),
                "hub", "checkpoints"),
            os.path.join(os.environ.get("RDPN6D_DATA_ROOT", "datasets"),
                         "pretrained"),
        ]
        for base in search:
            if not base or not os.path.isdir(base):
                continue
            hits = sorted(glob.glob(os.path.join(base, f"{name}*.pth")))
            if hits:
                return hits[0]
        raise FileNotFoundError(
            f"backbone.pretrained={spec!r}: no {name}*.pth found in "
            f"{[s for s in search if s]}. Nothing is downloaded: fetch the "
            f"torchvision checkpoint elsewhere (torchvision.models.resnet"
            f"{depth}(weights='IMAGENET1K_V1')) and drop the .pth into "
            "$RDPN6D_PRETRAINED_DIR, or train explicitly from scratch with "
            'backbone.pretrained="". Refusing to train from scratch '
            "silently.")
    if not os.path.exists(spec):
        raise FileNotFoundError(
            f"backbone.pretrained={spec!r} does not exist; set "
            'backbone.pretrained="" to train from scratch')
    return spec


def load_pretrained_backbone(model: nn.Module, spec: str,
                             depth: int = 34) -> nn.Module:
    """Load the torchvision ResNet ``state_dict`` that ``spec`` resolves to
    into ``model.backbone`` (in place; returns ``model``). The classifier
    (``fc.*``) is dropped; a trunk tensor the file lacks, or a key it has
    that the trunk does not, raises, so a partial file never leaves
    random-init weights in the trunk. A space-to-depth stem takes the 7×7
    kernel remapped (``models/resnet.stem_kernel_to_s2d``)."""
    path = resolve_pretrained(spec, depth)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k: v for k, v in sd.items() if not k.startswith("fc.")}
    trunk = {k for k in model.backbone.state_dict()
             if not k.startswith("spatial_net.")}
    missing = sorted(trunk - set(sd))
    unexpected = sorted(set(sd) - trunk)
    # torchvision files from before 0.4 carry no BatchNorm counters
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(
            f"{path}: not a ResNet-{depth} trunk: missing {missing[:5]}, "
            f"unexpected {unexpected[:5]}")
    stem = model.backbone.conv1.weight
    if stem.shape[-1] == 4 and sd["conv1.weight"].shape[-1] == 7:
        from ..models.resnet import stem_kernel_to_s2d

        sd["conv1.weight"] = stem_kernel_to_s2d(sd["conv1.weight"])
    model.backbone.load_state_dict(sd, strict=False)
    return model

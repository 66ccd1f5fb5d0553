"""Checkpoints in the port's own format.

Counterpart of ``rdpn6d_tpu/engine/checkpoint.py`` (orbax): one directory
per step, ``<directory>/<step>/state.pt`` holding the model's
``state_dict``, the optimizer's state and the step, with free-form
metadata beside it in ``extra.json``; the newest ``max_to_keep`` steps are
kept. Only directories that hold ``state.pt`` count as steps, so an orbax
step directory of the JAX package in a shared output directory is never
taken for one. JAX weights reach this format through
``utils/flax_params.checkpoint_from_params_pkl``. In a process group
(``parallel/mesh.py``) rank 0 writes each step and every rank waits for it
at a barrier; every rank restores.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any

import torch

from ..parallel import mesh
from ..parallel.train_step import TrainState

STATE_FILE = "state.pt"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep

    def _steps(self) -> list[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and os.path.isfile(
                          os.path.join(self.directory, d, STATE_FILE)))

    def save(self, step: int, state: TrainState,
             extra: dict[str, Any] | None = None) -> None:
        """Write step ``step`` (synchronously; the directory appears
        whole, by rename) and drop the oldest steps past ``max_to_keep``.
        In a process group rank 0 writes; every rank returns once it has."""
        if mesh.is_main():
            self._write(step, state, extra)
        mesh.barrier()

    def _write(self, step: int, state: TrainState,
               extra: dict[str, Any] | None) -> None:
        final = os.path.join(self.directory, str(step))
        tmp = f"{final}.tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        torch.save({"model": state.model.state_dict(),
                    "optimizer": None if state.optimizer is None
                    else state.optimizer.state_dict(),
                    "step": int(step)}, os.path.join(tmp, STATE_FILE))
        if extra:
            with open(os.path.join(tmp, "extra.json"), "w") as f:
                json.dump(extra, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        steps = self._steps()
        for old in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state: TrainState, step: int | None = None
                ) -> tuple[TrainState, dict[str, Any]]:
        """Load step ``step`` (default the latest) into ``state``'s model,
        and into its optimizer when it has one; returns (state, extra)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return state, {}
        sdir = os.path.join(self.directory, str(step))
        ckpt = torch.load(os.path.join(sdir, STATE_FILE),
                          map_location="cpu", weights_only=True)
        state.model.load_state_dict(ckpt["model"])
        if state.optimizer is not None and ckpt["optimizer"] is not None:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        extra: dict[str, Any] = {}
        extra_path = os.path.join(sdir, "extra.json")
        if os.path.exists(extra_path):
            with open(extra_path) as f:
                extra = json.load(f)
        return state, extra

    def resume_or_load(self, state: TrainState, resume: bool
                       ) -> tuple[TrainState, int]:
        """With ``resume`` and a checkpoint on disk, restore the latest and
        continue from its step; else start at 0."""
        if resume:
            step = self.latest_step()
            if step is not None:
                state, _ = self.restore(state, step)
                return state, int(step)
        return state, 0

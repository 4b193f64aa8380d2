"""Checkpoint management over ``torch.save`` (port of
``pdunet_tpu/training/checkpoint.py``, which wraps orbax).

A checkpoint is one file ``<directory>/<step>.pt`` holding ``{"model":
state_dict, "optimizer": state_dict, "step": int, "config": dict}``,
written to a temporary file and moved into place with ``os.replace``, so a
crash mid-write leaves the previous checkpoints whole. The manager keeps
the newest ``max_to_keep`` and saves as orbax's default policy does: a step
past the latest saved one, when it is a multiple of
``save_interval_steps`` or the directory holds none yet, or on ``force``.

In a run over a mesh every rank builds the manager and restores from it,
and only rank 0's (``primary=True``) writes; the state-dict keys are the
model's own, so a checkpoint moves between a mesh run and a single-device
one.

The reference needs ``_flip_remat_names`` because flax renames its scan
modules with ``model.remat``; the port's parameter names do not depend on
remat, so a checkpoint restores under either setting.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Optional

import torch

__all__ = ["CheckpointManager"]

_NAME = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Keep-N checkpoints of a train state (``training.loop.TrainState``)."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval_steps: int = 1,
                 primary: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        #: whether :meth:`save` writes (rank 0 of a mesh run)
        self.primary = primary

    def all_steps(self) -> list:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory))
                      if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def should_save(self, step: int) -> bool:
        latest = self.latest_step()
        if latest is not None and latest >= step:
            return False
        return latest is None or step % self.save_interval_steps == 0

    def save(self, step: int, state, config=None, force: bool = False) -> bool:
        """Write ``state`` as step ``step``; returns whether it was written
        (never off the primary rank)."""
        if not self.primary or (not force and not self.should_save(step)):
            return False
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "step": int(state.step),
                   "config": dataclasses.asdict(config) if config is not None else None}
        path = self._path(step)
        tmp = f"{path}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return True

    def restore(self, state, step: Optional[int] = None):
        """Load checkpoint ``step`` (default: the latest) into ``state`` in
        place and return it; None when there is no checkpoint. Raises
        ValueError when the saved model or optimizer does not match
        ``state``'s."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = self._path(step)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint for step {step} in {self.directory}")
        payload = torch.load(path, map_location="cpu", weights_only=True)
        saved = {k: tuple(v.shape) for k, v in payload["model"].items()}
        want = {k: tuple(v.shape) for k, v in state.model.state_dict().items()}
        if saved != want:
            missing = sorted(want.keys() - saved.keys())
            extra = sorted(saved.keys() - want.keys())
            shapes = sorted(k for k in want.keys() & saved.keys() if want[k] != saved[k])
            raise ValueError(
                f"checkpoint at step {step} in {self.directory} does not match the model "
                f"(missing {missing[:4]}{'…' if len(missing) > 4 else ''}, unexpected "
                f"{extra[:4]}{'…' if len(extra) > 4 else ''}, other shapes "
                f"{shapes[:4]}{'…' if len(shapes) > 4 else ''}); restore with the "
                f"config the run was trained with"
                + (f": {payload['config']['model']}" if payload.get("config") else ""))
        state.model.load_state_dict(payload["model"])
        try:
            state.optimizer.load_state_dict(payload["optimizer"])
        except ValueError as e:
            raise ValueError(f"checkpoint at step {step} in {self.directory}: the "
                             f"optimizer state does not match ({e})") from e
        state.step = payload["step"]
        return state

"""Checkpoints on ``torch.save``: the twin of ``valle_tpu/train/checkpoint.py``
(the reference's icefall checkpoint flow):

  - per-epoch ``epoch-N.pt`` and per-N-steps ``checkpoint-<step>.pt``, each
    with its ``.meta.json``, the step ones pruned to ``keep_last_k``, never
    one that a best marker names;
  - ``best-train-loss.json`` / ``best-valid-loss.json`` markers naming the
    best checkpoint so far;
  - ``latest()``: the checkpoint with the most steps, an epoch one at a tie;
  - contents ``{"model", "model_avg", "optimizer", "step", "meta"}``: the
    model's state dict (the reference's parameter names, so the port's and
    the JAX package's infer CLIs load the file as it is), the running
    average as a state dict of the same keys, the optimizer's
    ``state_dict()`` (ScaledAdam's clipping window under ``"global"``);
  - a train-stage switch keeps the weights, builds a fresh optimizer over
    the new stage's parameters and drops the sampler state.

A file is written to a temporary name and then renamed, so a crash during
a save leaves the previous checkpoints whole.  In a process group the
first rank writes the files, the markers and the pruning,
and every rank waits at a barrier after each save, so that all may then
read the same file (the ranks' weights and optimizer states are equal).
"""

from __future__ import annotations

import json
import os
import re
import time
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import torch

from valle_tpu_torch.parallel import dist
from valle_tpu_torch.train.state import TrainState, partition_params

_STEP = re.compile(r"^checkpoint-(\d+)\.pt$")
_EPOCH = re.compile(r"^epoch-(\d+)\.pt$")


def _names(directory: Path, pattern) -> list:
    return sorted(int(m.group(1)) for p in directory.iterdir() if (m := pattern.match(p.name)))


def averaged_state_dict(model: torch.nn.Module, model_avg: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """``model.state_dict()``'s keys with the running average's values: a
    tied parameter's every name holds its one average, and buffers their
    current values."""
    canonical = {id(p): name for name, p in model.named_parameters(remove_duplicate=True)}
    out = {}
    for key, t in model.state_dict(keep_vars=True).items():
        name = canonical.get(id(t))
        out[key] = model_avg[name] if name in model_avg else t.detach()
    return out


class CheckpointManager:
    def __init__(self, directory: str | Path, keep_last_k: int = 20):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last_k = keep_last_k
        self.last_save = {}  # seconds and bytes of the last save

    # ------------------------------------------------------------- low level
    def path(self, name: str) -> Path:
        return self.dir / f"{name}.pt"

    def _save(self, name: str, state: TrainState, meta: Dict) -> Path:
        payload = {"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                   "step": state.step, "meta": meta}
        if state.model_avg is not None:
            payload["model_avg"] = averaged_state_dict(state.model, state.model_avg)
        path = self.path(name)
        tmp = path.with_name(path.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, path)
        (self.dir / f"{name}.meta.json").write_text(json.dumps(meta))
        return path

    def _load(self, name: str, device) -> Tuple[Dict, Dict]:
        ckpt = torch.load(self.path(name), map_location=device, weights_only=False)
        return ckpt, self._meta(name) or ckpt.get("meta", {})

    # ------------------------------------------------------------ public api
    def save_epoch(self, epoch: int, state: TrainState, meta: Dict) -> None:
        meta = dict(meta, epoch=epoch)
        self._write(f"epoch-{epoch}", state, meta, prune=False)

    def save_step(self, step: int, state: TrainState, meta: Dict) -> None:
        self._write(f"checkpoint-{step}", state, meta, prune=True)

    def _write(self, name: str, state: TrainState, meta: Dict, prune: bool) -> None:
        """Save on the first rank (with the markers and the pruning), then
        a barrier; every rank records the save."""
        t0 = time.perf_counter()
        if dist.is_primary():
            self._save(name, state, meta)
            self._update_best(name, meta)
            if prune:
                self._prune()
        dist.barrier(dist.world_group())
        self.last_save = {"name": name, "seconds": time.perf_counter() - t0,
                          "bytes": self.path(name).stat().st_size}

    def _update_best(self, name: str, meta: Dict) -> None:
        """The best-train-loss / best-valid-loss markers: the name of the
        checkpoint with the lowest loss so far."""
        for key, marker in (("train_loss", "best-train-loss"), ("valid_loss", "best-valid-loss")):
            if meta.get(key) is None:
                continue
            marker_file = self.dir / f"{marker}.json"
            prev = json.loads(marker_file.read_text()) if marker_file.exists() else None
            if prev is None or meta[key] < prev["value"]:
                marker_file.write_text(json.dumps({"value": meta[key], "source": name}))

    def _prune(self) -> None:
        protected = set()
        for marker in ("best-train-loss", "best-valid-loss"):
            f = self.dir / f"{marker}.json"
            if f.exists():
                protected.add(json.loads(f.read_text())["source"])
        steps = _names(self.dir, _STEP)
        for s in steps[:-self.keep_last_k] if self.keep_last_k else []:
            name = f"checkpoint-{s}"
            if name in protected:
                continue
            self.path(name).unlink(missing_ok=True)
            (self.dir / f"{name}.meta.json").unlink(missing_ok=True)

    def _meta(self, name: str) -> Dict:
        f = self.dir / f"{name}.meta.json"
        return json.loads(f.read_text()) if f.exists() else {}

    def latest(self) -> Optional[str]:
        """The checkpoint to resume from: the one with the most steps
        (``meta["step"]``), the epoch one at a tie, since its epoch is
        finished.  A checkpoint without a step in its meta counts the number
        in its name, and an epoch one then comes after every step one (the
        JAX package's order, which can prefer an older step checkpoint to a
        later epoch one)."""
        best = None
        for p in self.dir.iterdir():
            m = _STEP.match(p.name) or _EPOCH.match(p.name)
            if m is None:
                continue
            is_epoch = m.re is _EPOCH
            name = p.name[:-len(".pt")]
            step = self._meta(name).get("step", -1 if is_epoch else int(m.group(1)))
            key = (step, is_epoch, int(m.group(1)))
            if best is None or key > best[0]:
                best = (key, name)
        return None if best is None else best[1]

    def best(self, which: str = "valid") -> Optional[str]:
        f = self.dir / f"best-{which}-loss.json"
        return json.loads(f.read_text())["source"] if f.exists() else None

    def restore(self, name: str, state: TrainState, *,
                make_optimizer: Optional[Callable] = None, from_stage: Optional[int] = None,
                to_stage: Optional[int] = None) -> Tuple[TrainState, Dict]:
        """Load ``name`` into ``state`` (in place; returned with the meta).
        When the train stage changes (AR -> NAR), keep the weights and the
        averaged model, build a fresh optimizer with ``make_optimizer`` over
        the new stage's trainable parameters, as they were loaded, and drop
        the sampler state."""
        device = next(state.model.parameters()).device
        ckpt, meta = self._load(name, device)
        state.model.load_state_dict(ckpt["model"])
        state.step = int(ckpt["step"])
        if state.model_avg is not None and "model_avg" in ckpt:
            with torch.no_grad():
                for k, v in state.model_avg.items():
                    v.copy_(ckpt["model_avg"][k])
        if from_stage is not None and to_stage is not None and from_stage != to_stage:
            if make_optimizer is None:
                raise ValueError("a stage-switch restore needs make_optimizer")
            trainable, _ = partition_params(state.model, to_stage)
            state.optimizer = make_optimizer(list(trainable.values()))
            meta = dict(meta)
            meta.pop("sampler_state", None)
            meta["stage_switched"] = True
        else:
            state.optimizer.load_state_dict(ckpt["optimizer"])
        return state, meta

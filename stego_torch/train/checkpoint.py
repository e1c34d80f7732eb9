"""Checkpoints with top-k retention by cluster mIoU; counterpart of
``stego_tpu/train/checkpoint.py``.

Reference behavior: Lightning ModelCheckpoint(every_n_train_steps=400,
save_top_k=2, monitor="test/cluster/mIoU", mode="max")
(train_segmentation.py:487-493), with the config embedded in the checkpoint
(save_hyperparameters, :106) so eval can rebuild the model without a config
file (eval_segmentation.py:67).

A run directory holds ``config.json``, the frozen backbone once
(``backbone.pt``: the ViT's state dict at its source precision, f32 under a
bf16 trunk) and one directory per kept step::

    <step>/state.pt     the train state: the head's and probes' state dicts,
                        the three Adams' state dicts and ``seg.step``
    <step>/model.ckpt   the reference Lightning checkpoint with the f32
                        backbone (``models/convert.py:save_stego_checkpoint``),
                        which ``stego_torch.eval`` and the JAX package's
                        ``load_stego_checkpoint`` read
    <step>/metrics.json the metrics the step was ranked by

After each save only the ``save_top_k`` steps of highest ``test/cluster/mIoU``
stay, ranked as the JAX package's orbax manager ranks them (a stable sort
by the metric of the steps in step order, so a tie keeps the later step; a
step without the metric ranks lowest). A preemption checkpoint
(``preempt/`` and ``preempt_step.json``) lands whatever its rank, and
:meth:`CheckpointManager.restore` prefers it when it is newer than every
kept step. Each step is written into a temporary directory and renamed, so
a reader never sees half of one. Saves are synchronous: the train state is
small, and the files are written from host copies. Over several processes
rank 0 writes (the ranks' states are equal bit for bit) and every rank
waits for it after each save; every rank restores.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict, Mapping, Optional

import torch

from stego_torch.config import Config
from stego_torch.models.convert import save_stego_checkpoint
from stego_torch.parallel import dist

METRIC_KEY = "test/cluster/mIoU"
BACKBONE_PREFIX = "net.model."


def top_k_steps(metrics_by_step: Mapping[int, Mapping[str, float]],
                k: int) -> list:
    """The steps that top-k retention keeps, in step order: orbax's BestN
    (a stable ascending sort by ``METRIC_KEY`` of the steps in step order,
    the last ``k`` kept); all of them when there are at most ``k``."""
    steps = sorted(metrics_by_step)
    if len(steps) <= k:
        return steps
    ranked = sorted(steps, key=lambda s: metrics_by_step[s].get(
        METRIC_KEY, float("-inf")))
    return sorted(ranked[-k:])


def _host(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in sd.items()}


def _optimizer_state(opt: torch.optim.Optimizer) -> Dict:
    sd = opt.state_dict()
    return {"state": {i: {k: (v.detach().cpu().clone()
                              if isinstance(v, torch.Tensor) else v)
                          for k, v in st.items()}
                      for i, st in sd["state"].items()},
            "param_groups": sd["param_groups"]}


class CheckpointManager:
    def __init__(self, directory: str, cfg: Config, save_top_k: int = 2):
        self.directory = os.path.abspath(directory)
        self.cfg = cfg
        self.save_top_k = max(1, save_top_k)
        self.primary = dist.is_primary()
        if self.primary:
            os.makedirs(self.directory, exist_ok=True)
            with open(os.path.join(self.directory, "config.json"), "w") as f:
                f.write(cfg.to_json())
        dist.barrier()
        self._backbone: Optional[Dict[str, torch.Tensor]] = None

    # -- the backbone --------------------------------------------------
    @property
    def _backbone_path(self) -> str:
        return os.path.join(self.directory, "backbone.pt")

    def save_backbone(self, backbone_sd: Mapping[str, torch.Tensor]) -> None:
        """Keep the frozen ViT's state dict (its source precision) for the
        ``.ckpt`` files, and write it once per run directory."""
        self._backbone = _host(backbone_sd)
        if self.primary and not os.path.exists(self._backbone_path):
            tmp = self._backbone_path + ".tmp"
            torch.save(self._backbone, tmp)
            os.replace(tmp, self._backbone_path)
        dist.barrier()

    def restore_backbone(self) -> Dict[str, torch.Tensor]:
        return torch.load(self._backbone_path, map_location="cpu",
                          weights_only=True)

    # -- steps ---------------------------------------------------------
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isdir(self._step_dir(n)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _metrics(self, step: int) -> Dict[str, float]:
        with open(os.path.join(self._step_dir(step), "metrics.json")) as f:
            return json.load(f)

    def _write(self, path: str, step: int, seg,
               metrics: Optional[Mapping[str, float]]) -> None:
        """The train state, the .ckpt and the metrics of ``seg`` into
        ``path`` (written as ``path``.tmp, then renamed over ``path``)."""
        if self._backbone is None:
            raise RuntimeError("save_backbone before the first save")
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        modules = {k: v for k, v in _host(seg.state_dict()).items()
                   if not k.startswith(BACKBONE_PREFIX)}
        torch.save({"modules": modules,
                    "optimizers": {name: _optimizer_state(opt) for name, opt
                                   in seg.optimizers().items()},
                    "step": int(seg.step)},
                   os.path.join(tmp, "state.pt"))
        save_stego_checkpoint(os.path.join(tmp, "model.ckpt"), seg, step,
                              backbone_sd=self._backbone)
        with open(os.path.join(tmp, "metrics.json"), "w") as f:
            json.dump({k: float(v) for k, v in (metrics or {}).items()}, f)
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)

    def save(self, step: int, seg,
             metrics: Optional[Mapping[str, float]] = None) -> None:
        """Save ``seg``'s train state as ``step``, then keep only the
        ``save_top_k`` best steps."""
        if self.primary:
            self._write(self._step_dir(step), step, seg, metrics)
            steps = self.all_steps()
            keep = set(top_k_steps({s: self._metrics(s) for s in steps},
                                   self.save_top_k))
            for s in steps:
                if s not in keep:
                    shutil.rmtree(self._step_dir(s))
        dist.barrier()

    def save_preemption(self, step: int, seg,
                        metrics: Optional[Mapping[str, float]] = None
                        ) -> None:
        """A save outside the top-k ranking, which lands whatever its
        metric: ``preempt/`` (replacing an earlier one) and
        ``preempt_step.json``. Nothing is written when a kept step already
        is ``step``."""
        if self.primary and step not in self.all_steps():
            self._write(os.path.join(self.directory, "preempt"), step, seg,
                        metrics)
            tmp = os.path.join(self.directory, "preempt_step.json.tmp")
            with open(tmp, "w") as f:
                json.dump({"step": int(step),
                           "metrics": {k: float(v) for k, v
                                       in (metrics or {}).items()}}, f)
            os.replace(tmp, os.path.join(self.directory,
                                         "preempt_step.json"))
        dist.barrier()

    def _preempt_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "preempt_step.json")
        if os.path.exists(p) and os.path.isdir(
                os.path.join(self.directory, "preempt")):
            with open(p) as f:
                return int(json.load(f)["step"])
        return None

    def checkpoint_path(self, step: Optional[int] = None) -> str:
        """The ``.ckpt`` of ``step`` (default: the newest kept step)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return os.path.join(self._step_dir(step), "model.ckpt")

    def restore(self, seg, step: Optional[int] = None) -> int:
        """Load a saved train state into ``seg`` (its head, probes,
        optimizers and ``step``; the backbone is not part of it) and return
        its step: ``step``, or else the newest of the kept steps and the
        preemption checkpoint. Raises FileNotFoundError when there is
        none."""
        path = None
        if step is None:
            pstep, latest = self._preempt_step(), self.latest_step()
            if pstep is not None and (latest is None or pstep > latest):
                step, path = pstep, os.path.join(self.directory, "preempt")
            else:
                step = latest
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = path or self._step_dir(step)
        state = torch.load(os.path.join(path, "state.pt"),
                           map_location="cpu", weights_only=True)
        missing, unexpected = seg.load_state_dict(state["modules"],
                                                  strict=False)
        missing = [k for k in missing if not k.startswith(BACKBONE_PREFIX)]
        if missing or unexpected:
            raise ValueError(f"checkpoint {path} does not fit the segmenter: "
                             f"missing {missing}, unexpected {unexpected}")
        for name, opt in seg.optimizers().items():
            opt.load_state_dict(state["optimizers"][name])
        seg.step = int(state["step"])
        return int(step)


def load_config(directory: str) -> Config:
    with open(os.path.join(os.path.abspath(directory), "config.json")) as f:
        return Config.from_dict(json.load(f))

"""Training loop (counterpart of ``dynamic_llava_tpu/train/trainer.py``,
single device).

Exponential Gumbel-tau annealing per step, grouped learning rates with
cosine + warmup schedules, per-step metric logging ({loss, mask losses,
lrs, tau}) to a JSONL stream, and checkpoints (``torch.save``) with
auto-resume. A checkpoint also holds the noise generator's state, so that
a resumed run draws the Gumbel noise an uninterrupted run would.
"""

from __future__ import annotations

import json
import os
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator

import torch

from ..config import LlavaConfig
from ..weights import map_leaves
from .optimizer import cosine_with_warmup, gumbel_tau_schedule, label_params, make_optimizer
from .step import batch_from_plan, make_train_step


@dataclass
class TrainerConfig:
    output_dir: str = "./checkpoints/run"
    learning_rate: float = 5e-6
    predictor_lr: float = 2e-4
    weight_decay: float = 0.0
    warmup_ratio: float = 0.03
    lr_scheduler_type: str = "cosine"
    num_train_steps: int = 1000
    gumbel_start_tau: float = 1.0
    gumbel_end_tau: float = 0.1
    logging_steps: int = 10
    save_steps: int = 500
    seed: int = 42
    gradient_checkpointing: bool = True
    # "nothing": recompute the whole layer in the backward (min memory, 7B)
    remat_policy: str = "nothing"
    grad_accum_steps: int = 1
    report_to: str = "jsonl"  # "jsonl" | "none"
    lora_mode: bool = False
    # stage-1 projector alignment: only the mm_projector trains
    tune_mm_mlp_adapter: bool = False
    # separate projector lr (0 = the base lr)
    mm_projector_lr: float = 0.0


MAX_CHECKPOINTS = 3  # the newest ones are kept


class MetricsLogger:
    """JSONL metrics stream."""

    def __init__(self, output_dir: str, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = None
        if enabled:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, Any]):
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = v
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None


class Trainer:
    """``Trainer(cfg, params, tc).train(batches)`` over ``(plan, images)``
    pairs. Runs on the card unless ``device`` says otherwise; ``params``
    are moved there and then updated in place."""

    def __init__(self, cfg: LlavaConfig, params, tc: TrainerConfig, device=None):
        self.cfg = cfg
        self.tc = tc
        self.device = torch.device("cuda" if device is None else device)
        params = map_leaves(lambda _, t: t.to(self.device), params)

        self.base_sched = cosine_with_warmup(
            tc.learning_rate, tc.num_train_steps, tc.warmup_ratio)
        self.pred_sched = cosine_with_warmup(
            tc.predictor_lr, tc.num_train_steps, tc.warmup_ratio)
        proj_sched = (
            cosine_with_warmup(tc.mm_projector_lr, tc.num_train_steps, tc.warmup_ratio)
            if tc.mm_projector_lr else None
        )
        self.optimizer = make_optimizer(
            base_lr=tc.learning_rate,
            predictor_lr=tc.predictor_lr,
            weight_decay=tc.weight_decay,
            lr_schedule=self.base_sched,
            predictor_lr_schedule=self.pred_sched,
            lora_mode=tc.lora_mode,
            tune_mm_mlp_adapter=tc.tune_mm_mlp_adapter,
            projector_lr_schedule=proj_sched,
        )
        self.params = params
        self.opt_state = self.optimizer.init(params)
        self.tau_fn = gumbel_tau_schedule(
            tc.gumbel_start_tau, tc.gumbel_end_tau, tc.num_train_steps)
        self.labels = label_params(
            params, lora_mode=tc.lora_mode,
            tune_mm_mlp_adapter=tc.tune_mm_mlp_adapter,
            projector_lr_group=bool(tc.mm_projector_lr),
        )
        self.step_fn = make_train_step(
            cfg, self.optimizer,
            remat=tc.gradient_checkpointing,
            grad_accum_steps=tc.grad_accum_steps,
            labels=self.labels,
            remat_policy=tc.remat_policy,
        )
        self.logger = MetricsLogger(tc.output_dir, tc.report_to != "none")
        self.generator = torch.Generator(device=self.device).manual_seed(tc.seed)
        self.step = 0

    # -- checkpointing -------------------------------------------------------

    @property
    def _ckpt_dir(self) -> str:
        return os.path.abspath(os.path.join(self.tc.output_dir, "ckpt"))

    def _checkpoints(self):
        """``(step, path)`` of the checkpoints on disk, oldest first."""
        if not os.path.isdir(self._ckpt_dir):
            return []
        found = []
        for name in os.listdir(self._ckpt_dir):
            m = re.fullmatch(r"step_(\d+)\.pt", name)
            if m:
                found.append((int(m.group(1)), os.path.join(self._ckpt_dir, name)))
        return sorted(found)

    def save(self) -> str:
        os.makedirs(self._ckpt_dir, exist_ok=True)
        path = os.path.join(self._ckpt_dir, f"step_{self.step}.pt")
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(
            {"step": self.step, "params": self.params, "opt_state": self.opt_state,
             "generator": self.generator.get_state()},
            tmp,
        )
        os.replace(tmp, path)
        for _, old in self._checkpoints()[:-MAX_CHECKPOINTS]:
            os.remove(old)
        return path

    def maybe_resume(self) -> bool:
        """Resume from the latest checkpoint if one exists: parameters and
        moments are copied into the tensors this trainer already holds."""
        found = self._checkpoints()
        if not found:
            return False
        step, path = found[-1]
        ckpt = torch.load(path, map_location=self.device, weights_only=True)

        def restore(dst, src):
            if isinstance(dst, dict):
                for k in dst:
                    dst[k] = restore(dst[k], src[k])
                return dst
            if isinstance(dst, list):
                return [restore(d, s) for d, s in zip(dst, src)]
            if isinstance(dst, torch.Tensor):
                with torch.no_grad():
                    return dst.copy_(src)
            return src

        restore(self.params, ckpt["params"])
        restore(self.opt_state, ckpt["opt_state"])
        self.generator.set_state(ckpt["generator"].cpu())
        self.step = step
        return True

    # -- loop ------------------------------------------------------------------

    def train(self, batches: Iterator) -> Dict[str, float]:
        tc = self.tc
        last_metrics: Dict[str, float] = {}
        t0, step0 = time.time(), self.step
        for plan, images in batches:
            if self.step >= tc.num_train_steps:
                break
            batch = batch_from_plan(plan, images, self.device)
            tau = self.tau_fn(self.step)
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, self.generator, tau)
            self.step += 1
            if self.step % tc.logging_steps == 0 or self.step == 1:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["gumbel_tau"] = float(tau)
                metrics["learning_rate"] = float(self.base_sched(self.step))
                metrics["predictor_lr"] = float(self.pred_sched(self.step))
                metrics["steps_per_s"] = (self.step - step0) / (time.time() - t0)
                self.logger.log(self.step, metrics)
                last_metrics = metrics
            if tc.save_steps and self.step % tc.save_steps == 0:
                self.save()
        return last_metrics

"""Trainer: the fault-tolerant training loop, as the reference's.

* checkpoint/restart via ``CheckpointManager`` (atomic, keep-k): a
  checkpoint every ``ckpt_every`` steps and one when the loop ends;
* preemption-safe: SIGTERM/SIGINT ends the loop with a final checkpoint;
* data-fault mitigation: a batch source that raises is retried up to
  ``max_data_retries`` times a step and each fault logged, and the step
  counter advances only on a step taken, so it stays deterministic;
* a JSONL metrics stream: a line at step 1 and every ``log_every`` steps.

The parameters are a tree of tensors (nested dicts, walked in sorted key
order): the reference's own tree, which the port's loss functions take
(``models.transformer.loss_fn`` and ``transformer_tree``,
``models.recsys.recsys_loss`` and ``recsys_tree``,
``models.gcn.gcn_loss``). The step is the port's ``optim.make_train_step``:
parameters and moments are updated in place, as the reference's jit
donates them. A numpy batch goes to the parameters' device
first.

The reference's mesh path (``mesh=`` with ``param_rules=``: sharded
parameters and the activation-sharding scope) is not ported: ``Trainer``
raises when given a mesh (ROADMAP.md §1 item 10, the mesh trainer).
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
from typing import Any, Callable, Iterator, Optional

import torch

from ..dist.sharding import MESH_TRAINER
from ..optim.adamw import AdamWConfig, _leaves, init_adamw, make_train_step
from .checkpoint import CheckpointManager


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    ckpt_dir: str = "build/train_ckpt"   # under the working directory
    keep_ckpts: int = 3
    metrics_path: Optional[str] = None
    max_data_retries: int = 3


class Trainer:
    def __init__(self, loss_fn: Callable, params: Any, opt_cfg: AdamWConfig,
                 cfg: TrainerConfig, *, mesh=None, param_rules=None,
                 accum_steps: int = 1, grad_transform=None):
        """``loss_fn(params, batch) -> (loss, metrics)``; ``params`` the
        tree (its tensors are updated in place)."""
        if mesh is not None or param_rules is not None:
            raise NotImplementedError(f"Trainer(mesh=, param_rules=): {MESH_TRAINER}")
        self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        self.params = params
        self.opt_state = init_adamw(params, opt_cfg)
        self.device = _leaves(params)[0].device
        self.step = 0
        self._stop = False
        self._metrics_f = None
        self._step_fn = make_train_step(loss_fn, opt_cfg, accum_steps=accum_steps,
                                        grad_transform=grad_transform)

    # -- preemption ------------------------------------------------------
    def _install_signal_handlers(self):
        def handler(signum, frame):
            self._stop = True
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                signal.signal(sig, handler)
            except ValueError:
                pass  # not the main thread

    # -- checkpointing -----------------------------------------------------
    def save(self):
        state = {"params": self.params, "opt": self.opt_state}
        return self.ckpt.save(self.step, state, extra={"step": self.step})

    def maybe_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        state, step = self.ckpt.restore(template, device=self.device)
        self.params = state["params"]
        self.opt_state = state["opt"]
        self.step = step
        return True

    # -- metrics -----------------------------------------------------------
    def _log(self, metrics: dict):
        if self.cfg.metrics_path:
            if self._metrics_f is None:
                os.makedirs(os.path.dirname(self.cfg.metrics_path) or ".", exist_ok=True)
                self._metrics_f = open(self.cfg.metrics_path, "a")
            rec = {"step": self.step, **{k: float(v) for k, v in metrics.items()}}
            self._metrics_f.write(json.dumps(rec) + "\n")
            self._metrics_f.flush()

    def _on_device(self, batch: dict) -> dict:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    # -- the loop ------------------------------------------------------------
    def fit(self, batches: Iterator, verbose: bool = False) -> dict:
        self._install_signal_handlers()
        history = []
        while self.step < self.cfg.total_steps and not self._stop:
            batch = None
            for attempt in range(self.cfg.max_data_retries):
                try:
                    batch = next(batches)
                    break
                except StopIteration:
                    self._stop = True
                    break
                except Exception as e:  # a data fault: skip and log
                    self._log({"data_fault": 1.0})
                    if verbose:
                        print(f"[trainer] data fault (attempt {attempt}): {e}")
            if batch is None or self._stop:
                break
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, self._on_device(batch))
            self.step += 1
            if self.step % self.cfg.log_every == 0 or self.step == 1:
                metrics = {k: float(v) for k, v in metrics.items()}
                history.append({"step": self.step, **metrics})
                self._log(metrics)
                if verbose:
                    print(f"[trainer] step {self.step}: " +
                          " ".join(f"{k}={v:.4g}" for k, v in metrics.items()))
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
        self.save()  # the preemption / completion checkpoint
        if self._metrics_f:
            self._metrics_f.close()
            self._metrics_f = None
        return {"final_step": self.step, "history": history}

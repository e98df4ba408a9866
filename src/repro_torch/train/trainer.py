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

**On a mesh** (``mesh=`` with ``param_rules=``, the reference's sharded
trainer) the trainer is SPMD: every rank builds it from the same tree and
feeds it the same global numpy batches (``dist.sharding``'s contract).
The specs come from ``spec_tree(params, param_rules, mesh)``, the moments'
from ``{"m": specs, "v": specs, "step": ()}``, both bound by
``bind_shardings``; parameters and moments are DTensors, a rank holding
only its block of each leaf. A batch is laid out over DP (``Shard(0)`` on
the data axes where the batch divides them, replicated on the model axis:
``shard_activation``'s layout for ``DP``).
The step is ``make_train_step`` over the DTensor tree: gradients come from
autograd through DTensor's sharding propagation, a leaf is redistributed
only where an op uses it, and AdamW updates the local blocks in place.
Each step runs inside ``activation_sharding(mesh)``. Metrics are plain
floats, equal on every rank. ``save`` gathers the tree leaf by leaf and
rank 0 writes the reference's unsharded layout, then every rank waits at a
barrier; ``maybe_restore`` lays a checkpoint out on the mesh, so an
unsharded checkpoint restores onto a mesh and a mesh checkpoint onto one
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import signal
from typing import Any, Callable, Iterator, Optional

import torch

from ..dist.sharding import (
    DP, _activation_spec, _placements, activation_sharding, bind_shardings, is_dtensor,
    spec_tree)
from ..optim.adamw import AdamWConfig, init_adamw, make_train_step
from ..utils import tree_leaves
from .checkpoint import CheckpointManager


def _map(fn, tree, *rest):
    """``fn`` over the leaves of a tree of dicts and the matching leaves of
    ``rest``."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return fn(tree, *rest)


def _distribute(x: torch.Tensor, bind) -> torch.Tensor:
    """Every rank holds the same ``x``: its own block, with no
    communication."""
    from torch.distributed.tensor import distribute_tensor
    mesh, placements = bind
    return distribute_tensor(x.detach().to(mesh.device_type), mesh, placements,
                             src_data_rank=None)


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
        self.cfg = cfg
        self.mesh = mesh
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep_ckpts)
        if mesh is not None and param_rules is not None:
            specs = spec_tree(params, param_rules, mesh)
            self.param_shardings = bind_shardings(mesh, specs)
            self.opt_shardings = bind_shardings(mesh, {"m": specs, "v": specs, "step": ()})
            self.params = _map(_distribute, params, self.param_shardings)
            self.device = torch.device(mesh.device_type, torch.cuda.current_device()) \
                if mesh.device_type == "cuda" else torch.device(mesh.device_type)
        else:
            self.mesh = None
            self.param_shardings = self.opt_shardings = None
            self.params = params
            self.device = tree_leaves(params)[0].device
        self.opt_state = init_adamw(self.params, opt_cfg)
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
        if self.mesh is None:
            return self.ckpt.save(self.step, state, extra={"step": self.step})
        import torch.distributed as dist
        rank0 = dist.get_rank() == 0

        def gather(x):   # a collective a leaf, on every rank; rank 0 keeps it
            full = x.full_tensor() if is_dtensor(x) else x
            return full.cpu() if rank0 else None
        host = _map(gather, state)
        path = self.ckpt.save(self.step, host, extra={"step": self.step}) if rank0 else None
        dist.barrier()
        return path

    def maybe_restore(self) -> bool:
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        template = {"params": self.params, "opt": self.opt_state}
        shardings = None
        if self.mesh is not None:
            shardings = {"params": self.param_shardings, "opt": self.opt_shardings}
        state, step = self.ckpt.restore(template, shardings=shardings, device=self.device)
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
        """A numpy batch on the device; on a mesh, each array's leading dim
        laid out over DP where it divides (every rank has the whole batch)."""
        out = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        if self.mesh is None:
            return out
        return {k: _distribute(v, (self.mesh, _placements(
            self.mesh, _activation_spec(self.mesh, v.shape, (DP,))))) for k, v in out.items()}

    # -- the loop ------------------------------------------------------------
    def train_step(self, batch: dict) -> dict:
        """One step of the loop on ``batch`` (inside the mesh's activation
        scope on a mesh), without its logs and checkpoints: the metrics,
        as tensors."""
        scope = activation_sharding(self.mesh) if self.mesh is not None \
            else contextlib.nullcontext()
        with scope:
            self.params, self.opt_state, metrics = self._step_fn(
                self.params, self.opt_state, self._on_device(batch))
        self.step += 1
        return metrics

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
            metrics = self.train_step(batch)
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


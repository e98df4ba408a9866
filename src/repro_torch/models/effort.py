"""Effort regressor: ``(query, radius) -> predicted match count``.

The serving layer's admission controller uses it to split a drained batch
into a cheap dispatch and a heavy one before any search runs: range-query
cost tracks the output size |S_r(q)|, so the match count is the effort
proxy. The model is the dense stack over ``[q, log1p(r), ||q||]`` features,
z-normalized with statistics frozen at fit time (the population standard
deviation, as ``jnp.std``), regressing ``log1p(count)`` under MSE, trained
full batch by the port's AdamW on the calibration sample.

Prediction is advisory: it decides which dispatch a request rides, never
what the answer is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..layers.mlp import dense_stack, init_dense_stack
from ..optim.adamw import AdamWConfig, init_adamw, make_train_step
from ..utils import resolve_device


@dataclasses.dataclass(frozen=True)
class EffortConfig:
    """Shape + training hyperparameters for the effort MLP."""
    dim: int                      # query dimensionality d (features are d+2)
    hidden: tuple = (32, 16)      # dense_stack hidden widths
    lr: float = 1e-2
    steps: int = 300
    weight_decay: float = 0.0

    @property
    def n_features(self) -> int:
        return self.dim + 2

    @property
    def n_layers(self) -> int:
        return len(self.hidden) + 1


def effort_features(queries, radii, device=None) -> torch.Tensor:
    """(Q, d) queries + (Q,)/scalar radii -> (Q, d+2) f32 feature rows
    ``[q, log1p(r), ||q||]``, on ``device`` (default: the queries' own, or
    the CPU for numpy queries)."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    r = torch.as_tensor(radii, dtype=torch.float32, device=q.device).expand(q.shape[0])
    nrm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.cat([q, torch.log1p(r)[:, None], nrm], dim=-1)


def init_effort(cfg: EffortConfig, *, generator=None, device="cuda") -> dict:
    """The MLP's tensors (``w{i}``, ``b{i}``) drawn by ``init_dense_stack``."""
    stack = init_dense_stack((cfg.n_features,) + tuple(cfg.hidden) + (1,),
                             generator=generator, device=device)
    return {k: v.detach() for k, v in stack.named_parameters()}


def effort_forward(params: dict, feats: torch.Tensor, cfg: EffortConfig,
                   mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Normalized features -> predicted ``log1p(count)`` (Q,)."""
    return dense_stack(params, (feats - mu) / sigma, cfg.n_layers)[:, 0]


def effort_loss(params, batch: dict, cfg: EffortConfig, mu, sigma):
    """MSE on log1p counts; ``(loss, metrics)`` for make_train_step."""
    err = effort_forward(params, batch["feats"], cfg, mu, sigma) - batch["log_count"]
    return torch.mean(torch.square(err)), {"mae_log": torch.mean(torch.abs(err))}


class EffortPredictor:
    """A fitted effort model: feature statistics + MLP tensors, all on one
    device. Build one with :meth:`fit` from (queries, radii, observed
    counts), then call :meth:`predict` in the admission path."""

    def __init__(self, cfg: EffortConfig, params: dict,
                 mu: torch.Tensor, sigma: torch.Tensor):
        self.cfg = cfg
        self.params = params
        self.mu = mu
        self.sigma = sigma

    @property
    def device(self) -> torch.device:
        return self.mu.device

    @staticmethod
    def fit(queries, radii, counts, cfg: EffortConfig | None = None,
            seed: int = 0, *, device="cuda",
            init_params: dict | None = None) -> "EffortPredictor":
        """Full-batch AdamW fit of log1p(count) on the calibration sample,
        on ``device``. The initial weights are drawn from a
        ``torch.Generator`` seeded with ``seed``, or taken from
        ``init_params`` (e.g. ``convert.effort_params_from_jax``)."""
        dev = resolve_device(device)
        q = torch.as_tensor(np.asarray(queries, np.float32), device=dev)
        if cfg is None:
            cfg = EffortConfig(dim=int(q.shape[1]))
        feats = effort_features(q, np.asarray(radii, np.float32))
        mu = torch.mean(feats, dim=0)
        sigma = torch.clamp(torch.std(feats, dim=0, correction=0), min=1e-6)
        y = torch.log1p(torch.as_tensor(np.asarray(counts, np.float32).reshape(-1),
                                        device=dev))
        batch = {"feats": feats, "log_count": y}
        if init_params is None:
            params = init_effort(cfg, generator=torch.Generator(device=dev).manual_seed(seed),
                                 device=dev)
        else:
            params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev).clone()
                      for k, v in init_params.items()}
        opt_cfg = AdamWConfig(lr=cfg.lr, weight_decay=cfg.weight_decay,
                              schedule="cosine", warmup_steps=10,
                              total_steps=cfg.steps)
        opt_state = init_adamw(params, opt_cfg)
        step = make_train_step(lambda p, b: effort_loss(p, b, cfg, mu, sigma), opt_cfg)
        for _ in range(cfg.steps):
            params, opt_state, _ = step(params, opt_state, batch)
        return EffortPredictor(cfg, params, mu, sigma)

    @torch.no_grad()
    def predict_log1p(self, queries, radii) -> torch.Tensor:
        """(Q,) predicted log1p(match count), on the predictor's device (one
        host-to-device copy per argument given as numpy)."""
        feats = effort_features(queries, radii, device=self.device)
        return effort_forward(self.params, feats, self.cfg, self.mu, self.sigma)

    def predict(self, queries, radii) -> np.ndarray:
        """(Q,) predicted match counts (>= 0, host array)."""
        logc = self.predict_log1p(queries, radii).cpu().numpy()
        return np.maximum(np.expm1(logc), 0.0)

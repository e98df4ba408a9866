"""AdamW + schedules + global-norm clipping + gradient accumulation.

An optimizer over parameter trees: dicts (possibly nested) of tensors,
walked in sorted key order as the reference's pytrees are; the update
writes the parameters and moments in place.
Gradients come from ``torch.autograd``. The arithmetic is the reference's:
weight decay inside the update, ``p - lr * (m_hat / (sqrt(v_hat) + eps) +
wd * p)``; bias corrections ``1 - b ** step`` in f32; clipping by the global
f32 norm with a floor of 1e-12; warm-up and cosine/linear schedules in f32.
(``torch.optim.AdamW`` differs in its schedule, its clipping and its state
layout.) Moments are kept in the parameter dtype unless ``moment_dtype``
says otherwise; gradient accumulation sums in ``accum_dtype`` (f32 when
None).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

import torch

UPDATE_CHUNK = 1 << 26   # elements the update (or a leaf's norm) computes at once


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: Optional[Any] = None   # None -> match param dtype
    accum_dtype: Optional[Any] = None    # grad-accumulation dtype (None -> f32)
    schedule: str = "cosine"             # cosine | linear | constant
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), as a new tree."""
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
            1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - (1 - cfg.min_lr_frac) * frac
    else:
        decay = torch.ones((), device=s.device)
    return cfg.lr * warm * decay


def _square_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of squares of a leaf; a leaf above ``UPDATE_CHUNK``
    elements chunk by chunk (a full-size square of a 10 GB embedding table
    would not fit beside its gradient and moments)."""
    if x.numel() <= UPDATE_CHUNK:
        return torch.sum(torch.square(x.to(torch.float32)))
    flat = x.reshape(-1)
    return torch.sum(torch.stack([torch.sum(torch.square(flat[i:i + UPDATE_CHUNK].to(
        torch.float32))) for i in range(0, flat.numel(), UPDATE_CHUNK)]))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.stack([_square_sum(x) for x in _leaves(tree)])))


def _clip_scale(tree, max_norm: float):
    """(the factor that clips ``tree`` to ``max_norm``, its global norm)."""
    gn = global_norm(tree)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0), gn


def _clip(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x.to(torch.float32) * scale).to(x.dtype)


def clip_by_global_norm(tree, max_norm: float):
    scale, gn = _clip_scale(tree, max_norm)
    return _map(lambda x: _clip(x, scale), tree), gn


def init_adamw(params, cfg: AdamWConfig) -> dict:
    def zeros_like(p):
        return torch.zeros(p.shape, dtype=cfg.moment_dtype or p.dtype, device=p.device)
    step = torch.zeros((), dtype=torch.int32, device=_leaves(params)[0].device)
    return {"m": _map(zeros_like, params), "v": _map(zeros_like, params), "step": step}


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: AdamWConfig):
    """Updates ``params`` and the moments of ``state`` in place (the
    reference's jit donates them) and returns (params, new_state, metrics).
    Each leaf is computed ``UPDATE_CHUNK`` elements at a time, so the update
    needs no second copy of the state and its temporaries stay a few
    chunks."""
    scale, gn = _clip_scale(grads, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    def upd(p, g, m, v):
        gf = _clip(g, scale).to(torch.float32)
        mf = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * gf * gf
        mhat = mf / b1c
        vhat = vf / b2c
        pf = p.to(torch.float32)
        pf = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * pf)
        return pf.to(p.dtype), mf.to(m.dtype), vf.to(v.dtype)

    for p, g, m, v in zip(_leaves(params), _leaves(grads), _leaves(state["m"]),
                          _leaves(state["v"])):
        flat = [p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)]
        for i in range(0, flat[0].numel(), UPDATE_CHUNK):
            part = [t[i:i + UPDATE_CHUNK] for t in flat]
            for dst, new in zip((part[0], part[2], part[3]), upd(*part)):
                dst.copy_(new)
    return (params, {"m": state["m"], "v": state["v"], "step": step},
            {"grad_norm": gn, "lr": lr})


def make_train_step(
    loss_fn: Callable,
    opt_cfg: AdamWConfig,
    *,
    accum_steps: int = 1,
    grad_transform: Optional[Callable] = None,
):
    """Builds ``train_step(params, opt_state, batch) -> (params, state,
    metrics)``. ``loss_fn(params, batch)`` returns ``(loss, metrics)``.

    ``accum_steps > 1`` splits the batch's leading axis into micro-batches
    and averages their gradients (the fixed-memory large-batch recipe).
    ``params`` and ``opt_state`` are updated in place (``adamw_update``)."""
    def grads_of(params, batch):
        leaves = _leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        tree = _map(lambda _: next(it), params)
        with torch.enable_grad():
            loss, metrics = loss_fn(tree, batch)
            grads = torch.autograd.grad(loss, live)
        it = iter(grads)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                _map(lambda _: next(it), params))

    def train_step(params, opt_state, batch):
        if accum_steps > 1:
            micro = _map(lambda x: x.reshape((accum_steps, -1) + tuple(x.shape[1:])),
                         batch)
            adt = opt_cfg.accum_dtype or torch.float32
            gsum = _map(lambda p: torch.zeros(p.shape, dtype=adt, device=p.device), params)
            lsum = torch.zeros((), device=_leaves(params)[0].device)
            for i in range(accum_steps):
                loss, _, grads = grads_of(params, _map(lambda x: x[i], micro))
                gsum = _map(lambda a, g: a + g.to(a.dtype), gsum, grads)
                lsum = lsum + loss
            grads = _map(lambda g: g / accum_steps, gsum)
            loss = lsum / accum_steps
            metrics = {}
        else:
            loss, metrics, grads = grads_of(params, batch)
        if grad_transform is not None:
            grads = grad_transform(grads)
        params, opt_state, opt_metrics = adamw_update(params, grads, opt_state, opt_cfg)
        return params, opt_state, {"loss": loss, **metrics, **opt_metrics}

    return train_step

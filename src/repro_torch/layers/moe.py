"""Mixture-of-Experts layer: top-k routing, shared experts, sort-based
capacity dispatch (qwen2-moe: 60 routed top-4 + 4 shared; deepseek-v2: 160
routed top-6 + 2 shared).

The dispatch is the reference's, step for step, because which assignments
are dropped decides the output:

  1. route in f32: softmax over the router logits, top-k, the weights
     renormalized (``normalize_weights``); the Switch aux loss from each
     token's primary expert;
  2. split the tokens into ``groups = max(1, min(n_groups, T // 2048))``
     groups, padding the last with tokens of weight 0 routed to expert 0;
  3. per group, flatten the (token, k) assignments, stable-sort them by
     expert id and number each within its expert's run (a ``cummax`` over
     the run starts); an assignment at position ``pos < C`` takes slot
     ``pos`` of its expert, the rest are dropped (``dropped_frac`` counts
     every assignment, the padding tokens' too);
  4. run every (allocated) expert on its ``C`` slots of every group: three
     batched products over an (E, G·C, D) buffer;
  5. give each token back its k weighted outputs, summed in ascending
     expert id (the reference's scatter order) in the input's dtype, and
     add the shared experts, a plain gated MLP.

The combine gathers, it does not scatter-add: atomics would make a bf16
sum depend on the order the card runs them in, and two calls must agree
bit for bit. The reference's five ``shard_activation`` pins stand at the
same steps (the groups over DP, the expert buffer and its output over TP,
the output over DP and TP); the port's buffer is (E, G·C, D), so its pins
name the expert axis first. Outside a mesh scope they are identities.

The router stays f32 (the reference casts it to f32 at every use), the
expert weights are stored in the model's dtype.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from ..dist.sharding import (
    DP, TP, _axis_size, _placements, gathered, is_dtensor, lay_out, local_block, mesh_axes,
    shard_activation, summed)
from ..utils import resolve_device
from .mlp import ACTS, MLP, MLPConfig, draw_dense, mlp

GROUP_TOKENS = 2048   # tokens a dispatch group holds at least (the reference's)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    d_model: int
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    act: str = "silu"
    router_dtype: str = "float32"
    normalize_weights: bool = True  # the transformer never sets it (ROADMAP.md §3)
    n_experts_alloc: int = 0        # physical rows (qwen2-moe: 60 logical, 64 allocated)
    n_groups: int = 1               # dispatch token groups

    @property
    def e_alloc(self) -> int:
        return max(self.n_experts, self.n_experts_alloc)

    def shared_cfg(self) -> MLPConfig:
        return MLPConfig(d_model=self.d_model, d_ff=self.n_shared * self.d_expert,
                         act=self.act, gated=True)


class MoE(nn.Module):
    """``router`` (d, E) f32; ``w_gate``/``w_up`` (E_alloc, d, f) and
    ``w_down`` (E_alloc, f, d); ``shared`` the shared experts as one gated
    ``MLP`` of width n_shared·f, or None: the reference's layouts."""

    def __init__(self, router, w_gate, w_up, w_down, shared: MLP | None = None):
        super().__init__()
        for name, t in (("router", router), ("w_gate", w_gate), ("w_up", w_up),
                        ("w_down", w_down)):
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))
        self.shared = shared


def init_moe(cfg: MoEConfig, *, generator=None, device="cuda",
             dtype=torch.float32) -> MoE:
    """Fan-in truncated-normal weights drawn in f32: the router kept in f32,
    the experts stored in ``dtype``."""
    dev = resolve_device(device, meta=True)
    draw = dict(generator=generator, device=dev, dtype=dtype)
    e, d, f = cfg.e_alloc, cfg.d_model, cfg.d_expert
    router = draw_dense((d, cfg.n_experts), d, generator=generator, device=dev,
                        dtype=torch.float32)
    w_gate = draw_dense((e, d, f), d, **draw)
    w_up = draw_dense((e, d, f), d, **draw)
    w_down = draw_dense((e, f, d), f, **draw)
    shared = None
    if cfg.n_shared > 0:
        fs = cfg.n_shared * f
        sg = draw_dense((d, fs), d, **draw)
        su = draw_dense((d, fs), d, **draw)
        shared = MLP(su, draw_dense((fs, d), fs, **draw), sg)
    return MoE(router, w_gate, w_up, w_down, shared)


def _position_in_run(sorted_e: torch.Tensor) -> torch.Tensor:
    """For ids sorted along the last dim, each one's index within its run."""
    idx = torch.arange(sorted_e.shape[-1], device=sorted_e.device).expand_as(sorted_e)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    run_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    return idx - run_start


def route(params: MoE, xt: torch.Tensor, cfg: MoEConfig):
    """xt (T, D) -> (probs (T, E), top_w (T, K), top_i (T, K)), all in f32
    but the int64 ids: the router's decision for each token."""
    return _route(params.router, xt, cfg)


def _route(router: torch.Tensor, xt: torch.Tensor, cfg: MoEConfig):
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.normalize_weights:
        top_w = top_w / torch.clamp(top_w.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, top_w, top_i


def dispatch_plan(t: int, cfg: MoEConfig, capacity: int | None = None) -> tuple[int, int, int]:
    """(groups, tokens a group after padding, capacity) for T tokens."""
    groups = max(1, min(cfg.n_groups, t // GROUP_TOKENS))
    tg = -(-t // groups)
    if capacity is None:
        capacity = int(cfg.capacity_factor * tg * cfg.top_k / cfg.n_experts) + 1
    return groups, tg, capacity


def _dispatch(xp, wp, ip, ea: int, c: int):
    """A block of groups: xp (G, tg, D), top-k weights and ids wp, ip (G,
    tg, K) -> (the expert buffer (E_alloc, G·C, D), keep (G, tg·K), the
    combine's plan). The buffer is (E_alloc, G, C) slots deep, so each
    expert's slots are one contiguous (G·C, D) block; dropped assignments
    go to a spare last row, which the experts never read."""
    groups, tg, d = xp.shape
    k = ip.shape[-1]
    # stable sort by expert, a slot for the first C of each run
    sorted_e, order = torch.sort(ip.reshape(groups, tg * k), dim=-1, stable=True)
    pos = _position_in_run(sorted_e)
    keep = pos < c
    g_idx = torch.arange(groups, device=xp.device)[:, None]
    rows = torch.where(keep, sorted_e * (groups * c) + g_idx * c + pos, ea * groups * c)
    buf = xp.new_zeros((ea * groups * c + 1, d))
    buf[rows.reshape(-1)] = xp.reshape(groups * tg, d)[(g_idx * tg + order // k).reshape(-1)]
    # each assignment's row, back in (token, k) order, its k rows in
    # ascending expert id (the reference's scatter order)
    row_tk = torch.empty_like(rows).scatter_(-1, order, rows).reshape(groups * tg, k)
    by_e = torch.argsort(ip.reshape(groups * tg, k), dim=-1, stable=True)
    plan = (row_tk.gather(-1, by_e), wp.reshape(groups * tg, k).gather(-1, by_e))
    return buf[:-1].reshape(ea, groups * c, d), keep, plan


def _combine(out, plan) -> torch.Tensor:
    """out (E_alloc·G·C + 1, D), its last row 0, the plan of ``_dispatch``
    -> (G·tg, D): each token's k weighted outputs summed in ascending
    expert id, in out's dtype."""
    row_tk, w_tk = plan
    w_tk = w_tk.to(out.dtype)
    y = out.new_zeros((row_tk.shape[0], out.shape[1]))
    for j in range(row_tk.shape[1]):
        y = y + out[row_tk[:, j]] * w_tk[:, j, None]
    return y


def moe_layer(params: MoE, x: torch.Tensor, cfg: MoEConfig,
              capacity: int | None = None):
    """x (B, S, D) -> (y (B, S, D), {"aux_loss", "dropped_frac"}), both f32
    scalars on x's device.

    On a mesh (x a DTensor) the layer keeps the reference's layouts, the
    groups over DP (pin 1) and the experts over TP (pins 2-4), and routes,
    dispatches and combines on each rank's groups, plain tensors: every
    step there is per token or per group, and DTensor has no rules for some
    of them (the sort's run positions, the scatter into the buffer) in
    torch 2.11. The router is gathered whole, its gradient a partial sum
    over DP; the aux loss's sums are summed over DP; the experts' products
    are DTensor ``bmm``s over the buffer, whose G·C dim is laid out as the
    groups; the combine reads every expert's outputs for the rank's groups
    (gathered over TP). When the groups do not divide DP (decode's single
    group, or padded groups) every rank routes every token.""" 
    dt = x.dtype
    b, s, d = x.shape
    t = b * s
    on_mesh = is_dtensor(x)
    xt = x.reshape(t, d)
    e, k, ea = cfg.n_experts, cfg.top_k, cfg.e_alloc
    groups, tg, c = dispatch_plan(t, cfg, capacity)
    pad = groups * tg - t      # padding tokens: weight 0, expert 0

    def _g(v):   # groups over DP; a single group (decode) is left alone
        return shard_activation(v, DP, *([None] * (v.ndim - 1))) if groups > 1 else v

    def _grouped(v):
        return (F.pad(v, (0, 0, 0, pad)) if pad else v).reshape((groups, tg, -1))

    if on_mesh:
        from torch.distributed.tensor import DTensor
        mesh = x.device_mesh
        split = groups > 1 and not pad and groups % _axis_size(mesh, mesh_axes(mesh)[0]) == 0
        ax = (DP,) if split else ()
        # the rank's groups (pin 1's layout), routed on the rank
        xt_l = local_block(lay_out(xt, *ax))
        n_l = xt_l.shape[0]
        probs, top_w, top_i = _route(gathered(params.router, split), xt_l, cfg)
        count = summed(F.one_hot(top_i[:, 0], e).float().sum(dim=0), mesh, split)
        aux_loss = e * torch.sum((count / t) * (summed(probs.sum(dim=0), mesh, split) / t))
        g_l = groups * n_l // t   # the rank's groups (all, unpadded ones, when split)
        h, keep, plan = _dispatch(*((F.pad(v, (0, 0, 0, pad)) if pad else v).reshape(g_l, tg, -1)
                                    for v in (xt_l, top_w, top_i)), ea, c)
        h = DTensor.from_local(h, mesh, _placements(mesh, (None,) + ax), run_check=False)
        keep = DTensor.from_local(keep, mesh, _placements(mesh, ax), run_check=False)
    else:
        probs, top_w, top_i = route(params, xt, cfg)
        frac = F.one_hot(top_i[:, 0], e).float().mean(dim=0)   # primary assignment
        aux_loss = e * torch.sum(frac * probs.mean(dim=0))
        h, keep, plan = _dispatch(_g(_grouped(xt)), _g(_grouped(top_w)), _g(_grouped(top_i)),
                                  ea, c)

    # ---- the experts: three batched products
    if groups > 1:
        h = shard_activation(h, TP, DP, None)            # (E, G·C, D)
    else:
        h = shard_activation(h, TP, None, None)
    g = ACTS[cfg.act](torch.bmm(h, params.w_gate.to(dt)))
    u = torch.bmm(h, params.w_up.to(dt))
    # bmm(out=) records no autograd node, and writes no DTensor pin
    if torch.is_grad_enabled() or on_mesh:
        yb = shard_activation(torch.bmm(g * u, params.w_down.to(dt)), TP,
                              DP if groups > 1 else None, None)
        if on_mesh:   # every expert's outputs for the rank's groups
            yb = local_block(lay_out(yb, None, *ax))
        out = torch.cat([yb.reshape(-1, d), yb.new_zeros((1, d))])
    else:
        out = x.new_empty((ea * groups * c + 1, d))
        torch.bmm(g * u, params.w_down.to(dt), out=out[:-1].view(ea, groups * c, d))
        out[-1] = 0                # the dropped assignments' row

    # ---- combine: each assignment's row, summed in ascending expert id
    y = _combine(out, plan)
    if on_mesh:
        y = DTensor.from_local(y, mesh, _placements(mesh, ax), run_check=False)
    y = _g(y.reshape(groups, tg, d)).reshape(groups * tg, d)
    y = shard_activation(y[:t] if pad else y, DP, TP)

    if params.shared is not None:   # on the unpadded tokens (ROADMAP.md §3)
        y = y + mlp(params.shared, xt, cfg.shared_cfg())

    dropped = 1.0 - keep.float().mean()
    return y.reshape(b, s, d), {"aux_loss": aux_loss, "dropped_frac": dropped}

"""Carry a built index across from the JAX package as plain arrays.

The reference's ``RangeSearchEngine`` holds ``points``, ``graph.neighbors``
and ``start_ids``; given those as numpy arrays, ``engine_from_arrays``
builds this package's engine over the identical index, so both packages
can be run on the same graph. An int8 reference corpus comes across as its
``codes`` and ``meta`` beside the raw ``points``, so both packages search
the identical quantized corpus. ``recsys_params_from_jax`` carries a JAX
two-tower parameter tree across, ``transformer_params_from_jax`` a JAX LM's,
``effort_params_from_jax`` the effort regressor's.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.corpus import QuantizedCorpus
from .core.engine import RangeSearchEngine
from .core.graph import Graph
from .layers.attention import GQA
from .layers.mlp import MLP, DenseStack
from .models.recsys import RecsysConfig, Tower, TwoTower
from .models.transformer import Block, Transformer, TransformerConfig, _check_supported
from .utils import resolve_device


def engine_from_arrays(points, neighbors, start_ids, metric: str = "l2",
                       device="cuda", codes=None, meta=None) -> RangeSearchEngine:
    dev = resolve_device(device)
    pts = torch.as_tensor(np.array(points, np.float32), device=dev).contiguous()
    nbrs = torch.as_tensor(np.array(neighbors, np.int32), device=dev)
    starts = torch.as_tensor(np.array(start_ids, np.int32), device=dev)
    corpus = pts
    if (codes is None) != (meta is None):
        raise ValueError("an int8 corpus needs both codes and meta")
    if codes is not None:
        corpus = QuantizedCorpus(
            codes=torch.as_tensor(np.array(codes, np.int8), device=dev).contiguous(),
            meta=torch.as_tensor(np.array(meta, np.float32), device=dev).contiguous(),
            raw=pts)
    return RangeSearchEngine(points=corpus,
                             graph=Graph(neighbors=nbrs.contiguous()),
                             start_ids=starts.reshape(-1), metric=metric)


def recsys_params_from_jax(params: dict, cfg: RecsysConfig,
                           device="cuda") -> TwoTower:
    """The reference's ``init_recsys`` tree for a two-tower model, given as
    numpy arrays ({"user"|"item": {"tables": (F, V, d), "mlp": {"w{i}":
    (in, out), "b{i}": (out,)}}}), as the port's ``TwoTower``. The port
    keeps the (in, out) weight layout, so nothing is transposed."""
    if cfg.kind != "two_tower":
        raise NotImplementedError(f"recsys kind {cfg.kind!r}")
    dev = resolve_device(device)

    def tensor(x):
        return torch.as_tensor(np.array(x, np.float32), device=dev).contiguous()

    def tower(p):
        mlp = p["mlp"]
        n = len(mlp) // 2
        stack = DenseStack([tensor(mlp[f"w{i}"]) for i in range(n)],
                           [tensor(mlp[f"b{i}"]) for i in range(n)])
        return Tower(tensor(p["tables"]), stack, cfg.dtype)

    return TwoTower(tower(params["user"]), tower(params["item"]))


def transformer_params_from_jax(params: dict, cfg: TransformerConfig,
                                device="cuda") -> Transformer:
    """The reference's ``init_transformer`` tree, given as numpy arrays with
    the layers stacked on axis 0 ({"embed": (V, d), "final_norm": (d,),
    "layers": {"attn": {"wq": (L, d, H, dh), ...}, "attn_norm": (L, d),
    "mlp": {...}, ...}}, "unembed" when untied), as the port's
    ``Transformer``. Layouts are kept, so nothing is transposed: the layers
    are unstacked, dense weights cast to ``cfg.dtype`` (as the reference
    casts them at each use) and norm scales kept in f32."""
    _check_supported(cfg)
    dev = resolve_device(device)

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x, np.float32), device=dev).to(dtype).contiguous()

    def dense(x):
        return tensor(x, cfg.dtype)

    lp = params["layers"]
    norm_names = [n for n in ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm")
                  if n in lp]
    layers = []
    for i in range(cfg.n_layers):
        a, m = lp["attn"], lp["mlp"]
        qk = [tensor(a[n][i]) for n in ("q_norm", "k_norm") if n in a]
        attn = GQA(dense(a["wq"][i]), dense(a["wk"][i]), dense(a["wv"][i]),
                   dense(a["wo"][i]), *qk)
        ffn = MLP(dense(m["w_up"][i]), dense(m["w_down"][i]),
                  dense(m["w_gate"][i]) if "w_gate" in m else None)
        layers.append(Block(attn, ffn, {n: tensor(lp[n][i]) for n in norm_names}))
    unembed_table = None if cfg.tie_embeddings else dense(params["unembed"])
    return Transformer(dense(params["embed"]), tensor(params["final_norm"]), layers,
                       unembed_table)


def effort_params_from_jax(params: dict, device="cuda") -> dict:
    """The reference's ``init_effort`` / fitted ``EffortPredictor.params``
    ({"w{i}": (in, out), "b{i}": (out,)}, numpy) as the port's effort
    tensors: the same (in, out) layout, so nothing is transposed."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev).contiguous()
            for k, v in params.items()}

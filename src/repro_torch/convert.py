"""Carry a built index across from the JAX package as plain arrays.

The reference's ``RangeSearchEngine`` holds ``points``, ``graph.neighbors``
and ``start_ids``; given those as numpy arrays, ``engine_from_arrays``
builds this package's engine over the identical index, so both packages
can be run on the same graph. An int8 reference corpus comes across as its
``codes`` and ``meta`` beside the raw ``points``, so both packages search
the identical quantized corpus. ``sharded_from_arrays`` does the same for a
reference ``ShardedCorpus`` (its stacked per-shard arrays), keeping only a
rank's own shards when given a mesh. ``recsys_params_from_jax`` carries a JAX
two-tower parameter tree across, ``transformer_params_from_jax`` a JAX LM's,
``effort_params_from_jax`` the effort regressor's.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.corpus import QuantizedCorpus
from .core.engine import RangeSearchEngine
from .core.graph import Graph
from .core.labels import as_label_rows
from .layers.attention import GQA, MLA
from .layers.mlp import MLP, DenseStack
from .layers.moe import MoE
from .models.recsys import RecsysConfig, Tower, TwoTower
from .models.transformer import Block, Transformer, TransformerConfig
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


def sharded_from_arrays(points, neighbors, start_ids, offsets, n_total: int, *,
                        codes=None, meta=None, labels=None, mesh=None,
                        model_axis: str = "model", device="cuda"):
    """A reference ``ShardedCorpus`` given as numpy arrays, stacked on the
    shard axis: ``points`` (S, n, d) f32 (the raw rows of an int8 corpus),
    ``neighbors`` (S, n, R), ``start_ids`` (S, k), ``offsets`` (S,),
    ``n_total``; an int8 corpus adds ``codes`` (S, n, d) and ``meta``
    (S, n, 3); ``labels`` (S, n, W) uint32 words. With ``mesh``, only the
    shards of this rank's model coordinate are kept (``build_sharded``'s
    layout)."""
    from .dist.sharded_engine import ShardedCorpus, _held_shards

    dev = resolve_device(device)
    if (codes is None) != (meta is None):
        raise ValueError("an int8 corpus needs both codes and meta")
    n_shards = np.asarray(offsets).shape[0]
    held = _held_shards(mesh, n_shards, model_axis)
    sel = slice(held.start, held.stop)

    def tensor(x, dtype):
        return torch.as_tensor(np.array(np.asarray(x)[sel], dtype), device=dev).contiguous()

    pts = tensor(points, np.float32)
    if codes is not None:
        pts = QuantizedCorpus(codes=tensor(codes, np.int8), meta=tensor(meta, np.float32),
                              raw=pts)
    return ShardedCorpus(
        points=pts, neighbors=tensor(neighbors, np.int32),
        start_ids=tensor(start_ids, np.int32).reshape(len(held), -1),
        offsets=tensor(offsets, np.int32), n_total=int(n_total),
        labels=None if labels is None else as_label_rows(np.asarray(labels)[sel], dev),
        first_shard=held.start, total_shards=n_shards)


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


_NORMS = ("attn_norm", "ffn_norm", "post_attn_norm", "post_ffn_norm")
_F32_LEAVES = ("q_norm", "k_norm", "kv_norm", "router")   # kept f32, as norm scales


def transformer_params_from_jax(params: dict, cfg: TransformerConfig,
                                device="cuda") -> Transformer:
    """The reference's ``init_transformer`` tree, given as numpy arrays, as
    the port's ``Transformer``: ``embed`` (V, d), ``final_norm`` (d,), the
    leading dense layers ``dense_layer{i}`` (unstacked), ``layers`` (the
    rest, stacked on axis 0: ``attn`` GQA or MLA leaves, the norms, ``mlp``
    or ``moe`` with its ``shared`` experts), ``unembed`` when untied.
    Layouts are kept, so nothing is transposed: the stacked layers are
    unstacked after the dense ones, weights cast to ``cfg.dtype`` (as the
    reference casts them at each use), norm scales and routers kept in f32."""
    dev = resolve_device(device)

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.array(x, np.float32), device=dev).to(dtype).contiguous()

    def leaf(name, x):
        return tensor(x) if name in _F32_LEAVES else tensor(x, cfg.dtype)

    def mlp(m):
        return MLP(leaf("w_up", m["w_up"]), leaf("w_down", m["w_down"]),
                   leaf("w_gate", m["w_gate"]) if "w_gate" in m else None)

    def block(lp):
        a = {n: leaf(n, x) for n, x in lp["attn"].items()}
        if cfg.attn_kind == "mla":
            attn = MLA(**a)
        else:
            attn = GQA(a["wq"], a["wk"], a["wv"], a["wo"], a.get("q_norm"), a.get("k_norm"))
        if "moe" in lp:
            m = lp["moe"]
            ffn = MoE(*(leaf(n, m[n]) for n in ("router", "w_gate", "w_up", "w_down")),
                      mlp(m["shared"]) if "shared" in m else None)
        else:
            ffn = mlp(lp["mlp"])
        return Block(attn, ffn, {n: tensor(lp[n]) for n in _NORMS if n in lp})

    def unstack(tree, i):
        return {k: unstack(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}

    layers = [block(params[f"dense_layer{i}"]) for i in range(cfg.first_dense)]
    layers += [block(unstack(params["layers"], i))
               for i in range(cfg.n_layers - cfg.first_dense)]
    unembed_table = None if cfg.tie_embeddings else leaf("unembed", params["unembed"])
    return Transformer(leaf("embed", params["embed"]), tensor(params["final_norm"]),
                       layers, unembed_table)


def effort_params_from_jax(params: dict, device="cuda") -> dict:
    """The reference's ``init_effort`` / fitted ``EffortPredictor.params``
    ({"w{i}": (in, out), "b{i}": (out,)}, numpy) as the port's effort
    tensors: the same (in, out) layout, so nothing is transposed."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.array(v, np.float32), device=dev).contiguous()
            for k, v in params.items()}

"""Carry a built index across from the JAX package as plain arrays.

The reference's ``RangeSearchEngine`` holds ``points``, ``graph.neighbors``
and ``start_ids``; given those as numpy arrays, ``engine_from_arrays``
builds this package's engine over the identical index, so both packages
can be run on the same graph. An int8 reference corpus comes across as its
``codes`` and ``meta`` beside the raw ``points``, so both packages search
the identical quantized corpus. ``sharded_from_arrays`` does the same for a
reference ``ShardedCorpus`` (its stacked per-shard arrays), keeping only a
rank's own shards when given a mesh. ``recsys_params_from_jax`` carries a JAX
recsys parameter tree across (every kind), ``transformer_params_from_jax`` a
JAX LM's (as served, or as f32 masters for training),
``gcn_params_from_jax`` a GCN's, ``effort_params_from_jax`` the effort
regressor's.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.corpus import QuantizedCorpus
from .core.engine import RangeSearchEngine
from .core.graph import Graph
from .core.labels import as_label_rows
from .layers.mlp import DenseStack
from .models.recsys import RecsysConfig, Tower, TwoTower
from .models.transformer import Transformer, TransformerConfig, transformer_from_tree
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


def _tensors(node, dev):
    """A tree of numpy arrays as a tree of f32 tensors on ``dev``."""
    if isinstance(node, dict):
        return {k: _tensors(v, dev) for k, v in node.items()}
    return torch.as_tensor(np.array(node, np.float32), device=dev).contiguous()


def recsys_params_from_jax(params: dict, cfg: RecsysConfig, device="cuda"):
    """The reference's ``init_recsys`` tree, given as numpy arrays, as the
    port's model of ``cfg.kind``: two-tower ({"user"|"item": {"tables":
    (F, V, d), "mlp": {"w{i}": (in, out), "b{i}": (out,)}}}) as a
    ``TwoTower``; Wide&Deep, DLRM and AutoInt as the same tree of tensors.
    The port keeps the (in, out) weight layout, so nothing is transposed;
    ``models.recsys.recsys_tree`` of the result is the same tree."""
    dev = resolve_device(device)
    tree = _tensors(params, dev)
    if cfg.kind != "two_tower":
        return tree

    def tower(p):
        mlp = p["mlp"]
        n = len(mlp) // 2
        stack = DenseStack([mlp[f"w{i}"] for i in range(n)], [mlp[f"b{i}"] for i in range(n)])
        return Tower(p["tables"], stack, cfg.dtype)

    return TwoTower(tower(tree["user"]), tower(tree["item"]))


def gcn_params_from_jax(params: dict, device="cuda") -> dict:
    """The reference's ``init_gcn`` tree ({"w{i}": (in, out), "b{i}":
    (out,)}, numpy) as the port's: the same dict of f32 tensors."""
    return _tensors(params, resolve_device(device))


def transformer_params_from_jax(params: dict, cfg: TransformerConfig,
                                device="cuda", *, f32_masters: bool = False) -> Transformer:
    """The reference's ``init_transformer`` tree, given as numpy arrays, as
    the port's ``Transformer``: ``embed`` (V, d), ``final_norm`` (d,), the
    leading dense layers ``dense_layer{i}`` (unstacked), ``layers`` (the
    rest, stacked on axis 0: ``attn`` GQA or MLA leaves, the norms, ``mlp``
    or ``moe`` with its ``shared`` experts), ``unembed`` when untied.
    Layouts are kept, so nothing is transposed (``transformer_from_tree``):
    weights cast to ``cfg.dtype``, norm scales and routers kept in f32; with
    ``f32_masters`` every weight stays f32, the reference's own storage, so
    both packages train from the same masters (``transformer_tree`` gives
    the reference's tree back)."""
    return transformer_from_tree(_tensors(params, resolve_device(device)), cfg,
                                 f32_masters=f32_masters)


def effort_params_from_jax(params: dict, device="cuda") -> dict:
    """The reference's ``init_effort`` / fitted ``EffortPredictor.params``
    ({"w{i}": (in, out), "b{i}": (out,)}, numpy) as the port's effort
    tensors: the same (in, out) layout, so nothing is transposed."""
    return _tensors(params, resolve_device(device))

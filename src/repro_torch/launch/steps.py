"""Cell builder: (ArchSpec, ShapeSpec, mesh) -> step function and inputs.

For every one of the 40 assigned (arch x shape) cells (and the engine's
own two), this produces:

* ``fn``: the step function (train_step / prefill / decode_step / serve /
  retrieval scoring / graph train / sharded range search), the port's own;
* ``args``: meta tensors standing in for every input (params, optimizer
  state, batches, KV caches) in the reference's tree structure and dtypes,
  the counterpart of ``ShapeDtypeStruct``: nothing is allocated;
* ``in_shardings`` / ``out_shardings``: ``(mesh, placements)`` leaves from
  ``dist.sharding.bind_shardings`` (what ``distribute_tensor`` takes),
  bound from the arch's rule table and the per-shape activation and cache
  layouts documented inline;
* ``donate``: the reference's donated argument indices, kept for
  comparison. The port has no use for them: its updates are in place
  (``optim.adamw_update`` writes the parameters and moments, decode writes
  the cache), so nothing is double-buffered;
* ``roles``: what each of ``args`` is, ``"params"``, ``"opt_state"`` or
  ``"inputs"`` (the port's own field: it splits a cell's bytes).

The reference's ``Cell.jitted()`` and ``lower()`` (XLA lowering for its dry
run) have no counterpart. A train cell's ``fn`` is ``optim.make_train_step``,
the step ``Trainer(mesh=, param_rules=)`` runs: over DTensor arguments laid
out by ``in_shardings`` it is the sharded step. The other LM, recsys and
GNN cells' ``fn`` take the same DTensor arguments, inside
``activation_sharding(mesh)``; the engine cells' ``fn`` takes a rank's
local blocks (its model coordinate's shards, every query). The dry run
(``launch/dryrun.py``) traces them so, one rank's fake blocks; plain tensors
of ``args``' shapes run them on one device.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable

import torch

from ..configs.common import ArchSpec, ShapeSpec
from ..dist.sharding import Spec, _axis_size, _shape, bind_shardings, mesh_axes, spec_tree
from ..layers.attention import KVCache
from ..layers.common import cast_tree
from ..models import gcn as gcn_mod
from ..models import recsys as rec_mod
from ..models import transformer as tf_mod
from ..optim.adamw import init_adamw, make_train_step
from ..utils import round_up


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_name: str
    fn: Callable
    args: tuple
    in_shardings: Any
    out_shardings: Any = None  # pinned for train cells: params/opt return
                               # in their sharded layout
    donate: tuple = ()         # the reference's donated argnums; unused here
    meta: dict = dataclasses.field(default_factory=dict)
    roles: tuple = ()          # each of args': "params", "opt_state" or "inputs"


TRAIN_ROLES = ("params", "opt_state", "inputs")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _ns(mesh, *spec):
    """The ``(mesh, placements)`` of a spec naming mesh axes per tensor dim
    (the reference's ``NamedSharding(mesh, P(*spec))``)."""
    return bind_shardings(mesh, Spec(spec))


def _dp_size(mesh) -> int:
    dp, _ = mesh_axes(mesh)
    return _axis_size(mesh, dp)


def _all_axes(mesh):
    dp, tp = mesh_axes(mesh)
    return (dp, tp) if not isinstance(dp, tuple) else dp + (tp,)


def _opt_state(params, arch: ArchSpec, p_shard, mesh):
    """(AdamW state on meta, its shardings)."""
    opt = init_adamw(params, arch.opt_cfg)
    return opt, {"m": p_shard, "v": p_shard, "step": _ns(mesh)}


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cache_spec(cfg, batch: int, mesh):
    """Decode-cache layout policy, the reference's:
    * batch shards over dp when divisible;
    * GQA: kv heads shard over tp when there are enough heads, else the
      *sequence* axis shards over tp (flash-decoding style partial softmax);
    * MLA: latent dim shards over tp (512 / 16 = 32).
    * tiny-batch long-context (long_500k): sequence shards over dp too.
    Returns the (k, v) specs, mesh axes per tensor dim."""
    dp, tp = mesh_axes(mesh)
    dp_size = _axis_size(mesh, dp)
    tp_size = _shape(mesh)[tp]
    batch_ax = dp if batch % dp_size == 0 and batch >= dp_size else None
    seq_dp = None if batch_ax is not None else dp
    if cfg.attn_kind == "mla":
        return (None, batch_ax, seq_dp, tp), (None, batch_ax, seq_dp, None)
    if cfg.n_kv % tp_size == 0 and cfg.n_kv >= tp_size:
        spec = (None, batch_ax, seq_dp, tp, None)
    else:  # few kv heads: shard the sequence axis over tp instead
        if seq_dp is None:
            seq_ax = tp
        else:
            dp_axes = seq_dp if isinstance(seq_dp, tuple) else (seq_dp,)
            seq_ax = dp_axes + (tp,)
        spec = (None, batch_ax, seq_ax, None, None)
    return spec, spec


def build_lm_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    cfg = arch.model_cfg
    dp, tp = mesh_axes(mesh)
    params = cast_tree(tf_mod.transformer_tree(
        tf_mod.init_transformer(cfg, device="meta", f32_masters=True), cfg), arch.param_dtype)
    p_shard = bind_shardings(mesh, spec_tree(params, arch.rules, mesh))
    b, s = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        loss = partial(tf_mod.loss_fn, cfg=cfg)
        step = make_train_step(loss, arch.opt_cfg, accum_steps=arch.accum_steps)
        opt, o_shard = _opt_state(params, arch, p_shard, mesh)
        batch = {"tokens": _meta((b, s), torch.int32),
                 "labels": _meta((b, s), torch.int32)}
        b_shard = {"tokens": _ns(mesh, dp, None), "labels": _ns(mesh, dp, None)}
        return Cell(arch.arch_id, shape.name, step, (params, opt, batch),
                    (p_shard, o_shard, b_shard),
                    out_shardings=(p_shard, o_shard, None),
                    donate=(0, 1), meta={"tokens": b * s}, roles=TRAIN_ROLES)

    if shape.kind == "prefill":
        def prefill(params_, tokens):
            # the position as the decode cell takes it: a 0-d int32 tensor
            logits, cache, pos = tf_mod.prefill(tf_mod.model_view(params_, cfg), tokens, cfg, s)
            return logits, cache, torch.tensor(pos, dtype=torch.int32, device=logits.device)
        return Cell(arch.arch_id, shape.name, prefill, (params, _meta((b, s), torch.int32)),
                    (p_shard, _ns(mesh, dp, None)),
                    meta={"tokens": b * s}, roles=("params", "inputs"))

    if shape.kind == "decode":
        def decode_step(params_, token, cache, pos):
            return tf_mod.decode_step(tf_mod.model_view(params_, cfg), token, cache,
                                      int(pos), cfg)
        ck, cv = tf_mod.cache_shapes(cfg, b, s)
        k_spec, v_spec = _lm_cache_spec(cfg, b, mesh)
        c_shard = KVCache(k=_ns(mesh, *k_spec), v=_ns(mesh, *v_spec))
        batch_ax = dp if b % _dp_size(mesh) == 0 and b >= _dp_size(mesh) else None
        return Cell(arch.arch_id, shape.name, decode_step,
                    (params, _meta((b, 1), torch.int32), KVCache(k=ck, v=cv),
                     _meta((), torch.int32)),
                    (p_shard, _ns(mesh, batch_ax, None), c_shard, _ns(mesh)),
                    out_shardings=(None, c_shard),
                    donate=(2,),
                    meta={"tokens": b, "kv_len": s}, roles=("params",) + ("inputs",) * 3)

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gcn_variant(cfg: gcn_mod.GCNConfig, shape: ShapeSpec) -> gcn_mod.GCNConfig:
    """Same 2-layer/16-hidden geometry, input/output dims per dataset."""
    d_feat = shape.d_feat or cfg.d_feat
    n_classes = {"full_graph_sm": 7, "minibatch_lg": 41,
                 "ogb_products": 47, "molecule": 2}.get(shape.name, cfg.n_classes)
    return dataclasses.replace(cfg, d_feat=d_feat, n_classes=n_classes)


def sampled_caps(shape: ShapeSpec) -> tuple[int, int]:
    """(max_nodes, max_edges) of the fanout-sampled subgraph."""
    n, e, front = shape.batch_nodes, 0, shape.batch_nodes
    for f in shape.fanout:
        e += front * f
        front = front * f
        n += front
    return n, e


def build_gnn_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    dp, tp = mesh_axes(mesh)
    all_ax = _all_axes(mesh)

    if shape.kind == "graph_batched":
        cfg = _gcn_variant(dataclasses.replace(arch.model_cfg, d_feat=16), shape)
        params = cast_tree(gcn_mod.init_gcn(cfg, device="meta"), arch.param_dtype)
        p_shard = bind_shardings(mesh, spec_tree(params, arch.rules, mesh))

        def loss(params_, batch_):
            logits = gcn_mod.gcn_batched_graphs(
                params_, batch_["feats"], batch_["edge_src"], batch_["edge_dst"], cfg)
            labels = torch.as_tensor(batch_["labels"], device=logits.device).long()
            lse = torch.logsumexp(logits, dim=-1)
            ll = torch.gather(logits, -1, labels[:, None])[:, 0]
            return torch.mean(lse - ll), {}

        step = make_train_step(loss, arch.opt_cfg)
        opt, o_shard = _opt_state(params, arch, p_shard, mesh)
        g, npg, epg = shape.n_graphs, shape.nodes_per_graph, shape.edges_per_graph
        batch = {"feats": _meta((g, npg, cfg.d_feat), torch.float32),
                 "edge_src": _meta((g, epg), torch.int32),
                 "edge_dst": _meta((g, epg), torch.int32),
                 "labels": _meta((g,), torch.int32)}
        b_shard = {"feats": _ns(mesh, dp, None, None),
                   "edge_src": _ns(mesh, dp, None),
                   "edge_dst": _ns(mesh, dp, None),
                   "labels": _ns(mesh, dp)}
        return Cell(arch.arch_id, shape.name, step, (params, opt, batch),
                    (p_shard, o_shard, b_shard), donate=(0, 1),
                    meta={"edges": g * epg, "nodes": g * npg}, roles=TRAIN_ROLES)

    cfg = _gcn_variant(arch.model_cfg, shape)
    params = cast_tree(gcn_mod.init_gcn(cfg, device="meta"), arch.param_dtype)
    p_shard = bind_shardings(mesh, spec_tree(params, arch.rules, mesh))
    step = make_train_step(partial(gcn_mod.gcn_loss, cfg=cfg), arch.opt_cfg)
    opt, o_shard = _opt_state(params, arch, p_shard, mesh)

    if shape.kind == "graph_sampled":
        n, e = sampled_caps(shape)
    else:
        n, e = shape.n_nodes, shape.n_edges
    # sharding-divisible sizes (data pipelines pad; the model masks padding
    # through -1 labels and edges)
    n = round_up(n, _dp_size(mesh))
    e = round_up(e, _axis_size(mesh, all_ax))
    batch = {"feats": _meta((n, cfg.d_feat), torch.float32),
             "edge_src": _meta((e,), torch.int32),
             "edge_dst": _meta((e,), torch.int32),
             "labels": _meta((n,), torch.int32)}
    # nodes shard over dp; the edge list (the big array) over the whole mesh
    b_shard = {"feats": _ns(mesh, dp, None),
               "edge_src": _ns(mesh, all_ax),
               "edge_dst": _ns(mesh, all_ax),
               "labels": _ns(mesh, dp)}
    return Cell(arch.arch_id, shape.name, step, (params, opt, batch),
                (p_shard, o_shard, b_shard), donate=(0, 1),
                meta={"edges": e, "nodes": n}, roles=TRAIN_ROLES)


# ---------------------------------------------------------------------------
# RecSys cells
# ---------------------------------------------------------------------------

def build_recsys_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    cfg = arch.model_cfg
    dp, tp = mesh_axes(mesh)
    all_ax = _all_axes(mesh)
    params = cast_tree(rec_mod.recsys_tree(rec_mod.init_recsys(cfg, device="meta")),
                       arch.param_dtype)
    p_shard = bind_shardings(mesh, spec_tree(params, arch.rules, mesh))
    b = shape.global_batch
    two_tower = cfg.kind == "two_tower"
    n_mlp = len(cfg.mlp_dims) + 1

    def batch_specs(bsz, ax):
        if two_tower:
            batch = {"user_sparse": _meta((bsz, cfg.n_sparse), torch.int32),
                     "item_sparse": _meta((bsz, cfg.n_sparse_item), torch.int32),
                     "log_q": _meta((bsz,), torch.float32)}
            shard = {"user_sparse": _ns(mesh, ax, None),
                     "item_sparse": _ns(mesh, ax, None),
                     "log_q": _ns(mesh, ax)}
        else:
            batch = {"sparse": _meta((bsz, cfg.n_sparse), torch.int32),
                     "label": _meta((bsz,), torch.float32)}
            shard = {"sparse": _ns(mesh, ax, None), "label": _ns(mesh, ax)}
            if cfg.n_dense:
                batch["dense"] = _meta((bsz, cfg.n_dense), torch.float32)
                shard["dense"] = _ns(mesh, ax, None)
        return batch, shard

    if shape.kind == "train":
        step = make_train_step(partial(rec_mod.recsys_loss, cfg=cfg), arch.opt_cfg)
        opt, o_shard = _opt_state(params, arch, p_shard, mesh)
        batch, b_shard = batch_specs(b, dp)
        return Cell(arch.arch_id, shape.name, step, (params, opt, batch),
                    (p_shard, o_shard, b_shard), donate=(0, 1),
                    meta={"examples": b}, roles=TRAIN_ROLES)

    if shape.kind == "serve":
        if two_tower:
            def fn(params_, user_sparse):
                return rec_mod.tower(params_["user"], user_sparse, cfg.dtype, n_mlp)
            args = (params, _meta((b, cfg.n_sparse), torch.int32))
            shard = (p_shard, _ns(mesh, dp, None))
        else:
            def fn(params_, batch_):
                return rec_mod.recsys_forward(params_, batch_, cfg)
            batch, b_shard = batch_specs(b, dp)
            batch.pop("label")
            b_shard.pop("label")
            args = (params, batch)
            shard = (p_shard, b_shard)
        return Cell(arch.arch_id, shape.name, fn, args, shard, meta={"examples": b},
                    roles=("params", "inputs"))

    if shape.kind == "retrieval":
        nc = round_up(shape.n_candidates, _axis_size(mesh, all_ax))
        if two_tower:
            # one user scored against 1M precomputed item embeddings: the
            # rangescan kernel's shape (brute force); the graph engine serves
            # the same corpus sub-linearly
            def fn(params_, user_sparse, cand_emb):
                u = rec_mod.tower(params_["user"], user_sparse, cfg.dtype, n_mlp)
                return rec_mod.retrieval_topk(u, cand_emb, k=1000)
            args = (params, _meta((1, cfg.n_sparse), torch.int32),
                    _meta((nc, cfg.d_out), torch.float32))
            shard = (p_shard, _ns(mesh, None, None), _ns(mesh, all_ax, None))
        else:
            # bulk-score 1M candidate rows for one context
            def fn(params_, batch_):
                return rec_mod.recsys_forward(params_, batch_, cfg)
            batch, b_shard = batch_specs(nc, all_ax)
            batch.pop("label")
            b_shard.pop("label")
            args = (params, batch)
            shard = (p_shard, b_shard)
        return Cell(arch.arch_id, shape.name, fn, args, shard, meta={"examples": nc},
                    roles=("params",) + ("inputs",) * (len(args) - 1))

    raise ValueError(shape.kind)


# ---------------------------------------------------------------------------
# Range-engine cells (the paper's own system)
# ---------------------------------------------------------------------------

def build_engine_cell(arch: ArchSpec, shape: ShapeSpec, mesh) -> Cell:
    """Shards lay along the model axis (one sub-index a shard, S = the
    model axis's size), query batches along the data axis; ``fn`` takes a
    rank's local blocks (its model coordinate's shards, every query) and
    returns the global (ids, dists, count) of ``dist.sharded_range_search``
    at radius 1.0 for every query."""
    from ..core.corpus import QuantizedCorpus
    from ..dist.sharded_engine import ShardedCorpus, _held_shards, sharded_range_search
    dp, tp = mesh_axes(mesh)
    ecfg = arch.model_cfg
    s_shards = _shape(mesh)[tp]
    n, d, r_deg = ecfg.shard_corpus, ecfg.dim, ecfg.max_degree
    cdt = ecfg.corpus_dtype
    if cdt == "int8":
        # quantized deploy: per-shard int8 codes + metadata + the raw f32
        # vectors the boundary rerank gathers from (core.corpus layout)
        points = QuantizedCorpus(codes=_meta((s_shards, n, d), torch.int8),
                                 meta=_meta((s_shards, n, 3), torch.float32),
                                 raw=_meta((s_shards, n, d), torch.float32))
        pts_shard = QuantizedCorpus(codes=_ns(mesh, tp, None, None),
                                    meta=_ns(mesh, tp, None, None),
                                    raw=_ns(mesh, tp, None, None))
    else:
        points = _meta((s_shards, n, d), getattr(torch, cdt))
        pts_shard = _ns(mesh, tp, None, None)
    held = _held_shards(mesh, s_shards, tp)

    def fn(points, neighbors, start_ids, offsets, queries):
        c = ShardedCorpus(points=points, neighbors=neighbors, start_ids=start_ids,
                          offsets=offsets, n_total=s_shards * n,
                          first_shard=held.start, total_shards=s_shards)
        # per-query radius vector (serving traffic mixes radii per batch)
        radii = torch.full((queries.shape[0],), 1.0, dtype=torch.float32,
                           device=queries.device)
        res = sharded_range_search(mesh=mesh, corpus=c, queries=queries, r=radii,
                                   cfg=ecfg.range_cfg, model_axis=tp, data_axis=dp)
        return res.ids, res.dists, res.count

    args = (points, _meta((s_shards, n, r_deg), torch.int32),
            _meta((s_shards, 1), torch.int32), _meta((s_shards,), torch.int32),
            _meta((shape.global_batch, d), torch.float32))
    shard = (pts_shard, _ns(mesh, tp, None, None), _ns(mesh, tp, None), _ns(mesh, tp),
             _ns(mesh, dp, None))
    return Cell(arch.arch_id, shape.name, fn, args, shard,
                meta={"queries": shape.global_batch, "corpus": s_shards * n},
                roles=("inputs",) * len(args))


# ---------------------------------------------------------------------------

def build_cell(arch: ArchSpec, shape_name: str, mesh) -> Cell:
    shape = arch.shapes[shape_name]
    if arch.family == "lm":
        return build_lm_cell(arch, shape, mesh)
    if arch.family == "gnn":
        return build_gnn_cell(arch, shape, mesh)
    if arch.family == "recsys":
        return build_recsys_cell(arch, shape, mesh)
    if arch.family == "engine":
        return build_engine_cell(arch, shape, mesh)
    raise ValueError(arch.family)

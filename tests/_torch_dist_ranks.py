"""One rank of ``tests/test_torch_dist.py``'s 2 x 2 gloo mesh on the CPU.

    python tests/_torch_dist_ranks.py RANK WORLD WORKDIR

Every rank rendezvous through a ``FileStore`` in WORKDIR, reads the shared
inputs (``inputs.npz``, written by the test), makes the same calls of the
port's multi-device layer with the same arguments, and writes what it got
to ``rank{RANK}.pkl``; the test asserts on those. The port imports no JAX,
and neither does this script.
"""
import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

FIELDS = ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "es_stopped",
          "phase2", "n_rerank")


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _corpus(inp, prefix, mesh, int8=False):
    from repro_torch.convert import sharded_from_arrays
    return sharded_from_arrays(
        inp[prefix + "raw"], inp[prefix + "neighbors"], inp[prefix + "start_ids"],
        inp[prefix + "offsets"], int(inp[prefix + "n_total"]),
        codes=inp[prefix + "codes"] if int8 else None,
        meta=inp[prefix + "meta"] if int8 else None,
        labels=inp[prefix + "labels"], mesh=mesh, device="cpu")


def _cfg(dt, cap):
    from repro_torch.core import RangeConfig, SearchConfig
    return RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                           expand_width=4, corpus_dtype=dt),
                       mode="greedy", result_cap=cap)


def _searches(inp, mesh, out):
    from repro_torch.core import LabelFilter
    from repro_torch.dist import sharded_range_search
    cap = int(inp["cap"])
    a32, a8 = _corpus(inp, "a_", mesh), _corpus(inp, "a_", mesh, int8=True)
    out["held"] = (a32.first_shard, a32.n_local, a32.n_shards)
    qs, radii = inp["qs"], inp["radii"]
    filt = LabelFilter(masks=torch.from_numpy(inp["masks"].view(np.int32)),
                       is_and=torch.from_numpy(inp["is_and"]))
    cases = {
        "f32": (a32, "float32", qs, 2.0, {}),
        "int8": (a8, "int8", qs, 2.0, {}),
        "mixed": (a32, "float32", qs, radii, {}),
        "equal_vec": (a32, "float32", qs, np.full(len(qs), 2.0, np.float32), {}),
        "tomb": (a32, "float32", qs, radii, {"tombstones": inp["tomb"]}),
        "filter": (a32, "float32", qs, radii, {"label_filter": filt}),
        "q15": (a32, "float32", qs[:15], radii[:15], {}),
    }
    for name, (c, dt, q, r, kw) in cases.items():
        res = sharded_range_search(mesh=mesh, corpus=c, queries=q, r=r, cfg=_cfg(dt, cap), **kw)
        out[name] = {f: getattr(res, f).numpy() for f in FIELDS}


def _collectives(inp, mesh, out):
    from repro_torch.dist import compressed_psum_mean
    from repro_torch.dist.collective_matmul import allgather_matmul, matmul_reducescatter
    from repro_torch.dist.embedding import sharded_lookup
    m = mesh.get_local_rank("model")
    lin = mesh.get_local_rank("data") * 2 + m
    x = torch.from_numpy(inp["psum_x"])
    out["psum"] = compressed_psum_mean(x[:, m * 500:(m + 1) * 500], axis_name="model", n=2,
                                       mesh=mesh).numpy()
    xx, w = torch.from_numpy(inp["ag_x"]), torch.from_numpy(inp["ag_w"])
    out["allgather"] = allgather_matmul(xx[m * 8:(m + 1) * 8], w, axis_name="model", n=2,
                                        mesh=mesh).numpy()
    x3, w3 = torch.from_numpy(inp["rs_x"]), torch.from_numpy(inp["rs_w"])
    out["reducescatter"] = matmul_reducescatter(
        x3[:, m * 10:(m + 1) * 10], w3[m * 10:(m + 1) * 10], axis_name="model", n=2,
        mesh=mesh).numpy()
    tables, idx = torch.from_numpy(inp["tables"]), inp["idx"]
    out["lookup_all"] = sharded_lookup(mesh, tables[:, lin * 16:(lin + 1) * 16], idx).numpy()
    out["lookup_model"] = sharded_lookup(mesh, tables[:, m * 32:(m + 1) * 32], idx,
                                         axis="model").numpy()


def _shardings(mesh, out, workdir):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.dist import LM_RULES, bind_shardings, spec_tree
    gen = torch.Generator().manual_seed(0)
    params = {"layers": {"attn": {"wq": torch.randn(6, 32, 4, 16, generator=gen),
                                  "wk": torch.randn(6, 32, 3, 16, generator=gen)},
                         "mlp": {"w_up": torch.randn(32, 64, generator=gen)}},
              "embed": torch.randn(100, 32, generator=gen),
              "final_norm": torch.randn(32, generator=gen)}
    bound = bind_shardings(mesh, spec_tree(params, LM_RULES, mesh))
    got = {}

    def walk(p, b, path):
        if isinstance(p, dict):
            for k in p:
                walk(p[k], b[k], path + (k,))
            return
        dt = distribute_tensor(p, *b)
        got["/".join(path)] = (tuple(("shard", x.dim) if x.is_shard() else ("replicate",)
                                     for x in b[1]), tuple(dt.to_local().shape),
                               bool(torch.equal(dt.full_tensor(), p)))
    walk(params, bound, ())
    out["bound"] = got
    # a checkpoint restored onto the mesh: rank 0 writes it, every rank
    # restores each leaf as a DTensor laid out by the same bindings
    from repro_torch.train import CheckpointManager
    cm = CheckpointManager(os.path.join(workdir, "ckpt"))
    if dist.get_rank() == 0:
        cm.save(1, params)
    dist.barrier()
    state, step = cm.restore(params, shardings=bound, device="cpu")
    flat = {"layers/attn/wq": state["layers"]["attn"]["wq"], "embed": state["embed"],
            "final_norm": state["final_norm"]}
    out["restored"] = {k: (tuple(v.to_local().shape), bool(torch.equal(
        v.full_tensor(), got_tensor(params, k)))) for k, v in flat.items()}
    out["restored_step"] = step


def got_tensor(params, path):
    for k in path.split("/"):
        params = params[k]
    return params


def _server(inp, mesh, out):
    from repro_torch.serve import RangeServer, Request, ServerConfig
    a32 = _corpus(inp, "a_", mesh)
    clock = FakeClock()
    srv = RangeServer(None, _cfg("float32", int(inp["cap"])),
                      ServerConfig(max_batch=int(inp["server_batch"])), mesh=mesh, sharded=a32,
                      clock=clock)
    for i, q in enumerate(inp["qs"]):
        clock.t = 0.25 * i
        srv.submit(Request(req_id=i, op="count" if i % 5 == 4 else "range", query=q,
                           radius=float(inp["radii"][i]),
                           filter_labels=[i % 8] if i % 3 == 1 else None))
    clock.t = 10.0
    out["server"] = [vars(r) for r in srv.run_until_drained()]
    out["server_stats"] = dict(srv.stats)


def _live_sharded(inp, mesh, out):
    """``LiveShardedIndex.range`` over the mesh: every rank keeps all four
    shards' live indices (the shared k-NN graphs of the "a_" shards, pad rows
    dropped), applies the same mutations, and searches the shards of its
    model coordinate. Saved beside the union of the four shards' own
    ``LiveSnapshot.range`` (fused), merged by distance in shard order."""
    from repro_torch.core import BuildConfig, Graph
    from repro_torch.dist.sharded_engine import union_merge
    from repro_torch.live import LiveConfig, LiveIndex, LiveShardedIndex
    raw, nbrs = inp["a_raw"], inp["a_neighbors"]
    n = raw.shape[1]
    shards = []
    for s in range(raw.shape[0]):
        real = int((raw[s, :, 0] < 1e29).sum())
        shards.append(LiveIndex.create(
            raw[s, :real], LiveConfig(capacity=480, insert_batch=32),
            BuildConfig(max_degree=nbrs.shape[2], beam=16),
            graph=Graph(torch.from_numpy(np.ascontiguousarray(nbrs[s, :real]))),
            first_ext_id=s * n, device="cpu"))
    sl = LiveShardedIndex(shards)
    sl.next_ext_id = int(inp["a_n_total"])
    qs, radii = inp["qs"], inp["radii"]
    sl.insert(qs[:12] + 0.05)
    sl.delete(np.r_[0:1601:9, 1601:1605])
    sl.maybe_consolidate()
    cfg = _cfg("float32", int(inp["cap"]))
    res = sl.range(mesh, qs, radii, cfg)
    per = [sh.snapshot().range(qs, radii, cfg=cfg, compacted=False) for sh in sl.shards]
    ids, dists = union_merge(torch.cat([p.ids for p in per], 1),
                             torch.cat([p.dists for p in per], 1), cfg.result_cap)
    out["live_sharded"] = {"ids": res.ids.numpy(), "dists": res.dists.numpy(),
                           "count": res.count.numpy()}
    out["live_union"] = {"ids": ids.numpy(), "dists": dists.numpy(),
                         "count": torch.clamp(sum(p.count for p in per),
                                              max=cfg.result_cap).numpy()}
    out["live_held"] = (sl._view_cache[1][0].first_shard, sl._view_cache[1][0].n_local)


LM_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=4, d_head=16, d_ff=64,
              vocab=64, loss_chunk=16, remat=False)
LM_DATA = dict(vocab=64, seq_len=16, batch=4)
TRAIN_ARCHS = ("wide-deep", "gcn-cora")
TRAIN_BATCH = 8


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (key,)).items()}
    return {"/".join(path): tree}


def _gathered(tree) -> dict:
    """{path: numpy} of a tree of DTensors, each leaf gathered (a collective
    every rank makes)."""
    return {k: v.full_tensor().numpy() for k, v in _flat(tree).items()}


def _local_bytes(tree) -> int:
    return sum(v.to_local().numel() * v.to_local().element_size()
               for v in _flat(tree).values())


def _mesh_trainer(mesh, out, workdir):
    """``Trainer(mesh=, param_rules=)`` on the 2 x 2 mesh. The LM restores
    the unsharded phase-1 checkpoint the test wrote (step 10) and trains to
    step 14, logging every 2 steps; wide-deep and gcn-cora (``reduced()``)
    train 3 steps from the training CLI's initial trees and batches. Saved:
    the histories, every leaf gathered, and each rank's local bytes of
    parameters and moments."""
    import functools
    from repro_torch.configs import get_arch
    from repro_torch.data import LMDataConfig, lm_batches
    from repro_torch.dist import LM_RULES
    from repro_torch.launch.train import build_training
    from repro_torch.models import transformer as tf
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = tf.TransformerConfig(**LM_CFG, dtype=torch.float32)
    tr = Trainer(functools.partial(tf.loss_fn, cfg=cfg),
                 tf.transformer_tree(tf.init_transformer(cfg, seed=1, device="cpu",
                                                         f32_masters=True), cfg),
                 AdamWConfig(lr=1e-2, warmup_steps=2),
                 TrainerConfig(total_steps=14, ckpt_every=50, log_every=2,
                               ckpt_dir=os.path.join(workdir, "lm_ck")),
                 mesh=mesh, param_rules=LM_RULES)
    restored = tr.maybe_restore()
    out["lm_restored"] = (restored, tr.step)
    out["lm_history"] = tr.fit(lm_batches(LMDataConfig(**LM_DATA), start_step=10))["history"]
    out["lm_params"] = _gathered(tr.params)
    out["lm_opt"] = {k: _gathered(tr.opt_state[k]) for k in ("m", "v")}
    out["lm_local"] = {"params": _local_bytes(tr.params),
                       "m": _local_bytes(tr.opt_state["m"]),
                       "v": _local_bytes(tr.opt_state["v"])}
    out["lm_shapes"] = {k: tuple(v.shape) for k, v in _flat(tr.params).items()}
    for arch_id in TRAIN_ARCHS:
        arch = get_arch(arch_id)
        params, loss, data = build_training(arch_id, True, TRAIN_BATCH, 16, device="cpu")
        tr = Trainer(loss, params, arch.opt_cfg,
                     TrainerConfig(total_steps=3, log_every=1,
                                   ckpt_dir=os.path.join(workdir, f"ck_{arch_id}")),
                     mesh=mesh, param_rules=arch.rules)
        out[arch_id] = {"history": tr.fit(data)["history"], "params": _gathered(tr.params),
                        "local": _local_bytes(tr.params) + _local_bytes(tr.opt_state["m"])
                        + _local_bytes(tr.opt_state["v"])}


def _mesh_moe(mesh, out):
    """The MoE on the 2 x 2 mesh against the unsharded port: reduced
    qwen2-moe in f32, 4 x 1,024 tokens (two dispatch groups, one a DP
    rank), the loss, the aux loss and every gradient leaf."""
    import dataclasses
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.configs import qwen2_moe_a27b
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.dist import LM_RULES, activation_sharding, bind_shardings, spec_tree
    from repro_torch.models import transformer as tf
    cfg = dataclasses.replace(qwen2_moe_a27b.reduced(), dtype=torch.float32, remat=False)
    tree = tf.transformer_tree(tf.init_transformer(cfg, device="cpu", f32_masters=True), cfg)
    flat = _flat(tree)
    bound = _flat(bind_shardings(mesh, spec_tree(tree, LM_RULES, mesh)))
    batch = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=1024, batch=4), 0)

    def grads(leaves, tokens):
        it = iter(leaves)
        t = {}
        for path in flat:
            node = t
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = next(it)
        loss, m = tf.loss_fn(t, {"tokens": tokens, "labels": tokens}, cfg)
        return loss, m["aux_loss"], torch.autograd.grad(loss, leaves)
    live = [distribute_tensor(v.detach().clone(), *bound[k], src_data_rank=None)
            .requires_grad_(True) for k, v in flat.items()]
    toks = distribute_tensor(torch.as_tensor(batch["tokens"]), mesh, (Shard(0), Replicate()),
                             src_data_rank=None)
    with activation_sharding(mesh):
        loss, aux, g = grads(live, toks)
    out["moe_mesh"] = (float(loss.full_tensor()), float(aux.full_tensor()),
                       [x.full_tensor().numpy() for x in g])
    loss, aux, g = grads([v.detach().clone().requires_grad_(True) for v in flat.values()],
                         torch.as_tensor(batch["tokens"]))
    out["moe_plain"] = (float(loss), float(aux), [x.numpy() for x in g])


def main(rank: int, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.dist import make_mesh
        inp = np.load(os.path.join(workdir, "inputs.npz"))
        mesh = make_mesh((2, 2), device_type="cpu")
        out = {"coord": tuple(mesh.get_coordinate())}
        _searches(inp, mesh, out)
        _collectives(inp, mesh, out)
        _shardings(mesh, out, workdir)
        _server(inp, mesh, out)
        _live_sharded(inp, mesh, out)
        _mesh_trainer(mesh, out, workdir)
        _mesh_moe(mesh, out)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

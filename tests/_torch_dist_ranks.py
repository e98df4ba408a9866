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
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])

"""The port's multi-device layer against the JAX package, on a 2 x 2 mesh.

The port runs SPMD over ``torch.distributed``: four gloo ranks on the CPU
(``tests/_torch_dist_ranks.py``), spawned once for the module, rendezvous
through a ``FileStore`` in the test's tmp dir and make the same calls with
the same arguments (``dist.sharding``'s contract). JAX's collectives need
four devices before its first import, so the reference's
``sharded_range_search`` (f32 and int8), ``compressed_psum_mean``,
``allgather_matmul``, ``matmul_reducescatter`` and ``sharded_lookup`` run
once in a JAX subprocess with ``--xla_force_host_platform_device_count=4``
(as ``tests/test_dist.py`` runs its own) on the same (2, 2) mesh shape and
the same shards. The other cases hold the port's collective result to the
host union of JAX's in-process per-shard ``range_search_fused`` over the
same shards (carried across by ``convert.sharded_from_arrays``), merged in
shard order by a stable sort on the distances.

The rig is ``tests/test_fault.py``'s at n=1,601: clustered points of d=8 in
4 shards, the last one short (398 rows and 3 pad rows), a k-NN graph (k=10)
per shard with an entry point per cluster, queries next to corpus points.
Ids, counts, flags and counters must be equal; distances ``allclose`` at
1e-6 relative (sums in another order), plus 1e-8 absolute on int8 shards:
their sure members keep certified lower bounds, f32 expressions whose terms
cancel near a zero distance (4.4e-5 differs by 2e-10 there).
"""
import functools
import os
import pickle
import shutil
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.dist.sharded_engine import build_sharded as jax_build_sharded
from repro.dist.sharding import LM_RULES as JLM_RULES
from repro.dist.sharding import spec_tree as jax_spec_tree
from repro_torch.dist import LM_RULES, DP, TP, Spec, bind_shardings, sharded_range_search
from repro_torch.dist import spec_tree
from repro_torch.core import RangeConfig
from repro_torch.dist.sharded_engine import ShardedCorpus
from repro_torch.utils import INVALID_ID

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = os.path.join(ROOT, "tests", "_torch_dist_ranks.py")
WORLD = 4
N = 1601        # 4 shards of 401 rows: the last holds 398 and 3 pad rows
CAP = 128
FIELDS = ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "es_stopped",
          "phase2", "n_rerank")
DIST_TOL = dict(rtol=1e-6, atol=0.0)
INT8_TOL = dict(rtol=1e-6, atol=1e-8)
TIMEOUT_S = 600
# the mesh trainer's rigs (tests/_torch_dist_ranks.py): the reference test's
# 2-layer LM (tests/test_dist.py::test_sharded_trainer_elastic_restore) and
# the training CLI's reduced wide-deep and gcn-cora
LM_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv=4, d_head=16, d_ff=64,
              vocab=64, loss_chunk=16, remat=False)
LM_DATA = dict(vocab=64, seq_len=16, batch=4)
TRAIN_ARCHS = ("wide-deep", "gcn-cora")
TRAIN_BATCH = 8
TRAIN_TOL = 1e-4   # relative; a sharded reduction sums in another order
# the reference builds its shard_map program anew at each call (~13 s of
# compile on a CPU), so the served stream is one micro-batch
SERVER_BATCH = 32

_JAX_SCRIPT = """
import pickle, sys
from functools import partial
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import repro.core as J
from repro.dist.compat import shard_map
from repro.dist.collective_matmul import allgather_matmul, matmul_reducescatter
from repro.dist.compression import compressed_psum_mean
from repro.dist.embedding import sharded_lookup
from repro.dist.sharded_engine import ShardedCorpus, sharded_range_search
from repro.serve import RangeServer, Request, ServerConfig
work, part = sys.argv[1], sys.argv[2]
inp = np.load(work + "/inputs.npz")
raw = jnp.asarray(inp["a_raw"])
cfgs = {dt: J.RangeConfig(search=J.SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                                expand_width=4, corpus_dtype=dt),
                          mode="greedy", result_cap=int(inp["cap"]))
        for dt in ("float32", "int8")}

def corpus(dt, labels=None):
    pts = raw if dt == "float32" else J.QuantizedCorpus(
        codes=jnp.asarray(inp["a_codes"]), meta=jnp.asarray(inp["a_meta"]), raw=raw)
    return ShardedCorpus(points=pts, neighbors=jnp.asarray(inp["a_neighbors"]),
                         start_ids=jnp.asarray(inp["a_start_ids"]),
                         offsets=jnp.asarray(inp["a_offsets"]),
                         n_total=int(inp["a_n_total"]), labels=labels)

out = {}
if part in ("f32", "int8"):
    dt = {"f32": "float32", "int8": "int8"}[part]
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    res = sharded_range_search(mesh=mesh, corpus=corpus(dt), queries=jnp.asarray(inp["qs"]),
                               r=2.0, cfg=cfgs[dt])
    for f in %(fields)r:
        out[part + "/" + f] = np.asarray(getattr(res, f))
if part == "f32":   # the collective helpers, one program
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    psum = shard_map(partial(compressed_psum_mean, axis_name="model", n=2), mesh=mesh,
                     in_specs=P(None, "model"), out_specs=P(None, "model"), check_vma=False)
    ag = shard_map(partial(allgather_matmul, axis_name="model", n=2), mesh=mesh,
                   in_specs=(P("model", None), P(None, None)), out_specs=P(None, None),
                   check_vma=False)
    rs = shard_map(partial(matmul_reducescatter, axis_name="model", n=2), mesh=mesh,
                   in_specs=(P(None, "model"), P("model", None)), out_specs=P("model", None),
                   check_vma=False)

    @jax.jit
    def helpers(x, xx, w, x3, w3, tables, idx):
        return (psum(x), ag(xx, w), rs(x3, w3),
                sharded_lookup(mesh, tables, idx, axis=("data", "model")),
                sharded_lookup(mesh, tables, idx, axis="model"))
    got = helpers(*(jnp.asarray(inp[k]) for k in ("psum_x", "ag_x", "ag_w", "rs_x", "rs_w",
                                                  "tables", "idx")))
    for k, v in zip(("psum", "allgather", "reducescatter", "lookup_all", "lookup_model"), got):
        out[k] = np.asarray(v)
if part == "server":   # RangeServer(mesh=, sharded=) on a one-device (1, 1) mesh
    class Clock:
        t = 0.0
        def __call__(self):
            return self.t
    clock = Clock()
    srv = RangeServer(None, cfgs["float32"], ServerConfig(max_batch=int(inp["server_batch"])),
                      mesh=jax.make_mesh((1, 1), ("data", "model")),
                      sharded=corpus("float32", jnp.asarray(inp["a_labels"])), clock=clock)
    for i, q in enumerate(inp["qs"]):
        clock.t = 0.25 * i
        srv.submit(Request(req_id=i, op="count" if i %% 5 == 4 else "range", query=q,
                           radius=float(inp["radii"][i]),
                           filter_labels=[i %% 8] if i %% 3 == 1 else None))
    clock.t = 10.0
    out = {"server": [vars(r) for r in srv.run_until_drained()], "stats": dict(srv.stats)}
if part == "train":   # the reference's unsharded Trainer on the port's checkpoint and trees
    import functools
    from repro.configs import get_arch
    from repro.data.lm import LMDataConfig, lm_batches
    from repro.launch.train import build_training
    from repro.models import TransformerConfig, init_transformer, loss_fn
    from repro.optim import AdamWConfig
    from repro.train import Trainer, TrainerConfig

    def flat(tree):
        return {"/".join(str(k.key) for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    cfg = TransformerConfig(**%(lm_cfg)r, dtype=jnp.float32)
    tr = Trainer(functools.partial(loss_fn, cfg=cfg), init_transformer(jax.random.PRNGKey(1), cfg),
                 AdamWConfig(lr=1e-2, warmup_steps=2),
                 TrainerConfig(total_steps=14, ckpt_every=50, log_every=2,
                               ckpt_dir=work + "/lm_ck_jax"))
    assert tr.maybe_restore() and tr.step == 10
    out["lm_history"] = tr.fit(lm_batches(LMDataConfig(**%(lm_data)r), start_step=10))["history"]
    out["lm_params"] = flat(tr.params)
    for arch_id in %(archs)r:
        arch = get_arch(arch_id)
        init = np.load(work + "/init_" + arch_id + ".npz")

        def port_init(jp):   # the port's initial tree, in the reference's structure
            return jax.tree_util.tree_map_with_path(
                lambda path, _: jnp.asarray(init["/".join(str(k.key) for k in path)]), jp)
        jp, loss, data = build_training(arch_id, True, %(batch)d, 16)
        tr = Trainer(loss, port_init(jp), arch.opt_cfg,
                     TrainerConfig(total_steps=3, log_every=1, ckpt_dir=work + "/jck_" + arch_id))
        out[arch_id] = {"history": tr.fit(data)["history"], "params": flat(tr.params)}
        try:   # the reference's own mesh Trainer, on a (2, 2) mesh of the 4 devices
            jp, loss, data = build_training(arch_id, True, %(batch)d, 16)
            tr = Trainer(loss, port_init(jp), arch.opt_cfg,
                         TrainerConfig(total_steps=3, log_every=1,
                                       ckpt_dir=work + "/jmesh_" + arch_id),
                         mesh=jax.make_mesh((2, 2), ("data", "model")), param_rules=arch.rules)
            out[arch_id]["mesh"] = {"history": tr.fit(data)["history"],
                                    "params": flat(tr.params)}
        except Exception as e:
            out[arch_id]["mesh"] = repr(e)
with open(work + "/jax_" + part + ".pkl", "wb") as f:
    pickle.dump(out, f)
""" % {"fields": FIELDS, "lm_cfg": LM_CFG, "lm_data": LM_DATA, "archs": TRAIN_ARCHS,
       "batch": TRAIN_BATCH}
JAX_PARTS = ("f32", "int8", "server", "train")


def _clustered(n, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, 8)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 8, n)]
           + rng.standard_normal((n, 8)).astype(np.float32) * 0.3).astype(np.float32)
    return centers, pts


def _builder(centers):
    centers_j = jnp.asarray(centers)

    def build(p):
        # a k-NN graph over separated clusters is disconnected: one entry
        # point per cluster keeps every component reachable
        lab = np.asarray(jnp.argmin(jnp.sum((p[:, None] - centers_j[None]) ** 2, -1), axis=1))
        starts = np.asarray([np.flatnonzero(lab == c)[0] for c in range(8)], np.int32)
        return J.build_knn_graph(p, k=10), jnp.asarray(starts)
    return build


def _arrays(prefix, c8):
    """A reference int8 ``ShardedCorpus`` as the arrays both packages read:
    its raw rows are the f32 corpus."""
    return {prefix + "raw": np.asarray(c8.points.raw),
            prefix + "codes": np.asarray(c8.points.codes),
            prefix + "meta": np.asarray(c8.points.meta),
            prefix + "neighbors": np.asarray(c8.neighbors),
            prefix + "start_ids": np.asarray(c8.start_ids),
            prefix + "offsets": np.asarray(c8.offsets),
            prefix + "n_total": np.asarray(c8.n_total),
            prefix + "labels": np.asarray(c8.labels)}


def _jcfg(dt="float32"):
    return J.RangeConfig(search=J.SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                               expand_width=4, corpus_dtype=dt),
                         mode="greedy", result_cap=CAP)


def _host_union(inp, prefix, qs, radii, tomb=None, filt=None):
    """JAX's per-shard ``range_search_fused`` over every shard, each
    shard's ids made global (pad rows past n_total dropped), then the
    union: candidates in shard order, a stable sort on the distances, the
    first CAP; counts summed and capped, flags OR-ed, counters summed."""
    n_total = int(inp[prefix + "n_total"])
    ids, dists, per = [], [], []
    for s in range(inp[prefix + "offsets"].shape[0]):
        res = J.range_search_fused(
            corpus=jnp.asarray(inp[prefix + "raw"][s]),
            graph=J.Graph(neighbors=jnp.asarray(inp[prefix + "neighbors"][s])),
            queries=jnp.asarray(qs), start_ids=jnp.asarray(inp[prefix + "start_ids"][s]),
            r=jnp.asarray(radii), cfg=_jcfg(), es_radius=jnp.full(len(qs), jnp.inf),
            tombstones=None if tomb is None else jnp.asarray(tomb[s]),
            labels=None if filt is None else jnp.asarray(inp[prefix + "labels"][s]),
            label_filter=filt)
        rid = np.asarray(res.ids).astype(np.int64)
        gid = np.where(rid == INVALID_ID, INVALID_ID, rid + int(inp[prefix + "offsets"][s]))
        gid = np.where(gid < n_total, gid, INVALID_ID)
        ids.append(gid)
        dists.append(np.where(gid == INVALID_ID, np.inf, np.asarray(res.dists)))
        per.append(res)
    ids, dists = np.concatenate(ids, 1), np.concatenate(dists, 1)
    order = np.argsort(dists, axis=1, kind="stable")[:, :CAP]
    total = sum((i != INVALID_ID).sum(1) for i in np.split(ids, len(per), axis=1))

    def any_(f):
        return sum(np.asarray(getattr(p, f)).astype(np.int32) for p in per) > 0

    return {"ids": np.take_along_axis(ids, order, 1), "dists": np.take_along_axis(dists, order, 1),
            "count": np.minimum(total, CAP), "overflow": any_("overflow") | (total > CAP),
            "n_visited": sum(np.asarray(p.n_visited) for p in per),
            "n_dist": sum(np.asarray(p.n_dist) for p in per),
            "es_stopped": any_("es_stopped"), "phase2": any_("phase2"),
            "n_rerank": sum(np.asarray(p.n_rerank) for p in per)}


def _assert_equal(got: dict, want: dict, name: str, tol=DIST_TOL):
    for f in FIELDS:
        g, w = np.asarray(got[f]), np.asarray(want[f])
        if f == "dists":
            np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w), err_msg=name)
            np.testing.assert_allclose(g[np.isfinite(w)], w[np.isfinite(w)], **tol,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g.astype(np.int64), w.astype(np.int64),
                                          err_msg=f"{name}: {f}")


def _inputs():
    centers, pts = _clustered(N)
    rng = np.random.default_rng(11)
    raw_labels = [sorted(int(x) for x in rng.choice(8, size=int(rng.integers(1, 3)),
                                                   replace=False))
                  for _ in range(pts.shape[0])]
    packed = J.pack_labels(raw_labels, 8)
    # one int8 build: its raw rows (pad rows FAR) are the f32 corpus's points
    a8 = jax_build_sharded(pts, 4, _builder(centers), corpus_dtype="int8", labels=packed)
    qs = pts[:24] + 0.01
    n = a8.shard_size
    tomb = np.zeros((4, -(-n // 32)), np.uint32)
    for s in range(4):                       # every 7th slot of every shard is dead
        for slot in range(s, n, 7):
            tomb[s, slot // 32] |= np.uint32(1 << (slot % 32))
    entries = [[q % 8] if q % 2 == 0 else [q % 8, (q + 3) % 8] for q in range(24)]
    filt = J.make_label_filter(entries, 8, modes=["and" if q % 2 == 0 else "or"
                                                 for q in range(24)])
    rng = np.random.default_rng(2)
    inp = {"cap": np.asarray(CAP), "server_batch": np.asarray(SERVER_BATCH), "qs": qs,
           # per-lane radii from 0.5 to 3.5: some lanes overflow the cap
           "radii": np.linspace(0.5, 3.5, 24).astype(np.float32),
           "tomb": tomb, "masks": np.asarray(filt.masks), "is_and": np.asarray(filt.is_and),
           "psum_x": rng.standard_normal((8, 1000)).astype(np.float32),
           "ag_x": rng.standard_normal((16, 12)).astype(np.float32),
           "ag_w": rng.standard_normal((12, 6)).astype(np.float32),
           "rs_x": rng.standard_normal((16, 20)).astype(np.float32),
           "rs_w": rng.standard_normal((20, 6)).astype(np.float32),
           "tables": rng.standard_normal((3, 64, 8)).astype(np.float32),
           "idx": rng.integers(0, 64, (10, 3)).astype(np.int32)}
    inp.update(_arrays("a_", a8))
    return inp, filt


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (key,)).items()}
    return {"/".join(path): tree}


def _phase_one(work):
    """The mesh trainer's phase 1, here: the port's unsharded ``Trainer`` on
    the reference test's LM, 10 steps with checkpoints at 5 and 10 (a copy
    for the reference to restore), and the initial trees of the reduced
    wide-deep and gcn-cora (the training CLI's, seed 0) for the reference."""
    from repro_torch.data import LMDataConfig, lm_batches
    from repro_torch.launch.train import init_params
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as ptf
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    cfg = ptf.TransformerConfig(**LM_CFG, dtype=torch.float32)
    tr = Trainer(functools.partial(ptf.loss_fn, cfg=cfg),
                 ptf.transformer_tree(ptf.init_transformer(cfg, seed=0, device="cpu",
                                                           f32_masters=True), cfg),
                 AdamWConfig(lr=1e-2, warmup_steps=2),
                 TrainerConfig(total_steps=10, ckpt_every=5, log_every=5,
                               ckpt_dir=os.path.join(work, "lm_ck")))
    tr.fit(lm_batches(LMDataConfig(**LM_DATA)))
    shutil.copytree(os.path.join(work, "lm_ck"), os.path.join(work, "lm_ck_jax"))
    for arch_id in TRAIN_ARCHS:
        arch = get_arch(arch_id)
        params = init_params(arch.family, arch.reduced(), 0, torch.device("cpu"))
        np.savez(os.path.join(work, f"init_{arch_id}.npz"),
                 **{k: v.numpy() for k, v in _flat(params).items()})


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the JAX subprocesses and the four ranks once; meanwhile compute
    the in-process JAX host unions. Returns (inputs, JAX collective results,
    host unions, JAX server responses and stats, every rank's outputs)."""
    torch.set_num_threads(1)
    work = str(tmp_path_factory.mktemp("dist"))
    inp, filt = _inputs()
    np.savez(os.path.join(work, "inputs.npz"), **inp)
    _phase_one(work)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    names = [f"jax_{p}" for p in JAX_PARTS] + [f"rank{r}" for r in range(WORLD)]
    logs = {name: open(os.path.join(work, name + ".log"), "w+") for name in names}
    procs = {}
    for part in JAX_PARTS:   # three JAX programs at once, each a few compiles
        procs[f"jax_{part}"] = subprocess.Popen(
            [sys.executable, "-c", _JAX_SCRIPT, work, part], cwd=ROOT,
            stdout=logs[f"jax_{part}"], stderr=subprocess.STDOUT,
            env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    for r in range(WORLD):
        procs[f"rank{r}"] = subprocess.Popen(
            [sys.executable, RANKS, str(r), str(WORLD), work], cwd=ROOT,
            stdout=logs[f"rank{r}"], stderr=subprocess.STDOUT,
            env=dict(env, OMP_NUM_THREADS="1"))
    try:
        unions = {
            "mixed": _host_union(inp, "a_", inp["qs"], inp["radii"]),
            "tomb": _host_union(inp, "a_", inp["qs"], inp["radii"], tomb=inp["tomb"]),
            "filter": _host_union(inp, "a_", inp["qs"], inp["radii"], filt=filt),
        }
        for name, p in procs.items():
            rc = p.wait(timeout=TIMEOUT_S)
            logs[name].seek(0)
            assert rc == 0, f"{name} exited {rc}:\n{logs[name].read()[-4000:]}"
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs.values():
            f.close()
    ranks, jx = [], {}
    for r in range(WORLD):
        with open(os.path.join(work, f"rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    for part in JAX_PARTS:
        with open(os.path.join(work, f"jax_{part}.pkl"), "rb") as f:
            jx.update(pickle.load(f))
    server = (jx.pop("server"), jx.pop("stats"))
    train = {k: jx.pop(k) for k in ("lm_history", "lm_params") + TRAIN_ARCHS}
    return types.SimpleNamespace(inp=inp, jax=jx, unions=unions, server=server, ranks=ranks,
                                 train=train, work=work)


def _jax_result(run, name):
    return {f: run.jax[f"{name}/{f}"] for f in FIELDS}


# ---------------------------------------------------------------------------
# the collective search
# ---------------------------------------------------------------------------

def test_ranks_hold_their_model_coordinates_shards(run):
    coords = [r["coord"] for r in run.ranks]
    assert sorted(coords) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in run.ranks:
        assert r["held"] == (2 * r["coord"][1], 2, 4)


@pytest.mark.parametrize("name", ["f32", "int8"])
def test_sharded_range_search_matches_jax_collective(run, name):
    """The (2, 2) collective against the reference's shard_map program on
    the same mesh shape and shards: int8 with local quantization, n_rerank
    summed over the shards."""
    want = _jax_result(run, name)
    for r in run.ranks:
        _assert_equal(r[name], want, name, INT8_TOL if name == "int8" else DIST_TOL)
    if name == "int8":
        assert want["n_rerank"].sum() > 0


@pytest.mark.parametrize("name", ["mixed", "tomb", "filter"])
def test_sharded_range_search_matches_host_union(run, name):
    """Mixed per-lane radii (some lanes overflow the cap), tombstones (every
    7th slot of each shard), an AND/OR label filter: each equal to the host
    union of JAX's per-shard searches."""
    for r in run.ranks:
        _assert_equal(r[name], run.unions[name], name)
    if name == "mixed":
        assert run.unions[name]["overflow"].any() and not run.unions[name]["overflow"].all()
    if name == "tomb":
        ids = run.unions[name]["ids"]
        valid = ids != INVALID_ID
        n = run.inp["a_raw"].shape[1]
        assert np.all((ids[valid] % n) % 7 != ids[valid] // n)  # no dead slot answers


def test_short_last_shard_pad_rows_never_answer(run):
    """n = 1,601 over 4 shards: the last one holds 398 rows and 3 pad rows
    (FAR rows, INVALID adjacency), which no case ever returns, though its
    real rows do answer."""
    assert run.inp["a_raw"].shape[1] == 401 and (run.inp["a_raw"][3, 398:] == 1e30).all()
    assert (run.inp["a_neighbors"][3, 398:] == INVALID_ID).all()
    for name in ("f32", "int8", "mixed", "tomb", "filter", "q15"):
        ids = run.ranks[0][name]["ids"]
        ids = ids[ids != INVALID_ID]
        assert (ids < N).all() and (ids >= 3 * 401).any(), name


def test_equal_radius_vector_is_the_scalar_call(run):
    for r in run.ranks:
        for f in FIELDS:
            np.testing.assert_array_equal(r["equal_vec"][f], r["f32"][f])


def test_odd_batch_pads_the_data_axis(run):
    """Q = 15 on a data axis of 2: replicate-padded to 16 and sliced back,
    each lane equal to the same lane of the 24-query call."""
    for r in run.ranks:
        for f in FIELDS:
            assert r["q15"][f].shape[0] == 15
            np.testing.assert_array_equal(r["q15"][f], r["mixed"][f][:15])


def test_every_rank_returns_the_same_result(run):
    for name in ("f32", "int8", "mixed", "tomb", "filter", "q15"):
        for r in run.ranks[1:]:
            for f in FIELDS:
                np.testing.assert_array_equal(r[name][f], run.ranks[0][name][f])


def test_tiered_corpus_and_unlabeled_filter_are_refused():
    one = torch.zeros((1, 4, 2))
    corpus = ShardedCorpus(points=one, neighbors=torch.zeros((1, 4, 2), dtype=torch.int32),
                           start_ids=torch.zeros((1, 1), dtype=torch.int32),
                           offsets=torch.zeros(1, dtype=torch.int32), n_total=4,
                           tiers=(object(),))
    with pytest.raises(ValueError, match="tiered"):
        sharded_range_search(mesh=None, corpus=corpus, queries=one[0], r=1.0,
                             cfg=RangeConfig())
    corpus.tiers = None
    with pytest.raises(ValueError, match="no labels"):
        sharded_range_search(mesh=None, corpus=corpus, queries=one[0], r=1.0,
                             cfg=RangeConfig(), label_filter=object())


# ---------------------------------------------------------------------------
# the collective helpers
# ---------------------------------------------------------------------------

def test_compressed_psum_mean_matches_jax(run):
    want = run.jax["psum"]
    x = run.inp["psum_x"].reshape(8, 2, 500)
    for r in run.ranks:
        np.testing.assert_allclose(r["psum"], want[:, :500], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["psum"], x.mean(1), rtol=0.05, atol=0.02)


def test_ring_matmuls_match_jax(run):
    for r in run.ranks:
        m = r["coord"][1]
        np.testing.assert_allclose(r["allgather"], run.jax["allgather"], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["allgather"], run.inp["ag_x"] @ run.inp["ag_w"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r["reducescatter"],
                                   run.jax["reducescatter"][m * 8:(m + 1) * 8],
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("axis", ["all", "model"])
def test_sharded_lookup_matches_jax(run, axis):
    want = np.take_along_axis(run.inp["tables"][None], run.inp["idx"].T[None, :, :, None],
                              axis=2)[0].transpose(1, 0, 2)
    for r in run.ranks:
        np.testing.assert_array_equal(r[f"lookup_{axis}"], run.jax[f"lookup_{axis}"])
        np.testing.assert_array_equal(r[f"lookup_{axis}"], want)


# ---------------------------------------------------------------------------
# sharding specs
# ---------------------------------------------------------------------------

def _meshes(data, model):
    """Shape-only stand-ins of a (data, model) mesh, one a package: both
    packages' spec logic reads only the axis names and sizes."""
    jmesh = types.SimpleNamespace(shape={"data": data, "model": model},
                                  axis_names=("data", "model"))
    tmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(data, model))
    return jmesh, tmesh


@pytest.mark.parametrize("model", [2, 4])
def test_spec_tree_matches_jax_on_a_reduced_transformer(model):
    """Every leaf of a reduced transformer's parameter tree (JAX's shapes,
    as ``torch.Size``s for the port), plus the 3-kv-head fallback of
    ``tests/test_dist.py``: 3 kv heads do not divide model=4, so TP drops."""
    from repro.configs import gemma3_27b
    from repro.models import transformer as jtf
    shapes = jax.eval_shape(lambda: jtf.init_transformer(jax.random.PRNGKey(0),
                                                         gemma3_27b.reduced()))
    shapes = {"model": shapes, "layers": {"attn": {"wk": np.zeros((6, 32, 3, 16))}}}
    jmesh, tmesh = _meshes(2, model)
    want = jax_spec_tree(shapes, JLM_RULES, jmesh)
    got = spec_tree(jax.tree.map(lambda x: torch.Size(x.shape), shapes), LM_RULES, tmesh)
    flat_w, tree_w = jax.tree_util.tree_flatten(want, is_leaf=lambda x: isinstance(x, tuple))
    flat_g, tree_g = jax.tree_util.tree_flatten(got, is_leaf=lambda x: isinstance(x, tuple))
    assert tree_w == tree_g
    assert [tuple(s) for s in flat_g] == [tuple(s) for s in flat_w]
    assert all(isinstance(s, Spec) for s in flat_g)
    wk = got["layers"]["attn"]["wk"]
    assert wk[1] == DP and wk[2] is None


def test_bind_shardings_placements_round_trip(run):
    """``bind_shardings`` gives DTensor placements (a tensor dim per mesh
    dim); ``distribute_tensor`` over the 2 x 2 gloo mesh and back gives the
    tensor again on every rank, and so does a checkpoint restored with
    ``CheckpointManager.restore(shardings=)``."""
    from torch.distributed.tensor import Replicate, Shard
    rep = ("replicate",)

    def shard(d):
        return ("shard", d)
    want = {"layers/attn/wq": ((shard(1), shard(2)), (6, 16, 2, 16)),
            "layers/attn/wk": ((shard(1), rep), (6, 16, 3, 16)),
            "layers/mlp/w_up": ((shard(0), shard(1)), (16, 32)),
            "embed": ((shard(1), shard(0)), (50, 16)),
            "final_norm": ((rep, rep), (32,))}
    for r in run.ranks:
        for path, (placements, local) in want.items():
            got_p, got_local, same = r["bound"][path]
            assert got_p == placements, path
            assert got_local == local, path
            assert same, path
        assert r["restored_step"] == 1
        for path in ("layers/attn/wq", "embed", "final_norm"):
            assert r["restored"][path] == (want[path][1], True), path
    tmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    assert bind_shardings(tmesh, Spec((None, (DP, TP), None)))[1] == (Shard(1), Shard(1))
    assert bind_shardings(tmesh, ())[1] == (Replicate(), Replicate())
    assert bind_shardings(tmesh, {"a": [Spec((TP,))]})["a"][0][1] == (Replicate(), Shard(0))


# ---------------------------------------------------------------------------
# serving over the mesh
# ---------------------------------------------------------------------------

def test_server_over_the_mesh_matches_jax(run):
    """``RangeServer(mesh=, sharded=)`` on every rank against the
    reference's on a (1, 1) mesh, one request stream on a fake clock
    (mixed radii, filtered lanes, count requests): every Response field
    (distances allclose), and the counters."""
    want, want_stats = run.server
    skip = {"dists", "ids", "timings"}
    for r in run.ranks:
        got = r["server"]
        assert [g["req_id"] for g in got] == [w["req_id"] for w in want]
        for g, w in zip(got, want):
            for k in w:
                if k not in skip:
                    assert g[k] == w[k], (g["req_id"], k)
            np.testing.assert_array_equal(np.asarray(g["ids"], np.int64),
                                          np.asarray(w["ids"], np.int64))
            np.testing.assert_allclose(g["dists"], w["dists"], **DIST_TOL)
            assert g["timings"] == pytest.approx(w["timings"])
        for k in ("served", "batches", "overflow", "mixed_radius_batches",
                  "filtered_batches", "filtered_requests", "count_requests",
                  "shard_retries", "shards_lost", "degraded_batches"):
            assert r["server_stats"][k] == want_stats[k], k
    assert sum(len(w["ids"]) for w in want) > 0


# ---------------------------------------------------------------------------
# the sharded live index over the mesh
# ---------------------------------------------------------------------------

def test_live_sharded_range_is_equal_on_every_rank(run):
    """``LiveShardedIndex.range`` on the 2 x 2 mesh: each rank stacks the
    two shards of its model coordinate, and every rank returns the same
    external ids, distances and counts, bit for bit the union of the four
    shards' own searches after the same mutations."""
    for r in run.ranks:
        assert r["live_held"] == (2 * r["coord"][1], 2)
        for f in ("ids", "dists", "count"):
            np.testing.assert_array_equal(r["live_sharded"][f], r["live_union"][f], err_msg=f)
            np.testing.assert_array_equal(r["live_sharded"][f], run.ranks[0]["live_sharded"][f])
    ids = run.ranks[0]["live_sharded"]["ids"]
    assert ((ids >= 1601) & (ids < 1613)).any()           # inserted rows answer
    assert not np.isin(ids, np.r_[0:1601:9]).any()        # deleted rows never do


# ---------------------------------------------------------------------------
# the mesh trainer
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _assert_history(got, want, name):
    assert [h["step"] for h in got] == [h["step"] for h in want], name
    for g, w in zip(got, want):
        assert abs(g["loss"] - w["loss"]) <= TRAIN_TOL * abs(w["loss"]), (name, g, w)


def test_mesh_trainer_restores_the_unsharded_checkpoint_and_matches_jax(run):
    """Phase 2 of the reference test on the port: ``Trainer(mesh=2 x 2,
    param_rules=LM_RULES)`` restores the unsharded checkpoint at step 10 and
    trains to 14. Its losses at steps 12 and 14 and every leaf at step 14
    within 1e-4 relative of the reference's unsharded ``Trainer`` restored
    from the same checkpoint, on the same batches."""
    want = run.train["lm_params"]
    for r in run.ranks:
        assert r["lm_restored"] == (True, 10)
        _assert_history(r["lm_history"], run.train["lm_history"], "lm")
        assert [h["step"] for h in r["lm_history"]] == [12, 14]
        assert set(r["lm_params"]) == set(want)
        for k, v in r["lm_params"].items():
            assert _rel(v, want[k]) <= TRAIN_TOL, k


@pytest.mark.parametrize("arch_id", TRAIN_ARCHS)
def test_mesh_trainer_matches_jax_on_recsys_and_gnn(run, arch_id):
    """wide-deep (``RECSYS_RULES``: the tables' rows over the whole mesh)
    and gcn-cora (``GNN_RULES``) at ``reduced()``, 3 steps on the 2 x 2
    mesh, against the reference's unsharded ``Trainer`` from the same
    initial tree on the same batches; and against the reference's own mesh
    ``Trainer`` on a (2, 2) mesh where it runs."""
    want = run.train[arch_id]
    for r in run.ranks:
        got = r[arch_id]
        _assert_history(got["history"], want["history"], arch_id)
        for k, v in got["params"].items():
            assert _rel(v, want["params"][k]) <= TRAIN_TOL, (arch_id, k)
        if isinstance(want["mesh"], dict):
            _assert_history(got["history"], want["mesh"]["history"], arch_id + " mesh")
            for k, v in got["params"].items():
                assert _rel(v, want["mesh"]["params"][k]) <= TRAIN_TOL, (arch_id, k)


def test_mesh_trainer_metrics_are_equal_on_every_rank(run):
    for r in run.ranks[1:]:
        assert r["lm_history"] == run.ranks[0]["lm_history"]
        for arch_id in TRAIN_ARCHS:
            assert r[arch_id]["history"] == run.ranks[0][arch_id]["history"]
    assert all(isinstance(v, float) for h in run.ranks[0]["lm_history"]
               for k, v in h.items() if k != "step")


def _shard_factor(spec, mesh) -> int:
    from repro_torch.dist.sharding import _axis_size, _resolve
    n = 1
    for sym in spec:
        n *= _axis_size(mesh, _resolve(sym, mesh) or ())
    return n


def test_mesh_trainer_holds_only_its_shards(run):
    """Each rank's local bytes of the parameters and of each moment are the
    total over the leaves of each leaf's bytes divided by its shard factor
    under ``spec_tree`` (the product of the mesh axes its dims shard over)."""
    from repro_torch.dist import GNN_RULES, RECSYS_RULES
    tmesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))

    def expected(shapes: dict, rules) -> int:
        tree: dict = {}
        for path, shp in shapes.items():
            node = tree
            *head, last = path.split("/")
            for k in head:
                node = node.setdefault(k, {})
            node[last] = torch.Size(shp)
        specs = _flat(spec_tree(tree, rules, tmesh))
        return sum(4 * int(np.prod(shapes[k])) // _shard_factor(specs[k], tmesh)
                   for k in shapes)
    lm = expected(run.ranks[0]["lm_shapes"], LM_RULES)
    assert lm < sum(4 * int(np.prod(s)) for s in run.ranks[0]["lm_shapes"].values())
    for r in run.ranks:
        assert r["lm_local"] == {"params": lm, "m": lm, "v": lm}
        for arch_id, rules in zip(TRAIN_ARCHS, (RECSYS_RULES, GNN_RULES)):
            shapes = {k: v.shape for k, v in r[arch_id]["params"].items()}
            assert r[arch_id]["local"] == 3 * expected(shapes, rules), arch_id


def test_moe_on_the_mesh_matches_the_unsharded_port(run):
    """The MoE layer on the 2 x 2 mesh (groups over DP, experts over TP,
    routing and dispatch on each rank's groups) against the same port
    unsharded: loss and aux loss within 1e-5, every gradient leaf within
    1e-4 relative."""
    for r in run.ranks:
        (lm, am, gm), (lp, ap, gp) = r["moe_mesh"], r["moe_plain"]
        assert abs(lm - lp) <= 1e-5 * abs(lp) and abs(am - ap) <= 1e-5 * abs(ap)
        assert len(gm) == len(gp)
        for a, b in zip(gm, gp):
            assert _rel(a, b) <= TRAIN_TOL


def test_mesh_checkpoint_restores_onto_one_device(run):
    """The mesh trainer's step-14 checkpoint (rank 0 writes the unsharded
    layout) restored by an unsharded ``CheckpointManager``: every leaf and
    moment equal to the leaves the ranks gathered."""
    from repro_torch.train import CheckpointManager
    cm = CheckpointManager(os.path.join(run.work, "lm_ck"))
    flat, manifest = cm.restore_flat(device="cpu")
    assert manifest["step"] == 14
    r0 = run.ranks[0]
    for k, v in r0["lm_params"].items():
        np.testing.assert_array_equal(flat["params." + k.replace("/", ".")].numpy(), v)
    for m in ("m", "v"):
        for k, v in r0["lm_opt"][m].items():
            np.testing.assert_array_equal(flat[f"opt.{m}." + k.replace("/", ".")].numpy(), v)
    assert int(flat["opt.step"]) == 14


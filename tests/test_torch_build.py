"""The port's Vamana build and deploy config against the JAX package.

Build parity is exact on points with small integer coordinates: every
distance is then an exact integer in f32 whatever the order of a sum, so
the two builds must make the same decision at every tie and agree row for
row. They are held against a *masked* reference: the JAX package's own
``beam_search_batch``, ``robust_prune``, ``_pack_reverse`` and
``gather_dist`` in a copy of its ``insert_batch_step`` whose two row writes
drop the padding lanes. The reference itself pads each batch with INVALID
ids mapped to row 0, and its two scatters then write node 0's old row back
over an update to node 0 (duplicate indices, the last write wins on its CPU
backend); ``test_reference_row0_padding_write`` shows that on the one row
it touches. On random floats near-tied α tests may fall either way, so the
graphs are held by AP against the oracle.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.configs import range_engine as jax_deploy
from repro.core.build import _pack_reverse as jax_pack_reverse
from repro.core.build import robust_prune as jax_robust_prune
from repro.core.distances import gather_dist as jax_gather_dist
from repro.core.distances import point_dist as jax_point_dist
from repro.core.graph import Graph as JGraph
from repro.core.graph import medoid as jax_medoid
from repro_torch.configs import range_engine as deploy
from repro_torch.core import (
    BuildConfig, Graph, RangeConfig, RangeSearchEngine, SearchConfig,
    average_precision, build_vamana, exact_range_search, insert_batch_step,
    robust_prune)
from repro_torch.core.build import _pack_reverse
from repro_torch.utils import INVALID_ID

_RIG: dict = {}


# ---------------------------------------------------------------------------
# the masked reference
# ---------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("cfg", "alpha"))
def _masked_insert_batch_step(points, nbr_rows, batch_ids, start_ids, cfg, alpha):
    """The reference's ``insert_batch_step`` with both row writes sent out
    of range (dropped) for the padding lanes."""
    n = points.shape[0]
    R = cfg.max_degree
    active = batch_ids != INVALID_ID
    safe_ids = jnp.where(active, batch_ids, 0)
    qs = jnp.take(points, safe_ids, axis=0)
    st = J.beam_search_batch(points, JGraph(neighbors=nbr_rows), qs, start_ids,
                             jnp.asarray(jnp.inf, jnp.float32), cfg.search_cfg)
    prune = jax.vmap(partial(jax_robust_prune, points, alpha=alpha, R=R,
                             metric=cfg.metric))
    new_rows = prune(qs, cand_ids=jnp.concatenate([st.visited_ids, st.ids], 1),
                     cand_dists=jnp.concatenate([st.visited_dists, st.dists], 1),
                     self_id=safe_ids)
    new_rows = jnp.where(active[:, None], new_rows, INVALID_ID)
    nbr_rows = nbr_rows.at[jnp.where(active, batch_ids, n)].set(new_rows, mode="drop")

    B = batch_ids.shape[0]
    dst_flat = new_rows.reshape(-1)
    src_flat = jnp.broadcast_to(batch_ids[:, None], (B, R)).reshape(-1)
    src_flat = jnp.where(dst_flat != INVALID_ID, src_flat, INVALID_ID)
    uniq_dst, rev_srcs = jax_pack_reverse(dst_flat, src_flat, cfg.rev_cap)

    def fix_row(dst, revs):
        ok = dst != INVALID_ID
        dstv = jnp.where(ok, dst, 0)
        merged = jnp.concatenate([nbr_rows[dstv], revs])
        order = jnp.arange(merged.shape[0])
        m_valid = (merged != INVALID_ID) & (merged != dstv)
        dup = jnp.any((merged[:, None] == merged[None, :])
                      & (order[None, :] < order[:, None]) & m_valid[:, None], axis=1)
        m_valid &= ~dup
        merged = jnp.where(m_valid, merged, INVALID_ID)
        pvec = points[dstv]
        dists = jax_gather_dist(points, merged, pvec, cfg.metric)
        pruned = jax_robust_prune(points, pvec, merged, dists, alpha, R, cfg.metric,
                                  self_id=dstv)
        merged_sorted = jnp.sort(merged)[:R]
        row = jnp.where(jnp.sum(m_valid) > R, pruned, merged_sorted)
        return jnp.where(ok, row, INVALID_ID), jnp.where(ok, dstv, n)

    rows, dst = jax.lax.map(lambda t: fix_row(*t), (uniq_dst, rev_srcs), batch_size=1024)
    return nbr_rows.at[dst].set(rows, mode="drop")


def _masked_build(points, cfg, seed=0):
    """The reference's ``build_vamana`` loop over the masked step."""
    pts = jnp.asarray(points)
    n = pts.shape[0]
    order = np.random.default_rng(seed).permutation(n).astype(np.int32)
    start = jax_medoid(pts)
    seed_ids = jnp.asarray(order[:cfg.max_degree])
    nbr_rows = jnp.full((n, cfg.max_degree), INVALID_ID, jnp.int32).at[start].set(
        jnp.where(seed_ids == start, INVALID_ID, seed_ids))
    for alpha in ([1.0, cfg.alpha] if cfg.two_pass else [cfg.alpha]):
        done, bsize = 0, min(64, cfg.insert_batch)
        while done < n:
            take = min(bsize, n - done)
            batch = np.full((cfg.insert_batch,), INVALID_ID, np.int32)
            batch[:take] = order[done:done + take]
            nbr_rows = _masked_insert_batch_step(pts, nbr_rows, jnp.asarray(batch),
                                                 start[None], cfg, alpha)
            done += take
            bsize = min(bsize * 2, cfg.insert_batch)
    return np.asarray(nbr_rows)


def _integer_points(n=2000, d=8, seed=0):
    return np.random.default_rng(seed).integers(-8, 9, (n, d)).astype(np.float32)


def _cfgs(metric="l2", **kw):
    kw = dict(dict(max_degree=16, beam=32, insert_batch=256, metric=metric), **kw)
    return J.BuildConfig(**kw), BuildConfig(**kw)


def _check_graph(nbrs):
    """No out-of-range id, self loop or duplicate in any row."""
    n = nbrs.shape[0]
    valid = nbrs != INVALID_ID
    assert ((nbrs[valid] >= 0) & (nbrs[valid] < n)).all()
    assert not (nbrs == np.arange(n)[:, None]).any()
    for row in nbrs:
        ids = row[row != INVALID_ID]
        assert ids.size == np.unique(ids).size


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_robust_prune_matches_jax(metric):
    """Fixed candidate lists with INVALID, duplicate and self entries, on
    integer points (many exact ties: the first minimum wins in both)."""
    rng = np.random.default_rng(1)
    pts = rng.integers(-4, 5, (300, 6)).astype(np.float32)
    b, c, R = 24, 40, 10
    self_id = rng.integers(0, 300, b).astype(np.int32)
    cand = rng.integers(0, 300, (b, c)).astype(np.int32)
    cand[:, 5] = cand[:, 2]                   # duplicates
    cand[::3, 7] = self_id[::3]               # the node itself
    cand[:, -6:] = INVALID_ID                 # padding
    cand[1::4, 10:20] = INVALID_ID
    safe = np.where(cand == INVALID_ID, 0, cand)
    dists = np.asarray(jax_point_dist(pts[safe], pts[self_id][:, None], metric))
    dists = np.where(cand == INVALID_ID, np.inf, dists).astype(np.float32)
    for alpha in (1.0, 1.2):
        want = jax.vmap(partial(jax_robust_prune, jnp.asarray(pts), alpha=alpha, R=R,
                                metric=metric))(
            jnp.asarray(pts[self_id]), cand_ids=jnp.asarray(cand),
            cand_dists=jnp.asarray(dists), self_id=jnp.asarray(self_id))
        got = robust_prune(torch.from_numpy(pts), torch.from_numpy(pts[self_id]),
                           torch.from_numpy(cand), torch.from_numpy(dists), alpha, R,
                           metric, self_id=torch.from_numpy(self_id))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert (got.numpy() == INVALID_ID).any() and (got.numpy() != INVALID_ID).any()


def test_pack_reverse_matches_jax():
    rng = np.random.default_rng(2)
    for m, cap in ((64, 4), (513, 8)):
        dst = rng.integers(0, 40, m).astype(np.int32)
        dst[rng.random(m) < 0.2] = INVALID_ID
        src = rng.integers(0, 1000, m).astype(np.int32)
        src[dst == INVALID_ID] = INVALID_ID
        ju, jr = jax_pack_reverse(jnp.asarray(dst), jnp.asarray(src), cap)
        tu, tr = _pack_reverse(torch.from_numpy(dst), torch.from_numpy(src), cap)
        np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_insert_batch_step_matches_masked_reference():
    """One padded insert batch from a shared graph state (half the points
    inserted by the masked reference), batch containing node 0."""
    pts = _integer_points()
    jcfg, tcfg = _cfgs()
    half = _masked_build(pts[:1000], jcfg)
    state = np.full((2000, 16), INVALID_ID, np.int32)
    state[:1000] = half
    start = np.array(jax_medoid(jnp.asarray(pts[:1000])))[None]
    batch = np.full((256,), INVALID_ID, np.int32)
    batch[:200] = np.arange(1000, 1200)
    batch[7] = 0                     # an existing node re-inserted
    want = _masked_insert_batch_step(jnp.asarray(pts), jnp.asarray(state),
                                     jnp.asarray(batch), jnp.asarray(start), jcfg, 1.2)
    before = torch.from_numpy(state.copy())
    got = insert_batch_step(torch.from_numpy(pts), before, torch.from_numpy(batch),
                            torch.from_numpy(start), tcfg, 1.2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(before.numpy(), state)   # input not modified
    assert (got.numpy()[batch[:200]] != INVALID_ID).any(1).all()


# ---------------------------------------------------------------------------
# whole builds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,two_pass", [("l2", False), ("ip", False), ("l2", True)])
def test_build_vamana_matches_masked_reference(metric, two_pass):
    pts = _integer_points()
    jcfg, tcfg = _cfgs(metric, two_pass=two_pass)
    want = _masked_build(pts, jcfg)
    timings = {}
    got = build_vamana(pts, tcfg, device="cpu", timings=timings).neighbors.numpy()
    np.testing.assert_array_equal(got, want)
    _check_graph(got)
    assert set(timings) == {"search", "prune", "reverse"}


def test_reference_row0_padding_write():
    """n=600, d=8 standard normal (seed 0), R=8, beam 16, batches of 128:
    the reference's row 0 is node 0's row from before its last update
    (written back by padding lanes); the port's equals the masked
    reference's, and so does every other row."""
    pts = np.random.default_rng(0).standard_normal((600, 8)).astype(np.float32)
    jcfg = J.BuildConfig(max_degree=8, beam=16, insert_batch=128)
    ref = np.asarray(J.build_vamana(jnp.asarray(pts), jcfg).neighbors)
    masked = _masked_build(pts, jcfg)
    got = build_vamana(pts, BuildConfig(max_degree=8, beam=16, insert_batch=128),
                       device="cpu").neighbors.numpy()
    np.testing.assert_array_equal(ref[0], [365, 370, 576, 395, 513, 438, 85, 440])
    np.testing.assert_array_equal(masked[0], [4, 365, 572, 370, 369, 458, 569, 576])
    np.testing.assert_array_equal(got, masked)
    assert not np.array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1:], ref[1:])


def _float_rig():
    if "float" not in _RIG:
        rng = np.random.default_rng(4)
        centers = rng.standard_normal((8, 16)).astype(np.float32) * 3
        pts = (centers[rng.integers(0, 8, 2000)]
               + rng.standard_normal((2000, 16)).astype(np.float32) * 0.4).astype(np.float32)
        _RIG["float"] = pts
    return _RIG["float"]


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_build_on_random_floats_answers_like_jax(metric):
    """The port's graph and the reference's, each searched by the port's
    engine: AP against the oracle within 0.01."""
    pts = _float_rig()
    jcfg, tcfg = _cfgs(metric)
    jg = J.build_vamana(jnp.asarray(pts), jcfg)
    tg = build_vamana(pts, tcfg, device="cpu")
    _check_graph(tg.neighbors.numpy())
    qs = pts[:64] + 0.01
    exact = np.asarray(jax_point_dist(pts[None], qs[:, None], metric))
    r = np.array([np.quantile(exact[i], 0.03) for i in range(64)], np.float32)
    gt_ids, _, gt_counts = exact_range_search(pts, qs, r, metric=metric, device="cpu")
    cfg = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                          metric=metric), result_cap=512)
    aps = []
    for nbrs in (np.asarray(jg.neighbors), tg.neighbors.numpy()):
        eng = RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)),
                                           metric=metric, device="cpu")
        res = eng.range(qs, r, cfg=cfg)
        aps.append(average_precision(gt_ids.numpy(), gt_counts.numpy(),
                                     res.ids.numpy(), res.count.numpy()))
    # the floors are tests/test_oracle.py's greedy ones (ip graphs navigate worse)
    assert aps[1] >= {"l2": 0.70, "ip": 0.40}[metric] and abs(aps[0] - aps[1]) <= 0.01, aps


def test_engine_build_equals_from_graph_over_build_vamana():
    pts = _integer_points(600)
    _, tcfg = _cfgs()
    labels = np.arange(600, dtype=np.uint32)[:, None] % 3
    eng = RangeSearchEngine.build(pts, tcfg, seed=3, corpus_dtype="int8",
                                  labels=labels, device="cpu")
    graph = build_vamana(pts, tcfg, seed=3, device="cpu")
    ref = RangeSearchEngine.from_graph(pts, graph, corpus_dtype="int8", device="cpu")
    assert torch.equal(eng.graph.neighbors, graph.neighbors)
    assert torch.equal(eng.start_ids, ref.start_ids)
    assert torch.equal(eng.points.codes, ref.points.codes)
    assert eng.labels.shape == (600, 1) and eng.stats()["corpus_dtype"] == "int8"
    jeng = J.RangeSearchEngine.from_graph(jnp.asarray(pts), JGraph(
        neighbors=jnp.asarray(graph.neighbors.numpy())))
    np.testing.assert_array_equal(eng.start_ids.numpy(), np.asarray(jeng.start_ids))
    with pytest.raises(ValueError):
        RangeSearchEngine.from_graph(pts, graph, labels=labels[:10], device="cpu")


# ---------------------------------------------------------------------------
# the deploy config
# ---------------------------------------------------------------------------

def _assert_fields_equal(t, j, path="cfg"):
    """Every field of the reference's config equal in the port's (the port's
    SearchConfig adds ``use_kernels``)."""
    for f in dataclasses.fields(j):
        a, b = getattr(t, f.name), getattr(j, f.name)
        if dataclasses.is_dataclass(b):
            _assert_fields_equal(a, b, f"{path}.{f.name}")
        else:
            assert a == b, f"{path}.{f.name}: {a!r} != {b!r}"


def test_deploy_config_matches_jax():
    _assert_fields_equal(deploy.EngineDeployConfig(), jax_deploy.EngineDeployConfig())
    _assert_fields_equal(deploy.reduced(), jax_deploy.reduced())
    for kw in (dict(corpus_dtype="int8"), dict(metric="ip"),
               dict(max_beam=256), dict(mode="doubling", max_beam=256),
               dict(lam=0.5), dict(result_cap=4096, beam=32),
               dict(use_expand_kernel=True, filter_threshold=0.1),
               dict(shard_corpus=10, dim=16)):
        _assert_fields_equal(deploy.EngineDeployConfig().overrides(**kw),
                             jax_deploy.EngineDeployConfig().overrides(**kw), str(kw))
    c = deploy.EngineDeployConfig().overrides(corpus_dtype="int8")
    assert c.corpus_dtype == c.range_cfg.search.corpus_dtype == "int8"
    c = deploy.EngineDeployConfig(range_cfg=RangeConfig(search=SearchConfig(
        corpus_dtype="bfloat16")))
    assert c.corpus_dtype == "bfloat16"
    assert deploy.EngineDeployConfig().overrides(metric="ip").range_cfg.search.metric == "ip"
    assert deploy.EngineDeployConfig().overrides(use_kernels=False).range_cfg.search.use_kernels is False
    with pytest.raises(TypeError):
        deploy.EngineDeployConfig().overrides(bogus=1)
    with pytest.raises(ValueError):
        deploy.EngineDeployConfig(corpus_dtype="int8", range_cfg=RangeConfig(
            search=SearchConfig(corpus_dtype="bfloat16")))
    with pytest.raises(ValueError):
        SearchConfig(corpus_dtype="int4")

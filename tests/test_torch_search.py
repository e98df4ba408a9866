"""The port's search loops against the JAX package, lane by lane.

Both packages search the same index: a Vamana graph built by
``repro.core.build_vamana`` and carried across as numpy arrays
(``repro_torch.convert.engine_from_arrays``). The reference runs each lane
in a vmapped ``while_loop``; the port runs one batched loop that freezes
finished lanes. Every lane's trajectory must be the same: ids, flags,
counters and bitset words equal; distances ``allclose(rtol=1e-5,
atol=1e-6)`` (a different summation order costs a few ulp; ip radii here
are O(10), so a 1e-6 absolute floor is a relative one too).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import (
    BuildConfig, RangeSearchEngine, build_vamana, greedy_search)
from repro.core import SearchConfig as JSearch
from repro.core import beam_search_batch as jax_beam_search_batch
from repro.core.beam_search import _merge_sorted as jax_merge
from repro.core.distances import point_dist
from repro.core.range_search import RangeConfig as JRange
from repro.core.range_search import range_phase1 as jax_phase1
from repro_torch.convert import engine_from_arrays
from repro_torch.core import ES_D_VISITED, SearchConfig, beam_search_batch
from repro_torch.core import greedy_search as torch_greedy_search
from repro_torch.core.beam_search import _merge_sorted
from repro_torch.core.range_search import RangeConfig, range_phase1
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-6)
_RIG: dict = {}


def _toy(n=2000, d=16, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 8, n)]
           + rng.standard_normal((n, d)).astype(np.float32) * 0.4)
    return pts.astype(np.float32)


def _rig(metric):
    """(JAX engine, port engine on the same index, queries, mixed radii)."""
    if metric not in _RIG:
        pts = _toy()
        graph = build_vamana(jnp.asarray(pts), BuildConfig(
            max_degree=16, beam=32, insert_batch=256, metric=metric))
        jeng = RangeSearchEngine.from_graph(jnp.asarray(pts), graph, metric=metric)
        teng = engine_from_arrays(pts, np.asarray(graph.neighbors),
                                  np.asarray(jeng.start_ids), metric, device="cpu")
        qs = pts[:32] + 0.01
        exact = np.asarray(point_dist(pts[None], qs[:, None], metric))
        quant = np.linspace(0.02, 0.10, qs.shape[0])
        radii = np.array([np.quantile(exact[i], quant[i])
                          for i in range(qs.shape[0])], np.float32)
        _RIG[metric] = (jeng, teng, qs, radii)
    return _RIG[metric]


def _per_lane_starts(jeng, q, seed=0):
    """(Q, 8) starts: the defaults, then lane-specific ids, one duplicate of
    a default and INVALID padding (duplicates collapse in init_state)."""
    rng = np.random.default_rng(seed)
    s0 = np.asarray(jeng.start_ids)
    n = jeng.points.shape[0]
    extra = rng.integers(0, n, (q, 4)).astype(np.int32)
    extra[:, 2] = s0[0]
    extra[::3, 3] = INVALID_ID
    return np.concatenate([np.broadcast_to(s0, (q, s0.size)), extra], 1)


def _assert_state_equal(jst, tst):
    for f in ("ids", "expanded", "active_width", "n_visited", "visited_ids",
              "n_dist", "es_stopped", "done"):
        np.testing.assert_array_equal(getattr(tst, f).numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    np.testing.assert_array_equal(tst.visited_bits.numpy(),
                                  np.asarray(jst.visited_bits).view(np.int32))
    for f in ("dists", "visited_dists", "d_visited", "d_start"):
        a, b = getattr(tst, f).numpy(), np.asarray(getattr(jst, f))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b), err_msg=f)
        np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)],
                                   err_msg=f, **TOL)


def _cfgs(metric, e, **kw):
    kw = dict(beam=16, max_beam=32, visit_cap=96, metric=metric,
              expand_width=e, **kw)
    return JSearch(**kw), SearchConfig(**kw)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("e", [1, 4])
@pytest.mark.parametrize("starts", ["shared", "per_lane"])
def test_beam_search_batch_matches_jax(metric, e, starts):
    """In-place doubling (max_beam > beam), mixed per-lane radii, shared or
    per-lane start points."""
    jeng, teng, qs, radii = _rig(metric)
    s = (np.asarray(jeng.start_ids) if starts == "shared"
         else _per_lane_starts(jeng, qs.shape[0]))
    jcfg, tcfg = _cfgs(metric, e)
    jst = jax_beam_search_batch(jeng.points, jeng.graph, jnp.asarray(qs),
                                jnp.asarray(s), jnp.asarray(radii), jcfg)
    tst = beam_search_batch(teng.points, teng.graph, torch.from_numpy(qs),
                            torch.from_numpy(np.array(s)),
                            torch.from_numpy(radii), tcfg)
    _assert_state_equal(jst, tst)


def _far_lanes(jeng, qs, radii, seed=1):
    """Half the lanes replaced by off-manifold queries with zero-result
    radii, whose early-stop radii straddle their nearest distance."""
    rng = np.random.default_rng(seed)
    pts = np.asarray(jeng.points)
    h = qs.shape[0] // 2
    far = (rng.standard_normal((h, pts.shape[1])) * 6).astype(np.float32)
    dmin = np.asarray(point_dist(pts[None], far[:, None], "l2")).min(axis=1)
    qs = np.concatenate([qs[:h], far]).astype(np.float32)
    r = np.concatenate([radii[:h], 0.5 * dmin]).astype(np.float32)
    es = np.concatenate([np.full(h, np.inf), dmin * np.linspace(0.8, 1.6, h)])
    return qs, r, es.astype(np.float32)


@pytest.mark.parametrize("e", [1, 4])
def test_beam_search_hashed_bitset_and_early_stop(e):
    """The hashed seen-filter regime (2000 nodes into 512 bits) and
    d_visited early stopping with per-lane stop radii."""
    jeng, teng, qs, radii = _rig("l2")
    qs, radii, es = _far_lanes(jeng, qs, radii)
    jcfg, tcfg = _cfgs("l2", e, bitset_cap_bits=512, es_metric=ES_D_VISITED,
                       es_visit_limit=8)
    jst = jax_beam_search_batch(jeng.points, jeng.graph, jnp.asarray(qs),
                                jeng.start_ids, jnp.asarray(radii), jcfg,
                                jnp.asarray(es))
    tst = beam_search_batch(teng.points, teng.graph, torch.from_numpy(qs),
                            teng.start_ids, torch.from_numpy(radii), tcfg,
                            torch.from_numpy(es))
    assert tst.es_stopped.any() and not tst.es_stopped.all()
    _assert_state_equal(jst, tst)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_range_phase1_matches_jax(metric):
    jeng, teng, qs, radii = _rig(metric)
    radii = np.where(np.arange(qs.shape[0]) % 2 == 0, radii,
                     radii - np.abs(radii)).astype(np.float32)  # mixed need
    jcfg = JRange(search=JSearch(beam=16, max_beam=16, visit_cap=64,
                                 metric=metric), result_cap=32)
    tcfg = RangeConfig(search=SearchConfig(beam=16, max_beam=16, visit_cap=64,
                                           metric=metric), result_cap=32)
    jst, jres, jneed = jax_phase1(jeng.points, jeng.graph, jnp.asarray(qs),
                                  jeng.start_ids, jnp.asarray(radii), jcfg)
    tst, tres, tneed = range_phase1(teng.points, teng.graph, torch.from_numpy(qs),
                                    teng.start_ids, torch.from_numpy(radii), tcfg)
    _assert_state_equal(jst, tst)
    np.testing.assert_array_equal(tneed.numpy(), np.asarray(jneed))
    assert tneed.any() and not tneed.all()
    for f in ("ids", "count", "overflow", "n_visited", "n_dist", "phase2"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)


@pytest.mark.parametrize("e", [1, 4])
@pytest.mark.parametrize("cap_bits", [1 << 20, 512])
def test_greedy_search_matches_jax(e, cap_bits):
    """Phase 2 from identical beam states, with a small result cap (drops
    and overflow) and a small expansion budget, in the exact and hashed
    bitset regimes."""
    jeng, teng, qs, radii = _rig("l2")
    jcfg, tcfg = _cfgs("l2", e, bitset_cap_bits=cap_bits)
    radii = radii * 2.0  # wide balls: buffers fill and overflow
    jst = jax_beam_search_batch(jeng.points, jeng.graph, jnp.asarray(qs),
                                jeng.start_ids, jnp.asarray(radii), jcfg)
    tst = beam_search_batch(teng.points, teng.graph, torch.from_numpy(qs),
                            teng.start_ids, torch.from_numpy(radii), tcfg)
    cap, rounds = 96, 40
    active = np.arange(qs.shape[0]) % 5 != 0
    jgs = jax.vmap(lambda q, r, s, a: greedy_search(
        jeng.points, jeng.graph, q, r, s, cap, rounds, jcfg, a))(
            jnp.asarray(qs), jnp.asarray(radii), jst, jnp.asarray(active))
    tgs = torch_greedy_search(teng.points, teng.graph, torch.from_numpy(qs),
                              torch.from_numpy(radii), tst, cap, rounds, tcfg,
                              torch.from_numpy(active))
    for f in ("res_ids", "res_count", "expand_ptr", "rounds", "overflow", "n_dist"):
        np.testing.assert_array_equal(getattr(tgs, f).numpy(),
                                      np.asarray(getattr(jgs, f)), err_msg=f)
    assert tgs.overflow.any() and (tgs.res_count == cap).any()
    a, b = tgs.res_dists.numpy(), np.asarray(jgs.res_dists)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], **TOL)


def test_merge_sorted_ties_match_jax():
    """Equal distances across the beam and the tile: the beam wins ties,
    then the lower position; the ±0.0 and +inf entries keep total order."""
    rng = np.random.default_rng(3)
    q, lb, t = 4, 12, 20
    vals = np.array([0.5, 1.0, 1.0, 2.0, -0.0, 0.0, np.inf], np.float32)
    b_d = np.sort(rng.choice(vals, (q, lb)), axis=1).astype(np.float32)
    c_d = rng.choice(vals, (q, t)).astype(np.float32)
    b_i = rng.integers(0, 100, (q, lb)).astype(np.int32)
    c_i = rng.integers(0, 100, (q, t)).astype(np.int32)
    b_e = rng.random((q, lb)) < 0.5
    got = _merge_sorted(*(torch.from_numpy(x) for x in (b_i, b_d, b_e, c_i, c_d)), lb)
    for i in range(q):
        want = jax_merge(*(jnp.asarray(x[i]) for x in (b_i, b_d, b_e, c_i, c_d)), lb)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
        np.testing.assert_array_equal(got[1][i].numpy().view(np.int32),
                                      np.asarray(want[1]).view(np.int32))


def test_frozen_lanes_keep_their_state():
    """A lane that finishes early is frozen: running it alone or inside a
    batch whose other lanes run longer gives the same state."""
    jeng, teng, qs, radii = _rig("l2")
    _, tcfg = _cfgs("l2", 4)
    batch = beam_search_batch(teng.points, teng.graph, torch.from_numpy(qs),
                              teng.start_ids, torch.from_numpy(radii), tcfg)
    lane = int(torch.argmin(batch.n_visited))
    alone = beam_search_batch(teng.points, teng.graph,
                              torch.from_numpy(qs[lane:lane + 1]),
                              teng.start_ids, torch.from_numpy(radii[lane:lane + 1]),
                              tcfg)
    for f in dataclasses.fields(alone):
        np.testing.assert_array_equal(getattr(alone, f.name)[0].numpy(),
                                      getattr(batch, f.name)[lane].numpy(),
                                      err_msg=f.name)

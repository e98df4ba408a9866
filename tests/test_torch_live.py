"""The port's live index against the JAX package's, and its own invariants.

Two rigs, both the reference's:

* **Integer coordinates** (``tests/test_torch_build.py``'s): every distance
  is an exact integer in f32 whatever the order of a sum, so the two
  packages make the same decision at every tie and their graphs must agree
  row for row. The JAX ``LiveIndex`` inserts through the reference's
  ``insert_batch_step``, whose padding lanes write node 0's old row back
  (ROADMAP.md §3); it is held here with the *masked* step
  (``tests/test_torch_build.py::_masked_insert_batch_step``) patched into
  ``repro.live.index``. After the same stream of inserts, deletes and
  consolidations, the two indices' neighbour rows, external ids, tombstones,
  entry points, counters, raw rows and (int8) codes are equal, and metadata
  ``allclose(rtol=1e-5, atol=1e-6)`` (the norms and errors are f32 sums over d
  terms, summed in another order). Served over ``RangeServer(live=)`` on one
  request stream, every ``Response`` equals JAX's field by field (ids,
  counts, flags, epoch, latency on a fake clock; distances exact, being
  integers), and so do the counters.
* **The clustered rig** (``tests/test_live.py``'s: 700 x 10, the
  reference's two-pass Vamana graph carried across): greedy range search
  recovers exact in-range sets there, so after a churn stream the two
  packages' answers are equal as sets (and equal to the live-set oracle on
  lanes that did not overflow).

The rest ports the reference's single-index live tests
(``tests/test_live.py``), the tier's write-through tests
(``tests/test_tier.py``) and the served mutation test
(``tests/test_train_serve.py``) to the port alone, and holds snapshot
isolation: a snapshot answers bit for bit as it did, whatever the index
does afterwards.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.live as JL
import repro.live.consolidate as jconsolidate
import repro.live.index as jlive_index
from repro.core.corpus import corpus_raw as jax_corpus_raw
from repro.core.corpus import corpus_set_rows as jax_corpus_set_rows
from repro.core.corpus import corpus_take_rows as jax_corpus_take_rows
from repro.core.corpus import corpus_with_capacity as jax_corpus_with_capacity
from repro.core.corpus import pad_corpus_rows as jax_pad_corpus_rows
from repro.serve import RangeServer as JRangeServer
from repro.serve import Request as JRequest
from repro.serve import ServerConfig as JServerConfig
from repro_torch.core import (
    BuildConfig, Graph, RangeConfig, RangeSearchEngine, SearchConfig, build_vamana,
    corpus_raw, corpus_set_rows, corpus_take_rows, corpus_with_capacity, pad_corpus_rows,
    quantize_corpus)
from repro_torch.live import FAR, LiveConfig, LiveIndex, consolidate_index, externalize_ids
from repro_torch.live.consolidate import _rewire
from repro_torch.serve import RangeServer, Request, ServerConfig
from repro_torch.tier import HostRowStore
from repro_torch.train import CheckpointManager
from repro_torch.utils import INVALID_ID
from test_torch_build import _masked_insert_batch_step

META_TOL = dict(rtol=1e-5, atol=1e-6)   # tests/test_torch_int8.py's metadata tolerance
# int8 results keep the certified lower bound of a sure member's distance:
# the two frameworks sum its terms in different orders (a few ulp)
DIST_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only spin,
    and under the parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def masked(monkeypatch):
    """The JAX LiveIndex inserts through the masked reference step."""
    monkeypatch.setattr(jlive_index, "insert_batch_step", _masked_insert_batch_step)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# rigs
# ---------------------------------------------------------------------------

IBCFG = dict(max_degree=12, beam=24, insert_batch=128)
ILCFG = dict(capacity=800, insert_batch=32, consolidate_at=0.2)
D_INT = 8


def _int_cfgs(corpus_dtype="float32"):
    """(JAX, port) range configs of the integer rig's searches: one shape
    of each program, so the JAX package compiles it once a test process."""
    s = dict(beam=24, max_beam=24, visit_cap=96, corpus_dtype=corpus_dtype)
    return (J.RangeConfig(search=J.SearchConfig(**s), mode="greedy", result_cap=256),
            RangeConfig(search=SearchConfig(**s), mode="greedy", result_cap=256))


def _ints(n, seed):
    return np.random.default_rng(seed).integers(-8, 9, (n, D_INT)).astype(np.float32)


@pytest.fixture(scope="module")
def int_rig():
    """(points (600, 8), their Vamana graph (the port's CPU build, equal row
    for row to the masked reference's), a stream of 200 integer vectors)."""
    pts = _ints(600, 0)
    graph = build_vamana(pts, BuildConfig(**IBCFG), device="cpu")
    return pts, graph.neighbors.numpy(), _ints(200, 5)


def _int_pair(int_rig, corpus_dtype="float32", labels=None):
    pts, nbrs, _ = int_rig
    kw = dict(corpus_dtype=corpus_dtype)
    j = JL.LiveIndex.create(jnp.asarray(pts), JL.LiveConfig(**ILCFG), J.BuildConfig(**IBCFG),
                            graph=J.Graph(jnp.asarray(nbrs)),
                            labels=None if labels is None else jnp.asarray(labels), **kw)
    t = LiveIndex.create(pts, LiveConfig(**ILCFG), BuildConfig(**IBCFG),
                         graph=Graph(torch.from_numpy(nbrs)), labels=labels,
                         device="cpu", **kw)
    return j, t


def _state(idx) -> dict:
    """The mutable state of either package's index, as numpy."""
    pts = idx.points
    out = dict(neighbors=_np(idx.neighbors), start_ids=_np(idx.start_ids),
               ext_ids=_np(idx.ext_ids),
               tombstones=_np(idx.tombstones).view(np.uint32),
               counters=np.asarray([idx.live_count, idx.next_ext_id, idx.epoch, idx.wal_seq]),
               dead=np.asarray(sorted(idx._dead), np.int64),
               raw=_np(corpus_raw(pts) if isinstance(idx, LiveIndex) else jax_corpus_raw(pts)))
    hot = getattr(pts, "device", pts) if getattr(pts, "is_tiered", False) else pts
    if hasattr(hot, "codes"):
        out["codes"], out["meta"] = _np(hot.codes), _np(hot.meta)
    if idx.labels is not None:
        out["labels"] = _np(idx.labels).view(np.uint32)
    return out


def _assert_state(t, j):
    st, sj = _state(t), _state(j)
    assert st.keys() == sj.keys()
    for k in sj:
        if k == "meta":
            np.testing.assert_allclose(st[k], sj[k], **META_TOL, err_msg=k)
        else:
            np.testing.assert_array_equal(st[k], sj[k], err_msg=k)


@pytest.fixture(scope="module")
def clustered():
    """tests/test_live.py's rig: (points (700, 10), the reference's two-pass
    Vamana graph, a stream of 120 points)."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, 10)).astype(np.float32) * 3
    pts = (centers[rng.integers(0, 8, 700)]
           + rng.standard_normal((700, 10)).astype(np.float32) * 0.4).astype(np.float32)
    graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
        max_degree=24, beam=48, insert_batch=256, two_pass=True))
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((8, 10)).astype(np.float32) * 3
    stream = (centers[rng.integers(0, 8, 120)]
              + rng.standard_normal((120, 10)).astype(np.float32) * 0.4).astype(np.float32)
    return pts, np.array(graph.neighbors), stream


BCFG = BuildConfig(max_degree=24, beam=48, insert_batch=256, two_pass=True)
LCFG = LiveConfig(capacity=1024, insert_batch=64, consolidate_at=0.25)
CFG = RangeConfig(search=SearchConfig(beam=64, max_beam=64, visit_cap=256),
                  mode="greedy", result_cap=512)


def _live(clustered, corpus_dtype="float32", **kw):
    pts, nbrs, _ = clustered
    return LiveIndex.create(pts, kw.pop("cfg", LCFG), BCFG, corpus_dtype=corpus_dtype,
                            graph=Graph(torch.from_numpy(nbrs)), device="cpu", **kw)


def _sets(res):
    ids = _np(res.ids)
    return [set(row[row != INVALID_ID].tolist()) for row in ids]


def _oracle_sets(live, qs, radii):
    ext, vecs = live.live_vectors()
    exact = ((vecs[None].astype(np.float64) - np.asarray(qs)[:, None]) ** 2).sum(-1)
    return [set(ext[exact[i] <= radii[i]].tolist()) for i in range(len(qs))]


def _mixed_radii(qs, lo=1.0, hi=6.0, seed=3):
    return np.random.default_rng(seed).uniform(lo, hi, len(qs)).astype(np.float32)


# ---------------------------------------------------------------------------
# the corpus helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_corpus_helpers_match_jax(corpus_dtype):
    """``corpus_with_capacity`` / ``pad_corpus_rows``, ``corpus_set_rows``
    with inactive lanes, ``corpus_take_rows``: rows and codes bit for bit,
    metadata to META_TOL; the inputs untouched (functional)."""
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((40, 12)).astype(np.float32) * 3
    vecs = rng.standard_normal((8, 12)).astype(np.float32)
    slots = np.arange(40, 48, dtype=np.int32)
    active = np.arange(8) < 5
    if corpus_dtype == "int8":
        jc = J.quantize_corpus(jnp.asarray(pts))
        tc = quantize_corpus(torch.from_numpy(pts))
    else:
        jc, tc = jnp.asarray(pts), torch.from_numpy(pts)
    jcap, tcap = jax_corpus_with_capacity(jc, 64, FAR), corpus_with_capacity(tc, 64, FAR)
    before = {k: v.clone() for k, v in (dataclasses.asdict(tcap).items()
                                        if corpus_dtype == "int8" else [("x", tcap)])}
    jset = jax_corpus_set_rows(jcap, jnp.asarray(slots), jnp.asarray(vecs), jnp.asarray(active))
    tset = corpus_set_rows(tcap, torch.from_numpy(slots), torch.from_numpy(vecs),
                           torch.from_numpy(active))
    idx = np.asarray([3, 44, 0, 41, 63], np.int32)
    jtake, ttake = jax_corpus_take_rows(jset, jnp.asarray(idx)), corpus_take_rows(
        tset, torch.from_numpy(idx))
    for j, t in ((jcap, tcap), (jset, tset), (jtake, ttake)):
        if corpus_dtype == "int8":
            np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
            np.testing.assert_array_equal(t.raw.numpy(), np.asarray(j.raw))
            np.testing.assert_allclose(t.meta.numpy(), np.asarray(j.meta), **META_TOL)
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for k, v in (dataclasses.asdict(tcap).items() if corpus_dtype == "int8" else [("x", tcap)]):
        assert torch.equal(v, before[k]), k          # nothing written in place
    if corpus_dtype == "int8":
        jp = jax_pad_corpus_rows(jc, 5, FAR)
        tp = pad_corpus_rows(tc, 5, FAR)
        np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))
        np.testing.assert_array_equal(tp.meta.numpy()[40:], np.asarray(jp.meta)[40:])
        assert (tp.meta.numpy()[40:] == [0.0, np.float32(FAR), 0.0]).all()
        assert pad_corpus_rows(tc, 0, FAR) is tc
    with pytest.raises(ValueError, match="capacity"):
        corpus_with_capacity(tc, 10)
    assert corpus_with_capacity(tc, 40) is tc


# ---------------------------------------------------------------------------
# consolidation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.05, 0.3])
def test_consolidate_index_matches_jax(int_rig, frac):
    """``_rewire`` and ``consolidate_index`` row for row against the
    reference's (integer rig, 30 unborn slots past the watermark): the
    rewired rows, the compacted corpus, adjacency, entry points, ``perm``
    and the counts."""
    pts, nbrs, _ = int_rig
    cap, live_count = 630, 600
    jcfg, tcfg = J.BuildConfig(**IBCFG), BuildConfig(**IBCFG)
    graph = np.full((cap, nbrs.shape[1]), INVALID_ID, np.int32)
    graph[:600] = nbrs
    full = np.concatenate([pts, np.full((cap - 600, D_INT), FAR, np.float32)])
    dead = np.zeros(cap, bool)
    dead[np.random.default_rng(9).choice(600, int(frac * 600), replace=False)] = True
    want, jstats = jconsolidate._rewire(graph, dead, live_count, jnp.asarray(full), jcfg)
    got, tstats = _rewire(torch.from_numpy(graph), torch.from_numpy(dead), live_count,
                          torch.from_numpy(full), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert tstats == jstats and tstats["n_pruned"] > 0
    jout = jconsolidate.consolidate_index(jnp.asarray(full), jnp.asarray(graph), dead,
                                          live_count, jcfg, "l2", 4, far=FAR)
    tout = consolidate_index(torch.from_numpy(full), torch.from_numpy(graph), dead,
                             live_count, tcfg, "l2", 4, far=FAR)
    for name, j, t in zip(("points", "neighbors", "starts", "perm"), jout[:4], tout[:4]):
        np.testing.assert_array_equal(_np(t), np.asarray(j), err_msg=name)
    assert tout[4] == jout[4]


def test_consolidate_without_dead_rows_and_of_everything(int_rig):
    pts, nbrs, _ = int_rig
    same, stats = _rewire(torch.from_numpy(nbrs), torch.zeros(600, dtype=torch.bool), 600,
                          torch.from_numpy(pts), BuildConfig(**IBCFG))
    assert stats == dict(n_rewired=0, n_pruned=0) and torch.equal(same, torch.from_numpy(nbrs))
    with pytest.raises(ValueError, match="empty"):
        consolidate_index(torch.from_numpy(pts), torch.from_numpy(nbrs), np.ones(600, bool),
                          600, BuildConfig(**IBCFG), "l2", 4)


# ---------------------------------------------------------------------------
# the live index against JAX's
# ---------------------------------------------------------------------------

def _stream(j, t, ops):
    """Apply ``ops`` to both indices, holding the returns and the state
    equal after each."""
    for op, arg in ops:
        if op == "insert":
            a, b = j.insert(arg), t.insert(arg)
        elif op == "delete":
            a, b = j.delete(arg), t.delete(arg)
        elif op == "maybe":
            a, b = j.maybe_consolidate(), t.maybe_consolidate()
        else:
            a, b = j.consolidate(), t.consolidate()
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a, op
        _assert_state(t, j)


def _int_ops(stream):
    return [("insert", stream[:50]), ("delete", np.arange(0, 120, 3)),
            ("delete", np.asarray([600, 601, 605, 9999, 600])),   # fresh, unknown, repeat
            ("insert", stream[50:90]), ("consolidate", None),
            ("insert", stream[90:130]), ("delete", np.arange(200, 360)),
            ("maybe", None), ("maybe", None), ("insert", stream[130:200]),
            ("delete", np.arange(640, 700))]


@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_live_index_matches_jax(masked, int_rig, corpus_dtype):
    """The same mixed stream through both packages: the state equal after
    every operation (``_assert_state``), the returns equal, a threshold
    consolidation on both, and the answers equal lane for lane."""
    j, t = _int_pair(int_rig, corpus_dtype)
    _assert_state(t, j)
    _stream(j, t, _int_ops(int_rig[2]))
    assert t.epoch > 8 and t.stats() == j.stats()
    np.testing.assert_array_equal(t.live_vectors()[0], j.live_vectors()[0])
    np.testing.assert_array_equal(t.live_vectors()[1], j.live_vectors()[1])
    qs = int_rig[2][:8] + 0.5
    radii = np.where(np.arange(8) % 2 == 0, 40.5, 200.5).astype(np.float32)
    jcfg, tcfg = _int_cfgs(corpus_dtype)
    jr = j.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg)
    tr = t.range(qs, radii, cfg=tcfg)
    for f in ("ids", "count", "overflow", "n_visited", "n_dist", "n_rerank"):
        np.testing.assert_array_equal(_np(getattr(tr, f)), np.asarray(getattr(jr, f)), f)
    if corpus_dtype == "float32":   # exact: sums of squares of half-integers
        np.testing.assert_array_equal(_np(tr.dists), np.asarray(jr.dists))
    else:
        np.testing.assert_allclose(_np(tr.dists), np.asarray(jr.dists), **DIST_TOL)
    assert int(_np(tr.count).sum()) > 0 and _np(tr.phase2).any()


def test_labeled_live_index_matches_jax(masked, int_rig):
    """Label rows ride inserts and move with their slots through
    consolidation: the label store equals JAX's after every operation."""
    from repro_torch.core import make_mask, pack_labels
    rng = np.random.default_rng(12)
    labels = pack_labels([rng.choice(40, 2, replace=False) for _ in range(600)], 40)
    j, t = _int_pair(int_rig, labels=labels)
    stream = int_rig[2]
    rows = np.stack([make_mask([i % 40, 39], 40) for i in range(60)])
    np.testing.assert_array_equal(t.insert(stream[:60], labels=rows),
                                  j.insert(stream[:60], labels=rows))
    _assert_state(t, j)
    _stream(j, t, [("insert", stream[60:80]), ("delete", np.arange(0, 600, 4)),
                   ("consolidate", None)])
    with pytest.raises(ValueError, match="labels shape"):
        t.insert(stream[:2], labels=rows[:1])


def test_live_results_match_jax_as_sets(masked, clustered):
    """The clustered rig after a churn stream: both packages' answers equal
    as sets on every lane, and equal to the live-set oracle where no lane
    overflowed (the int8 corpus is held to the oracle by
    ``test_churn_oracle_equivalence``)."""
    pts, nbrs, stream = clustered
    rng = np.random.default_rng(11)
    doomed = [rng.choice(700, 40, replace=False), rng.choice(700, 30, replace=False)]
    qs = np.concatenate([pts[100:116] + 0.01, stream[30:38] + 0.01])
    radii = _mixed_radii(qs)
    for corpus_dtype in ("float32",):
        j = JL.LiveIndex.create(jnp.asarray(pts), JL.LiveConfig(**dataclasses.asdict(LCFG)),
                                J.BuildConfig(**dataclasses.asdict(BCFG)),
                                graph=J.Graph(jnp.asarray(nbrs)), corpus_dtype=corpus_dtype)
        t = _live(clustered, corpus_dtype)
        for idx in (j, t):
            ids0 = idx.insert(stream[:30])
            idx.delete(doomed[0])
            idx.insert(stream[30:60])
            idx.delete(ids0[:10])
            idx.delete(doomed[1])
        assert t.epoch == j.epoch == 5
        dt = "int8" if corpus_dtype == "int8" else "float32"
        s = dict(beam=64, max_beam=64, visit_cap=256, corpus_dtype=dt)
        jr = j.range(jnp.asarray(qs), jnp.asarray(radii),
                     cfg=J.RangeConfig(search=J.SearchConfig(**s), mode="greedy",
                                       result_cap=512))
        tr = t.range(qs, radii, cfg=RangeConfig(search=SearchConfig(**s), mode="greedy",
                                                result_cap=512))
        want = _oracle_sets(t, qs, radii)
        over = _np(tr.overflow)
        assert _sets(tr) == _sets(jr), corpus_dtype
        for i in range(len(qs)):
            if not over[i]:
                assert _sets(tr)[i] == want[i], (corpus_dtype, i)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def _answers(snap, qs, radii):
    res = snap.range(qs, radii, cfg=CFG)
    return {f.name: getattr(res, f.name).clone() for f in dataclasses.fields(res)}


@pytest.mark.parametrize("kind", ["float32", "int8", "tiered"])
def test_snapshot_isolation(clustered, kind):
    """A snapshot taken before inserts, deletes and a consolidation answers
    bit for bit as it did (every result field), and its tensors hold the
    same bits; the index itself moved on."""
    pts, _, stream = clustered
    live = _live(clustered, "float32" if kind == "float32" else "int8", tier=kind == "tiered")
    qs = pts[:16] + 0.01
    radii = _mixed_radii(qs)
    snap = live.snapshot()
    before = _answers(snap, qs, radii)
    tomb, nbrs = snap.tombstones.clone(), snap.graph.neighbors.clone()
    live.insert(stream[:70])
    live.delete(np.arange(0, 700, 3))
    live.delete(np.arange(700, 720))
    assert live.consolidate()["reclaimed"] == 254
    live.insert(stream[70:])
    after = _answers(snap, qs, radii)
    for f, v in before.items():
        assert torch.equal(after[f], v), f
    assert torch.equal(snap.tombstones, tomb) and torch.equal(snap.graph.neighbors, nbrs)
    assert live.snapshot().epoch == snap.epoch + 5
    assert _answers(live.snapshot(), qs, radii)["ids"].ne(before["ids"]).any()


# ---------------------------------------------------------------------------
# the reference's live-index tests (tests/test_live.py), on the port
# ---------------------------------------------------------------------------

def test_insert_then_query_finds_new_point_at_exact_distance(clustered):
    live = _live(clustered)
    new = clustered[2][:40]
    ids = live.insert(new)
    assert ids.shape == (40,) and live.n_live == 740
    qs = new[:8] + 0.001
    res, res_f = live.range(qs, 0.5, cfg=CFG), live.range(qs, 0.5, cfg=CFG, compacted=False)
    got, got_f = _sets(res), _sets(res_f)
    d_exact = np.sum((new[:8] - qs) ** 2, axis=1)
    for i in range(8):
        assert ids[i] in got[i] and got[i] == got_f[i]
        j = int(np.nonzero(_np(res.ids[i]) == ids[i])[0][0])
        np.testing.assert_allclose(_np(res.dists)[i, j], d_exact[i], atol=1e-5)


def test_delete_then_query_never_returns_deleted(clustered):
    live = _live(clustered)
    pts = clustered[0]
    doomed = np.arange(0, 50)
    assert live.delete(doomed) == 50
    assert live.delete(doomed) == 0          # idempotent
    qs = pts[:16] + 0.01                     # queries AT deleted points
    radii = _mixed_radii(qs)
    res = live.range(qs, radii, cfg=CFG)
    for i, got in enumerate(_sets(res)):
        assert not (got & set(doomed.tolist())), i
    want = _oracle_sets(live, qs, radii)     # tombstones still route
    over = _np(res.overflow)
    for i, got in enumerate(_sets(res)):
        if not over[i]:
            assert got == want[i], i


@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_churn_oracle_equivalence(clustered, corpus_dtype):
    live = _live(clustered, corpus_dtype)
    pts, _, stream = clustered
    rng = np.random.default_rng(11)
    ids0 = live.insert(stream[:30])
    live.delete(rng.choice(700, 40, replace=False))
    ids1 = live.insert(stream[30:60])
    live.delete(ids0[:10])
    live.delete(rng.choice(700, 30, replace=False))
    assert live.epoch == 5
    qs = np.concatenate([pts[100:116] + 0.01, stream[30:38] + 0.01])
    radii = _mixed_radii(qs)
    res_c = live.range(qs, radii, cfg=CFG)
    res_f = live.range(qs, radii, cfg=CFG, compacted=False)
    want = _oracle_sets(live, qs, radii)
    got_c, got_f = _sets(res_c), _sets(res_f)
    over = _np(res_c.overflow)
    for i in range(len(qs)):
        assert got_c[i] == got_f[i], i
        if not over[i]:
            assert got_c[i] == want[i], i
    all_got = set().union(*got_c)
    assert not (all_got & set(ids0[:10].tolist()))
    assert set(ids1.tolist()) & all_got


def test_consolidation_rewires_compacts_and_preserves_results(clustered):
    live = _live(clustered)
    pts, _, stream = clustered
    live.insert(stream[:50])
    live.delete(np.random.default_rng(2).choice(700, 200, replace=False))
    qs = pts[300:316] + 0.01
    radii = _mixed_radii(qs)
    want = _oracle_sets(live, qs, radii)
    before = live.live_vectors()
    assert live.maybe_consolidate()
    assert not live.maybe_consolidate()
    st = live.stats()
    assert st["n_dead"] == 0 and st["live_count"] == 550
    assert st["free_slots"] == LCFG.capacity - 550
    after = live.live_vectors()
    np.testing.assert_array_equal(np.sort(before[0]), np.sort(after[0]))
    res = live.range(qs, radii, cfg=CFG)
    over = _np(res.overflow)
    for i, got in enumerate(_sets(res)):
        if not over[i]:
            assert got == want[i], i


def test_insert_beyond_capacity_consolidates_or_raises(clustered):
    live = _live(clustered, cfg=LiveConfig(capacity=720, insert_batch=64))
    stream = clustered[2]
    with pytest.raises(ValueError, match="capacity"):
        live.insert(stream[:40])
    live.delete(np.arange(100))
    ids = live.insert(stream[:40])           # the insert's consolidation freed slots
    assert live.live_count == 640 and live.n_live == 640
    got = set().union(*_sets(live.range(stream[:4] + 0.001, 0.5, cfg=CFG)))
    assert set(ids[:4].tolist()) <= got


def test_delete_everything_never_crashes_consolidation(clustered):
    live = _live(clustered)
    assert live.delete(np.arange(700)) == 700
    assert live.n_live == 0 and live.tombstone_frac() == 1.0
    assert not live.maybe_consolidate()
    assert live.consolidate()["reclaimed"] == 0
    res = live.range(clustered[0][:4] + 0.01, 10.0, cfg=CFG)
    assert int(_np(res.count).sum()) == 0


def test_live_checkpoint_roundtrip(clustered, tmp_path):
    live = _live(clustered, "int8")
    pts, _, stream = clustered
    live.insert(stream[:30])
    live.delete(np.arange(40))
    cm = CheckpointManager(str(tmp_path), keep=2)
    live.save(cm)
    live2 = LiveIndex.restore(cm, device="cpu")
    assert live2.stats() == live.stats()
    qs = pts[:12] + 0.01
    radii = _mixed_radii(qs)
    r1, r2 = live.range(qs, radii, cfg=CFG), live2.range(qs, radii, cfg=CFG)
    for name in ("ids", "dists", "count", "overflow", "n_rerank"):
        assert torch.equal(getattr(r1, name), getattr(r2, name)), name
    ids_a, ids_b = live.insert(stream[30:40]), live2.insert(stream[30:40])
    np.testing.assert_array_equal(ids_a, ids_b)
    assert live2.delete(ids_b[:3]) == 3


def test_frozen_engine_unaffected_by_tombstone_arg_absence(clustered):
    pts, nbrs, _ = clustered
    live = _live(clustered)
    qs = pts[:8] + 0.01
    radii = _mixed_radii(qs)
    eng = RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)), device="cpu")
    for a, b in zip(_sets(eng.range(qs, radii, cfg=CFG)), _sets(live.range(qs, radii, cfg=CFG))):
        assert a == b


def test_live_index_argument_checks(clustered):
    pts, nbrs, stream = clustered
    with pytest.raises(ValueError, match="exceeds capacity"):
        _live(clustered, cfg=LiveConfig(capacity=600))
    with pytest.raises(ValueError, match="not built on these points"):
        LiveIndex.create(pts[:500], LCFG, BCFG, graph=Graph(torch.from_numpy(nbrs)),
                         device="cpu")
    live = _live(clustered)
    with pytest.raises(ValueError, match="one id per"):
        live.insert(stream[:2], ext_ids=np.asarray([5000]))
    with pytest.raises(ValueError, match="no labels"):
        live.insert(stream[:1], labels=np.zeros((1, 1), np.uint32))
    assert live.insert(stream[:0]).shape == (0,)
    np.testing.assert_array_equal(externalize_ids(live.ext_ids, np.asarray([[3, INVALID_ID]])),
                                  [[3, INVALID_ID]])
    for bad in (dict(capacity=0), dict(capacity=4, insert_batch=0),
                dict(capacity=4, consolidate_at=0.0)):
        with pytest.raises(ValueError):
            LiveConfig(**bad)


# ---------------------------------------------------------------------------
# the tier's write-through (tests/test_tier.py's live tests, on the port)
# ---------------------------------------------------------------------------

def test_host_row_store_write_take_and_copy_free_wrap():
    rows = np.arange(24, dtype=np.float32).reshape(6, 4)
    store = HostRowStore(rows)
    store.write(np.asarray([1, 4]), np.full((2, 4), -1.0, np.float32))
    arr = store.to_array()
    assert arr.shape == (6, 4) and (arr[[1, 4]] == -1).all() and (arr[0] == rows[0]).all()
    assert np.shares_memory(arr, store.to_array())           # a view, not a copy
    taken = store.take(np.asarray([4, 0]))
    store.write(np.asarray([0]), np.zeros((1, 4), np.float32))
    np.testing.assert_array_equal(taken.to_array(), [[-1] * 4, [0, 1, 2, 3]])
    mm = rows.copy()
    wrapped = HostRowStore(mm, copy=False)
    wrapped.write(np.asarray([2]), np.ones((1, 4), np.float32))
    assert (mm[2] == 1).all() and not wrapped.pinned           # writes go through
    np.testing.assert_array_equal(wrapped.gather(np.asarray([2])).numpy(), mm[2:3])
    with pytest.raises(ValueError, match="copy=False"):
        HostRowStore(rows.astype(np.float64), copy=False)


def _tier_pair(clustered, corpus_dtype, **kw):
    return _live(clustered, corpus_dtype, **kw), _live(clustered, corpus_dtype, tier=True, **kw)


def _bitwise(a, b):
    for f in ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "n_rerank"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("corpus_dtype", ["float32", "int8"])
def test_live_churn_tiered_bitwise_parity(clustered, corpus_dtype):
    a, b = _tier_pair(clustered, corpus_dtype)
    qs = clustered[0][:24] + 0.01
    radii = _mixed_radii(qs)
    stream = clustered[2]
    np.testing.assert_array_equal(a.insert(stream[:60]), b.insert(stream[:60]))
    for live in (a, b):
        live.delete(np.arange(700, 720))
        live.delete(np.arange(5, 45))
    _bitwise(a.range(qs, radii, cfg=CFG), b.range(qs, radii, cfg=CFG))
    assert b.points.n == LCFG.capacity
    assert torch.equal(b.points.raw_array(), corpus_raw(a.points))
    sa, sb = a.consolidate(), b.consolidate()     # a fresh store and cache
    assert sa == sb
    _bitwise(a.range(qs, radii, cfg=CFG), b.range(qs, radii, cfg=CFG))
    np.testing.assert_array_equal(a.insert(stream[60:]), b.insert(stream[60:]))
    _bitwise(a.range(qs, radii, cfg=CFG), b.range(qs, radii, cfg=CFG))
    assert torch.equal(b.points.raw_array(), corpus_raw(a.points))
    if corpus_dtype == "int8":
        assert b.points.counters.pairs > 0


def test_live_insert_invalidates_stale_cache_lines(clustered):
    a, b = _tier_pair(clustered, "int8", cfg=LiveConfig(capacity=768, insert_batch=64))
    qs = clustered[0][:24] + 0.01
    radii = _mixed_radii(qs)
    stream = clustered[2]
    _bitwise(a.range(qs, radii, cfg=CFG), b.range(qs, radii, cfg=CFG))
    for k in range(3):
        ids_a, ids_b = a.insert(stream[:40] + 0.01 * k), b.insert(stream[:40] + 0.01 * k)
        np.testing.assert_array_equal(ids_a, ids_b)
        _bitwise(a.range(qs, radii, cfg=CFG), b.range(qs, radii, cfg=CFG))
        a.delete(ids_a)
        b.delete(ids_b)
        a.maybe_consolidate()
        b.maybe_consolidate()
        _bitwise(a.range(qs, radii, cfg=CFG), b.range(qs, radii, cfg=CFG))


def test_checkpoint_store_and_manifest_never_disagree(clustered, tmp_path):
    """A torn checkpoint directory is invisible; every completed step's
    payload is its host store; a restore maps it copy-on-write (writable,
    bit for bit) and keeps churning as the uninterrupted index does."""
    _, b = _tier_pair(clustered, "int8")
    qs = clustered[0][:24] + 0.01
    radii = _mixed_radii(qs)
    stream = clustered[2]
    cm = CheckpointManager(str(tmp_path), keep=3)
    b.insert(stream[:40])
    b.save(cm, step=1)
    raw1 = b.points.store.to_array().copy()
    b.insert(stream[40:80])
    b.delete(np.arange(10, 30))
    b.save(cm, step=2)
    raw2 = b.points.store.to_array().copy()
    res2 = b.range(qs, radii, cfg=CFG)
    torn = tmp_path / "step_0000000003.tmp"
    torn.mkdir()
    (torn / "raw.npy").write_bytes(b"\x93NUMPY garbage")
    assert cm.latest_step() == 2
    for step, raw in ((1, raw1), (2, raw2)):
        man = cm.manifest(step)
        assert "raw" in man["paths"]
        got = LiveIndex.restore(cm, step=step, device="cpu")
        assert man["extra"]["tier"]["cache_rows"] == got.points.cache.capacity
        assert not got.points.store.pinned
        np.testing.assert_array_equal(got.points.store.to_array(), raw)
    restored = LiveIndex.restore(cm, device="cpu")
    _bitwise(res2, restored.range(qs, radii, cfg=CFG))
    np.testing.assert_array_equal(b.insert(stream[80:]), restored.insert(stream[80:]))
    _bitwise(b.range(qs, radii, cfg=CFG), restored.range(qs, radii, cfg=CFG))
    np.testing.assert_array_equal(np.load(tmp_path / "step_0000000002" / "raw.npy"), raw2)


# ---------------------------------------------------------------------------
# RangeServer(live=)
# ---------------------------------------------------------------------------

def _server_stream(int_rig):
    """Integer-coordinate traffic: range and count requests at half-integer
    radii (one in five dense), inserts of stream vectors, deletes of initial
    and of freshly assigned ids (600.. are the inserts' ids)."""
    pts, _, stream = int_rig
    out = []
    for i in range(40):
        if i % 5 == 1:
            out.append(dict(req_id=i, op="insert", query=stream[i]))
        elif i % 5 == 3:
            ids = np.concatenate([np.arange(i * 15, i * 15 + 20), [600 + i // 5, i * 15]])
            out.append(dict(req_id=i, op="delete", delete_ids=ids))
        else:
            out.append(dict(req_id=i, op="count" if i % 7 == 0 else "range",
                            query=pts[i * 11] + 0.5, radius=200.5 if i % 5 == 0 else 40.5))
    return out


def _drive(cls_server, cls_req, live, cfg, scfg, stream):
    """Ten requests (six queries, two inserts, two deletes), then a step."""
    clock = FakeClock()
    srv = cls_server(None, cfg, scfg, live=live, clock=clock)
    resp = []
    for kw in stream:
        assert srv.submit(cls_req(**kw)) is None
        if kw["req_id"] % 10 == 9:
            resp += srv.step()
            clock.t += 1.0
    while srv.pending() or srv.in_flight():
        resp += srv.step()
        clock.t += 1.0
    return srv, resp


FIELDS = ("op", "count", "overflow", "es_stopped", "complete", "coverage", "code",
          "filtered", "radius", "latency_s", "timings", "epoch")


@pytest.mark.parametrize("continuous", [False, True], ids=["lockstep", "continuous"])
def test_server_live_matches_jax(masked, int_rig, continuous):
    """One stream of queries, inserts and deletes served by both packages
    over their live indices (integer rig): per ``req_id`` the same Response
    (every field, ids, distances exact), the same order and counters, and
    the indices' states equal at the end. Auto-consolidation fires."""
    j, t = _int_pair(int_rig)
    jcfg, tcfg = _int_cfgs()
    sc = (dict(max_batch=10, continuous=True, lanes=4, slice_rounds=2) if continuous
          else dict(max_batch=10))
    stream = _server_stream(int_rig)
    jsrv, jresp = _drive(JRangeServer, JRequest, j, jcfg, JServerConfig(**sc), stream)
    tsrv, tresp = _drive(RangeServer, Request, t, tcfg, ServerConfig(**sc), stream)
    assert [r.req_id for r in tresp] == [r.req_id for r in jresp]
    assert sorted(r.req_id for r in tresp) == list(range(40))
    for a, b in zip(jresp, tresp):
        for f in FIELDS:
            x, y = getattr(b, f), getattr(a, f)
            assert x == y or (f == "radius" and np.isnan(x) and np.isnan(y)), (a.req_id, f)
        np.testing.assert_array_equal(b.ids, a.ids, err_msg=str(a.req_id))
        np.testing.assert_array_equal(b.dists, a.dists, err_msg=str(a.req_id))
    assert tsrv.stats == jsrv.stats
    s = tsrv.stats
    assert s["inserts"] == 8 and s["deletes"] and s["consolidations"] and s["epoch"] == t.epoch
    if continuous:
        assert s["pool_admitted"]
    _assert_state(t, j)


def test_server_live_mutation_requests(clustered):
    """tests/test_train_serve.py's: insert/delete requests ride the queue;
    the batch's mutations apply first, then its queries answer on one
    snapshot (the fresh point at its exact distance, deleted points never)."""
    pts, nbrs, _ = clustered
    live = _live(clustered, cfg=LiveConfig(capacity=1500, insert_batch=64))
    srv = RangeServer(None, CFG, ServerConfig(max_batch=16), live=live)
    eng = RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)), device="cpu")
    with pytest.raises(ValueError, match="live"):
        RangeServer(eng, CFG).submit(Request(req_id=0, op="delete", delete_ids=np.asarray([1])))
    with pytest.raises(ValueError, match="delete_ids"):
        srv.submit(Request(req_id=0, op="delete"))
    with pytest.raises(ValueError, match="labeled inserts"):
        srv.submit(Request(req_id=0, op="insert", query=pts[0], labels=[1]))
    with pytest.raises(ValueError, match="range/count"):
        srv.submit(Request(req_id=0, op="insert", query=pts[0], filter_labels=[1]))
    fresh = pts[0] * 0.5 + 3.0
    srv.submit(Request(req_id=0, op="insert", query=fresh))
    srv.submit(Request(req_id=1, op="delete", delete_ids=np.asarray([3, 4, 4])))
    srv.submit(Request(req_id=2, query=fresh + 0.001, radius=1.0))
    srv.submit(Request(req_id=3, query=pts[3], radius=1.0))
    resp = {r.req_id: r for r in srv.run_until_drained()}
    assert len(resp) == 4
    new_id = int(resp[0].ids[0])
    assert new_id == 700 and resp[0].op == "insert"
    assert resp[1].op == "delete" and srv.stats["deletes"] == 2
    assert new_id in resp[2].ids.tolist()
    k = resp[2].ids.tolist().index(new_id)
    np.testing.assert_allclose(resp[2].dists[k], float(np.sum((fresh + 0.001 - fresh) ** 2)),
                               atol=1e-5)
    assert not ({3, 4} & set(resp[3].ids.tolist()))
    assert resp[2].epoch == resp[3].epoch == live.epoch
    assert srv.stats["inserts"] == 1 and srv.stats["epoch"] == live.epoch


def test_continuous_live_server_finishes_the_pool_before_mutating(clustered):
    """A pooled lane admitted before a consolidation answers on the
    snapshot it was admitted under: its external ids equal a lockstep
    server's on the same stream."""
    pts, _, stream = clustered
    reqs = [dict(req_id=i, query=pts[i] + 0.01, radius=9.0 if i % 2 else 0.5)
            for i in range(8)]
    reqs += [dict(req_id=8, op="delete", delete_ids=np.arange(0, 700, 2)),
             dict(req_id=9, op="insert", query=stream[0])]
    reqs += [dict(req_id=10 + i, query=pts[i] + 0.01, radius=9.0) for i in range(8)]
    out = {}
    for continuous in (False, True):
        live = _live(clustered)
        scfg = ServerConfig(max_batch=8, continuous=continuous, lanes=4, slice_rounds=1)
        srv = RangeServer(None, CFG, scfg, live=live, clock=FakeClock())
        resp = []
        for i in range(0, len(reqs), 8):
            for kw in reqs[i:i + 8]:
                srv.submit(Request(**kw))
            resp += srv.step()
        resp += srv.run_until_drained()
        out[continuous] = sorted(resp, key=lambda r: r.req_id)
        assert srv.stats["consolidations"] == 1
    for a, b in zip(out[False], out[True]):
        assert (a.req_id, a.op, a.epoch, a.count) == (b.req_id, b.op, b.epoch, b.count)
        assert set(a.ids.tolist()) == set(b.ids.tolist())
    assert out[True][1].epoch == 0 and out[True][15].epoch == 3


# ---------------------------------------------------------------------------
# the sharded live index (tests/test_live.py's sharded cases; replica groups)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def shard_graphs(int_rig):
    """The integer rig in two shards of 300, each with the port's CPU Vamana
    graph (equal row for row to the masked reference's)."""
    pts = int_rig[0]
    return [(pts[s * 300:(s + 1) * 300],
             build_vamana(pts[s * 300:(s + 1) * 300], BuildConfig(**IBCFG),
                          device="cpu").neighbors.numpy()) for s in range(2)]


def _sharded(shard_graphs, pkg, replicas=1):
    """A two-shard live index of either package over ``shard_graphs``;
    ``replicas`` > 1 (the port) clones each shard into a replica group."""
    from repro_torch.live import LiveShardedIndex, clone_live_index
    shards = []
    for s, (block, nbrs) in enumerate(shard_graphs):
        if pkg == "jax":
            shards.append(JL.LiveIndex.create(
                jnp.asarray(block), JL.LiveConfig(**ILCFG), J.BuildConfig(**IBCFG),
                graph=J.Graph(jnp.asarray(nbrs)), first_ext_id=s * 300))
        else:
            shards.append(LiveIndex.create(
                block, LiveConfig(**ILCFG), BuildConfig(**IBCFG),
                graph=Graph(torch.from_numpy(nbrs)), first_ext_id=s * 300, device="cpu"))
    if pkg == "jax":
        sl = JL.LiveShardedIndex(shards)
    else:
        sl = LiveShardedIndex(shards, replica_groups=[
            [sh] + [clone_live_index(sh) for _ in range(replicas - 1)] for sh in shards])
    sl.next_ext_id = 600
    return sl


def _sharded_ops():
    """tests/test_live.py's sharded churn and split, on the integer rig: a
    batch to the least-loaded shard, deletes by owner (fresh, initial,
    unknown), then a batch larger than any shard's free space (it splits),
    more deletes past the consolidation threshold."""
    big = _ints(520, 21)
    return [("insert", _ints(40, 20)), ("delete", np.r_[600:608, 0:300:7, 10**6]),
            ("maybe", None), ("insert", big), ("delete", np.r_[300:600:2, 640:700]),
            ("maybe", None), ("delete", np.arange(700, 900)), ("maybe", None)]


def _apply(sl, op, arg):
    if op == "insert":
        return sl.insert(arg)
    if op == "delete":
        return sl.delete(arg)
    return sl.maybe_consolidate()


def test_sharded_routing_and_state_match_jax(masked, shard_graphs):
    """Owners, external ids, per-shard live counts and every shard's state
    equal JAX's after each operation; a 2-replica group passes
    ``assert_replica_parity`` throughout, and each of its members equals
    the lone (unreplicated) reference shard under the same mutations, so no
    field a clone shares is written twice."""
    j = _sharded(shard_graphs, "jax")
    t = _sharded(shard_graphs, "port", replicas=2)
    for op, arg in _sharded_ops():
        a, b = _apply(j, op, arg), _apply(t, op, arg)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(b, a)
        else:
            assert b == a, op
        assert t._owner == j._owner and t.next_ext_id == j.next_ext_id
        assert [sh.n_live for sh in t.shards] == [sh.n_live for sh in j.shards]
        t.assert_replica_parity()
        for g, jsh in zip(t.groups, j.shards):
            for member in g:
                _assert_state(member, jsh)
    owners = [t._owner[int(e)] for e in range(600, 640)]
    assert len(set(owners)) == 1                      # one batch, one owner
    assert {t._owner[int(e)] for e in range(640, 1160)} == {0, 1}   # the split
    assert t.n_live == j.n_live and sum(sh.epoch for sh in t.shards) > 6
    with pytest.raises(ValueError, match="free capacity"):
        t.insert(_ints(t.shards[0].capacity * 2, 22))


def test_sharded_range_equals_the_shards_union(shard_graphs):
    """``LiveShardedIndex.range`` over a one-rank mesh: external ids, bit for
    bit the union of the shards' own ``LiveSnapshot.range`` (fused, merged
    in shard order by distance), no deleted id, no id outside the live-set
    oracle (integer distances: exact), and 85 % of the oracle's ids (the
    walk is approximate: 195 of 217 here)."""
    import torch.distributed as dist
    from repro_torch.dist import make_mesh
    from repro_torch.dist.sharded_engine import union_merge
    t = _sharded(shard_graphs, "port", replicas=2)
    for op, arg in _sharded_ops()[:5]:
        _apply(t, op, arg)
    qs = np.concatenate([shard_graphs[0][0][:6], shard_graphs[1][0][:6]]) + 0.5
    radii = np.where(np.arange(12) % 2 == 0, 40.5, 120.5).astype(np.float32)
    _, cfg = _int_cfgs()
    fresh = not dist.is_initialized()
    mesh = make_mesh((1, 1), device_type="cpu")
    try:
        got = t.range(mesh, qs, radii, cfg)
        again = t.range(mesh, qs, radii, cfg)     # the cached view
    finally:
        if fresh:
            dist.destroy_process_group()
    per = [sh.snapshot().range(qs, radii, cfg=cfg, compacted=False) for sh in t.shards]
    ids, dists = union_merge(torch.cat([p.ids for p in per], 1),
                             torch.cat([p.dists for p in per], 1), cfg.result_cap)
    assert torch.equal(got.ids, ids) and torch.equal(got.dists, dists)
    assert torch.equal(got.count, torch.clamp(sum(p.count for p in per), max=cfg.result_cap))
    assert got.ids.dtype == torch.int64 and torch.equal(again.ids, got.ids)
    dead = set(range(600, 608)) | set(range(0, 300, 7)) | set(range(300, 600, 2))
    assert not dead & set(got.ids.numpy().ravel().tolist())
    want = _oracle_sets(t, qs, radii)
    found = sum(len(row) for row in _sets(got))
    assert all(row <= want[i] for i, row in enumerate(_sets(got)))   # no false positive
    assert found >= 0.85 * sum(len(w) for w in want) and found > 0


@pytest.mark.parametrize("kind", ["float32", "tiered"])
def test_clone_live_index_is_independent(clustered, kind):
    """A clone and its original mutate apart: an insert, a delete and a
    consolidation of the original leave the clone's state (the tier's host
    store and cache included) as it was, and the clone then takes the same
    mutations to the same state."""
    from repro_torch.live import clone_live_index
    a = _live(clustered, "int8" if kind == "tiered" else "float32", tier=kind == "tiered")
    b = clone_live_index(a)
    before = _state(b)
    if kind == "tiered":
        assert b.points.store is not a.points.store and b.points.cache is not a.points.cache
    stream = clustered[2]
    for idx in (a,):
        idx.insert(stream[:20])
        idx.delete(np.arange(0, 700, 3))
        idx.consolidate()
    for k, v in _state(b).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)
    assert b.wal is None and b.n_live == 700
    b.insert(stream[:20])
    b.delete(np.arange(0, 700, 3))
    b.consolidate()
    sa, sb = _state(a), _state(b)
    for k in sa:
        np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)


def test_rebuild_replica_from_checkpoint_and_wal_matches_jax(masked, shard_graphs, tmp_path):
    """A lost replica rebuilt from its group primary's checkpoint and WAL
    tail rejoins bit for bit: parity holds, and every member equals the
    lone JAX shard under the same mutations."""
    from repro_torch.fault import WriteAheadLog
    j = _sharded(shard_graphs, "jax")
    t = _sharded(shard_graphs, "port", replicas=2)
    t.groups[1][0].attach_wal(WriteAheadLog(str(tmp_path / "shard1.wal")))
    cm = CheckpointManager(str(tmp_path / "ck"))
    ops = _sharded_ops()
    for op, arg in ops[:3]:
        _apply(j, op, arg)
        _apply(t, op, arg)
    t.groups[1][0].save(cm)
    for op, arg in ops[3:6]:
        _apply(j, op, arg)
        _apply(t, op, arg)
    t.groups[1][1] = None                     # replica (1, 1) is lost
    rebuilt = t.rebuild_replica(1, 1, cm, wal=WriteAheadLog(str(tmp_path / "shard1.wal")))
    assert rebuilt.wal is None and t.groups[1][0].wal is not None
    assert rebuilt.wal_seq == t.groups[1][0].wal_seq == 3
    t.assert_replica_parity()
    for g, jsh in zip(t.groups, j.shards):
        for member in g:
            st, sj = _state(member), _state(jsh)
            st["counters"] = st["counters"][:3]   # the JAX shards keep no WAL: wal_seq 0
            sj["counters"] = sj["counters"][:3]
            for k in sj:
                if k == "meta":
                    np.testing.assert_allclose(st[k], sj[k], **META_TOL, err_msg=k)
                else:
                    np.testing.assert_array_equal(st[k], sj[k], err_msg=k)

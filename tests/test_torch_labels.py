"""Filtered range search in the port against the JAX package.

The rig is the reference's labeled exact-recovery rig (tests/test_oracle.py):
a two-pass Vamana graph built by the reference, beam >= ball size and radii
midway between consecutive sorted distances, so the unfiltered walk recovers
each ball and a filtered answer equals the post-filtered brute-force oracle.
Both packages search the identical index (``engine_from_arrays``, the int8
engine with the reference's codes) with identical label rows: every lane's
ids, counts, n_dist, n_visited and flags must be equal and distances
``allclose(rtol=1e-5, atol=1e-5)`` (sums in another order).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from repro.core.bitset import bitset_add as jax_bitset_add
from repro.core.distances import point_dist
from repro_torch.convert import engine_from_arrays
from repro_torch.core import (
    ENTRY_SEED_FRAC, RangeConfig, SearchConfig, all_pass_filter, label_match_counts,
    label_match_matrix, labels_match, make_label_filter, make_mask, num_label_words,
    pack_labels)
from repro_torch.core.labels import as_label_rows
from repro_torch.utils import INVALID_ID

N_LABELS = 8
TOL = dict(rtol=1e-5, atol=1e-5)
_RIG: dict = {}


def _toy(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, d)).astype(np.float32) * 3
    return (centers[rng.integers(0, 8, n)]
            + rng.standard_normal((n, d)).astype(np.float32) * 0.4).astype(np.float32)


def _rig():
    """(points, raw label lists, packed labels, {name: (JAX engine, port
    engine)} for f32 and int8, queries, exact (Q, N), mixed radii)."""
    if not _RIG:
        pts = _toy(1200, 10, 3)
        graph = J.build_vamana(jnp.asarray(pts), J.BuildConfig(
            max_degree=24, beam=48, insert_batch=256, two_pass=True))
        rng = np.random.default_rng(11)
        raw = [sorted(int(x) for x in rng.choice(N_LABELS, size=int(rng.integers(1, 3)),
                                                  replace=False))
               for _ in range(pts.shape[0])]
        packed = J.pack_labels(raw, N_LABELS)
        jeng = J.RangeSearchEngine.from_graph(jnp.asarray(pts), graph, labels=packed)
        jeng_q = J.RangeSearchEngine(points=J.quantize_corpus(jnp.asarray(pts)),
                                     graph=jeng.graph, start_ids=jeng.start_ids,
                                     labels=jeng.labels, metric="l2")
        nbrs, starts = np.asarray(graph.neighbors), np.asarray(jeng.start_ids)
        lab = as_label_rows(packed)
        teng = dataclasses.replace(
            engine_from_arrays(pts, nbrs, starts, device="cpu"), labels=lab)
        teng_q = dataclasses.replace(
            engine_from_arrays(pts, nbrs, starts, device="cpu",
                               codes=np.asarray(jeng_q.points.codes),
                               meta=np.asarray(jeng_q.points.meta)), labels=lab)
        qs = pts[:24] + 0.01
        exact = np.asarray(point_dist(pts[None], qs[:, None], "l2"))
        srt = np.sort(exact, axis=1)
        ks = np.linspace(16, 96, qs.shape[0]).astype(int)
        lanes = np.arange(qs.shape[0])
        radii = ((srt[lanes, ks] + srt[lanes, ks + 1]) / 2).astype(np.float32)
        _RIG.update(pts=pts, raw=raw, packed=packed,
                    engines={"f32": (jeng, teng), "int8": (jeng_q, teng_q)},
                    qs=qs, exact=exact, radii=radii)
    r = _RIG
    return r["pts"], r["raw"], r["packed"], r["engines"], r["qs"], r["exact"], r["radii"]


def _cfgs(**kw):
    s = dict(beam=48, max_beam=48, visit_cap=384)
    return (J.RangeConfig(search=J.SearchConfig(**s), mode="greedy", result_cap=512, **kw),
            RangeConfig(search=SearchConfig(**s), mode="greedy", result_cap=512, **kw))


def _lane_filter(n):
    """Even lanes AND one label (narrow), odd lanes OR two labels (broad)."""
    entries, modes = [], []
    for q in range(n):
        if q % 2 == 0:
            entries.append([q % N_LABELS])
            modes.append("and")
        else:
            entries.append([q % N_LABELS, (q + 3) % N_LABELS])
            modes.append("or")
    return entries, modes


def _filters(entries, modes):
    return (J.make_label_filter(entries, N_LABELS, modes=modes),
            make_label_filter(entries, N_LABELS, modes=modes))


def _assert_result_equal(jres, tres):
    for f in ("ids", "count", "overflow", "n_visited", "n_dist", "es_stopped",
              "phase2", "n_rerank"):
        np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                      np.asarray(getattr(jres, f)), err_msg=f)
    a, b = tres.dists.numpy(), np.asarray(jres.dists)
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)], **TOL)


def _oracle(raw, exact, radii, entries, modes, q):
    ball = np.nonzero(exact[q] <= radii[q])[0]
    pred = set(entries[q])
    return {int(i) for i in ball
            if (pred <= set(raw[i]) if modes[q] == "and" else bool(pred & set(raw[i])))}


def _sets(res):
    ids = res.ids.numpy()
    return [set(row[row != INVALID_ID].tolist()) for row in ids]


# ---------------------------------------------------------------------------
# packing, predicates and matching
# ---------------------------------------------------------------------------

def test_packing_filters_and_matching_match_jax():
    _, raw, packed, _, _, _, _ = _rig()
    np.testing.assert_array_equal(pack_labels(raw, N_LABELS), packed)
    member = np.zeros((len(raw), 40), bool)
    for i, row in enumerate(raw):
        member[i, row] = True
        member[i, 33 + i % 7] = True
    np.testing.assert_array_equal(pack_labels(member, 40), J.pack_labels(member, 40))
    assert num_label_words(40) == 2 and num_label_words(32) == 1
    np.testing.assert_array_equal(make_mask([0, 31, 39], 40), J.make_mask([0, 31, 39], 40))
    with pytest.raises(ValueError):
        pack_labels([[8]], N_LABELS)
    with pytest.raises(ValueError):
        num_label_words(0)

    entries = [[1], None, [2, 5], [], [31, 33], [0]]
    modes = ["and", "or", "or", "and", "or", "and"]
    jf = J.make_label_filter(entries, 40, modes=modes)
    tf = make_label_filter(entries, 40, modes=modes)
    np.testing.assert_array_equal(tf.masks.numpy().view(np.uint32), np.asarray(jf.masks))
    np.testing.assert_array_equal(tf.is_and.numpy(), np.asarray(jf.is_and))
    ja, ta = J.all_pass_filter(6, 40), all_pass_filter(6, 40)
    np.testing.assert_array_equal(ta.masks.numpy().view(np.uint32), np.asarray(ja.masks))
    np.testing.assert_array_equal(ta.is_and.numpy(), np.asarray(ja.is_and))
    with pytest.raises(ValueError):
        make_label_filter([[1]], 40, modes=["xor"])

    rows = J.pack_labels(member, 40)
    lab = as_label_rows(rows)
    np.testing.assert_array_equal(label_match_matrix(lab, tf).numpy(),
                                  np.asarray(J.label_match_matrix(jnp.asarray(rows), jf)))
    np.testing.assert_array_equal(label_match_counts(lab, tf).numpy(),
                                  np.asarray(J.label_match_counts(jnp.asarray(rows), jf)))
    for q in range(len(entries)):
        np.testing.assert_array_equal(
            labels_match(lab, tf.masks[q], tf.is_and[q]).numpy(),
            np.asarray(J.labels_match(jnp.asarray(rows), jf.masks[q], jf.is_and[q])))


# ---------------------------------------------------------------------------
# filtered range search against the JAX package and the oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compacted", [True, False], ids=["compacted", "fused"])
@pytest.mark.parametrize("corpus", ["f32", "int8"])
def test_filtered_search_matches_jax(corpus, compacted):
    _, raw, _, engines, qs, exact, radii = _rig()
    jeng, teng = engines[corpus]
    entries, modes = _lane_filter(qs.shape[0])
    jf, tf = _filters(entries, modes)
    jcfg, tcfg = _cfgs()
    jres = jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                      compacted=compacted, filter=jf)
    tres = teng.range(qs, radii, cfg=tcfg, compacted=compacted, filter=tf)
    _assert_result_equal(jres, tres)
    assert not tres.overflow.any()
    for q, got in enumerate(_sets(tres)):
        assert got == _oracle(raw, exact, radii, entries, modes, q), f"lane {q}"
    if corpus == "int8":
        assert int(tres.n_rerank.sum()) > 0


@pytest.mark.parametrize("compacted", [True, False], ids=["compacted", "fused"])
def test_allpass_bitwise_equal_to_unfiltered(compacted):
    _, _, _, engines, qs, _, radii = _rig()
    teng = engines["f32"][1]
    _, tcfg = _cfgs()
    a = teng.range(qs, radii, cfg=tcfg, compacted=compacted)
    b = teng.range(qs, radii, cfg=tcfg, compacted=compacted,
                   filter=all_pass_filter(qs.shape[0], N_LABELS))
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def test_superset_predicate_monotonicity():
    _, _, _, engines, qs, _, radii = _rig()
    teng = engines["f32"][1]
    n = qs.shape[0]
    _, tcfg = _cfgs()
    la = [[q % N_LABELS] for q in range(n)]
    lb = [[q % N_LABELS, (q + 1) % N_LABELS] for q in range(n)]

    def get(ids, mode):
        return _sets(teng.range(qs, radii, cfg=tcfg, compacted=False,
                                filter=make_label_filter(ids, N_LABELS, modes=mode)))
    or_a, or_b, and_a, and_b = get(la, "or"), get(lb, "or"), get(la, "and"), get(lb, "and")
    for q in range(n):
        assert or_a[q] <= or_b[q] and and_b[q] <= and_a[q] and or_a[q] == and_a[q], q


@pytest.mark.parametrize("corpus", ["f32", "int8"])
def test_fallback_lanes_match_jax(corpus):
    """With ``filter_threshold`` above the narrow lanes' selectivity (~19 %),
    they scan their posting lists (n_visited == 0) and every lane equals
    JAX's and the oracle; the broad lanes (~36 %) walk."""
    _, raw, _, engines, qs, exact, radii = _rig()
    jeng, teng = engines[corpus]
    entries, modes = _lane_filter(qs.shape[0])
    jf, tf = _filters(entries, modes)
    jcfg, tcfg = _cfgs(filter_threshold=0.25)
    jres = jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg, filter=jf)
    tres = teng.range(qs, radii, cfg=tcfg, filter=tf)
    _assert_result_equal(jres, tres)
    nv = tres.n_visited.numpy()
    assert (nv[::2] == 0).all() and (nv[1::2] > 0).all()
    counts = label_match_counts(teng.labels, tf).numpy()
    np.testing.assert_array_equal(tres.n_dist.numpy()[::2], counts[::2])
    for q, got in enumerate(_sets(tres)):
        assert got == _oracle(raw, exact, radii, entries, modes, q), f"lane {q}"
    fb = tres.ids[::2]
    valid = fb != INVALID_ID
    lanes = torch.arange(0, qs.shape[0], 2)[:, None].expand_as(fb)[valid]
    np.testing.assert_allclose(tres.dists[::2][valid].numpy(),
                               exact[lanes.numpy(), fb[valid].numpy()], **TOL)


def test_fallback_with_small_result_cap_overflows_as_jax():
    _, _, _, engines, qs, _, radii = _rig()
    jeng, teng = engines["f32"]
    entries, modes = _lane_filter(qs.shape[0])
    jf, tf = _filters(entries, modes)
    s = dict(beam=48, max_beam=48, visit_cap=384)
    jcfg = J.RangeConfig(search=J.SearchConfig(**s), result_cap=8, filter_threshold=0.25)
    tcfg = RangeConfig(search=SearchConfig(**s), result_cap=8, filter_threshold=0.25)
    tres = teng.range(qs, radii, cfg=tcfg, filter=tf)
    _assert_result_equal(jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                                    filter=jf), tres)
    assert tres.overflow[::2].any()


def test_seeded_lanes_match_jax():
    """Every lane AND over one label (~19 % of the corpus, under
    ENTRY_SEED_FRAC): the compacted path seeds each walk with posting-list
    members, which moves its distance count off the fused (unseeded) walk's,
    and equals JAX's on every lane."""
    pts, raw, _, engines, qs, exact, radii = _rig()
    jeng, teng = engines["f32"]
    entries = [[q % N_LABELS] for q in range(qs.shape[0])]
    jf, tf = _filters(entries, "and")
    counts = label_match_counts(teng.labels, tf).numpy()
    assert ((counts > 0) & (counts < ENTRY_SEED_FRAC * pts.shape[0])).all()
    jcfg, tcfg = _cfgs()
    tres = teng.range(qs, radii, cfg=tcfg, filter=tf)
    _assert_result_equal(jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                                    filter=jf), tres)
    fused = teng.range(qs, radii, cfg=tcfg, compacted=False, filter=tf)
    assert (tres.n_dist != fused.n_dist).any()
    for q, got in enumerate(_sets(tres)):
        assert got == _oracle(raw, exact, radii, entries, ["and"] * len(entries), q)


@pytest.mark.parametrize("compacted", [True, False], ids=["compacted", "fused"])
def test_filtered_composes_with_tombstones(compacted):
    pts, raw, _, engines, qs, exact, radii = _rig()
    jeng, teng = engines["f32"]
    n = pts.shape[0]
    entries, modes = _lane_filter(qs.shape[0])
    jf, tf = _filters(entries, modes)
    dead = np.arange(0, n, 7, dtype=np.int32)
    jtomb = jax_bitset_add(jnp.zeros(((n + 31) // 32,), jnp.uint32),
                           jnp.asarray(dead), jnp.ones(dead.shape, bool))
    jcfg, tcfg = _cfgs(filter_threshold=0.25 if compacted else 0.0)
    jres = jeng.range(jnp.asarray(qs), jnp.asarray(radii), cfg=jcfg,
                      compacted=compacted, tombstones=jtomb, filter=jf)
    tres = teng.range(qs, radii, cfg=tcfg, compacted=compacted,
                      tombstones=np.asarray(jtomb), filter=tf)
    _assert_result_equal(jres, tres)
    dead_set = set(dead.tolist())
    for q, got in enumerate(_sets(tres)):
        assert got == _oracle(raw, exact, radii, entries, modes, q) - dead_set, q


def test_filter_threshold_is_validated():
    with pytest.raises(ValueError):
        RangeConfig(filter_threshold=1.5)
    with pytest.raises(ValueError):
        RangeConfig(filter_threshold=-0.1)

"""The generator, the traffic and the radius rule."""
import json

import numpy as np
import pytest
import torch
from conftest import ROOT

from rangebench.harness import corpus, radius, traffic


def _cfg(name):
    return json.loads((ROOT / "rangebench" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name,dim", [("bigann-1m-f32", 128), ("ssnpp-1m-int8", 256)])
def test_rangebench_published_widths(name, dim):
    cfg = _cfg(name)
    assert cfg["dim"] == cfg["published"]["dim"] == dim
    assert cfg["metric"] == cfg["published"]["metric"] == "l2"
    assert cfg["n"] == 1_000_000 and cfg["reduced"] == ["n"]


@pytest.mark.parametrize("name", ["bigann-1m-f32", "ssnpp-1m-int8"])
def test_rangebench_corpus_shapes_and_determinism(name):
    cfg = _cfg(name)
    dist = corpus.distribution(cfg, "cpu")
    a = corpus.corpus(dist, 2000)
    assert a.shape == (2000, cfg["dim"]) and a.dtype == torch.float32
    # the deployment's points: the same on every call
    assert torch.equal(a, corpus.corpus(corpus.distribution(cfg, "cpu"), 2000))
    other = dict(cfg, generator=dict(cfg["generator"], distribution_seed=1))
    assert not torch.equal(a, corpus.corpus(corpus.distribution(other, "cpu"), 2000))
    # points lie near the unit shell of the latent space (clusters and background)
    norms = torch.linalg.vector_norm(a @ dist.basis, dim=1)
    assert 0.5 < float(norms.median()) < 1.5


def test_rangebench_sizes_follow_make_corpus():
    dist = corpus.distribution(_cfg("bigann-1m-f32"), "cpu")
    sizes = dist.cluster_sizes(12345)
    assert sizes.sum() == 12345 and len(sizes) == 40 and (sizes >= 0).all()


MIX = {"batch": 64, "loop": "closed",
       "radius": {"kind": "levels", "lo": 0.5, "hi": 1.5, "count": 8}}


def test_rangebench_seeds_deal_the_same_work_in_another_order():
    dist = corpus.distribution(_cfg("bigann-1m-f32"), "cpu")
    p1, l1, o1 = traffic.pool(dist, MIX, 1000, 0.02, 3, 48, 2**31 + 11)
    p2, l2, o2 = traffic.pool(dist, MIX, 1000, 0.02, 3, 48, 2**31 + 11)
    p3, l3, o3 = traffic.pool(dist, MIX, 1000, 0.02, 3, 48, 7)
    assert all(torch.equal(a.queries, b.queries) for a, b in zip(p1, p2))
    assert all(torch.equal(a, b) for a, b in zip(l1, l2))
    assert not torch.equal(p1[0].queries, p3[0].queries)
    # the same set of queries and radii, dealt in another order
    q1 = torch.cat([b.queries for b in p1])
    q3 = torch.cat([b.queries for b in p3])
    assert torch.equal(q1[torch.argsort(o1)], q3[torch.argsort(o3)])
    # the same judged queries: the set's first 48, wherever they went
    assert sum(x.numel() for x in l1) == sum(x.numel() for x in l3) == 48
    j1 = torch.cat([b.queries[x] for b, x in zip(p1, l1)])
    j3 = torch.cat([b.queries[x] for b, x in zip(p3, l3)])
    assert torch.equal(torch.sort(j1[:, 0]).values, torch.sort(j3[:, 0]).values)


def test_rangebench_every_block_holds_the_mix():
    dist = corpus.distribution(_cfg("bigann-1m-f32"), "cpu")
    qs, rs = traffic.query_set(dist, MIX, 1000, 0.02, 2)
    assert qs.shape == (128, 128) and rs.shape == (128,)
    for block in (rs[:64], rs[64:]):     # 8 queries at each of the 8 levels
        levels, counts = torch.unique(block, return_counts=True)
        assert len(levels) == 8 and (counts == 8).all()
    np.testing.assert_allclose(float(levels.min()), 0.01, rtol=1e-6)
    np.testing.assert_allclose(float(levels.max()), 0.03, rtol=1e-6)
    _, fixed = traffic.query_set(dist, dict(MIX, radius={"kind": "fixed"}), 1000, 0.02, 1)
    assert (fixed == np.float32(0.02)).all()


def test_rangebench_unknown_traffic_refused():
    with pytest.raises(ValueError):
        traffic.check({"batch": 4, "loop": "open", "radius": {"kind": "fixed"}})


def test_rangebench_radius_rule_hand_worked():
    # n = 10 points, 4 queries, 3 radii. Zero fractions 0.75, 0.5, 0.5;
    # captured 0.075, 0.15, 0.15, so log10 slopes (np.gradient) 0.301,
    # 0.1505, 0; scores |zf - 0.5| + slope: 0.551, 0.1505, 0: the last,
    # where the capture curve is flat, wins
    counts = np.array([[0, 0, 0], [0, 0, 0], [0, 3, 3], [3, 3, 3]])
    radii = np.array([0.1, 0.2, 0.4], np.float32)
    r, gi, zf = radius.select(counts, radii, n=10, target_zero_frac=0.5)
    assert (r, gi, zf) == (np.float32(0.4), 2, 0.5)
    with pytest.raises(ValueError):
        radius.select(np.zeros((3, 2), int), radii[:2], n=10, target_zero_frac=0.5)


def test_rangebench_counts_at_brute_force():
    g = torch.Generator().manual_seed(0)
    pts = torch.randn(500, 8, generator=g)
    qs = torch.randn(7, 8, generator=g)
    radii = np.array([1.0, 4.0, 9.0, 16.0], np.float32)
    got = radius.counts_at(pts, qs, radii, "l2", block=64)
    d = ((qs[:, None, :] - pts[None]) ** 2).sum(-1)
    want = (d[:, :, None] <= torch.as_tensor(radii)).sum(1).numpy()
    assert np.abs(got - want).max() <= 1   # f32 expansion vs difference at a tie
    assert (np.diff(got, axis=1) >= 0).all()


def test_rangebench_grid_is_fixed():
    cfg = _cfg("bigann-1m-f32")
    g = radius.grid(cfg["radius_rule"])
    assert len(g) == 96 and g[0] > 0 and np.all(np.diff(g) > 0)

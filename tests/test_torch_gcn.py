"""The port's GCN, its segment ops and the graph data against the JAX
package's.

Weights come across from JAX's ``init_gcn`` through
``convert.gcn_params_from_jax``; graphs are numpy (``make_sbm_graph``, the
sampler), equal bit for bit in the two packages.

Tolerances, each with its reason (the frameworks add messages in different
orders): ``gather_scatter`` and the forward ``rtol=1e-5, atol=1e-6``;
``sym_norm_weights`` (degrees are exact sums of ones) ``rtol=1e-6``;
losses 1e-5 relative, every gradient leaf 1e-4 relative L2, the
parameters after three AdamW steps (lr 1e-2, gcn-cora's) 1e-4 relative L2
a leaf. ``range_graph_dataset``: the port's k-NN graph may order two
neighbours whose f32 distances tie within 1e-5 differently
(ROADMAP.md §3), so edges are equal up to such near-ties.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as jax_gcn_cora
from repro.data import graphs as jgraphs
from repro.layers import segment as jseg
from repro.models import gcn as jgcn
from repro.optim import adamw as jopt
from repro_torch.configs import gcn_cora
from repro_torch.convert import gcn_params_from_jax
from repro_torch.data import (
    NeighborSampler, make_sbm_graph, range_graph_dataset, to_csr)
from repro_torch.layers import gather_scatter, sym_norm_weights
from repro_torch.models import (
    GCNConfig, gcn_batched_graphs, gcn_forward, gcn_loss, init_gcn)
from repro_torch.optim import AdamWConfig, init_adamw, make_train_step
from repro_torch.utils import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _edges(rng, n, e, pad=0.15):
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    drop = rng.random(e) < pad
    src[drop & (rng.random(e) < 0.5)] = -1
    dst[drop] = np.where(src[drop] >= 0, -1, dst[drop])
    return src, dst


def _batch(g):
    return {"feats": g.feats, "edge_src": g.edge_src, "edge_dst": g.edge_dst,
            "labels": g.labels}


def test_config_is_the_reference_config():
    for port, ref in ((gcn_cora.reduced(), jax_gcn_cora.reduced()),
                      (gcn_cora.ARCH.model_cfg, jax_gcn_cora.ARCH.model_cfg)):
        assert dataclasses.asdict(port) == dict(vars(ref), dtype=torch.float32)
    assert gcn_cora.ARCH.shapes == {k: type(gcn_cora.ARCH.shapes[k])(**vars(v))
                                    for k, v in jax_gcn_cora.ARCH.shapes.items()}
    assert gcn_cora.ARCH.opt_cfg == AdamWConfig(**vars(jax_gcn_cora.ARCH.opt_cfg))


@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
@pytest.mark.parametrize("weighted", [False, True])
def test_gather_scatter_matches_jax(agg, weighted):
    rng = np.random.default_rng(0)
    n, d, e = 60, 5, 70     # sparse: some nodes get no message
    feats = rng.standard_normal((n, d)).astype(np.float32)
    src, dst = _edges(rng, n, e)
    w = rng.random(e).astype(np.float32) if weighted else None
    got = gather_scatter(torch.from_numpy(feats), src, dst, n, agg=agg,
                         edge_weight=None if w is None else torch.from_numpy(w))
    want = jseg.gather_scatter(jnp.asarray(feats), jnp.asarray(src), jnp.asarray(dst), n,
                               agg=agg, edge_weight=None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    lonely = np.setdiff1d(np.arange(n), dst[(src >= 0) & (dst >= 0)])
    assert lonely.size and not got[torch.from_numpy(lonely).long()].any()
    # the gradient with respect to the features, against jax.grad
    x = torch.from_numpy(feats).requires_grad_(True)
    (gather_scatter(x, src, dst, n, agg=agg) ** 2).sum().backward()
    jg = jax.grad(lambda f: jnp.sum(jseg.gather_scatter(
        f, jnp.asarray(src), jnp.asarray(dst), n, agg=agg) ** 2))(jnp.asarray(feats))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), **TOL)


def test_sym_norm_weights_match_jax():
    rng = np.random.default_rng(1)
    src, dst = _edges(rng, 40, 200)
    got = sym_norm_weights(torch.from_numpy(src), torch.from_numpy(dst), 40)
    want = jseg.sym_norm_weights(jnp.asarray(src), jnp.asarray(dst), 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert not got[torch.from_numpy((src < 0) | (dst < 0))].any()


def test_graph_data_is_the_reference_data():
    for args in ((300, 4, 16, 8, 0.8, 1), (120, 7, 9, 3, 0.5, 0)):
        g, jg = make_sbm_graph(*args), jgraphs.make_sbm_graph(*args)
        for f in ("feats", "edge_src", "edge_dst", "labels"):
            assert getattr(g, f).dtype == getattr(jg, f).dtype
            np.testing.assert_array_equal(getattr(g, f), getattr(jg, f))
        assert (g.n_nodes, g.n_edges, g.n_classes) == (jg.n_nodes, jg.n_edges, jg.n_classes)
        for a, b in zip(to_csr(g.n_nodes, g.edge_src, g.edge_dst),
                        jgraphs.to_csr(jg.n_nodes, jg.edge_src, jg.edge_dst)):
            np.testing.assert_array_equal(a, b)
    g = make_sbm_graph(500, 4, 8, avg_degree=6)
    s = NeighborSampler(g, fanouts=(5, 3), batch_nodes=16, seed=0)
    js = jgraphs.NeighborSampler(jgraphs.make_sbm_graph(500, 4, 8, avg_degree=6),
                                 fanouts=(5, 3), batch_nodes=16, seed=0)
    assert (s.max_nodes, s.max_edges) == (js.max_nodes, js.max_edges)
    for _ in range(2):
        b, jb = s.sample(), js.sample()
        for f in ("node_ids", "feats", "edge_src", "edge_dst", "labels", "seed_mask"):
            np.testing.assert_array_equal(getattr(b, f), getattr(jb, f))


def test_range_graph_dataset_matches_jax_up_to_near_ties():
    rng = np.random.default_rng(0)
    pts = rng.standard_normal((120, 8)).astype(np.float32)
    labels = rng.integers(0, 3, 120)
    g = range_graph_dataset(pts, labels, 3, k=6, device="cpu")
    jg = jgraphs.range_graph_dataset(pts, labels, 3, k=6)
    assert g.n_edges == jg.n_edges == 120 * 6
    np.testing.assert_array_equal(g.edge_dst, jg.edge_dst)
    np.testing.assert_array_equal(g.labels, jg.labels)
    diff = np.nonzero(g.edge_src != jg.edge_src)[0]
    d = lambda i, j: float(np.sum((pts[i] - pts[j]) ** 2))   # noqa: E731
    for e in diff:   # a swapped pair of near-tied neighbours
        i = g.edge_dst[e]
        assert abs(d(i, g.edge_src[e]) - d(i, jg.edge_src[e])) <= 1e-5 * d(i, jg.edge_src[e])
    assert len(diff) <= 0.01 * g.n_edges


@pytest.fixture(scope="module")
def cora_like():
    """gcn-cora's reduced config on a 300-node SBM graph, JAX's loss,
    gradients (jitted) and three AdamW steps at gcn-cora's optimizer."""
    cfg, jcfg = gcn_cora.reduced(), jax_gcn_cora.reduced()
    g = make_sbm_graph(300, cfg.n_classes, cfg.d_feat, avg_degree=8, seed=1)
    g.labels[::5] = -1                       # unlabelled nodes drop out of the loss
    batch = dict(_batch(g), label_mask=(np.arange(300) % 7 != 0).astype(np.float32))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jgcn.init_gcn(jax.random.PRNGKey(0), jcfg)
    vg = jax.jit(jax.value_and_grad(functools.partial(jgcn.gcn_loss, cfg=jcfg), has_aux=True))
    (loss, metrics), grads = vg(jp, jbatch)
    opt = jopt.AdamWConfig(**vars(jax_gcn_cora.ARCH.opt_cfg))
    upd = jax.jit(functools.partial(jopt.adamw_update, cfg=opt))
    p, state = jp, jopt.init_adamw(jp, opt)
    for _ in range(3):
        (_, _), gr = vg(p, jbatch)
        p, state, _ = upd(p, gr, state)
    as_np = functools.partial(jax.tree.map, np.asarray)
    return dict(cfg=cfg, jcfg=jcfg, batch=batch, jp=as_np(jp), loss=float(loss),
                acc=float(metrics["acc"]), grads=as_np(grads), after=as_np(p))


def test_gcn_forward_loss_and_gradients_match_jax(cora_like):
    c = cora_like
    params = gcn_params_from_jax(c["jp"], device="cpu")
    b = c["batch"]
    logits = gcn_forward(params, b["feats"], b["edge_src"], b["edge_dst"], c["cfg"])
    jfwd = jax.jit(jgcn.gcn_forward, static_argnums=4)
    want = jfwd(c["jp"], b["feats"], b["edge_src"], b["edge_dst"], c["jcfg"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    live = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    loss, metrics = gcn_loss(live, b, c["cfg"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), c["loss"], rtol=1e-5)
    assert float(metrics["acc"]) == c["acc"]
    for k, v in live.items():
        assert _rel_l2(v.grad.numpy(), c["grads"][k]) <= 1e-4, k
    # the mean aggregator without sym norm, too
    cfg = dataclasses.replace(c["cfg"], sym_norm=False, agg="mean")
    jcfg = dataclasses.replace(c["jcfg"], sym_norm=False, agg="mean")
    np.testing.assert_allclose(
        gcn_forward(params, b["feats"], b["edge_src"], b["edge_dst"], cfg).numpy(),
        np.asarray(jfwd(c["jp"], b["feats"], b["edge_src"], b["edge_dst"], jcfg)), **TOL)


def test_gcn_three_adamw_steps_match_jax(cora_like):
    c = cora_like
    params = gcn_params_from_jax(c["jp"], device="cpu")
    opt = gcn_cora.ARCH.opt_cfg
    step = make_train_step(functools.partial(gcn_loss, cfg=c["cfg"]), opt)
    state = init_adamw(params, opt)
    for _ in range(3):
        params, state, _ = step(params, state, c["batch"])
    for k in sorted(params):
        assert _rel_l2(params[k].numpy(), c["after"][k]) <= 1e-4, k


def test_gcn_batched_graphs_match_jax():
    cfg = GCNConfig(n_layers=2, d_feat=6, d_hidden=8, n_classes=2)
    jcfg = jgcn.GCNConfig(n_layers=2, d_feat=6, d_hidden=8, n_classes=2)
    rng = np.random.default_rng(4)
    jp = {f"w{i}": rng.standard_normal(shape).astype(np.float32) / np.float32(shape[0] ** 0.5)
          for i, shape in enumerate([(6, 8), (8, 2)])}
    jp.update(b0=0.1 * rng.standard_normal(8).astype(np.float32),
              b1=0.1 * rng.standard_normal(2).astype(np.float32))
    feats = rng.standard_normal((4, 10, 6)).astype(np.float32)
    es = rng.integers(-1, 10, (4, 12)).astype(np.int32)
    ed = rng.integers(0, 10, (4, 12)).astype(np.int32)
    got = gcn_batched_graphs(gcn_params_from_jax(jp, device="cpu"), feats, es, ed, cfg)
    want = jax.jit(jgcn.gcn_batched_graphs, static_argnums=4)(
        jp, jnp.asarray(feats), jnp.asarray(es), jnp.asarray(ed), jcfg)
    assert got.shape == (4, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_gcn_learns_sbm_labels_and_samples_train():
    """After tests/test_models.py: 40 full-batch steps reach accuracy > 0.8;
    a sampled subgraph batch gives a finite loss."""
    cfg = GCNConfig(n_layers=2, d_feat=16, d_hidden=16, n_classes=4)
    g = make_sbm_graph(300, 4, 16, avg_degree=8, seed=1)
    params = init_gcn(cfg, device="cpu")
    opt = AdamWConfig(lr=5e-2, warmup_steps=1, schedule="constant")
    step = make_train_step(functools.partial(gcn_loss, cfg=cfg), opt)
    state = init_adamw(params, opt)
    for _ in range(40):
        params, state, _ = step(params, state, _batch(g))
    assert float(gcn_loss(params, _batch(g), cfg)[1]["acc"]) > 0.8
    b = NeighborSampler(make_sbm_graph(500, 4, 16, avg_degree=6), fanouts=(5, 3),
                        batch_nodes=16, seed=0).sample()
    loss, _ = gcn_loss(params, {"feats": b.feats, "edge_src": b.edge_src,
                                "edge_dst": b.edge_dst, "labels": b.labels}, cfg)
    assert np.isfinite(float(loss))
    assert all(t.dtype == torch.float32 for t in tree_leaves(init_gcn(gcn_cora.ARCH.model_cfg,
                                                                  device="meta")))

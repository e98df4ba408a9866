"""The port's two-tower model against the JAX package's.

Parameters come across from JAX's ``init_recsys`` as numpy arrays through
``convert.recsys_params_from_jax`` (the two frameworks' generators cannot
give the same draws); ids are numpy draws from a seed. Tolerances: tower
outputs, forward, scores ``allclose(rtol=1e-5, atol=1e-6)`` — the two
frameworks' matmuls sum in different orders (a few ulp). The initializers
are held to their distribution: a normal truncated at ±3σ has standard
deviation 0.98658σ.

The slice as a whole: reduced towers embed 2,000 items and 64 users in
each package, and each package's own rangescan serves them (ip) at a
radius midway between two consecutive distances: counts equal, ids equal
up to swaps of members whose distances lie within 1e-5 (the embeddings
differ by ~1e-7 between the packages), and each package's AP against its
own ``exact_range_search`` equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.two_tower_retrieval import ARCH as JAX_ARCH
from repro.configs.two_tower_retrieval import reduced as jax_reduced
from repro.core import average_precision as jax_ap
from repro.core import exact_range_search as jax_exact
from repro.kernels import rangescan as jax_rangescan
from repro.models import recsys as jrec
from repro_torch.configs.two_tower_retrieval import ARCH, reduced
from repro_torch.convert import recsys_params_from_jax
from repro_torch.core import average_precision, exact_range_search
from repro_torch.kernels import rangescan
from repro_torch.kernels.rangescan import rangescan_dists
from repro_torch.kernels.rangescan.ref import compare_scans
from repro_torch.models import (
    init_recsys, init_tower, recsys_forward, retrieval_scores, retrieval_topk)
from repro_torch.models.recsys import bce_loss, recsys_loss, two_tower_loss
from repro_torch.utils import INVALID_ID

TOL = dict(rtol=1e-5, atol=1e-6)
TN_STD = 0.9865881  # std of a unit normal truncated at +-3


@pytest.fixture(scope="module")
def pair():
    cfg = jax_reduced()
    params = jrec.init_recsys(jax.random.PRNGKey(0), cfg)
    model = recsys_params_from_jax(jax.tree.map(np.asarray, params), reduced(),
                                   device="cpu")
    return cfg, params, model


def _ids(rng, b, f, vocab):
    return rng.integers(0, vocab, (b, f)).astype(np.int32)


def test_configs_match_the_reference():
    """Every field of the reference's config is the port's, with its value
    (the other kinds' fields, once left out, are back)."""
    kept = [f.name for f in dataclasses.fields(reduced()) if f.name != "dtype"]
    assert set(kept) == set(vars(jax_reduced())) - {"dtype"}
    for port, ref in ((reduced(), jax_reduced()), (ARCH.model_cfg, JAX_ARCH.model_cfg)):
        assert {k: getattr(port, k) for k in kept} == {k: getattr(ref, k) for k in kept}
        assert port.dtype == torch.float32
    assert ARCH.shapes == {k: type(ARCH.shapes[k])(**vars(v))
                           for k, v in JAX_ARCH.shapes.items()}
    assert ARCH.shapes["serve_p99"].global_batch == 512
    assert ARCH.shapes["retrieval_cand"].n_candidates == 1_000_000


def test_towers_forward_and_scores_match_jax(pair):
    cfg, params, model = pair
    rng = np.random.default_rng(1)
    users = _ids(rng, 33, cfg.n_sparse, cfg.vocab)
    items = _ids(rng, 70, cfg.n_sparse_item, cfg.vocab)
    n_mlp = len(cfg.mlp_dims) + 1
    ju = np.asarray(jrec.tower(params["user"], users, cfg, n_mlp))
    ji = np.asarray(jrec.embed_items(params, items, cfg))
    with torch.inference_mode():
        tu = model.user(torch.as_tensor(users)).numpy()
        ti = model.item(torch.as_tensor(items)).numpy()
        fu, fi = recsys_forward(model, {"user_sparse": torch.as_tensor(users),
                                        "item_sparse": torch.as_tensor(items)},
                                reduced())
    np.testing.assert_allclose(tu, ju, **TOL)
    np.testing.assert_allclose(ti, ji, **TOL)
    jfu, jfi = jrec.recsys_forward(params, {"user_sparse": users,
                                            "item_sparse": items}, cfg)
    np.testing.assert_allclose(fu.numpy(), np.asarray(jfu), **TOL)
    np.testing.assert_allclose(fi.numpy(), np.asarray(jfi), **TOL)
    np.testing.assert_allclose(np.linalg.norm(tu, axis=1), 1.0, rtol=1e-6)
    # scores and top-k over the same embeddings
    qe, ce = torch.from_numpy(ju.copy()), torch.from_numpy(ji.copy())
    np.testing.assert_allclose(retrieval_scores(qe, ce).numpy(),
                               np.asarray(jrec.retrieval_scores(ju, ji)), **TOL)
    ids, vals = retrieval_topk(qe, ce, k=10)
    jids, jvals = jrec.retrieval_topk(ju, ji, k=10)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **TOL)


def test_init_statistics():
    cfg = reduced()
    tower = init_tower(cfg, "item", seed=3, device="cpu")
    tab = tower.tables.detach()
    assert tab.shape == (cfg.n_sparse_item, cfg.vocab, cfg.d_embed)
    assert float(tab.abs().max()) <= 3 * 0.02
    assert float(tab.abs().max()) > 2.8 * 0.02          # reaches the cut
    assert abs(float(tab.std()) - 0.02 * TN_STD) < 0.02 * 0.01
    assert abs(float(tab.mean())) < 1e-4
    dims = cfg.tower_dims("item")
    for i in range(len(dims) - 1):
        w = getattr(tower.mlp, f"w{i}").detach()
        sigma = dims[i] ** -0.5
        assert w.shape == (dims[i], dims[i + 1])
        assert float(w.abs().max()) <= 3 * sigma
        assert abs(float(w.std()) - sigma * TN_STD) < sigma * 0.05
        assert not getattr(tower.mlp, f"b{i}").any()
    # the reference's draws have the same distribution
    jp = jrec.init_recsys(jax.random.PRNGKey(0), jax_reduced())
    jtab = np.asarray(jp["item"]["tables"])
    assert abs(float(jtab.std()) - float(tab.std())) < 0.02 * 0.01
    # a seed fixes the draws; another seed changes them
    again = init_tower(cfg, "item", seed=3, device="cpu")
    assert torch.equal(again.tables, tower.tables)
    assert not torch.equal(init_tower(cfg, "item", seed=4, device="cpu").tables,
                           tower.tables)


def test_full_width_shapes_on_meta_match_jax():
    cfg = ARCH.model_cfg
    model = init_recsys(cfg, device="meta")
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert all(v.is_meta for v in model.state_dict().values())
    jshapes = jax.eval_shape(lambda: jrec.init_recsys(jax.random.PRNGKey(0),
                                                      JAX_ARCH.model_cfg))
    flat = {".".join(str(p.key) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]}
    assert shapes == flat
    assert shapes["user.tables"] == (16, 10_485_760, 64)
    assert shapes["item.mlp.w2"] == (512, 256)
    # one tower's table: 16 * 10,485,760 * 64 f32, past 2^31 elements
    assert model.user.tables.numel() == 10_737_418_240


def test_unported_kinds_and_losses_raise():
    """Every kind and loss of the reference is ported now: an unknown kind
    raises, as in the reference; the losses run (held against JAX's in
    tests/test_torch_recsys_family.py)."""
    with pytest.raises(ValueError, match="kind"):
        init_recsys(dataclasses.replace(reduced(), kind="fm"), device="cpu")
    with pytest.raises(ValueError, match="kind"):
        recsys_forward({}, {}, dataclasses.replace(reduced(), kind="fm"))
    model = init_recsys(reduced(), device="cpu")
    ids = {"user_sparse": np.zeros((4, 4), np.int32), "item_sparse": np.zeros((4, 4), np.int32)}
    for fn in (two_tower_loss, recsys_loss):
        loss, metrics = fn(model, ids, reduced())
        assert bool(torch.isfinite(loss)) and set(metrics) == {"in_batch_acc"}
    ctr = dataclasses.replace(reduced(), kind="wide_deep")
    loss, metrics = bce_loss(init_recsys(ctr, device="cpu"),
                             {"sparse": np.zeros((4, 4), np.int32),
                              "label": np.ones(4, np.float32)}, ctr)
    assert bool(torch.isfinite(loss)) and set(metrics) == {"mean_logit"}


def _midpoint(dist, frac):
    d = np.sort(dist.ravel())
    i = int(frac * (d.size - 1))
    lo, hi = max(0, i - 20), min(d.size - 1, i + 20)
    j = lo + int(np.argmax(np.diff(d[lo:hi + 1])))
    return float((d[j] + d[j + 1]) / 2)


@pytest.mark.parametrize("k", [16, 256])
def test_two_tower_brute_force_slice_matches_jax(pair, k):
    """embed_items -> tower -> rangescan (ip) in each package."""
    cfg, params, model = pair
    rng = np.random.default_rng(1)
    items = _ids(rng, 2000, cfg.n_sparse_item, cfg.vocab)
    users = _ids(rng, 64, cfg.n_sparse, cfg.vocab)
    j_items = jrec.embed_items(params, items, cfg)
    j_users = jrec.tower(params["user"], users, cfg, len(cfg.mlp_dims) + 1)
    with torch.inference_mode():
        t_items = model.item(torch.as_tensor(items))
        t_users = model.user(torch.as_tensor(users))
    dist = rangescan_dists(t_users, t_items, "ip")
    r = _midpoint(-(np.asarray(j_users, np.float64)
                    @ np.asarray(j_items, np.float64).T), 0.01)
    jids, jd, jc = (np.array(t) for t in jax_rangescan(
        j_users, j_items, jnp.float32(r), k=k, metric="ip", use_pallas=False))
    got = rangescan(t_users, t_items, r, k=k, metric="ip")
    ids, dd, c = (t.numpy() for t in got)
    np.testing.assert_array_equal(c, jc)
    assert (c > k).any() == (k == 16) and (c > 0).any()
    want = [torch.as_tensor(x) for x in (jids, jd, jc)]
    _, unexcused, err = compare_scans(got, want, dist, r, 1e-5)
    assert unexcused == 0 and err <= 1e-5
    under = c <= k                       # lanes holding every member
    for i in np.nonzero(under)[0]:
        assert set(ids[i][ids[i] != INVALID_ID]) == set(jids[i][jids[i] != INVALID_ID])
    # each package's AP against its own oracle
    gt = exact_range_search(t_items, t_users, r, metric="ip", device="cpu")
    jgt = jax_exact(j_items, j_users, r, "ip")
    ap = average_precision(gt[0].numpy(), gt[2].numpy(), ids, c)
    jap = jax_ap(np.asarray(jgt[0]), np.asarray(jgt[2]), jids, jc)
    assert ap == jap
    if k == 256:
        assert ap == 1.0

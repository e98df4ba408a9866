"""The rest of the recsys family against the JAX package: the embedding
bag and the per-field lookup, the interactions, Wide&Deep, DLRM and
AutoInt (forward, loss, every gradient leaf, AdamW steps), the two-tower
loss, the synthetic recsys batches and the four configurations.

Weights are numpy draws in the shape of JAX's ``init_recsys`` tree,
carried across by ``convert.recsys_params_from_jax``; batches are the synthetic recsys
stream, numpy, equal bit for bit in the two packages.

Tolerances, each with its reason (the frameworks sum in different orders):
* lookups and bags: sums of the same rows, ``rtol=1e-6, atol=1e-7``;
* interactions, forward logits: ``rtol=1e-5, atol=1e-6``;
* losses 1e-5 relative, every gradient leaf 1e-4 relative L2, the
  parameters after three AdamW steps (lr 1e-3) 1e-4 relative L2 a leaf.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import autoint as jax_autoint
from repro.configs import dlrm_rm2 as jax_dlrm
from repro.configs import two_tower_retrieval as jax_tt
from repro.configs import wide_deep as jax_wd
from repro.data.recsys import RecsysDataConfig as JaxRecsysDataConfig
from repro.data.recsys import recsys_batch as jax_recsys_batch
from repro.layers import embedding as jemb
from repro.layers import interactions as jint
from repro.models import recsys as jrec
from repro.optim import adamw as jopt
from repro_torch.configs import autoint, dlrm_rm2, two_tower_retrieval, wide_deep
from repro_torch.convert import recsys_params_from_jax
from repro_torch.data import RecsysDataConfig, recsys_batch, recsys_batches
from repro_torch.layers import (
    BagConfig, FieldAttnConfig, dot_interaction, embedding_bag, field_attention,
    fm_interaction, init_field_attention, multi_field_lookup)
from repro_torch.models import init_recsys, recsys_forward, recsys_loss, recsys_tree
from repro_torch.optim import AdamWConfig, init_adamw, make_train_step
from repro_torch.utils import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-6)
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant")
MODULES = {"wide-deep": (wide_deep, jax_wd), "dlrm-rm2": (dlrm_rm2, jax_dlrm),
           "autoint": (autoint, jax_autoint),
           "two-tower-retrieval": (two_tower_retrieval, jax_tt)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree,
                               np.float32)}


def _data_cfg(cfg, batch):
    return RecsysDataConfig(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, vocab=cfg.vocab,
                            batch=batch, two_tower=cfg.kind == "two_tower",
                            n_sparse_item=cfg.n_sparse_item)


def test_configs_are_the_reference_configs():
    for name, (mod, jmod) in MODULES.items():
        for port, ref in ((mod.reduced(), jmod.reduced()),
                          (mod.ARCH.model_cfg, jmod.ARCH.model_cfg)):
            want = dict(vars(ref), dtype=torch.float32)
            assert dataclasses.asdict(port) == want, name
        assert mod.ARCH.opt_cfg == jopt_to_port(jmod.ARCH.opt_cfg)
        assert mod.ARCH.shapes == {k: type(mod.ARCH.shapes[k])(**vars(v))
                                   for k, v in jmod.ARCH.shapes.items()}
        assert [(r.pattern, r.spec) for r in mod.ARCH.rules] == [
            (r.pattern, r.spec) for r in jmod.ARCH.rules]


def jopt_to_port(o):
    return AdamWConfig(**{k: v for k, v in vars(o).items()
                          if k not in ("moment_dtype", "accum_dtype")})


@pytest.mark.parametrize("two_tower,n_dense", [(False, 13), (False, 0), (True, 0)])
def test_recsys_batches_are_the_reference_stream(two_tower, n_dense):
    cfg = RecsysDataConfig(n_dense=n_dense, n_sparse=5, vocab=777, batch=33, seed=2,
                           two_tower=two_tower, n_sparse_item=3)
    jcfg = JaxRecsysDataConfig(**dataclasses.asdict(cfg))
    it = recsys_batches(cfg, start_step=4)
    for step in (4, 5):
        got, want = next(it), jax_recsys_batch(jcfg, step)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    assert not np.array_equal(recsys_batch(cfg, 0)["label" if not two_tower else "user_sparse"],
                              recsys_batch(cfg, 1)["label" if not two_tower else "user_sparse"])


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_jax(mode):
    rng = np.random.default_rng(0)
    table = rng.standard_normal((50, 6)).astype(np.float32)
    ids = rng.integers(0, 50, (9, 5)).astype(np.int32)
    ids[rng.random(ids.shape) < 0.4] = -1
    ids[3] = -7                                 # a bag with no real id
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), BagConfig(mode))
    want = jemb.embedding_bag(jnp.asarray(table), jnp.asarray(ids), jemb.BagConfig(mode))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    assert not got[3].any()


def test_multi_field_lookup_matches_jax():
    rng = np.random.default_rng(1)
    tables = rng.standard_normal((4, 30, 5)).astype(np.float32)
    ids = rng.integers(0, 30, (11, 4)).astype(np.int32)
    got = multi_field_lookup(torch.from_numpy(tables), ids)
    want = jemb.multi_field_lookup(jnp.asarray(tables), jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("keep_self", [False, True])
def test_interactions_match_jax(keep_self):
    rng = np.random.default_rng(2)
    feats = rng.standard_normal((7, 5, 8)).astype(np.float32)
    got = dot_interaction(torch.from_numpy(feats), keep_self)
    want = jint.dot_interaction(jnp.asarray(feats), keep_self)
    assert got.shape == want.shape == (7, 15 if keep_self else 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(fm_interaction(torch.from_numpy(feats)).numpy(),
                               np.asarray(jint.fm_interaction(jnp.asarray(feats))), **TOL)


def test_field_attention_matches_jax():
    cfg = FieldAttnConfig(n_fields=5, d_embed=8, n_layers=2, n_heads=2, d_attn=16)
    jcfg = jint.FieldAttnConfig(**dataclasses.asdict(cfg))
    jp = jint.init_field_attention(jax.random.PRNGKey(0), jcfg)
    feats = np.random.default_rng(3).standard_normal((6, 5, 8)).astype(np.float32)
    tree = jax.tree.map(lambda x: torch.from_numpy(np.asarray(x)), jp)
    got = field_attention(tree, torch.from_numpy(feats), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jint.field_attention(
        jp, jnp.asarray(feats), jcfg)), **TOL)
    port = init_field_attention(cfg, device="cpu")
    assert jax.tree.map(lambda t: tuple(t.shape), port) == jax.tree.map(
        lambda x: tuple(x.shape), jp)


def np_params(jcfg, seed=0) -> dict:
    """Weights in the tree of the reference's ``init_recsys`` (its shapes by
    ``jax.eval_shape``: no JAX init to run), drawn with numpy: tables
    0.02 N(0, 1), weights N(0, 1) / sqrt(fan_in), biases 0.1 N(0, 1)."""
    shapes = jax.eval_shape(functools.partial(jrec.init_recsys, cfg=jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        x = rng.standard_normal(s.shape).astype(np.float32)
        name = str(path[-1].key)
        if name in ("tables", "wide"):
            return 0.02 * x
        return 0.1 * x if name.startswith("b") else x / np.float32(np.sqrt(s.shape[0]))

    return jax.tree_util.tree_map_with_path(draw, shapes)


class Pair:
    """One reduced config in both packages: the same numpy weights carried
    across, a batch, JAX's loss and gradients (jitted once) and three AdamW
    steps."""

    def __init__(self, arch):
        mod, jmod = MODULES[arch]
        self.cfg, self.jcfg = mod.reduced(), jmod.reduced()
        self.jparams = np_params(self.jcfg)
        self.model = recsys_params_from_jax(jax.tree.map(np.asarray, self.jparams),
                                            self.cfg, device="cpu")
        self.batch = recsys_batch(_data_cfg(self.cfg, 64), 0)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        vg = jax.jit(jax.value_and_grad(functools.partial(jrec.recsys_loss, cfg=self.jcfg),
                                        has_aux=True))
        (loss, metrics), grads = vg(self.jparams, jbatch)
        self.loss, self.metrics = float(loss), {k: float(v) for k, v in metrics.items()}
        self.grads = _flat(jax.tree.map(np.asarray, grads))
        opt = jopt.AdamWConfig(**OPT)
        upd = jax.jit(functools.partial(jopt.adamw_update, cfg=opt))
        p, state = self.jparams, jopt.init_adamw(self.jparams, opt)
        for _ in range(3):
            (_, _), g = vg(p, jbatch)
            p, state, _ = upd(p, g, state)
        self.after = _flat(jax.tree.map(np.asarray, p))


_PAIRS: dict = {}


def pair(arch) -> Pair:
    if arch not in _PAIRS:
        _PAIRS[arch] = Pair(arch)
    return _PAIRS[arch]


@pytest.mark.parametrize("arch", list(MODULES))
def test_forward_loss_and_gradients_match_jax(arch):
    p = pair(arch)
    tree = recsys_tree(p.model)
    assert list(_flat(tree)) == list(p.grads)        # the reference's leaves, in order
    assert isinstance(p.model, dict) == (p.cfg.kind != "two_tower")
    out = recsys_forward(p.model, p.batch, p.cfg)
    want = jrec.recsys_forward(p.jparams, {k: jnp.asarray(v) for k, v in p.batch.items()},
                               p.jcfg)
    for got, ref in zip(out if isinstance(out, tuple) else (out,),
                        want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    live = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    it = iter(live)
    loss, metrics = recsys_loss(jax.tree.map(lambda _: next(it), tree), p.batch, p.cfg)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), p.loss, rtol=1e-5)
    for k, v in p.metrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, rtol=1e-5, atol=1e-7)
    for (path, want_g), got in zip(p.grads.items(), grads):
        assert _rel_l2(got.numpy(), want_g) <= 1e-4, (path, _rel_l2(got.numpy(), want_g))


@pytest.mark.parametrize("arch", list(MODULES))
def test_three_adamw_steps_match_jax(arch):
    p = pair(arch)
    tree = jax.tree.map(lambda t: t.clone(), recsys_tree(p.model))
    opt = AdamWConfig(**OPT)
    step = make_train_step(functools.partial(recsys_loss, cfg=p.cfg), opt)
    state = init_adamw(tree, opt)
    for _ in range(3):
        tree, state, _ = step(tree, state, p.batch)
    for (path, want), got in zip(p.after.items(), tree_leaves(tree)):
        assert _rel_l2(got.numpy(), want) <= 1e-4, (path, _rel_l2(got.numpy(), want))


def test_full_width_shapes_on_meta_match_jax():
    """init_recsys at the published geometries, on the meta device, against
    jax.eval_shape of the reference's init: the same tree of shapes."""
    for arch, (mod, jmod) in MODULES.items():
        cfg = mod.ARCH.model_cfg
        model = init_recsys(cfg, device="meta")
        shapes = jax.tree.map(lambda t: tuple(t.shape), recsys_tree(model))
        jshapes = jax.eval_shape(lambda c=jmod.ARCH.model_cfg: jrec.init_recsys(
            jax.random.PRNGKey(0), c))
        assert shapes == jax.tree.map(lambda s: tuple(s.shape), jshapes), arch
    wd = recsys_tree(init_recsys(wide_deep.ARCH.model_cfg, device="meta"))
    assert wd["tables"].shape == (40, 2_097_152, 32) and wd["wide"].shape == (40, 2_097_152, 1)


def test_init_draws_from_a_seed():
    cfg = dlrm_rm2.reduced()
    a, b = (recsys_tree(init_recsys(cfg, seed=s, device="cpu")) for s in (3, 3))
    c = recsys_tree(init_recsys(cfg, seed=4, device="cpu"))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))
    assert not torch.equal(a["tables"], c["tables"])
    assert float(a["tables"].abs().max()) <= 0.06 and not a["top"]["b0"].any()


def test_two_tower_loss_in_row_blocks_matches_jax(monkeypatch):
    """The in-batch softmax made 16 rows at a time (a checkpoint each under
    grad) against JAX's whole matrix: loss, accuracy and gradients."""
    from repro_torch.models import recsys as prec
    p = pair("two-tower-retrieval")
    monkeypatch.setattr(prec, "IN_BATCH_ROWS", 16)
    tree = recsys_tree(p.model)
    live = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    it = iter(live)
    loss, metrics = recsys_loss(jax.tree.map(lambda _: next(it), tree), p.batch, p.cfg)
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), p.loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["in_batch_acc"]), p.metrics["in_batch_acc"])
    for want, got in zip(p.grads.values(), grads):
        assert _rel_l2(got.numpy(), want) <= 1e-4

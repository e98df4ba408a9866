"""The port's LM training against the JAX package's: the loss, every
gradient leaf, AdamW steps, and the Trainer's behaviours.

Both packages start from the same weights (numpy draws in the shape of
JAX's ``init_transformer`` tree, carried across as f32 masters by
``convert.transformer_params_from_jax(..., f32_masters=True)`` and
``transformer_tree``) and the same batches (the synthetic LM stream,
numpy, equal bit for bit). JAX runs its own
``loss_fn`` under ``jax.value_and_grad`` (jitted once a configuration, in a
module fixture) and its own ``adamw_update``; the port runs its
``loss_fn`` through ``optim.make_train_step``.

Tolerances, each with its reason (the two frameworks sum in different
orders: the chunked CE, ``sdpa``'s softmax, the matmuls):
* loss, CE and aux loss: 1e-5 relative;
* every gradient leaf: 1e-4 relative L2 (leaf against leaf);
* parameters after three AdamW steps (lr 1e-3): 1e-4 relative L2 a leaf
  (AdamW divides each element's moment by its own root mean square, so an
  element whose gradient is small carries its sum-order error into the
  update at full size; at lr 1e-2 a step moves the weights ten times as
  far and the error with them);
* bf16 compute over f32 masters: the loss within 1e-3 relative, every
  gradient leaf within 5e-2 relative L2 (bf16 has 8 bits of mantissa and
  the two frameworks round their products and casts in different places;
  measured 1.4e-2), the masters after one step within 5e-3 relative L2
  (the first AdamW step moves each element by lr times the sign of its
  gradient, so an element whose bf16 gradient is near zero may move the
  other way: measured 1.4e-3 at lr 1e-3);
* gradient accumulation against the big batch: the reference test's own
  ``rtol=2e-3, atol=2e-4``.
"""
import dataclasses
import functools
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as jax_deepseek
from repro.configs import gemma3_27b as jax_gemma
from repro.configs import qwen2_moe_a27b as jax_qwen_moe
from repro.configs import qwen3_14b as jax_qwen
from repro.data.lm import LMDataConfig as JaxLMDataConfig
from repro.data.lm import lm_batch as jax_lm_batch
from repro.models import transformer as jtf
from repro.optim import adamw as jopt
from repro_torch.convert import transformer_params_from_jax
from repro_torch.data import LMDataConfig, lm_batch, lm_batches
from repro_torch.kernels.flashattn import flash_attention
from repro_torch.layers import attention as port_attention
from repro_torch.models import transformer as ptf
from repro_torch.optim import AdamWConfig, init_adamw, make_train_step
from repro_torch.utils import tree_leaves
from repro_torch.train import CheckpointManager, Trainer, TrainerConfig

DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
OPT = dict(lr=1e-3, warmup_steps=1, schedule="constant")
B, S = 2, 40   # S > loss_chunk 32: two chunks, the second padded


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg):
    """The port's config of a reference config: every field the port has."""
    kept = {f.name for f in dataclasses.fields(ptf.TransformerConfig)} - {"use_kernels"}
    vals = {k: getattr(jcfg, k) for k in kept}
    vals["dtype"] = DTYPES[jcfg.dtype]
    return ptf.TransformerConfig(**vals)


def _softcapped(cfg):
    return dataclasses.replace(cfg, logit_softcap=3.0, attn_softcap=2.0)


CASES = {   # gemma3 with both soft caps; qwen2-moe at capacity 1.0 (drops)
    "gemma3": lambda: _softcapped(jax_gemma.reduced()),
    "qwen3": jax_qwen.reduced,
    "qwen2-moe": lambda: dataclasses.replace(jax_qwen_moe.reduced(), capacity_factor=1.0),
    "deepseek-v2": jax_deepseek.reduced,
}


def np_params(jcfg, seed=0) -> dict:
    """Weights for both packages, drawn with numpy into the reference's
    tree (``jax.eval_shape`` of its init: no JAX init to compile): norm
    scales 1 + 0.1 N(0, 1), every other leaf 0.1 N(0, 1)."""
    shapes = jax.eval_shape(functools.partial(jtf.init_transformer, cfg=jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        name = str(path[-1].key)
        x = 0.1 * rng.standard_normal(s.shape).astype(np.float32)
        return x + 1.0 if name.endswith("norm") else x

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(vocab, masked=False):
    cfg = LMDataConfig(vocab=vocab, seq_len=S, batch=B)
    got, want = lm_batch(cfg, 0), jax_lm_batch(JaxLMDataConfig(**dataclasses.asdict(cfg)), 0)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if masked:
        got["labels"] = got["labels"].copy()
        got["labels"][:, ::3] = -1
    return got


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _port_tree(params, cfg):
    """The reference's tree, through the f32-master converter and back."""
    model = transformer_params_from_jax(_np_tree(params), cfg, device="cpu",
                                        f32_masters=True)
    return ptf.transformer_tree(model, cfg)


def _flat(tree, prefix=""):
    """{path: leaf} in sorted key order (the optimizers' leaf order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree.detach().float() if isinstance(tree, torch.Tensor)
                               else tree, np.float32)}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


class JaxRun:
    """The reference's loss and gradients of one config (one jitted
    ``value_and_grad``), and on demand its three AdamW steps (one jitted
    ``adamw_update``)."""

    def __init__(self, jcfg):
        self.jcfg = jcfg
        self.cfg = port_config(jcfg)
        self.params = np_params(jcfg)
        self.vg = jax.jit(jax.value_and_grad(functools.partial(jtf.loss_fn, cfg=jcfg),
                                             has_aux=True))
        self.batch = _batch(jcfg.vocab)
        self.loss, self.metrics, self.grads = self.grad(self.batch)
        self._after = None

    def grad(self, batch):
        (loss, metrics), grads = self.vg(self.params, {k: jnp.asarray(v)
                                                       for k, v in batch.items()})
        return (float(loss), {k: float(v) for k, v in metrics.items()},
                _flat(_np_tree(grads)))

    @property
    def after(self) -> dict:
        if self._after is None:
            batch = {k: jnp.asarray(v) for k, v in self.batch.items()}
            p, state = self.params, jopt.init_adamw(self.params, JOPT)
            for _ in range(3):
                (_, _), g = self.vg(p, batch)
                p, state, _ = JAX_UPDATE(p, g, state)
            self._after = _flat(_np_tree(p))
        return self._after


_RUNS: dict = {}
JOPT = jopt.AdamWConfig(**OPT)
JAX_UPDATE = jax.jit(functools.partial(jopt.adamw_update, cfg=JOPT))   # one a tree structure


def jax_run(name) -> JaxRun:
    if name not in _RUNS:
        _RUNS[name] = JaxRun(CASES[name]())
    return _RUNS[name]


def port_grads(tree, batch, cfg):
    """(loss, metrics, gradient leaves) of the port's loss_fn on ``tree``."""
    live = [t.clone().requires_grad_(True) for t in tree_leaves(tree)]
    it = iter(live)
    loss, metrics = ptf.loss_fn(jax.tree.map(lambda _: next(it), tree), batch, cfg)
    grads = torch.autograd.grad(loss, live)
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


@pytest.mark.parametrize("name", list(CASES))
def test_loss_and_every_gradient_leaf_match_jax(name):
    run = jax_run(name)
    tree = _port_tree(run.params, run.cfg)
    # the same leaves, in the same order, as the reference's tree walk
    jpaths = ["/".join(str(k.key) for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(run.params)[0]]
    assert list(_flat(tree)) == jpaths
    assert all(t.dtype == torch.float32 for t in tree_leaves(tree))
    loss, metrics, grads = port_grads(tree, run.batch, run.cfg)
    np.testing.assert_allclose(loss, run.loss, rtol=1e-5)
    for k, v in run.metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-9)
    assert (run.metrics["aux_loss"] > 0) == run.cfg.is_moe
    for (path, want), got in zip(run.grads.items(), grads):
        assert _rel_l2(got.numpy(), want) <= 1e-4, (path, _rel_l2(got.numpy(), want))
    # remat (each Block recomputed in the backward, MoE routing included)
    # changes nothing
    _, _, again = port_grads(tree, run.batch, dataclasses.replace(run.cfg, remat=True))
    assert all(torch.allclose(a, b, rtol=1e-6, atol=1e-9) for a, b in zip(grads, again))


@pytest.mark.parametrize("name", list(CASES))
def test_three_adamw_steps_match_jax(name):
    """The Trainer's step (parameters and moments updated in place)."""
    run = jax_run(name)
    tree = _port_tree(run.params, run.cfg)
    opt = AdamWConfig(**OPT)
    step = make_train_step(functools.partial(ptf.loss_fn, cfg=run.cfg), opt)
    state = init_adamw(tree, opt)
    new = tree
    for _ in range(3):
        new, state, metrics = step(new, state, run.batch)
    assert int(state["step"]) == 3 and np.isfinite(float(metrics["grad_norm"]))
    assert all(a is b for a, b in zip(tree_leaves(new), tree_leaves(tree)))
    for (path, want), got in zip(run.after.items(), tree_leaves(new)):
        assert _rel_l2(got.numpy(), want) <= 1e-4, (path, _rel_l2(got.numpy(), want))


def test_chunked_update_equals_the_whole_leaf_update(monkeypatch):
    """The update writes parameters and moments in place, leaf by leaf in
    chunks of UPDATE_CHUNK elements: chunks of 1,000 give the bits of
    whole leaves. Clipping is off: the grad norm sums its squares in the
    same chunks, so its last bit, and a clipping factor, may move."""
    from repro_torch.optim import adamw
    run = jax_run("qwen3")
    opt = AdamWConfig(**{**OPT, "clip_norm": 1e30})
    loss = functools.partial(ptf.loss_fn, cfg=run.cfg)
    a, b = _port_tree(run.params, run.cfg), _port_tree(run.params, run.cfg)
    sa, sb = init_adamw(a, opt), init_adamw(b, opt)
    new_a, sa2, _ = make_train_step(loss, opt)(a, sa, run.batch)
    monkeypatch.setattr(adamw, "UPDATE_CHUNK", 1000)
    assert max(t.numel() for t in tree_leaves(b)) > 1000
    new_b, sb2, _ = make_train_step(loss, opt)(b, sb, run.batch)
    assert all(x is y for x, y in zip(tree_leaves(new_a), tree_leaves(a)))
    assert all(x is y for x, y in zip(tree_leaves(sa2["m"]), tree_leaves(sa["m"])))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(new_a), tree_leaves(new_b)))
    assert all(torch.equal(x, y) for x, y in zip(tree_leaves(sa2), tree_leaves(sb2)))


def test_masked_labels_match_jax():
    """Labels < 0 drop out of the mean: loss and gradients with a third of
    the labels masked, against JAX's on the same batch."""
    run = jax_run("qwen3")
    batch = _batch(run.cfg.vocab, masked=True)
    jloss, _, jgrads = run.grad(batch)
    assert abs(jloss - run.loss) > 1e-6
    loss, _, grads = port_grads(_port_tree(run.params, run.cfg), batch, run.cfg)
    np.testing.assert_allclose(loss, jloss, rtol=1e-5)
    for want, got in zip(jgrads.values(), grads):
        assert _rel_l2(got.numpy(), want) <= 1e-4


def test_chunked_ce_matches_jax_and_the_unchunked_loss():
    """chunked_ce_loss at chunks 7 (padded), 16 and the whole sequence,
    softcapped, against JAX's and against a plain full-logits CE."""
    jcfg = CASES["gemma3"]()
    cfg = port_config(jcfg)
    params = np_params(jcfg, seed=2)
    tree = _port_tree(params, cfg)
    rng = np.random.default_rng(0)
    hidden = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.7).astype(np.float32)
    logits = ptf.logits_from_hidden(ptf.model_view(tree, cfg), torch.from_numpy(hidden), cfg)
    lse = torch.logsumexp(logits, -1)
    ll = torch.gather(logits, -1, torch.from_numpy(labels).long()[..., None])[..., 0]
    plain = float(((lse - ll) * torch.from_numpy(mask)).sum() / mask.sum())
    for chunk in (7, 16, S):
        jc, c = (dataclasses.replace(x, loss_chunk=chunk) for x in (jcfg, cfg))
        want = float(jtf.chunked_ce_loss(params, jnp.asarray(hidden), jnp.asarray(labels),
                                         jnp.asarray(mask), jc))
        got = float(ptf.chunked_ce_loss(tree, torch.from_numpy(hidden),
                                        torch.from_numpy(labels), torch.from_numpy(mask), c))
        np.testing.assert_allclose(got, want, rtol=1e-5)
        np.testing.assert_allclose(got, plain, rtol=1e-5)


def test_bf16_compute_over_f32_masters_matches_jax():
    """qwen3 computed in bf16 over f32 masters: the loss and gradients
    against JAX's (jitted, as the reference trains), then one AdamW step:
    the masters stay f32 and move as JAX's do."""
    run = jax_run("qwen3")
    jcfg = dataclasses.replace(run.jcfg, dtype=jnp.bfloat16)
    cfg = port_config(jcfg)
    vg = jax.jit(jax.value_and_grad(functools.partial(jtf.loss_fn, cfg=jcfg), has_aux=True))
    (jloss, _), jgrads = vg(run.params, {k: jnp.asarray(v) for k, v in run.batch.items()})
    jnew, _, _ = JAX_UPDATE(run.params, jgrads, jopt.init_adamw(run.params, JOPT))
    tree = _port_tree(run.params, cfg)
    loss, _, grads = port_grads(tree, run.batch, cfg)
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-3)
    for want, got in zip(_flat(_np_tree(jgrads)).values(), grads):
        assert got.dtype == torch.float32 and _rel_l2(got.numpy(), want) <= 5e-2
    popt = AdamWConfig(**OPT)
    new, _, _ = make_train_step(functools.partial(ptf.loss_fn, cfg=cfg), popt)(
        tree, init_adamw(tree, popt), run.batch)
    for want, got in zip(_flat(_np_tree(jnew)).values(), tree_leaves(new)):
        assert got.dtype == torch.float32          # the masters stay f32
        assert _rel_l2(got.numpy(), want) <= 5e-3


def test_training_runs_no_flash_attention():
    """loss_fn selects sdpa: neither the flash-attention kernel nor its
    plain version is called, forward or backward, remat on and off."""
    def refuse(*a, **k):
        raise AssertionError("the training path called flash attention")

    cfg = port_config(jax_qwen.reduced())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_attention, "flash_attention", refuse)
        mp.setattr(port_attention, "flash_attention_ref", refuse)
        for remat in (True, False):
            c = dataclasses.replace(cfg, remat=remat)
            tree = ptf.transformer_tree(ptf.init_transformer(c, device="cpu",
                                                             f32_masters=True), c)
            step = make_train_step(functools.partial(ptf.loss_fn, cfg=c), AdamWConfig(**OPT))
            _, _, m = step(tree, init_adamw(tree, AdamWConfig(**OPT)), _batch(cfg.vocab))
            assert np.isfinite(float(m["loss"]))


def test_flash_attention_refuses_inputs_that_require_grad():
    q = torch.randn(1, 2, 4, 16, requires_grad=True)
    k = torch.randn(1, 1, 4, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, k)
    with torch.no_grad():
        assert flash_attention(q, k, k).shape == q.shape
    assert flash_attention(q.detach(), k, k).shape == q.shape


def test_transformer_tree_round_trip_and_serving_module():
    """transformer_tree -> transformer_from_tree gives the model back, f32
    masters or cast to the serving dtype; the f32-master init draws the
    serving init's weights."""
    cfg = port_config(jax_deepseek.reduced())
    model = ptf.init_transformer(cfg, device="cpu", f32_masters=True)
    tree = ptf.transformer_tree(model, cfg)
    back = ptf.transformer_from_tree(tree, cfg, f32_masters=True)
    for (n, a), (m, b) in zip(model.named_parameters(), back.named_parameters()):
        assert n == m and torch.equal(a, b)
    bf = ptf.transformer_from_tree(tree, dataclasses.replace(cfg, dtype=torch.bfloat16))
    assert bf.layers[1].moe.w_up.dtype == torch.bfloat16
    assert bf.layers[1].moe.router.dtype == torch.float32
    assert bf.final_norm.dtype == torch.float32
    serve = ptf.init_transformer(dataclasses.replace(cfg, dtype=torch.bfloat16), device="cpu")
    assert torch.equal(serve.layers[0].attn.w_dq, model.layers[0].attn.w_dq.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# The Trainer (after tests/test_train_serve.py)
# ---------------------------------------------------------------------------

TCFG = ptf.TransformerConfig(name="t", n_layers=2, d_model=32, n_heads=2, n_kv=1,
                             d_head=16, d_ff=64, vocab=64, dtype=torch.float32,
                             loss_chunk=16, remat=False)
DCFG = LMDataConfig(vocab=64, seq_len=16, batch=4)
LOSS = functools.partial(ptf.loss_fn, cfg=TCFG)


def _params():
    return ptf.transformer_tree(ptf.init_transformer(TCFG, device="cpu", f32_masters=True),
                                TCFG)


def _trainer(tmp, total=20, **kw):
    return Trainer(LOSS, _params(), AdamWConfig(lr=1e-2, total_steps=100, warmup_steps=2),
                   TrainerConfig(total_steps=total, ckpt_every=10, log_every=5,
                                 ckpt_dir=str(tmp), **kw))


def test_trainer_loss_decreases_and_metrics_logged(tmp_path):
    mpath = str(tmp_path / "metrics.jsonl")
    out = _trainer(tmp_path / "ck", metrics_path=mpath).fit(lm_batches(DCFG))
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert [h["step"] for h in out["history"]] == [1, 5, 10, 15, 20]
    lines = [json.loads(line) for line in open(mpath)]
    assert len(lines) == 5 and all("loss" in line for line in lines)
    assert CheckpointManager(str(tmp_path / "ck")).completed_steps() == [10, 20]


def test_trainer_restart_resumes_exactly(tmp_path):
    ck = tmp_path / "ck"
    tr1 = _trainer(ck, total=20)
    tr1.fit(lm_batches(DCFG))
    tr2 = _trainer(ck, total=30)
    assert tr2.maybe_restore() and tr2.step == 20
    for a, b in zip(tree_leaves(tr2.params), tree_leaves(tr1.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(tr2.opt_state), tree_leaves(tr1.opt_state)):
        assert torch.equal(a, b)
    out = tr2.fit(lm_batches(DCFG, start_step=20))
    assert out["final_step"] == 30
    # the same 30 steps uninterrupted end on the same bits
    tr3 = _trainer(tmp_path / "ck3", total=30)
    tr3.fit(lm_batches(DCFG))
    for a, b in zip(tree_leaves(tr3.params), tree_leaves(tr2.params)):
        assert torch.equal(a, b)


def test_trainer_checkpoints_bf16_moments(tmp_path):
    """deepseek-v2's optimizer keeps its moments in bf16: they checkpoint
    (as their bits) and restore into the template's bf16, exactly."""
    opt = AdamWConfig(lr=1e-2, warmup_steps=2, moment_dtype=torch.bfloat16)
    tr1 = Trainer(LOSS, _params(), opt, TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path)))
    tr1.fit(lm_batches(DCFG))
    tr2 = Trainer(LOSS, _params(), opt, TrainerConfig(total_steps=3, ckpt_dir=str(tmp_path)))
    assert tr2.maybe_restore() and tr2.step == 3
    for a, b in zip(tree_leaves(tr2.opt_state), tree_leaves(tr1.opt_state)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert tr2.opt_state["m"]["embed"].dtype == torch.bfloat16


def test_trainer_data_fault_skipped_not_fatal(tmp_path):
    class Flaky:
        def __init__(self):
            self.src = lm_batches(DCFG)
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            self.n += 1
            if self.n == 3:
                raise RuntimeError("simulated data-shard timeout")
            return next(self.src)

    mpath = str(tmp_path / "m.jsonl")
    out = _trainer(tmp_path / "ck", total=10, metrics_path=mpath).fit(Flaky())
    assert out["final_step"] == 10
    assert sum("data_fault" in json.loads(line) for line in open(mpath)) == 1


def test_trainer_preemption_signal_checkpoints(tmp_path):
    tr = _trainer(tmp_path / "ck", total=1000)
    src = lm_batches(DCFG)

    def batches():
        n = 0
        while True:
            n += 1
            if n == 6:  # SIGTERM mid-run
                os.kill(os.getpid(), signal.SIGTERM)
            yield next(src)

    old = signal.getsignal(signal.SIGTERM)
    try:
        out = tr.fit(batches())
    finally:
        signal.signal(signal.SIGTERM, old)
    assert out["final_step"] < 1000
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == out["final_step"]


def test_gradient_accumulation_matches_big_batch():
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, schedule="constant")
    batch = lm_batch(LMDataConfig(vocab=64, seq_len=16, batch=8), 0)
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    a, b = _params(), _params()
    p1, _, _ = make_train_step(LOSS, opt)(a, init_adamw(a, opt), batch)
    p2, _, _ = make_train_step(LOSS, opt, accum_steps=2)(b, init_adamw(b, opt), batch)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-4)


def test_trainer_with_a_mesh_raises(tmp_path):
    """The mesh trainer, which raised until it was ported: ``Trainer(mesh=,
    param_rules=LM_RULES)`` on a one-rank gloo mesh in this process equals
    the unsharded ``Trainer`` over 3 steps, its leaves DTensors, every
    metric and leaf within 1e-6 relative (the lookup and the label logit
    take DTensor's ops there)."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.dist import LM_RULES, make_mesh
    own = not dist.is_initialized()
    mesh = make_mesh((1, 1), device_type="cpu")
    try:
        opt = AdamWConfig(lr=1e-2, total_steps=100, warmup_steps=2)

        def cfg(name):
            return TrainerConfig(total_steps=3, ckpt_every=10, log_every=1,
                                 ckpt_dir=str(tmp_path / name))
        ref = Trainer(LOSS, _params(), opt, cfg("plain"))
        want = ref.fit(lm_batches(DCFG))["history"]
        tr = Trainer(LOSS, _params(), opt, cfg("mesh"), mesh=mesh, param_rules=LM_RULES)
        got = tr.fit(lm_batches(DCFG))["history"]
        assert [h["step"] for h in got] == [1, 2, 3]
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            for k in w:
                assert g[k] == pytest.approx(w[k], rel=1e-6), (g["step"], k)
        for a, b in zip(tree_leaves(tr.params), tree_leaves(ref.params)):
            assert isinstance(a, DTensor)
            np.testing.assert_allclose(a.full_tensor().numpy(), b.numpy(), rtol=1e-6,
                                       atol=1e-7)
    finally:
        if own:
            dist.destroy_process_group()

"""The port's LM serving path against the JAX package's.

Layers get the same numpy weights and inputs in both packages; whole models
come across from JAX's ``init_transformer`` through
``convert.transformer_params_from_jax`` (the two frameworks' generators
cannot give the same draws). Everything here is f32, as the reduced
configurations are; on the CPU the port's attention core is the
flash-attention kernel's plain version (MLA's is ``sdpa`` everywhere).

Tolerances, each with its reason:
* norms, embeddings, MLP, attention layers: ``rtol=1e-5, atol=1e-5``
  (products and sums in another order: a few f32 ulp);
* rope at positions up to 4,096: ``atol=5e-4``. An angle there reaches
  ~4,100 rad, where one f32 ulp is 4.9e-4, and the two frameworks' f32
  ``pow`` (for ``inv_freq``) and ``sin``/``cos`` may each differ by an
  ulp (measured: 8.6e-5 at dh=128, theta 1e6); the error grows with the
  position, and at positions below 20 the comparison holds to 1e-5;
* models (gemma3 with its 16-token window shorter than the prompt, dual
  theta and sandwich norms; qwen3 with qk-norm, untied; starcoder2 with
  the plain GELU MLP and MQA; qwen2-moe (GQA + MoE) and deepseek-v2 (MLA +
  MoE, a leading dense layer), each also at capacity factor 1.0, where
  decode steps drop assignments): logits within 1e-4 and caches within
  1e-5 (absolute, on O(1) values) over prefill and 8 decode steps, the
  greedy tokens equal on every step; the MoE aux loss within 1e-6, and
  every MoE call's output within 1e-5 of JAX's ``moe_layer`` on the same
  input, its dropped assignments equal in number.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_v2_236b as jax_deepseek
from repro.configs import gemma3_27b as jax_gemma
from repro.configs import qwen2_moe_a27b as jax_qwen_moe
from repro.configs import qwen3_14b as jax_qwen
from repro.configs import starcoder2_7b as jax_star
from repro.data.lm import LMDataConfig as JaxLMDataConfig
from repro.data.lm import lm_batch as jax_lm_batch
from repro.layers import attention as jatt
from repro.layers import embedding as jemb
from repro.layers import moe as jmoe
from repro.layers import norm as jnorm
from repro.layers import rope as jrope
from repro.models import transformer as jtf
from repro_torch.configs import (
    deepseek_v2_236b, gemma3_27b, qwen2_moe_a27b, qwen3_14b, starcoder2_7b)
from repro_torch.convert import transformer_params_from_jax
from repro_torch.data import LMDataConfig, lm_batch
from repro_torch.layers import (
    GQA, MLP, GQAConfig, KVCache, MLPConfig, apply_rope, embed_tokens,
    gqa_attention, init_gqa, init_mlp, layer_norm, mlp, rms_norm, unembed)
from repro_torch.models import (
    TransformerConfig, cache_shapes, decode_step, forward, greedy_token,
    init_cache, init_transformer, logits_from_hidden, prefill)
from repro_torch.layers.moe import dispatch_plan
from repro_torch.models import transformer as port_tf
from repro_torch.models.transformer import chunked_ce_loss, loss_fn

jmlp = importlib.import_module("repro.layers.mlp")   # the package's ``mlp`` is the function

TOL = dict(rtol=1e-5, atol=1e-5)
TN_STD = 0.9865881  # std of a unit normal truncated at +-3
# the reference's fields the port's TransformerConfig leaves out (XLA's
# scan unrolling), and the port's own
LEFT_OUT = {"scan_unroll"}
DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_config(jcfg) -> TransformerConfig:
    """The port's config of a reference config: every kept field copied."""
    kept = {f.name for f in dataclasses.fields(TransformerConfig)} - {"use_kernels"}
    vals = {k: getattr(jcfg, k) for k in kept}
    vals["dtype"] = DTYPES[jcfg.dtype]
    return TransformerConfig(**vals)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("unit_offset", [False, True])
def test_rms_norm_matches_jax(unit_offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32) * 3
    w = rng.standard_normal(48).astype(np.float32) * 0.1
    want = _np(jnorm.rms_norm(x, w, unit_offset=unit_offset))
    np.testing.assert_allclose(rms_norm(_t(x), _t(w), unit_offset=unit_offset).numpy(),
                               want, **TOL)
    b = rng.standard_normal(48).astype(np.float32)
    np.testing.assert_allclose(layer_norm(_t(x), _t(w), _t(b)).numpy(),
                               _np(jnorm.layer_norm(x, w, b)), **TOL)


@pytest.mark.parametrize("theta,dh", [(10_000.0, 16), (1_000_000.0, 128)])
def test_rope_matches_jax(theta, dh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 40, 3, dh)).astype(np.float32)
    pos = np.concatenate([np.arange(20), 4096 - np.arange(20)]).astype(np.int32)
    want = _np(jrope.apply_rope(x, pos, theta))
    got = apply_rope(_t(x), torch.from_numpy(pos), theta).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    np.testing.assert_allclose(got[:, :20], want[:, :20], **TOL)


def test_embedding_matches_jax():
    rng = np.random.default_rng(2)
    table = rng.standard_normal((50, 24)).astype(np.float32) * 0.02
    toks = rng.integers(0, 50, (3, 7)).astype(np.int32)
    for scale in (False, True):
        want = _np(jemb.embed_tokens(table, toks, jnp.float32, scale=scale))
        got = embed_tokens(_t(table), torch.from_numpy(toks), torch.float32, scale=scale)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    # bf16: sqrt(d_model) rounded to bf16 first, as the reference (d=5376:
    # 73.32 -> 73.5)
    big = np.full((2, 5376), 0.5, np.float32)
    got = embed_tokens(_t(big), torch.tensor([[1]]), torch.bfloat16, scale=True)
    assert float(got[0, 0, 0]) == 0.5 * 73.5
    want = _np(jemb.embed_tokens(big, np.array([[1]]), jnp.bfloat16, scale=True))
    assert float(want[0, 0, 0]) == 0.5 * 73.5
    x = rng.standard_normal((3, 7, 24)).astype(np.float32)
    for cap in (0.0, 3.0):
        np.testing.assert_allclose(unembed(_t(table), _t(x), cap).numpy(),
                                   _np(jemb.unembed(table, x, cap)), **TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True), ("gelu", False)])
def test_mlp_matches_jax(act, gated):
    cfg = MLPConfig(d_model=32, d_ff=80, act=act, gated=gated)
    jcfg = jmlp.MLPConfig(d_model=32, d_ff=80, act=act, gated=gated)
    params = jax.tree.map(np.asarray, jmlp.init_mlp(jax.random.PRNGKey(0), jcfg))
    x = np.random.default_rng(3).standard_normal((2, 9, 32)).astype(np.float32)
    port = MLP(_t(params["w_up"]), _t(params["w_down"]),
               _t(params["w_gate"]) if gated else None)
    np.testing.assert_allclose(mlp(port, _t(x), cfg).numpy(),
                               _np(jmlp.mlp(params, x, jcfg)), **TOL)


def _gqa_pair(qk_norm=True, softcap=0.0):
    jcfg = jatt.GQAConfig(d_model=48, n_heads=6, n_kv=2, d_head=16,
                          qk_norm=qk_norm, softcap=softcap)
    cfg = GQAConfig(d_model=48, n_heads=6, n_kv=2, d_head=16, qk_norm=qk_norm,
                    softcap=softcap)
    p = jax.tree.map(np.asarray, jatt.init_gqa(jax.random.PRNGKey(1), jcfg))
    rng = np.random.default_rng(4)
    if qk_norm:   # scales other than the init's ones
        p = dict(p, q_norm=1 + 0.1 * rng.standard_normal(16).astype(np.float32),
                 k_norm=1 + 0.1 * rng.standard_normal(16).astype(np.float32))
    norms = [_t(p[n]) for n in ("q_norm", "k_norm")] if qk_norm else []
    port = GQA(_t(p["wq"]), _t(p["wk"]), _t(p["wv"]), _t(p["wo"]), *norms)
    return jcfg, cfg, p, port


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (5, 0.0), (0, 20.0)])
def test_gqa_attention_matches_jax(window, softcap):
    jcfg, cfg, p, port = _gqa_pair(softcap=softcap)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 48)).astype(np.float32)
    # no cache, positions from 3
    pos = np.broadcast_to(3 + np.arange(11)[None], (2, 11)).astype(np.int32)
    want, _ = jatt.gqa_attention(p, x, jcfg, positions=pos, rope_theta=10_000.0,
                                 window=window)
    got, _ = gqa_attention(port, _t(x), cfg, q_offset=3, rope_theta=10_000.0,
                           window=window)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    # with a cache: a prompt of 11, then one decode token at position 11
    jc = jatt.KVCache(k=jnp.zeros((2, 16, 2, 16)), v=jnp.zeros((2, 16, 2, 16)))
    pc = KVCache(k=torch.zeros((2, 16, 2, 16)), v=torch.zeros((2, 16, 2, 16)))
    pos0 = np.broadcast_to(np.arange(11)[None], (2, 11)).astype(np.int32)
    want, jc = jatt.gqa_attention(p, x, jcfg, positions=pos0, rope_theta=1e6,
                                  window=window, cache=jc, cache_pos=0,
                                  kv_valid_len=jnp.asarray(11))
    got, pc2 = gqa_attention(port, _t(x), cfg, q_offset=0, rope_theta=1e6,
                             window=window, cache=pc, kv_valid_len=11)
    assert pc2 is pc                         # updated in place
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    x1 = rng.standard_normal((2, 1, 48)).astype(np.float32)
    want, jc = jatt.gqa_attention(p, x1, jcfg, positions=np.full((2, 1), 11, np.int32),
                                  rope_theta=1e6, window=window, cache=jc,
                                  cache_pos=11, kv_valid_len=jnp.asarray(12))
    got, pc = gqa_attention(port, _t(x1), cfg, q_offset=11, rope_theta=1e6,
                            window=window, cache=pc, kv_valid_len=12)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(pc.k.numpy(), _np(jc.k), **TOL)
    np.testing.assert_allclose(pc.v.numpy(), _np(jc.v), **TOL)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _capacity_1(make):
    return lambda: dataclasses.replace(make(), capacity_factor=1.0)


MODELS = {"gemma3": jax_gemma.reduced, "qwen3": jax_qwen.reduced,
          "starcoder2": jax_star.reduced, "qwen2moe": jax_qwen_moe.reduced,
          "deepseek": jax_deepseek.reduced,
          # capacity factor 1.0: a decode step of 2 tokens gets capacity 1
          "qwen2moe-drop": _capacity_1(jax_qwen_moe.reduced),
          "deepseek-drop": _capacity_1(jax_deepseek.reduced)}
DROP_FREE = ["gemma3", "qwen3", "starcoder2", "qwen2moe", "deepseek"]


@pytest.fixture(scope="module")
def jax_inits():
    """JAX's parameter trees by reduced model name (a "-drop" variant's
    capacity factor changes no weight, so it shares its model's)."""
    return {}


@pytest.fixture(scope="module", params=list(MODELS))
def model_pair(request, jax_inits):
    jcfg = MODELS[request.param]()
    base = request.param.removesuffix("-drop")
    if base not in jax_inits:
        jax_inits[base] = jax.jit(jtf.init_transformer, static_argnums=1)(
            jax.random.PRNGKey(0), MODELS[base]())
    params = jax_inits[base]
    cfg = port_config(jcfg)
    model = transformer_params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                        device="cpu")
    return jcfg, params, cfg, model


class MoESpy:
    """Records every call of the port's ``moe_layer`` inside the model (the
    layer, its input and its results) and holds each, after the run, to
    JAX's ``moe_layer`` on the same input with that layer's JAX weights."""

    def __init__(self, monkeypatch, model, params, jcfg):
        self.calls, self.layer_of = [], {}
        fd = jcfg.first_dense
        for i, layer in enumerate(model.layers):
            if layer.moe is not None:
                self.layer_of[id(layer.moe)] = jax.tree.map(
                    lambda a, j=i - fd: a[j], params["layers"]["moe"])
        inner = port_tf.moe_layer

        def spy(p, h, cfg, capacity=None):
            y, aux = inner(p, h, cfg, capacity)
            self.calls.append((id(p), h.numpy().copy(), y.numpy().copy(), aux))
            return y, aux
        monkeypatch.setattr(port_tf, "moe_layer", spy)
        self.jmoe = jax.jit(lambda p, h: jmoe.moe_layer(p, h, jcfg.moe_cfg()))
        self.mcfg = port_config(jcfg).moe_cfg()

    def check(self) -> int:
        """Returns the number of assignments dropped over all calls."""
        dropped = 0
        for key, h, y, aux in self.calls:
            jy, jaux = self.jmoe(self.layer_of[key], h)
            np.testing.assert_allclose(y, _np(jy), rtol=1e-5, atol=1e-5)
            groups, tg, _ = dispatch_plan(h.shape[0] * h.shape[1], self.mcfg)
            n = groups * tg * self.mcfg.top_k
            got = int(round(float(aux["dropped_frac"]) * n))
            assert got == int(round(float(jaux["dropped_frac"]) * n))
            np.testing.assert_allclose(float(aux["aux_loss"]), float(jaux["aux_loss"]),
                                       rtol=0, atol=1e-6)
            dropped += got
        return dropped


def test_gemma3_reduced_is_the_port_config():
    assert port_config(jax_gemma.reduced()) == gemma3_27b.reduced()
    assert port_config(jax_gemma.ARCH.model_cfg) == gemma3_27b.ARCH.model_cfg
    assert gemma3_27b.ARCH.shapes == {
        k: type(gemma3_27b.ARCH.shapes[k])(**vars(v))
        for k, v in jax_gemma.ARCH.shapes.items()}
    kept = {f.name for f in dataclasses.fields(TransformerConfig)} - {"use_kernels"}
    assert set(vars(jax_gemma.reduced())) - kept == LEFT_OUT


def test_lm_data_is_the_reference_stream():
    for cfg in (LMDataConfig(vocab=262_144, seq_len=64, batch=4),
                LMDataConfig(vocab=512, seq_len=24, batch=2, seed=3)):
        jcfg = JaxLMDataConfig(**dataclasses.asdict(cfg))
        for step in (0, 5):
            got, want = lm_batch(cfg, step), jax_lm_batch(jcfg, step)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(got[key], want[key])


def test_forward_prefill_decode_match_jax(model_pair, monkeypatch):
    jcfg, params, cfg, model = model_pair
    spy = MoESpy(monkeypatch, model, params, jcfg) if cfg.is_moe else None
    toks = lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=20, batch=2, seed=1), 0)["tokens"]
    max_len = 32
    with torch.inference_mode():
        h, _, aux = forward(model, torch.from_numpy(toks), cfg)
        jh, _, jaux = jax.jit(jtf.forward, static_argnums=(2,))(params, toks, jcfg)
        np.testing.assert_allclose(logits_from_hidden(model, h, cfg).numpy(),
                                   _np(jtf.logits_from_hidden(params, jh, jcfg)),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=0, atol=1e-6)
        assert cfg.is_moe == (float(aux) > 0)
        lg, cache, pos = prefill(model, torch.from_numpy(toks), cfg, max_len)
        jlg, jcache, jpos = jax.jit(jtf.prefill, static_argnums=(2, 3))(
            params, toks, jcfg, max_len)
        assert pos == int(jpos) == 20
        assert tuple(cache.k.shape) == jcache.k.shape and tuple(cache.v.shape) == jcache.v.shape
        jstep = jax.jit(jtf.decode_step, static_argnums=(4,))
        for step in range(9):
            np.testing.assert_allclose(lg.numpy(), _np(jlg), rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(cache.k.numpy(), _np(jcache.k), rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(cache.v.numpy(), _np(jcache.v), rtol=1e-5, atol=1e-5)
            tok, jtok = greedy_token(lg), jtf.greedy_token(jlg)
            np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
            if step == 8:
                break
            lg, cache = decode_step(model, tok, cache, pos, cfg)
            jlg, jcache = jstep(params, jtok, jcache, jnp.asarray(pos, jnp.int32), jcfg)
            pos += 1
    if spy is not None:
        n_moe = cfg.n_layers - cfg.first_dense
        assert len(spy.calls) == n_moe * (1 + 1 + 8)    # forward, prefill, 8 steps
        dropped = spy.check()
        assert (dropped > 0) == (cfg.capacity_factor == 1.0)


@pytest.mark.parametrize("model_pair", DROP_FREE, indirect=True)
def test_decode_matches_teacher_forcing(model_pair):
    """The port of tests/test_models.py::test_lm_decode_matches_teacher_forcing
    (on the drop-free configurations: where a MoE drops, capacity depends
    on the token count, so a decode step and a full forward differ)."""
    _, _, cfg, model = model_pair
    toks = torch.from_numpy(lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=12,
                                                  batch=2, seed=2), 0)["tokens"])
    with torch.inference_mode():
        lg_p, cache, kvlen = prefill(model, toks, cfg, max_len=16)
        h_full, _, _ = forward(model, toks, cfg)
        np.testing.assert_allclose(
            lg_p.numpy(), logits_from_hidden(model, h_full[:, -1:], cfg).numpy(),
            rtol=1e-5, atol=1e-5)
        nt = greedy_token(lg_p)
        lg_d, _ = decode_step(model, nt, cache, kvlen, cfg)
        h2, _, _ = forward(model, torch.cat([toks, nt], dim=1), cfg)
        np.testing.assert_allclose(
            lg_d.numpy(), logits_from_hidden(model, h2[:, -1:], cfg).numpy(),
            rtol=1e-5, atol=1e-5)


def test_plain_path_equals_kernel_path_on_cpu(model_pair):
    """``use_kernels=False`` runs the plain version on any device; on the
    CPU the dispatcher takes the same plain version, so the two agree."""
    _, _, cfg, model = model_pair
    toks = torch.from_numpy(lm_batch(LMDataConfig(vocab=cfg.vocab, seq_len=10,
                                                  batch=1), 0)["tokens"])
    with torch.inference_mode():
        a = prefill(model, toks, cfg, 12)[0]
        b = prefill(model, toks, dataclasses.replace(cfg, use_kernels=False), 12)[0]
    assert torch.equal(a, b)


def test_layer_meta_matches_jax():
    for jcfg in (jax_gemma.ARCH.model_cfg, jax_gemma.reduced(), jax_qwen.reduced()):
        for got, want in zip(port_config(jcfg).layer_meta(), jcfg.layer_meta()):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    windows, thetas = gemma3_27b.ARCH.model_cfg.layer_meta()
    assert windows.shape == (62,) and int((windows == 1024).sum()) == 52
    assert set(np.flatnonzero(windows == 0)) == set(range(5, 62, 6))
    assert set(thetas[windows == 0]) == {1e6} and set(thetas[windows > 0]) == {1e4}


def _meta_shapes(port_cfg, jax_cfg) -> dict:
    """The port's full-width state dict on the meta device, held name for
    name and shape for shape to ``jax.eval_shape`` of the reference's init
    (``dense_layer{i}`` is the port's layer i, the stacked layers follow);
    returns {name: (shape, dtype)}."""
    model = init_transformer(port_cfg, device="meta")
    shapes = {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}
    jshapes = jax.eval_shape(lambda: jtf.init_transformer(jax.random.PRNGKey(0), jax_cfg))
    want, fd = {}, port_cfg.first_dense
    for path, leaf in jax.tree_util.tree_flatten_with_path(jshapes)[0]:
        keys = [str(p.key) for p in path]
        if keys[0] == "layers":
            for i in range(fd, port_cfg.n_layers):
                want[".".join(["layers", str(i)] + keys[1:])] = leaf.shape[1:]
        elif keys[0].startswith("dense_layer"):
            want[".".join(["layers", keys[0][len("dense_layer"):]] + keys[1:])] = leaf.shape
        else:
            want[".".join(keys)] = leaf.shape
    assert {k: s for k, (s, _) in shapes.items()} == want
    return shapes


def test_full_width_shapes_on_meta_match_jax():
    cfg = gemma3_27b.ARCH.model_cfg
    shapes = _meta_shapes(cfg, jax_gemma.ARCH.model_cfg)
    # dense weights in bf16 (the reference's f32 masters, cast once), norms f32
    assert shapes["layers.0.attn.wq"] == ((5376, 32, 128), torch.bfloat16)
    assert shapes["layers.61.mlp.w_down"] == ((21504, 5376), torch.bfloat16)
    assert shapes["embed"] == ((262_144, 5376), torch.bfloat16)
    assert shapes["layers.0.post_ffn_norm"] == ((5376,), torch.float32)
    assert shapes["layers.0.attn.q_norm"] == ((128,), torch.float32)
    assert sum(np.prod(s) for s, _ in shapes.values()) == 27_009_002_240
    # the serving cache: 4 prompts of 4,096 + 32 decoded tokens
    k, v = cache_shapes(cfg, 4, 4128)
    jk, jv = jtf.cache_shapes(jax_gemma.ARCH.model_cfg, 4, 4128)
    assert tuple(k.shape) == jk.shape == tuple(v.shape) == jv.shape == (62, 4, 4128, 16, 128)
    assert k.dtype == torch.bfloat16 and jk.dtype == jnp.bfloat16
    assert 2 * 2 * k.numel() == 8_386_510_848       # 8.39 GB in bf16


LM_FAMILY = {   # port config module, JAX config module, parameters
    "qwen2-moe-a2.7b": (qwen2_moe_a27b, jax_qwen_moe, 15_146_059_776),
    "deepseek-v2-236b": (deepseek_v2_236b, jax_deepseek, 235_741_434_880),
    "qwen3-14b": (qwen3_14b, jax_qwen, 14_768_307_200),
    "starcoder2-7b": (starcoder2_7b, jax_star, 7_172_559_360),
}


@pytest.mark.parametrize("arch", list(LM_FAMILY))
def test_lm_family_full_width_shapes_on_meta_match_jax(arch):
    mod, jmod, n_params = LM_FAMILY[arch]
    cfg = mod.ARCH.model_cfg
    shapes = _meta_shapes(cfg, jmod.ARCH.model_cfg)
    assert sum(np.prod(s) for s, _ in shapes.values()) == n_params
    k, v = cache_shapes(cfg, 4, 1056)
    jk, jv = jtf.cache_shapes(jmod.ARCH.model_cfg, 4, 1056)
    assert (tuple(k.shape), tuple(v.shape)) == (jk.shape, jv.shape)
    assert k.dtype == v.dtype == torch.bfloat16
    if cfg.is_moe:   # the router f32, the experts bf16 in their allocated rows
        name = f"layers.{cfg.first_dense}.moe"
        assert shapes[f"{name}.router"] == ((cfg.d_model, cfg.n_experts), torch.float32)
        assert shapes[f"{name}.w_gate"] == (
            (max(cfg.n_experts, cfg.n_experts_alloc), cfg.d_model, cfg.d_expert), torch.bfloat16)
        fs = cfg.n_shared * cfg.d_expert
        assert shapes[f"{name}.shared.w_down"] == ((fs, cfg.d_model), torch.bfloat16)
    if cfg.attn_kind == "mla":   # the latent and the rope key: 576 values a token
        assert tuple(k.shape) == (60, 4, 1056, 512) and tuple(v.shape) == (60, 4, 1056, 64)
        assert shapes["layers.0.mlp.w_up"] == ((5120, 12288), torch.bfloat16)
        assert shapes["layers.0.attn.kv_norm"] == ((512,), torch.float32)
        assert shapes["layers.1.attn.w_uq"] == ((1536, 128, 192), torch.bfloat16)


@pytest.mark.parametrize("arch", list(LM_FAMILY))
def test_lm_family_configs_are_the_reference_configs(arch):
    mod, jmod, _ = LM_FAMILY[arch]
    assert port_config(jmod.ARCH.model_cfg) == mod.ARCH.model_cfg
    assert port_config(jmod.reduced()) == mod.reduced()
    assert mod.ARCH.arch_id == jmod.ARCH.arch_id and mod.ARCH.source == jmod.ARCH.source
    assert mod.ARCH.shapes == {k: type(mod.ARCH.shapes[k])(**vars(v))
                               for k, v in jmod.ARCH.shapes.items()}
    # what the reference's transformer builds from the fields
    jcfg, cfg = jmod.ARCH.model_cfg, mod.ARCH.model_cfg
    for port, ref in ((cfg.attn_cfg(), jcfg.attn_cfg()), (cfg.mlp_cfg(), jcfg.mlp_cfg())):
        assert type(port).__name__ == type(ref).__name__
        shared = {f.name for f in dataclasses.fields(port)} & set(vars(ref))
        assert {n: getattr(port, n) for n in shared} == {n: getattr(ref, n) for n in shared}
    if cfg.is_moe:
        assert vars(cfg.moe_cfg()) == vars(jcfg.moe_cfg())


def test_init_statistics():
    cfg = dataclasses.replace(gemma3_27b.reduced(), d_model=128, d_ff=512, vocab=4096)
    model = init_transformer(cfg, seed=3, device="cpu")
    emb = model.embed.detach()
    assert float(emb.abs().max()) <= 3 * 0.02
    assert abs(float(emb.std()) - 0.02 * TN_STD) < 0.02 * 0.01
    for name, w, fan_in in (("wq", model.layers[0].attn.wq, 128),
                            ("wo", model.layers[2].attn.wo, 4 * 16),
                            ("w_down", model.layers[5].mlp.w_down, 512)):
        sigma = fan_in ** -0.5
        assert float(w.abs().max()) <= 3 * sigma, name
        assert abs(float(w.std()) - sigma * TN_STD) < sigma * 0.05, name
    # sandwich norms are offsets from 1: zeros; qk-norm scales: ones
    assert not model.layers[0].post_attn_norm.any() and not model.final_norm.any()
    assert torch.equal(model.layers[0].attn.q_norm, torch.ones(16))
    again = init_transformer(cfg, seed=3, device="cpu")
    assert torch.equal(again.layers[4].mlp.w_up, model.layers[4].mlp.w_up)
    assert not torch.equal(init_transformer(cfg, seed=4, device="cpu").embed, model.embed)
    # the reference's draws have the same distribution
    jp = jtf.init_transformer(jax.random.PRNGKey(0), jax_gemma.reduced())
    jw = np.asarray(jp["layers"]["attn"]["wq"])
    assert abs(float(jw.std()) - 64 ** -0.5 * TN_STD) < 64 ** -0.5 * 0.05
    # bf16 storage
    bf = init_transformer(dataclasses.replace(cfg, dtype=torch.bfloat16), device="cpu")
    assert bf.layers[0].mlp.w_gate.dtype == torch.bfloat16
    assert bf.layers[0].attn_norm.dtype == torch.float32


def test_unported_parts_raise():
    """Nothing of the LM family is left unported. The activation pins (which
    raised here until the mesh trainer was ported) are identities outside a
    mesh scope, and inside a scope of more than one rank a plain tensor
    raises; the training loss, MoE, MLA and leading dense layers run."""
    import types
    from repro_torch.dist.sharding import (
        DP, TP, activation_sharding, current_mesh, shard_activation)
    cfg = gemma3_27b.reduced()
    x = torch.zeros((2, 4, 8))
    assert current_mesh() is None and shard_activation(x, DP, TP, None) is x
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with activation_sharding(mesh) as m:
        assert m is mesh and current_mesh() is mesh
        with pytest.raises(TypeError, match="must be a DTensor"):
            shard_activation(x, DP, TP, None)
    assert current_mesh() is None
    model = init_transformer(cfg, device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    loss, _ = loss_fn(model, {"tokens": toks, "labels": toks}, cfg)
    hidden, _, _ = forward(model, toks, cfg)
    ce = chunked_ce_loss(model, hidden, toks, torch.ones((1, 4)), cfg)
    assert bool(torch.isfinite(loss)) and abs(float(loss) - float(ce)) < 1e-6
    for port in (qwen2_moe_a27b.reduced(), deepseek_v2_236b.reduced(),
                 dataclasses.replace(cfg, first_dense=2)):
        model = init_transformer(port, device="cpu")
        kinds = ["moe" if layer.moe is not None else "mlp" for layer in model.layers]
        assert kinds == ["mlp"] * port.first_dense + (
            ["moe" if port.is_moe else "mlp"] * (port.n_layers - port.first_dense))
        with torch.inference_mode():
            lg, _, _ = prefill(model, torch.zeros((1, 4), dtype=torch.long), port, 6)
        assert tuple(lg.shape) == (1, 1, port.vocab) and bool(torch.isfinite(lg).all())


def test_layer_inits_draw_what_they_store():
    g = torch.Generator().manual_seed(0)
    cfg = GQAConfig(d_model=32, n_heads=4, n_kv=2, d_head=8, qk_norm=True)
    attn = init_gqa(cfg, generator=g, device="cpu", dtype=torch.bfloat16)
    assert attn.wk.shape == (32, 2, 8) and attn.wk.dtype == torch.bfloat16
    assert attn.k_norm.dtype == torch.float32
    m = init_mlp(MLPConfig(d_model=32, d_ff=64, gated=False), generator=g, device="cpu")
    assert m.w_gate is None and m.w_up.shape == (32, 64)
    assert init_cache(gemma3_27b.reduced(), 2, 8, device="cpu").k.shape == (6, 2, 8, 2, 16)

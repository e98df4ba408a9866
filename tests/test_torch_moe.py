"""The port's MoE layer and MLA attention against the JAX package's.

Both get the same numpy weights and inputs; everything but the bf16 routing
case is f32, with one torch thread (small ops on many threads a worker
oversubscribe the cores). JAX's layers are jitted once a configuration.

Tolerances, each with its reason:
* MoE ``y``: ``rtol=1e-5, atol=1e-5`` (products in another order: a few f32
  ulp); ``aux_loss`` to 1e-6 (a mean over T and a sum over E, reordered);
* ``dropped_frac``: the number of dropped assignments equal (the fraction
  is ``1 - mean(keep)``, whose f32 rounding depends on the sum's order: JAX
  gives -7.5e-9 where nothing is dropped);
* bf16 routing: the top-k ids equal (the router runs in f32 in both), and
  ``y`` within 2e-2 (a bf16 ulp of O(1) values, the products' order);
* MLA: ``rtol=1e-5, atol=1e-5``, and the cache's untouched tail exactly 0.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import attention as jatt
from repro.layers import moe as jmoe
from repro_torch.configs import deepseek_v2_236b, qwen2_moe_a27b
from repro_torch.layers import (
    MLA, MLP, KVCache, MLAConfig, MoE, MoEConfig, init_mla, init_moe, mla_attention,
    mlp, moe_layer)
from repro_torch.layers.moe import dispatch_plan, route

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.array(x, np.float32)).to(dtype)


def port_moe(p: dict, dtype=torch.float32) -> MoE:
    """The reference's ``init_moe`` tree as the port's ``MoE``: the router
    in f32, the experts in ``dtype``."""
    shared = None
    if "shared" in p:
        sp = p["shared"]
        shared = MLP(_t(sp["w_up"], dtype), _t(sp["w_down"], dtype), _t(sp["w_gate"], dtype))
    return MoE(_t(p["router"]), *(_t(p[n], dtype) for n in ("w_gate", "w_up", "w_down")),
               shared)


def _dropped(frac, n_assign: int) -> int:
    return int(round(float(frac) * n_assign))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

MOE_CASES = {   # MoEConfig fields, (B, S), explicit capacity
    "drop-free": (dict(n_experts=8, top_k=2, d_expert=24, n_shared=2,
                       capacity_factor=8.0), (2, 9), None),
    "dropping": (dict(n_experts=8, top_k=2, d_expert=24, n_shared=2,
                      capacity_factor=1.0), (2, 9), None),
    "capacity-1": (dict(n_experts=8, top_k=3, d_expert=24, n_shared=1), (3, 5), 1),
    "e_alloc": (dict(n_experts=6, n_experts_alloc=8, top_k=2, d_expert=24,
                     n_shared=1, capacity_factor=0.5), (2, 9), None),
    "unnormalized": (dict(n_experts=8, top_k=2, d_expert=24, normalize_weights=False,
                          capacity_factor=1.0), (2, 9), None),
    # 3 groups of 2,049 tokens, the last holding 2 padding tokens (no shared
    # experts: the reference cannot add them to padded groups, ROADMAP.md §3)
    "groups-padding": (dict(n_experts=8, top_k=2, d_expert=8, n_groups=3,
                            capacity_factor=1.0), (1, 6145), None),
}


def _moe_pair(fields: dict, d: int, seed: int = 0):
    jcfg = jmoe.MoEConfig(d_model=d, **fields)
    cfg = MoEConfig(d_model=d, **fields)
    p = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(seed), jcfg))
    return jcfg, cfg, p


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_layer_matches_jax(case):
    fields, shape, capacity = MOE_CASES[case]
    d = 16 if case == "groups-padding" else 32
    jcfg, cfg, p = _moe_pair(fields, d)
    x = np.random.default_rng(1).standard_normal(shape + (d,)).astype(np.float32)
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_layer(p, x, jcfg, capacity=capacity))(p, x)
    y, aux = moe_layer(port_moe(p), _t(x), cfg, capacity=capacity)
    np.testing.assert_allclose(y.numpy(), _np(jy), **TOL)
    np.testing.assert_allclose(float(aux["aux_loss"]), float(jaux["aux_loss"]),
                               rtol=0, atol=1e-6)
    t = shape[0] * shape[1]
    groups, tg, c = dispatch_plan(t, cfg, capacity)
    n_assign = groups * tg * cfg.top_k
    assert _dropped(aux["dropped_frac"], n_assign) == _dropped(jaux["dropped_frac"], n_assign)
    dropped = _dropped(aux["dropped_frac"], n_assign)
    if case == "drop-free":
        assert dropped == 0
    else:
        assert dropped > 0, case          # each other case drops
    if case == "groups-padding":
        assert (groups, tg) == (3, 2049)
    if case == "e_alloc":   # the padding experts' rows receive no tokens
        assert tuple(port_moe(p).w_gate.shape) == (8, d, 24)


def test_moe_shared_experts_on_padded_groups():
    """With shared experts and padded groups the reference fails on a shape
    mismatch (its shared MLP runs on the padded tokens); the port runs the
    shared experts on the real tokens: the routed part equals the same
    layer's without shared experts, which matches JAX."""
    fields = dict(n_experts=8, top_k=2, d_expert=8, n_groups=3, capacity_factor=1.0)
    jcfg, cfg, p = _moe_pair(dict(fields, n_shared=2), 16)
    x = np.random.default_rng(2).standard_normal((1, 6145, 16)).astype(np.float32)
    with pytest.raises(TypeError, match="broadcast"):
        jax.eval_shape(lambda p, x: jmoe.moe_layer(p, x, jcfg), p, x)
    routed = {k: v for k, v in p.items() if k != "shared"}
    jy, _ = jax.jit(lambda p, x: jmoe.moe_layer(p, x, dataclasses.replace(jcfg, n_shared=0)))(
        routed, x)
    port = port_moe(p)
    y, _ = moe_layer(port, _t(x), cfg)
    shared = mlp(port.shared, _t(x), cfg.shared_cfg())
    np.testing.assert_allclose((y - shared).numpy(), _np(jy), rtol=1e-5, atol=2e-5)


def test_moe_bf16_routing_matches_jax():
    """The same bf16 x through both packages: the router runs in f32 in
    both, so the top-k ids and the drops are equal; the port stores its
    router in f32 whatever the experts' dtype."""
    fields = dict(n_experts=8, top_k=2, d_expert=24, n_shared=2, capacity_factor=1.0)
    jcfg, cfg, p = _moe_pair(fields, 32)
    x32 = np.random.default_rng(3).standard_normal((2, 24, 32)).astype(np.float32)
    xb = jnp.asarray(x32, jnp.bfloat16)
    x = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    assert np.array_equal(x.float().numpy(), np.asarray(xb.astype(jnp.float32)))
    port = port_moe(p, torch.bfloat16)
    assert port.router.dtype == torch.float32 and port.w_up.dtype == torch.bfloat16
    init = init_moe(cfg, device="cpu", dtype=torch.bfloat16)
    assert init.router.dtype == torch.float32 and init.w_down.dtype == torch.bfloat16
    assert init.shared.w_gate.dtype == torch.bfloat16

    def jroute(router, xb):
        probs = jax.nn.softmax(xb.reshape(-1, 32).astype(jnp.float32) @ router, axis=-1)
        return jax.lax.top_k(probs, 2)[1]
    _, _, top_i = route(port, x.reshape(-1, 32), cfg)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(jax.jit(jroute)(p["router"], xb)))
    jy, jaux = jax.jit(lambda p, x: jmoe.moe_layer(p, x, jcfg))(p, xb)
    y, aux = moe_layer(port, x, cfg)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    n_assign = 48 * 2
    assert _dropped(aux["dropped_frac"], n_assign) == _dropped(jaux["dropped_frac"], n_assign) > 0
    np.testing.assert_allclose(y.float().numpy(), _np(jy.astype(jnp.float32)),
                               rtol=2e-2, atol=2e-2)


def test_position_in_run_and_dispatch_plan():
    from repro_torch.layers.moe import _position_in_run
    e = torch.tensor([[0, 0, 0, 2, 2, 5, 7, 7, 7, 7], [1, 1, 1, 1, 1, 1, 1, 1, 3, 3]])
    got = _position_in_run(e)
    want = jmoe._position_in_run(jnp.asarray(e[0].numpy()))
    assert got[0].tolist() == np.asarray(want).tolist() == [0, 1, 2, 0, 1, 0, 0, 1, 2, 3]
    assert got[1].tolist() == [0, 1, 2, 3, 4, 5, 6, 7, 0, 1]
    # the full-width plans: qwen2-moe's prefill of 4 x 4,096 tokens runs 8
    # groups of 2,048 at capacity 171, deepseek-v2's of 4 x 1,024 two groups
    # at 97; a decode step of 4 tokens one group at capacity 1 (it drops)
    qwen = qwen2_moe_a27b.ARCH.model_cfg.moe_cfg()
    deep = deepseek_v2_236b.ARCH.model_cfg.moe_cfg()
    assert dispatch_plan(16_384, qwen) == (8, 2048, 171)
    assert dispatch_plan(4, qwen) == (1, 4, 1)
    assert dispatch_plan(4096, deep) == (2, 2048, 97)
    assert dispatch_plan(4, deep) == (1, 4, 1)
    assert dispatch_plan(4096, qwen) == (2, 2048, 171)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_pair(kv_chunk=0):
    fields = dict(d_model=32, n_heads=4, q_lora=16, kv_lora=8, qk_nope_dim=8,
                  qk_rope_dim=4, v_head_dim=6, kv_chunk=kv_chunk)
    jcfg, cfg = jatt.MLAConfig(**fields), MLAConfig(**fields)
    p = jax.tree.map(np.asarray, jatt.init_mla(jax.random.PRNGKey(3), jcfg))
    rng = np.random.default_rng(4)   # latent norm scales other than the init's ones
    p = dict(p, q_norm=1 + 0.1 * rng.standard_normal(16).astype(np.float32),
             kv_norm=1 + 0.1 * rng.standard_normal(8).astype(np.float32))
    return jcfg, cfg, p, MLA(**{n: _t(v) for n, v in p.items()})


@pytest.mark.parametrize("kv_chunk", [0, 4])
def test_mla_attention_matches_jax(kv_chunk):
    """Without a cache (positions from 3), then with one: a prompt of 11
    and one decode token, the cache 16 long (with kv_chunk 4 the prompt
    takes the chunked online-softmax branch, 16 > 2 x 4)."""
    jcfg, cfg, p, port = _mla_pair(kv_chunk)
    jmla = jax.jit(lambda p, x, pos, cache, cache_pos, kvv: jatt.mla_attention(
        p, x, jcfg, positions=pos, rope_theta=1e4, window=0, cache=cache,
        cache_pos=cache_pos, kv_valid_len=kvv))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, 32)).astype(np.float32)
    pos = np.broadcast_to(3 + np.arange(11)[None], (2, 11)).astype(np.int32)
    want, _ = jmla(p, x, pos, None, None, None)
    got, none = mla_attention(port, _t(x), cfg, q_offset=3, rope_theta=1e4, window=0)
    assert none is None
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)

    jc = jatt.KVCache(k=jnp.zeros((2, 16, 8)), v=jnp.zeros((2, 16, 4)))
    pc = KVCache(k=torch.zeros((2, 16, 8)), v=torch.zeros((2, 16, 4)))
    pos0 = np.broadcast_to(np.arange(11)[None], (2, 11)).astype(np.int32)
    want, jc = jmla(p, x, pos0, jc, 0, 11)
    got, pc2 = mla_attention(port, _t(x), cfg, q_offset=0, rope_theta=1e4, window=0,
                             cache=pc, kv_valid_len=11)
    assert pc2 is pc                              # updated in place
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert not pc.k[:, 11:].any() and not pc.v[:, 11:].any()   # the tail untouched
    assert pc.k[:, :11].abs().sum() > 0
    x1 = rng.standard_normal((2, 1, 32)).astype(np.float32)
    want, jc = jmla(p, x1, np.full((2, 1), 11, np.int32), jc, 11, 12)
    got, pc = mla_attention(port, _t(x1), cfg, q_offset=11, rope_theta=1e4, window=0,
                            cache=pc, kv_valid_len=12)
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    np.testing.assert_allclose(pc.k.numpy(), _np(jc.k), **TOL)
    np.testing.assert_allclose(pc.v.numpy(), _np(jc.v), **TOL)
    assert not pc.k[:, 12:].any()


def test_mla_init_draws_what_it_stores():
    cfg = MLAConfig(d_model=32, n_heads=4, q_lora=16, kv_lora=8, qk_nope_dim=8,
                    qk_rope_dim=4, v_head_dim=6)
    m = init_mla(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                 dtype=torch.bfloat16)
    jshapes = jax.eval_shape(lambda: jatt.init_mla(jax.random.PRNGKey(0), jatt.MLAConfig(
        d_model=32, n_heads=4, q_lora=16, kv_lora=8, qk_nope_dim=8, qk_rope_dim=4,
        v_head_dim=6)))
    for name, leaf in jshapes.items():
        assert tuple(getattr(m, name).shape) == leaf.shape, name
        want = torch.float32 if name.endswith("_norm") else torch.bfloat16
        assert getattr(m, name).dtype == want, name
    assert torch.equal(m.kv_norm, torch.ones(8))
    sigma = 32 ** -0.5
    assert float(m.w_dkv.float().abs().max()) <= 3 * sigma * 1.01


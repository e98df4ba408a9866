"""The port's flash attention against the JAX package's.

The port's plain version (``flash_attention_ref``) and its dispatcher
(``ops.flash_attention``, which takes a CPU tensor to the plain version)
are held to JAX's Pallas kernel (interpret mode, 32-row and 32-key blocks)
and to JAX's ``flash_attention_ref`` on the same numpy inputs, at the
shapes of ``tests/test_kernels.py`` and at the GQA groups of the port's LM
configurations (2, 5 and 9), at decode (Sq = 1, G rows) and in bf16.
Tolerances are the JAX tests': 2e-4 in f32 (the two frameworks sum the
dot products in different orders, and the kernel scales q before the
product where the plain versions scale the logits), 5e-2 in bf16.

The port's plain ``sdpa`` is held to JAX's in both branches (unchunked and
KV-chunked) with (B, S) positions and ``kv_valid_len`` (2e-5, as
``tests/test_attention_chunked.py``), and the port's layer core (the
flash-attention function on the (B, H, S, dh) views, keys sliced to
``kv_valid_len``) to JAX's ``sdpa`` masking the same tail.

A row that sees no key: the port returns 0 there (its docstring says why);
JAX's plain version returns the mean of all Skv value rows.

The decode kernel's split plan (``ops.visible_key_range``,
``decode_splits``, ``split_bounds``: plain Python on the host) is held to
the plain version's mask and to covering the visible keys exactly once.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flashattn import flash_attention as jax_flash
from repro.kernels.flashattn import flash_attention_ref as jax_flash_ref
from repro.layers.attention import sdpa as jax_sdpa
from repro_torch.kernels.flashattn import (
    flash_attention, flash_attention_cuda, flash_attention_ref)
from repro_torch.kernels.flashattn import ops as flash_ops
from repro_torch.kernels.flashattn.ops import (
    SPLIT_BLOCKS, SPLIT_MIN_KEYS, decode_splits, split_bounds, visible_key_range)
from repro_torch.kernels.flashattn.ref import visible_mask
from repro_torch.layers.attention import sdpa

TOL = dict(rtol=2e-4, atol=2e-4)

CASES = [
    # the five cases of tests/test_kernels.py
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, 0),
    (1, 8, 2, 37, 37, 16, True, 0, 50.0, 0),      # softcap, ragged len
    (1, 4, 4, 16, 128, 32, True, 64, 0.0, 112),   # decode w/ window+offset
    (2, 2, 1, 33, 65, 64, False, 0, 0.0, 0),      # non-causal MQA
    (1, 6, 3, 128, 128, 64, True, 32, 30.0, 0),   # window + softcap
    # the port's LM groups: qwen3's 5 and starcoder2's 9
    (1, 10, 2, 24, 40, 16, True, 0, 0.0, 16),
    (1, 9, 1, 20, 33, 32, True, 8, 0.0, 13),
    # decode: one position, the G heads of a kv head as rows (gemma3's G=2)
    (2, 8, 4, 1, 50, 128, True, 16, 0.0, 49),
    (1, 9, 1, 1, 70, 32, True, 0, 0.0, 69),
]


def _qkv(b, hq, hkv, sq, skv, dh, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, dh)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, dh)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,hq,hkv,sq,skv,dh,causal,window,cap,qoff", CASES)
def test_flash_matches_jax(b, hq, hkv, sq, skv, dh, causal, window, cap, qoff,
                           monkeypatch):
    """On CPU tensors ``ops.flash_attention`` is one call of the plain
    version with the same arguments, whose result it returns as it is: a
    spy holds that. (Two separate CPU calls need not agree to the bit: the
    CPU GEMM library does not promise run-to-run reproducibility, and under
    a loaded host two calls once differed by 7.8e-5.)"""
    q, k, v = _qkv(b, hq, hkv, sq, skv, dh)
    kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
    want_pallas = np.asarray(jax_flash(q, k, v, **kw, block_q=32, block_k=32,
                                       interpret=True))
    want_ref = np.asarray(jax_flash_ref(q, k, v, **kw))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs, flash_attention_ref(*args, **kwargs)))
        return calls[-1][2]

    monkeypatch.setattr(flash_ops, "flash_attention_ref", spy)
    got_ops = flash_attention(tq, tk, tv, **kw)
    (args, kwargs, out), = calls              # CPU: the plain version, once
    assert all(a is b for a, b in zip(args, (tq, tk, tv))) and len(args) == 3
    assert kwargs == dict(kw, scale=None) and got_ops is out
    got_ref = flash_attention_ref(tq, tk, tv, **kw).numpy()
    np.testing.assert_allclose(got_ref, want_ref, **TOL)
    np.testing.assert_allclose(got_ref, want_pallas, **TOL)
    np.testing.assert_allclose(got_ops.numpy(), want_ref, **TOL)


def test_flash_bf16_matches_jax():
    q, k, v = _qkv(1, 4, 2, 64, 64, 32, seed=1)
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jax_flash(q, k, v, block_q=32, block_k=32, interpret=True),
                      np.float32)
    want_ref = np.asarray(jax_flash_ref(q, k, v), np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = flash_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2, atol=5e-2)
    np.testing.assert_allclose(got.float().numpy(), want_ref, rtol=5e-2, atol=5e-2)


def test_flash_reads_strided_views():
    """The model's (B, S, H, dh) tensors seen as (B, H, S, dh): the same
    result as contiguous inputs."""
    q, k, v = _qkv(2, 4, 2, 9, 13, 16, seed=2)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    views = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (tq, tk, tv)]
    assert not views[0].is_contiguous()
    kw = dict(causal=True, window=5, q_offset=4)
    np.testing.assert_array_equal(flash_attention(*views, **kw).numpy(),
                                  flash_attention(tq, tk, tv, **kw).numpy())


def test_rows_that_see_no_key():
    """Causal, window 4, rows at positions 14..21 over 16 keys: rows 14..18
    see keys, rows 19..21 see none (their window starts past the last key).
    Rows with keys agree with JAX; the others are 0 in the port and the
    mean of all value rows in JAX's plain version."""
    q, k, v = _qkv(1, 2, 1, 8, 16, 16, seed=3)
    kw = dict(causal=True, window=4, q_offset=14)
    got = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)), **kw).numpy()
    want = np.asarray(jax_flash_ref(q, k, v, **kw))
    seen = slice(0, 5)
    np.testing.assert_allclose(got[:, :, seen], want[:, :, seen], **TOL)
    assert not got[:, :, 5:].any()
    mean_v = np.repeat(v, 2, axis=1).mean(axis=2, keepdims=True)
    np.testing.assert_allclose(want[:, :, 5:], np.broadcast_to(mean_v, want[:, :, 5:].shape),
                               rtol=1e-5, atol=1e-5)
    # a q_offset past every key under causality: the whole output is 0
    far = flash_attention_ref(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, window=4, q_offset=40)
    assert not far.any()


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 1, 4, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q, k, v)


@pytest.mark.parametrize("win,cap,kvv", [
    (0, 0.0, None),
    (16, 20.0, 48),
    (0, 0.0, 40),
    (7, 0.0, None),
])
@pytest.mark.parametrize("kv_chunk", [0, 8])
def test_sdpa_matches_jax(win, cap, kvv, kv_chunk):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 12, 6, 16)).astype(np.float32)
    k = rng.standard_normal((2, 48, 3, 16)).astype(np.float32)
    v = rng.standard_normal((2, 48, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(36 + np.arange(12)[None], (2, 12)).astype(np.int32)
    kw = dict(causal=True, window=win, softcap=cap, scale=0.25, kv_chunk=kv_chunk)
    want = np.asarray(jax_sdpa(q, k, v, q_positions=pos,
                               kv_valid_len=None if kvv is None else jnp.asarray(kvv),
                               **kw))
    got = sdpa(*(torch.from_numpy(x) for x in (q, k, v)),
               q_positions=torch.from_numpy(pos), kv_valid_len=kvv, **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    # the port's layer core: flash attention on the (B, H, S, dh) views,
    # keys sliced to kv_valid_len, rows at q_offset = 36
    t = 48 if kvv is None else kvv
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k[:, :t], v[:, :t]))
    core = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2), tv.transpose(1, 2),
                           causal=True, window=win, softcap=cap, q_offset=36,
                           scale=0.25).transpose(1, 2).numpy()
    np.testing.assert_allclose(core, want, **TOL)


# --- the decode kernel's split plan (ops.py, host side) ----------------------

SKVS = sorted(set(range(1, 8193, 37)) | {1, 2, 255, 256, 257, 511, 512, 513, 1023,
                                          1024, 1025, 4096, 4097, 8191, 8192})


@pytest.mark.parametrize("bh", [1, 2, 16, 64, 100, 132, 256])
@pytest.mark.parametrize("window,sq", [(0, 1), (1024, 1), (24, 1), (0, 8), (100, 3)])
def test_decode_split_plan_covers_the_visible_keys(bh, window, sq):
    """For a decode step at the end of the cache (q_offset = Skv - Sq,
    causal), the visible range equals the keys some row of the plain
    version's mask sees, and the splits cover it exactly once: no gap, no
    overlap, every split non-empty, at least one split; more than one only
    when each keeps SPLIT_MIN_KEYS keys, and no more than the card needs
    (a power of two at or above SPLIT_BLOCKS / (B * Hkv))."""
    for skv in SKVS:
        if skv < sq:
            continue
        kw = dict(causal=True, window=window, q_offset=skv - sq)
        lo, hi = visible_key_range(sq, skv, **kw)
        seen = torch.nonzero(visible_mask(sq, skv, device="cpu", **kw).any(0)).flatten()
        assert (lo, hi) == (int(seen[0]), int(seen[-1]) + 1)
        splits = decode_splits(hi - lo, bh)
        bounds = split_bounds(lo, hi, splits)
        assert len(bounds) == splits >= 1
        assert bounds[0][0] == lo and bounds[-1][1] == hi
        assert all(a < b for a, b in bounds)                          # non-empty
        assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))   # no gap, no overlap
        if splits > 1:
            assert min(b - a for a, b in bounds) >= SPLIT_MIN_KEYS
        want = 1
        while want * bh < SPLIT_BLOCKS:
            want *= 2
        assert splits == min(max(1, (hi - lo) // SPLIT_MIN_KEYS), want)


def test_decode_split_plan_at_the_served_shapes():
    """gemma3-27b at B=4 (64 (b, kv head) pairs), one step past a 4,096-token
    prompt: 8 splits of 512 keys on a global layer, 4 of 256 on a local
    layer (window 1,024)."""
    lo, hi = visible_key_range(1, 4097, causal=True, window=0, q_offset=4096)
    assert decode_splits(hi - lo, 64) == 8
    assert [b - a for a, b in split_bounds(lo, hi, 8)] == [512] * 7 + [513]
    lo, hi = visible_key_range(1, 4097, causal=True, window=1024, q_offset=4096)
    assert (lo, hi) == (3073, 4097) and decode_splits(hi - lo, 64) == 4
    assert [b - a for a, b in split_bounds(lo, hi, 4)] == [256] * 4


def test_visible_key_range_without_keys():
    """A window that ends before every key: an empty range, one split that
    sweeps nothing."""
    lo, hi = visible_key_range(8, 16, causal=True, window=4, q_offset=40)
    assert hi <= lo
    assert decode_splits(hi - lo, 64) == 1
    assert all(a >= b for a, b in split_bounds(lo, hi, 1))

"""The reference's public names in the port, and the small ones held to it.

* ``tests/api_snapshot.json`` (the reference's pinned surface of ``core``,
  ``serve``, ``live`` and ``fault``) walked over the port: every name
  exists with the same kind and, for classes and functions, the same
  parameter names in the same order. The port may add keyword parameters,
  only those ``ADDED_KEYWORDS`` names, each a departure ROADMAP.md §3
  records; ``random_regular`` keeps the reference's names, its ``key`` a
  seed or a ``torch.Generator`` where the reference takes a JAX key.
* Every public name of ``utils``, ``layers.common``, ``core.graph``,
  ``analysis`` (with ``hlo`` and ``roofline``), ``launch.mesh``,
  ``launch.steps``, ``launch.dryrun``, ``dist`` (with ``sharding``) and
  ``train`` (with ``trainer``), less the names ``ABSENT`` gives a reason
  for (``fusion_count``); ``dist.compat`` has no counterpart module, with
  its reason.
* The new ``utils`` and ``layers.common`` functions against the
  reference's on the same numpy inputs; ``core.graph.from_lists`` equal to
  the reference's, ``random_regular`` by its properties; the single-query
  ``core.beam_search`` against JAX's on ``tests/test_torch_search.py``'s
  rig, every ``BeamState`` field (ids, flags and counters equal,
  distances ``allclose(rtol=1e-5, atol=1e-6)``); ``build_knn_graph``'s
  ``mutual``, taken and ignored as the reference does.
"""
import dataclasses
import importlib
import inspect
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.layers.common as jcommon
import repro.utils as jutils
from repro.core import beam_search as jax_beam_search
from repro.models import gcn as jgcn
from repro.models import recsys as jrec
from repro.models import transformer as jtf
from repro_torch.configs import autoint, gcn_cora, qwen2_moe_a27b, two_tower_retrieval
from repro_torch.core import Graph, beam_search, build_knn_graph, from_lists, random_regular
from repro_torch.layers import common
from repro_torch.models import init_gcn, init_recsys, init_transformer, recsys_tree
from repro_torch.models.transformer import transformer_tree
from repro_torch import utils
from test_torch_search import _assert_state_equal, _cfgs, _rig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SNAPSHOT = os.path.join(ROOT, "tests", "api_snapshot.json")

# keyword parameters the port adds to a reference signature (ROADMAP.md §3)
ADDED_KEYWORDS = {
    "device": "entry points take the device they run on, 'cuda' by default",
    "use_kernel": "gather_dist: the plain version on demand",
    "use_kernels": "SearchConfig: the whole search on its plain versions",
    "timings": "insert_batch_step: the build's time split",
    "block": "build_knn_graph: the corpus block of its exact top-k",
    "query_block": "exact_topk, build_knn_graph: its query block",
}
# names of the reference with no counterpart in the port, each with its
# reason (ROADMAP.md §3)
NO_FUSIONS = "eager PyTorch runs no fusion pass, so there are no fusions to count"
ABSENT = {"repro.analysis": {"fusion_count": NO_FUSIONS},
          "repro.analysis.hlo": {"fusion_count": NO_FUSIONS}}
ABSENT_MODULES = {"repro.dist.compat": "it bridges shard_map's move between jax versions; "
                                       "torch's device-mesh and collective API has no such "
                                       "split"}
SURFACE = ("repro.utils", "repro.layers.common", "repro.core.graph", "repro.analysis",
           "repro.analysis.roofline", "repro.analysis.hlo", "repro.launch.mesh",
           "repro.launch.steps", "repro.launch.dryrun", "repro.dist", "repro.dist.sharding",
           "repro.train", "repro.train.trainer")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only spin,
    and under the parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _top_level_split(body: str) -> list:
    """``body`` split at its commas outside brackets and quotes."""
    parts, depth, quote, cur = [], 0, None, ""
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    return parts + [cur]


def _param_names(sig: str) -> list:
    """Parameter names of a signature as ``str(inspect.signature)`` prints
    it (the snapshot's form; its defaults are reprs, not code)."""
    depth, quote = 0, None
    for end, ch in enumerate(sig):
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "([{<":
            depth += 1
        elif ch in ")]}>":
            depth -= 1
            if depth == 0:
                break
    names = []
    for part in _top_level_split(sig[1:end]):
        m = re.match(r"\s*\**(\w+)", part)
        if m:
            names.append(m.group(1))
    return names


def _kind(obj) -> str:
    if inspect.isclass(obj):
        return "class"
    return "function" if callable(obj) else type(obj).__name__


def test_param_names_parser():
    assert _param_names("(a, b: 'int' = f(1, 2), *, c=<factory>, **kw) -> 'X'") == \
        ["a", "b", "c", "kw"]
    assert _param_names("(clock: 'Callable[[], float]' = <built-in function monotonic>, "
                        "d='a,b', /, e=(1, 2)) -> None") == ["clock", "d", "e"]


@pytest.mark.parametrize("module", ["repro.core", "repro.serve", "repro.live",
                                    "repro.fault"])
def test_api_snapshot_names_exist_in_port(module):
    want = json.load(open(SNAPSHOT))[module]
    port = importlib.import_module("repro_torch" + module[len("repro"):])
    problems = []
    for name, desc in want.items():
        if not hasattr(port, name):
            problems.append(f"{name}: missing")
            continue
        obj = getattr(port, name)
        if _kind(obj) != desc["kind"]:
            problems.append(f"{name}: a {_kind(obj)}, the reference's a {desc['kind']}")
            continue
        if desc["kind"] not in ("class", "function") or desc.get("signature") is None:
            continue
        ref = _param_names(desc["signature"])
        got = list(inspect.signature(obj).parameters)
        kept = [p for p in got if p in ref or p not in ADDED_KEYWORDS]
        if kept != ref:
            problems.append(f"{name}: parameters {got}, the reference's {ref}")
        for p in set(got) - set(ref):
            if inspect.signature(obj).parameters[p].default is inspect.Parameter.empty:
                problems.append(f"{name}: the added {p} has no default")
    assert not problems, "\n".join(problems)


def _public(mod) -> set:
    """A module's public names, less the modules it imports (but the
    analysis package's own submodules)."""
    names = getattr(mod, "__all__", None) or dir(mod)
    return {n for n in names if not n.startswith("_")
            and not (inspect.ismodule(getattr(mod, n)) and n not in ("roofline", "hlo"))}


def _own(mod, name: str) -> bool:
    """Whether ``name`` is the reference module's surface: what it defines
    or re-exports from its package, not its imports of jax, numpy or
    typing."""
    obj = getattr(mod, name)
    return not callable(obj) or str(getattr(obj, "__module__", None) or "repro").startswith(
        "repro")


def _import_reference(module: str):
    """The reference module; its dry run sets ``XLA_FLAGS`` when imported,
    which is put back so no later subprocess inherits it."""
    flags = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(module)
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


@pytest.mark.parametrize("module", SURFACE)
def test_module_names_exist_in_port(module):
    ref = _import_reference(module)
    port = importlib.import_module("repro_torch" + module[len("repro"):])
    want = {n for n in _public(ref) if _own(ref, n)}
    absent = ABSENT.get(module, {})
    missing = sorted(want - set(absent) - _public(port))
    assert not missing, missing
    assert not set(absent) & _public(port), "a recorded absence exists after all"


@pytest.mark.parametrize("module", sorted(ABSENT_MODULES))
def test_modules_without_a_counterpart(module):
    importlib.import_module(module)
    with pytest.raises(ModuleNotFoundError):
        importlib.import_module("repro_torch" + module[len("repro"):])


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_utils_scalars_and_padding():
    assert utils.INF == jutils.INF and utils.INF == np.inf
    for a, b in [(0, 8), (1, 8), (8, 8), (9, 8), (1000, 128)]:
        assert utils.round_up(a, b) == jutils.round_up(a, b)
    x = np.arange(12, dtype=np.int32).reshape(3, 4)
    for target, fill in [(3, 0), (5, -1), (8, utils.INVALID_ID)]:
        got = utils.pad_rows(torch.from_numpy(x), target, fill)
        np.testing.assert_array_equal(got.numpy(), jutils.pad_rows(x, target, fill))
        assert got.dtype == torch.int32


def test_tree_bytes_and_count_match_reference():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 5)).astype(np.float32),
            "b": [np.zeros(7, np.int8), {"c": np.ones((2, 2), np.float16)}]}
    ported = {"a": torch.from_numpy(tree["a"]).to(torch.bfloat16),
              "b": [torch.from_numpy(tree["b"][0]), {"c": torch.from_numpy(tree["b"][1]["c"])}]}
    assert utils.tree_count(ported) == jutils.tree_count(tree) == 15 + 7 + 4
    jtree = dict(tree, a=jnp.asarray(tree["a"], jnp.bfloat16))
    assert utils.tree_bytes(ported) == jutils.tree_bytes(jtree) == 30 + 7 + 8
    # a meta tensor counts the bytes it stands for; dataclass fields count
    meta = torch.empty((1 << 20, 128), device="meta")
    assert utils.tree_bytes({"x": meta}) == 4 << 27
    from repro_torch.layers import KVCache
    assert utils.tree_count(KVCache(k=torch.zeros(2, 3), v=torch.zeros(4))) == 10


def test_block_until_ready_and_timeit():
    tree = {"a": torch.ones(3), "n": 4}
    assert utils.block_until_ready(tree) is tree
    calls = []
    sec = utils.timeit(lambda: calls.append(1) or torch.ones(2), warmup=2, iters=5)
    assert len(calls) == 7 and sec >= 0.0


@pytest.mark.parametrize("axis", [-1, 0])
def test_masked_min_matches_reference(axis):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 5, (6, 9)).astype(np.float32)    # ties
    mask = rng.random((6, 9)) < 0.4
    mask[2] = False
    mask[:, 3] = False
    jv, ji = jutils.masked_min(jnp.asarray(x), jnp.asarray(mask), axis=axis)
    tv, ti = utils.masked_min(torch.from_numpy(x), torch.from_numpy(mask), axis=axis)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("p", [0.0, 0.3, 1.0])
def test_stable_compact_indices_match_reference(p):
    active = np.random.default_rng(2).random(37) < p
    want = jutils.stable_compact_indices(jnp.asarray(active))
    got = utils.stable_compact_indices(torch.from_numpy(active))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# layers.common
# ---------------------------------------------------------------------------

def _reference_trees():
    """(name, the port's meta tree, the reference's eval_shape tree) of the
    reference-shaped trees the port builds: the LM (reduced qwen2-moe, its
    MoE, shared experts and leading dense layer), two-tower, AutoInt, GCN."""
    from repro.configs import autoint as jai
    from repro.configs import gcn_cora as jgc
    from repro.configs import qwen2_moe_a27b as jqm
    from repro.configs import two_tower_retrieval as jtt
    key = jax.random.PRNGKey(0)
    lm, jlm = qwen2_moe_a27b.reduced(), jqm.reduced()
    out = [("lm", transformer_tree(init_transformer(lm, device="meta"), lm),
            jax.eval_shape(lambda: jtf.init_transformer(key, jlm)))]
    for name, mod, jmod in (("two_tower", two_tower_retrieval, jtt), ("autoint", autoint, jai)):
        out.append((name, recsys_tree(init_recsys(mod.reduced(), device="meta")),
                    jax.eval_shape(lambda c=jmod.reduced(): jrec.init_recsys(key, c))))
    out.append(("gcn", init_gcn(gcn_cora.reduced(), device="meta"),
                jax.eval_shape(lambda: jgcn.init_gcn(key, jgc.reduced()))))
    return out


def test_flatten_paths_and_param_count_match_reference():
    for name, tree, jtree in _reference_trees():
        got, want = common.flatten_paths(tree), jcommon.flatten_paths(jtree)
        # JAX's tree functions return dicts in sorted key order; the port's
        # trees keep their build order
        assert sorted(got) == sorted(want), name
        assert {p: tuple(x.shape) for p, x in got.items()} == \
            {p: tuple(x.shape) for p, x in want.items()}, name
        assert common.param_count(tree) == jcommon.param_count(jtree), name
    lm = dict((n, t) for n, t, _ in _reference_trees())["lm"]
    assert any("/moe/shared/" in p for p in common.flatten_paths(lm))


def test_cast_tree_matches_reference():
    tree = {"w": np.ones((2, 3), np.float32), "ids": np.arange(4, dtype=np.int32),
            "n": [np.zeros(2, np.float32)]}
    want = jcommon.cast_tree(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    got = common.cast_tree(jax.tree.map(torch.from_numpy, tree), torch.bfloat16)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, got)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, want))
    flat_got, flat_want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert [str(x.dtype).replace("torch.", "") for x in flat_got] == \
        [str(x.dtype) for x in flat_want]
    meta = common.cast_tree({"x": torch.empty(3, device="meta")}, torch.bfloat16)["x"]
    assert meta.is_meta and meta.dtype == torch.bfloat16


def test_split_keys_are_deterministic_seeds():
    a, b = list(common.split_keys(0, 5)), list(common.split_keys(0, 5))
    assert a == b and len(set(a)) == 5 and list(common.split_keys(1, 5)) != a
    assert all(isinstance(s, int) and 0 <= s < 2**63 for s in a)
    # each seed is what the port's init functions take
    w = [init_gcn(gcn_cora.reduced(), seed=s, device="cpu")["w0"] for s in a[:2]]
    assert not torch.equal(w[0], w[1])


# ---------------------------------------------------------------------------
# core
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_degree", [None, 5])
def test_from_lists_matches_reference(max_degree):
    lists = [[1, 2], [], [0, 1, 3], [2]]
    got = from_lists(lists, max_degree, device="cpu")
    want = J.from_lists(lists, max_degree)
    np.testing.assert_array_equal(got.neighbors.numpy(), np.asarray(want.neighbors))
    assert got.neighbors.dtype == torch.int32
    with pytest.raises(ValueError, match="degree"):
        from_lists([[1, 2, 3]], 2, device="cpu")


def test_random_regular_properties():
    g = random_regular(3, 500, 8, device="cpu")
    nb = g.neighbors
    assert isinstance(g, Graph) and tuple(nb.shape) == (500, 8) and nb.dtype == torch.int32
    assert int(nb.min()) >= 0 and int(nb.max()) < 500
    assert not (nb == torch.arange(500, dtype=torch.int32)[:, None]).any()
    assert torch.equal(random_regular(3, 500, 8, device="cpu").neighbors, nb)
    assert not torch.equal(random_regular(4, 500, 8, device="cpu").neighbors, nb)
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(random_regular(gen, 500, 8).neighbors, nb)


@pytest.mark.parametrize("e", [1, 4])
def test_single_query_beam_search_matches_jax(e):
    jeng, teng, qs, radii = _rig("l2")
    jcfg, tcfg = _cfgs("l2", e)
    for lane in (0, 7, 19):
        jst = jax_beam_search(jeng.points, jeng.graph, jnp.asarray(qs[lane]),
                              jeng.start_ids, jnp.float32(radii[lane]), jcfg)
        tst = beam_search(teng.points, teng.graph, torch.from_numpy(qs[lane]),
                          teng.start_ids, float(radii[lane]), tcfg)
        assert tst.ids.dim() == 1 and tst.n_visited.dim() == 0
        _assert_state_equal(jst, tst)


def test_build_knn_graph_takes_mutual():
    pts = np.random.default_rng(3).standard_normal((300, 8)).astype(np.float32)
    a = build_knn_graph(pts, k=6, device="cpu")
    b = build_knn_graph(pts, k=6, mutual=True, device="cpu")
    assert torch.equal(a.neighbors, b.neighbors)
    assert dataclasses.is_dataclass(b)

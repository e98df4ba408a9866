"""Import hygiene and device rules of the PyTorch port.

* ``repro_torch`` imports torch, numpy and the standard library only: not
  JAX, and no module of the JAX package ``repro``.
* Its entry points run on the card by default and raise where there is
  none, rather than running on the CPU unasked.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad, " ".join(names))
"""

# modules each slice added, imported here by name so that a rename shows
NAMED = ("repro_torch.core.labels", "repro_torch.core.build",
         "repro_torch.configs.range_engine", "repro_torch.tier",
         "repro_torch.tier.budget", "repro_torch.tier.cache",
         "repro_torch.tier.corpus", "repro_torch.tier.planner",
         "repro_torch.tier.store", "repro_torch.fault", "repro_torch.fault.errors",
         "repro_torch.optim", "repro_torch.optim.adamw", "repro_torch.models.effort",
         "repro_torch.serve", "repro_torch.serve.latency", "repro_torch.serve.scheduler",
         "repro_torch.serve.server", "repro_torch.live", "repro_torch.live.index",
         "repro_torch.live.consolidate", "repro_torch.fault.wal", "repro_torch.train",
         "repro_torch.train.checkpoint", "repro_torch.dist", "repro_torch.dist.sharding",
         "repro_torch.dist.sharded_engine", "repro_torch.dist.collective_matmul",
         "repro_torch.dist.embedding", "repro_torch.dist.compression",
         "repro_torch.fault.injector", "repro_torch.fault.degraded",
         "repro_torch.fault.replica", "repro_torch.live.sharded", "repro_torch.launch",
         "repro_torch.launch.serve", "repro_torch.layers.moe",
         "repro_torch.configs.qwen2_moe_a27b", "repro_torch.configs.deepseek_v2_236b",
         "repro_torch.configs.qwen3_14b", "repro_torch.configs.starcoder2_7b",
         "repro_torch.train.trainer", "repro_torch.launch.train", "repro_torch.models.gcn",
         "repro_torch.layers.segment", "repro_torch.layers.interactions",
         "repro_torch.data.graphs", "repro_torch.data.recsys", "repro_torch.configs.wide_deep",
         "repro_torch.configs.dlrm_rm2", "repro_torch.configs.autoint",
         "repro_torch.configs.gcn_cora")


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad, names = out.stdout.split(" ", 2)
    assert int(n_modules) >= 50
    assert bad.strip() == "[]"
    assert set(NAMED) <= set(names.split())


def _imported_modules(path: str) -> set:
    """Every module an ``import`` statement of the file names, at any depth
    (the port and chip_smoke.py import torch and the port's own modules
    inside functions too)."""
    import ast
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_no_import_statement_names_jax_or_repro():
    """Statically, lazy imports included: no file of the port, nor
    chip_smoke.py, imports jax, jaxlib or the JAX package ``repro``."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, fs in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        files += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    assert len(files) > 80
    for path in files:
        bad = {m for m in _imported_modules(path) if m.split(".")[0] in ("jax", "jaxlib", "repro")}
        assert not bad, (path, bad)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    code = ("import sys; sys.path.insert(0, %r); import chip_smoke; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    """A host without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(no_cuda, tmp_path):
    from repro_torch.configs import deepseek_v2_236b, gemma3_27b
    from repro_torch.configs.two_tower_retrieval import reduced
    from repro_torch.convert import (
        effort_params_from_jax, engine_from_arrays, recsys_params_from_jax,
        transformer_params_from_jax)
    from repro_torch.kernels import rangescan
    from repro_torch.layers import (
        GQAConfig, MLAConfig, MLPConfig, MoEConfig, init_dense_stack, init_gqa, init_mla,
        init_mlp, init_moe, init_token_embedding)
    from repro_torch.models import (
        EffortConfig, EffortPredictor, init_cache, init_effort, init_recsys, init_tower,
        init_transformer)
    from repro_torch.core import (
        Graph, RangeSearchEngine, build_knn_graph, build_vamana, exact_range_search,
        exact_topk, range_counts_at, sweep)
    from repro_torch.live import LiveConfig, LiveIndex
    from repro_torch.tier import tiered_corpus
    from repro_torch.train import CheckpointManager
    from repro_torch.configs import dlrm_rm2, gcn_cora
    from repro_torch.convert import gcn_params_from_jax
    from repro_torch.data import range_graph_dataset
    from repro_torch.layers import FieldAttnConfig, init_field_attention
    from repro_torch.launch.train import build_training
    from repro_torch.models import init_gcn

    pts = np.random.default_rng(0).standard_normal((64, 8)).astype(np.float32)
    nbrs = np.zeros((64, 4), np.int32)
    params = {side: init_tower(reduced(), side, device="cpu") for side in ("user", "item")}
    params = {side: {"tables": t.tables.detach().numpy(),
                     "mlp": {k: v.detach().numpy() for k, v in t.mlp.state_dict().items()}}
              for side, t in params.items()}
    lm = gemma3_27b.reduced()
    lm_params = {"embed": np.zeros((lm.vocab, lm.d_model), np.float32),
                 "final_norm": np.zeros(lm.d_model, np.float32), "layers": {}}
    cm = CheckpointManager(str(tmp_path))
    LiveIndex.create(pts, LiveConfig(capacity=80), graph=Graph(torch.from_numpy(nbrs)),
                     device="cpu").save(cm)
    calls = [
        lambda: RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs))),
        lambda: build_knn_graph(pts, k=4),
        lambda: exact_range_search(pts, pts[:4], 1.0),
        lambda: exact_topk(pts, pts[:4], k=4),
        lambda: range_counts_at(pts, pts[:4], np.ones(2, np.float32)),
        lambda: sweep(pts, pts[:4], np.ones(2, np.float32)),
        lambda: engine_from_arrays(pts, nbrs, np.zeros(1, np.int32)),
        lambda: RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)),
                                             corpus_dtype="int8"),
        lambda: init_tower(reduced(), "item"),
        lambda: init_recsys(reduced()),
        lambda: recsys_params_from_jax(params, reduced()),
        lambda: rangescan(pts[:4], pts, 1.0, k=8),
        lambda: init_dense_stack((8, 4)),
        lambda: init_transformer(lm),
        lambda: init_cache(lm, 1, 8),
        lambda: transformer_params_from_jax(lm_params, lm),
        lambda: init_mlp(MLPConfig(d_model=8, d_ff=16)),
        lambda: init_gqa(GQAConfig(d_model=8, n_heads=2, n_kv=1, d_head=4)),
        lambda: init_mla(MLAConfig(d_model=8, n_heads=2, q_lora=4, kv_lora=4)),
        lambda: init_moe(MoEConfig(d_model=8, n_experts=4, top_k=2, d_expert=8)),
        lambda: init_transformer(deepseek_v2_236b.reduced()),
        lambda: init_cache(deepseek_v2_236b.reduced(), 1, 8),
        lambda: init_token_embedding(16, 8),
        lambda: build_vamana(pts),
        lambda: RangeSearchEngine.build(pts),
        lambda: tiered_corpus(pts),
        lambda: RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)),
                                             tier=True),
        lambda: init_effort(EffortConfig(dim=8)),
        lambda: EffortPredictor.fit(pts, np.ones(64, np.float32), np.ones(64)),
        lambda: effort_params_from_jax({"w0": np.zeros((10, 1), np.float32)}),
        lambda: LiveIndex.create(pts, LiveConfig(capacity=80), graph=Graph(
            torch.from_numpy(nbrs))),
        lambda: LiveIndex.restore(cm),
        lambda: cm.restore_flat(),
        lambda: init_recsys(dlrm_rm2.reduced()),
        lambda: init_gcn(gcn_cora.reduced()),
        lambda: gcn_params_from_jax({"w0": np.zeros((2, 2), np.float32)}),
        lambda: range_graph_dataset(pts, np.zeros(64), 2, k=4),
        lambda: init_field_attention(FieldAttnConfig(n_fields=2, d_embed=4)),
        lambda: build_training("gcn-cora", True, 4, 8),
        lambda: init_transformer(lm, f32_masters=True),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    # asked for explicitly, the CPU works
    eng = RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)),
                                       device="cpu")
    assert eng.device.type == "cpu"
    eng = RangeSearchEngine.from_graph(pts, Graph(torch.from_numpy(nbrs)),
                                       corpus_dtype="int8", device="cpu")
    assert eng.device.type == "cpu" and eng.stats()["corpus_dtype"] == "int8"
    assert tiered_corpus(pts, device="cpu").device.codes.device.type == "cpu"
    assert init_recsys(reduced(), device="cpu").user.tables.device.type == "cpu"
    assert recsys_params_from_jax(params, reduced(), device="cpu").item.tables.shape == (4, 1000, 16)
    assert rangescan(pts[:4], pts, 1.0, k=8, device="cpu")[0].device.type == "cpu"
    assert init_dense_stack((8, 4), device="cpu").w0.device.type == "cpu"
    assert init_transformer(lm, device="cpu").embed.device.type == "cpu"
    assert init_cache(lm, 1, 8, device="cpu").k.device.type == "cpu"
    assert init_transformer(lm, device="meta").embed.is_meta
    assert init_effort(EffortConfig(dim=8), device="cpu")["w0"].device.type == "cpu"
    assert init_gcn(gcn_cora.reduced(), device="cpu")["w0"].device.type == "cpu"
    assert init_recsys(dlrm_rm2.reduced(), device="cpu")["tables"].device.type == "cpu"
    assert build_training("gcn-cora", True, 4, 8, device="cpu")[0]["w1"].device.type == "cpu"

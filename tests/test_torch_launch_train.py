"""The port's training CLI (``python -m repro_torch.launch.train``) against
the reference's, one arch of each family and the two-tower model, both run
in process on the CPU (``--device cpu``) with ``--smoke``.

The reference's CLI runs first; its initial parameters (seed 0, JAX's
generator; for the LM, numpy draws in its tree's shape, since the
reference's eager init costs seconds on the CPU) are carried across into
the port's run by patching ``repro_torch.launch.train.init_params`` (the
two generators cannot give the same draws). Both write a JSONL metrics stream: the logged metrics at
steps 1 and 10 must agree within 1e-4 relative (step 1: one forward on the
same weights and batch, the frameworks' sums in another order; step 10:
nine AdamW updates later, each within the optimizer's tolerance). The
port's run then resumes from its checkpoint to step 12, as the CLI's
``--resume`` does.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
import repro_torch.launch.train as ptrain
from repro_torch.convert import (
    gcn_params_from_jax, recsys_params_from_jax, transformer_params_from_jax)
from repro_torch.models import recsys_tree, transformer_tree

ARCHS = ["gemma3-27b", "gcn-cora", "dlrm-rm2", "two-tower-retrieval"]
_JAX_LM_INIT = jtrain.tf_mod.init_transformer   # before any test patches it
SMALL = ["--batch", "4", "--seq-len", "32"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metrics(path) -> dict:
    return {rec.pop("step"): rec for rec in map(json.loads, open(path))}


def _from_jax(params):
    """``init_params`` returning the reference run's initial tree."""
    def init(family, cfg, seed, device):
        if family == "lm":
            return transformer_tree(transformer_params_from_jax(
                params, cfg, device, f32_masters=True), cfg)
        if family == "gnn":
            return gcn_params_from_jax(params, device)
        return recsys_tree(recsys_params_from_jax(params, cfg, device))
    return init


def _np_lm_init(key, cfg):
    """The reference's LM tree with numpy weights: 0.05 N(0, 1), norm
    scales 1 + 0.05 N(0, 1)."""
    import functools

    import jax.numpy as jnp
    shapes = jax.eval_shape(functools.partial(_JAX_LM_INIT, cfg=cfg), key)
    rng = np.random.default_rng(0)

    def draw(path, s):
        x = 0.05 * rng.standard_normal(s.shape).astype(np.float32)
        return jnp.asarray(x + 1.0 if str(path[-1].key).endswith("norm") else x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_matches_the_reference_and_resumes(arch, tmp_path, monkeypatch, capsys):
    seen = {}
    build = jtrain.build_training

    def spy(*args, **kwargs):
        out = build(*args, **kwargs)
        seen["params"] = jax.tree.map(np.asarray, out[0])
        return out

    monkeypatch.setattr(jtrain, "build_training", spy)
    # the reference's LM init, eager, costs seconds on the CPU: both CLIs
    # start from numpy draws in its tree's shape instead
    monkeypatch.setattr(jtrain.tf_mod, "init_transformer", _np_lm_init)
    jm, pm = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    assert jtrain.main(["--arch", arch, "--smoke", "--steps", "10", *SMALL,
                        "--ckpt-dir", str(tmp_path / "jck"), "--metrics", str(jm)]) == 0
    monkeypatch.setattr(ptrain, "init_params", _from_jax(seen["params"]))
    capsys.readouterr()
    common = ["--arch", arch, "--smoke", *SMALL, "--ckpt-dir", str(tmp_path / "ck"),
              "--device", "cpu"]
    assert ptrain.main([*common, "--steps", "10", "--metrics", str(pm)]) == 0
    out = capsys.readouterr().out
    assert "[trainer] step 1: loss=" in out and "[train] done at step 10" in out
    got, want = _metrics(pm), _metrics(jm)
    assert sorted(got) == sorted(want) == [1, 10]
    for step in want:
        assert got[step].keys() == want[step].keys()
        for k, v in want[step].items():
            np.testing.assert_allclose(got[step][k], v, rtol=1e-4, atol=1e-7,
                                       err_msg=f"{arch} step {step} {k}")
    assert ptrain.main([*common, "--steps", "12", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 10" in out and "[train] done at step 12" in out


def test_train_cli_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ptrain.main(["--arch", "gcn-cora", "--smoke", "--steps", "1"])


def _port_value(v):
    """A reference config value in the port's terms: jnp dtypes as torch's."""
    import jax.numpy as jnp
    return {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}.get(v, v)


def _fields(cfg) -> dict:
    return {k: _port_value(v) for k, v in vars(cfg).items()}


def test_registry_matches_the_reference():
    """The registry's ids, order, 40 cells and every architecture's
    published geometry, reduced config, optimizer and rules."""
    import dataclasses

    import repro.configs as jconfigs
    import repro_torch.configs as pconfigs
    assert list(pconfigs.REGISTRY) == list(jconfigs.REGISTRY) == pconfigs.list_archs()
    assert pconfigs.ASSIGNED == jconfigs.ASSIGNED and len(pconfigs.ASSIGNED) == 10
    assert pconfigs.all_cells() == jconfigs.all_cells() and len(pconfigs.all_cells()) == 40
    assert pconfigs.all_cells(include_engine=True) == jconfigs.all_cells(include_engine=True)
    with pytest.raises(KeyError, match="unknown arch"):
        pconfigs.get_arch("gpt-5")
    for arch_id, j in jconfigs.REGISTRY.items():
        p = pconfigs.get_arch(arch_id)
        assert (p.family, p.source, p.technique_note, p.accum_steps) == (
            j.family, j.source, j.technique_note, j.accum_steps), arch_id
        assert p.param_dtype == _port_value(j.param_dtype)
        assert p.opt_cfg == type(p.opt_cfg)(**_fields(j.opt_cfg)), arch_id
        assert p.shapes == {k: type(p.shapes[k])(**vars(v)) for k, v in j.shapes.items()}
        assert [(r.pattern, r.spec) for r in p.rules] == [(r.pattern, r.spec) for r in j.rules]
        if arch_id == "range-engine":    # held field by field in tests/test_torch_build.py
            continue
        kept = {f.name for f in dataclasses.fields(p.model_cfg)}
        for port, ref in ((p.model_cfg, j.model_cfg), (p.reduced(), j.reduced())):
            want = {k: v for k, v in _fields(ref).items() if k in kept}
            got = {k: v for k, v in vars(port).items() if k != "use_kernels"}
            assert got == want, arch_id
            # the reference's fields the port leaves out: XLA's scan unrolling
            assert set(vars(ref)) - kept <= {"scan_unroll"}, arch_id

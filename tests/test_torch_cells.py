"""The cell builder, the meshes and the roofline against the JAX package.

Every cell of ``configs.all_cells(include_engine=True)`` (42: ten
architectures x four shapes, and the engine's two) is built by both
packages at full width, and described leaf by leaf
(``tests/_torch_cells_dump.py``): each input's path, shape and dtype, each
input and output placement (a tensor dim a mesh axis, or replicated), the
donated indices, ``meta`` and ``analytic_model_flops`` over the cell's
parameter tree. The descriptions must be equal, the flops within 1e-12
relative (the parameter counts are summed in another order). On a (1, 1)
mesh both packages build in this process (the port's mesh is a one-rank
gloo group); at the production 16 x 16 the reference runs in a subprocess
with 256 forced CPU devices and the port in another on torch's fake process
group of 256 ranks (shapes only), the two started together once a module.

Every other cell runs once too, at its arch's ``reduced()`` model and its
shape cut to CPU size (``_reduced``): the port's ``fn`` on real CPU
tensors (floats random, integers 0, which is a valid token, id, node,
class and position everywhere) returns the tree of paths, shapes and
dtypes that ``jax.eval_shape`` gives for the reference's cell on the same
sizes, every float finite.

The engine cell also runs: at ``range_engine.reduced()`` (2,000 x 16,
R=8, result_cap 128) on real CPU tensors, the port's ``fn`` against the
reference's jitted one on the same numpy inputs: ids and counts equal,
distances ``allclose(rtol=1e-5, atol=1e-6)``. The points are N(0, 0.3²),
so that radius 1.0 (squared l2) holds between 0 and 116 of them a query.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_cells_dump as dump
from repro.analysis import roofline as jroof
from repro.configs import get_arch as jax_get_arch
from repro.configs import range_engine as jre
from repro.core import build_knn_graph as jax_build_knn_graph
from repro.core import medoid as jax_medoid
from repro.launch.steps import build_cell as jax_build_cell
from repro_torch.analysis import roofline
from repro_torch.configs import all_cells, get_arch
from repro_torch.configs import range_engine as tre
from repro_torch.launch.mesh import make_host_mesh, mesh_devices
from repro_torch.launch.steps import build_cell

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = [f"{a}/{s}" for a, s in all_cells(include_engine=True)]
FLOPS_REL = 1e-12
TIMEOUT_S = 300
ENGINE_SIGMA = 0.3
ENGINE_QUERIES = 128
# a shape's sizes at CPU scale (each nonzero size of the full shape, at most this)
REDUCED_SHAPE = dict(seq_len=16, global_batch=2, n_candidates=2048, n_nodes=64,
                     n_edges=256, d_feat=16, batch_nodes=4, n_graphs=4, nodes_per_graph=6,
                     edges_per_graph=10)
REDUCED_FANOUT = (3, 2)
REDUCED_KV = 32             # a decode cell's cache length


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for this module's small tensors: more only spin,
    and under the parallel test workers they oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def torch_mesh():
    """A (1, 1) gloo mesh over a one-rank group of this process, taken down
    after the module."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1)
    yield mesh
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture(scope="module")
def one_rank(torch_mesh, jax_mesh):
    return dump.describe_jax(jax_mesh), dump.describe_torch(torch_mesh)


@pytest.fixture(scope="module")
def production():
    """Both packages' descriptions at 16 x 16, each from its own subprocess,
    the two run at once."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    script = os.path.join(ROOT, "tests", "_torch_cells_dump.py")
    procs = {side: subprocess.Popen([sys.executable, script, side, "16x16"], env=env,
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for side in ("jax", "torch")}
    out = {}
    for side, p in procs.items():
        stdout, stderr = p.communicate(timeout=TIMEOUT_S)
        assert p.returncode == 0, f"{side} side failed:\n{stderr[-3000:]}"
        out[side] = json.loads(stdout)
    return out["jax"], out["torch"]


def _assert_same(want: dict, got: dict, name: str) -> None:
    for key in ("args", "in", "out", "donate", "meta"):
        assert got[key] == want[key], (name, key)
    assert abs(got["flops"] - want["flops"]) <= FLOPS_REL * abs(want["flops"]), name
    assert got["flops"] > 0, name


@pytest.mark.parametrize("cell", CELLS)
def test_cell_matches_reference_on_one_rank_mesh(one_rank, cell):
    want, got = one_rank
    _assert_same(want[cell], got[cell], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_matches_reference_on_production_mesh(production, cell):
    want, got = production
    _assert_same(want[cell], got[cell], cell)
    # every input leaf is placed, sharded somewhere over the 256 ranks or
    # replicated
    assert set(got[cell]["in"]) == set(got[cell]["args"]), cell


def test_production_mesh_has_256_devices(production, torch_mesh):
    want, got = production
    assert got["mesh_devices"] == want["mesh_devices"] == 256
    assert mesh_devices(torch_mesh) == 1
    assert set(got) - {"mesh_devices"} == set(CELLS)


def test_int8_engine_cell_matches_reference(torch_mesh, jax_mesh):
    """The quantized deploy's cell: a QuantizedCorpus of codes, metadata
    and raw rows, each placed along the model axis."""
    jarch = dataclasses.replace(jre.ARCH, model_cfg=jre.EngineDeployConfig(
        corpus_dtype="int8"))
    tarch = dataclasses.replace(tre.ARCH, model_cfg=tre.EngineDeployConfig(
        corpus_dtype="int8"))
    want = dump.describe_jax(jax_mesh, jarch, "search_4k")
    got = dump.describe_torch(torch_mesh, tarch, "search_4k")
    _assert_same(want, got, "int8 search_4k")
    assert got["args"]["0/codes"] == [[1, 1_000_000, 128], "int8"]
    assert got["args"]["0/raw"] == [[1, 1_000_000, 128], "float32"]


def test_roofline_constants_are_h100():
    """The H100 SXM data sheet's dense rates, at its 700 W limit."""
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.ICI_BW == 450e9
    assert roofline.F32_FLOPS == 67e12 and roofline.TF32_FLOPS == 495e12
    assert roofline.INT8_OPS == 1979e12
    assert round(roofline.PEAK_FLOPS / roofline.HBM_BW) == 295
    assert round(roofline.F32_FLOPS / roofline.HBM_BW) == 20


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("dim", [16, 128, 960])
def test_corpus_bytes_and_intensity_match_reference(dtype, dim):
    assert roofline.corpus_bytes_per_distance(dim, dtype) == \
        jroof.corpus_bytes_per_distance(dim, dtype)
    assert roofline.search_arithmetic_intensity(dim, dtype) == \
        jroof.search_arithmetic_intensity(dim, dtype)
    assert roofline.jnp_itemsize(dtype) == jroof.jnp_itemsize(dtype)


def _report(mod, **kw):
    fields = dict(arch_id="range-engine", shape="search_4k", mesh="1x1", chips=1,
                  hlo_flops=8.59e9, hlo_bytes=1.72e10, collective_bytes=0.0,
                  collective_wire_bytes=0.0, collective_summary="", compute_s=8.7e-6,
                  memory_s=5.13e-3, collective_s=0.0, dominant="memory",
                  model_flops=8.59e9, useful_ratio=1.0, step_time_s=5.13e-3,
                  mfu=1.7e-3, memory_per_device={"argument_size_in_bytes": 7}, note="n")
    fields.update(kw)
    return mod.RooflineReport(**fields)


def test_roofline_report_fields_json_row_and_round_trip(tmp_path):
    assert [f.name for f in dataclasses.fields(roofline.RooflineReport)] == \
        [f.name for f in dataclasses.fields(jroof.RooflineReport)]
    reps = [_report(roofline), _report(roofline, shape="search_64k", mfu=0.25)]
    jreps = [_report(jroof), _report(jroof, shape="search_64k", mfu=0.25)]
    assert [r.to_json() for r in reps] == [r.to_json() for r in jreps]
    assert [r.row() for r in reps] == [r.row() for r in jreps]
    path = str(tmp_path / "reports.json")
    roofline.save_reports(reps, path)
    assert roofline.load_reports(path) == jroof.load_reports(path) == \
        [r.to_json() for r in reps]


def _reduced(arch, name):
    """``arch`` at its ``reduced()`` model with shape ``name`` alone, cut to
    CPU size: each nonzero size to at most REDUCED_SHAPE's, a sampled
    fanout of REDUCED_FANOUT, a decode cache of REDUCED_KV, and an LM
    training batch of two a micro-batch."""
    shape = arch.shapes[name]
    kw = {k: min(getattr(shape, k), v) for k, v in REDUCED_SHAPE.items() if getattr(shape, k)}
    if shape.fanout:
        kw["fanout"] = REDUCED_FANOUT
    if shape.kind == "decode":
        kw["seq_len"] = REDUCED_KV
    if shape.kind == "train" and arch.family == "lm":
        kw["global_batch"] = 2 * arch.accum_steps
    return dataclasses.replace(arch, model_cfg=arch.reduced(),
                               shapes={name: dataclasses.replace(shape, **kw)})


def _materialize(tree, gen, zeros: bool):
    """Real CPU tensors for a tree of meta ones: floats N(0, 0.02²) in their
    dtype (0 where ``zeros``, as a fresh optimizer state's), integers 0."""
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() and not zeros:
            return (torch.randn(tree.shape, generator=gen) * 0.02).to(tree.dtype)
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, dict):
        return {k: _materialize(v, gen, zeros) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_materialize(v, gen, zeros) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _materialize(getattr(tree, f.name), gen, zeros)
            for f in dataclasses.fields(tree)})
    return tree


@pytest.mark.parametrize("cell", [c for c in CELLS if not c.startswith("range-engine/")])
def test_cell_fn_runs_at_reduced_like_reference(torch_mesh, jax_mesh, cell):
    aid, name = cell.split("/")
    jcell = jax_build_cell(_reduced(jax_get_arch(aid), name), name, jax_mesh)
    want = {p: [list(x.shape), str(x.dtype)]
            for p, x in dump.flat_jax(jax.eval_shape(jcell.fn, *jcell.args)).items()}
    tcell = build_cell(_reduced(get_arch(aid), name), name, torch_mesh)
    assert len(tcell.roles) == len(tcell.args) and tcell.roles[0] == "params", cell
    gen = torch.Generator().manual_seed(0)
    args = [_materialize(a, gen, role == "opt_state") for a, role in zip(tcell.args, tcell.roles)]
    with torch.no_grad():
        out = dump.flat_torch(tcell.fn(*args))
    assert {p: [list(x.shape), dump._dtype(x.dtype)] for p, x in out.items()} == want, cell
    assert all(torch.isfinite(x).all() for x in out.values() if x.is_floating_point()), cell


def _engine_archs():
    shape = dict(name="search", kind="range_search", global_batch=ENGINE_QUERIES)
    jarch = dataclasses.replace(jre.ARCH, model_cfg=jre.reduced(), shapes={
        "search": dataclasses.replace(jre.ARCH.shapes["search_4k"], **shape)})
    tarch = dataclasses.replace(tre.ARCH, model_cfg=tre.reduced(), shapes={
        "search": dataclasses.replace(tre.ARCH.shapes["search_4k"], **shape)})
    return jarch, tarch


def test_engine_cell_at_reduced_runs_like_reference(torch_mesh, jax_mesh):
    jarch, tarch = _engine_archs()
    cfg = tarch.model_cfg
    rng = np.random.default_rng(0)
    pts = (rng.standard_normal((cfg.shard_corpus, cfg.dim)) * ENGINE_SIGMA).astype(np.float32)
    qs = (rng.standard_normal((ENGINE_QUERIES, cfg.dim)) * ENGINE_SIGMA).astype(np.float32)
    nbrs = np.array(jax_build_knn_graph(jnp.asarray(pts), k=cfg.max_degree).neighbors)
    start = np.array(jax_medoid(jnp.asarray(pts))).reshape(1, 1).astype(np.int32)
    args = (pts[None], nbrs[None], start, np.zeros(1, np.int32), qs)
    want = [np.asarray(x) for x in jax_build_cell(jarch, "search", jax_mesh).jitted()(
        *(jnp.asarray(a) for a in args))]
    cell = build_cell(tarch, "search", torch_mesh)
    assert [tuple(a.shape) for a in cell.args] == [a.shape for a in args]
    got = [x.numpy() for x in cell.fn(*(torch.from_numpy(a) for a in args))]
    ids, dists, count = got
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(count, want[2])
    np.testing.assert_array_equal(np.isfinite(dists), np.isfinite(want[1]))
    fin = np.isfinite(want[1])
    np.testing.assert_allclose(dists[fin], want[1][fin], rtol=1e-5, atol=1e-6)
    # the rig exercises the range test: empty lanes, and none at the cap
    cap = cfg.range_cfg.result_cap
    assert count.min() == 0 and 0 < count.max() < cap
    assert (dists[fin] <= 1.0).all()

"""The port's dry-run analysis against the reference's (``tests/test_analysis.py``).

The reference walks XLA's partitioned HLO text; the port walks the FX graph
``make_fx`` records of a step under ``FakeTensorMode``. Each case holds the
port's numbers to the reference's own on the same program:

* a loop of 7 matmuls (32 x 128 by 128 x 128) and a 3 x 4 nested loop
  (8 x 64 by 64 x 64): the port's trace unrolls them, the reference counts
  its scans' trips; ``dot_flops`` equal;
* one 64 x 256 by 256 x 256 matmul of two arguments: flops and
  ``hbm_bytes`` equal;
* the sum of a (64, 4) f32 tensor sharded over 8 ranks (the port's fake
  process group, the reference's 8 forced host devices in a subprocess):
  the all-reduce's count, operand bytes and wire bytes equal;
* ``make_report`` against the reference's on the same cost, memory and
  analysis, the port's constants set to the reference's v5e figures for
  that test only: every field equal;
* the dry run's per-cell function on one cell of each of the nine kinds at
  its arch's ``reduced()`` (the cut shapes of ``tests/test_torch_cells.py``),
  on a fake 2 x 2 and a fake (1, 1) mesh, in one subprocess
  (``tests/_torch_dryrun_cells.py``): finite flops above 0, the argument
  bytes equal to rank 0's blocks as this test computes them from the
  placements, collectives counted in each train cell on 2 x 2 and none on
  (1, 1).
"""
import json
import os
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import roofline as jroof
from repro.analysis.hlo import analyze_module as jax_analyze
from repro_torch.analysis import hlo, roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS_SCRIPT = os.path.join(ROOT, "tests", "_torch_dryrun_cells.py")
TIMEOUT_S = 600

_JAX_COLLECTIVE = textwrap.dedent("""
    import json, os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.analysis.hlo import analyze_module
    mesh = jax.make_mesh((8,), ("d",))
    f = jax.jit(lambda x: jnp.sum(x), in_shardings=(NamedSharding(mesh, P("d")),))
    c = analyze_module(f.lower(jax.ShapeDtypeStruct((64, 4), jnp.float32)).compile()
                       .as_text()).collectives
    print(json.dumps([c.counts, c.operand_bytes, c.wire_bytes]))
""")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def subprocs():
    """The reference's 8-device collective program and the port's dry-run
    cells, each in its own process, started together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = {"jax": subprocess.Popen([sys.executable, "-c", _JAX_COLLECTIVE], cwd=ROOT, env=env,
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
             "cells": subprocess.Popen([sys.executable, CELLS_SCRIPT], cwd=ROOT, env=env,
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT_S)
            assert p.returncode == 0, f"{name}:\n{stderr[-4000:]}"
            out[name] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _trace(fn, *shapes):
    from torch.fx.experimental.proxy_tensor import make_fx
    return make_fx(fn, tracing_mode="fake")(*(torch.zeros(s) for s in shapes))


def test_loop_of_matmuls_counts_every_trip():
    w = jnp.zeros((128, 128), jnp.float32)

    def scanned(x):
        def body(c, _):
            return c @ w, None
        return jax.lax.scan(body, x, None, length=7)[0]
    want = jax_analyze(jax.jit(scanned).lower(jnp.zeros((32, 128))).compile().as_text())

    def looped(x, w):
        for _ in range(7):
            x = x @ w
        return x
    got = hlo.analyze_module(_trace(looped, (32, 128), (128, 128)))
    assert want.n_while == 1 and want.max_trip == 7
    assert got.n_while == 0 and got.max_trip == 1 and got.dot_count == 7
    assert got.dot_flops == want.dot_flops == 2 * 32 * 128 * 128 * 7


def test_nested_loops_multiply():
    w = jnp.zeros((64, 64), jnp.float32)

    def nested(x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            return jax.lax.scan(inner, c, None, length=4)[0], None
        return jax.lax.scan(outer, x, None, length=3)[0]
    want = jax_analyze(jax.jit(nested).lower(jnp.zeros((8, 64))).compile().as_text())

    def looped(x, w):
        for _ in range(3):
            for _ in range(4):
                x = x @ w
        return x
    got = hlo.analyze_module(_trace(looped, (8, 64), (64, 64)))
    assert got.dot_flops == want.dot_flops == 2 * 8 * 64 * 64 * 12
    assert hlo.count_op(_trace(looped, (8, 64), (64, 64)), "mm") == 12


def test_plain_matmul_flops_and_bytes_match_reference():
    x, w = jnp.zeros((64, 256), jnp.float32), jnp.zeros((256, 256), jnp.float32)
    want = jax_analyze(jax.jit(lambda x, w: x @ w).lower(x, w).compile().as_text())
    gm = _trace(lambda x, w: x @ w, (64, 256), (256, 256))
    got = hlo.analyze_module(gm)
    assert got.dot_flops == want.dot_flops == 2 * 64 * 256 * 256
    assert got.hbm_bytes == want.hbm_bytes == 4 * (64 * 256 + 256 * 256 + 64 * 256)
    ins = hlo.instructions(gm)
    assert [(i.opcode, i.shape) for i in ins] == [("mm", "f32[64,256]")]
    mem = hlo.memory_analysis(gm)
    assert (mem.argument_size_in_bytes, mem.output_size_in_bytes) == (4 * (64 * 256 + 256 * 256),
                                                                      4 * 64 * 256)


def test_liveness_walk_peaks_at_the_largest_live_set():
    """x -> a = x @ w (live), b = a + 1 (a and b live), c = b * 2 (a dead
    after b): the peak holds a and b, the output is no temporary."""
    def f(x, w):
        a = x @ w
        b = a + 1
        return (b * 2).sum()
    mem = hlo.memory_analysis(_trace(f, (16, 32), (32, 8)))
    assert mem.temp_size_in_bytes == 2 * 16 * 8 * 4
    assert mem.output_size_in_bytes == 4


def test_collectives_match_reference_on_eight_ranks(subprocs):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.dryrun import _fake_tensor_workarounds
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        mesh = DeviceMesh("cpu", torch.arange(8), mesh_dim_names=("d",))

        def f(local):
            x = DTensor.from_local(local, mesh, (Shard(0),), run_check=False,
                                   shape=(64, 4), stride=(4, 1))
            return torch.sum(x).full_tensor()
        from torch.fx.experimental.proxy_tensor import make_fx
        with _fake_tensor_workarounds():
            gm = make_fx(f, tracing_mode="fake")(torch.zeros((8, 4)))
        got = hlo.parse_collectives(gm)
    finally:
        dist.destroy_process_group()
    counts, operand, wire = subprocs["jax"]
    assert counts == {"all-reduce": 1.0}
    assert got.counts == counts
    assert got.operand_bytes == operand == {"all-reduce": 4.0}
    assert got.wire_bytes == wire
    assert got.summary() == hlo.CollectiveStats(counts, operand, wire).summary()


def test_make_report_matches_reference_at_equal_constants(monkeypatch):
    from repro.analysis.hlo import CollectiveStats as JStats
    from repro.analysis.hlo import ModuleAnalysis as JAnalysis
    for name in ("PEAK_FLOPS", "HBM_BW", "ICI_BW"):
        monkeypatch.setattr(roofline, name, getattr(jroof, name))
    arch = types.SimpleNamespace(arch_id="qwen3-14b")
    shape = types.SimpleNamespace(name="train_4k")
    stats = ({"all-gather": 3.0, "reduce-scatter": 2.0}, {"all-gather": 3.5e8,
             "reduce-scatter": 1.25e8}, {"all-gather": 3.4e8, "reduce-scatter": 1.2e8})
    mem = types.SimpleNamespace(argument_size_in_bytes=7_000_000_000,
                                output_size_in_bytes=6_500_000_000,
                                temp_size_in_bytes=12_000_000_000)
    for cost, trip in (({"flops": 3.1e15, "bytes accessed": 2.2e12}, 1),
                       ({"flops": 1.0e12, "bytes accessed": 4.0e9}, 62),
                       ({}, 1)):
        ours = hlo.ModuleAnalysis(dot_flops=2.9e15, hbm_bytes=3.3e12,
                                  collectives=hlo.CollectiveStats(*stats), n_while=0,
                                  max_trip=trip, dot_count=500.0)
        theirs = JAnalysis(dot_flops=2.9e15, hbm_bytes=3.3e12, collectives=JStats(*stats),
                           n_while=0, max_trip=trip, dot_count=500.0)
        got = roofline.make_report(arch, shape, "16x16", 256, cost, mem, ours, 4.4e17,
                                   note="n")
        want = jroof.make_report(arch, shape, "16x16", 256, cost, mem, theirs, 4.4e17,
                                 note="n")
        assert got.to_json() == want.to_json()
        assert got.row() == want.row()


def _local_bytes(desc: dict) -> int:
    """Rank 0's bytes of a cell's arguments from their shapes and
    placements: a dim sharded over a mesh axis of n keeps ceil(size / n);
    the engine's queries (its last argument) go in whole, and a decode
    cell's position (its last) is a Python int in the trace."""
    total = 0
    names = list(desc["args"])
    if desc["kind"] == "decode":
        names = names[:-1]
    for i, path in enumerate(names):
        shape, itemsize = desc["args"][path]
        shape = list(shape)
        if not (desc["kind"] == "range_search" and i == len(names) - 1):
            for axis, pl in zip(desc["mesh"], desc["in"][path]):
                if pl != "R":
                    d = int(pl[1:])
                    shape[d] = -(-shape[d] // axis)
        total += int(np.prod(shape)) * itemsize
    return total


@pytest.mark.parametrize("mesh", ["2x2", "1x1"])
def test_dryrun_cells_of_every_kind(subprocs, mesh):
    cells = subprocs["cells"][mesh]
    kinds = {c["kind"] for c in cells.values()}
    assert kinds == {"train", "prefill", "decode", "serve", "retrieval", "graph_full",
                     "graph_sampled", "graph_batched", "range_search"}
    for name, c in cells.items():
        rep = c["report"]
        assert np.isfinite(rep["hlo_flops"]) and rep["hlo_flops"] > 0, name
        assert rep["chips"] == (4 if mesh == "2x2" else 1)
        assert rep["memory_per_device"]["argument_size_in_bytes"] == \
            _local_bytes(c), name
        assert rep["dominant"] in ("compute", "memory", "collective")
        n_coll = c["collectives"]
        if c["kind"] == "train":
            assert (n_coll > 0) if mesh == "2x2" else (n_coll == 0), (name, n_coll)
        if c["kind"] == "decode":
            assert "seq_len - 1" in rep["note"]
        if c["kind"] == "range_search":
            assert "one iteration" in rep["note"]

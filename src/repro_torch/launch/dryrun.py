"""Multi-pod dry run: trace every (arch x shape x mesh) cell's step on one
rank of the production mesh, on the CPU, and report its roofline terms.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-27b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40 cells, 16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod # 2x16x16
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --include-engine \\
      --keep-going --report build/roofline_16x16.json

The reference lowers and compiles each cell under 256 or 512 forced host
devices. The port sets up torch's fake process group of that many ranks in
this one process (``torch.testing._internal.distributed.fake_pg``: shapes
only, its collectives return at once), then per cell:

1. ``make_production_mesh``, and ``build_cell`` inside
   ``activation_sharding(mesh)``;
2. rank 0's local block of each meta argument becomes a fake tensor, made a
   DTensor of the argument's global shape and placements inside the traced
   function (the engine cells take the rank's blocks as they are, every
   query included, as their ``fn`` does);
3. ``make_fx`` traces ``cell.fn`` under ``FakeTensorMode``: the graph holds
   rank 0's aten ops and the collectives DTensor's redistributions issue;
4. ``analysis.hlo.analyze_module`` and ``memory_analysis`` read the graph
   (the cost's flops are its dot flops plus ``pointwise_flops``, as XLA's
   cost analysis counts elementwise work; its bytes the walk's),
   ``analytic_model_flops`` the cell's parameters, ``make_report`` makes
   the report, appended to ``--report`` as JSON.

Three things differ from a run, and a cell's ``note`` says which apply:
* decode cells bind the position to the Python int ``seq_len - 1``: the
  cell's ``int(pos)`` cannot read a fake tensor;
* range-search cells trace one iteration of each walk
  (``core.beam_search.walk_trips(1)``): the walk ends on a host test
  (``live.any()``) every iteration, and the reference's HLO walk counts a
  while body of unknown trip count once;
* a kernel is an opaque launch to a trace, and on the CPU the trace passes
  through its plain version: the bytes of the flash attention (prefill,
  decode) and the engine's expand and gatherdist are the plain version's,
  which overstate the kernel's traffic.

Prints the reference's lines for each cell; the exit code is 0 only if no
cell failed. The fake process group is torch's testing module, so the dry
run needs a torch that ships it; it is a CPU tool.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys
import time
import traceback

import torch

from ..analysis.hlo import analyze_module, memory_analysis, pointwise_flops
from ..analysis.roofline import analytic_model_flops, make_report
from ..configs import all_cells, get_arch
from ..dist.sharding import activation_sharding, is_dtensor
from .mesh import make_production_mesh, mesh_devices
from .steps import build_cell

NOTE_DECODE = "decode position bound to the Python int seq_len - 1 for the trace"
NOTE_WALK = ("one iteration of each walk traced (its loop ends on a host test); "
             "a while body of unknown trip count counts once")
NOTE_KERNEL = ("kernel {} traced through its plain version: its bytes overstate "
               "the kernel's traffic")


def fake_world(size: int) -> None:
    """A fake process group of ``size`` ranks in this process, rank 0
    (shapes only); an existing group of that size is kept."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"initialized, the dry run needs {size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


# ---------------------------------------------------------------------------
# trees of arguments and their bindings
# ---------------------------------------------------------------------------

def _is_binding(x) -> bool:
    from torch.distributed.device_mesh import DeviceMesh
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh)


def _flatten(tree, out: list):
    """The tensors of ``tree`` into ``out``; returns a rebuild function."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
        return lambda it: next(it)
    if isinstance(tree, dict):
        parts = {k: _flatten(v, out) for k, v in tree.items()}
        return lambda it: {k: f(it) for k, f in parts.items()}
    if isinstance(tree, (list, tuple)):
        parts = [_flatten(v, out) for v in tree]
        return lambda it: type(tree)(f(it) for f in parts)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        parts = {f.name: _flatten(getattr(tree, f.name), out)
                 for f in dataclasses.fields(tree)}
        return lambda it: dataclasses.replace(tree, **{k: f(it) for k, f in parts.items()})
    return lambda it: tree


def _bindings(tree, binding, out: list) -> None:
    """``binding``'s ``(mesh, placements)`` for each tensor of ``tree``, in
    ``_flatten``'s order (a binding over a subtree applies to its every
    tensor)."""
    if isinstance(tree, torch.Tensor):
        out.append(binding)
    elif _is_binding(binding) or binding is None:
        n: list = []
        _flatten(tree, n)
        out.extend([binding] * len(n))
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _bindings(v, binding[k], out)
    elif isinstance(tree, (list, tuple)):
        for v, b in zip(tree, binding):
            _bindings(v, b, out)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            _bindings(getattr(tree, f.name), getattr(binding, f.name), out)


def local_shape(shape, binding) -> tuple:
    """Rank 0's block of a tensor of ``shape`` laid out by ``binding``: a
    dim sharded over a mesh axis of n ranks keeps its first chunk, of
    ceil(size / n) rows (``torch.chunk``'s split)."""
    shape = list(shape)
    if binding is None:
        return tuple(shape)
    mesh, placements = binding
    for i, pl in enumerate(placements):
        if pl.is_shard():
            n = mesh.size(i)
            shape[pl.dim] = -(-shape[pl.dim] // n)
    return tuple(shape)


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _fake_tensor_workarounds():
    """Two checks inside DTensor read tensor values, which a fake tensor
    does not have; in the trace they are set aside:
    * a redistribution of a strided shard (two sharded dims merged by a
      reshape, as an einsum does) is planned from a ``torch.arange`` read
      back with ``.tolist()``: the planning runs with the dispatch modes
      set aside, so it neither fails nor enters the graph;
    * an embedding over rows sharded on two mesh axes materializes one mask
      for both and checks with ``torch.equal`` that the second is the first
      (it is: both are the same lookup's): the check is skipped."""
    from torch.distributed.tensor._ops._mask_buffer import MaskBuffer
    from torch.distributed.tensor.placement_types import _StridedShard
    from torch.utils._python_dispatch import _disable_current_modes
    offsets, materialize = _StridedShard.local_shard_size_and_offset, \
        MaskBuffer.materialize_mask

    def plain_offsets(self, *args, **kwargs):
        with _disable_current_modes():
            return offsets(self, *args, **kwargs)

    def unchecked(self, mask):
        if self.refcount == 0:
            self.data = mask
        self.refcount += 1
    _StridedShard.local_shard_size_and_offset = plain_offsets
    MaskBuffer.materialize_mask = unchecked
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = offsets
        MaskBuffer.materialize_mask = materialize


def trace_cell(arch, shape, cell):
    """(the FX graph of rank 0's step, the notes that apply to it)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.fx.experimental.proxy_tensor import make_fx

    from ..core.beam_search import walk_trips

    engine = arch.family == "engine"
    decode = shape.kind == "decode"
    args = list(cell.args)
    shard = list(cell.in_shardings)
    if engine:   # the rank passes its shards' blocks and every query
        shard[-1] = None
    if decode:   # the position: a Python int (int(pos) reads no fake tensor)
        pos, args, shard = shape.seq_len - 1, args[:-1], shard[:-1]
    leaves: list = []
    rebuild = _flatten(tuple(args), leaves)
    binds: list = []
    for a, b in zip(args, shard):
        _bindings(a, b, binds)

    def step(*local):
        wrapped = []
        for t, x, b in zip(local, leaves, binds):
            if b is None or engine:
                wrapped.append(t)
            else:
                wrapped.append(DTensor.from_local(t, b[0], b[1], run_check=False,
                                                  shape=x.shape, stride=x.stride()))
        call = rebuild(iter(wrapped))
        if decode:
            call = call + (pos,)
        out: list = []
        _flatten(cell.fn(*call), out)
        return [o.to_local() if is_dtensor(o) else o for o in out]

    notes = []
    if decode:
        notes.append(NOTE_DECODE)
    if engine:
        notes.append(NOTE_WALK)
        notes.append(NOTE_KERNEL.format("expand and gatherdist"))
    elif arch.family == "lm" and shape.kind in ("prefill", "decode") \
            and arch.model_cfg.attn_kind == "gqa":
        notes.append(NOTE_KERNEL.format("flashattn"))
    with FakeTensorMode(allow_non_fake_inputs=True), _fake_tensor_workarounds(), \
            (walk_trips(1) if engine else contextlib.nullcontext()):
        local = [torch.empty(local_shape(x.shape, b), dtype=x.dtype)
                 for x, b in zip(leaves, binds)]
        gm = make_fx(step)(*local)
    return gm, notes


def run_cell(arch_id: str, shape_name: str, multi_pod: bool = False, verbose: bool = True,
             *, arch=None, mesh=None, mesh_name=None):
    """One cell's ``RooflineReport``. ``arch`` (an ``ArchSpec``, e.g. at its
    ``reduced()``) and ``mesh`` override the registry's and the production
    mesh (which needs a fake world of its size, ``fake_world``)."""
    arch = arch or get_arch(arch_id)
    shape = arch.shapes[shape_name]
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        mesh_name = "2x16x16" if multi_pod else "16x16"
    mesh_name = mesh_name or "x".join(str(s) for s in tuple(mesh.shape))
    chips = mesh_devices(mesh)
    t0 = time.time()
    with activation_sharding(mesh):
        cell = build_cell(arch, shape_name, mesh)
        gm, notes = trace_cell(arch, shape, cell)
    t_trace = time.time() - t0
    analysis = analyze_module(gm)
    mem = memory_analysis(gm)
    cost = {"flops": analysis.dot_flops + pointwise_flops(gm),
            "bytes accessed": analysis.hbm_bytes}
    model_flops = analytic_model_flops(arch, shape, cell.args[0])
    report = make_report(arch, shape, mesh_name, chips, cost, mem, analysis,
                         model_flops, note="; ".join(notes))
    if verbose:
        print(f"== {arch_id} x {shape_name} on {mesh_name} "
              f"({chips} chips)  [trace {t_trace:.1f}s]")
        print(f"   memory_analysis: {mem}")
        print(f"   cost_analysis: flops={cost.get('flops', 0):.4g} "
              f"bytes={cost.get('bytes accessed', 0):.4g}")
        print(f"   collectives: {analysis.collectives.summary()}")
        print(f"   whiles={analysis.n_while} max_trip={analysis.max_trip} "
              f"dot_flops/dev={analysis.dot_flops:.4g}")
        print(f"   roofline: {report.row()}")
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", default=None)
    p.add_argument("--shape", default=None)
    p.add_argument("--all", action="store_true")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--include-engine", action="store_true")
    p.add_argument("--report", default=None, help="append JSON reports here")
    p.add_argument("--keep-going", action="store_true")
    args = p.parse_args(argv)

    if args.all:
        cells = all_cells(include_engine=args.include_engine)
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    elif args.arch:
        cells = [(args.arch, s) for s in get_arch(args.arch).shapes]
    else:
        p.error("need --arch [--shape] or --all")

    fake_world(512 if args.multi_pod else 256)
    t0 = time.time()
    reports, failures = [], []
    for arch_id, shape_name in cells:
        try:
            reports.append(run_cell(arch_id, shape_name, args.multi_pod))
        except Exception as e:
            failures.append((arch_id, shape_name, repr(e)))
            print(f"!! FAILED {arch_id} x {shape_name}: {e}")
            traceback.print_exc()
            if not args.keep_going:
                break
    if args.report and reports:
        existing = []
        if os.path.exists(args.report):
            with open(args.report) as f:
                existing = json.load(f)
        os.makedirs(os.path.dirname(args.report) or ".", exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(existing + [r.to_json() for r in reports], f, indent=1)
    import resource
    print(f"\n{len(reports)} cells OK, {len(failures)} failed in {time.time() - t0:.1f} s "
          f"(peak host memory {resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6:.2f} GB)")
    for a, s, e in failures:
        print(f"  FAIL {a} x {s}: {e}")
    return 0 if not failures else 1


if __name__ == "__main__":
    sys.exit(main())

"""Per-rank analysis of a traced torch program: the counterpart of the
reference's HLO walk.

The reference walks XLA's compiled, partitioned HLO text. The port has no
HLO: its program is the FX graph that ``torch.fx.experimental.proxy_tensor.
make_fx`` records of a step under ``FakeTensorMode`` (aten ops on one
rank's local blocks, plus the ``_c10d_functional`` collectives that
DTensor's redistributions issue and the ``c10d`` ones of the port's own
collective helpers). Every node carries its fake value (``meta["val"]``),
so shapes and dtypes are exact. The names and fields are the reference's:

1. FLOPs: every node whose op has a formula in ``torch.utils.flop_counter``'s
   registry (matmuls, convolutions, attention) adds that formula on its fake
   shapes; ``dot_count`` counts those nodes;
2. HBM bytes: every op that is not a view adds its tensor operands' and
   results' bytes. Eager PyTorch runs each op as its own kernel, the
   counterpart of the reference's "top level of non-fused computations";
   views move nothing;
3. collectives: the result's bytes per op class, with the reference's ring
   wire-byte estimate from the group size the op names;
4. loops: a trace unrolls Python loops, so ``n_while`` is 0 and ``max_trip``
   1: a loop's trips are all in the graph.

The reference's ``fusion_count`` has no counterpart: eager PyTorch runs no
fusion pass, so there is nothing to count.
"""
from __future__ import annotations

import dataclasses
import operator
from collections import defaultdict

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# (op namespace, op name) -> the reference's collective class
_CLASSES = {
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "all_gather_into_tensor_coalesced"): "all-gather",
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_reduce_coalesced"): "all-reduce",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "reduce_scatter_tensor_coalesced"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("c10d", "allgather_"): "all-gather",
    ("c10d", "_allgather_base_"): "all-gather",
    ("c10d", "allreduce_"): "all-reduce",
    ("c10d", "reduce_scatter_"): "reduce-scatter",
    ("c10d", "_reduce_scatter_base_"): "reduce-scatter",
    ("c10d", "alltoall_"): "all-to-all",
    ("c10d", "alltoall_base_"): "all-to-all",
    ("c10d", "send"): "collective-permute",
    ("c10d", "recv_"): "collective-permute",
}


_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
               torch.float64: "f64", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
               torch.int32: "s32", torch.int64: "s64", torch.bool: "pred"}


@dataclasses.dataclass
class Instr:
    """One call of the traced program in the reference's fields: the node's
    name, its result's shape as HLO prints one (``f32[64,256]``, a tuple
    ``(f32[2], s32[2])``), the op's name (``mm``), its operands as text, and
    the graph it belongs to."""
    name: str
    shape: str
    opcode: str
    rest: str
    comp: str


def _shape_str(value) -> str:
    ts = _tensors(value)
    parts = [f"{_HLO_DTYPES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"
             for t in ts]
    return parts[0] if len(parts) == 1 and isinstance(value, torch.Tensor) \
        else "(" + ", ".join(parts) + ")"


def instructions(program, comp: str = "main") -> list:
    """The ``Instr`` of every op call of ``program``, in order."""
    out = []
    for node in _graph(program).nodes:
        if node.op == "call_function" and hasattr(node.target, "_schema"):
            out.append(Instr(name=node.name, shape=_shape_str(_val(node)),
                             opcode=_op_key(node.target)[1],
                             rest=", ".join(str(a) for a in node.args), comp=comp))
    return out


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    operand_bytes: dict
    wire_bytes: dict

    @property
    def total_operand_bytes(self) -> float:
        return sum(self.operand_bytes.values())

    @property
    def total_wire_bytes(self) -> float:
        return sum(self.wire_bytes.values())

    def summary(self) -> str:
        rows = []
        for op in sorted(self.counts):
            rows.append(f"{op}: n={self.counts[op]:.0f} "
                        f"bytes={self.operand_bytes[op]:.3e} "
                        f"wire/dev={self.wire_bytes[op]:.3e}")
        return "; ".join(rows) if rows else "no collectives"


@dataclasses.dataclass
class ModuleAnalysis:
    dot_flops: float
    hbm_bytes: float
    collectives: CollectiveStats
    n_while: int
    max_trip: int
    dot_count: float


def _graph(program) -> torch.fx.Graph:
    return program.graph if hasattr(program, "graph") else program


def _tensors(value) -> list:
    """The tensors of a node's value (a tensor, or a list/tuple of them)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, (list, tuple)):
        return [t for v in value for t in _tensors(v)]
    return []


def _nbytes(value) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(value))


def _val(node):
    return node.meta.get("val") if isinstance(node, torch.fx.Node) else node


def _args_vals(node) -> tuple:
    def conv(a):
        if isinstance(a, torch.fx.Node):
            return _val(a)
        if isinstance(a, (list, tuple)):
            return type(a)(conv(x) for x in a)
        return a
    return conv(node.args), {k: conv(v) for k, v in node.kwargs.items()}


def _flat_nodes(x) -> list:
    if isinstance(x, torch.fx.Node):
        return [x]
    if isinstance(x, (list, tuple)):
        return [n for v in x for n in _flat_nodes(v)]
    if isinstance(x, dict):
        return [n for v in x.values() for n in _flat_nodes(v)]
    return []


def _operand_nodes(node) -> list:
    return _flat_nodes(node.args) + _flat_nodes(node.kwargs)


def _op_key(target):
    ns = getattr(target, "namespace", None)
    packet = getattr(target, "_overloadpacket", None)
    name = getattr(packet, "__name__", None)
    return (ns, name.split(".")[-1] if name else None)


def is_view(target) -> bool:
    """An op whose result aliases an operand without writing it (a view)."""
    schema = getattr(target, "_schema", None)
    if schema is None:
        return False
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in schema.returns)


def _aliases(target) -> bool:
    """An op whose result aliases an operand (a view or an in-place op)."""
    schema = getattr(target, "_schema", None)
    return schema is not None and any(r.alias_info is not None for r in schema.returns)


def _group_size(node) -> int:
    """The group size a collective names: an argument, or its group's size
    (the group alive while the trace is analysed)."""
    ns, name = _op_key(node.target)
    args, kwargs = _args_vals(node)
    if name in ("all_gather_into_tensor", "all_gather_into_tensor_coalesced",
                "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced"):
        return max(int(args[-2]), 1)
    rest = list(args) + list(kwargs.values())
    if ns == "_c10d_functional":   # the group's name is the last string
        from torch.distributed.distributed_c10d import _resolve_process_group
        name = [a for a in rest if isinstance(a, str)][-1]
        return max(_resolve_process_group(name).size(), 1)
    for a in rest:                 # c10d: the process group object
        if not isinstance(a, torch.Tensor) and callable(getattr(a, "size", None)):
            try:
                return max(int(a.size()), 1)
            except (TypeError, RuntimeError):
                continue
    return 1


def _flops(node) -> float:
    from torch.utils.flop_counter import flop_registry
    packet = getattr(node.target, "_overloadpacket", None)
    if packet not in flop_registry:
        return -1.0
    args, kwargs = _args_vals(node)
    return float(flop_registry[packet](*args, **kwargs, out_val=_val(node)))


def analyze_module(program) -> ModuleAnalysis:
    """``program``: an FX ``GraphModule`` or ``Graph`` traced with fake
    values (``make_fx(..., tracing_mode="fake")`` or under a
    ``FakeTensorMode``)."""
    dot_flops = dot_count = hbm = 0.0
    ccounts: dict = defaultdict(float)
    cbytes: dict = defaultdict(float)
    cwire: dict = defaultdict(float)
    for node in _graph(program).nodes:
        if node.op != "call_function" or not hasattr(node.target, "_schema"):
            continue
        op = _CLASSES.get(_op_key(node.target))
        if op is not None:
            b = float(_nbytes(_val(node)))
            n = _group_size(node)
            ccounts[op] += 1
            cbytes[op] += b
            if op == "all-reduce":
                w = 2 * (n - 1) / max(n, 1) * b
            elif op in ("all-gather", "reduce-scatter", "all-to-all"):
                w = (n - 1) / max(n, 1) * b
            else:
                w = b
            cwire[op] += w
            continue
        f = _flops(node)
        if f >= 0:
            dot_flops += f
            dot_count += 1
        if not is_view(node.target):
            hbm += _nbytes(_val(node)) + sum(_nbytes(_val(a)) for a in _operand_nodes(node))
    coll = CollectiveStats(counts=dict(ccounts), operand_bytes=dict(cbytes),
                           wire_bytes=dict(cwire))
    return ModuleAnalysis(dot_flops=dot_flops, hbm_bytes=hbm, collectives=coll,
                          n_while=0, max_trip=1, dot_count=dot_count)


def pointwise_flops(program) -> float:
    """One flop a result element of every pointwise op (``torch.Tag.
    pointwise``): with ``dot_flops``, the trace's counterpart of XLA's
    ``cost_analysis()["flops"]``, which counts elementwise work too."""
    total = 0.0
    for node in _graph(program).nodes:
        if node.op == "call_function" and torch.Tag.pointwise in getattr(node.target, "tags", ()):
            total += sum(t.numel() for t in _tensors(_val(node)))
    return total


@dataclasses.dataclass
class MemoryStats:
    """``compiled.memory_analysis()``'s counterpart, per rank, in bytes:
    the arguments (the rank's local blocks), the outputs, and the peak of
    the intermediates live at once in node order."""
    argument_size_in_bytes: int
    output_size_in_bytes: int
    temp_size_in_bytes: int


def memory_analysis(program) -> MemoryStats:
    """A liveness walk over the graph in node order: a value is live from
    the node that makes it to its storage's last use (a value nothing reads
    dies at once); views, in-place results and the items of a tuple share
    their operand's storage; arguments and outputs are not temporaries."""
    nodes = list(_graph(program).nodes)
    owner: dict = {}
    last: dict = {}
    args = outs = 0
    out_owners: set = set()
    for i, node in enumerate(nodes):
        if node.op == "placeholder":
            owner[node] = node
            args += _nbytes(_val(node))
        elif node.op == "output":
            returned = _operand_nodes(node)
            outs = sum(_nbytes(_val(a)) for a in returned)
            out_owners = {owner[a] for a in returned if a in owner}
            continue
        else:
            ops = _operand_nodes(node)
            src = ops[0] if node.target is operator.getitem and ops else next(
                (a for a in ops if isinstance(_val(a), torch.Tensor)), None)
            alias = node.target is operator.getitem or _aliases(node.target)
            owner[node] = owner.get(src, node) if alias and src is not None else node
        # a value no node reads dies where it is made
        last[owner[node]] = max(last.get(owner[node], i), i)
        for a in _operand_nodes(node):
            if a in owner:
                last[owner[a]] = i
    live = peak = 0
    frees: dict = defaultdict(list)
    for o, i in last.items():
        frees[i].append(o)
    for i, node in enumerate(nodes):
        if node.op == "call_function" and owner.get(node) is node and node not in out_owners:
            live += _nbytes(_val(node))
            peak = max(peak, live)
        for o in frees.get(i, ()):
            if o.op != "placeholder" and o not in out_owners:
                live -= _nbytes(_val(o))
    return MemoryStats(argument_size_in_bytes=int(args), output_size_in_bytes=int(outs),
                       temp_size_in_bytes=int(peak))


def parse_collectives(program) -> CollectiveStats:
    """The collective stats of ``analyze_module``."""
    return analyze_module(program).collectives


def count_op(program, opname: str) -> int:
    """Calls of the op ``opname`` (an aten op's name, ``"mm"``)."""
    return sum(ins.opcode == opname for ins in instructions(program))

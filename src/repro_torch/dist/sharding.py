"""Rule-based sharding specs, and the device mesh of the port.

Model code never names mesh axes. It speaks two symbols:

* ``DP``: the data-parallel direction, every mesh axis that is not the
  model axis;
* ``TP``: the tensor-parallel direction, the ``"model"`` axis.

Each architecture ships a table of ``Rule``s (a regex over the "/"-joined
parameter path -> a symbolic spec for the *trailing* dims). ``spec_tree``
matches them against a parameter tree with the **divisibility fallback**:
a dim that does not divide its mesh axes is replicated instead (3 kv heads
on tp=4 -> KV replication), so one rule table serves every mesh.
``bind_shardings`` resolves the symbolic tree against a mesh into the
``(mesh, placements)`` that ``torch.distributed.tensor.distribute_tensor``
takes.

**The contract that replaces ``shard_map``.** The reference is
single-controller: one process owns every device of a ``jax`` mesh. The
port is SPMD over ``torch.distributed``, one rank per device:

* ``make_mesh(shape, axis_names)`` is the port's ``jax.make_mesh``: a
  ``DeviceMesh`` over the initialized world. With no process group
  initialized and a one-rank shape it initializes a one-rank group over an
  in-memory ``HashStore``, so one process needs no environment variables.
  The backend is NCCL on ``"cuda"`` and gloo on ``"cpu"`` unless
  ``backend=`` names another; nothing falls back to another device or
  backend unasked. (Two ranks that share one card need ``backend="gloo"``:
  NCCL refuses two ranks on one device.)
* Every rank makes the same call with the same arguments in the same order
  (``sharded_range_search``, the collective helpers, ``RangeServer.step``),
  global queries, radii, filters, tombstones and requests alike, and every
  rank gets back the same global result, as the reference's caller gets one
  global array.
* A rank's device holds only its own shards: a ``ShardedCorpus`` built for
  a mesh holds the shards at its model coordinate, where ``shard_map``'s
  ``P(model_axis, ...)`` in-specs would put them.

``mesh_axes`` and ``_axis_size`` read only a mesh's ``mesh_dim_names`` and
``shape``, so the shape logic needs no process group.

**Activations.** ``shard_activation(x, DP, TP, None)`` inside an
``activation_sharding(mesh)`` scope redistributes the DTensor ``x`` to the
resolved layout (the reference's ``with_sharding_constraint``); outside
any scope it is the identity, which keeps the model code mesh-agnostic and
every single-device result bit for bit what it was. Inside a scope of more
than one rank a plain tensor raises ``TypeError``: it is a value that
should have been distributed and was not, and it must not be computed
unsharded in silence. ``replicate_like`` makes a plain constant (rope
tables, masks, an iota) a replicated DTensor on a DTensor's mesh, so the
two mix; on plain tensors it is the identity.
"""
from __future__ import annotations

import dataclasses
import re
import threading
from contextlib import contextmanager
from typing import Any, Sequence, Union

import numpy as np
import torch

# Symbolic axes: plain strings that never collide with real mesh axis names.
DP = "dp"
TP = "tp"

AxisSym = Union[str, tuple, None]

MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True)
class Rule:
    """``pattern`` is a regex over the "/"-joined param path; ``spec`` is a
    symbolic spec for the *trailing* dims of any matching leaf (leading
    dims, such as scan or expert stacking, replicate)."""

    pattern: str
    spec: tuple

    def matches(self, path: str) -> bool:
        return re.fullmatch(self.pattern, path) is not None


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

def make_mesh(shape, axis_names=("data", "model"), *, device_type: str = "cuda",
              backend=None):
    """A ``DeviceMesh`` of ``shape`` named ``axis_names`` over the ranks of
    the initialized world (rank-major, as ``jax.make_mesh`` lays devices
    out). With no process group and a one-rank shape, a one-rank group over
    a ``HashStore`` is initialized first. ``backend`` defaults to NCCL on
    ``"cuda"`` and gloo on ``"cpu"``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axis names {axis_names}")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device type {device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' to "
                           "run on the CPU")
    size = int(np.prod(shape))
    if not dist.is_initialized():
        if size != 1:
            raise RuntimeError(
                f"a {size}-rank mesh needs an initialized process group "
                "(torch.distributed.init_process_group on every rank)")
        dist.init_process_group(
            backend or ("nccl" if device_type == "cuda" else "gloo"),
            store=dist.HashStore(), rank=0, world_size=1)
    elif size != dist.get_world_size():
        raise ValueError(f"mesh of {size} ranks over a world of "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(size).reshape(shape),
                      mesh_dim_names=tuple(axis_names))


# ---------------------------------------------------------------------------
# Mesh introspection
# ---------------------------------------------------------------------------

def _shape(mesh) -> dict:
    """{axis name: size}: the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in tuple(mesh.shape))))


def mesh_axes(mesh):
    """(dp, tp): tp is the model axis; dp is every other axis (a bare name
    for one axis, a tuple for several)."""
    names = tuple(mesh.mesh_dim_names)
    tp = MODEL_AXIS if MODEL_AXIS in names else names[-1]
    dp_axes = tuple(a for a in names if a != tp)
    dp = dp_axes[0] if len(dp_axes) == 1 else dp_axes
    return dp, tp


def _axis_size(mesh, axes) -> int:
    axes = axes if isinstance(axes, tuple) else (axes,)
    shape = _shape(mesh)
    return int(np.prod([shape[a] for a in axes])) if axes else 1


def _resolve(sym: AxisSym, mesh):
    """Symbolic entry -> concrete mesh axis name(s) (or None)."""
    if sym is None:
        return None
    dp, tp = mesh_axes(mesh)
    if isinstance(sym, tuple):
        out: list = []
        for s in sym:
            r = _resolve(s, mesh)
            if r is None:
                continue
            out.extend(r if isinstance(r, tuple) else (r,))
        return tuple(out) if out else None
    if sym == DP:
        return dp
    if sym == TP:
        return tp
    if sym in mesh.mesh_dim_names:
        return sym
    raise ValueError(f"unknown sharding axis {sym!r} for mesh {mesh.mesh_dim_names}")


# ---------------------------------------------------------------------------
# spec_tree: rules x params -> symbolic spec tree (divisibility fallback)
# ---------------------------------------------------------------------------

def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _leaf_spec(path: str, leaf, rules: Sequence[Rule], mesh) -> tuple:
    shape = tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)
    ndim = len(shape)
    spec: list = [None] * ndim
    for rule in rules:
        if not rule.matches(path):
            continue
        tail = tuple(rule.spec)[-ndim:] if ndim else ()
        for i, sym in enumerate(tail, start=ndim - len(tail)):
            if sym is None:
                continue
            size = _axis_size(mesh, _resolve(sym, mesh) or ())
            # divisibility fallback: replicate instead of shard
            if size > 1 and shape[i] % size == 0 and shape[i] > 0:
                spec[i] = sym
        break  # first matching rule wins
    return tuple(spec)


class Spec(tuple):
    """One leaf's symbolic spec. A distinct type (not a bare tuple) so
    ``bind_shardings`` can tell a spec from a list/tuple container of
    specs."""

    __slots__ = ()


def _is_leaf(node) -> bool:
    return isinstance(node, (torch.Tensor, torch.Size, np.ndarray))


def _map_with_path(fn, tree, path=()):
    if _is_leaf(tree):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    raise TypeError(f"cannot walk a {type(tree).__name__} in a parameter tree")


def spec_tree(params: Any, rules: Sequence[Rule], mesh) -> Any:
    """Symbolic spec tree matching ``params`` (nested dicts and lists of
    tensors or ``torch.Size``s): one ``Spec`` of DP/TP/None per leaf (full
    rank), matched on the reference's "/"-joined paths."""
    return _map_with_path(
        lambda path, leaf: Spec(_leaf_spec(_path_str(path), leaf, rules, mesh)), params)


def _is_spec(node) -> bool:
    """Hand-written plain tuples/lists of symbols also count as specs
    (``()`` = fully replicated), but never a container holding ``Spec``s."""
    if isinstance(node, Spec):
        return True
    return isinstance(node, (tuple, list)) and all(
        n is None or isinstance(n, str) or
        (isinstance(n, tuple) and not isinstance(n, Spec)
         and all(isinstance(s, str) for s in n))
        for n in node)


def _placements(mesh, spec) -> tuple:
    """A JAX-style spec (mesh axes per tensor dim) as DTensor placements (a
    tensor dim per mesh dim): ``(None, (DP, TP), None)`` -> ``(Shard(1),
    Shard(1))``. Two mesh dims on one tensor dim shard it major-to-minor in
    the spec's order, as ``PartitionSpec`` does."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    for dim, sym in enumerate(spec):
        axes = _resolve(sym, mesh)
        if axes is None:
            continue
        idx = [names.index(a) for a in (axes if isinstance(axes, tuple) else (axes,))]
        if idx != sorted(idx):
            raise NotImplementedError(
                f"spec {tuple(spec)} shards dim {dim} over mesh axes out of the "
                "mesh's order; DTensor's placements cannot express it")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def bind_shardings(mesh, specs: Any) -> Any:
    """Symbolic spec tree -> ``(mesh, placements)`` tree, each leaf what
    ``distribute_tensor(tensor, *leaf)`` takes. ``Spec`` leaves (and plain
    tuples of symbols, e.g. ``()``) bind; dicts and containers recurse."""
    if _is_spec(specs):
        return mesh, _placements(mesh, specs)
    if isinstance(specs, dict):
        return {k: bind_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, (list, tuple)):
        return type(specs)(bind_shardings(mesh, v) for v in specs)
    raise TypeError(f"cannot bind shardings for {specs!r}")


# ---------------------------------------------------------------------------
# Activation sharding (training and MoE)
# ---------------------------------------------------------------------------

class _Scope(threading.local):
    def __init__(self):
        self.mesh = None


_SCOPE = _Scope()


@contextmanager
def activation_sharding(mesh):
    """Within this scope, ``shard_activation`` pins layouts on ``mesh``."""
    prev, _SCOPE.mesh = _SCOPE.mesh, mesh
    try:
        yield mesh
    finally:
        _SCOPE.mesh = prev


def current_mesh():
    return _SCOPE.mesh


def _mesh_size(mesh) -> int:
    return int(np.prod(tuple(mesh.shape)))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard_activation(x, *axes: AxisSym):
    """``x`` redistributed to the symbolic ``axes`` with the divisibility
    fallback; the identity outside an ``activation_sharding`` scope.
    ``axes`` cover the leading dims (trailing dims replicate); a spec that
    shards no dim leaves ``x``'s layout as it is, as the reference sets no
    constraint then, but for a partial sum, which is reduced (torch 2.11
    cannot add a partial sum to a sharded tensor)."""
    mesh = _SCOPE.mesh
    if mesh is None:
        return x
    if not is_dtensor(x):
        if _mesh_size(mesh) > 1:
            raise TypeError(
                f"shard_activation got a plain {type(x).__name__} of shape "
                f"{tuple(x.shape)} inside a {_mesh_size(mesh)}-rank mesh scope; "
                "a value on the mesh must be a DTensor")
        return x
    spec = _activation_spec(mesh, x.shape, axes)
    if not any(s is not None for s in spec):   # no constraint; a partial sum is reduced
        if not any(pl.is_partial() for pl in x.placements):
            return x
        from torch.distributed.tensor import Replicate
        return x.redistribute(x.device_mesh, [Replicate() if pl.is_partial() else pl
                                              for pl in x.placements])
    placements = _placements(mesh, spec)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def _activation_spec(mesh, shape, axes) -> list:
    """The mesh axes of ``axes`` for the leading dims of ``shape``, a dim
    that does not divide its axes left unsharded, as is one whose axes hold
    a single rank (a shard of one is the whole: DTensor would still refuse
    views across it)."""
    spec = []
    for i, sym in enumerate(axes[: len(shape)]):
        r = _resolve(sym, mesh)
        if r is not None and (_axis_size(mesh, r) == 1 or shape[i] % _axis_size(mesh, r)):
            r = None  # divisibility fallback: leave the dim unsharded
        spec.append(r)
    return spec


def lay_out(x, *axes: AxisSym):
    """The DTensor ``x`` laid out exactly as the symbolic ``axes`` say for
    its leading dims (``shard_activation``'s spec), every other dim and
    mesh axis replicated, a ``Partial`` reduced; a plain tensor as it is.
    ``lay_out(h, DP)`` gathers a sequence-sharded activation before a
    product folds (batch, sequence) into one dim, which DTensor's view
    rule refuses when both dims are sharded (torch 2.11)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    placements = _placements(mesh, _activation_spec(mesh, x.shape, axes))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(mesh, placements)


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def local_block(x: torch.Tensor) -> torch.Tensor:
    """``x.to_local()`` to compute on, its gradient made contiguous on the
    way back where the mesh has more than one rank: the gradient re-enters
    ``x`` as a DTensor with ``x``'s strides, and a transposed local
    gradient would break that DTensor's later views. On one rank the block
    is the whole and its gradient goes back as it is, as on a plain
    tensor (a copy would change the products' layouts, and with them the
    last bits of a bf16 step)."""
    local = x.to_local()
    return local if _mesh_size(x.device_mesh) == 1 else _ContiguousGrad.apply(local)


class _GradLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.placements:
            grad = grad.redistribute(grad.device_mesh, ctx.placements)
        return grad


def grad_fence(x):
    """``x`` (a DTensor) as it is, its gradient laid out as ``x`` on the way
    back, whatever layout the product that reads it gives the gradient: a
    reshape's backward then splits or folds only what its forward did
    (DTensor's view rule in torch 2.11 refuses to split a dim sharded across
    a head). A plain tensor goes straight through."""
    return _GradLayout.apply(x) if is_dtensor(x) else x


def _partial_over_dp(mesh, rows_split: bool) -> tuple:
    """Placements of a per-rank partial result: a partial sum over the DP
    mesh dims when the rows are split over DP, replicated elsewhere."""
    from torch.distributed.tensor import Partial, Replicate
    dp, _ = mesh_axes(mesh)
    names = tuple(mesh.mesh_dim_names)
    dp_dims = {names.index(a) for a in (dp if isinstance(dp, tuple) else (dp,))}
    return tuple(Partial() if rows_split and i in dp_dims else Replicate()
                 for i in range(mesh.ndim))


def gathered(w, rows_split: bool) -> torch.Tensor:
    """The whole of the DTensor weight ``w`` as a plain tensor, for a
    computation on each rank's rows: its gradient, on the way back, a
    partial sum over DP when the rows are split over DP (each rank's rows
    give a part of it), else replicated."""
    from torch.distributed.tensor import Replicate
    full = w.redistribute(w.device_mesh, (Replicate(),) * w.device_mesh.ndim)
    return _ContiguousGrad.apply(full.to_local(
        grad_placements=_partial_over_dp(w.device_mesh, rows_split)))


def summed(local: torch.Tensor, mesh, rows_split: bool) -> torch.Tensor:
    """A replicated DTensor on ``mesh``: the sum over DP of each rank's
    ``local`` (a plain tensor) when the rows are split over DP, else
    ``local`` itself. (A plain tensor joined to a DTensor loss would take a
    DTensor gradient into plain operations on the way back.)"""
    from torch.distributed.tensor import DTensor, Replicate
    out = DTensor.from_local(local, mesh, _partial_over_dp(mesh, rows_split), run_check=False)
    return out.redistribute(mesh, (Replicate(),) * mesh.ndim) if rows_split else out


def on_replicas(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with every DTensor argument gathered whole
    (replicated) and passed as its local copy; a tensor result comes back
    a replicated DTensor on their mesh. For a function DTensor's sharding
    rules cannot take whatever the layout (the GCN's index-adds over an
    edge list); plain arguments go straight through."""
    dts = [a for a in list(args) + list(kwargs.values()) if is_dtensor(a)]
    if not dts:
        return fn(*args, **kwargs)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = dts[0].device_mesh
    rep = (Replicate(),) * mesh.ndim

    def local(a):
        return local_block(a.redistribute(mesh, rep)) if is_dtensor(a) else a
    out = fn(*(local(a) for a in args), **{k: local(v) for k, v in kwargs.items()})
    return DTensor.from_local(out.contiguous(), mesh, rep, run_check=False)


def on_local_rows(fn, x, *args):
    """``fn(x, *args)`` for a function of each row of ``x`` alone (a tensor
    result with one row a row of ``x``): on a DTensor, run on each rank's
    rows, ``x`` laid out batch over DP and whole otherwise, the result laid
    out the same; a plain ``x`` goes straight through."""
    if not is_dtensor(x):
        return fn(x, *args)
    from torch.distributed.tensor import DTensor
    x = lay_out(x, DP)
    return DTensor.from_local(fn(local_block(x), *args).contiguous(), x.device_mesh,
                              x.placements, run_check=False)


def zeros_on(shape, dtype, like, *axes: AxisSym) -> torch.Tensor:
    """Zeros of ``shape`` on ``like``'s device; when ``like`` is a DTensor,
    a DTensor on its mesh laid out by the symbolic ``axes`` (as
    ``shard_activation``'s), each rank allocating only its block."""
    if not is_dtensor(like):
        return torch.zeros(shape, dtype=dtype, device=like.device)
    from torch.distributed.tensor import zeros
    mesh = like.device_mesh
    return zeros(tuple(shape), dtype=dtype, device_mesh=mesh,
                 placements=_placements(mesh, _activation_spec(mesh, shape, axes)))


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]``: each row's entry at its index along the last dim
    (the CE losses' label logit). On a DTensor the last dim may be sharded,
    where DTensor's gather is wrong (its masked partial), so the entry is
    selected by a replicated iota and summed: one nonzero term, the same
    value."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    iota = replicate_like(torch.arange(x.shape[-1], device=x.device), x)
    return torch.sum(torch.where(idx[..., None] == iota, x,
                                 torch.zeros((), dtype=x.dtype, device=x.device)), -1)


def lookup_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a (V, d) table. A DTensor table is looked up by
    ``F.embedding``, whose sharding rule takes a table sharded by rows
    (a masked partial sum over the row shards): its columns are gathered
    first where they are sharded (the LM token table's d over DP); rows
    sharded over two mesh axes at once are taken as they are. The rows come
    back laid out as ``ids``, the partial sum reduced at once."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Replicate
    placements = tuple(Replicate() if pl.is_shard(1) else pl for pl in table.placements)
    if placements != tuple(table.placements):
        table = table.redistribute(table.device_mesh, placements)
    rows = torch.nn.functional.embedding(ids, table)
    return rows.redistribute(rows.device_mesh, ids.placements)


def replicate_like(t: torch.Tensor, like) -> torch.Tensor:
    """``t`` (a plain tensor equal on every rank: a constant) as a DTensor
    replicated on ``like``'s mesh when ``like`` is a DTensor; else ``t``."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim, run_check=False)


# ---------------------------------------------------------------------------
# Rule tables (consumed by configs/*.py)
# ---------------------------------------------------------------------------

# LM params: FSDP over dp (d_model / reduction dims), Megatron TP over heads
# / ffn / experts / vocab. Norms and biases replicate via the catch-all.
LM_RULES = [
    Rule(r".*attn/w[qkv]", (DP, TP, None)),          # (D, H|Hkv, dh)
    Rule(r".*attn/wo", (TP, None, DP)),              # (H, dh|dv, D)
    Rule(r".*attn/w_dq", (DP, TP)),                  # (D, q_lora)
    Rule(r".*attn/w_dkv", (DP, TP)),                 # (D, kv_lora)
    Rule(r".*attn/w_u[qkv]", (DP, TP, None)),        # (lora, H, d)
    Rule(r".*attn/w_kr", (DP, None)),                # (D, rope_dim): tiny
    Rule(r".*moe/router", (DP, None)),               # (D, E): E rarely /: tp
    Rule(r".*moe/shared/w_(gate|up)", (DP, TP)),     # (D, Fs)
    Rule(r".*moe/shared/w_down", (TP, DP)),          # (Fs, D)
    Rule(r".*moe/w_(gate|up)", (TP, DP, None)),      # (E, D, F): EP over tp
    Rule(r".*moe/w_down", (TP, None, DP)),           # (E, F, D)
    Rule(r".*mlp/w_(gate|up)", (DP, TP)),            # (D, F)
    Rule(r".*mlp/w_down", (TP, DP)),                 # (F, D)
    Rule(r".*(embed|unembed)", (TP, DP)),            # (V, D): vocab over tp
    Rule(r".*", ()),                                 # norms/biases replicate
]

# RecSys params: the (F, V, d) field tables row-shard V over the whole mesh;
# MLP towers are FSDP x TP.
RECSYS_RULES = [
    Rule(r".*tables|.*wide", (None, (DP, TP), None)),  # (F, V, d) row-sharded
    Rule(r"(.*/)?w\d+", (DP, TP)),                     # tower matmuls
    Rule(r".*", ()),                                   # biases etc.
]

# GNN params: tiny dense weights; shard where divisible, replicate otherwise.
GNN_RULES = [
    Rule(r"(.*/)?w\d+", (DP, TP)),
    Rule(r".*", ()),
]

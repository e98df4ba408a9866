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

``activation_sharding`` and ``shard_activation`` (the reference's
activation layout pins) serve the mesh trainer (``Trainer(mesh=,
param_rules=)``), which is not ported: ROADMAP.md §1, item 10. Outside a
mesh scope the reference's pins are identities, and the port's
single-device models leave them out.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Sequence, Union

import numpy as np
import torch

# Symbolic axes: plain strings that never collide with real mesh axis names.
DP = "dp"
TP = "tp"

AxisSym = Union[str, tuple, None]

MODEL_AXIS = "model"

MESH_TRAINER = "ROADMAP.md §1 item 10 (the mesh trainer)"


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

def activation_sharding(mesh):
    raise NotImplementedError(f"activation_sharding is not ported yet: {MESH_TRAINER}")


def shard_activation(x, *axes: AxisSym):
    raise NotImplementedError(f"shard_activation is not ported yet: {MESH_TRAINER}")


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

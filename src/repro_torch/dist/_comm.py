"""The collectives the port's multi-device layer runs, over the process
group of one mesh axis (or of the whole mesh).

Every payload goes through these wrappers, so the one backend rule lives in
one place: **gloo carries CUDA tensors through host memory.** gloo has CUDA
implementations of only some collectives and none of point-to-point sends,
so over a gloo group a payload on a card is copied to the host, the
collective runs on the host copy, and the result is copied back. Only ranks
that share one card run gloo on CUDA tensors (NCCL refuses two ranks on one
device); NCCL, and gloo on CPU tensors, take each collective directly.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_group(mesh, axes):
    """The process group spanning ``axes`` of ``mesh``: one axis name, or a
    tuple naming every axis (the whole mesh, which the port's meshes make
    of the whole world, rank-major)."""
    axes = axes if isinstance(axes, tuple) else (axes,)
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    if sorted(axes) == sorted(names):
        if mesh.size() != dist.get_world_size():
            raise NotImplementedError("a group over every axis of a mesh smaller "
                                      "than the world")
        return dist.group.WORLD
    raise NotImplementedError(f"a group over axes {axes} of a mesh of {names}")


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape on each), in the group's rank order."""
    host = _via_host(t, group)
    src = t.cpu() if host else t.contiguous()
    out = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out] if host else out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of every rank's ``t``, as a new tensor."""
    buf = t.cpu() if _via_host(t, group) else t.clone()
    dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
    return buf.to(t.device)


def ring_shift(t: torch.Tensor, group) -> torch.Tensor:
    """One ring hop: send ``t`` to the next rank of the group and receive
    the previous rank's (``ppermute`` over the pairs ``(i, i + 1 mod n)``),
    as one ``batch_isend_irecv``."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    host = _via_host(t, group)
    idx = dist.get_rank(group)
    send = t.cpu() if host else t.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, (idx + 1) % n), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, (idx - 1) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv.to(t.device)

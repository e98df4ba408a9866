"""Every cell of the cell builder as JSON, in one package's terms, so the
reference's cells and the port's compare leaf by leaf.

    python tests/_torch_cells_dump.py jax 16x16     # 256 forced CPU devices
    python tests/_torch_cells_dump.py torch 16x16   # torch's fake process group

prints one JSON object {"arch/shape": description}. A description holds
``args`` ({path: [shape, dtype]}), ``in``/``out`` ({path: placements},
one entry a mesh axis: "S<dim>" or "R"), ``donate``, ``meta`` and
``flops`` (``analytic_model_flops`` over the cell's ``args[0]``), and
``mesh_devices`` the mesh's device count. Paths are
"/"-joined dict keys, sequence indices and dataclass field names.
``describe_jax`` and ``describe_torch`` give the same in process for any
mesh of their package, or one cell's description for a given ArchSpec and
shape name; ``flat_jax`` and ``flat_torch`` are the two path walks.
"""
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def flat_jax(tree) -> dict:
    """{path: leaf} of a JAX pytree."""
    import jax

    def key(k) -> str:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    return {"/".join(key(k) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_torch(tree, path=()) -> dict:
    """{path: leaf} of a tree of the port's (dicts in sorted key order,
    lists, tuples, dataclasses): a tensor or a ``(mesh, placements)``
    binding is a leaf, None is no leaf."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(tree, torch.Tensor) or (
            isinstance(tree, tuple) and len(tree) == 2 and isinstance(tree[0], DeviceMesh)):
        return {"/".join(path): tree}
    if tree is None:
        return {}
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    elif dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    else:
        raise TypeError(type(tree))
    out = {}
    for k, v in items:
        out.update(flat_torch(v, path + (str(k),)))
    return out


def _flops(roofline, arch, cell):
    return float(roofline.analytic_model_flops(arch, arch.shapes[cell.shape_name],
                                               cell.args[0]))


def describe_jax(mesh, arch=None, shape_name=None) -> dict:
    from repro.analysis import roofline
    from repro.configs import all_cells, get_arch
    from repro.launch.steps import build_cell
    flat = flat_jax

    def placements(ns) -> list:
        spec = tuple(ns.spec)
        out = []
        for axis in ns.mesh.axis_names:
            dims = [i for i, s in enumerate(spec)
                    if s == axis or (isinstance(s, tuple) and axis in s)]
            out.append(f"S{dims[0]}" if dims else "R")
        return out

    def one(arch, sh):
        cell = build_cell(arch, sh, mesh)
        return {
            "args": {p: [list(x.shape), _dtype(x.dtype)] for p, x in flat(cell.args).items()},
            "in": {p: placements(s) for p, s in flat(cell.in_shardings).items()},
            "out": {p: placements(s) for p, s in flat(cell.out_shardings).items()},
            "donate": list(cell.donate), "meta": dict(cell.meta),
            "flops": _flops(roofline, arch, cell)}

    if arch is not None:
        return one(arch, shape_name)
    return {f"{aid}/{sh}": one(get_arch(aid), sh) for aid, sh in all_cells(include_engine=True)}


def describe_torch(mesh, arch=None, shape_name=None) -> dict:
    from torch.distributed.tensor import Shard
    from repro_torch.analysis import roofline
    from repro_torch.configs import all_cells, get_arch
    from repro_torch.launch.steps import build_cell
    flat = flat_torch

    def placements(binding) -> list:
        return [f"S{p.dim}" if isinstance(p, Shard) else "R" for p in binding[1]]

    def one(arch, sh):
        cell = build_cell(arch, sh, mesh)
        return {
            "args": {p: [list(x.shape), _dtype(x.dtype)] for p, x in flat(cell.args).items()},
            "in": {p: placements(s) for p, s in flat(cell.in_shardings).items()},
            "out": {p: placements(s) for p, s in flat(cell.out_shardings).items()},
            "donate": list(cell.donate), "meta": dict(cell.meta),
            "flops": _flops(roofline, arch, cell)}

    if arch is not None:
        return one(arch, shape_name)
    return {f"{aid}/{sh}": one(get_arch(aid), sh) for aid, sh in all_cells(include_engine=True)}


def main(side: str, mesh_name: str) -> None:
    data, model = (int(x) for x in mesh_name.split("x"))
    sys.path.insert(0, os.path.join(ROOT, "src"))
    production = (data, model) == (16, 16)
    if side == "jax":
        os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={data * model}"
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        from repro.launch.mesh import make_host_mesh, make_production_mesh, mesh_devices
        mesh = make_production_mesh() if production else make_host_mesh(data, model)
        out = describe_jax(mesh)
    else:
        import torch
        import torch.distributed as dist
        from torch.testing._internal.distributed.fake_pg import FakeStore
        from repro_torch.launch.mesh import make_host_mesh, make_production_mesh, mesh_devices
        torch.set_num_threads(1)
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=data * model)
        try:
            mesh = (make_production_mesh(device_type="cpu") if production
                    else make_host_mesh(data, model))
            out = describe_torch(mesh)
        finally:
            dist.destroy_process_group()
    out["mesh_devices"] = mesh_devices(mesh)
    print(json.dumps(out))


if __name__ == "__main__":
    main(*sys.argv[1:3])

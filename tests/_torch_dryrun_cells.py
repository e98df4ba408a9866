"""The port's dry run on one cell of each of the nine kinds, at each arch's
``reduced()`` and ``tests/test_torch_cells.py``'s cut shapes, on a fake
2 x 2 and a fake (1, 1) mesh (torch's fake process group: shapes only).

    python tests/_torch_dryrun_cells.py

prints one JSON object {"2x2": cells, "1x1": cells}; a cell holds its
``kind``, its ``report`` (``RooflineReport.to_json()``), ``collectives``
(the count of collective calls in its trace), the ``mesh`` sizes, and its
arguments: ``args`` ({path: [shape, itemsize]}) and ``in`` ({path:
placements, "S<dim>" or "R" a mesh axis}). It imports no JAX.
"""
import dataclasses
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("wide-deep/train_batch", "qwen3-14b/prefill_32k", "qwen3-14b/decode_32k",
         "wide-deep/serve_p99", "wide-deep/retrieval_cand", "gcn-cora/full_graph_sm",
         "gcn-cora/minibatch_lg", "gcn-cora/molecule", "range-engine/search_4k")
# tests/test_torch_cells.py's cut shapes
REDUCED_SHAPE = dict(seq_len=16, global_batch=2, n_candidates=2048, n_nodes=64,
                     n_edges=256, d_feat=16, batch_nodes=4, n_graphs=4, nodes_per_graph=6,
                     edges_per_graph=10)
REDUCED_FANOUT = (3, 2)
REDUCED_KV = 32


def _reduced(arch, name):
    shape = arch.shapes[name]
    kw = {k: min(getattr(shape, k), v) for k, v in REDUCED_SHAPE.items()
          if getattr(shape, k, None)}
    if shape.fanout:
        kw["fanout"] = REDUCED_FANOUT
    if shape.kind == "decode":
        kw["seq_len"] = REDUCED_KV
    if shape.kind == "train" and arch.family == "lm":
        kw["global_batch"] = 2 * arch.accum_steps
    return dataclasses.replace(arch, model_cfg=arch.reduced(),
                               shapes={name: dataclasses.replace(shape, **kw)})


def _cells(data: int, model: int) -> dict:
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import fake_world, run_cell
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_cell
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from _torch_cells_dump import flat_torch
    fake_world(data * model)
    try:
        mesh = make_host_mesh(data, model)
        out = {}
        for cell_id in CELLS:
            aid, name = cell_id.split("/")
            arch = _reduced(get_arch(aid), name)
            rep = run_cell(aid, name, arch=arch, mesh=mesh, verbose=False)
            cell = build_cell(arch, name, mesh)
            args, shard = flat_torch(cell.args), flat_torch(cell.in_shardings)
            out[cell_id] = {
                "kind": arch.shapes[name].kind, "report": rep.to_json(),
                "collectives": sum(int(n) for n in re.findall(r"n=(\d+)",
                                                              rep.collective_summary)),
                "mesh": [data, model],
                "args": {p: [list(x.shape), x.element_size()] for p, x in args.items()},
                "in": {p: [f"S{pl.dim}" if isinstance(pl, Shard) else "R" for pl in b[1]]
                       for p, b in shard.items()}}
        return out
    finally:
        dist.destroy_process_group()


def main() -> None:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    torch.set_num_threads(1)
    print(json.dumps({"2x2": _cells(2, 2), "1x1": _cells(1, 1)}))


if __name__ == "__main__":
    main()

"""Roofline terms per (arch x shape x mesh), on the H100's constants.

Hardware constants (NVIDIA H100 SXM data sheet, dense rates at the 700 W
power limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM,
450 GB/s each way over NVLink per card; beside them the rates of the other
types the port's kernels compute in: 67 TFLOP/s f32 outside the tensor
cores, 495 TFLOP/s TF32, 1,979 TOP/s int8.

Terms (seconds), as the reference's:
  compute    = FLOPs            / (chips * PEAK_FLOPS)
  memory     = bytes_accessed   / (chips * HBM_BW)
  collective = collective_bytes / (chips * ICI_BW)

MODEL_FLOPS is the analytic useful-work count: 6·N·D for dense training,
6·N_active·D for MoE, 2·N·D for inference passes, with the GNN / recsys /
engine analogues documented in ``analytic_model_flops``; it runs over a
parameter tree of meta tensors (``launch.steps`` builds them), where the
reference runs over ``jax.eval_shape``'s stand-ins.

``make_report`` is the reference's arithmetic over the dry run's numbers:
``cost`` ({"flops", "bytes accessed"}) and the analysis come from the
traced per-rank program (``analysis/hlo.py``), ``mem`` from its liveness
walk (``hlo.memory_analysis``).
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Any

import numpy as np

PEAK_FLOPS = 989e12      # bf16 / card, dense tensor cores
HBM_BW = 3.35e12         # bytes/s / card
ICI_BW = 450e9           # bytes/s / card, NVLink, each way
F32_FLOPS = 67e12        # f32 / card, outside the tensor cores
TF32_FLOPS = 495e12      # tf32 / card, dense tensor cores
INT8_OPS = 1979e12       # int8 / card, dense tensor cores


# ---------------------------------------------------------------------------
# Corpus-gather roofline (the search loop's dominant term)
# ---------------------------------------------------------------------------

def corpus_bytes_per_distance(dim: int, corpus_dtype: str = "float32") -> float:
    """Device-memory bytes gathered per in-loop distance computation.

    f32/bf16 rows stream ``itemsize * dim``; the int8 quantized corpus
    streams 1-byte codes plus the [scale, |x_hat|^2, err] metadata row
    (``core.corpus.META_BYTES``, the constant ``core.corpus.bytes_per_vector``
    uses). This is the denominator of the search loop's arithmetic
    intensity: the number the quantized pipeline exists to shrink."""
    if corpus_dtype == "int8":
        from ..core.corpus import META_BYTES
        return dim + float(META_BYTES)
    return float(jnp_itemsize(corpus_dtype)) * dim


def search_arithmetic_intensity(dim: int,
                                corpus_dtype: str = "float32") -> float:
    """FLOPs per device-memory byte for the in-loop distance (l2 matmul form:
    one dot (2d) + the rank-1 norm correction (~3 flops)). The H100's
    machine balance is ``PEAK_FLOPS / HBM_BW`` ~ 295 flops/byte in bf16 and
    ``F32_FLOPS / HBM_BW`` ~ 20 in f32, so the gather term stays
    memory-bound at every storage dtype: bytes per distance, not FLOPs, set
    the QPS ceiling, and int8's ~4x byte cut is worth a guard-band rerank."""
    flops = 2.0 * dim + 3.0
    return flops / corpus_bytes_per_distance(dim, corpus_dtype)


def jnp_itemsize(dtype_name: str) -> int:
    """Bytes of one element of a corpus dtype, by name (the reference's
    name, kept so the two surfaces compare)."""
    return {"float32": 4, "bfloat16": 2, "int8": 1}[dtype_name]


@dataclasses.dataclass
class RooflineReport:
    arch_id: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float          # operand-bytes metric
    collective_wire_bytes: float     # ring wire estimate / device
    collective_summary: str
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    step_time_s: float               # max of the three terms (bound)
    mfu: float                       # model_flops / (chips*peak*step_time)
    memory_per_device: dict
    note: str = ""

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    def row(self) -> str:
        return (f"{self.arch_id:22s} {self.shape:14s} {self.mesh:10s} "
                f"c={self.compute_s:.3e} m={self.memory_s:.3e} "
                f"x={self.collective_s:.3e} dom={self.dominant:10s} "
                f"useful={self.useful_ratio:.2f} mfu~{self.mfu:.2%}")


def _count_params(tree, scale_moe: float = 1.0) -> float:
    """Matmul-participating parameter count; expert tensors scaled by
    (top_k/n_experts) when ``scale_moe`` < 1."""
    from ..layers.common import flatten_paths
    total = 0.0
    for path, leaf in flatten_paths(tree).items():
        size = float(np.prod(tuple(leaf.shape))) if len(leaf.shape) else 1.0
        if "/moe/" in f"/{path}/" and "router" not in path and "shared" not in path:
            size *= scale_moe
        total += size
    return total


def analytic_model_flops(arch, shape, params_abstract) -> float:
    """Useful-work FLOPs per step (see module docstring)."""
    fam = arch.family
    if fam == "lm":
        cfg = arch.model_cfg
        scale = (cfg.top_k / cfg.n_experts) if cfg.is_moe else 1.0
        n_active = _count_params(params_abstract, scale_moe=scale)
        if shape.kind == "train":
            return 6.0 * n_active * shape.global_batch * shape.seq_len
        if shape.kind == "prefill":
            return 2.0 * n_active * shape.global_batch * shape.seq_len
        # decode: one token/seq forward + KV-cache attention reads
        kv_flops = 4.0 * shape.global_batch * shape.seq_len * \
            cfg.n_heads * (cfg.d_head if cfg.attn_kind == "gqa" else cfg.v_head_dim)
        return 2.0 * n_active * shape.global_batch + kv_flops
    if fam == "gnn":
        cfg = arch.model_cfg
        if shape.kind == "graph_batched":
            n = shape.n_graphs * shape.nodes_per_graph
            e = shape.n_graphs * shape.edges_per_graph
            d_in = 16
        elif shape.kind == "graph_sampled":
            from ..launch.steps import sampled_caps
            n, e = sampled_caps(shape)
            d_in = shape.d_feat
        else:
            n, e = shape.n_nodes, shape.n_edges
            d_in = shape.d_feat
        dims = [d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [7]
        dense = sum(2.0 * n * dims[i] * dims[i + 1] for i in range(cfg.n_layers))
        msg = sum(2.0 * e * dims[i + 1] for i in range(cfg.n_layers))
        return 3.0 * (dense + msg)       # every GNN cell trains: fwd + bwd
    if fam == "recsys":
        from ..layers.common import flatten_paths
        emb_re = re.compile(r"(^|/)(tables|wide)(/|$)")
        n_mlp = sum(
            float(np.prod(tuple(leaf.shape))) for path, leaf in
            flatten_paths(params_abstract).items() if not emb_re.search(path))
        b = shape.n_candidates or shape.global_batch
        mult = 6.0 if shape.kind == "train" else 2.0
        flops = mult * n_mlp * b
        if shape.kind == "retrieval" and arch.model_cfg.kind == "two_tower":
            flops = 2.0 * n_mlp * 1 + 2.0 * shape.n_candidates * arch.model_cfg.d_out
        return flops
    if fam == "engine":
        cfg = arch.model_cfg
        # per query: ~visit_cap expansions x max_degree neighbors x 2d flops
        sc = cfg.range_cfg.search
        return (2.0 * shape.global_batch * sc.visit_cap * cfg.max_degree * cfg.dim)
    return 0.0


def make_report(arch, shape, mesh_name: str, chips: int, cost: dict,
                mem: Any, analysis, model_flops: float,
                note: str = "") -> RooflineReport:
    """The reference's report. ``cost`` and ``analysis`` describe one
    rank's program; whole-program totals are that times ``chips``, so the
    terms reduce to per-rank over the per-card rates. The analysis's loop
    trips stand in for the cost's where a loop ran more than 4 times (the
    reference's rule; a trace unrolls its loops, so ``max_trip`` is 1)."""
    coll = analysis.collectives
    flops_dev = max(float(cost.get("flops", 0.0)), analysis.dot_flops)
    bytes_cost = float(cost.get("bytes accessed", 0.0))
    bytes_dev = max(bytes_cost, analysis.hbm_bytes) if analysis.max_trip > 4 \
        else bytes_cost
    cbytes_dev = float(coll.total_operand_bytes)
    flops = flops_dev * chips
    byts = bytes_dev * chips
    cbytes = cbytes_dev * chips
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = bytes_dev / HBM_BW
    collective_s = cbytes_dev / ICI_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(compute_s, memory_s, collective_s)
    mfu = model_flops / (chips * PEAK_FLOPS * step) if step > 0 else 0.0
    mem_d = {}
    if mem is not None:
        for f in ("argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes",
                  "alias_size_in_bytes"):
            v = getattr(mem, f, None)
            if v is not None:
                mem_d[f] = int(v)
    return RooflineReport(
        arch_id=arch.arch_id, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=byts, collective_bytes=cbytes,
        collective_wire_bytes=float(coll.total_wire_bytes),
        collective_summary=coll.summary(),
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        dominant=dominant, model_flops=model_flops,
        useful_ratio=(model_flops / flops) if flops else 0.0,
        step_time_s=step, mfu=mfu, memory_per_device=mem_d, note=note)


def save_reports(reports: list[RooflineReport], path: str):
    with open(path, "w") as f:
        json.dump([r.to_json() for r in reports], f, indent=1)


def load_reports(path: str) -> list[dict]:
    with open(path) as f:
        return json.load(f)

"""gcn-cora [gnn] — 2 layers, d_hidden=16, aggregator=mean (symmetric
normalization), Cora geometry (2708 nodes, 1433 features, 7 classes).
[arXiv:1609.02907; paper]
"""
from ..dist.sharding import GNN_RULES
from ..models.gcn import GCNConfig
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, gnn_shapes


def reduced() -> GCNConfig:
    return GCNConfig(name="gcn-smoke", n_layers=2, d_feat=32, d_hidden=16,
                     n_classes=5)


ARCH = ArchSpec(
    arch_id="gcn-cora",
    family="gnn",
    model_cfg=GCNConfig(name="gcn-cora", n_layers=2, d_feat=1433,
                        d_hidden=16, n_classes=7, agg="mean", sym_norm=True),
    shapes=gnn_shapes(),
    rules=GNN_RULES,
    opt_cfg=AdamWConfig(lr=1e-2, weight_decay=5e-4, total_steps=200,
                        warmup_steps=0, schedule="constant"),
    source="arXiv:1609.02907 (Kipf & Welling GCN); paper tier",
    technique_note=(
        "GNN: technique DIRECTLY applicable at the data level — "
        "data.graphs.range_graph_dataset builds the input graph with the "
        "paper's own k-NN/range engine (DESIGN.md §6)."),
    reduced=reduced,
)

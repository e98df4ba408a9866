"""Graph datasets and the fanout neighbor sampler (GraphSAGE-style), numpy
only: the port's own copy of the reference's ``src/repro/data/graphs.py``,
so every graph, CSR layout and sampled batch is bit for bit the
reference's.

Synthetic stochastic-block-model graphs stand in for Cora / ogbn-products.
The CSR layout is on the host; the sampler produces padded fixed-shape
subgraph batches. ``range_graph_dataset`` builds the GNN input graph with
the port's own k-NN engine (``core.build.build_knn_graph``), on the card
unless the caller asks for the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class GraphData:
    feats: np.ndarray      # (N, d) float32
    edge_src: np.ndarray   # (E,) int32
    edge_dst: np.ndarray   # (E,) int32
    labels: np.ndarray     # (N,) int32
    n_classes: int

    @property
    def n_nodes(self) -> int:
        return self.feats.shape[0]

    @property
    def n_edges(self) -> int:
        return self.edge_src.shape[0]


def make_sbm_graph(n_nodes: int, n_classes: int, d_feat: int, avg_degree: int,
                   p_in: float = 0.8, seed: int = 0) -> GraphData:
    """Stochastic block model with class-correlated features."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feats = centers[labels] + 0.5 * rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    e = n_nodes * avg_degree
    src = rng.integers(0, n_nodes, e).astype(np.int32)
    same = rng.random(e) < p_in
    # destination: same-class node (homophily) or random
    perm_by_class = {c: np.nonzero(labels == c)[0] for c in range(n_classes)}
    dst = rng.integers(0, n_nodes, e).astype(np.int32)
    src_labels = labels[src]   # gathered once, not once a class (the reference's bits)
    for c, nodes in perm_by_class.items():
        m = same & (src_labels == c)
        dst[m] = nodes[rng.integers(0, len(nodes), int(m.sum()))]
    return GraphData(feats=feats, edge_src=src, edge_dst=dst, labels=labels,
                     n_classes=n_classes)


def to_csr(n_nodes: int, edge_src: np.ndarray, edge_dst: np.ndarray):
    """(indptr, indices): incoming neighbors of each node (dst -> srcs)."""
    order = np.argsort(edge_dst, kind="stable")
    sorted_dst = edge_dst[order]
    sorted_src = edge_src[order]
    counts = np.bincount(sorted_dst, minlength=n_nodes)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr, sorted_src


@dataclasses.dataclass
class SampledBatch:
    """Padded layered subgraph: seed nodes + fanout-sampled neighborhoods."""
    node_ids: np.ndarray    # (N_sub,) global ids (-1 pad)
    feats: np.ndarray       # (N_sub, d)
    edge_src: np.ndarray    # (E_sub,) local ids (-1 pad)
    edge_dst: np.ndarray    # (E_sub,)
    labels: np.ndarray      # (N_sub,) -1 for non-seed
    seed_mask: np.ndarray   # (N_sub,) bool


class NeighborSampler:
    """Uniform fanout sampler over CSR (GraphSAGE). Fixed output shapes."""

    def __init__(self, data: GraphData, fanouts: tuple[int, ...] = (15, 10),
                 batch_nodes: int = 1024, seed: int = 0):
        self.data = data
        self.fanouts = fanouts
        self.batch_nodes = batch_nodes
        self.indptr, self.indices = to_csr(data.n_nodes, data.edge_src, data.edge_dst)
        self.rng = np.random.default_rng(seed)
        # fixed caps
        self.max_nodes = batch_nodes
        f = 1
        self.max_edges = 0
        for fo in fanouts:
            self.max_edges += self.max_nodes * fo if not self.max_edges else 0
        n, e = batch_nodes, 0
        total_n = batch_nodes
        for fo in fanouts:
            e += n * fo
            n = n * fo
            total_n += n
        self.max_nodes = total_n
        self.max_edges = e

    def sample(self) -> SampledBatch:
        d = self.data
        seeds = self.rng.integers(0, d.n_nodes, self.batch_nodes).astype(np.int64)
        nodes = [seeds]
        edges_src, edges_dst = [], []
        frontier = seeds
        # local id = position in the concatenated node list
        id_map = {}
        for nid in seeds:
            if nid not in id_map:
                id_map[nid] = len(id_map)
        all_nodes = list(dict.fromkeys(seeds.tolist()))
        frontier_local = [id_map[n] for n in seeds.tolist()]
        for fo in self.fanouts:
            nxt, nxt_local = [], []
            for local, nid in zip(frontier_local, frontier.tolist()):
                lo, hi = self.indptr[nid], self.indptr[nid + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = self.rng.integers(lo, hi, min(fo, int(deg)))
                for t in self.indices[take]:
                    t = int(t)
                    if t not in id_map:
                        id_map[t] = len(id_map)
                        all_nodes.append(t)
                    edges_src.append(id_map[t])
                    edges_dst.append(local)
                    nxt.append(t)
                    nxt_local.append(id_map[t])
            frontier = np.asarray(nxt, np.int64) if nxt else np.zeros(0, np.int64)
            frontier_local = nxt_local
            if len(frontier) == 0:
                break

        n_sub = len(all_nodes)
        e_sub = len(edges_src)
        node_ids = np.full(self.max_nodes, -1, np.int32)
        node_ids[:n_sub] = np.asarray(all_nodes, np.int32)[: self.max_nodes]
        feats = np.zeros((self.max_nodes, d.feats.shape[1]), np.float32)
        feats[:n_sub] = d.feats[np.asarray(all_nodes)[: self.max_nodes]]
        es = np.full(self.max_edges, -1, np.int32)
        ed = np.full(self.max_edges, -1, np.int32)
        es[:e_sub] = np.asarray(edges_src, np.int32)[: self.max_edges]
        ed[:e_sub] = np.asarray(edges_dst, np.int32)[: self.max_edges]
        labels = np.full(self.max_nodes, -1, np.int32)
        labels[: self.batch_nodes] = d.labels[seeds][: self.max_nodes]
        seed_mask = np.zeros(self.max_nodes, bool)
        seed_mask[: self.batch_nodes] = True
        return SampledBatch(node_ids=node_ids, feats=feats, edge_src=es,
                            edge_dst=ed, labels=labels, seed_mask=seed_mask)


def range_graph_dataset(points: np.ndarray, labels: np.ndarray, n_classes: int,
                        k: int = 8, device="cuda") -> GraphData:
    """A GNN dataset whose edges come from the paper's k-NN engine: each
    node's k nearest other nodes as its sources. Near-ties of the distances
    may order two neighbours differently from the reference's graph."""
    from ..core.build import build_knn_graph
    from ..utils import INVALID_ID

    g = build_knn_graph(np.asarray(points, np.float32), k=k, device=device)
    nbrs = g.neighbors.cpu().numpy()
    n = points.shape[0]
    src = nbrs.reshape(-1)
    dst = np.repeat(np.arange(n, dtype=np.int32), nbrs.shape[1])
    ok = src != INVALID_ID
    return GraphData(feats=points.astype(np.float32), edge_src=src[ok].astype(np.int32),
                     edge_dst=dst[ok], labels=labels.astype(np.int32),
                     n_classes=n_classes)

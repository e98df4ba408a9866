"""Synthetic embedding corpora with paper-matched range characteristics.

The paper's nine corpora (BIGANN, DEEP, MSTuring, GIST, SSNPP, OpenAI,
Text2Image, Wikipedia, MSMARCO) are multi-GB downloads unavailable offline.
What the paper's experiments actually depend on is the *shape* of each
dataset's range structure (Sec. 3):

* the percent-captured curve's steepness around the chosen radius
  ("robust" vs "perturbable" — Fig. 3),
* the match-size frequency distribution (Pareto: most queries zero results,
  few huge outliers — Fig. 4),
* match density growth with corpus size (Fig. 7).

We generate mixtures of Gaussian clusters with power-law cluster sizes plus a
uniform background, and draw queries as a mix of near-cluster probes (produce
matches) and background probes (produce zero matches). Each profile below is
tuned to reproduce one paper dataset's qualitative signature; benchmarks
sweep them exactly like the paper sweeps its corpora.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CorpusProfile:
    """Generator knobs for one dataset signature."""

    name: str
    dim: int
    metric: str            # "l2" | "ip"
    n_clusters: int        # per 100k points
    zipf_a: float          # cluster-size power law (lower = heavier outliers)
    cluster_std: float     # intra-cluster spread (vs unit inter-cluster scale)
    background_frac: float # fraction of corpus drawn as unclustered noise
    query_hit_frac: float  # fraction of queries aimed at clusters
    query_std: float       # query offset from its cluster center
    latent_dim: int = 16   # intrinsic dimensionality: points live on a
                           # low-dim manifold linearly embedded in `dim`
                           # (real embeddings are low-intrinsic-dim; full-rank
                           # Gaussian shells are un-navigable and unrealistic)
    notes: str = ""


# Signatures mirror Figs. 3/4: robust-radius sets (bigann/deep/gist/wikipedia/
# msmarco) get tight, well-separated clusters; perturbable sets (ssnpp,
# text2image, msturing) get wide overlapping clusters; gist-like gets a few
# enormous clusters (its Fig. 4 row has hundreds of >1e4 outliers).
PROFILES: dict[str, CorpusProfile] = {
    p.name: p
    for p in [
        CorpusProfile("bigann-like", 128, "l2", 160, 2.2, 0.035, 0.55, 0.92, 0.05,
                      notes="robust radius; strong zero/nonzero separation"),
        CorpusProfile("deep-like", 96, "l2", 200, 2.4, 0.035, 0.60, 0.95, 0.05,
                      notes="robust; sparse matches"),
        CorpusProfile("msturing-like", 100, "l2", 120, 2.0, 0.08, 0.50, 0.96, 0.09,
                      notes="perturbable; mostly tiny result sets"),
        CorpusProfile("gist-like", 256, "l2", 24, 1.3, 0.06, 0.25, 0.15, 0.03,
                      latent_dim=20,
                      notes="few enormous clusters + few cluster-centered "
                            "queries -> most queries zero, outliers >1e3"),
        CorpusProfile("ssnpp-like", 200, "l2", 80, 2.0, 0.10, 0.40, 0.93, 0.11,
                      notes="dense, density grows fast with scale"),
        CorpusProfile("openai-like", 384, "l2", 100, 1.9, 0.05, 0.45, 0.70, 0.06,
                      latent_dim=24,
                      notes="moderate tail, many 1-10-result queries"),
        CorpusProfile("text2image-like", 200, "ip", 140, 2.3, 0.06, 0.55, 0.985, 0.10,
                      notes="IP metric; extremely skewed to zero results"),
        CorpusProfile("wikipedia-like", 256, "ip", 90, 2.1, 0.05, 0.45, 0.55, 0.06,
                      notes="IP; flatter distribution, many small result sets"),
        CorpusProfile("msmarco-like", 256, "ip", 110, 2.0, 0.05, 0.50, 0.70, 0.06,
                      notes="IP; early-stop separation exists (Fig. 5a)"),
    ]
}


@dataclasses.dataclass
class RangeDataset:
    name: str
    metric: str
    points: np.ndarray   # (N, d) float32
    queries: np.ndarray  # (Q, d) float32
    radius: Optional[float] = None  # filled by radius selection


def _zipf_sizes(rng: np.random.Generator, n_items: int, n_clusters: int, a: float) -> np.ndarray:
    w = rng.zipf(a, size=n_clusters).astype(np.float64)
    w = w / w.sum()
    sizes = np.floor(w * n_items).astype(np.int64)
    sizes[0] += n_items - sizes.sum()
    return sizes


def make_corpus(
    profile: str | CorpusProfile,
    n: int = 100_000,
    n_queries: int = 2_000,
    seed: int = 0,
) -> RangeDataset:
    """Low-intrinsic-dim corpus: all structure lives in a ``latent_dim``
    subspace, linearly embedded into ``dim`` by a random orthonormal map
    (+ tiny ambient noise) — the geometry real embedding models produce,
    and the geometry graph indices are navigable on."""
    p = PROFILES[profile] if isinstance(profile, str) else profile
    # Independent streams so the *distribution* (centers, basis) is identical
    # at every corpus size — Fig. 7's "larger sample from the same
    # distribution" semantics — and queries are reusable across scales.
    rng_dist = np.random.default_rng(seed * 7919 + 1)
    rng = np.random.default_rng(seed * 7919 + 2)
    rng_q = np.random.default_rng(seed * 7919 + 3)
    ld = min(p.latent_dim, p.dim)
    n_clusters = max(4, p.n_clusters // 4)
    centers = rng_dist.standard_normal((n_clusters, ld)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)  # unit shell

    n_bg = int(n * p.background_frac)
    n_cl = n - n_bg
    sizes = _zipf_sizes(rng_dist, n_cl, n_clusters, p.zipf_a)
    assign = np.repeat(np.arange(n_clusters), sizes)
    lat_cl = centers[assign] + (p.cluster_std * rng.standard_normal((n_cl, ld))).astype(np.float32)
    lat_bg = rng.standard_normal((n_bg, ld)).astype(np.float32)
    lat_bg /= np.linalg.norm(lat_bg, axis=1, keepdims=True)
    latent = np.concatenate([lat_cl, lat_bg]).astype(np.float32)
    rng.shuffle(latent, axis=0)

    n_hit = int(n_queries * p.query_hit_frac)
    # hit queries target clusters proportionally to size (big clusters produce
    # the paper's huge-result outliers)
    probs = sizes / sizes.sum()
    q_assign = rng_q.choice(n_clusters, size=n_hit, p=probs)
    q_hit = centers[q_assign] + (p.query_std * rng_q.standard_normal((n_hit, ld))).astype(np.float32)
    q_bg = rng_q.standard_normal((n_queries - n_hit, ld)).astype(np.float32)
    q_bg /= np.linalg.norm(q_bg, axis=1, keepdims=True)
    q_bg *= 1.25  # push background queries off the data shell -> zero results
    q_latent = np.concatenate([q_hit, q_bg]).astype(np.float32)
    rng_q.shuffle(q_latent, axis=0)

    if p.metric == "ip":
        # IP corpora: scale points by a lognormal "importance" so inner
        # products have the heavy positive tail real MIPS sets show
        scale = rng.lognormal(mean=0.0, sigma=0.25, size=(latent.shape[0], 1)).astype(np.float32)
        latent = latent * scale

    # random orthonormal embedding latent -> ambient + small ambient noise
    basis, _ = np.linalg.qr(rng_dist.standard_normal((p.dim, ld)))
    basis = basis.astype(np.float32)
    points = latent @ basis.T
    points += (0.01 * p.cluster_std) * rng.standard_normal(points.shape).astype(np.float32)
    queries = q_latent @ basis.T
    return RangeDataset(name=p.name, metric=p.metric, points=points, queries=queries)


def dataset_names() -> list[str]:
    return list(PROFILES)

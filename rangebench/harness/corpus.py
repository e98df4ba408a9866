"""Synthetic corpora and queries, drawn on the device from seeds.

A torch rewrite of the port's ``data/synthetic.py::make_corpus``: a
mixture of Zipf-sized Gaussian clusters on a unit shell in a
``latent_dim``-dimensional subspace, embedded in ``dim`` by a random
orthonormal map with a little ambient noise, plus a uniform background on
the shell; queries are near-cluster probes (which match) and background
probes pushed off the shell (which mostly do not).

The corpus is the deployment's, as a public benchmark's data file is: the
distribution (cluster centres, cluster shares, the embedding) is drawn
with numpy in ``make_corpus``'s order from the configuration's
``distribution_seed``, and the points from the same seed on the device,
with a ``torch.Generator`` in a few large calls. Every run of a
configuration indexes the same points; a run's ``--seed`` orders its
queries (``traffic.py``). An index built on another draw is another
graph, whose reach from its start points differs: per-lane recall moved
from 0.52 to 0.73 between two draws on one H100.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

# make_corpus pushes background queries off the data shell by this factor
BACKGROUND_QUERY_SCALE = 1.25
# ... and adds ambient noise of this fraction of the cluster spread
AMBIENT_NOISE = 0.01


def stream_seed(seed: int, *salt: int) -> int:
    """A 63-bit generator seed for one stream of one run: any whole
    ``seed`` (negative or past 64 bits too) and the stream's salt."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(int(s) for s in salt)).encode())
    return int.from_bytes(digest.digest()[:8], "little") & (2**63 - 1)


def generator(device, seed: int, *salt: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, *salt))


@dataclasses.dataclass
class Distribution:
    """One configuration's fixed distribution on one device."""

    dim: int
    metric: str
    centers: torch.Tensor     # (C, ld) f32, unit norm
    shares: np.ndarray        # (C,) f64, each cluster's share of the clustered points
    basis: torch.Tensor       # (dim, ld) f32, orthonormal columns
    knobs: dict               # the configuration's "generator" group

    def cluster_sizes(self, n_clustered: int) -> np.ndarray:
        """``make_corpus``'s sizes: floor of each share, the remainder to
        the first cluster."""
        sizes = np.floor(self.shares * n_clustered).astype(np.int64)
        sizes[0] += n_clustered - sizes.sum()
        return sizes


def distribution(cfg: dict, device) -> Distribution:
    g = cfg["generator"]
    rng = np.random.default_rng(g["distribution_seed"])
    ld = min(g["latent_dim"], cfg["dim"])
    n_clusters = max(4, g["n_clusters"] // 4)
    centers = rng.standard_normal((n_clusters, ld)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    w = rng.zipf(g["zipf_a"], size=n_clusters).astype(np.float64)
    shares = w / w.sum()
    basis, _ = np.linalg.qr(rng.standard_normal((cfg["dim"], ld)))
    return Distribution(dim=cfg["dim"], metric=cfg["metric"],
                        centers=torch.as_tensor(centers, device=device),
                        shares=shares,
                        basis=torch.as_tensor(basis.astype(np.float32), device=device),
                        knobs=g)


def _embed(dist: Distribution, latent: torch.Tensor) -> torch.Tensor:
    # an exact f32 product: the points are data, not a measurement
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return latent @ dist.basis.T
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def corpus(dist: Distribution, n: int) -> torch.Tensor:
    """(n, dim) f32 points of the deployment, on the distribution's device."""
    g, dev = dist.knobs, dist.centers.device
    gen = generator(dev, g["distribution_seed"], 1)
    n_bg = int(n * g["background_frac"])
    n_cl = n - n_bg
    ld = dist.centers.shape[1]
    sizes = torch.as_tensor(dist.cluster_sizes(n_cl), device=dev)
    assign = torch.repeat_interleave(torch.arange(len(sizes), device=dev), sizes)
    latent = torch.randn((n, ld), generator=gen, device=dev)
    latent[:n_cl].mul_(g["cluster_std"]).add_(dist.centers[assign])
    bg = latent[n_cl:]
    bg.div_(torch.linalg.vector_norm(bg, dim=1, keepdim=True))
    latent = latent[torch.randperm(n, generator=gen, device=dev)]
    if dist.metric == "ip":
        # make_corpus's lognormal importance (sigma 0.25) for inner products
        latent.mul_(torch.exp(0.25 * torch.randn((n, 1), generator=gen, device=dev)))
    points = _embed(dist, latent)
    noise = torch.randn(points.shape, generator=gen, device=dev)
    return points.add_(noise, alpha=AMBIENT_NOISE * g["cluster_std"])


def queries(dist: Distribution, count: int, n: int, gen: torch.Generator) -> torch.Tensor:
    """(count, dim) f32 queries in the generator's natural mix: a fixed
    number of near-cluster probes (clusters drawn by size, as the corpus of
    ``n`` points holds them) and of background probes, in a random order."""
    g, dev = dist.knobs, dist.centers.device
    n_hit = int(count * g["query_hit_frac"])
    ld = dist.centers.shape[1]
    sizes = dist.cluster_sizes(n - int(n * g["background_frac"]))
    probs = torch.as_tensor(sizes / sizes.sum(), dtype=torch.float32, device=dev)
    pick = torch.multinomial(probs, n_hit, replacement=True, generator=gen) if n_hit else (
        torch.zeros(0, dtype=torch.long, device=dev))
    lat = torch.randn((count, ld), generator=gen, device=dev)
    lat[:n_hit].mul_(g["query_std"]).add_(dist.centers[pick])
    bg = lat[n_hit:]
    bg.div_(torch.linalg.vector_norm(bg, dim=1, keepdim=True)).mul_(BACKGROUND_QUERY_SCALE)
    lat = lat[torch.randperm(count, generator=gen, device=dev)]
    return _embed(dist, lat).contiguous()


def calibration_queries(dist: Distribution, count: int, n: int) -> torch.Tensor:
    """The radius rule's query sample: drawn from the distribution's own
    seed, so every run of a configuration calibrates on the same probes."""
    gen = generator(dist.centers.device, dist.knobs["distribution_seed"], 3)
    return queries(dist, count, n, gen)

"""range-engine: the paper's own system as a deployment configuration.

One shard of a range-retrieval deployment: 1M points of d=128 per shard,
a Vamana graph of degree 32, l2, and the fused greedy search (beam 64,
visit_cap 256, E=4, result_cap 1024) over 4096-query batches, each query
at its own radius. ``corpus_dtype`` "int8" is the production setting (the
guard-banded walk on int8 codes and the exact rerank of the band); the
default stays f32. A multi-shard deployment splits its corpus over the
mesh's model axis, one such shard a sub-index (``dist.build_sharded``).
"""
import dataclasses

from ..core.beam_search import SearchConfig
from ..core.range_search import RangeConfig
from ..dist.sharding import Rule
from ..optim.adamw import AdamWConfig
from .common import ArchSpec, ShapeSpec


@dataclasses.dataclass(frozen=True)
class EngineDeployConfig:
    name: str = "range-engine"
    shard_corpus: int = 1_000_000     # points per shard
    dim: int = 128
    max_degree: int = 32
    metric: str = "l2"
    # corpus storage dtype; "int8" is the production deploy (d + 12 hot
    # bytes a vector against 4d for f32), f32 the default
    corpus_dtype: str = "float32"
    range_cfg: RangeConfig = dataclasses.field(default_factory=lambda: RangeConfig(
        search=SearchConfig(beam=64, max_beam=64, visit_cap=256, expand_width=4),
        mode="greedy", result_cap=1024, frontier_rounds=2048))

    def __post_init__(self):
        # keep the search config's corpus_dtype in step with the deploy
        # field: the non-default side wins, and two different non-defaults
        # are an error, never a silent override
        s = self.range_cfg.search.corpus_dtype
        if s != self.corpus_dtype:
            if s != "float32" and self.corpus_dtype != "float32":
                raise ValueError(
                    f"corpus_dtype={self.corpus_dtype!r} conflicts with "
                    f"range_cfg.search.corpus_dtype={s!r}")
            unified = s if self.corpus_dtype == "float32" else self.corpus_dtype
            object.__setattr__(self, "corpus_dtype", unified)
            object.__setattr__(self, "range_cfg", dataclasses.replace(
                self.range_cfg, search=dataclasses.replace(
                    self.range_cfg.search, corpus_dtype=unified)))

    def overrides(self, **kw) -> "EngineDeployConfig":
        """A new config with each keyword routed to the level that owns it:
        an ``EngineDeployConfig`` field, a ``RangeConfig`` field or a
        ``SearchConfig`` field, resolved in that order (``lam`` sets the
        range config's). ``metric`` sets the deploy field and the search's;
        ``corpus_dtype`` sets both sides of the ``__post_init__`` sync. An
        unknown key raises ``TypeError``."""
        deploy_f = {f.name for f in dataclasses.fields(EngineDeployConfig)}
        range_f = {f.name for f in dataclasses.fields(RangeConfig)} - {"search"}
        search_f = {f.name for f in dataclasses.fields(SearchConfig)}
        d_kw, r_kw, s_kw = {}, {}, {}
        for k, v in kw.items():
            if k in deploy_f:
                d_kw[k] = v
                if k in ("metric", "corpus_dtype"):
                    s_kw[k] = v
            elif k in range_f:
                r_kw[k] = v
            elif k in search_f:
                s_kw[k] = v
            else:
                raise TypeError(f"overrides() got unknown knob {k!r}")
        rc = d_kw.pop("range_cfg", self.range_cfg)
        if s_kw:
            rc = dataclasses.replace(rc, search=dataclasses.replace(rc.search, **s_kw))
        if r_kw:
            rc = dataclasses.replace(rc, **r_kw)
        return dataclasses.replace(self, range_cfg=rc, **d_kw)


def reduced() -> EngineDeployConfig:
    return EngineDeployConfig(
        name="range-engine-smoke", shard_corpus=2_000, dim=16, max_degree=8,
        range_cfg=RangeConfig(search=SearchConfig(beam=16, max_beam=16,
                                                  visit_cap=64, expand_width=4),
                              mode="greedy", result_cap=128,
                              frontier_rounds=256))


ARCH = ArchSpec(
    arch_id="range-engine",
    family="engine",
    model_cfg=EngineDeployConfig(),
    shapes={
        "search_4k": ShapeSpec("search_4k", "range_search", global_batch=4096,
                               notes="batched online range queries"),
        "search_64k": ShapeSpec("search_64k", "range_search", global_batch=65_536,
                                notes="bulk range search (Szilvasy-style)"),
    },
    rules=[Rule(r".*", ())],
    opt_cfg=AdamWConfig(),
    source="this paper",
    technique_note="the paper's contribution itself",
    reduced=reduced,
)

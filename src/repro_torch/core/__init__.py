"""The paper's contribution: range retrieval on graph-based indices."""
from .beam_search import (
    ES_D_TOP1,
    ES_D_TOP10,
    ES_D_VISITED,
    ES_NONE,
    ES_RATIO_TOP10,
    BeamState,
    SearchConfig,
    beam_search,
    beam_search_batch,
    broadcast_radius,
    topk_from_state,
)
from .build import BuildConfig, build_knn_graph, build_vamana, insert_batch_step, robust_prune
from .corpus import (
    CORPUS_DTYPES,
    META_BYTES,
    Corpus,
    QuantizedCorpus,
    bytes_per_vector,
    corpus_cast,
    corpus_dim,
    corpus_dtype_name,
    corpus_raw,
    corpus_set_rows,
    corpus_size,
    corpus_take_rows,
    corpus_with_capacity,
    hot_arm,
    lower_bound_dists,
    pad_corpus_rows,
    quantize_corpus,
    quantize_rows,
    quantized_gather_lb,
    query_quant_err,
    upper_bound_dists,
)
from .distances import gather_dist, pairwise_dist, point_dist
from .engine import RangeSearchEngine
from .graph import Graph, from_lists, medoid, random_regular, start_points
from .labels import (
    LabelFilter,
    all_pass_filter,
    label_match_counts,
    label_match_matrix,
    labels_match,
    make_label_filter,
    make_mask,
    num_label_words,
    pack_labels,
)
from .ground_truth import exact_range_search, exact_topk, range_counts_at
from .metrics import average_precision, recall_at_k, zero_result_accuracy
from .radius import RadiusProfile, default_grid, match_histogram, select_radius, sweep
from .range_search import (
    ENTRY_SEED_FRAC,
    GreedyState,
    RangeConfig,
    RangeResult,
    filter_labeled,
    filter_tombstoned,
    finalize_results,
    greedy_coverage,
    greedy_lane_done,
    greedy_resume_batch,
    greedy_search,
    greedy_seed_batch,
    range_phase1,
    range_search_compacted,
    range_search_fused,
)

__all__ = [k for k in dir() if not k.startswith("_")]

#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

    python3 chip_smoke.py                 # full size: N=1M, d=128, Q=4096
    python3 chip_smoke.py --n 100000      # a shorter rehearsal
    python3 chip_smoke.py --result-cap 4096   # a larger result buffer, and
                                              # the two-tower AP probes

Phases, each printed as it ends:
  1. build the CUDA kernels from the sources in the checkout (nvcc, sm_90a,
     one process per source, all started together); print the build time
     and the card's name and power limit;
  2. a bigann-like corpus from a seed and its exact k-NN graph (R=32), and
     its int8 quantization (one pass on the card);
  3. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path (time, bound, plain version's time): expand
     and gatherdist (f32/bf16), expand-int8 and gatherdist-int8 in both
     arithmetic forms (int32 dots equal; the two kernels bit for bit on
     shared candidates, on every route of each), rerank_fetch at P in {1,
     17, 4096, 16384, 24576, 32768, 65536}; expand and expand-int8 on the
     route their plan takes (bulk) and on the warp route, bit for bit
     equal, each timed; gatherdist-int8 at random start points and at the
     main path's 4 shared ones, and rerank_fetch, on both routes (regs and
     the first kernel, warp), beside an empty kernel on the planned grid
     (the launch floor);
  4. the radius, chosen the paper's way (sweep + select_radius) on a
     256-query sample, for half the queries to answer empty;
  5. the f32 main path: ``RangeSearchEngine.range(compacted=True)`` on all
     queries in greedy, beam and doubling modes (QPS, AP against
     ``exact_range_search``, match histogram, launches of each kernel,
     expand's routes, all bulk);
  6. the int8 main path: ``from_graph(corpus_dtype="int8")`` on the same
     graph and radius, greedy/beam/doubling in the f32-query form and
     greedy in the int8-query form (QPS, AP, AP against f32, mean n_rerank,
     band size P, launches and routes, each kernel's redesigned route
     asserted; no false positive); rerank_fetch at the band the greedy run
     produced on each route (regs, warp), warm and with L2 flushed before
     each launch; the expand launches of the greedy
     f32, int8 f32-query and int8 int8-query batches (kept on their
     warm-up runs) replayed in one CUDA graph on each route ([served]:
     sum, mean a launch, count, bound; every launch bit for bit equal on
     the two routes);
  7. the guard-band contract on 256 queries: the post-rerank set equals the
     rerank-disabled set filtered by the exact distances; and one greedy
     batch of each engine (f32, int8 f32-query) under ``trace.card_syncs``:
     every synchronizing call the card reports from the port is counted in
     ``host_syncs`` ([syncs]: the sites and both counts);
  8. the kernel path against the plain path through the same engines on a
     256-query subset (AP within 0.01), f32 and int8;
 11. [tier]: ``from_graph(corpus_dtype="int8", tier=True)`` on the k-NN
     graph (raw rows in pinned host memory), greedy int8, two calls (cold,
     warm) at the default cache (n/8 rows) and at a third of the band's
     distinct rows (evicting): ids, dists, count and n_rerank bit for bit
     the resident int8 engine's in every call, the same rerank_fetch route;
     the counters (pairs, rows, hits, misses, MB fetched, evictions), the
     device bytes against the resident corpus's, QPS against resident;
 12. [vamana]: the Vamana path (12-15) on its own bigann-like draw of
     250,000 points (VAMANA_N; the same distribution and seed, its own
     4,096 queries, radius for half of them to answer empty, and oracle):
     ``build_vamana`` on the card (R=32, beam 64, alpha 1.2,
     batches up to 1024; the reference's serve CLI settings): build time
     and its split (search, prune, reverse edges), expand and gatherdist
     launches and routes, every row checked (no id out of range, no self
     loop, no duplicate), degrees and the share reachable from the medoid;
     greedy f32 and int8 on it beside the main corpus's k-NN graph's QPS
     and AP, the
     kernel path against the plain path (AP within 0.01), the guard band;
 13. [filtered]: benchmarks/run.py's filtered workload on the Vamana engine
     (16 labels, 1-2 a point; 128 queries alternating one-label AND and
     four-label OR; the radius of ~128 mean matches): unfiltered and
     filtered QPS and AP (against the post-filtered oracle; the gap <=
     0.01), then the selective lanes on the fallback scan (every lane
     n_visited == 0, answers equal to the post-filtered oracle as sets up to
     pairs within 1e-5 of r), its QPS against the walk's, and its
     rerank_fetch launch and route;
 14. [serve]: the serving layer (``RangeServer``) on the Vamana engine,
     with the reference serve CLI's settings (max_batch 128, 32 lanes, 8
     rounds a slice, the effort regressor fitted on the card on 256
     calibration requests with their exact counts): lockstep, f32 and
     int8, on the first 1,024 queries at r, every response equal to its lane of
     ``engine.range`` (f32: the distances' bits too), requests/s beside
     engine.range's QPS and exact p50/p99; benchmarks/run.py's tail
     workload (512 requests, every 16th at the radius of ~512 mean
     matches, the rest at ~4) in lockstep and continuously, each after a
     warm-up pass, f32 and int8: continuous equal to lockstep per request,
     AP of both, point p50/p99, heavy p99, the point-p99 ratio, the pool
     counters; a 256-request continuous pass on the plain path (AP within
     0.01 of the kernel path); every path kernel launched through the
     server (``serve_launches`` in the kernels line);
 15. [live]: the live index (``repro_torch.live``) promoted from the Vamana
     graph, the serve CLI's --churn settings (capacity n + k, insert steps
     of 128, R=32, beam 64), greedy at r: (a) f32 and int8, k = 10,000
     inserts (a corpus point plus 0.05 std noise, benchmarks/run.py's churn
     row) and k deletes of initial ids, with their rates; QPS and AP on the
     live set beside the static engine's; gates: no deleted id answers,
     each of 256 inserted vectors finds its own id at distance 0, the int8
     guard band on the live snapshot, a pre-churn snapshot answers bit for
     bit as before, kernel-path AP equals plain-path AP within 0.01; then
     ``consolidate()`` (seconds, rows rewired and pruned, slots reclaimed)
     and the gates again; (b) f32 durability: a WAL and a checkpoint in a
     temporary directory, half the churn, save, 2,000 inserts and deletes
     and a consolidation, a torn record; ``LiveIndex.restore(cm, wal=)``
     equals the uninterrupted index bit for bit (checkpoint bytes, save,
     restore and replay seconds); (c) 256 queries shuffled with 500
     inserts and 500 deletes through ``RangeServer(live=)``, lockstep and
     continuous: every request answered once, each insert's id holding its
     vector, continuous equal to lockstep per query, requests/s, epoch,
     AP on the final live set; every search kernel launched through the
     live path (``live_launches`` in the kernels line);
 16. [sharded]: the sharded engine (``repro_torch.dist``, ``fault``) on the
     same corpus, queries, radius and oracle in 4 contiguous shards of
     250,000, each an exact k-NN graph (R=32) from its medoid, f32 and int8
     (each shard quantized on its own), greedy at result_cap 1024:
     ``sharded_range_search`` on a one-rank NCCL mesh, bit for bit the host
     union of the four per-shard ``range_search_fused`` calls, no false
     positive, a mixed r/2r batch equal lane for lane to the homogeneous
     calls, QPS, AP and the phase-2 share beside the single index's (and AP
     with 4 starts a shard); the f32 collective on two ranks sharing the
     card (gloo, mesh (1, 2), this script started with ``--sharded-rank``,
     its kernels the parent's builds), each rank bit for bit the one-rank
     result, with its wall time and the model-axis gather's; the host
     fan-out healthy (threaded and serial, bit for bit), with shard 1 down
     (coverage 0.75, the union of the other three) and with garbage at
     (shard 2, attempt 0) (caught, retried, healthy), each on the first
     1,024 queries (FANOUT_QUERIES); ``RangeServer(mesh=,
     sharded=)`` and ``RangeServer(sharded=, injector=)`` over 256
     requests, each equal to its lane and annotated when degraded;
     ``sharded_launches`` in the kernels line;
 17. [replicated]: ``fault.replica`` over [sharded]'s f32 and int8 corpora,
     two bit-identical replicas (``ReplicatedCorpus.replicate``,
     ``parity_ok`` on the card; the fleet's device bytes), each gate on the
     first 1,024 queries and bit for bit the unreplicated serial fan-out:
     (a) healthy, threaded and serial; (b) replicas (1, 0) and (3, 1)
     down: coverage 1.0, ``replica_lost``; (c) scripted-slow primaries
     hedged at 5 ms: 4 hedges fired and won; (d) the wall-clock hedge
     (hedges fired, wall; its losing walks waited out); (e) a breaker
     tripped by scripted errors, re-admitted through the half-open probe
     past an injected cooldown, and ``lose`` + ``maintain`` recovery; (f)
     both replicas of shard 2 down: coverage 0.75, ``shard_lost``, the
     survivors' union; then 256 requests through
     ``RangeServer(replicas=2)`` at the serve CLI's fault, hedge and retry
     settings, each equal to its lane and annotated 7 of 8 replicas
     (requests/s, exact p50/p99, the replication stats);
     ``replicated_launches`` in the kernels line;
 18. [live sharded]: ``live.LiveShardedIndex`` over the 4 k-NN shards in
     groups of two (``clone_live_index``), 10,000 inserts and deletes
     ([live]'s churn) with their rates; ``assert_replica_parity``; no
     deleted id; inserted vectors stored, wired and found by ``range`` at
     least as often as one ``LiveIndex`` over the 1M k-NN graph finds them
     under the same churn, none found that nothing links to (those counted); ``range`` over a one-rank mesh
     bit for bit the union of the shards' own searches (external ids) and
     the replicated fan-out over ``replicated_corpus()``;
     ``rebuild_replica`` from a checkpoint and a WAL tail of 2,000
     mutations rejoins bit for bit; AP on the final live set;
     ``live_sharded_launches`` (the churn's and the timed ``range``'s) in
     the kernels line;
 19. [cli]: ``python -m repro_torch.launch.serve --n 25000 --queries
     256`` three times (``--early-stop --mixed-radius``; ``--shards 4
     --replicas 2 --hedge-ms 5 --down-replicas 1:0,3:1``, which must stay
     whole; ``--churn 0.05``), each exiting 0, its AP and rate lines
     re-printed with its wall;
 19b. [cells], after [cli]: the cell builder (``launch/steps.py``) and the
     roofline (``analysis/roofline.py``). Every cell of
     ``configs.all_cells(include_engine=True)`` (42) built at full width on
     the meta device over a one-rank NCCL mesh, each with its analytic
     model flops, the bytes of its parameter, optimizer-state and input
     trees, and the flops' floor at the bf16 peak; then the range-engine
     cell on the card over the main path's corpus and k-NN graph as one
     shard, corpus and queries scaled by 1/sqrt(r) (the cell searches at
     1.0): search_4k in f32 and int8, search_64k in f32 on 65,536 more
     queries of the corpus; each counted call equal to a direct
     ``range_search_fused`` merged as one shard (ids, distance bits,
     counts), every kernel of its path launched (``cells_launches`` in the
     kernels line), in f32 every 64th expand launch and every gatherdist
     launch of that call, at the batch's own 4,096 or 65,536 lanes, held
     against its plain op at DIST_TOL, AP against ``exact_range_search``
     at 1.0, kernel and plain path within 0.01 AP on 256 queries; the
     median wall of 3 more calls, QPS, peak memory, and the shares of the
     wall the engine's analytic flops (at the f32 rate) and the
     reference's gather bytes (at HBM_BW) would take;
 20. [train lm], after [cells] (training launches no kernel): qwen3-14b at
     full width, depth cut from 40 to 4 layers (2.88 B f32 masters from
     seed 0, 46.0 GB with gradients and moments), computed in bf16 with
     remat and GQA through ``sdpa``; 8 steps of the Trainer's step
     at the config's opt_cfg over 2 x 4,096 tokens of the LM stream
     (train_4k's length; its global batch of 256 cut): tokens/s, ms a step
     split into forward+backward and the update, peak memory; gates:
     finite losses and grad norms, masters still f32, no flashattn launch;
     the trained weights cast to bf16 and served, one prefill with 4
     flashattn launches on wgmma; one f32 step of a 2-layer qwen3 on the
     card against the CPU (every leaf within 1e-4 relative L2);
 21. [train recsys]: 5 steps on 65,536 rows (train_batch) of wide-deep
     and autoint at full width and vocabulary, dlrm-rm2 with its vocabulary
     cut to 2,097,152 a field and two-tower to 1,048,576 (rows/s, ms a step,
     the update's share, peak); the three CTR kinds' forward at full
     vocabulary on serve_p99 (512) and serve_bulk (262,144) rows; each
     reduced config one step on the card against the CPU (1e-4);
 22. [train gcn]: gcn-cora's geometry on make_sbm_graph(2708, 7, 1433,
     avg_degree=4), 200 steps (training accuracy), one step card vs CPU
     (1e-5); the ogb_products scale (2,449,029 nodes, avg_degree 25: 61.2 M
     edges, 100 features, 47 classes), 5 steps (ms a step, peak);
 23. [train cli]: ``python -m repro_torch.launch.train --arch <id> --smoke
     --steps 20``, then ``--resume --steps 30`` (which must print ``resumed
     from step 20``), for gemma3-27b, gcn-cora and dlrm-rm2, the three archs
     at once;
 24. [mesh train], last: the mesh trainer (``Trainer(mesh=,
     param_rules=LM_RULES)``: DTensor parameters and moments, each step in
     the activation scope) on a one-rank NCCL (1, 1) mesh against the
     unsharded Trainer from the same tree on the same batches: qwen3-14b at
     full width, depth cut from 40 to 2 (2.22 B f32 masters), 3 steps of 2
     x 4,096 tokens (ms a step after step 1, their ratio, peak memory;
     gates: every loss and grad norm and every leaf after step 3 within
     1e-5 relative, every parameter a DTensor); then the reference's
     elastic rig (2 layers, d_model 32): 10 unsharded steps and a
     checkpoint under build/, restored on the mesh at step 10 and trained
     to 14 against the unsharded continuation (1e-5); flashattn never
     launched;
  9. [two_tower], run right after the build so its 43 GB tables find the
     card empty: the two-tower-retrieval model at full width (16 + 16
     fields, vocab 10,485,760, d_embed 64, towers 1024-1024-512-256, both
     from seeds), 1M items embedded by the item tower (freed before the
     user tower is built), 512 user requests (serve_p99) and 1
     (retrieval_cand); the radius the paper's way at ip; brute-force
     serving (user tower + rangescan, k=256) and the graph engine on the
     same corpus (exact k-NN graph at ip, greedy) with QPS, AP and
     launches (expand's routes asserted bulk); expand and gatherdist
     against their plain versions at that path's shapes (ip, d=256), and
     the graph engine's kernel path equal
     to its plain path on every lane; rangescan against its plain version
     at k=128 and k=256 on the 512 requests, on 64 and on 1, every lane,
     excusing only pairs within 1e-5 of the radius or of each other (f32
     rounding of a reordered dot of two unit vectors at d=256 is ~1e-6),
     with the route of each call (the served batch asserted on wgmma);
     the kernel's time and TFLOP/s against both bounds (the f32 pipes,
     and three TF32 products on the tensor cores), the SIMT route, the
     plain version and the product alone (one torch.matmul); with
     --profile, a trace of the brute-force batch (tower, scan, merge);
 10. [lm], right after [two_tower] (its 54 GB of weights need the card
     too): gemma3-27b at full width and depth (62 layers, 52 local with a
     1024 window and 10 global, 32 heads over 16 kv heads, dh 128, vocab
     262,144) in bf16 from seed 0; 4 prompts of 4,096 tokens from the
     synthetic LM stream prefilled (cache of 4,128) and 32 greedy decode
     steps, with flashattn's launches counted (62 a prefill, 62 a step)
     and its routes (all 62 prefill calls on wgmma, every step's on
     decode_split); the kernel path against the plain path
     (use_kernels=False) on prompt 0, full depth in bf16 (relative L2 of
     the last-token logits <= 5e-2 on every step) and depth 6 in f32
     (<= 1e-4, argmax equal); flashattn against its plain version at the
     JAX tests' shapes and on the inputs the path gave one local and one
     global layer at prefill and at a decode step, with its route (and
     split count), its time against the bound (TFLOP/s or GB/s and the
     share of the bound), the plain version and one
     scaled_dot_product_attention call (and the ratio to it);
 10b. [lm moe], right after [lm]: qwen2-moe-a2.7b at full width and depth
     (24 layers, d_model 2048, 16 heads over 16 kv heads, dh 128; MoE 60
     experts in 64 allocated rows, top-4, d_expert 1408, 4 shared; vocab
     151,936 untied; 15.15 B parameters, 30.3 GB) in bf16 from seed 0: 4
     prompts of 4,096 tokens prefilled (cache 4,128) and 32 greedy decode
     steps (tokens/s, ms a step, peak memory; flashattn's launches and
     routes asserted, 24 wgmma a prefill, 24 decode_split a step; each MoE
     layer's dropped share at prefill (8 groups of 2,048, capacity 171) and
     at a decode step (capacity 1)); the kernel path against the plain path
     at full depth in bf16 (printed with the tokens routed differently, not
     gated) and at depth 4 in f32 (relative L2 of the logits <= 1e-4,
     argmax and every top-k routing equal); flashattn on layer 0's prefill
     and decode inputs against its plain version and SDPA; one full-width
     MoE layer in f32 on the card against the CPU at 4,096 tokens (two
     groups) and 4 (y within 1e-4 relative L2, the drops and the routing
     equal; two calls on the card bit for bit equal);
 10c. [lm mla]: deepseek-v2-236b at full width, its depth cut to 7 layers
     (the dense layer, d_ff 12,288, then 6 MoE layers: MLA 128 heads,
     q_lora 1,536, kv_lora 512, rope 64; 160 experts top-6, d_expert
     1,536, 2 shared; 25.2 B parameters, 50.4 GB) in bf16 from seed 0: 4
     prompts of 1,024 tokens (cache 1,056) and 32 greedy decode steps
     (tokens/s, ms a step, peak memory, the MLA cache's bytes against a GQA
     cache of the same heads, each MoE layer's dropped share; flashattn
     never launched: MLA's core is sdpa, as in the reference); then the
     one-layer MoE gate with the experts cut to 16.

The search configuration is the repo's single-shard deployment,
``EngineDeployConfig()`` (src/repro_torch/configs/range_engine.py, the
reference's): 1M points per shard, d=128, R=32, l2, beam=64,
visit_cap=256, E=4, greedy, result_cap=1024, frontier_rounds=2048,
4096-query batches; f32 and its production int8 setting; the other modes
and the filtered workload through ``overrides()``. The two-tower phase serves the configuration of
src/repro_torch/configs/two_tower_retrieval.py with the search settings of
examples/two_tower_range.py (k=256; beam=32, visit_cap=128, greedy,
result_cap=512); the LM phases serve src/repro_torch/configs/gemma3_27b.py,
qwen2_moe_a27b.py and deepseek_v2_236b.py.
Any failure exits non-zero. The last line is the device JSON.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:   # the H100 SXM's rates: device memory, and each type's dense peak
    from repro_torch.analysis.roofline import (
        F32_FLOPS, HBM_BW, INT8_OPS, PEAK_FLOPS, TF32_FLOPS)
except ModuleNotFoundError:
    sys.exit(f"chip_smoke: the port's package is not in {ROOT}/src: run this script "
             "from a checkout of the repo")

N_QUERIES = 4096            # the deployment's search_4k batch
N_QUERIES_64K = 65_536      # the deployment's search_64k batch ([cells])
VAMANA_N = 250_000          # the Vamana path's corpus ([vamana] to [live]); cut from 1M,
                            # whose build alone took 180 s of the script's limit
FANOUT_QUERIES = 1_024      # the host fan-out's gates ([sharded] (3), [replicated]);
                            # cut from 4,096 for the script's limit
SEED = 0
DIST_TOL = {"float32": dict(rtol=1e-5, atol=1e-5),  # sum order differs
            "bfloat16": dict(rtol=1e-2, atol=1e-5)}
RANGESCAN_TOL = 1e-5        # unit vectors, d=256: reordered f32 dots differ ~1e-6
TT_CHUNK = 65_536           # items a tower embeds at once
LM_PROMPTS, LM_PROMPT_LEN, LM_STEPS = 4, 4096, 32
LM_PARAMS = 27_009_002_240  # gemma3-27b's parameters (sum of the table shapes)
LM_MAX_LEN = LM_PROMPT_LEN + LM_STEPS
LM_BF16_REL = 5e-2          # kernel vs plain path, bf16, full depth: rel. L2 of logits
LM_F32_REL = 1e-4           # the same in f32 at depth 6
MOE_PARAMS = 15_146_059_776  # qwen2-moe-a2.7b's parameters (64 allocated expert rows)
MOE_F32_DEPTH = 4           # the kernel-vs-plain gate's depth in f32
MOE_REL = 1e-4              # that gate's, and the one-layer card-vs-CPU gate's, rel. L2
MLA_LAYERS = 7              # deepseek-v2 at full width: first_dense 1 + 6 MoE layers
MLA_PARAMS = 25_219_261_440
MLA_PROMPT_LEN = 1024
MLA_MAX_LEN = MLA_PROMPT_LEN + LM_STEPS
MLA_GATE_EXPERTS = 16       # the one-layer gate's experts: an f32 CPU copy of 1.5 GB
FLASH_TOL = {"float32": dict(rtol=2e-4, atol=2e-4),    # sum order, q scaled first
             "bfloat16": dict(rtol=1e-2, atol=1e-2)}   # one bf16 ulp of the output
FLASH_CASES = [   # tests/test_kernels.py's five: b, hq, hkv, sq, skv, dh, causal,
    (2, 4, 2, 64, 64, 32, True, 0, 0.0, 0),        # window, softcap, q_offset
    (1, 8, 2, 37, 37, 16, True, 0, 50.0, 0),
    (1, 4, 4, 16, 128, 32, True, 64, 0.0, 112),
    (2, 2, 1, 33, 65, 64, False, 0, 0.0, 0),
    (1, 6, 3, 128, 128, 64, True, 32, 30.0, 0),
]
PORT_KERNELS = ("expand", "gatherdist", "rerank_fetch", "rangescan", "flash")
GRAPH_CALLS = 20            # calls a graph when timing kernels of a few us
TRACE_PAUSE_S = 0.05        # host pause on each side of the step into the traced run
ENTRY_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err",
              "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, repeats: int = 5, graph: bool = True,
            calls: int = 1) -> float:
    """Device time of one call: ``fn`` is captured ``calls`` times in one
    CUDA graph and the graph replayed ``reps`` times between two CUDA
    events, so the host's launch overhead is not counted; the median over
    ``repeats`` such runs. A kernel of a few microseconds takes ``calls``
    > 1: one replay a call would time the host's replay rate (the
    ``[kernel] gatherdist-int8 launch floor`` line times an empty kernel
    both ways). With
    ``graph=False`` the calls themselves run between the events (for
    plain versions whose launches are few against their device time)."""
    import torch
    if not graph:
        fn()
        times = []
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / reps)
        return float(np.median(times))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / (reps * calls))
    return float(np.median(times))


FLUSH_BYTES = 128 * 2**20   # more than the H100's 50 MB L2


def cold_ms(fn, flush, reps: int = 20) -> float:
    """Device time of one call that finds L2 holding none of its inputs:
    ``fn`` is captured once in a CUDA graph, and each of ``reps`` replays
    runs between two CUDA events right after a write of ``flush`` (a
    tensor of FLUSH_BYTES); the median. The write keeps the card busy while
    the host enqueues the events and the replay, so the host's launch
    overhead is not counted."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    times = []
    for _ in range(reps):
        flush.fill_(1.0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(n_bytes: float, ops: float, rate: float = F32_FLOPS) -> tuple[float, str]:
    t_b, t_o = n_bytes / HBM_BW, ops / rate
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def check_close(name, got, want, tol) -> float:
    import torch
    fin = torch.isfinite(want)
    if not torch.equal(fin, torch.isfinite(got)):
        raise AssertionError(f"{name}: +inf pattern differs from the plain version")
    if not torch.allclose(got[fin], want[fin], **tol):
        raise AssertionError(f"{name}: distances differ beyond {tol}")
    return float((got[fin] - want[fin]).abs().max()) if fin.any() else 0.0


def make_frontier(n, qn, e, gen, dev):
    import torch
    from repro_torch.utils import INVALID_ID
    frontier = torch.randint(0, n, (qn, e), generator=gen, device=dev,
                             dtype=torch.int32)
    frontier[::8, 3] = INVALID_ID            # exhausted frontier slots
    frontier[::16, 1] = frontier[::16, 0]    # duplicate frontier nodes
    return frontier


def same_bits(a, b) -> bool:
    """Whether two tuples of tensors hold the same bits."""
    import torch
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x.view(torch.int32), y.view(torch.int32))
        for x, y in zip(a, b))


def expand_bytes(ids, frontier, nbrs, queries, row_bytes: int) -> int:
    """Bytes an expansion must move: each distinct surviving row once, each
    distinct frontier node's adjacency row once, the frontier, the queries
    and the outputs (ids, distances, n_dist)."""
    import torch
    from repro_torch.utils import INVALID_ID
    n, r = nbrs.shape
    kept = ids[ids != INVALID_ID]
    f_ok = frontier[(frontier >= 0) & (frontier < n)]
    return (torch.unique(kept).numel() * row_bytes
            + torch.unique(f_ok).numel() * r * 4 + frontier.numel() * 4
            + queries.numel() * 4 + ids.numel() * 8 + frontier.shape[0] * 4)


def kernel_checks(points, nbrs, queries, gen, dtypes=("float32", "bfloat16"),
                  metrics=("l2", "ip"), widths=(4, 32), tag=""):
    """Each f32/bf16 kernel against its plain version at the main path's
    shapes (E=4, SearchConfig's default; gatherdist at S in ``widths``).
    Returns the JSON entries of the f32 l2 configuration the main path
    runs, where it is among those checked."""
    import torch
    from repro_torch.kernels.expand import expand_cuda, expand_frontier_ref
    from repro_torch.kernels.gatherdist import gatherdist_cuda, gatherdist_ref
    from repro_torch.utils import INVALID_ID
    n, d = points.shape
    r = nbrs.shape[1]
    qn, e = queries.shape[0], 4
    dev = points.device
    frontier = make_frontier(n, qn, e, gen, dev)
    entries = {}
    for dtype in dtypes:
        pts = points.to(getattr(torch, dtype)).contiguous()
        for metric in metrics:
            args = (pts, nbrs, frontier, queries)
            route = kernel_route(expand_cuda, lambda: expand_cuda(*args, metric=metric))
            ids, dd, nd = expand_cuda(*args, metric=metric)
            warp = expand_cuda(*args, metric=metric, route="warp")
            rids, rd, rnd = expand_frontier_ref(*args, metric=metric)
            torch.cuda.synchronize()
            if not (torch.equal(ids, rids) and torch.equal(nd, rnd)):
                raise AssertionError(f"expand {dtype} {metric}: ids/n_dist differ")
            err = check_close(f"expand {dtype} {metric}", dd, rd, DIST_TOL[dtype])
            if not same_bits((ids, dd, nd), warp):
                raise AssertionError(f"expand {dtype} {metric}: the {route} and warp "
                                     "routes differ")
            ms = time_ms(lambda: expand_cuda(*args, metric=metric))
            warp_ms = time_ms(lambda: expand_cuda(*args, metric=metric, route="warp"))
            plain = time_ms(lambda: expand_frontier_ref(*args, metric=metric))
            kept = ids[ids != INVALID_ID]
            n_bytes = expand_bytes(ids, frontier, nbrs, queries,
                                   d * pts.element_size())
            flops = kept.numel() * (3 if metric == "l2" else 2) * d
            b_ms, b_by = bound_ms(n_bytes, flops)
            log(f"[kernel] expand{tag} {dtype} {metric} Q={qn} E={e} R={r} d={d}: "
                f"ids/n_dist equal, max_abs_err={err:.3g}, route {route}: ms={ms:.4f} "
                f"({b_ms / ms:.1%} of the bound), warp route ms={warp_ms:.4f} "
                f"({b_ms / warp_ms:.1%}), bitwise equal; plain_ms={plain:.4f}, "
                f"bound_ms={b_ms:.4f} ({b_by}, {n_bytes / 1e6:.1f} MB), gathered "
                f"rows={kept.numel()}")
            if (dtype, metric) == ("float32", "l2"):
                entries["expand"] = dict(
                    name="expand", route="cuda",
                    source="src/repro_torch/kernels/expand/csrc/expand.cu",
                    replaces="src/repro/kernels/expand/kernel.py:49",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, expand_route=route,
                    warp_ms=warp_ms)
        for s in widths:
            ids = torch.randint(0, n, (qn, s), generator=gen, device=dev,
                                dtype=torch.int32)
            ids[::5, -1] = INVALID_ID
            for metric in metrics:
                args = (pts, ids, queries)
                got = gatherdist_cuda(*args, metric=metric)
                want = gatherdist_ref(*args, metric=metric)
                torch.cuda.synchronize()
                err = check_close(f"gatherdist {dtype} {metric} S={s}", got,
                                  want, DIST_TOL[dtype])
                ms = time_ms(lambda: gatherdist_cuda(*args, metric=metric), calls=GRAPH_CALLS)
                plain = time_ms(lambda: gatherdist_ref(*args, metric=metric))
                ok = ids[(ids >= 0) & (ids < n)]
                n_bytes = (torch.unique(ok).numel() * d * pts.element_size()
                           + ids.numel() * 8 + queries.numel() * 4)
                flops = ok.numel() * (3 if metric == "l2" else 2) * d
                b_ms, b_by = bound_ms(n_bytes, flops)
                log(f"[kernel] gatherdist{tag} {dtype} {metric} Q={qn} S={s} d={d}: "
                    f"max_abs_err={err:.3g}, ms={ms:.4f}, plain_ms={plain:.4f}, "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                if (dtype, metric, s) == ("float32", "l2", 4):
                    entries["gatherdist"] = dict(
                        name="gatherdist", route="cuda",
                        source="src/repro_torch/kernels/gatherdist/csrc/gatherdist.cu",
                        replaces="src/repro/kernels/gatherdist/kernel.py:32",
                        max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                        bound_by=b_by, library_ms=None)
    return entries


def int8_kernel_checks(qc, nbrs, queries, gen):
    """expand-int8 and gatherdist-int8 in both forms against their plain
    versions at the main path's shapes (int32 dots equal in the int8-query
    form), and against each other bit for bit on the candidates they share,
    every route of each; gatherdist-int8 at random start points and at the
    main path's 4 shared ones, on its planned route and the first kernel
    (bit for bit equal), beside an empty kernel on its grid; rerank_fetch
    at P in {1, 17, 4096, 16384, 24576, 32768, 65536} on both routes (regs
    and warp, which the plan takes below REGS_MIN_PAIRS), on random lanes
    and lane-major ones (the band's order, timed).
    Returns the JSON entries of the form the main path runs by default
    (f32-query, l2; ``form`` says so), each with the int8-query form's
    times beside it."""
    import torch
    from repro_torch.kernels._launch import empty_launch
    from repro_torch.kernels.expand import expand_frontier_int8_ref, expand_int8_cuda
    from repro_torch.kernels.gatherdist import gatherdist_int8_cuda, gatherdist_int8_ref
    from repro_torch.kernels.rerank_fetch import fetch_rerank_pairs_ref, rerank_fetch_cuda
    from repro_torch.utils import INVALID_ID
    gather_ops = sys.modules["repro_torch.kernels.gatherdist.ops"]
    n, d = qc.shape
    r = nbrs.shape[1]
    qn, e = queries.shape[0], 4
    dev = qc.device
    frontier = make_frontier(n, qn, e, gen, dev)
    starts = torch.randint(0, n, (qn, 4), generator=gen, device=dev,
                           dtype=torch.int32)
    starts[::5, -1] = INVALID_ID
    # the main path's start points: engine.start_ids (S,) expanded to (Q, S)
    # by init_state, made contiguous by gather_dist
    shared = torch.randint(0, n, (4,), generator=gen, device=dev,
                           dtype=torch.int32).expand(qn, -1).contiguous()
    gp = gather_ops.plan(qn, d)
    def empty():
        empty_launch(gp.blocks, gp.threads, dev)

    floor = time_ms(empty, calls=GRAPH_CALLS)
    log(f"[kernel] gatherdist-int8 launch floor: the empty kernel on its grid "
        f"({gp.blocks} blocks of {gp.threads} threads) ms={floor:.4f} at "
        f"{GRAPH_CALLS} launches a graph, {time_ms(empty):.4f} at one a graph "
        f"(the host's replay rate)")
    tol = DIST_TOL["float32"]
    entries = {}
    for quant in (False, True):
        form = "int8-query" if quant else "f32-query"
        pre = "int8_query_" if quant else ""
        for metric in ("l2", "ip"):
            kw = dict(metric=metric, quantize_query=quant)
            args = (qc.codes, qc.meta, nbrs, frontier, queries)
            route = kernel_route(expand_int8_cuda, lambda: expand_int8_cuda(*args, **kw))
            got = expand_int8_cuda(*args, **kw, return_dots=quant)
            warp = expand_int8_cuda(*args, **kw, return_dots=quant, route="warp")
            want = expand_frontier_int8_ref(qc, nbrs, frontier, queries, **kw,
                                            return_dots=quant)
            torch.cuda.synchronize()
            ids, dd, nd = got[:3]
            if not (torch.equal(ids, want[0]) and torch.equal(nd, want[2])):
                raise AssertionError(f"expand-int8 {form} {metric}: ids/n_dist differ")
            if quant and not torch.equal(got[3], want[3]):
                raise AssertionError(f"expand-int8 {form} {metric}: int32 dots differ")
            err = check_close(f"expand-int8 {form} {metric}", dd, want[1], tol)
            if not same_bits(got, warp):
                raise AssertionError(f"expand-int8 {form} {metric}: the {route} and "
                                     "warp routes differ")
            # the two int8 kernels on the candidates they share: same bits,
            # on each of gatherdist-int8's routes
            keep = ids != INVALID_ID
            for g_route in (None, "warp"):
                g = gatherdist_int8_cuda(qc.codes, qc.meta, ids, queries, **kw,
                                         return_dots=quant, route=g_route)
                torch.cuda.synchronize()
                gd = g[0] if quant else g
                if not torch.equal(gd[keep].view(torch.int32), dd[keep].view(torch.int32)):
                    raise AssertionError(f"{form} {metric}: gatherdist-int8 ({g_route or 'planned'} "
                                         "route) and expand-int8 differ on shared candidates")
                if quant and not torch.equal(g[1][keep], got[3][keep]):
                    raise AssertionError(f"{form} {metric}: the two kernels' dots differ")
            ms = time_ms(lambda: expand_int8_cuda(*args, **kw))
            warp_ms = time_ms(lambda: expand_int8_cuda(*args, **kw, route="warp"))
            plain = time_ms(lambda: expand_frontier_int8_ref(
                qc, nbrs, frontier, queries, **kw))
            n_kept = int(keep.sum())
            n_bytes = expand_bytes(ids, frontier, nbrs, queries, d + 12)
            ops = n_kept * d * (2 if quant else (4 if metric == "l2" else 3))
            b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS if quant else F32_FLOPS)
            log(f"[kernel] expand-int8 {form} {metric} Q={qn} E={e} R={r} d={d}: "
                f"ids/n_dist equal{', dots equal' if quant else ''}, "
                f"max_abs_err={err:.3g}, route {route}: ms={ms:.4f} ({b_ms / ms:.1%} "
                f"of the bound), warp route ms={warp_ms:.4f} ({b_ms / warp_ms:.1%}), "
                f"bitwise equal; plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}, "
                f"{n_bytes / 1e6:.1f} MB), gathered rows={n_kept}; gatherdist-int8 "
                f"on the same {n_kept} candidates, both routes: bitwise equal")
            if (quant, metric) == (False, "l2"):
                entries["expand_int8"] = dict(
                    name="expand_int8", route="cuda",
                    source="src/repro_torch/kernels/expand/csrc/expand_int8.cu",
                    replaces="src/repro/kernels/expand/kernel.py:118",
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, form=form, expand_route=route,
                    warp_ms=warp_ms)
            elif metric == "l2":
                entries["expand_int8"].update(int8_query_ms=ms,
                                              int8_query_warp_ms=warp_ms)
            # gatherdist-int8 at the start points' shape (S=4): random starts
            # (the table's shape) and the main path's 4 shared starts
            gather = {}
            for shape, sids in (("random", starts), ("shared", shared)):
                sargs = (qc.codes, qc.meta, sids, queries)
                g_route = kernel_route(gatherdist_int8_cuda,
                                       lambda: gatherdist_int8_cuda(*sargs, **kw))
                got = gatherdist_int8_cuda(*sargs, **kw, return_dots=quant)
                old = gatherdist_int8_cuda(*sargs, **kw, return_dots=quant, route="warp")
                want = gatherdist_int8_ref(qc, sids, queries, **kw, return_dots=quant)
                torch.cuda.synchronize()
                got, old, want = [x if quant else (x,) for x in (got, old, want)]
                if quant and not torch.equal(got[1], want[1]):
                    raise AssertionError(f"gatherdist-int8 {form} {metric}: dots differ")
                if not same_bits(got, old):
                    raise AssertionError(f"gatherdist-int8 {form} {metric} {shape}: the "
                                         f"{g_route} and warp routes differ")
                err = check_close(f"gatherdist-int8 {form} {metric} {shape}",
                                  got[0], want[0], tol)
                ms = time_ms(lambda: gatherdist_int8_cuda(*sargs, **kw), calls=GRAPH_CALLS)
                old_ms = ms if g_route == "warp" else time_ms(
                    lambda: gatherdist_int8_cuda(*sargs, **kw, route="warp"),
                    calls=GRAPH_CALLS)
                plain = time_ms(lambda: gatherdist_int8_ref(qc, sids, queries, **kw))
                ok = sids[(sids >= 0) & (sids < n)]
                n_bytes = (torch.unique(ok).numel() * (d + 12) + sids.numel() * 8
                           + queries.numel() * 4)
                ops = ok.numel() * d * (2 if quant else (4 if metric == "l2" else 3))
                b_ms, b_by = bound_ms(n_bytes, ops, INT8_OPS if quant else F32_FLOPS)
                gather[shape] = dict(err=err, ms=ms, old_ms=old_ms, plain=plain,
                                     b_ms=b_ms, b_by=b_by, route=g_route)
                log(f"[kernel] gatherdist-int8 {form} {metric} Q={qn} S=4 d={d}, {shape} "
                    f"starts ({torch.unique(ok).numel()} distinct rows): "
                    f"{'dots equal, ' if quant else ''}max_abs_err={err:.3g}, route "
                    f"{g_route}: ms={ms:.4f} ({b_ms / ms:.1%} of the bound), "
                    f"{'planned' if g_route == 'warp' else f'warp route ms={old_ms:.4f}'}"
                    f", bitwise equal; floor {floor:.4f}, "
                    f"plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}, "
                    f"{n_bytes / 1e6:.2f} MB)")
            if metric != "l2":
                continue
            g, m = gather["random"], gather["shared"]
            if not quant:
                entries["gatherdist_int8"] = dict(
                    name="gatherdist_int8", route="cuda",
                    source="src/repro_torch/kernels/gatherdist/csrc/gatherdist_int8.cu",
                    replaces="src/repro/kernels/gatherdist/kernel.py:50",
                    max_abs_err=max(g["err"], m["err"]), ms=g["ms"], plain_ms=g["plain"],
                    bound_ms=g["b_ms"], bound_by=g["b_by"], library_ms=None, form=form,
                    gather_route=g["route"], floor_ms=floor)
            entries["gatherdist_int8"].update({
                f"{pre}ms": g["ms"], f"{pre}main_shape_ms": m["ms"],
                f"{pre}main_shape_bound_ms": m["b_ms"]})
            if g["route"] != "warp":
                entries["gatherdist_int8"].update({
                    f"{pre}old_route_ms": g["old_ms"],
                    f"{pre}main_shape_old_route_ms": m["old_ms"]})
            else:
                entries["gatherdist_int8"][f"{pre}gather_route"] = "warp"
    raw = qc.raw
    for p in (1, 17, 4096, 16384, 24576, 32768, 65536):
        ids = torch.randint(0, n, (p,), generator=gen, device=dev, dtype=torch.int32)
        lanes = torch.randint(0, qn, (p,), generator=gen, device=dev,
                              dtype=torch.int32)
        major = torch.sort(lanes).values     # lane-major, as the band arrives
        for metric in ("l2", "ip"):
            f_route = kernel_route(rerank_fetch_cuda, lambda: rerank_fetch_cuda(
                raw, queries, ids, major, metric=metric))
            errs, times = {}, {}
            for order, ln in (("random", lanes), ("lane-major", major)):
                fargs = (raw, queries, ids, ln)
                want = fetch_rerank_pairs_ref(*fargs, metric)
                for route in ("regs", "warp"):
                    got = rerank_fetch_cuda(*fargs, metric=metric, route=route)
                    torch.cuda.synchronize()
                    errs[route] = max(errs.get(route, 0.0), check_close(
                        f"rerank_fetch P={p} {metric} {order} {route}", got, want, tol))
            for route in ("regs", "warp"):
                times[route] = time_ms(lambda: rerank_fetch_cuda(
                    raw, queries, ids, major, metric=metric, route=route),
                    calls=GRAPH_CALLS)
            log(f"[kernel] rerank_fetch {metric} P={p} d={d} (random and lane-major "
                f"lanes; times lane-major): planned route {f_route}; regs "
                f"max_abs_err={errs['regs']:.3g}, ms={times['regs']:.4f}; warp "
                f"max_abs_err={errs['warp']:.3g}, ms={times['warp']:.4f}")
    return entries


def rerank_at_band(eng_q, queries, r, cfg, launches: int):
    """rerank_fetch against its plain version on the very pairs one int8
    main-path batch sends it: the band, taken from the rerank-disabled
    result as the result stage takes it. Each route (the planned one and
    the other) within tolerance and timed warm (graph replays: the rows sit
    in L2) and cold (L2 flushed before each launch, in turns), beside an
    empty kernel on the planned grid.
    Returns its JSON entry."""
    import torch
    from repro_torch.core import upper_bound_dists
    from repro_torch.kernels._launch import empty_launch
    from repro_torch.kernels.rerank_fetch import fetch_rerank_pairs_ref, rerank_fetch_cuda
    from repro_torch.utils import INVALID_ID
    fetch_ops = sys.modules["repro_torch.kernels.rerank_fetch.ops"]
    qc = eng_q.points
    pre = eng_q.range(queries, r, cfg=dataclasses.replace(cfg, rerank=False))
    valid = pre.ids != INVALID_ID
    ub = upper_bound_dists(qc, torch.where(valid, pre.ids, 0), pre.dists,
                           queries, "l2")
    lanes, slots = torch.nonzero(valid & (ub > r), as_tuple=True)
    ids = pre.ids[lanes, slots].contiguous()
    lanes = lanes.to(torch.int32).contiguous()
    p = ids.numel()
    if p == 0:
        raise AssertionError("the greedy int8 batch has an empty band")
    args = (qc.raw, queries, ids, lanes)
    route = kernel_route(rerank_fetch_cuda, lambda: rerank_fetch_cuda(*args))
    routes = tuple(dict.fromkeys((route, "regs", "warp")))
    want = fetch_rerank_pairs_ref(*args)
    errs = {}
    for rt in routes:
        got = rerank_fetch_cuda(*args, route=rt)
        torch.cuda.synchronize()
        errs[rt] = check_close(f"rerank_fetch at the band, route {rt}", got, want,
                               DIST_TOL["float32"])
    warm = {rt: time_ms(lambda: rerank_fetch_cuda(*args, route=rt)) for rt in routes}
    flush = torch.empty(FLUSH_BYTES // 4, device=qc.raw.device)
    cold = dict.fromkeys(routes, 0.0)
    for rt in routes + routes[::-1]:     # in turns: a, b, b, a
        cold[rt] += cold_ms(lambda: rerank_fetch_cuda(*args, route=rt), flush) / 2
    del flush
    blocks, threads = fetch_ops.launch_grid(p, qc.shape[1], route, qc.raw.device)
    floor = time_ms(lambda: empty_launch(blocks, threads, qc.raw.device),
                    calls=GRAPH_CALLS)
    plain = time_ms(lambda: fetch_rerank_pairs_ref(*args))
    d = qc.shape[1]
    n_rows = torch.unique(ids).numel()
    n_bytes = (n_rows + torch.unique(lanes).numel()) * d * 4 + p * 12
    b_ms, b_by = bound_ms(n_bytes, p * d * 3)
    runs = torch.unique_consecutive(lanes).numel()
    log(f"[kernel] rerank_fetch l2 at the greedy band P={p} ({n_rows} distinct rows, "
        f"{runs} runs of one lane) d={d}: route {route}: max_abs_err={errs[route]:.3g}, "
        f"ms={warm[route]:.4f} ({b_ms / warm[route]:.1%} of the bound), cold "
        f"{cold[route]:.4f} ({b_ms / cold[route]:.1%}; L2 flushed before each "
        f"launch); warp route ms={warm['warp']:.4f}, cold {cold['warp']:.4f}; "
        f"floor {floor:.4f} ({blocks} blocks of {threads} threads); plain_ms={plain:.4f}, "
        f"bound_ms={b_ms:.4f} ({b_by}); every pair's row read once: "
        f"{p * d * 4 / 1e6:.1f} MB, {p * d * 4 / HBM_BW * 1e3:.4f} ms")
    return dict(name="rerank_fetch", route="cuda",
                source="src/repro_torch/kernels/rerank_fetch/csrc/rerank_fetch.cu",
                replaces="src/repro/kernels/rerank_fetch/kernel.py:31",
                launches=launches, max_abs_err=errs[route], ms=warm[route],
                plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None,
                fetch_route=route, old_route_ms=warm["warp"], floor_ms=floor,
                cold_ms=cold[route], old_route_cold_ms=cold["warp"])


def trace_launches(rows, names) -> dict:
    """Launches of each of the port's kernels in a trace, by wrapper name
    (``names``): a kernel belongs to the longest name its function's name
    begins with (``gatherdist_int8_regs_kernel`` to ``gatherdist_int8``,
    ``gatherdist_kernel`` to ``gatherdist``)."""
    every = set(names) | set(PORT_KERNELS) | {"expand_int8", "gatherdist_int8"}
    found = dict.fromkeys(names, 0)
    for e in rows:
        m = re.search(r"::(\w+)[<(]", e.key) or re.match(r"(\w+)", e.key)
        fname = m.group(1) if m else ""
        owner = max((n for n in every if fname.startswith(n + "_")), key=len,
                    default=None)
        if owner in found:
            found[owner] += e.count
    return found


def profile_run(fn, wall_s: float, name: str, kernels=None) -> None:
    """Device time by kernel over one traced run of ``fn``, and the device's
    busy share of ``wall_s``, the untraced run's wall time. ``fn`` runs
    twice: once while the tracer warms up, then traced, with a pause of
    TRACE_PAUSE_S on each side of the step between them. A kernel that runs
    right at the start of a trace (the search's first, gatherdist) was
    missing from some traces on an H100: with no warm-up in 6 of 7 traced
    modes, with the warm-up alone in 1 of 8; with the pause after the step
    alone, the warm-up's last kernels (3 expand-int8 launches and its
    rerank_fetch) landed in the traced window once. With ``kernels``
    (wrapper name to wrapper), the traced run's launch counts must equal
    the trace's."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAUSE_S)
        prof.step()
        for k in (kernels or {}).values():
            k.launches = 0
        time.sleep(TRACE_PAUSE_S)
        fn()
        torch.cuda.synchronize()
        prof.step()
    # kernel rows only: the CPU-side op rows carry their kernels' time too,
    # and the schedule's ProfilerStep* row spans the whole step
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith("ProfilerStep")]
    if not rows:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    total_us = sum(e.self_device_time_total for e in rows)
    log(f"[profile] {name}: device busy {total_us / 1e3:.2f} ms of "
        f"{wall_s * 1e3:.2f} ms wall ({total_us / 1e4 / wall_s:.1f}%), "
        f"{sum(e.count for e in rows)} kernels")
    rows.sort(key=lambda e: -e.self_device_time_total)
    # the eight largest, then the port's own kernels that are not among them
    own = [e for e in rows[8:] if any(k in e.key for k in PORT_KERNELS)]
    for e in rows[:8] + own:
        log(f"[profile] {name}:   {e.self_device_time_total / 1e3:9.3f} ms "
            f"{e.count:6d}x  {e.key[:90]}")
    if kernels:
        counted = {n: k.launches for n, k in kernels.items()}
        traced = trace_launches(rows, list(kernels))
        log(f"[profile] {name}: the port's launches in the trace {traced}, by the "
            f"wrappers' counts {counted}")
        if traced != counted:
            raise AssertionError(f"{name}: the trace holds launches {traced}, the "
                                 f"wrappers counted {counted}")


GEMM_KERNELS = ("gemm", "xmma", "nvjet", "cutlass")   # cuBLAS's kernel names


def profile_layers(fn, wall_s: float, name: str) -> None:
    """One traced run of an LM call ``fn`` with its attention and MoE
    layers each in a ``record_function`` range: the device time of the
    attention layers (the flash kernel's share), of the MoE layers split
    into GEMM kernels (router, experts, shared experts) and the rest
    (routing, sort, position scan, scatter, gather, combine), and of the
    rest of the call, against ``wall_s``; the MoE layers' largest non-GEMM
    kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import transformer
    names = ("gqa_attention", "mla_attention", "moe_layer")
    inner = {n: getattr(transformer, n) for n in names}

    def ranged(n, f):
        def call(*args, **kw):
            with record_function(f"lm.{n}"):
                return f(*args, **kw)
        return call

    fn()
    torch.cuda.synchronize()
    try:
        for n, f in inner.items():
            setattr(transformer, n, ranged(n, f))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for n, f in inner.items():
            setattr(transformer, n, f)

    def kernels(evt):
        yield from evt.kernels
        for child in evt.cpu_children:
            yield from kernels(child)

    # every device row of the trace; flashattn's launches go through ctypes,
    # outside the op tree, so its time is read here and not under a range
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
            and not e.key.startswith(("lm.", "ProfilerStep"))]   # not the ranges
    total = sum(e.self_device_time_total for e in rows) / 1e3
    flash = sum(e.self_device_time_total for e in rows if "flash" in e.key) / 1e3
    split = {n: [] for n in names}
    for e in prof.events():
        if e.name.startswith("lm.") and e.name[3:] in split:
            split[e.name[3:]].extend(kernels(e))
    if total <= 0:
        raise AssertionError(f"{name}: the profiler recorded no device time")
    attn = [k for k in split["gqa_attention"] + split["mla_attention"] if "flash" not in k.name]
    moe = split["moe_layer"]
    ms = lambda ks: sum(k.duration for k in ks) / 1e3   # noqa: E731
    gemm = [k for k in moe if any(g in k.name for g in GEMM_KERNELS)]
    glue = [k for k in moe if not any(g in k.name for g in GEMM_KERNELS)]
    by_name: dict = {}
    for k in glue:
        by_name[k.name] = by_name.get(k.name, 0.0) + k.duration / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"[profile] {name}: device busy {total:.2f} ms of {wall_s * 1e3:.2f} ms wall "
        f"({total / wall_s / 10:.1f}%); attention layers {ms(attn):.2f} ms over "
        f"{len(attn)} kernels (projections, norms, rope, cache writes; MLA's core) and "
        f"flashattn {flash:.2f}; MoE layers {ms(moe):.2f} ms: GEMM (router, experts, "
        f"shared) {ms(gemm):.2f} over {len(gemm)} kernels, the rest (routing, sort, "
        f"scan, scatter, gather, combine) {ms(glue):.2f} over {len(glue)}; everything "
        f"else {total - ms(attn) - flash - ms(moe):.2f}; "
        f"the MoE layers' largest non-GEMM kernels: "
        + "; ".join(f"{v:.3f} ms {k[:60]}" for k, v in top))


def _check_shapes(res, qn, cap, name):
    import torch
    from repro_torch.utils import INVALID_ID
    if tuple(res.ids.shape) != (qn, cap) or tuple(res.count.shape) != (qn,):
        raise AssertionError(f"{name}: result shapes {tuple(res.ids.shape)}")
    valid = res.ids != INVALID_ID
    if not torch.equal(valid.sum(1).to(torch.int32), res.count):
        raise AssertionError(f"{name}: count != valid rows")
    return torch.nonzero(valid, as_tuple=True)


def check_result(res, points, queries, r, cap, name) -> None:
    """Shapes, padding, and every returned id truly in range at its exact
    distance (recomputed here in plain PyTorch)."""
    import torch
    from repro_torch.core import point_dist
    lane, slot = _check_shapes(res, queries.shape[0], cap, name)
    exact = point_dist(points[res.ids[lane, slot].long()], queries[lane], "l2")
    got = res.dists[lane, slot]
    if not torch.isfinite(got).all() or not (exact <= r + 1e-5).all():
        raise AssertionError(f"{name}: a returned id is out of range")
    if not torch.allclose(got, exact, rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{name}: returned distances are not exact")


def check_result_int8(res, points, queries, r, cap, name) -> None:
    """The int8 path returns exact distances only inside the band and
    certified lower bounds elsewhere: every returned id lies within r at
    its exact distance, no returned distance exceeds the exact one."""
    import torch
    from repro_torch.core import point_dist
    lane, slot = _check_shapes(res, queries.shape[0], cap, name)
    exact = point_dist(points[res.ids[lane, slot].long()], queries[lane], "l2")
    got = res.dists[lane, slot]
    if not torch.isfinite(got).all() or not (exact <= r + 1e-5).all():
        raise AssertionError(f"{name}: a returned id is out of range "
                             "(a false positive)")
    if not (got <= exact + 1e-5).all():
        raise AssertionError(f"{name}: a returned distance exceeds the exact one")


def check_sync_count(engine, queries, r, cfg, name) -> None:
    """One ``compacted=True`` batch under ``trace.card_syncs``: every
    synchronizing call the card reports from the port's code is one the
    ``host_syncs`` counter adds, so the counter misses no sync."""
    from repro_torch import trace
    before = trace.counters().get("host_syncs", 0)
    frames = trace.card_syncs(lambda: engine.range(queries, r, cfg=cfg, compacted=True))
    counted = trace.counters().get("host_syncs", 0) - before
    sites: dict = {}
    for f in frames:
        key = f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}" if f else "outside the port"
        sites[key] = sites.get(key, 0) + 1
    reported = sum(1 for f in frames if f)
    log(f"[syncs] {name}: {reported} synchronizing calls reported from the port, "
        f"{counted} counted in host_syncs; sites {sites}")
    if reported == 0 or counted != reported:
        raise AssertionError(f"{name}: host_syncs counted {counted} syncs where the "
                             f"card reported {reported} from the port")


def check_guard_band(eng_q, points, queries, r, cfg, name, tol=1e-6):
    """The guard-band contract (tests/test_oracle.py (c)): on every lane
    whose buffer did not overflow, the post-rerank set equals the
    rerank-disabled set filtered by the exact distances. The exact
    distances here are recomputed in plain PyTorch, which sums in another
    order than the rerank kernel, so a pair within ``tol`` of r may fall
    either way; every other pair must be decided as the filter decides it.
    Returns (lanes checked, pairs within tol of r)."""
    import torch
    from repro_torch.core import point_dist
    from repro_torch.utils import INVALID_ID
    res = eng_q.range(queries, r, cfg=cfg)
    pre = eng_q.range(queries, r, cfg=dataclasses.replace(cfg, rerank=False))
    valid = pre.ids != INVALID_ID
    lane, slot = torch.nonzero(valid, as_tuple=True)
    exact = torch.full(pre.dists.shape, torch.inf, device=pre.dists.device)
    exact[lane, slot] = point_dist(points[pre.ids[lane, slot].long()],
                                   queries[lane], "l2")
    ids_post, ids_pre = res.ids.cpu().numpy(), pre.ids.cpu().numpy()
    sure_in = (valid & (exact <= r - tol)).cpu().numpy()
    maybe_in = (valid & (exact <= r + tol)).cpu().numpy()
    over = (res.overflow | pre.overflow).cpu().numpy()
    checked = 0
    for i in range(ids_post.shape[0]):
        if over[i]:
            continue
        got = set(ids_post[i][ids_post[i] != INVALID_ID].tolist())
        if not (set(ids_pre[i][sure_in[i]].tolist()) <= got
                <= set(ids_pre[i][maybe_in[i]].tolist())):
            raise AssertionError(f"{name}: guard-band contract broken on lane {i}")
        checked += 1
    return checked, int((maybe_in & ~sure_in).sum())


class _Recorder:
    """Stands in for a kernel wrapper: records each call's arguments, calls
    the wrapper, and reads and writes the wrapper's own counters (the
    wrapper counts through its module-level name)."""

    def __init__(self, inner, record):
        object.__setattr__(self, "inner", inner)
        object.__setattr__(self, "record", record)

    def __call__(self, *args, **kw):
        self.record(self.inner, args, kw)
        return self.inner(*args, **kw)

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        setattr(self.inner, name, value)


class ExpandCapture:
    """Swaps ``kernels.expand.ops``' two kernel wrappers for recorders that
    also keep each launch's inputs (frontier and queries cloned; corpus and
    adjacency, which the walk never writes, by reference) for a replay on
    each route. They launch what they wrap, so the counts and routes move
    as they would; used on the warm-up run only."""

    NAMES = {"expand_cuda": 2, "expand_int8_cuda": 3}   # the frontier's position

    def __init__(self):
        from repro_torch.kernels.expand import ops
        self.ops, self.kept = ops, []

    def _record(self, inner, args, kw):
        fi = self.NAMES[inner.__name__]
        self.kept.append((inner, [a.clone() if i in (fi, fi + 1) else a
                                  for i, a in enumerate(args)], dict(kw)))

    def __enter__(self):
        self.inner = {name: getattr(self.ops, name) for name in self.NAMES}
        for name, fn in self.inner.items():
            setattr(self.ops, name, _Recorder(fn, self._record))
        return self

    def __exit__(self, *exc):
        for name, fn in self.inner.items():
            setattr(self.ops, name, fn)


def served_replay(kept, name: str, row_bytes: int) -> dict:
    """The launches one served batch made, replayed on each route in one
    CUDA graph: every launch's outputs bit for bit equal on the two routes,
    each route's summed device time, and the bound of the whole batch (each
    launch's distinct kept rows, adjacency rows, inputs and outputs at the
    card's memory rate). Returns the entry's served_* numbers."""
    import torch
    if not kept:
        raise AssertionError(f"{name}: no expand launch was captured")
    kernel = kept[0][0]
    n_bytes = 0
    for fn, args, kw in kept:
        got = fn(*args, **kw)
        warp = fn(*args, **kw, route="warp")
        torch.cuda.synchronize()
        if not same_bits(got, warp):
            raise AssertionError(f"{name}: a served launch differs between the routes")
        n_bytes += expand_bytes(got[0], args[-2], args[-3], args[-1], row_bytes)
    routes = dict(kernel.routes)
    sums = {route: time_ms(lambda: [fn(*args, **kw, route=route) for fn, args, kw in kept],
                           reps=3, repeats=3)
            for route in ("bulk", "warp")}
    moved = {r: kernel.routes[r] - routes[r] for r in routes}
    if moved["bulk"] == 0 or moved["warp"] == 0:
        raise AssertionError(f"{name}: the replay moved the routes {moved}")
    n = len(kept)
    bound = n_bytes / HBM_BW * 1e3
    lanes = np.array([[args[-2].shape[0], int(((args[-2] >= 0) & (args[-2] < args[-3].shape[0]))
                                             .any(1).sum())] for _, args, _ in kept])
    log(f"[served] {name}: lanes a launch median {np.median(lanes[:, 0]):.0f} (max "
        f"{lanes[:, 0].max()}), live lanes median {np.median(lanes[:, 1]):.0f} (max "
        f"{lanes[:, 1].max()}, all launches {lanes[:, 1].sum()})")
    log(f"[served] {name}: {n} expand launches replayed in one CUDA graph: bulk "
        f"{sums['bulk']:.4f} ms ({sums['bulk'] / n * 1e3:.2f} us a launch), warp "
        f"{sums['warp']:.4f} ms ({sums['warp'] / n * 1e3:.2f} us a launch), "
        f"bulk/warp {sums['bulk'] / sums['warp']:.3f}; bound {bound:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB); every launch bitwise equal on the two routes")
    return dict(served_ms=sums["bulk"], served_warp_ms=sums["warp"],
                served_launches=n, served_bound_ms=bound)


def run_mode(engine, queries, r, cfg, kernels, profile: bool, name, capture=None):
    """One main-path run of one mode, with every launch and route count set
    to 0 just before and read just after; ``capture`` (a context) wraps the
    warm-up run. Returns (result, wall seconds, counts, routes)."""
    import torch
    with capture or contextlib.nullcontext():
        engine.range(queries, r, cfg=cfg)                  # warm-up
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "routes"):
            k.routes = dict.fromkeys(k.routes, 0)
    t0 = time.perf_counter()
    res = engine.range(queries, r, cfg=cfg, compacted=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: k.launches for n, k in kernels.items()}
    routes = {n: dict(k.routes) for n, k in kernels.items() if hasattr(k, "routes")}
    if profile:
        profile_run(lambda: engine.range(queries, r, cfg=cfg), dt, name, kernels)
    return res, dt, counts, routes


SERVED_ROUTES = {"expand": "bulk", "expand_int8": "bulk", "gatherdist_int8": "regs",
                 "rerank_fetch": "regs"}   # the route each kernel's served launches take


def check_routes(routes: dict, counts: dict, name: str, expect=None) -> None:
    """Every launch of a served run took the kernel's redesigned route
    (``SERVED_ROUTES``: expand's bulk, gatherdist-int8's regs), or the one
    ``expect`` names for it (rerank_fetch: its plan's for the band)."""
    for k, by_route in routes.items():
        served = (expect or {}).get(k, SERVED_ROUTES[k])
        want = {rt: counts[k] if rt == served else 0 for rt in by_route}
        if by_route != want:
            raise AssertionError(f"{name}: {k} routes {by_route} of {counts[k]} launches")


def kernel_route(kernel, fn) -> str:
    """Call ``fn`` (one call of ``kernel``'s wrapper) and name the route it
    took, by the wrapper's route counts."""
    before = dict(kernel.routes)
    fn()
    moved = [r for r, n in kernel.routes.items() if n != before[r]]
    if len(moved) != 1:
        raise AssertionError(f"{kernel.__name__}: one call moved the routes {moved}")
    return moved[0]


def rangescan_checks(queries, q1, items, r, launches: int, routes: dict):
    """rangescan against its plain version at k=128 and k=256, on the
    512-request batch, on 64 of its requests and on 1, every lane
    (``compare_scans`` excuses only what f32 rounding explains), with the
    route of each call; times at 512 requests and at 1 (k=256) against both
    bounds (the f32 pipes; three TF32 products on the tensor cores, the
    lower and the one the JSON entry carries), the SIMT route on the same
    inputs, the plain version and the product alone. ``launches`` and
    ``routes`` are the served batch's. Returns the JSON entry."""
    import torch
    from repro_torch.kernels.rangescan import rangescan_cuda, rangescan_dists, rangescan_ref
    from repro_torch.kernels.rangescan.ref import compare_scans
    n, d = items.shape
    max_err = 0.0
    for k in (128, 256):
        for name, qq in ((f"Q={queries.shape[0]}", queries), ("Q=64", queries[:64]),
                         ("Q=1", q1)):
            got = []
            route = kernel_route(rangescan_cuda, lambda: got.extend(rangescan_cuda(qq, items, r, k=k, metric="ip")))
            want = rangescan_ref(qq, items, r, k=k, metric="ip")
            dist = rangescan_dists(qq, items, "ip")
            torch.cuda.synchronize()
            excused, unexcused, err = compare_scans(got, want, dist, r, RANGESCAN_TOL)
            if unexcused:
                raise AssertionError(f"rangescan k={k} {name}: {unexcused} "
                                     "differences from the plain version beyond "
                                     "f32 rounding")
            max_err = max(max_err, err)
            log(f"[kernel] rangescan ip k={k} {name} N={n} d={d} route={route}: counts, "
                f"ids and ranks equal to the plain version on every lane but {excused} "
                f"excused (pairs within {RANGESCAN_TOL:g} of r or of each other), "
                f"max_abs_err={err:.3g}, in-range counts "
                f"{want[2].min().item()}..{want[2].max().item()}")
            del dist
    out = dict(name="rangescan", route="cuda",
               source="src/repro_torch/kernels/rangescan/csrc/rangescan.cu",
               replaces="src/repro/kernels/rangescan/kernel.py:73",
               launches=launches, max_abs_err=max_err)
    for qq, tag, reps in ((queries, "", 10), (q1, "q1_", 50)):
        qn = qq.shape[0]
        route = kernel_route(rangescan_cuda, lambda: rangescan_cuda(qq, items, r, k=256, metric="ip"))
        times = {k: time_ms(lambda: rangescan_cuda(qq, items, r, k=k, metric="ip"),
                            reps=reps, repeats=3) for k in (128, 256)}
        simt = time_ms(lambda: rangescan_cuda(qq, items, r, k=256, metric="ip", route="simt"),
                       reps=reps, repeats=3)
        plain = time_ms(lambda: rangescan_ref(qq, items, r, k=256, metric="ip"),
                        reps=2 if qn > 1 else 10, repeats=3, graph=False)
        lib = time_ms(lambda: torch.matmul(qq, items.T), reps=reps, repeats=3)
        n_bytes = n * d * 4 + qn * d * 4 + qn * 256 * 8 + qn * 4
        flops = 2.0 * qn * n * d
        b_f32, by_f32 = bound_ms(n_bytes, flops, F32_FLOPS)
        b_ms, b_by = bound_ms(n_bytes, 3 * flops, TF32_FLOPS)
        ms = times[256]
        log(f"[kernel] rangescan ip Q={qn} N={n} d={d} route={route}: ms={ms:.4f} "
            f"(k=256), {times[128]:.4f} (k=128), {flops / ms / 1e9:.1f} TFLOP/s; "
            f"bound_ms={b_ms:.4f} ({b_by}, 3xTF32 on the tensor cores at "
            f"{TF32_FLOPS / 1e12:.0f} TFLOP/s, {b_ms / ms * 100:.1f}% of it), "
            f"f32-pipe bound {b_f32:.4f} ({by_f32}, {F32_FLOPS / 1e12:.0f} TFLOP/s, "
            f"{b_f32 / ms * 100:.1f}%); the simt route {simt:.4f} ms; plain_ms={plain:.4f}; "
            f"the product alone (torch.matmul, TF32 off) {lib:.4f} ms, "
            f"ratio {ms / lib:.3f}")
        out.update({f"{tag}ms": ms, f"{tag}plain_ms": plain,
                    f"{tag}bound_ms": b_ms, f"{tag}bound_by": b_by,
                    f"{tag}library_ms": lib, f"{tag}scan_route": route,
                    f"{tag}simt_ms": simt, f"{tag}f32_bound_ms": b_f32})
    out["routes"] = routes
    return out


def ip_radius(items, sample, dev, name: str) -> float:
    """The radius the paper's way (sweep + select_radius, half the sample
    answering empty) over unit vectors at ip."""
    from repro_torch.core import default_grid, exact_topk, match_histogram, select_radius, sweep
    t0 = time.perf_counter()
    base = default_grid(items, sample, metric="ip", num=48)
    # the sampled grid's low end already holds many matches among 1M items,
    # and a request answers empty below its nearest item's distance: extend
    # the grid down through the sample's nearest distances (finely) and to
    # -1, the least ip between unit vectors
    nearest = exact_topk(items, sample, k=1, metric="ip", device=dev)[1][:, 0]
    lo, hi = float(nearest.min()), float(nearest.max())
    grid = np.unique(np.concatenate([[-1.0], np.linspace(lo, hi, 128), base])
                     .astype(np.float32))
    prof = sweep(items, sample, grid, metric="ip", device=dev)
    r, gi = select_radius(prof, target_zero_frac=0.5)
    log(f"[radius] {name}: r={r:.6g} (grid index {gi} of {grid.size}, "
        f"{grid[0]:.4f}..{grid[-1]:.4f}; the sample's nearest items at "
        f"{lo:.4f}..{hi:.4f}, median {float(nearest.median()):.4f}; zero-result "
        f"fraction {prof.zero_frac[gi]:.3f} on {sample.shape[0]} requests; "
        f"{time.perf_counter() - t0:.2f} s); sample matches "
        f"{match_histogram(prof.counts[:, gi])}")
    return r


def two_tower_ap_probes(engine, items, queries, held, r, gt, cfg_r, dev) -> None:
    """Where the graph half's AP goes: held-out items as queries
    (similar-items retrieval) at their own radius, chosen the same way, and
    both kinds of query through a 4x beam and an 8x visit budget on the
    same graph. Prints only; it gates nothing."""
    from repro_torch.core import average_precision, exact_range_search, match_histogram
    r_ii = ip_radius(items, held[:256], dev, "two-tower ip (held-out items)")
    gt_ii = exact_range_search(items, held, r_ii, metric="ip", device=dev)
    gt_ii = (gt_ii[0].cpu().numpy(), gt_ii[2].cpu().numpy())
    res_ii = engine.range(held, r_ii, cfg=cfg_r)
    ap_ii = average_precision(*gt_ii, res_ii.ids.cpu().numpy(), res_ii.count.cpu().numpy())
    log(f"[two_tower] graph engine control, {held.shape[0]} held-out items as "
        f"queries: AP={ap_ii:.4f}, mean n_dist {float(res_ii.n_dist.float().mean()):.0f}, "
        f"matches {match_histogram(gt_ii[1])}")
    wide = dataclasses.replace(cfg_r, search=dataclasses.replace(
        cfg_r.search, beam=128, max_beam=128, visit_cap=1024))
    for name, qq, rr, (g_ids, g_cnt) in (("user requests", queries, r, gt),
                                         ("held-out items", held, r_ii, gt_ii)):
        res_w = engine.range(qq, rr, cfg=wide)
        ap_w = average_precision(g_ids, g_cnt, res_w.ids.cpu().numpy(),
                                 res_w.count.cpu().numpy())
        log(f"[two_tower] graph engine probe, beam=128 visit_cap=1024, {name}: "
            f"AP={ap_w:.4f}, mean n_dist {float(res_w.n_dist.float().mean()):.0f}")


def two_tower_phase(dev, kernels, ap_probes: bool = False, profile: bool = False) -> dict:
    """Two-tower retrieval serving at full width: the item corpus, the
    requests, the radius, brute-force serving through rangescan, the graph
    engine on the same corpus at ip, and rangescan against its plain
    version. ``ap_probes`` adds ``two_tower_ap_probes``; ``profile`` traces
    the brute-force batch. Returns the kernels JSON entry of rangescan."""
    import torch
    from repro_torch.configs.two_tower_retrieval import ARCH
    from repro_torch.core import (
        RangeConfig, RangeSearchEngine, SearchConfig, average_precision,
        build_knn_graph, exact_range_search, match_histogram, point_dist)
    from repro_torch.kernels.rangescan import rangescan
    from repro_torch.kernels.rangescan.ref import compare_scans
    from repro_torch.models import init_tower
    cfg = ARCH.model_cfg
    n_items = ARCH.shapes["retrieval_cand"].n_candidates
    n_req = ARCH.shapes["serve_p99"].global_batch
    k = 256                                   # examples/two_tower_range.py
    log(f"[two_tower] {ARCH.arch_id}: {cfg.n_sparse} user + "
        f"{cfg.tower_fields('item')} item fields, vocab {cfg.vocab:,}, d_embed "
        f"{cfg.d_embed}, towers {cfg.tower_dims('item')}, {n_items:,} items, "
        f"{n_req} requests (serve_p99) and 1 (retrieval_cand)")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the item corpus: item tower from seed 0, embedded in chunks, freed --
    item_sparse = np.random.default_rng(1).integers(
        0, cfg.vocab, (n_items, cfg.tower_fields("item")))
    t0 = time.perf_counter()
    tower = init_tower(cfg, "item", seed=0, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    ids = torch.as_tensor(item_sparse, device=dev)
    items = torch.empty((n_items, cfg.d_out), device=dev)
    for c0 in range(0, n_items, TT_CHUNK):
        items[c0:c0 + TT_CHUNK] = tower(ids[c0:c0 + TT_CHUNK])
    held = None
    if ap_probes:   # held-out items, the queries of the similar-items control
        held = tower(torch.as_tensor(np.random.default_rng(3).integers(
            0, cfg.vocab, (n_req, cfg.tower_fields("item"))), device=dev))
    torch.cuda.synchronize()
    t_embed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    table_bytes = tower.tables.numel() * tower.tables.element_size()
    del tower, ids
    torch.cuda.empty_cache()
    norms = items.norm(dim=1)
    if not (torch.isfinite(items).all() and torch.allclose(norms, torch.ones_like(norms),
                                                           atol=1e-5)):
        raise AssertionError("item embeddings are not finite unit vectors")
    log(f"[two_tower] item tower (seed 0, tables {table_bytes / 1e9:.2f} GB) "
        f"built in {t_init:.2f} s; {n_items:,} items embedded in {t_embed:.2f} s "
        f"in chunks of {TT_CHUNK}; peak device memory {peak / 1e9:.2f} GB; item "
        f"tower freed; corpus ({n_items}, {cfg.d_out}) f32, unit norm")

    # -- the requests: user tower from seed 1 -------------------------------
    rng = np.random.default_rng(2)
    users = {name: torch.as_tensor(rng.integers(0, cfg.vocab, (b, cfg.n_sparse)),
                                   device=dev)
             for name, b in (("serve_p99", n_req), ("retrieval_cand", 1),
                             ("sample", 256))}
    t0 = time.perf_counter()
    user_tower = init_tower(cfg, "user", seed=1, device=dev)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    t0 = time.perf_counter()
    queries = user_tower(users["serve_p99"])
    q1 = user_tower(users["retrieval_cand"])
    sample = user_tower(users["sample"])
    torch.cuda.synchronize()
    log(f"[two_tower] user tower (seed 1) built in {t_init:.2f} s; {n_req} + 1 + "
        f"256 requests embedded in {(time.perf_counter() - t0) * 1e3:.1f} ms; "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- the radius, the paper's way, at ip ---------------------------------
    r = ip_radius(items, sample, dev, "two-tower ip")
    gt_ids, gt_d, gt_counts = exact_range_search(items, queries, r, metric="ip",
                                                 device=dev)
    gt1 = exact_range_search(items, q1, r, metric="ip", device=dev)
    gt_np, gc_np = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    log(f"[oracle] two-tower: matches of the {n_req} requests "
        f"{match_histogram(gc_np)}; retrieval_cand {int(gt1[2][0])}")

    # -- brute-force serving: user tower + rangescan --------------------------
    def brute(u):
        return rangescan(user_tower(u), items, r, k=k, metric="ip")

    brute(users["serve_p99"])
    torch.cuda.synchronize()
    scan = kernels["rangescan"]
    for kern in kernels.values():
        kern.launches = 0
    scan.routes = dict.fromkeys(scan.routes, 0)
    t0 = time.perf_counter()
    ids_bf, d_bf, c_bf = brute(users["serve_p99"])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = {n: kern.launches for n, kern in kernels.items()}
    routes = dict(scan.routes)
    if counts["rangescan"] != 1 or routes != {**dict.fromkeys(routes, 0), "wgmma": 1}:
        raise AssertionError(f"brute force: launches {counts}, routes {routes}")
    q1_route = kernel_route(scan, lambda: brute(users["retrieval_cand"]))
    t0 = time.perf_counter()
    _, _, c_alone = rangescan(queries, items, r, k=k, metric="ip")
    torch.cuda.synchronize()
    dt_alone = time.perf_counter() - t0
    lat = []
    for _ in range(20):
        t0 = time.perf_counter()
        brute(users["retrieval_cand"])
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    _, unexcused, _ = compare_scans(
        (ids_bf, d_bf, c_bf), (gt_ids[:, :k], gt_d[:, :k], gt_counts),
        -(queries @ items.T), r, RANGESCAN_TOL)
    if unexcused or not torch.equal(c_bf, c_alone):
        raise AssertionError(f"brute force: {unexcused} differences from "
                             "exact_range_search beyond f32 rounding")
    c_np = c_bf.cpu().numpy()
    lo = gc_np <= k
    ap_lo = average_precision(gt_np[lo], gc_np[lo], ids_bf.cpu().numpy()[lo], c_np[lo])
    ap_hi = average_precision(gt_np[~lo], gc_np[~lo], ids_bf.cpu().numpy()[~lo],
                              np.minimum(c_np[~lo], k))
    log(f"[two_tower] brute force (user tower + rangescan, k={k}): "
        f"QPS={n_req / dt:.1f} ({dt * 1e3:.2f} ms for {n_req} requests; "
        f"rangescan alone {dt_alone * 1e3:.2f} ms), retrieval_cand latency "
        f"median {np.median(lat) * 1e3:.3f} ms (p90 {np.quantile(lat, 0.9) * 1e3:.3f}), "
        f"AP={ap_lo:.4f} on the {int(lo.sum())} lanes with count <= {k}, "
        f"AP={ap_hi:.4f} on the {int((~lo).sum())} lanes with count > {k} "
        f"(k of count), launches={counts}, routes={routes} (retrieval_cand: "
        f"{q1_route})")
    if profile:
        profile_run(lambda: brute(users["serve_p99"]), dt, "two-tower brute-force batch")

    # -- the graph engine on the same corpus, ip -------------------------------
    t0 = time.perf_counter()
    graph = build_knn_graph(items, k=32, metric="ip", device=dev)
    torch.cuda.synchronize()
    t_graph = time.perf_counter() - t0
    engine = RangeSearchEngine.from_graph(items, graph, metric="ip", n_starts=4,
                                          device=dev)
    cfg_r = RangeConfig(search=SearchConfig(beam=32, max_beam=32, visit_cap=128,
                                            metric="ip"),
                        mode="greedy", result_cap=512)

    def served(u):
        return engine.range(user_tower(u), r, cfg=cfg_r)

    served(users["serve_p99"])
    torch.cuda.synchronize()
    expand = kernels["expand"]
    for kern in kernels.values():
        kern.launches = 0
    expand.routes = dict.fromkeys(expand.routes, 0)
    t0 = time.perf_counter()
    res = served(users["serve_p99"])
    torch.cuda.synchronize()
    dt_g = time.perf_counter() - t0
    g_counts = {n: kern.launches for n, kern in kernels.items()}
    g_routes = dict(expand.routes)
    if min(g_counts["expand"], g_counts["gatherdist"]) == 0:
        raise AssertionError(f"graph engine: launches {g_counts}")
    check_routes({"expand": g_routes}, g_counts, "two-tower graph engine")
    lane, slot = _check_shapes(res, n_req, cfg_r.result_cap, "two-tower graph")
    exact = point_dist(items[res.ids[lane, slot].long()], queries[lane], "ip")
    if not (exact <= r + RANGESCAN_TOL).all():
        raise AssertionError("two-tower graph: a returned id is out of range")
    t0 = time.perf_counter()
    res_k = engine.range(queries, r, cfg=cfg_r)
    torch.cuda.synchronize()
    dt_alone = time.perf_counter() - t0
    ap_g = average_precision(gt_np, gc_np, res.ids.cpu().numpy(), res.count.cpu().numpy())
    log(f"[two_tower] graph engine (exact k-NN graph R=32 at ip, built in "
        f"{t_graph:.2f} s; greedy beam=32 visit_cap=128 result_cap=512): "
        f"QPS={n_req / dt_g:.1f} ({dt_g * 1e3:.2f} ms for {n_req} requests, user "
        f"tower included; search alone {dt_alone * 1e3:.2f} ms), AP={ap_g:.4f}, "
        f"mean n_dist {float(res.n_dist.float().mean()):.0f} vs {n_items:,} brute, "
        f"overflowed lanes={int(res.overflow.sum())}, launches={g_counts}, "
        f"expand routes {g_routes}")
    # expand and gatherdist against their plain versions at this path's
    # shapes (ip, d=256, 512 requests, R=32, E=4, S=4) on this corpus
    kernel_checks(items, graph.neighbors, queries,
                  torch.Generator(device=dev).manual_seed(SEED),
                  dtypes=("float32",), metrics=("ip",), widths=(4,),
                  tag=" (two-tower)")
    # the same engine through the plain versions of its kernels: the same
    # walk on every lane
    plain_cfg = dataclasses.replace(cfg_r, search=dataclasses.replace(
        cfg_r.search, use_kernels=False))
    res_p = engine.range(queries, r, cfg=plain_cfg)
    for field in ("ids", "count", "n_dist", "n_visited", "overflow"):
        if not torch.equal(getattr(res_k, field), getattr(res_p, field)):
            raise AssertionError(f"two-tower graph engine: {field} of the kernel "
                                 "and plain paths differ")
    err = check_close("two-tower graph engine", res_k.dists, res_p.dists,
                      DIST_TOL["float32"])
    ap_p = average_precision(gt_np, gc_np, res_p.ids.cpu().numpy(),
                             res_p.count.cpu().numpy())
    log(f"[plain] two-tower graph engine ip on {n_req} requests: AP kernel="
        f"{ap_g:.4f} plain={ap_p:.4f}; ids, counts, n_dist, n_visited and "
        f"overflow equal on every lane, max_abs_err={err:.3g}")
    if ap_probes:
        two_tower_ap_probes(engine, items, queries, held, r, (gt_np, gc_np), cfg_r, dev)
    del engine, graph, user_tower
    torch.cuda.empty_cache()

    return rangescan_checks(queries, q1, items, r, counts["rangescan"], routes)


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


class AttentionCapture:
    """Swaps the LM layer's attention core for one that also keeps copies of
    its inputs, in the model's layouts, on the calls named in ``want``
    ({call index: tag}; call i of a run is layer i % L of its i // L-th
    forward). It launches what it wraps, so the kernel's count moves as it
    would; used on the warm-up run only."""

    def __init__(self, want: dict):
        from repro_torch.layers import attention
        self.mod, self.want, self.calls, self.kept = attention, want, 0, {}

    def __enter__(self):
        inner = self.inner = self.mod.flash_attention

        def core(q, k, v, **kw):
            tag = self.want.get(self.calls)
            if tag is not None:
                keep = [x.transpose(1, 2).contiguous().transpose(1, 2) for x in (q, k, v)]
                self.kept[tag] = (*keep, dict(kw))
            self.calls += 1
            return inner(q, k, v, **kw)

        self.mod.flash_attention = core
        return self

    def __exit__(self, *exc):
        self.mod.flash_attention = self.inner


def sdpa_library(q, k, v, kw):
    """The same function as one ``scaled_dot_product_attention`` call (no
    configuration sets a soft cap): no mask where every key is visible,
    ``is_causal`` where rows and keys start together, else a boolean mask
    made here. Returns the call."""
    import torch
    from repro_torch.kernels.flashattn.ref import visible_mask
    if kw["softcap"] > 0:
        raise ValueError("no library call applies a soft cap")
    sq, skv = q.shape[2], k.shape[2]
    mask = visible_mask(sq, skv, causal=kw["causal"], window=kw["window"],
                        q_offset=kw["q_offset"], device=q.device)
    if bool(mask.all()):
        how = {}
    elif kw["causal"] and kw["window"] <= 0 and kw["q_offset"] == 0 and sq == skv:
        how = dict(is_causal=True)
    else:
        how = dict(attn_mask=mask)
    return lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, scale=kw["scale"], enable_gqa=True, **how)


def flash_checks(captured: dict, dev) -> dict:
    """flashattn against its plain version at the JAX tests' shapes (f32 and
    bf16) and on the captured inputs of the LM path (one global and one
    local layer, at prefill and at one decode step, all prompts); times by
    CUDA-graph replay against the bound, the plain version and one SDPA
    call. Returns the JSON entry (prefill global layer; decode_* the
    decode step's global layer)."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention_cuda, flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(SEED)
    max_err = 0.0
    for (b, hq, hkv, sq, skv, dh, causal, window, cap, qoff) in FLASH_CASES:
        kw = dict(causal=causal, window=window, softcap=cap, q_offset=qoff)
        for dtype in ("float32", "bfloat16"):
            q, k, v = (torch.randn(shape, generator=gen, device=dev).to(getattr(torch, dtype))
                       for shape in ((b, hq, sq, dh), (b, hkv, skv, dh), (b, hkv, skv, dh)))
            route = kernel_route(flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
            got = flash_attention_cuda(q, k, v, **kw)
            want = flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            err = check_close(f"flashattn {dtype} {(b, hq, hkv, sq, skv, dh)}",
                              got.float(), want.float(), FLASH_TOL[dtype])
            log(f"[kernel] flashattn {dtype} B={b} Hq={hq} Hkv={hkv} Sq={sq} Skv={skv} "
                f"dh={dh} causal={causal} window={window} softcap={cap} "
                f"q_offset={qoff}: route {route}, max_abs_err={err:.3g}")
    entry = dict(name="flashattn", route="cuda",
                 source="src/repro_torch/kernels/flashattn/csrc/flashattn_wgmma.cu",
                 decode_source="src/repro_torch/kernels/flashattn/csrc/flashattn.cu",
                 replaces="src/repro/kernels/flashattn/kernel.py:33")
    for tag, (q, k, v, kw) in captured.items():
        times, err, route = flash_case(tag, q, k, v, kw, dev)
        max_err = max(max_err, err)
        if tag == "prefill global":
            entry.update(times, prefill_route=route)
        elif tag == "prefill local":
            entry.update({f"local_{k}": v for k, v in times.items()})
        elif tag == "decode global":
            entry.update({f"decode_{k}": v for k, v in times.items()}, decode_route=route)
        else:
            entry.update({f"decode_local_{k}": v for k, v in times.items()})
        torch.cuda.empty_cache()
    entry["max_abs_err"] = max_err
    return entry


def flash_case(tag: str, q, k, v, kw: dict, dev) -> tuple[dict, float, str]:
    """flashattn on one captured input of the LM path, against its plain
    version (bf16 tolerance) and one SDPA call: its route (asserted:
    decode_split at one query row, else wgmma), split count, TFLOP/s or
    GB/s and share of the bound, each timed by CUDA-graph replay. Returns
    ({ms, plain_ms, bound_ms, bound_by, library_ms}, max_abs_err, route)."""
    import torch
    from repro_torch.kernels.flashattn import flash_attention_cuda, flash_attention_ref
    from repro_torch.kernels.flashattn.ops import decode_splits, visible_key_range
    from repro_torch.kernels.flashattn.ref import visible_mask
    route = kernel_route(flash_attention_cuda, lambda: flash_attention_cuda(q, k, v, **kw))
    got = flash_attention_cuda(q, k, v, **kw)
    want = flash_attention_ref(q, k, v, **kw)
    lib_fn = sdpa_library(q, k, v, kw)
    lib_out = lib_fn()
    torch.cuda.synchronize()
    err = check_close(f"flashattn {tag}", got.float(), want.float(), FLASH_TOL["bfloat16"])
    lib_err = float((lib_out.float() - want.float()).abs().max())
    del got, want, lib_out
    b, hq, sq, dh = q.shape
    skv = k.shape[2]
    decode = sq == 1
    ms = time_ms(lambda: flash_attention_cuda(q, k, v, **kw),
                 reps=200 if decode else 10, repeats=5)
    plain = time_ms(lambda: flash_attention_ref(q, k, v, **kw),
                    reps=20 if decode else 2, repeats=3, graph=False)
    lib = time_ms(lib_fn, reps=200 if decode else 10, repeats=5)
    mask = visible_mask(sq, skv, causal=kw["causal"], window=kw["window"],
                        q_offset=kw["q_offset"], device=dev)
    flops = 4.0 * dh * int(mask.sum()) * b * hq
    # q and the output once each, and K and V of the keys some row sees
    # (at a local layer's decode step, its window)
    n_bytes = (2 * q.numel() + 2 * int(mask.any(0).sum()) * b * k.shape[1] * dh
               ) * q.element_size()
    b_ms, b_by = bound_ms(n_bytes, flops, PEAK_FLOPS)
    if decode:   # the split count as ops.py plans it for these inputs
        lo, hi = visible_key_range(sq, skv, causal=kw["causal"], window=kw["window"],
                                   q_offset=kw["q_offset"])
        splits = decode_splits(hi - lo, b * k.shape[1])
        how, rate = f"{splits} splits, ", f"{n_bytes / ms / 1e6:.1f} GB/s"
    else:
        how, rate = "", f"{flops / ms / 1e9:.1f} TFLOP/s"
    log(f"[kernel] flashattn {tag} B={b} Hq={hq} Hkv={k.shape[1]} Sq={sq} Skv={skv} "
        f"dh={dh} window={kw['window']} q_offset={kw['q_offset']} bf16: route {route} "
        f"({how}{rate}, {b_ms / ms:.1%} of the bound), "
        f"max_abs_err={err:.3g} (SDPA vs plain {lib_err:.3g}), ms={ms:.4f}, "
        f"plain_ms={plain:.4f}, bound_ms={b_ms:.4f} ({b_by}: {flops:.3g} flops at "
        f"989 TFLOP/s, {n_bytes / 1e6:.1f} MB at 3.35 TB/s; at the f32 rate "
        f"{flops / F32_FLOPS * 1e3:.4f} ms), library_ms={lib:.4f} "
        f"(scaled_dot_product_attention), {ms / lib:.3f}x SDPA, "
        f"{ms / b_ms:.2f}x the bound")
    want_route = "decode_split" if decode else "wgmma"
    if route != want_route:
        raise AssertionError(f"flashattn {tag}: route {route}, not {want_route}")
    return dict(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib), err, route


def lm_paths(model, toks, cfg, steps: int, feed=None):
    """prefill + ``steps`` decode steps of ``toks`` through ``cfg``'s path;
    the next token is the greedy one, or ``feed[t]`` (teacher forcing).
    Returns (last-token f32 logits a step, the tokens chosen, each layer's
    hidden state at the prompt's last position)."""
    import torch
    from repro_torch.models import decode_step, greedy_token, prefill
    hidden = []   # a Block returns (x, the MoE's aux dict or None)
    hooks = [layer.register_forward_hook(
        lambda mod, args, out: hidden.append(out[0][0, -1].float())
        if out[0].shape[1] > 1 else None)
        for layer in model.layers]
    try:
        logits, cache, pos = prefill(model, toks, cfg, max_len=toks.shape[1] + steps)
        out, chosen = [logits[0, -1]], [greedy_token(logits)]
        for t in range(steps):
            tok = chosen[-1] if feed is None else feed[t]
            logits, cache = decode_step(model, tok, cache, pos, cfg)
            pos += 1
            out.append(logits[0, -1])
            chosen.append(greedy_token(logits))
    finally:
        for h in hooks:
            h.remove()
    return torch.stack(out), chosen, hidden


class MoECapture:
    """Swaps the transformer's ``moe_layer`` for one that also keeps, call
    by call, the token count, the aux dict and (with ``ids``) each token's
    top-k expert ids, sorted (the router's decision on the same input:
    ``layers.moe.route``; the dispatch's slots are a function of them). It
    runs what it wraps; call i of a run is MoE layer i % L_moe of its
    i // L_moe-th forward."""

    def __init__(self, ids: bool = False):
        from repro_torch.models import transformer
        self.mod, self.ids, self.calls = transformer, ids, []

    def __enter__(self):
        from repro_torch.layers.moe import route
        inner = self.inner = self.mod.moe_layer

        def moe(params, h, cfg, capacity=None):
            y, aux = inner(params, h, cfg, capacity)
            ids = None
            if self.ids:
                ids = route(params, h.reshape(-1, h.shape[-1]), cfg)[2].sort(dim=-1).values
            self.calls.append((h.shape[0] * h.shape[1], aux, ids))
            return y, aux

        self.mod.moe_layer = moe
        return self

    def __exit__(self, *exc):
        self.mod.moe_layer = self.inner

    def dropped(self) -> list:
        return [float(aux["dropped_frac"]) for _, aux, _ in self.calls]


def lm_compare(model, toks, cfg, steps: int, limit: float, name: str,
               routing_equal: bool = False) -> float:
    """The kernel path against the plain path (``use_kernels=False``) on
    the same model and prompt, the plain path fed the kernel path's tokens:
    the relative L2 error of the last-token logits at the prefill and each
    step must stay within ``limit``; the share of equal argmaxes and each
    layer's hidden-state error at the prompt's last position are printed.
    For a MoE model, the tokens whose top-k expert ids differ between the
    paths are counted by layer (prefill and steps), and must be none with
    ``routing_equal``."""
    import torch
    with MoECapture(ids=cfg.is_moe) as kcap:
        lk, chosen, hk = lm_paths(model, toks, cfg, steps)
    with MoECapture(ids=cfg.is_moe) as pcap:
        lp, _, hp = lm_paths(model, toks, dataclasses.replace(cfg, use_kernels=False),
                             steps, feed=chosen[:-1])
    torch.cuda.synchronize()
    errs = [rel_l2(a, b) for a, b in zip(lk, lp)]
    same = float((lk.argmax(-1) == lp.argmax(-1)).float().mean())
    layer_errs = [rel_l2(a, b) for a, b in zip(hk, hp)]
    del lk, lp, hk, hp
    routing = ""
    if cfg.is_moe:
        n_moe = cfg.n_layers - cfg.first_dense
        differ = np.zeros(n_moe, np.int64)
        for i, ((_, _, a), (_, _, b)) in enumerate(zip(kcap.calls, pcap.calls)):
            differ[i % n_moe] += int((a != b).any(dim=-1).sum())
        routing = (f"; tokens routed differently by MoE layer (prefill and steps, of "
                   f"{sum(t for t, _, _ in kcap.calls) // n_moe} a layer): "
                   f"{' '.join(str(int(n)) for n in differ)} ({int(differ.sum())} in all)")
    log(f"[lm] kernel vs plain path, {name}: relative L2 error of the last-token "
        f"logits max {max(errs):.3g} (prefill {errs[0]:.3g}; steps "
        f"{' '.join(f'{e:.2g}' for e in errs[1:])}), limit {limit:g}; argmax equal "
        f"on a share {same:.4f} of {len(errs)} (prefill + {steps} steps); "
        f"hidden-state error by layer at the prompt's last position: "
        f"{' '.join(f'{e:.2g}' for e in layer_errs)}{routing}")
    if max(errs) > limit:
        raise AssertionError(f"{name}: the kernel and plain paths part by "
                             f"{max(errs):.3g} > {limit:g}")
    if routing_equal and differ.any():
        raise AssertionError(f"{name}: {int(differ.sum())} tokens routed differently")
    return same


def lm_phase(dev, kernels, profile: bool = False) -> dict:
    """gemma3-27b serving at full width and depth: the model from seed 0 in
    bf16, 4 prompts of 4,096 tokens prefilled and 32 greedy decode steps
    (launches counted), the kernel path against the plain path (prompt 0,
    full depth, bf16; then depth 6 in f32), and flashattn against its plain
    version on the inputs this path gave it. ``profile`` traces one decode
    step. Returns the JSON entry."""
    import torch
    from repro_torch.configs.gemma3_27b import ARCH
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import decode_step, greedy_token, init_transformer, prefill
    cfg = ARCH.model_cfg
    windows, _ = cfg.layer_meta()
    n_layers = cfg.n_layers
    local, glob = int(np.flatnonzero(windows > 0)[0]), int(np.flatnonzero(windows == 0)[0])
    model, t_build, w_bytes = lm_build(cfg, dev, LM_PARAMS, ARCH.arch_id)
    log(f"[lm] {ARCH.arch_id}: {n_layers} layers ({int((windows > 0).sum())} local "
        f"window {cfg.window}, {int((windows == 0).sum())} global), d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv} kv heads, dh {cfg.d_head}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab:,}, tied; built from seed {SEED} in "
        f"{t_build:.2f} s: {LM_PARAMS:,} parameters, {w_bytes / 1e9:.2f} GB")
    tokens = torch.as_tensor(lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=LM_PROMPT_LEN, batch=LM_PROMPTS, seed=SEED), 0)["tokens"],
        device=dev)

    # warm-up: a prefill and one decode step, keeping the attention inputs
    # of the first local and the first global layer
    want = {local: "prefill local", glob: "prefill global",
            n_layers + local: "decode local", n_layers + glob: "decode global"}
    with AttentionCapture(want) as cap:
        logits, cache, pos = prefill(model, tokens, cfg, max_len=LM_MAX_LEN)
        decode_step(model, greedy_token(logits), cache, pos, cfg)
    torch.cuda.synchronize()
    captured = cap.kept
    del logits, cache
    torch.cuda.empty_cache()

    # the served run, launches counted
    (t_prefill, step_s, n_prefill, counts, prefill_routes, decode_routes, logits, cache,
     chosen) = lm_served(model, tokens, cfg, LM_MAX_LEN, kernels, n_layers)
    if profile:
        # the last step again (its cache row rewritten): the cache is full
        tok = chosen[-1]
        profile_run(lambda: decode_step(model, tok, cache, LM_MAX_LEN - 1, cfg),
                    float(np.median(step_s)), "lm decode step")
    toks_out = torch.cat(chosen, dim=1).cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    step_ms = np.median(step_s) * 1e3
    log(f"[lm] served {LM_PROMPTS} prompts x {LM_PROMPT_LEN} tokens (lm_batch seed "
        f"{SEED}), cache {tuple(cache.k.shape)} x 2 bf16 "
        f"({2 * cache.k.numel() * 2 / 1e9:.2f} GB): prefill {t_prefill * 1e3:.1f} ms "
        f"({LM_PROMPTS * LM_PROMPT_LEN / t_prefill:.1f} tokens/s); {LM_STEPS} greedy "
        f"decode steps, median {step_ms:.2f} ms a step (min {min(step_s) * 1e3:.2f}, "
        f"max {max(step_s) * 1e3:.2f}; {LM_PROMPTS / step_ms * 1e3:.1f} tokens/s); "
        f"peak device memory {peak / 1e9:.2f} GB; flashattn launches {n_prefill} at "
        f"prefill, {(counts['flashattn'] - n_prefill) // LM_STEPS} a step "
        f"({counts['flashattn']} in all), routes {prefill_routes} at prefill and "
        f"{decode_routes} over the steps; tokens of prompt 0 {toks_out[0, :8].tolist()}...")
    del logits, cache, chosen
    torch.cuda.empty_cache()

    # the kernel path against the plain path: full depth, bf16, prompt 0
    torch.cuda.reset_peak_memory_stats()
    lm_compare(model, tokens[:1], cfg, LM_STEPS, LM_BF16_REL,
               f"full depth bf16, prompt 0, {LM_STEPS} steps")
    log(f"[lm] peak device memory of the comparison "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()

    # the kernel against its plain version, on the card emptied of the model
    torch.cuda.reset_peak_memory_stats()
    entry = flash_checks(captured, dev)
    entry["launches"] = counts["flashattn"]
    del captured
    torch.cuda.empty_cache()
    log(f"[lm] peak device memory of the kernel checks "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # full width, depth 6 (one 5:1 period), f32
    torch.cuda.reset_peak_memory_stats()
    cfg6 = dataclasses.replace(cfg, n_layers=6, dtype=torch.float32)
    model = init_transformer(cfg6, seed=SEED, device=dev)
    same = lm_compare(model, tokens[:1], cfg6, 8, LM_F32_REL,
                      "full width, depth 6, f32, prompt 0, 8 steps")
    if same != 1.0:
        raise AssertionError("depth 6 f32: an argmax differs between the paths")
    log(f"[lm] peak device memory of the depth-6 f32 run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del model
    torch.cuda.empty_cache()
    return entry


def moe_layer_gate(mcfg, dev, name: str) -> None:
    """One full-width MoE layer drawn in f32 on the card from the seed and
    copied to the CPU, on a prefill-sized input (4,096 tokens: two dispatch
    groups) and a decode-sized one (4 tokens: capacity 1): y within
    MOE_REL relative L2 of the CPU's, the drops and every token's top-k ids
    equal (so every kept slot: the slots are a function of the ids), and
    two calls on the card bit for bit equal."""
    import copy

    import torch
    from repro_torch.layers.moe import dispatch_plan, init_moe, moe_layer, route
    gen = torch.Generator(device=dev).manual_seed(SEED)
    layer = init_moe(mcfg, generator=gen, device=dev, dtype=torch.float32)
    cpu = copy.deepcopy(layer).cpu()
    n_bytes = sum(p.numel() * p.element_size() for p in cpu.parameters())
    for b, s_len in ((1, 4096), (4, 1)):
        x = torch.randn((b, s_len, mcfg.d_model), generator=gen, device=dev)
        y, aux = moe_layer(layer, x, mcfg)
        y2, aux2 = moe_layer(layer, x, mcfg)
        ids = route(layer, x.reshape(-1, mcfg.d_model), mcfg)[2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xc = x.cpu()
        yc, auxc = moe_layer(cpu, xc, mcfg)
        probs, _, ids_c = route(cpu, xc.reshape(-1, mcfg.d_model), mcfg)
        t_cpu = time.perf_counter() - t0
        top = probs.topk(mcfg.top_k + 1, dim=-1).values
        margin = float((top[:, -2] - top[:, -1]).min())
        groups, tg, c = dispatch_plan(b * s_len, mcfg)
        n = groups * tg * mcfg.top_k
        kept = (round((1 - float(aux["dropped_frac"])) * n),
                round((1 - float(auxc["dropped_frac"])) * n))
        err = rel_l2(y.cpu(), yc)
        bitwise = torch.equal(y, y2) and torch.equal(aux["dropped_frac"], aux2["dropped_frac"])
        same_ids = torch.equal(ids.cpu(), ids_c)
        log(f"[{name}] one MoE layer f32 ({mcfg.n_experts} experts, {mcfg.e_alloc} "
            f"allocated, top-{mcfg.top_k}, d_expert {mcfg.d_expert}, {mcfg.n_shared} "
            f"shared; {n_bytes / 1e9:.2f} GB on the CPU), T={b * s_len}: {groups} groups "
            f"of {tg}, capacity {c}; card vs CPU relative L2 {err:.3g} (limit "
            f"{MOE_REL:g}), kept assignments {kept[0]} and {kept[1]} of {n}, top-k ids "
            f"{'equal' if same_ids else 'DIFFER'} (smallest k-th/(k+1)-th prob gap on "
            f"the CPU {margin:.3g}), aux loss {float(aux['aux_loss']):.6f} and "
            f"{float(auxc['aux_loss']):.6f}; two calls on the card "
            f"{'bit for bit equal' if bitwise else 'DIFFER'}; CPU {t_cpu:.2f} s")
        if err > MOE_REL or kept[0] != kept[1] or not same_ids or not bitwise:
            raise AssertionError(f"{name}: the MoE layer on the card and on the CPU part")
        del x, y, y2, yc, xc, probs
    del layer, cpu
    torch.cuda.empty_cache()


def lm_served(model, tokens, cfg, max_len: int, kernels: dict, n_flash: int):
    """The served run: every launch count set to 0, ``prefill`` of
    ``tokens`` and LM_STEPS greedy decode steps, each timed to a
    synchronize; flashattn launched ``n_flash`` times a call (its GQA
    layers), on ``wgmma`` at prefill and ``decode_split`` at each step, and
    the last logits finite (each asserted). Returns (prefill s, step
    seconds, flashattn's launches at prefill, every kernel's count after
    the steps, flashattn's routes at prefill and over the steps, the last
    logits, the cache, the chosen tokens)."""
    import torch
    from repro_torch.models import decode_step, greedy_token, prefill
    flash = kernels["flashattn"]
    for kern in kernels.values():
        kern.launches = 0
    flash.routes = dict.fromkeys(flash.routes, 0)
    t0 = time.perf_counter()
    logits, cache, pos = prefill(model, tokens, cfg, max_len=max_len)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    at_prefill = {n: k.launches for n, k in kernels.items()}
    prefill_routes = dict(flash.routes)
    tok = greedy_token(logits)
    chosen, step_s = [tok], []
    for _ in range(LM_STEPS):
        t0 = time.perf_counter()
        logits, cache = decode_step(model, tok, cache, pos, cfg)
        tok = greedy_token(logits)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        pos += 1
        chosen.append(tok)
    counts = {n: k.launches for n, k in kernels.items()}
    decode_routes = {r: n - prefill_routes[r] for r, n in flash.routes.items()}
    n_prefill = at_prefill["flashattn"]
    if n_prefill != n_flash or counts["flashattn"] != n_flash * (LM_STEPS + 1):
        raise AssertionError(f"flashattn launches: {n_prefill} at prefill, "
                             f"{counts['flashattn']} in all")
    if (prefill_routes != {"wgmma": n_flash, "tile_f32": 0, "decode_split": 0}
            or decode_routes != {"wgmma": 0, "tile_f32": 0,
                                 "decode_split": n_flash * LM_STEPS}):
        raise AssertionError(f"flashattn routes: {prefill_routes} at prefill, "
                             f"{decode_routes} over the steps")
    if tuple(logits.shape) != (tokens.shape[0], 1, cfg.vocab) or not torch.isfinite(logits).all():
        raise AssertionError(f"decode logits {tuple(logits.shape)} not finite")
    return (t_prefill, step_s, n_prefill, counts, prefill_routes, decode_routes, logits,
            cache, chosen)


def lm_build(cfg, dev, want_params: int, name: str):
    """``init_transformer(cfg)`` from SEED on the card, its parameter count
    asserted; returns (model, build seconds, bytes)."""
    import torch
    from repro_torch.models import init_transformer
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_transformer(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != want_params:
        raise AssertionError(f"{name} has {n_params:,} parameters, not {want_params:,}")
    return model, t_build, sum(p.numel() * p.element_size() for p in model.parameters())


def lm_moe_phase(dev, kernels, profile: bool = False) -> dict:
    """qwen2-moe-a2.7b serving at full width and depth (24 layers of GQA,
    16 heads over 16 kv heads, and MoE: 60 experts in 64 rows, top-4, 4
    shared; bf16 from seed 0): 4 prompts of 4,096 tokens prefilled and 32
    greedy decode steps (flashattn's launches and routes asserted, each
    layer's dropped share at prefill and at a decode step); the kernel path
    against the plain path at full depth in bf16 (printed) and at depth 4
    in f32 (gated: logits, argmax, routing); one full-width MoE layer on the
    card against the CPU; flashattn on this path's inputs against SDPA.
    ``profile`` traces a prefill and a decode step. Returns the flashattn
    JSON keys of this path."""
    import torch
    from repro_torch.configs.qwen2_moe_a27b import ARCH
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.layers.moe import dispatch_plan
    from repro_torch.models import decode_step, greedy_token, init_transformer, prefill
    cfg = ARCH.model_cfg
    mcfg = cfg.moe_cfg()
    L = cfg.n_layers
    model, t_build, w_bytes = lm_build(cfg, dev, MOE_PARAMS, ARCH.arch_id)
    log(f"[lm moe] {ARCH.arch_id}: {L} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.n_kv} kv heads, dh {cfg.d_head}; MoE {cfg.n_experts} experts "
        f"({mcfg.e_alloc} allocated) top-{cfg.top_k}, d_expert {cfg.d_expert}, "
        f"{cfg.n_shared} shared, router f32; vocab {cfg.vocab:,}, untied; built from seed "
        f"{SEED} in {t_build:.2f} s: {MOE_PARAMS:,} parameters, {w_bytes / 1e9:.2f} GB")
    tokens = torch.as_tensor(lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=LM_PROMPT_LEN, batch=LM_PROMPTS, seed=SEED), 0)["tokens"],
        device=dev)

    # warm-up: a prefill and one decode step, keeping layer 0's attention
    # inputs and every MoE layer's dropped share
    with AttentionCapture({0: "moe prefill", L: "moe decode"}) as cap, MoECapture() as mcap:
        logits, cache, pos = prefill(model, tokens, cfg, max_len=LM_MAX_LEN)
        warm = logits[:, -1].clone()
        decode_step(model, greedy_token(logits), cache, pos, cfg)
    torch.cuda.synchronize()
    drops = mcap.dropped()
    for when, sl, t in (("prefill", drops[:L], LM_PROMPTS * LM_PROMPT_LEN),
                        ("a decode step", drops[L:], LM_PROMPTS)):
        g, tg, c = dispatch_plan(t, mcfg)
        log(f"[lm moe] dropped share by layer at {when} (T={t}: {g} groups of {tg}, "
            f"capacity {c}): {' '.join(f'{d:.4f}' for d in sl)}")
    del logits, cache, mcap
    torch.cuda.empty_cache()

    (t_prefill, step_s, n_prefill, counts, prefill_routes, decode_routes, logits, cache,
     chosen) = lm_served(model, tokens, cfg, LM_MAX_LEN, kernels, L)
    same_prefill = torch.equal(warm, prefill(model, tokens, cfg, LM_MAX_LEN)[0][:, -1])
    toks_out = torch.cat(chosen, dim=1).cpu().numpy()
    peak = torch.cuda.max_memory_allocated()
    step_ms = np.median(step_s) * 1e3
    log(f"[lm moe] served {LM_PROMPTS} prompts x {LM_PROMPT_LEN} tokens (lm_batch seed "
        f"{SEED}), cache {tuple(cache.k.shape)} x 2 bf16 "
        f"({2 * cache.k.numel() * 2 / 1e9:.2f} GB): prefill {t_prefill * 1e3:.1f} ms "
        f"({LM_PROMPTS * LM_PROMPT_LEN / t_prefill:.1f} tokens/s); {LM_STEPS} greedy "
        f"decode steps, median {step_ms:.2f} ms a step (min {min(step_s) * 1e3:.2f}, "
        f"max {max(step_s) * 1e3:.2f}; {LM_PROMPTS / step_ms * 1e3:.1f} tokens/s); "
        f"peak device memory {peak / 1e9:.2f} GB; flashattn launches {n_prefill} at "
        f"prefill, {(counts['flashattn'] - n_prefill) // LM_STEPS} a step "
        f"({counts['flashattn']} in all), routes {prefill_routes} at prefill and "
        f"{decode_routes} over the steps; the prefill's logits again "
        f"{'bit for bit equal' if same_prefill else 'not bit for bit equal'} to the "
        f"warm-up's; tokens of prompt 0 {toks_out[0, :8].tolist()}...")
    if profile:
        profile_layers(lambda: prefill(model, tokens, cfg, max_len=LM_MAX_LEN),
                       t_prefill, "lm moe prefill")
        tok = chosen[-1]   # the last step again (its cache row rewritten)
        profile_layers(lambda: decode_step(model, tok, cache, LM_MAX_LEN - 1, cfg),
                       float(np.median(step_s)), "lm moe decode step")
    del logits, cache, chosen, warm
    torch.cuda.empty_cache()

    # the kernel path against the plain path: full depth, bf16, prompt 0
    # (printed: bf16 routing is discontinuous, a flipped expert moves a token)
    lm_compare(model, tokens[:1], cfg, LM_STEPS, float("inf"),
               f"{ARCH.arch_id} full depth bf16, prompt 0, {LM_STEPS} steps (not gated)")
    del model
    torch.cuda.empty_cache()

    # flashattn on this path's inputs (G=1), on the card emptied of the model
    entry = {"lm_moe_launches": counts["flashattn"]}
    for tag, (q, k, v, kw) in cap.kept.items():
        times, _, _ = flash_case(tag, q, k, v, kw, dev)
        key = tag.replace(" prefill", "")
        entry.update({f"{key.replace(' ', '_')}_{n}": t for n, t in times.items()})
    del cap
    torch.cuda.empty_cache()

    # full width, depth 4, f32: gated
    cfg4 = dataclasses.replace(cfg, n_layers=MOE_F32_DEPTH, dtype=torch.float32)
    model = init_transformer(cfg4, seed=SEED, device=dev)
    same = lm_compare(model, tokens[:1], cfg4, 8, MOE_REL,
                      f"full width, depth {MOE_F32_DEPTH}, f32, prompt 0, 8 steps",
                      routing_equal=True)
    if same != 1.0:
        raise AssertionError(f"depth {MOE_F32_DEPTH} f32: an argmax differs between the paths")
    del model
    torch.cuda.empty_cache()
    moe_layer_gate(mcfg, dev, "lm moe")
    log(f"[lm moe] peak device memory after the served run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return entry


def lm_mla_phase(dev, kernels, profile: bool = False) -> None:
    """deepseek-v2-236b at full width, its depth cut to 7 layers (the
    leading dense layer and 6 MoE layers: MLA with 128 heads, q_lora 1,536,
    kv_lora 512, rope 64; 160 experts top-6, d_expert 1,536, 2 shared; bf16
    from seed 0): 4 prompts of 1,024 tokens prefilled (cache 1,056) and 32
    greedy decode steps, each layer's dropped share, flashattn never
    launched (MLA's core is sdpa); then one full-width MoE layer (its
    experts cut to 16) on the card against the CPU. ``profile`` traces a
    prefill and a decode step."""
    import torch
    from repro_torch.configs.deepseek_v2_236b import ARCH
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.layers.moe import dispatch_plan
    from repro_torch.models import decode_step, greedy_token, prefill
    cfg = dataclasses.replace(ARCH.model_cfg, n_layers=MLA_LAYERS)
    mcfg = cfg.moe_cfg()
    n_moe = cfg.n_layers - cfg.first_dense
    model, t_build, w_bytes = lm_build(cfg, dev, MLA_PARAMS, ARCH.arch_id)
    log(f"[lm mla] {ARCH.arch_id} at full width, depth cut to {cfg.n_layers} of "
        f"{ARCH.model_cfg.n_layers} ({cfg.first_dense} dense, d_ff {cfg.d_ff}, then "
        f"{n_moe} MoE): d_model {cfg.d_model}, MLA {cfg.n_heads} heads, q_lora "
        f"{cfg.q_lora}, kv_lora {cfg.kv_lora}, nope {cfg.qk_nope_dim} + rope "
        f"{cfg.qk_rope_dim}, v {cfg.v_head_dim}; {cfg.n_experts} experts top-{cfg.top_k}, "
        f"d_expert {cfg.d_expert}, {cfg.n_shared} shared; vocab {cfg.vocab:,}, untied; "
        f"built from seed {SEED} in {t_build:.2f} s: {MLA_PARAMS:,} parameters, "
        f"{w_bytes / 1e9:.2f} GB")
    tokens = torch.as_tensor(lm_batch(LMDataConfig(
        vocab=cfg.vocab, seq_len=MLA_PROMPT_LEN, batch=LM_PROMPTS, seed=SEED), 0)["tokens"],
        device=dev)
    with MoECapture() as mcap:
        logits, cache, pos = prefill(model, tokens, cfg, max_len=MLA_MAX_LEN)
        decode_step(model, greedy_token(logits), cache, pos, cfg)
    torch.cuda.synchronize()
    drops = mcap.dropped()
    for when, sl, t in (("prefill", drops[:n_moe], LM_PROMPTS * MLA_PROMPT_LEN),
                        ("a decode step", drops[n_moe:], LM_PROMPTS)):
        g, tg, c = dispatch_plan(t, mcfg)
        log(f"[lm mla] dropped share by MoE layer at {when} (T={t}: {g} groups of "
            f"{tg}, capacity {c}): {' '.join(f'{d:.4f}' for d in sl)}")
    del logits, cache, mcap
    torch.cuda.empty_cache()

    # MLA's core is sdpa: flashattn is never launched
    t_prefill, step_s, _, _, _, _, logits, cache, chosen = lm_served(
        model, tokens, cfg, MLA_MAX_LEN, kernels, 0)
    peak = torch.cuda.max_memory_allocated()
    step_ms = np.median(step_s) * 1e3
    # a GQA cache of the same heads: k of dn + dr and v of dv, every head
    gqa = cfg.n_layers * LM_PROMPTS * MLA_MAX_LEN * cfg.n_heads * (
        cfg.qk_nope_dim + cfg.qk_rope_dim + cfg.v_head_dim) * 2
    mla = (cache.k.numel() + cache.v.numel()) * 2
    toks_out = torch.cat(chosen, dim=1).cpu().numpy()
    log(f"[lm mla] served {LM_PROMPTS} prompts x {MLA_PROMPT_LEN} tokens (lm_batch seed "
        f"{SEED}), cache {tuple(cache.k.shape)} + {tuple(cache.v.shape)} bf16: "
        f"{mla / 1e6:.1f} MB against {gqa / 1e6:.1f} MB for a GQA cache of the same "
        f"heads ({gqa / mla:.1f}x); prefill {t_prefill * 1e3:.1f} ms "
        f"({LM_PROMPTS * MLA_PROMPT_LEN / t_prefill:.1f} tokens/s); {LM_STEPS} greedy "
        f"decode steps, median {step_ms:.2f} ms a step (min {min(step_s) * 1e3:.2f}, "
        f"max {max(step_s) * 1e3:.2f}; {LM_PROMPTS / step_ms * 1e3:.1f} tokens/s); "
        f"peak device memory {peak / 1e9:.2f} GB; flashattn launches 0; tokens of "
        f"prompt 0 {toks_out[0, :8].tolist()}...")
    if profile:
        profile_layers(lambda: prefill(model, tokens, cfg, max_len=MLA_MAX_LEN),
                       t_prefill, "lm mla prefill")
        tok = chosen[-1]
        profile_layers(lambda: decode_step(model, tok, cache, MLA_MAX_LEN - 1, cfg),
                       float(np.median(step_s)), "lm mla decode step")
    del model, logits, cache, chosen
    torch.cuda.empty_cache()
    moe_layer_gate(dataclasses.replace(mcfg, n_experts=MLA_GATE_EXPERTS), dev, "lm mla")


def graph_checks(nbrs, start) -> dict:
    """A built graph's rows on the device: no id out of range, no self
    loop, no duplicate within a row (fails otherwise); its degrees, and the
    share of nodes reachable from ``start`` (breadth first)."""
    import torch
    from repro_torch.utils import INVALID_ID
    n = nbrs.shape[0]
    valid = nbrs != INVALID_ID
    rows = torch.arange(n, device=nbrs.device)[:, None]
    srt = torch.sort(nbrs, dim=1).values
    bad = {"out of range": int((valid & ((nbrs < 0) | (nbrs >= n))).sum()),
           "self loops": int((nbrs == rows).sum()),
           "duplicates": int(((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != INVALID_ID)).sum())}
    if any(bad.values()):
        raise AssertionError(f"the built graph has bad entries {bad}")
    seen = torch.zeros(n, dtype=torch.bool, device=nbrs.device)
    seen[start] = True
    frontier, depth = start.reshape(1).long(), 0
    while frontier.numel():
        nb = nbrs[frontier].flatten()
        nb = torch.unique(nb[nb != INVALID_ID]).long()
        frontier = nb[~seen[nb]]
        seen[frontier] = True
        depth += 1
    deg = valid.sum(1)
    return dict(min=int(deg.min()), mean=float(deg.float().mean()), max=int(deg.max()),
                reachable=float(seen.float().mean()), depth=depth - 1)


def reset_counts(kernels: dict) -> None:
    for k in kernels.values():
        k.launches = 0
        if hasattr(k, "routes"):
            k.routes = dict.fromkeys(k.routes, 0)


def read_counts(kernels: dict) -> tuple[dict, dict]:
    return ({n: k.launches for n, k in kernels.items()},
            {n: dict(k.routes) for n, k in kernels.items() if hasattr(k, "routes")})


def radius_and_oracle(ds, points, queries, tag: str = ""):
    """The radius chosen the paper's way (sweep + select_radius on a
    256-query sample) for half the queries to answer empty, and the oracle
    (``exact_range_search``) at it over every query. Returns (the sweep's
    profile, r, the oracle's ids and counts on the host, ``ap_of``: a
    result's AP against the oracle on its first k lanes)."""
    import torch
    from repro_torch.core import (
        average_precision, default_grid, exact_range_search, match_histogram, select_radius,
        sweep)
    t0 = time.perf_counter()
    # default_grid's low end is the 0.05% quantile of a 2048-point sample's
    # distances; at 1M points that radius already holds ~500 matches, so
    # the grid is extended three decades down to reach zero-result radii
    grid = default_grid(ds.points, ds.queries[:256], num=48)
    grid = np.geomspace(grid[0] / 1e3, grid[-1], 96).astype(np.float32)
    prof = sweep(points, queries[:256], grid, device=points.device)
    # target: half the queries answer empty. (At the paper's default of
    # 0.95 almost no lane saturates its beam on this corpus, and greedy
    # phase 2 would not run at all.)
    r, gi = select_radius(prof, target_zero_frac=0.5)
    log(f"[radius{tag}] r={r:.6g} (grid index {gi}, zero-result fraction "
        f"{prof.zero_frac[gi]:.3f} on 256 queries, "
        f"{time.perf_counter() - t0:.2f} s)")
    t0 = time.perf_counter()
    gt_ids, _, gt_counts = exact_range_search(points, queries, r, device=points.device)
    torch.cuda.synchronize()
    gt_ids, gt_counts = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    log(f"[oracle{tag}] exact_range_search over {queries.shape[0]} queries in "
        f"{time.perf_counter() - t0:.2f} s; matches {match_histogram(gt_counts)}")

    def ap_of(res, k=queries.shape[0]):
        return average_precision(gt_ids[:k], gt_counts[:k], res.ids.cpu().numpy(),
                                 res.count.cpu().numpy())

    return prof, r, gt_ids, gt_counts, ap_of


def vamana_phase(points, queries, r, cfg, q_cfg, ap_of, knn, kernels, profile):
    """[vamana]: the Vamana graph built on the card (the reference's serve
    CLI settings: R=32, beam 64, alpha 1.2, batches up to 1024, one pass)
    over ``points`` (the Vamana path's own VAMANA_N-point draw), its build
    time and split, its launches, a check of every row, its degrees and
    reachability; then greedy f32 and int8 on it at the main path's
    settings beside the main corpus's k-NN graph's QPS and AP (``knn``),
    the kernel path against
    the plain path and the int8 guard-band contract. Returns (the f32
    engine, the build's launches, the greedy f32 and int8 APs)."""
    import torch
    from repro_torch.core import BuildConfig, RangeSearchEngine, build_vamana
    bcfg = BuildConfig(max_degree=32, beam=64, alpha=1.2, insert_batch=1024, metric="l2")
    build_kernels = {"expand": kernels["expand"], "gatherdist": kernels["gatherdist"]}
    reset_counts(build_kernels)
    split: dict = {}
    t0 = time.perf_counter()
    graph = build_vamana(points, bcfg, seed=SEED, device=points.device, timings=split)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts, routes = read_counts(build_kernels)
    if min(counts.values()) == 0:
        raise AssertionError(f"[vamana] the build launched no kernel of {counts}")
    check_routes(routes, counts, "vamana build")
    engine = RangeSearchEngine.from_graph(points, graph, metric="l2", n_starts=4,
                                          device=points.device)
    g = graph_checks(graph.neighbors, engine.start_ids[0])
    if profile:    # one full-width insert batch into the built graph, traced
        from repro_torch.core import insert_batch_step
        from repro_torch.core.graph import medoid
        batch = torch.from_numpy(np.random.default_rng(SEED).permutation(
            points.shape[0])[:bcfg.insert_batch].astype(np.int32)).to(points.device)
        start = medoid(points)[None]
        step = lambda: insert_batch_step(points, graph.neighbors, batch, start, bcfg,  # noqa: E731
                                         bcfg.alpha)
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        profile_run(step, time.perf_counter() - t0, "vamana insert batch", build_kernels)
    log(f"[vamana] build_vamana n={points.shape[0]} R={bcfg.max_degree} "
        f"beam={bcfg.beam} alpha={bcfg.alpha} insert_batch={bcfg.insert_batch} "
        f"seed={SEED} on the card in {dt:.2f} s: search {split['search']:.2f} s, "
        f"prune {split['prune']:.2f} s, reverse edges {split['reverse']:.2f} s; "
        f"launches {counts}, routes {routes}")
    log(f"[vamana] graph: no id out of range, no self loop, no duplicate in a row; "
        f"degree min {g['min']} mean {g['mean']:.2f} max {g['max']}; reachable from "
        f"the medoid {g['reachable']:.6f} (depth {g['depth']})")
    engine_q = RangeSearchEngine.from_graph(points, graph, metric="l2", n_starts=4,
                                            corpus_dtype="int8", device=points.device)
    sub = queries[:256]
    f32_k = {k: kernels[k] for k in ("expand", "gatherdist")}
    q_k = {k: kernels[k] for k in ("expand_int8", "gatherdist_int8", "rerank_fetch")}
    aps = {}
    for name, eng, c, kern in (("greedy f32", engine, cfg, f32_k),
                               ("greedy int8 f32-query", engine_q, q_cfg, q_k)):
        res, wall, cnt, rts = run_mode(eng, queries, r, c, kern, profile, f"vamana {name}")
        if min(cnt.values()) == 0:
            raise AssertionError(f"[vamana] {name}: a kernel was never launched {cnt}")
        check_routes(rts, cnt, f"vamana {name}", {"rerank_fetch": sys.modules[
            "repro_torch.kernels.rerank_fetch.ops"].plan(int(res.n_rerank.sum()),
                                                         points.shape[1])})
        if eng is engine:
            check_result(res, points, queries, r, c.result_cap, f"vamana {name}")
        else:
            check_result_int8(res, points, queries, r, c.result_cap, f"vamana {name}")
        ap = aps[name] = ap_of(res)
        plain = dataclasses.replace(c, search=dataclasses.replace(c.search, use_kernels=False))
        ap_k, ap_p = ap_of(eng.range(sub, r, cfg=c), 256), ap_of(eng.range(sub, r, cfg=plain), 256)
        if abs(ap_k - ap_p) > 0.01:
            raise AssertionError(f"[vamana] {name}: kernel and plain AP differ by "
                                 f"{abs(ap_k - ap_p):.4f}")
        log(f"[vamana] {name}: QPS={N_QUERIES / wall:.1f} ({wall * 1e3:.1f} ms), "
            f"AP={ap:.4f} (the main corpus's k-NN graph: QPS={knn[name][1]:.1f}, "
            f"AP={knn[name][0]:.4f}), mean "
            f"n_visited={float(res.n_visited.float().mean()):.1f}, mean n_dist="
            f"{float(res.n_dist.float().mean()):.1f}, phase-2 share="
            f"{float(res.phase2.float().mean()):.4f}, overflowed lanes="
            f"{int(res.overflow.sum())}, launches={cnt}, routes {rts}; on 256 queries "
            f"AP kernel={ap_k:.4f} plain={ap_p:.4f}")
        if eng is engine_q:
            n_ok, n_tie = check_guard_band(engine_q, points, sub, r, c, f"vamana {name}")
            log(f"[guard] vamana int8 {name} on 256 queries: post-rerank set == "
                f"rerank-disabled set filtered by the exact distances on {n_ok} lanes; "
                f"{n_tie} pairs within 1e-6 of r")
    del engine_q
    return engine, counts, aps


FILTER_LABELS = 16          # benchmarks/run.py's filtered row: 16 labels, 1-2 a point
FILTER_QUERIES = 128
FILTER_SEED = 17
MAX_FILTERED_AP_GAP = 0.01  # benchmarks/run.py's gate


def filtered_phase(engine, points, queries, prof, deploy, fetch_kernel):
    """[filtered]: the reference benchmark's filtered workload
    (benchmarks/run.py:420-505) on the Vamana engine (VAMANA_N points): 16
    labels, 1-2 a point (seed 17, drawn as one vectorized pair a point:
    the same distribution as the reference's per-point draws, another
    sequence); 128 queries whose lanes alternate one-label AND (~9 % of the
    corpus) and four-label OR (~35 %); the radius whose mean match count on
    the sweep sample is nearest 128. Unfiltered and filtered QPS and AP (the
    latter against the post-filtered oracle; gap <= 0.01); then the
    selective lanes again with filter_threshold at 1.5x their largest
    selectivity: every lane on the fallback scan (n_visited == 0), its
    answers equal to the post-filtered oracle as sets but for pairs within
    1e-5 relative of r. Returns the fallback run's rerank_fetch launches."""
    import torch
    from repro_torch.core import (
        average_precision, exact_range_search, label_match_counts, labels_match,
        make_label_filter, pack_labels, point_dist)
    from repro_torch.utils import INVALID_ID
    dev = points.device
    n = points.shape[0]
    rng = np.random.default_rng(FILTER_SEED)
    k = rng.integers(1, 3, n)
    first = rng.integers(0, FILTER_LABELS, n)
    second = (first + rng.integers(1, FILTER_LABELS, n)) % FILTER_LABELS
    member = np.zeros((n, FILTER_LABELS), bool)
    member[np.arange(n), first] = True
    member[np.arange(n)[k == 2], second[k == 2]] = True
    eng = dataclasses.replace(engine, labels=torch.from_numpy(
        pack_labels(member, FILTER_LABELS).view(np.int32)).to(dev))
    qs = queries[:FILTER_QUERIES]
    entries = [[q % FILTER_LABELS] if q % 2 == 0
               else [(q + j) % FILTER_LABELS for j in range(4)] for q in range(FILTER_QUERIES)]
    modes = ["and" if q % 2 == 0 else "or" for q in range(FILTER_QUERIES)]
    filt = make_label_filter(entries, FILTER_LABELS, modes=modes)
    mean_counts = prof.counts.mean(axis=0)
    r = float(prof.radii[int(np.argmin(np.abs(mean_counts - 128.0)))])
    cfg = deploy.overrides(beam=32, max_beam=32, visit_cap=128).range_cfg
    gt_ids, gt_d, gt_counts = exact_range_search(points, qs, r, cap=16384, device=dev)
    if int(gt_counts.max()) > gt_ids.shape[1]:
        raise AssertionError("[filtered] the oracle's cap is below a lane's count")
    valid = gt_ids != INVALID_ID
    ok = valid & labels_match(eng.labels[torch.where(valid, gt_ids, 0).long()],
                              filt.masks.to(dev)[:, None, :], filt.is_and.to(dev)[:, None])
    order = torch.sort((~ok).to(torch.int8), dim=1, stable=True).indices
    gt_f = torch.gather(torch.where(ok, gt_ids, INVALID_ID), 1, order).cpu().numpy()
    gt_f_counts = ok.sum(1).cpu().numpy()
    gt_np, gt_counts_np = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    sel_frac = label_match_counts(eng.labels, filt).cpu().numpy() / n

    def timed(q, c, f=None):
        eng.range(q, r, cfg=c, filter=f)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.range(q, r, cfg=c, filter=f)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res_u, t_u = timed(qs, cfg)
    res_f, t_f = timed(qs, cfg, filt)
    ap_u = average_precision(gt_np, gt_counts_np, res_u.ids.cpu().numpy(),
                             res_u.count.cpu().numpy())
    ap_f = average_precision(gt_f, gt_f_counts, res_f.ids.cpu().numpy(),
                             res_f.count.cpu().numpy())
    log(f"[filtered] {FILTER_QUERIES} queries, r={r:.6g} (mean matches "
        f"{float(gt_counts.float().mean()):.1f}, filtered {gt_f_counts.mean():.1f}); "
        f"selectivity AND lanes {sel_frac[::2].mean():.4f}, OR lanes "
        f"{sel_frac[1::2].mean():.4f}: unfiltered QPS={FILTER_QUERIES / t_u:.1f} "
        f"AP={ap_u:.4f}; filtered QPS={FILTER_QUERIES / t_f:.1f} AP={ap_f:.4f} "
        f"(post-filtered oracle), gap {ap_u - ap_f:+.4f} (limit {MAX_FILTERED_AP_GAP})")
    if ap_u - ap_f > MAX_FILTERED_AP_GAP:
        raise AssertionError(f"[filtered] filtered AP trails unfiltered by {ap_u - ap_f:.4f}")

    sel = np.arange(0, FILTER_QUERIES, 2)
    qs_sel = qs[torch.from_numpy(sel).to(dev)]
    filt_sel = make_label_filter([entries[i] for i in sel], FILTER_LABELS, modes="and")
    thr = min(0.999, float(sel_frac[::2].max()) * 1.5)
    res_w, t_w = timed(qs_sel, cfg, filt_sel)
    fb_cfg = dataclasses.replace(cfg, filter_threshold=thr)
    eng.range(qs_sel, r, cfg=fb_cfg, filter=filt_sel)
    torch.cuda.synchronize()
    reset_counts({"rerank_fetch": fetch_kernel})
    t0 = time.perf_counter()
    res_fb = eng.range(qs_sel, r, cfg=fb_cfg, filter=filt_sel)
    torch.cuda.synchronize()
    t_fb = time.perf_counter() - t0
    launches, routes = read_counts({"rerank_fetch": fetch_kernel})
    if not bool((res_fb.n_visited == 0).all()) or launches["rerank_fetch"] != 1:
        raise AssertionError(f"[filtered] fallback: n_visited "
                             f"{res_fb.n_visited.tolist()}, launches {launches}")
    excused, pairs = 0, int(res_fb.n_dist.sum())
    ids_fb = res_fb.ids.cpu().numpy()
    for j, lane in enumerate(sel):
        got = set(ids_fb[j][ids_fb[j] != INVALID_ID].tolist())
        want = set(gt_f[lane][:gt_f_counts[lane]].tolist())
        for i in got ^ want:
            d = float(point_dist(points[i], qs[lane], "l2"))
            if abs(d - r) > 1e-5 * abs(r):
                raise AssertionError(f"[filtered] fallback lane {lane}: id {i} at "
                                     f"{d:.8g} against r={r:.8g}")
            excused += 1
    log(f"[filtered] fallback on the {sel.size} selective lanes, filter_threshold="
        f"{thr:.4f}: every lane n_visited == 0, answers equal to the post-filtered "
        f"oracle as sets on every lane ({excused} pairs within 1e-5 of r excused); "
        f"QPS={sel.size / t_fb:.1f} against the walk's {sel.size / t_w:.1f} on the same "
        f"lanes ({t_w / t_fb:.2f}x); {pairs} exact pairs in {launches['rerank_fetch']} "
        f"rerank_fetch launch, route {[k for k, v in routes['rerank_fetch'].items() if v]}")
    return launches["rerank_fetch"]


def tier_phase(engine_q, points, graph, queries, r, q_cfg, fetch_kernel):
    """[tier]: ``from_graph(corpus_dtype="int8", tier=True)`` on the same
    graph under the greedy int8 setting, 4096 queries, two calls (cold, then
    warm), at the default cache (n/8 rows) and at a cache of a third of the
    greedy band's distinct rows (so that it evicts): ids, dists, count and
    n_rerank equal to the resident int8 engine's bit for bit in every call,
    each rerank on the resident call's route. Returns the tier's
    rerank_fetch launches."""
    import torch
    from repro_torch.core import RangeSearchEngine
    before = dict(fetch_kernel.routes)
    want = engine_q.range(queries, r, cfg=q_cfg)
    torch.cuda.synchronize()
    resident_route = {k: fetch_kernel.routes[k] - before[k] for k in before}
    t0 = time.perf_counter()
    engine_q.range(queries, r, cfg=q_cfg)
    torch.cuda.synchronize()
    t_res = time.perf_counter() - t0
    resident = engine_q.points
    res_bytes = sum(t.numel() * t.element_size() for t in (resident.codes, resident.meta,
                                                           resident.raw))
    launches, band_rows = 0, None
    for small in (False, True):
        # the second tier's cache holds a third of the band's distinct rows
        mb = band_rows * points.shape[1] * 4 / 3 / 2**20 if small else None
        label = f"resident_mb={mb:.2f}" if small else "default cache (n/8 rows)"
        t0 = time.perf_counter()
        eng_t = RangeSearchEngine.from_graph(points, graph, metric="l2", n_starts=4,
                                             corpus_dtype="int8", tier=True,
                                             resident_mb=mb, device=points.device)
        torch.cuda.synchronize()
        t_make = time.perf_counter() - t0
        tier = eng_t.points
        for call in ("cold", "warm"):
            before = dict(fetch_kernel.routes)
            t0 = time.perf_counter()
            got = eng_t.range(queries, r, cfg=q_cfg)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            moved = {k: fetch_kernel.routes[k] - before[k] for k in before}
            launches += sum(moved.values())
            if moved != resident_route:
                raise AssertionError(f"[tier] {label} {call}: rerank routes {moved}, "
                                     f"the resident call's {resident_route}")
            for f in ("ids", "dists", "count", "n_rerank"):
                if not torch.equal(getattr(got, f), getattr(want, f)):
                    raise AssertionError(f"[tier] {label} {call}: {f} differs from the "
                                         "resident int8 engine's")
            c = tier.counters.as_dict()
            band_rows = band_rows or c["unique_rows"]
            log(f"[tier] {label} {call}: ids, dists, count, n_rerank bit for bit the "
                f"resident engine's; QPS={N_QUERIES / dt:.1f} against resident "
                f"{N_QUERIES / t_res:.1f}; rerank route {moved}; counters so far: "
                f"pairs {c['pairs']}, unique rows {c['unique_rows']}, hits "
                f"{c['cache_hits']}, misses {c['cache_misses']}, fetched "
                f"{c['fetched_bytes'] / 1e6:.1f} MB in {c['fetch_batches']} buckets, "
                f"evictions {c['cache_evictions']}")
        b = tier.budget()
        log(f"[tier] {label}: made in {t_make:.2f} s; cache {tier.cache.capacity} rows; "
            f"device {b.device_total / 1e6:.1f} MB ({b.device}) against the resident "
            f"corpus's {res_bytes / 1e6:.1f} MB; host store {b.host_total / 1e6:.1f} MB "
            f"(pinned {tier.store.pinned})")
        if mb is not None and tier.counters.cache_evictions == 0:
            raise AssertionError("[tier] the small cache never evicted")
        del eng_t, tier
    return launches


SERVE_MAX_BATCH = 128       # the reference serve CLI's defaults (src/repro/launch/serve.py)
SERVE_LANES = 32
SERVE_SLICE_ROUNDS = 8
SERVE_CALIBRATION = 256     # the CLI fits the effort regressor on 256 requests
TAIL_REQUESTS = 512         # benchmarks/run.py's tail row: one heavy lane in 16 (cut
                            # from 1,024 for the script's limit)
TAIL_HEAVY_EVERY = 16
TAIL_POINT_MATCHES = 4.0
TAIL_HEAVY_MATCHES = 512.0
SERVE_PLAIN_REQUESTS = 256
SERVE_LOCKSTEP = 1_024      # the lockstep requests a dtype (the first of the main path's
                            # queries); cut from 4,096 for the script's limit
MAX_SERVE_AP_GAP = 0.01     # kernel path against plain path, as [plain]


def drive_server(server, queries_np, radii):
    """Submit every request (backing off on queue_full by serving a step,
    as the serve CLI does) and serve until drained; the host's wall time
    and the responses sorted by request id."""
    import torch
    from repro_torch.serve import Request
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resp = []
    for i in range(queries_np.shape[0]):
        rq = Request(req_id=i, query=queries_np[i], radius=float(radii[i]))
        while server.submit(rq) is not None:
            resp.extend(server.step())
    resp.extend(server.run_until_drained())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    resp.sort(key=lambda x: x.req_id)
    if [x.req_id for x in resp] != list(range(queries_np.shape[0])):
        raise AssertionError("[serve] a request went unanswered or twice")
    return resp, wall


def served_arrays(resp, cap: int):
    """(ids (Q, cap) INVALID-padded, counts) of range responses, for AP."""
    from repro_torch.utils import INVALID_ID
    ids = np.full((len(resp), cap), INVALID_ID, np.int64)
    counts = np.zeros(len(resp), np.int64)
    for i, x in enumerate(resp):
        ids[i, :len(x.ids)] = x.ids
        counts[i] = len(x.ids)
    return ids, counts


def latency_line(lat) -> str:
    return (f"p50 {np.percentile(lat, 50) * 1e3:.3f} ms, p99 "
            f"{np.percentile(lat, 99) * 1e3:.3f} ms")


def check_against_engine(resp, want, exact_dists: bool, points, queries, r, name) -> int:
    """Every response equals its lane of ``engine.range``: ids, count,
    overflow, es_stopped, and (f32) the distances' bits. An int8 lane may
    differ only by an id whose exact distance is within 1e-6 of r (the
    band's exact distances come from rerank_fetch, whose route follows the
    band's size: 128 lanes and 4,096 do not take the same route). Returns
    the number of such excused ids."""
    from repro_torch.core import point_dist
    from repro_torch.utils import INVALID_ID
    w_ids, w_d, w_c, w_o, w_e = (t.cpu().numpy() for t in (
        want.ids, want.dists, want.count, want.overflow, want.es_stopped))
    excused = 0
    for i, x in enumerate(resp):
        keep = w_ids[i] != INVALID_ID
        same = np.array_equal(x.ids, w_ids[i][keep])
        if exact_dists:
            same = same and np.array_equal(x.dists.view(np.int32), w_d[i][keep].view(np.int32))
        if same and (x.count, x.overflow, x.es_stopped) == (w_c[i], w_o[i], w_e[i]):
            continue
        if exact_dists:
            raise AssertionError(f"[serve] {name}: request {i} differs from engine.range "
                                 f"(count {x.count} against {w_c[i]})")
        for j in set(x.ids.tolist()) ^ set(w_ids[i][keep].tolist()):
            d = float(point_dist(points[j], queries[i], "l2"))
            if abs(d - r) > 1e-6 * abs(r):
                raise AssertionError(f"[serve] {name}: request {i} id {j} at {d:.9g} "
                                     f"differs from engine.range (r={r:.9g})")
            excused += 1
        if x.overflow != w_o[i] or x.es_stopped != w_e[i]:
            raise AssertionError(f"[serve] {name}: request {i} flags differ")
    return excused


def serve_phase(engine, points, queries, r, prof, cfg, q_cfg, kernels, gt):
    """[serve]: the serving layer (``repro_torch.serve.RangeServer``) on the
    Vamana engine (VAMANA_N x 128) with the reference serve CLI's settings
    (max_batch 128, 32 lanes, 8 rounds a slice; the effort regressor fitted
    on 256 calibration requests with their exact counts). Lockstep, f32 and
    int8: the first SERVE_LOCKSTEP requests at r, each response equal to
    ``engine.range``'s lane; requests/s beside engine.range's QPS, exact
    latency percentiles. Then benchmarks/run.py's tail workload (every 16th
    request at the radius of ~512 mean matches, the rest at ~4) served in
    lockstep and continuously (after a warm-up pass of each): per request
    the same ids, count and overflow; AP of both against the oracle; point
    p50/p99, heavy p99, the point-p99 ratio and the pool counters. A
    256-request continuous pass on the plain path gives AP within 0.01 of
    the kernel path. Every path kernel must launch through the server.
    ``gt`` is the oracle's (ids, counts) at r. Returns the server's
    launches per kernel."""
    import torch
    from repro_torch.core import (
        RangeSearchEngine, average_precision, exact_range_search)
    from repro_torch.models import EffortPredictor
    from repro_torch.serve import RangeServer, ServerConfig
    dev = points.device
    card = card_line()
    engine_q = RangeSearchEngine.from_graph(points, engine.graph, metric="l2", n_starts=4,
                                            corpus_dtype="int8", device=dev)
    path = {"float32": ("expand", "gatherdist"),
            "int8": ("expand_int8", "gatherdist_int8", "rerank_fetch")}
    launches = dict.fromkeys(kernels, 0)

    def counted(kind, fn, name):
        reset_counts(kernels)
        out = fn()
        counts, _ = read_counts(kernels)
        missing = [k for k in path[kind] if counts[k] == 0]
        if missing:
            raise AssertionError(f"[serve] {name}: {missing} never launched {counts}")
        for k, v in counts.items():
            launches[k] += v
        return out, counts

    q_np = queries.cpu().numpy()
    lock_cfg = ServerConfig(max_batch=SERVE_MAX_BATCH, lanes=SERVE_LANES,
                            slice_rounds=SERVE_SLICE_ROUNDS)
    cont_cfg = dataclasses.replace(lock_cfg, continuous=True)
    engines = {"float32": (engine, cfg), "int8": (engine_q, q_cfg)}
    lq = queries[:SERVE_LOCKSTEP]
    radii_all = np.full(lq.shape[0], r, np.float32)
    for kind, (eng, c) in engines.items():
        eng.range(lq, r, cfg=c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = eng.range(lq, r, cfg=c)
        torch.cuda.synchronize()
        t_range = time.perf_counter() - t0
        srv = RangeServer(eng, c, lock_cfg)
        (resp, wall), counts = counted(
            kind, lambda: drive_server(srv, q_np[:SERVE_LOCKSTEP], radii_all),
            f"lockstep {kind}")
        excused = check_against_engine(resp, want, kind == "float32", points, lq, r,
                                       f"lockstep {kind}")
        ids, cnt = served_arrays(resp, c.result_cap)
        ap = average_precision(gt[0][:SERVE_LOCKSTEP], gt[1][:SERVE_LOCKSTEP], ids, cnt)
        lat = np.array([x.latency_s for x in resp])
        log(f"[serve] lockstep {kind}: {len(resp)} requests at r={r:.6g}, max_batch "
            f"{SERVE_MAX_BATCH} ({srv.stats['batches']} micro-batches): "
            f"{len(resp) / wall:.1f} requests/s against engine.range's "
            f"{len(resp) / t_range:.1f} QPS on the same queries; latency "
            f"{latency_line(lat)} (exact, {len(lat)} responses); AP={ap:.4f}; every "
            f"response equal to engine.range's lane (ids, count, overflow, es_stopped"
            f"{', distance bits' if kind == 'float32' else f'; {excused} ids within 1e-6 of r excused'}); "
            f"reranked {srv.stats['reranked']}; launches {counts}; card {card}")

    # -- the tail workload ----------------------------------------------------
    mean_counts = prof.counts.mean(axis=0)
    r_point = float(prof.radii[int(np.argmin(np.abs(mean_counts - TAIL_POINT_MATCHES)))])
    r_heavy = float(prof.radii[int(np.argmin(np.abs(mean_counts - TAIL_HEAVY_MATCHES)))])
    nq = TAIL_REQUESTS
    radii = np.full(nq, r_point, np.float32)
    radii[::TAIL_HEAVY_EVERY] = r_heavy
    point = radii == r_point
    tq = queries[:nq]
    gt_ids, _, gt_counts = exact_range_search(points, tq, torch.from_numpy(radii).to(dev),
                                              cap=4096, device=dev)
    gt_ids, gt_counts = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
    ncal = SERVE_CALIBRATION
    t0 = time.perf_counter()
    effort = EffortPredictor.fit(q_np[:ncal], radii[:ncal], gt_counts[:ncal], device=dev)
    t_fit = time.perf_counter() - t0
    split_ok = float(np.mean((effort.predict(q_np[:nq], radii) >= cont_cfg.effort_threshold)
                             == ~point))
    log(f"[serve] tail workload: {nq} requests, every {TAIL_HEAVY_EVERY}th at r_heavy="
        f"{r_heavy:.6g} (mean matches {gt_counts[~point].mean():.1f}), the rest at r_point="
        f"{r_point:.6g} ({gt_counts[point].mean():.2f}); effort regressor fitted on the "
        f"card on {ncal} requests in {t_fit:.2f} s (300 AdamW steps); its split at "
        f"{cont_cfg.effort_threshold:g} matches agrees with the radius class on {split_ok:.4f} of the requests")

    def ap_resp(resp, k=nq):
        ids, cnt = served_arrays(resp, cfg.result_cap)
        return average_precision(gt_ids[:k], gt_counts[:k], ids, cnt)

    for kind, (eng, c) in engines.items():
        tq_np = q_np[:nq]
        drive_server(RangeServer(eng, c, lock_cfg), tq_np, radii)               # warm-up
        drive_server(RangeServer(eng, c, cont_cfg, effort=effort), tq_np, radii)
        srv_l = RangeServer(eng, c, lock_cfg)
        (resp_l, wall_l), cnt_l = counted(kind, lambda: drive_server(srv_l, tq_np, radii),
                                          f"tail lockstep {kind}")
        srv_c = RangeServer(eng, c, cont_cfg, effort=effort)
        (resp_c, wall_c), cnt_c = counted(kind, lambda: drive_server(srv_c, tq_np, radii),
                                          f"tail continuous {kind}")
        for a, b in zip(resp_l, resp_c):
            if (set(a.ids.tolist()) != set(b.ids.tolist()) or a.count != b.count
                    or a.overflow != b.overflow):
                raise AssertionError(f"[serve] tail {kind}: request {a.req_id} differs "
                                     "between continuous and lockstep")
        s = srv_c.stats
        if not (s["pool_admitted"] and s["bucket_heavy"] and s["bucket_cheap"]):
            raise AssertionError(f"[serve] tail {kind}: the pool or a bucket never ran {s}")
        lat_l = np.array([x.latency_s for x in resp_l])
        lat_c = np.array([x.latency_s for x in resp_c])
        p99 = {m: float(np.percentile(v[point], 99)) for m, v in (("l", lat_l), ("c", lat_c))}
        pool = {k: s[k] for k in ("pool_admitted", "pool_retired", "pool_ticks",
                                  "pool_rotations", "pool_oneshot", "bucket_cheap",
                                  "bucket_heavy")}
        log(f"[serve] tail {kind}: continuous equals lockstep on every request (id set, "
            f"count, overflow); AP lockstep={ap_resp(resp_l):.4f} continuous="
            f"{ap_resp(resp_c):.4f}; lockstep {nq / wall_l:.1f} requests/s, point "
            f"{latency_line(lat_l[point])}, heavy p99 "
            f"{np.percentile(lat_l[~point], 99) * 1e3:.3f} ms; continuous {nq / wall_c:.1f} "
            f"requests/s, point {latency_line(lat_c[point])}, heavy p99 "
            f"{np.percentile(lat_c[~point], 99) * 1e3:.3f} ms; point p99 ratio "
            f"(continuous/lockstep) {p99['c'] / p99['l']:.4f}; pool {pool}; launches "
            f"lockstep {cnt_l} continuous {cnt_c}; card {card}")

    # -- the kernel path against the plain path, continuous -------------------
    k = SERVE_PLAIN_REQUESTS
    plain = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, use_kernels=False))
    aps = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        resp, _ = drive_server(RangeServer(engine, c, cont_cfg, effort=effort), q_np[:k],
                               radii[:k])
        aps[name] = ap_resp(resp, k)
    log(f"[serve] continuous f32 on {k} tail requests: AP kernel={aps['kernel']:.4f} "
        f"plain={aps['plain']:.4f}")
    if abs(aps["kernel"] - aps["plain"]) > MAX_SERVE_AP_GAP:
        raise AssertionError(f"[serve] kernel and plain AP differ by "
                             f"{abs(aps['kernel'] - aps['plain']):.4f}")
    del engine_q
    return launches


LIVE_K = 10_000             # rows inserted and deleted: 1 % of n (benchmarks/run.py churns 10 %)
LIVE_INSERT_BATCH = 128     # the serve CLI's --churn path (src/repro/launch/serve.py:165-167)
LIVE_CHECK = 256            # queries of each gate
LIVE_DURABLE_TAIL = 2_000   # inserts and deletes after the checkpoint
LIVE_SERVED_QUERIES = 256      # cut from 1,024 (and 2,000 mutations) for the script's limit
LIVE_SERVED_MUTATIONS = 500
LIVE_PATH = ("expand", "gatherdist", "expand_int8", "gatherdist_int8", "rerank_fetch")


class _SlotView:
    """A live snapshot searched by slot id with its tombstones applied: the
    guard-band check's engine (its ids index the capacity's raw rows)."""

    def __init__(self, snap):
        self.engine, self.tombstones = snap.as_engine(), snap.tombstones

    def range(self, queries, r, cfg):
        return self.engine.range(queries, r, cfg=cfg, tombstones=self.tombstones)


def live_ap(live, queries, res_ids, res_counts, r):
    """AP of external-id answers against ``exact_range_search`` over the
    index's live set (``live_vectors``), ids mapped to its rows."""
    import torch
    from repro_torch.core import average_precision, exact_range_search
    from repro_torch.utils import INVALID_ID
    ext, vecs = live.live_vectors()
    gt_ids, _, gt_counts = exact_range_search(torch.from_numpy(vecs).to(queries.device),
                                              queries, r, device=queries.device)
    lut = np.full(live.next_ext_id + 1, INVALID_ID, np.int64)
    lut[ext] = np.arange(ext.shape[0])
    ids = np.asarray(res_ids)
    rows = np.where(ids == INVALID_ID, INVALID_ID, lut[np.minimum(ids, live.next_ext_id)])
    return average_precision(gt_ids.cpu().numpy(), gt_counts.cpu().numpy(), rows,
                             np.asarray(res_counts))


def live_gates(live, snap0, before, queries, fresh_ids, fresh, doomed, r, cfg, name):
    """The churn gates of [live] (a) on the index as it stands: no deleted id
    answers (all queries), each of LIVE_CHECK inserted vectors finds its own
    id at distance 0, the int8 guard band on the live snapshot, the
    pre-churn snapshot answers bit for bit as before, kernel-path AP equals
    plain-path AP within 0.01. Returns (the full batch's AP, QPS, a line)."""
    import torch
    from repro_torch.core import corpus_raw
    snap = live.snapshot()
    res = snap.range(queries, r, cfg=cfg)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = snap.range(queries, r, cfg=cfg)
    torch.cuda.synchronize()
    qps = queries.shape[0] / (time.perf_counter() - t0)
    ids = res.ids.cpu().numpy()
    if np.isin(ids, doomed).any():
        raise AssertionError(f"[live] {name}: a deleted id answered")
    ap = live_ap(live, queries, ids, res.count.cpu().numpy(), r)
    k = LIVE_CHECK
    mine = snap.range(torch.from_numpy(fresh[:k]).to(queries.device), r, cfg=cfg)
    m_ids, m_d = mine.ids.cpu().numpy(), mine.dists.cpu().numpy()
    hit = [bool(((m_ids[i] == fresh_ids[i]) & (m_d[i] == 0.0)).any()) for i in range(k)]
    if not all(hit):
        raise AssertionError(f"[live] {name}: {k - sum(hit)} of {k} inserted vectors did not "
                             "find their own id at distance 0")
    sub = queries[:k]
    guard = ""
    if cfg.search.corpus_dtype == "int8":
        n_ok, n_tie = check_guard_band(_SlotView(snap), corpus_raw(live.points), sub, r, cfg,
                                       f"live {name}")
        guard = f"; guard band held on {n_ok} lanes ({n_tie} pairs within 1e-6 of r)"
    again = snap0.range(sub, r, cfg=cfg)
    for f in ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "n_rerank"):
        if not torch.equal(getattr(again, f), before[f]):
            raise AssertionError(f"[live] {name}: the pre-churn snapshot's {f} changed")
    plain = dataclasses.replace(cfg, search=dataclasses.replace(cfg.search, use_kernels=False))
    res_k, res_p = snap.range(sub, r, cfg=cfg), snap.range(sub, r, cfg=plain)
    ap_k = live_ap(live, sub, res_k.ids.cpu().numpy(), res_k.count.cpu().numpy(), r)
    ap_p = live_ap(live, sub, res_p.ids.cpu().numpy(), res_p.count.cpu().numpy(), r)
    if abs(ap_k - ap_p) > 0.01:
        raise AssertionError(f"[live] {name}: kernel and plain AP differ by {abs(ap_k - ap_p):.4f}")
    line = (f"no deleted id in {queries.shape[0]} answers; {k} of {k} inserted vectors "
            f"found their own id at distance 0{guard}; the pre-churn snapshot answered {k} "
            f"queries bit for bit as before; on {k} queries AP kernel={ap_k:.4f} "
            f"plain={ap_p:.4f}")
    return ap, qps, line


def live_phase(graph, points, queries, r, cfg, q_cfg, kernels, vamana_aps) -> dict:
    """[live]: the live index (``repro_torch.live``) promoted from the Vamana
    graph (``graph=``, VAMANA_N x 128), with the serve CLI's --churn settings
    (``LiveConfig(capacity=n + k, insert_batch=128)``, ``BuildConfig(
    max_degree=32, beam=64)``) and the deploy config's greedy search at r.
    (a) f32 and int8: insert LIVE_K rows (a corpus point plus 0.05 std noise,
    benchmarks/run.py's churn row), delete LIVE_K initial ids, answer the
    queries, the gates of ``live_gates``; then ``consolidate()`` and the
    gates again. (b) f32 durability: a WAL and a checkpoint in a temporary
    directory; half the churn, save, LIVE_DURABLE_TAIL inserts and deletes
    and a consolidation, a torn record; ``LiveIndex.restore(cm, wal=)``
    equals the uninterrupted index bit for bit. (c) served churn:
    LIVE_SERVED_QUERIES queries shuffled with LIVE_SERVED_MUTATIONS inserts
    and deletes (seed 0, as the serve CLI's `_churn_main`), through
    ``RangeServer(None, cfg, ServerConfig(max_batch=128), live=)`` in
    lockstep and continuously: every request answered once, each insert
    response carrying the id its row holds, continuous equal to lockstep on
    every query. Returns the phase's launches per kernel (every count set to
    0 at its start; the plain path launches none)."""
    import tempfile

    import torch
    from repro_torch.core import BuildConfig, corpus_raw
    from repro_torch.fault import WriteAheadLog
    from repro_torch.fault.wal import encode_record
    from repro_torch.live import LiveConfig, LiveIndex
    from repro_torch.serve import RangeServer, Request, ServerConfig
    from repro_torch.train import CheckpointManager
    from repro_torch.utils import INVALID_ID
    dev = points.device
    card = card_line()
    n, k = points.shape[0], LIVE_K
    lcfg = LiveConfig(capacity=n + k, insert_batch=LIVE_INSERT_BATCH)
    bcfg = BuildConfig(max_degree=32, beam=64)
    pts_np = points.cpu().numpy()
    rng = np.random.default_rng(SEED)          # benchmarks/run.py:900-903
    fresh = (pts_np[rng.integers(0, n, k)] + rng.standard_normal((k, pts_np.shape[1]))
             .astype(np.float32) * 0.05 * pts_np.std()).astype(np.float32)
    doomed = rng.choice(n, k, replace=False)
    del pts_np
    sub = queries[:LIVE_CHECK]
    reset_counts(kernels)

    # -- (a) churn on the engine, f32 and int8 --------------------------------
    for dtype, c in (("float32", cfg), ("int8", q_cfg)):
        t0 = time.perf_counter()
        live = LiveIndex.create(points, lcfg, bcfg, corpus_dtype=dtype, graph=graph, device=dev)
        torch.cuda.synchronize()
        t_create = time.perf_counter() - t0
        snap0 = live.snapshot()
        res0 = snap0.range(sub, r, cfg=c)
        before = {f: getattr(res0, f).clone() for f in (
            "ids", "dists", "count", "overflow", "n_visited", "n_dist", "n_rerank")}
        t0 = time.perf_counter()
        fresh_ids = live.insert(fresh)
        torch.cuda.synchronize()
        t_ins = time.perf_counter() - t0
        t0 = time.perf_counter()
        n_del = live.delete(doomed)
        torch.cuda.synchronize()
        t_del = time.perf_counter() - t0
        if n_del != k or live.n_live != n or not np.array_equal(fresh_ids, n + np.arange(k)):
            raise AssertionError(f"[live] {dtype}: {n_del} deleted, {live.n_live} live")
        ap, qps, line = live_gates(live, snap0, before, queries, fresh_ids, fresh, doomed, r, c,
                                   dtype)
        static = vamana_aps["greedy f32" if dtype == "float32" else "greedy int8 f32-query"]
        log(f"[live] {dtype} churn: LiveIndex.create(graph=) in {t_create:.2f} s; {k} inserts "
            f"in {t_ins:.2f} s ({k / t_ins:.1f} inserts/s; one call, "
            f"{-(-k // LIVE_INSERT_BATCH)} insert steps of {LIVE_INSERT_BATCH}), {k} deletes in "
            f"{t_del:.4f} s ({k / t_del:.1f} deletes/s); {queries.shape[0]} queries at "
            f"r={r:.6g}: QPS={qps:.1f}, AP={ap:.4f} on the live set (the static Vamana "
            f"engine's {static:.4f}); {line}; card {card}")
        t0 = time.perf_counter()
        st = live.consolidate()
        torch.cuda.synchronize()
        t_con = time.perf_counter() - t0
        if st["reclaimed"] != k or live.n_dead or live.live_count != n:
            raise AssertionError(f"[live] {dtype}: consolidation {st}")
        ap, qps, line = live_gates(live, snap0, before, queries, fresh_ids, fresh, doomed, r, c,
                                   f"{dtype} consolidated")
        log(f"[live] {dtype} consolidate: {t_con:.2f} s, n_rewired={st['n_rewired']}, "
            f"n_pruned={st['n_pruned']}, reclaimed={st['reclaimed']}; QPS={qps:.1f}, "
            f"AP={ap:.4f} on the live set; {line}")
        del live, snap0, res0
        torch.cuda.empty_cache()
    counts, _ = read_counts(kernels)
    log(f"[live] churn launches {counts}")

    # -- (b) durability, f32 --------------------------------------------------
    half, tail = k // 2, LIVE_DURABLE_TAIL
    with tempfile.TemporaryDirectory(prefix="live_") as tmp:
        wal_path = os.path.join(tmp, "wal.bin")
        cm = CheckpointManager(os.path.join(tmp, "ck"), keep=1)
        victim = LiveIndex.create(points, lcfg, bcfg, graph=graph, device=dev)
        victim.attach_wal(WriteAheadLog(wal_path))
        victim.insert(fresh[:half])
        victim.delete(doomed[:half])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_dir = victim.save(cm)
        t_save = time.perf_counter() - t0
        ck_seq = victim.wal_seq
        ck_bytes = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        victim.insert(fresh[half:half + tail])
        victim.delete(doomed[half:half + tail])
        st = victim.consolidate()
        torch.cuda.synchronize()
        with open(wal_path, "ab") as f:          # a crash mid-append
            f.write(encode_record(victim.wal_seq + 1, "consolidate", {})[:9])
        wal_bytes = os.path.getsize(wal_path)
        t0 = time.perf_counter()
        loaded = LiveIndex.restore(cm, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        del loaded
        t0 = time.perf_counter()
        got = LiveIndex.restore(cm, wal=WriteAheadLog(wal_path), device=dev)
        torch.cuda.synchronize()
        t_rec = time.perf_counter() - t0
        pairs = {"points": (corpus_raw(got.points), corpus_raw(victim.points)),
                 "neighbors": (got.neighbors, victim.neighbors),
                 "start ids": (got.start_ids, victim.start_ids),
                 "ext ids": (torch.from_numpy(got.ext_ids), torch.from_numpy(victim.ext_ids)),
                 "tombstones": (got.tombstones, victim.tombstones),
                 "counters": (torch.tensor([got.live_count, got.next_ext_id, got.epoch,
                                            got.wal_seq]),
                              torch.tensor([victim.live_count, victim.next_ext_id,
                                            victim.epoch, victim.wal_seq]))}
        for what, (a, b) in pairs.items():
            if not torch.equal(a, b):
                raise AssertionError(f"[live] durability: the recovered {what} differ")
        ra, rb = got.range(sub, r, cfg=cfg), victim.range(sub, r, cfg=cfg)
        for f in ("ids", "dists", "count", "overflow", "n_visited", "n_dist"):
            if not torch.equal(getattr(ra, f), getattr(rb, f)):
                raise AssertionError(f"[live] durability: the recovered index's {f} differ")
        log(f"[live] durability f32: {half} inserts + {half} deletes, save, {tail} inserts + "
            f"{tail} deletes + consolidate (n_rewired={st['n_rewired']}), a torn record; "
            f"checkpoint {ck_bytes} bytes saved in {t_save:.2f} s, WAL {wal_bytes} bytes; "
            f"restore {t_load:.2f} s, restore + replay of {got.wal_seq - ck_seq} records "
            f"{t_rec:.2f} s; the recovered index equals the uninterrupted one bit for bit "
            f"(points, neighbors, start ids, ext ids, tombstones, counters) and answers "
            f"{LIVE_CHECK} queries identically; card {card}")
        del victim, got
    torch.cuda.empty_cache()

    # -- (c) served churn -----------------------------------------------------
    q_np = queries[:LIVE_SERVED_QUERIES].cpu().numpy()
    m = LIVE_SERVED_MUTATIONS
    srng = np.random.default_rng(SEED)           # src/repro/launch/serve.py:191, 207-226
    s_doomed = srng.choice(n, size=m, replace=False)
    reqs = ([dict(req_id=i, query=q_np[i], radius=float(r)) for i in range(q_np.shape[0])]
            + [dict(req_id=q_np.shape[0] + i, op="insert", query=fresh[i]) for i in range(m)]
            + [dict(req_id=q_np.shape[0] + m + i, op="delete",
                    delete_ids=np.asarray([s_doomed[i]])) for i in range(m)])
    srng.shuffle(reqs)
    served = {}
    for mode in ("lockstep", "continuous"):
        live = LiveIndex.create(points, lcfg, bcfg, graph=graph, device=dev)
        scfg = ServerConfig(max_batch=SERVE_MAX_BATCH, continuous=mode == "continuous")
        srv = RangeServer(None, cfg, scfg, live=live)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        resp = []
        for kw in reqs:
            while srv.submit(Request(**kw)) is not None:
                resp.extend(srv.step())
        resp.extend(srv.run_until_drained())
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        resp.sort(key=lambda x: x.req_id)
        if [x.req_id for x in resp] != list(range(len(reqs))):
            raise AssertionError(f"[live] served {mode}: a request went unanswered or twice")
        ins = [x for x in resp if x.op == "insert"]
        ext = np.asarray([int(x.ids[0]) for x in ins])
        slots = torch.tensor([live._slot_of[int(e)] for e in ext], device=dev)
        rows = corpus_raw(live.points)[slots].cpu().numpy()
        want = np.stack([fresh[x.req_id - q_np.shape[0]] for x in ins])
        if np.unique(ext).size != m or not np.array_equal(rows, want):
            raise AssertionError(f"[live] served {mode}: an insert response's id does not "
                                 "hold its vector")
        rq = [x for x in resp if x.op == "range"]
        ids = np.full((len(rq), cfg.result_cap), INVALID_ID, np.int64)
        for i, x in enumerate(rq):
            ids[i, :len(x.ids)] = x.ids
        ap = live_ap(live, queries[:len(rq)], ids, [len(x.ids) for x in rq], r)
        s = srv.stats
        served[mode] = rq
        log(f"[live] served {mode}: {len(reqs)} requests ({len(rq)} queries, {m} inserts, "
            f"{m} deletes, shuffled) at max_batch {SERVE_MAX_BATCH} in {wall:.2f} s = "
            f"{len(reqs) / wall:.1f} requests/s; epoch={s['epoch']}, consolidations="
            f"{s['consolidations']}, batches={s['batches']}, pool admitted "
            f"{s['pool_admitted']}; every request answered once, each insert response "
            f"carries the id its row holds; AP={ap:.4f} on the final live set; card {card}")
        del live, srv
        torch.cuda.empty_cache()
    for a, b in zip(served["lockstep"], served["continuous"]):
        if (set(a.ids.tolist()) != set(b.ids.tolist()) or a.count != b.count
                or a.overflow != b.overflow):
            raise AssertionError(f"[live] served: request {a.req_id} differs between "
                                 "continuous and lockstep")
    log(f"[live] served: continuous equals lockstep on all {len(served['lockstep'])} query "
        "responses (id set, count, overflow)")
    counts, _ = read_counts(kernels)
    missing = [name for name in LIVE_PATH if counts[name] == 0]
    if missing:
        raise AssertionError(f"[live] {missing} never launched through the live path {counts}")
    log(f"[live] launches through the live path {counts}")
    return counts


SHARDS = 4                  # S: 4 contiguous shards of 250,000 at 1M
SHARD_SERVED = 256          # requests through RangeServer(mesh=, sharded=); cut from 1,024
SHARD_RANKS = 2             # ranks of the second collective run, on the one card
SHARD_RANK_TIMEOUT_S = 400
SHARDED_PATH = {"float32": ("expand", "gatherdist"),
                "int8": ("expand_int8", "gatherdist_int8", "rerank_fetch")}
RESULT_FIELDS = ("ids", "dists", "count", "overflow", "n_visited", "n_dist", "es_stopped",
                 "phase2", "n_rerank")


def _host(res) -> dict:
    return {f: getattr(res, f).cpu().numpy() for f in RESULT_FIELDS}


def _lanes(d: dict, k: int) -> dict:
    """A host result's first ``k`` lanes (a lane's answer does not depend on
    the batch it is searched in)."""
    return {f: v[:k] for f, v in d.items()}


def _same_result(got: dict, want: dict) -> list:
    """The fields of two host results that differ (distances by their bits)."""
    return [f for f in RESULT_FIELDS
            if not np.array_equal(got[f].view(np.int32) if f == "dists" else got[f],
                                  want[f].view(np.int32) if f == "dists" else want[f])]


def host_union(per_shard: list, offsets, n_total: int, cap: int, keep=None) -> dict:
    """The union of per-shard ``range_search_fused`` results (host dicts of
    shard-local ids), computed on the host independently of
    ``dist.sharded_engine``: ids made global (INVALID, and past n_total,
    dropped), candidates in shard order, a stable sort on the distances in
    the reference's total order, the first ``cap``; counts summed and
    capped, flags OR-ed, counters summed. ``keep`` names the shards merged
    (every one by default)."""
    from repro_torch.utils import INVALID_ID
    keep = range(len(per_shard)) if keep is None else keep
    ids, dists, parts = [], [], [per_shard[s] for s in keep]
    for s in keep:
        p = per_shard[s]
        gid = np.where(p["ids"] == INVALID_ID, INVALID_ID, p["ids"].astype(np.int64)
                       + int(offsets[s]))
        gid = np.where(gid < n_total, gid, INVALID_ID).astype(np.int32)
        ids.append(gid)
        dists.append(np.where(gid == INVALID_ID, np.float32(np.inf), p["dists"]))
    ids, dists = np.concatenate(ids, 1), np.concatenate(dists, 1).astype(np.float32)
    u = dists.view(np.uint32).astype(np.int64)
    key = np.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u ^ 0x80000000)
    order = np.argsort(key, axis=1, kind="stable")[:, :cap]
    total = sum((g != INVALID_ID).sum(1) for g in np.split(ids, len(parts), axis=1))

    def any_(f):
        return sum(p[f].astype(np.int32) for p in parts) > 0

    return {"ids": np.take_along_axis(ids, order, 1),
            "dists": np.take_along_axis(dists, order, 1),
            "count": np.minimum(total, cap).astype(np.int32),
            "overflow": any_("overflow") | (total > cap),
            "n_visited": sum(p["n_visited"] for p in parts).astype(np.int32),
            "n_dist": sum(p["n_dist"] for p in parts).astype(np.int32),
            "es_stopped": any_("es_stopped"), "phase2": any_("phase2"),
            "n_rerank": sum(p["n_rerank"] for p in parts).astype(np.int32)}


def _shard_view(corpus, i):
    from repro_torch.core import QuantizedCorpus
    p = corpus.points
    if isinstance(p, QuantizedCorpus):
        return QuantizedCorpus(codes=p.codes[i], meta=p.meta[i], raw=p.raw[i])
    return p[i]


def per_shard_results(corpus, queries, r, cfg) -> list:
    """Each shard's own ``range_search_fused`` call, on the host."""
    from repro_torch.core import Graph, range_search_fused
    return [_host(range_search_fused(corpus=_shard_view(corpus, i),
                                     graph=Graph(neighbors=corpus.neighbors[i]),
                                     queries=queries, start_ids=corpus.start_ids[i], r=r,
                                     cfg=cfg))
            for i in range(corpus.n_local)]


def sharded_rank(rank: int, world: int, workdir: str, device: str = "cuda") -> int:
    """One rank of the ``[sharded]`` phase's collective run over ``world``
    ranks that share one card: gloo (NCCL refuses two ranks on one device),
    the mesh (1, world), the shards of this rank's model coordinate loaded
    from the arrays the parent wrote (its kernels are the parent's builds);
    a warm-up call, then a timed one over every query; the result and the
    wall time go back to ``workdir``."""
    import torch
    import torch.distributed as dist
    from repro_torch.convert import sharded_from_arrays
    from repro_torch.dist import make_mesh, sharded_range_search
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(workdir, "store"), world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh((1, world), device_type=device, backend="gloo")
        a = {k: np.load(os.path.join(workdir, k + ".npy"), mmap_mode="r")
             for k in ("points", "neighbors", "start_ids", "offsets", "queries")}
        corpus = sharded_from_arrays(a["points"], a["neighbors"], a["start_ids"], a["offsets"],
                                     int(np.load(os.path.join(workdir, "n_total.npy"))),
                                     mesh=mesh, device=device)
        meta = json.loads(open(os.path.join(workdir, "cfg.json")).read())
        from repro_torch.core import RangeConfig, SearchConfig
        cfg = RangeConfig(search=SearchConfig(**meta["search"]),
                          **{k: v for k, v in meta.items() if k != "search"})
        queries = torch.as_tensor(np.array(a["queries"]), device=device)
        r = float(np.load(os.path.join(workdir, "r.npy")))
        sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=r, cfg=cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=r, cfg=cfg)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # the model-axis gather alone, at its payload's shape: the gloo wire
        from repro_torch.dist._comm import all_gather, axis_group
        payload = torch.zeros((queries.shape[0], 2 * corpus.n_local * cfg.result_cap),
                              dtype=torch.int32, device=device)
        group = axis_group(mesh, "model")
        all_gather(payload, group)
        t0 = time.perf_counter()
        all_gather(payload, group)
        wire = time.perf_counter() - t0
        np.savez(os.path.join(workdir, f"rank{rank}.npz"), wall=wall, wire=wire,
                 wire_bytes=payload.numel() * 4,
                 held=np.asarray([corpus.first_shard, corpus.n_local]), **_host(res))
    finally:
        dist.destroy_process_group()
    return 0


def two_rank_run(corpus, queries, r, cfg, world: int = SHARD_RANKS) -> list:
    """Write the f32 shards, the queries and the config to a temporary
    directory, start ``world`` ranks of this script (``--sharded-rank``),
    all at once, and return what each rank got ({fields..., wall, held})."""
    import tempfile
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        for k, v in (("points", corpus.points), ("neighbors", corpus.neighbors),
                     ("start_ids", corpus.start_ids), ("offsets", corpus.offsets),
                     ("queries", queries)):
            np.save(os.path.join(work, k + ".npy"), v.cpu().numpy())
        np.save(os.path.join(work, "n_total.npy"), np.asarray(corpus.n_total))
        np.save(os.path.join(work, "r.npy"), np.asarray(r, np.float32))
        c = dataclasses.asdict(cfg)
        with open(os.path.join(work, "cfg.json"), "w") as f:
            json.dump(c, f)
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--sharded-rank", str(k),
             "--sharded-world", str(world), "--sharded-dir", work,
             "--sharded-device", corpus.device.type],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for k in range(world)]
        outs = []
        try:
            for k, p in enumerate(procs):
                text = p.communicate(timeout=SHARD_RANK_TIMEOUT_S)[0]
                if p.returncode != 0:
                    raise AssertionError(f"[sharded] rank {k} of {world} exited "
                                         f"{p.returncode}:\n{text[-3000:]}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for k in range(world):
            with np.load(os.path.join(work, f"rank{k}.npz")) as z:
                outs.append({f: z[f] for f in z.files})
        return outs


def sharded_phase(points, queries, r, cfg, q_cfg, kernels, ap_of, single) -> dict:
    """[sharded]: the engine split into SHARDS contiguous shards of the main
    path's corpus (``dist.build_sharded``), one exact k-NN sub-index (R=32)
    a shard with its medoid as the start, f32 and int8 (quantized a shard at
    a time); the main path's queries, radius and oracle; the deploy config's
    greedy search (result_cap 1024).
    (1) ``sharded_range_search`` over a one-rank mesh (``make_mesh((1, 1))``,
    NCCL), every shard local, f32 and int8: (a) bit for bit the host union
    of the four per-shard ``range_search_fused`` calls; (b) no false
    positive at the exact distances; (c) a mixed-radius batch (r and 2r
    alternating) equal lane for lane to the two homogeneous calls; (d)
    every kernel of the path launched (``sharded_launches``). QPS, AP, the
    phase-2 share and the results beside the single index's (``single``),
    and the f32 AP with 4 starts a shard (``start_points``, as the single
    index's ``n_starts=4``).
    (2) The f32 collective over two ranks on the one card (gloo, mesh
    (1, 2), two shards each): each rank's result bit for bit (1)'s.
    (3) ``fault.fault_tolerant_sharded_search`` on the f32 corpus and the
    first FANOUT_QUERIES queries: healthy,
    bit for bit (1)'s; the threaded fan-out bit for bit the serial one; shard
    1 down: coverage 0.75 and the union of shards {0, 2, 3}; garbage at
    (shard 2, attempt 0): caught, retried, equal to healthy.
    (4) ``RangeServer(mesh=, sharded=)`` in lockstep over SHARD_SERVED
    requests, each equal to its lane of (1); then with shard 1 down
    (``injector=``), each annotated 3 of 4 shards, ``shard_lost``, equal to
    its lane of the union of {0, 2, 3}. Returns the launches of (1), and
    for the phases after it the corpora and each shard's k-NN graph and
    start."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import build_knn_graph, match_histogram, medoid, start_points
    from repro_torch.dist import build_sharded, make_mesh, sharded_range_search
    from repro_torch.fault import FaultInjector, RetryPolicy, fault_tolerant_sharded_search
    from repro_torch.serve import RangeServer, ServerConfig
    from repro_torch.utils import INVALID_ID
    dev = points.device
    card = card_line()
    t_phase = time.perf_counter()
    n = points.shape[0]
    mesh = make_mesh((1, 1), device_type=dev.type)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    # -- the shards ------------------------------------------------------------
    graphs = []

    def knn(block):
        g = build_knn_graph(block, k=32, metric="l2", device=dev)
        graphs.append((g, medoid(block).reshape(1)))
        return graphs[-1]

    sync()
    t0 = time.perf_counter()
    corpora = {"float32": build_sharded(points, SHARDS, knn, mesh=mesh, device=dev)}
    sync()
    t_build = time.perf_counter() - t0
    again = iter(graphs)
    t0 = time.perf_counter()
    corpora["int8"] = build_sharded(points, SHARDS, lambda block: next(again),
                                    corpus_dtype="int8", mesh=mesh, device=dev)
    sync()
    t_q = time.perf_counter() - t0
    f32 = corpora["float32"]
    log(f"[sharded] build_sharded({n}, {SHARDS}): shards of {f32.shard_size}, an exact k-NN "
        f"graph (R=32) and the medoid start each, {t_build:.2f} s on the card; int8 (each "
        f"shard quantized on its own) over the same graphs {t_q:.2f} s; mesh (1, 1) over "
        f"{dist.get_backend()}, every shard local; card {card}")

    # -- (1) the collective over one rank ---------------------------------------
    launches, unions, pers = {}, {}, {}
    nq = queries.shape[0]
    alt = torch.where(torch.arange(nq, device=dev) % 2 == 0, r, 2 * r).to(torch.float32)
    for dt, c in (("float32", cfg), ("int8", q_cfg)):
        corpus = corpora[dt]
        sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=r, cfg=c)  # warm-up
        sync()
        reset_counts(kernels)
        t0 = time.perf_counter()
        res = sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=r, cfg=c)
        sync()
        wall = time.perf_counter() - t0
        counts, routes = read_counts(kernels)
        missing = [k for k in SHARDED_PATH[dt] if counts[k] == 0]
        if missing:
            raise AssertionError(f"[sharded] {dt}: {missing} never launched {counts}")
        launches.update({k: counts[k] for k in SHARDED_PATH[dt]})
        got = _host(res)
        per = pers[dt] = per_shard_results(corpus, queries, r, c)
        unions[dt] = host_union(per, corpus.offsets.cpu().numpy(), corpus.n_total,
                                c.result_cap)
        bad = _same_result(got, unions[dt])
        if bad:
            raise AssertionError(f"[sharded] {dt}: {bad} differ from the host union of the "
                                 "per-shard calls")
        if dt == "float32":
            check_result(res, points, queries, r, c.result_cap, "[sharded] float32")
        else:
            check_result_int8(res, points, queries, r, c.result_cap, "[sharded] int8")
        t_mix = time.perf_counter()
        mixed = _host(sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=alt,
                                           cfg=c))
        wide = _host(sharded_range_search(mesh=mesh, corpus=corpus, queries=queries, r=2 * r,
                                          cfg=c))
        t_mix = time.perf_counter() - t_mix
        for name, want, lanes in (("r", got, slice(0, None, 2)), ("2r", wide, slice(1, None, 2))):
            bad = _same_result({f: v[lanes] for f, v in mixed.items()},
                               {f: v[lanes] for f, v in want.items()})
            if bad:
                raise AssertionError(f"[sharded] {dt}: the mixed batch's {name} lanes differ "
                                     f"from the homogeneous call in {bad}")
        ap = ap_of(res)
        s_ap, s_qps = single[dt]
        log(f"[sharded] {dt} collective, 1 rank, {SHARDS} shards: QPS={nq / wall:.1f} "
            f"({wall * 1e3:.1f} ms for {nq} queries), AP={ap:.4f} (single index on the 1M "
            f"k-NN graph, compacted: AP {s_ap:.4f}, QPS {s_qps:.1f}), phase-2 share="
            f"{float(res.phase2.float().mean()):.4f}, overflowed lanes="
            f"{int(res.overflow.sum())}, mean n_rerank={float(res.n_rerank.float().mean()):.2f}"
            f", launches={counts}, routes {routes}; gates: (a) bit for bit the host union of "
            f"the {SHARDS} per-shard range_search_fused calls, (b) no false positive, (c) the "
            f"r/2r mixed batch equal lane for lane to the two homogeneous calls "
            f"({t_mix:.2f} s for both), (d) every path kernel launched; results "
            f"{match_histogram(got['count'])}; card {card}")

    # the single index starts from 4 points (start_points); the same graphs
    # with 4 starts a shard say how much of the AP gap is the start count
    regraph = iter(g for g, _ in graphs)
    four = build_sharded(points, SHARDS, lambda b: (next(regraph), start_points(b, "l2", k=4)),
                         mesh=mesh, device=dev)
    ap4 = ap_of(sharded_range_search(mesh=mesh, corpus=four, queries=queries, r=r, cfg=cfg))
    del four
    log(f"[sharded] float32 with 4 starts a shard (start_points, the single index's n_starts):"
        f" AP={ap4:.4f}; card {card}")

    # -- (2) the f32 collective over two ranks on the one card -------------------
    t0 = time.perf_counter()
    outs = two_rank_run(f32, queries, r, cfg)
    t_two = time.perf_counter() - t0
    for k, o in enumerate(outs):
        bad = _same_result(o, unions["float32"])
        if bad or list(o["held"]) != [k * SHARDS // SHARD_RANKS, SHARDS // SHARD_RANKS]:
            raise AssertionError(f"[sharded] rank {k} of {SHARD_RANKS}: held {o['held']}, "
                                 f"{bad} differ from the one-rank result")
    walls = [float(o["wall"]) for o in outs]
    wires = [float(o["wire"]) for o in outs]
    log(f"[sharded] float32 collective, {SHARD_RANKS} ranks on the one card (gloo, mesh (1, "
        f"{SHARD_RANKS}), {SHARDS // SHARD_RANKS} shards a rank, payloads through host "
        f"memory): each rank's result bit for bit the one-rank result; the timed call took "
        f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms on the ranks "
        f"(QPS={nq / max(walls):.1f}); the model-axis gather alone "
        f"({int(outs[0]['wire_bytes'])} bytes a rank) "
        f"{', '.join(f'{w * 1e3:.1f}' for w in wires)} ms; the run, process start and shard "
        f"loading included, {t_two:.1f} s; card {card}")

    # -- (3) the host fan-out, on the first FANOUT_QUERIES queries ---------------
    fast = RetryPolicy(backoff_s=0.0)
    nf = min(FANOUT_QUERIES, nq)
    qf, whole = queries[:nf], _lanes(unions["float32"], nf)
    healthy = None
    for workers in (None, 0):
        sync()
        t0 = time.perf_counter()
        d = fault_tolerant_sharded_search(corpus=f32, queries=qf, r=r, cfg=cfg,
                                          retry=fast, max_workers=workers)
        sync()
        wall = time.perf_counter() - t0
        bad = _same_result(_host(d.result), whole)
        if bad or not d.complete:
            raise AssertionError(f"[sharded] fan-out (max_workers={workers}): {bad} differ "
                                 "from the collective result")
        if workers is None:
            healthy = wall
    log(f"[sharded] fan-out healthy, {nf} queries: bit for bit the collective result, "
        f"threaded ({SHARDS} workers, one device) and serial; {healthy * 1e3:.1f} ms threaded, "
        f"{wall * 1e3:.1f} ms serial (QPS {nf / healthy:.1f}, {nf / wall:.1f}); card {card}")
    survivors = host_union(pers["float32"], f32.offsets.cpu().numpy(), f32.n_total,
                           cfg.result_cap, keep=(0, 2, 3))
    d = fault_tolerant_sharded_search(corpus=f32, queries=qf, r=r, cfg=cfg,
                                      injector=FaultInjector(seed=0, down_shards=(1,)),
                                      retry=fast)
    bad = _same_result(_host(d.result), _lanes(survivors, nf))
    if bad or (d.coverage, d.shards_ok, d.shards_total) != (0.75, 3, 4):
        raise AssertionError(f"[sharded] shard 1 down: coverage {d.coverage}, {bad} differ "
                             "from the union of shards 0, 2, 3")
    g = fault_tolerant_sharded_search(corpus=f32, queries=qf, r=r, cfg=cfg,
                                      injector=FaultInjector(script={(2, 0): "garbage"}),
                                      retry=fast)
    bad = _same_result(_host(g.result), whole)
    if bad or list(g.attempts) != [1, 1, 2, 1] or g.faults[2] != "garbage":
        raise AssertionError(f"[sharded] garbage at (2, 0): attempts {g.attempts}, faults "
                             f"{g.faults}, {bad} differ from healthy")
    log(f"[sharded] fan-out faults: shard 1 down -> coverage {d.coverage}, shards_ok "
        f"{d.shards_ok}/{d.shards_total}, attempts {d.attempts.tolist()}, bit for bit the "
        f"union of shards {{0, 2, 3}}; garbage at (shard 2, attempt 0) -> caught by "
        f"validation, attempts {g.attempts.tolist()}, bit for bit healthy; card {card}")

    # -- (4) served ---------------------------------------------------------------
    q_np = queries[:SHARD_SERVED].cpu().numpy()
    radii = np.full(SHARD_SERVED, r, np.float32)
    for name, kw, want in (
            ("collective", dict(mesh=mesh), unions["float32"]),
            ("fan-out, shard 1 down", dict(injector=FaultInjector(seed=0, down_shards=(1,)),
                                           retry=fast), survivors)):
        srv = RangeServer(None, cfg, ServerConfig(max_batch=SERVE_MAX_BATCH), sharded=f32,
                          **kw)
        resp, wall = drive_server(srv, q_np, radii)
        for i, x in enumerate(resp):
            keep = want["ids"][i] != INVALID_ID
            same = (np.array_equal(x.ids, want["ids"][i][keep])
                    and np.array_equal(x.dists.view(np.int32),
                                       want["dists"][i][keep].view(np.int32))
                    and (x.count, x.overflow) == (want["count"][i], want["overflow"][i]))
            annotated = ((x.shards_ok, x.shards_total, x.code) == (3, 4, "shard_lost")
                         if "down" in name else x.shards_ok is None)
            if not (same and annotated):
                raise AssertionError(f"[sharded] served {name}: request {i} differs from its "
                                     f"lane ({x.count} against {want['count'][i]}) or is not "
                                     f"annotated ({x.shards_ok}/{x.shards_total}, {x.code})")
        log(f"[sharded] served {name}: {SHARD_SERVED} requests at max_batch {SERVE_MAX_BATCH}"
            f" in {wall:.2f} s = {SHARD_SERVED / wall:.1f} requests/s; each response equal to "
            f"its lane{' and annotated 3 of 4 shards, shard_lost' if 'down' in name else ''}; "
            f"stats shard_retries={srv.stats['shard_retries']}, shards_lost="
            f"{srv.stats['shards_lost']}, degraded_batches={srv.stats['degraded_batches']}; "
            f"card {card}")
    dist.destroy_process_group()
    log(f"[sharded] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches, corpora, graphs


REPLICAS = 2                # R: two bit-identical copies of every shard
REPL_SERVED = 256           # requests through RangeServer(replicas=); cut from 1,024
REPL_HEDGE_S = 0.005        # the serve CLI's --hedge-ms 5
STRAY_TIMEOUT_S = 120       # the wall-clock hedge's losing walks, left running


def _bytes(corpus) -> int:
    """The device bytes one copy of a sharded corpus holds."""
    from repro_torch.fault.replica import _leaves
    return sum(t.numel() * t.element_size() for t in _leaves(corpus))


def wait_for_strays(baseline: int) -> float:
    """Wait until the threads a wall-clock hedge left behind (losing walks
    that cannot be cancelled once they run) have ended; their seconds."""
    import threading
    t0 = time.perf_counter()
    while threading.active_count() > baseline:
        if time.perf_counter() - t0 > STRAY_TIMEOUT_S:
            raise AssertionError("[replicated] a hedge's losing walk is still running "
                                 f"after {STRAY_TIMEOUT_S} s")
        time.sleep(0.01)
    return time.perf_counter() - t0


def replicated_phase(corpora, queries, r, cfg, q_cfg, kernels) -> dict:
    """[replicated]: ``fault.replica`` over ``[sharded]``'s corpora (4 k-NN
    shards of 250,000, f32 and int8), R = REPLICAS copies
    (``ReplicatedCorpus.replicate``, ``parity_ok`` on the card), the main
    path's first FANOUT_QUERIES queries and its radius, greedy, result_cap
    1,024. Each gate against
    PR 22's unreplicated serial fan-out (``base``), bit for bit: (a) healthy,
    threaded and serial; (b) replicas (1, 0) and (3, 1) down: coverage 1.0,
    ``replica_lost``, served by [0, 1, 0, 0]; (c) every primary scripted
    slow with a 5 ms hedge: 4 hedges fired and won; (d) the wall-clock hedge
    (no injector, ``HedgePolicy()``), its losing walks waited out; (e) a
    scripted error trips replica (0, 0)'s breaker (threshold 2), an
    injected clock past the cooldown re-admits it through the half-open
    probe, ``lose(0, 1)`` then ``maintain()`` recovers replica (0, 1) and a
    probe closes it; (f) both replicas of shard 2 down: coverage 0.75,
    ``shard_lost``, the union of shards {0, 1, 3}. Then f32 served:
    ``RangeServer(replicas=2)`` at the serve CLI's fault, hedge and retry
    settings with replica (1, 0) down, REPL_SERVED requests, each equal to
    its lane of ``base`` and annotated 7 of 8 replicas. Returns the
    launches of the replicated runs (counted from 0 after the bases)."""
    import threading

    import torch
    from repro_torch.fault import (
        BreakerConfig, FaultInjector, HedgePolicy, ReplicaFleet, ReplicatedCorpus,
        RetryPolicy, fault_tolerant_sharded_search, replicated_fan_out)
    from repro_torch.serve import RangeServer, ServerConfig
    from repro_torch.utils import INVALID_ID
    card = card_line()
    t_phase = time.perf_counter()
    nq = min(FANOUT_QUERIES, queries.shape[0])
    queries = queries[:nq]
    fast = RetryPolicy(backoff_s=0.0)
    cfgs = {"float32": cfg, "int8": q_cfg}
    base = {}
    for dt, corpus in corpora.items():      # PR 22's unreplicated serial fan-out
        d = fault_tolerant_sharded_search(corpus=corpus, queries=queries, r=r, cfg=cfgs[dt],
                                          retry=fast, max_workers=0)
        base[dt] = _host(d.result)
    reset_counts(kernels)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def same(res, want, name, dt, code, served=None):
        bad = _same_result(_host(res.result), want)
        if bad or res.code != code or (served is not None and res.served_by.tolist() != served):
            raise AssertionError(f"[replicated] {dt} {name}: {bad} differ; code {res.code} "
                                 f"(want {code}), served by {res.served_by.tolist()}")

    for dt, corpus in corpora.items():
        c = cfgs[dt]
        kw = dict(queries=queries, r=r, cfg=c, retry=fast)
        rc, t_rep = timed(lambda: ReplicatedCorpus.replicate(corpus, REPLICAS))
        ok, t_par = timed(rc.parity_ok)
        if not ok:
            raise AssertionError(f"[replicated] {dt}: the replicas are not bit-identical")
        one = _bytes(corpus)
        every = sum(_bytes(x) for x in rc.replicas)
        # (a) healthy
        walls = {}
        for workers in (None, 0):
            a, walls[workers] = timed(lambda: replicated_fan_out(
                fleet=ReplicaFleet(rc), max_workers=workers, **kw))
            same(a, base[dt], f"healthy (max_workers={workers})", dt, None, [0] * SHARDS)
        # (b) two replicas down
        b = replicated_fan_out(fleet=ReplicaFleet(rc), max_workers=0, injector=FaultInjector(
            seed=0, down_replicas=((1, 0), (3, 1))), **kw)
        same(b, base[dt], "replicas (1, 0), (3, 1) down", dt, "replica_lost", [0, 1, 0, 0])
        # (3, 1) is never contacted (its shard's primary answers), so only
        # (1, 0) counts against the batch's redundancy
        if b.coverage != 1.0 or b.replicas_ok != REPLICAS * SHARDS - 1:
            raise AssertionError(f"[replicated] {dt}: coverage {b.coverage}, "
                                 f"{b.replicas_ok} replicas ok")
        # (c) scripted slow primaries, hedged
        h = replicated_fan_out(fleet=ReplicaFleet(rc), max_workers=0, injector=FaultInjector(
            seed=0, script={(s, 0, 0): "slow" for s in range(SHARDS)}),
            hedge=HedgePolicy(delay_s=REPL_HEDGE_S), **kw)
        same(h, base[dt], "slow primaries", dt, None, [1] * SHARDS)
        if not h.hedges_fired == h.hedge_wins == SHARDS:
            raise AssertionError(f"[replicated] {dt}: {h.hedges_fired} hedges fired, "
                                 f"{h.hedge_wins} won")
        # (d) the wall-clock hedge
        baseline = threading.active_count()
        fleet_d = ReplicaFleet(rc)
        w, t_wall = timed(lambda: replicated_fan_out(fleet=fleet_d, hedge=HedgePolicy(), **kw))
        t_strays = wait_for_strays(baseline)
        torch.cuda.synchronize()
        same(w, base[dt], "wall-clock hedge", dt, None)
        # (e) breakers on an injected clock
        now = [0.0]
        fleet = ReplicaFleet(rc, clock=lambda: now[0],
                             breaker=BreakerConfig(fail_threshold=2, cooldown_s=30.0))
        err = FaultInjector(seed=0, script={(0, 0, 0): "error"})
        for _ in range(2):
            e = replicated_fan_out(fleet=fleet, injector=err, max_workers=0, **kw)
            same(e, base[dt], "error at (0, 0)", dt, "replica_lost", [1, 0, 0, 0])
        if fleet.breakers[(0, 0)].state != "open" or fleet.stats["breaker_trips"] != 1:
            raise AssertionError(f"[replicated] {dt}: breaker (0, 0) "
                                 f"{fleet.breakers[(0, 0)].state}, {fleet.stats}")
        e = replicated_fan_out(fleet=fleet, max_workers=0, **kw)
        same(e, base[dt], "breaker open", dt, "replica_lost", [1, 0, 0, 0])
        now[0] += 31.0
        e = replicated_fan_out(fleet=fleet, max_workers=0, **kw)
        same(e, base[dt], "half-open probe", dt, None, [0] * SHARDS)
        fleet.lose(0, 1)
        recovered = fleet.maintain()
        state = fleet.breakers[(0, 1)].state
        e = replicated_fan_out(fleet=fleet, max_workers=0, preferred=1, **kw)
        same(e, base[dt], "recovered replica's probe", dt, None, [1] * SHARDS)
        if (recovered, state, fleet.breakers[(0, 0)].state, fleet.breakers[(0, 1)].state) != (
                1, "half_open", "closed", "closed"):
            raise AssertionError(f"[replicated] {dt}: recovery {recovered}, {state}")
        # (f) a whole shard down
        f = replicated_fan_out(fleet=ReplicaFleet(rc), max_workers=0, injector=FaultInjector(
            seed=0, down_replicas=((2, 0), (2, 1))), **kw)
        # the per-shard calls on this batch: int8's rerank route follows the
        # batch's band size, so [sharded]'s 4,096-lane calls are not its lanes
        survivors = host_union(per_shard_results(corpus, queries, r, c),
                               corpus.offsets.cpu().numpy(), corpus.n_total, c.result_cap,
                               keep=(0, 1, 3))
        same(f, survivors, "shard 2 down", dt, "shard_lost", [0, 0, -1, 0])
        if f.coverage != 0.75:
            raise AssertionError(f"[replicated] {dt}: coverage {f.coverage}")
        log(f"[replicated] {dt}, {nq} queries: ReplicatedCorpus.replicate(corpus, {REPLICAS}) in "
            f"{t_rep:.3f} s, parity_ok on the card in {t_par:.3f} s; device bytes of the fleet "
            f"{every} against one copy's {one} ({every / one:.2f}x); gates, each bit for bit "
            f"PR 22's unreplicated serial fan-out: (a) healthy threaded "
            f"{walls[None] * 1e3:.1f} ms, serial {walls[0] * 1e3:.1f} ms (QPS "
            f"{nq / walls[None]:.1f}, {nq / walls[0]:.1f}); (b) replicas (1, 0), (3, 1) down: "
            f"coverage {b.coverage}, {b.code}, served by {b.served_by.tolist()}, "
            f"{b.replicas_ok}/{b.replicas_total} replicas ok; (c) slow primaries, hedge "
            f"{REPL_HEDGE_S * 1e3:g} ms: {h.hedges_fired} hedges fired, {h.hedge_wins} won; (d) "
            f"wall-clock hedge (HedgePolicy(), delay {HedgePolicy().delay_for(fleet_d.hist(0)):g}"
            f" s): {w.hedges_fired} fired, {w.hedge_wins} won, served by "
            f"{w.served_by.tolist()}, {t_wall * 1e3:.1f} ms, its losing walks ended "
            f"{t_strays:.2f} s later; (e) breaker (0, 0) tripped after 2 scripted errors, "
            f"skipped while open, closed by the half-open probe past the cooldown; lose(0, 1), "
            f"maintain() recovered {recovered}, the probe closed it; (f) shard 2's replicas "
            f"down: coverage {f.coverage}, {f.code}, the union of shards {{0, 1, 3}}; card {card}")
        del rc
        torch.cuda.empty_cache()

    # -- served -------------------------------------------------------------------
    corpus = corpora["float32"]
    q_np = queries[:REPL_SERVED].cpu().numpy()
    want = base["float32"]
    srv = RangeServer(None, cfg, ServerConfig(max_batch=SERVE_MAX_BATCH), sharded=corpus,
                      replicas=REPLICAS, injector=FaultInjector(seed=0, down_replicas=((1, 0),)),
                      hedge=HedgePolicy(delay_s=REPL_HEDGE_S), retry=RetryPolicy(backoff_s=0.01))
    resp, wall = drive_server(srv, q_np, np.full(REPL_SERVED, r, np.float32))
    for i, x in enumerate(resp):
        keep = want["ids"][i] != INVALID_ID
        ok = (np.array_equal(x.ids, want["ids"][i][keep])
              and np.array_equal(x.dists.view(np.int32), want["dists"][i][keep].view(np.int32))
              and (x.count, x.overflow) == (want["count"][i], want["overflow"][i])
              and (x.replicas_ok, x.replicas_total, x.code, x.coverage) == (
                  REPLICAS * SHARDS - 1, REPLICAS * SHARDS, "replica_lost", 1.0))
        if not ok:
            raise AssertionError(f"[replicated] served: request {i} differs from its lane or "
                                 f"is not annotated ({x.replicas_ok}/{x.replicas_total}, "
                                 f"{x.code})")
    st = srv.stats
    counts, _ = read_counts(kernels)
    log(f"[replicated] served: RangeServer(replicas={REPLICAS}, injector=down (1, 0), hedge "
        f"{REPL_HEDGE_S * 1e3:g} ms, retry backoff 0.01 s), {REPL_SERVED} requests at max_batch "
        f"{SERVE_MAX_BATCH} in {wall:.2f} s = {REPL_SERVED / wall:.1f} requests/s, "
        f"{latency_line([x.latency_s for x in resp])} (PR 22 unreplicated: 188.3-215.7 "
        f"requests/s through the collective, 77.4-95.2 on the fan-out with a shard down); each "
        f"response equal to its lane, annotated {REPLICAS * SHARDS - 1} of "
        f"{REPLICAS * SHARDS} replicas, replica_lost; stats hedges_fired={st['hedges_fired']}, "
        f"hedge_wins={st['hedge_wins']}, breaker_trips={st['breaker_trips']}, replicas_lost="
        f"{st['replicas_lost']}, replicas_recovered={st['replicas_recovered']}, shard_retries="
        f"{st['shard_retries']}, degraded_batches={st['degraded_batches']}; launches {counts}; "
        f"card {card}")
    missing = [k for k in ("expand", "gatherdist", "expand_int8", "gatherdist_int8",
                           "rerank_fetch") if counts[k] == 0]
    if missing:
        raise AssertionError(f"[replicated] {missing} never launched {counts}")
    log(f"[replicated] phase took {time.perf_counter() - t_phase:.1f} s")
    return {k: counts[k] for k in counts}


LS_REPLICAS = 2             # each shard's replica group
LS_ROUNDS = 10              # the churn in rounds of LIVE_K / LS_ROUNDS inserts, then deletes
LS_TAIL = 1_000             # the WAL tail: inserts and deletes on one shard, each


def live_sharded_phase(points, queries, r, cfg, graphs, knn_graph, kernels) -> dict:
    """[live sharded]: ``live.LiveShardedIndex`` over ``[sharded]``'s 4 k-NN
    shards of 250,000 (``LiveIndex.create(block, graph=)`` each, capacity
    250,000 + LIVE_K, the serve CLI's --churn insert steps of 128), each
    cloned into a group of LS_REPLICAS (``clone_live_index``); f32, greedy
    at r. Churn: LIVE_K inserts (a corpus point plus 0.05 std noise, as
    ``[live]``) and LIVE_K deletes of initial ids, in LS_ROUNDS rounds, each
    insert run by every member of its group. Gates: ``assert_replica_parity``;
    ``range(mesh, ...)`` over a one-rank mesh answers no deleted id; each of
    LIVE_CHECK inserted vectors is stored bit for bit at a live slot of its
    owner with out-edges, and ``range`` finds it at distance 0 wherever
    its owner's own walk does, and at least as many of them as one
    ``LiveIndex`` over the 1M k-NN graph ``knn_graph`` finds under the same
    churn (a k-NN graph is not navigable everywhere, so neither finds all;
    the share the owner's walk finds from 32 start points is printed
    beside); those no other born slot links to (the insert step prunes
    reverse edges into full rows, so some keep none) are counted in both
    indexes, and ``range`` finds none of them; ``range`` equals the host
    union of the four shards' ``LiveSnapshot.range`` (fused) bit for bit
    with external ids; ``replicated_corpus()`` through
    ``replicated_fan_out`` equals ``range`` bit for bit; a checkpoint of one
    group's primary, a WAL tail of LS_TAIL inserts and LS_TAIL deletes on
    it, then ``rebuild_replica`` rejoins bit for bit. AP on the final live
    set. Returns the launches of the churn and the timed ``range``, each
    read right after it."""
    import dataclasses
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.core import BuildConfig, start_points
    from repro_torch.dist import make_mesh
    from repro_torch.fault import ReplicaFleet, RetryPolicy, WriteAheadLog, replicated_fan_out
    from repro_torch.live import (
        LiveConfig, LiveIndex, LiveShardedIndex, clone_live_index, externalize_ids)
    from repro_torch.train import CheckpointManager
    from repro_torch.utils import INVALID_ID
    dev = points.device
    card = card_line()
    t_phase = time.perf_counter()
    n, k = points.shape[0], LIVE_K
    s_n = n // SHARDS
    lcfg = LiveConfig(capacity=s_n + k, insert_batch=LIVE_INSERT_BATCH)
    bcfg = BuildConfig(max_degree=32, beam=64)
    pts_np = points.cpu().numpy()
    rng = np.random.default_rng(SEED)          # [live]'s churn rows
    fresh = (pts_np[rng.integers(0, n, k)] + rng.standard_normal((k, pts_np.shape[1]))
             .astype(np.float32) * 0.05 * pts_np.std()).astype(np.float32)
    doomed = rng.choice(n, k, replace=False)
    tail = (pts_np[rng.integers(0, n, LS_TAIL)] + rng.standard_normal(
        (LS_TAIL, pts_np.shape[1])).astype(np.float32) * 0.05 * pts_np.std()).astype(np.float32)
    del pts_np
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shards = [LiveIndex.create(points[s * s_n:(s + 1) * s_n], lcfg, bcfg, graph=graphs[s][0],
                               first_ext_id=s * s_n, device=dev) for s in range(SHARDS)]
    sl = LiveShardedIndex(shards, replica_groups=[
        [sh] + [clone_live_index(sh) for _ in range(LS_REPLICAS - 1)] for sh in shards])
    sl.next_ext_id = n
    torch.cuda.synchronize()
    t_create = time.perf_counter() - t0
    reset_counts(kernels)
    step = k // LS_ROUNDS
    t_ins = t_del = 0.0
    fresh_ids = []
    for i in range(LS_ROUNDS):
        t0 = time.perf_counter()
        fresh_ids.append(sl.insert(fresh[i * step:(i + 1) * step]))
        torch.cuda.synchronize()
        t_ins += time.perf_counter() - t0
        t0 = time.perf_counter()
        sl.delete(doomed[i * step:(i + 1) * step])
        torch.cuda.synchronize()
        t_del += time.perf_counter() - t0
    churn_counts, _ = read_counts(kernels)
    fresh_ids = np.concatenate(fresh_ids)
    owners = np.bincount([sl._owner[int(e)] for e in fresh_ids], minlength=SHARDS)
    if sl.n_live != n or not np.array_equal(fresh_ids, n + np.arange(k)):
        raise AssertionError(f"[live sharded] {sl.n_live} live after the churn")
    sl.assert_replica_parity()

    mesh = make_mesh((1, 1), device_type=dev.type)
    reset_counts(kernels)
    sl.range(mesh, queries, r, cfg)                                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sl.range(mesh, queries, r, cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    range_counts, _ = read_counts(kernels)
    missing = [kk for kk in ("expand", "gatherdist")
               if churn_counts[kk] == 0 or range_counts[kk] == 0]
    if missing:
        raise AssertionError(f"[live sharded] {missing} never launched: churn {churn_counts}, "
                             f"range {range_counts}")
    counts = {kk: churn_counts[kk] + range_counts[kk] for kk in ("expand", "gatherdist")}
    got = _host(res)
    if np.isin(got["ids"], doomed).any():
        raise AssertionError("[live sharded] a deleted id answered")
    # inserted vectors: each stored bit for bit at a live slot of its owner,
    # wired with out-edges; those with no in-edge counted; each one its
    # owner's own walk finds (the [live] path: snapshot, compacted) the
    # sharded range finds too, at distance 0. A k-NN graph is not navigable
    # everywhere, so the share found is held to one LiveIndex over the 1M
    # k-NN graph taking the same churn, and the owner's walk from 32 start
    # points is measured beside
    m = LIVE_CHECK
    q_fresh = torch.from_numpy(fresh[:m]).to(dev)
    mine = _host(sl.range(mesh, q_fresh, r, cfg))
    found = np.asarray([((mine["ids"][i] == fresh_ids[i]) & (mine["dists"][i] == 0.0)).any()
                        for i in range(m)])
    own = np.zeros(m, bool)
    many = np.zeros(m, bool)
    orphan = np.zeros(m, bool)

    def orphans(idx, slots):
        """Which of ``slots`` no other born slot of ``idx`` links to and no
        walk starts from (a tombstoned slot still routes the walk)."""
        born = idx.neighbors[:idx.live_count]
        sl32 = slots.to(born.dtype)
        rows, cols = torch.isin(born, sl32).nonzero(as_tuple=True)
        into = born[rows, cols]
        return (~torch.isin(sl32, into[into != rows])
                & ~torch.isin(sl32, idx.start_ids)).cpu().numpy()

    owner = np.asarray([sl._owner[int(e)] for e in fresh_ids[:m]])
    for si, sh in enumerate(sl.shards):
        lanes = np.nonzero(owner == si)[0]
        if not len(lanes):
            continue
        slots = torch.tensor([sh._slot_of[int(fresh_ids[i])] for i in lanes], device=dev)
        if not (torch.equal(sh.points[slots], q_fresh[lanes])
                and bool((sh.neighbors[slots] != INVALID_ID).any(1).all())):
            raise AssertionError(f"[live sharded] an inserted vector of shard {si} is not "
                                 "stored or not wired")
        orphan[lanes] = orphans(sh, slots)
        snap = sh.snapshot()
        ids = snap.range(q_fresh[lanes], r, cfg=cfg).ids.cpu().numpy()
        own[lanes] = (ids == fresh_ids[lanes][:, None]).any(1)
        wide = dataclasses.replace(snap, start_ids=start_points(
            points[si * s_n:(si + 1) * s_n], "l2", 32))
        ids = wide.range(q_fresh[lanes], r, cfg=cfg).ids.cpu().numpy()
        many[lanes] = (ids == fresh_ids[lanes][:, None]).any(1)
    if (own & ~found).any():
        raise AssertionError(f"[live sharded] {int((own & ~found).sum())} inserted vectors "
                             "their own shard finds are missing from range")
    if (found & orphan).any():
        raise AssertionError("[live sharded] range found an inserted vector nothing links to")
    single = LiveIndex.create(points, LiveConfig(capacity=n + k, insert_batch=LIVE_INSERT_BATCH),
                              bcfg, graph=knn_graph, device=dev)
    one_ids = single.insert(fresh)
    single.delete(doomed)
    one = _host(single.range(q_fresh, r, cfg=cfg))
    one_found = int(sum(((one["ids"][i] == one_ids[i]) & (one["dists"][i] == 0.0)).any()
                        for i in range(m)))
    one_orphans = int(orphans(single, torch.tensor(
        [single._slot_of[int(e)] for e in one_ids[:m]], device=dev)).sum())
    del single, one
    if int(found.sum()) < one_found:
        raise AssertionError(f"[live sharded] range finds {int(found.sum())} of {m} inserted "
                             f"vectors, one LiveIndex under the same churn {one_found}")
    per = [_host(sh.snapshot().range(queries, r, cfg=cfg, compacted=False)) for sh in sl.shards]
    union = host_union(per, np.zeros(SHARDS, np.int64), 2**31 - 1, cfg.result_cap)
    bad = _same_result(got, union)
    if bad:
        raise AssertionError(f"[live sharded] range: {bad} differ from the host union of the "
                             "shards' LiveSnapshot.range")
    rc, tomb, flat_ext = sl.replicated_corpus()
    if not rc.parity_ok():
        raise AssertionError("[live sharded] the replicated columns differ")
    d = replicated_fan_out(fleet=ReplicaFleet(rc), queries=queries, r=r, cfg=cfg,
                           tombstones=tomb, retry=RetryPolicy(backoff_s=0.0), max_workers=0,
                           preferred=1)
    fan = _host(d.result)
    fan["ids"] = externalize_ids(flat_ext, fan["ids"])
    bad = _same_result(fan, got)
    if bad or d.served_by.tolist() != [1] * SHARDS:
        raise AssertionError(f"[live sharded] the replicated fan-out: {bad} differ from range")
    del rc, tomb
    ap = live_ap(sl, queries, got["ids"], got["count"], r)

    # -- a replica rebuilt from a checkpoint and the WAL's tail -----------------
    free = [sh.capacity - sh.n_live for sh in sl.shards]
    s = int(np.argmax(free))
    gone = np.setdiff1d(np.arange(s * s_n, (s + 1) * s_n), doomed)[:LS_TAIL]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        primary = sl.groups[s][0]
        primary.attach_wal(WriteAheadLog(os.path.join(work, "shard.wal")))
        cm = CheckpointManager(os.path.join(work, "ckpt"))
        t0 = time.perf_counter()
        primary.save(cm)
        t_save = time.perf_counter() - t0
        ids = sl.insert(tail)
        if {sl._owner[int(e)] for e in ids} != {s}:
            raise AssertionError("[live sharded] the WAL tail's inserts left their shard")
        sl.delete(gone)
        wal_bytes = os.path.getsize(os.path.join(work, "shard.wal"))
        sl.groups[s][1] = None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sl.rebuild_replica(s, 1, cm, wal=WriteAheadLog(os.path.join(work, "shard.wal")))
        torch.cuda.synchronize()
        t_rebuild = time.perf_counter() - t0
        sl.assert_replica_parity()
        primary.wal = None
    after = sl.range(mesh, queries, r, cfg)
    ap_final = live_ap(sl, queries, after.ids.cpu().numpy(), after.count.cpu().numpy(), r)
    dist.destroy_process_group()
    log(f"[live sharded] LiveShardedIndex over {SHARDS} k-NN shards of {s_n} (capacity "
        f"{s_n + k}), groups of {LS_REPLICAS} (clone_live_index), created in {t_create:.2f} s; "
        f"{k} inserts in {LS_ROUNDS} rounds in {t_ins:.2f} s = {k / t_ins:.1f} inserts/s a group "
        f"({LS_REPLICAS * k / t_ins:.1f} member inserts/s; [live]'s single index: 1,177-1,391), "
        f"routed {owners.tolist()}; {k} deletes in {t_del:.3f} s; range(mesh (1, 1)) over "
        f"{queries.shape[0]} queries: QPS={queries.shape[0] / wall:.1f}, AP={ap:.4f} on the live "
        f"set; gates: assert_replica_parity, no deleted id, {m} of {m} inserted vectors stored "
        f"bit for bit and wired, {int(found.sum())} of {m} found at distance 0 by range, every one "
        f"their owner's own walk finds ({int(own.sum())}), no fewer than one LiveIndex over the "
        f"{n}-point k-NN graph under the same churn finds ({one_found}), none of them without an "
        f"in-edge ({int(orphan.sum())} of {m} have none and are no start point; in the single "
        f"index {one_orphans}); the owner's walk from 32 start points finds "
        f"{int(many.sum())}; range bit for bit the "
        f"host union of the {SHARDS} shards' "
        f"LiveSnapshot.range with external ids, replicated_corpus() through "
        f"replicated_fan_out (served by replica 1) bit for bit range; card {card}")
    log(f"[live sharded] rebuild: shard {s}'s primary saved in {t_save:.2f} s, a WAL tail of "
        f"{LS_TAIL} inserts and {LS_TAIL} deletes ({wal_bytes} bytes), replica ({s}, 1) lost and "
        f"rebuilt (restore + replay) in {t_rebuild:.2f} s, parity held; AP on the final live set "
        f"{ap_final:.4f} ({sl.n_live} live); launches: churn {churn_counts}, range {range_counts}; "
        f"card {card}")
    log(f"[live sharded] phase took {time.perf_counter() - t_phase:.1f} s")
    return {kk: counts[kk] for kk in ("expand", "gatherdist")}


CELL_RUNS = (("search_4k", "float32"), ("search_4k", "int8"), ("search_64k", "float32"))
CELL_PATH = {"float32": ("expand", "gatherdist"),
             "int8": ("expand_int8", "gatherdist_int8", "rerank_fetch")}
CELL_PLAIN_QUERIES = 256    # the kernel-vs-plain AP gate's lanes, as [plain]
CELL_AP_GAP = 0.01
CELL_ITERS = 3              # timed cell calls (the median), after one warm-up


CELL_KEEP_EVERY = 64        # the expand launches of a cell call held against the plain op


class CellCapture:
    """Swaps the f32 path's two kernel wrappers (``expand_cuda``,
    ``gatherdist_cuda``) for recorders that keep the inputs of every
    CELL_KEEP_EVERY-th expand launch (the first included) and of every
    gatherdist launch of one cell call: the per-iteration inputs cloned,
    the corpus and adjacency (never written) by reference. The recorders
    launch what they wrap, so the counts move as they would."""

    CLONED = {"expand_cuda": (2, 3), "gatherdist_cuda": (1, 2)}   # frontier/ids, queries
    EVERY = {"expand_cuda": CELL_KEEP_EVERY, "gatherdist_cuda": 1}

    def __init__(self):
        self.mods = {"expand_cuda": sys.modules["repro_torch.kernels.expand.ops"],
                     "gatherdist_cuda": sys.modules["repro_torch.kernels.gatherdist.ops"]}
        self.seen = dict.fromkeys(self.mods, 0)
        self.kept = []

    def _record(self, inner, args, kw):
        name = inner.__name__
        if self.seen[name] % self.EVERY[name] == 0:
            self.kept.append((name, self.seen[name],
                              [a.clone() if i in self.CLONED[name] else a
                               for i, a in enumerate(args)], dict(kw)))
        self.seen[name] += 1

    def __enter__(self):
        self.inner = {name: getattr(mod, name) for name, mod in self.mods.items()}
        for name, mod in self.mods.items():
            setattr(mod, name, _Recorder(self.inner[name], self._record))
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, name, self.inner[name])

    def check(self, tag: str) -> dict:
        """Each kept launch again on its inputs against its plain op: ids
        and n_dist equal, distances within DIST_TOL. Returns each kernel's
        (launches held, lanes a launch, largest error)."""
        import torch
        from repro_torch.kernels.expand import expand_frontier_ref
        from repro_torch.kernels.gatherdist import gatherdist_ref
        held = {}
        for name, i, args, kw in self.kept:
            got = self.inner[name](*args, **kw)
            if name == "expand_cuda":
                want = expand_frontier_ref(*args, **kw)
                torch.cuda.synchronize()
                if not (torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])):
                    raise AssertionError(f"[cells] {tag}: expand launch {i}: ids/n_dist differ "
                                         "from the plain version")
                err = check_close(f"[cells] {tag}: expand launch {i}", got[1], want[1],
                                  DIST_TOL["float32"])
            else:
                want = gatherdist_ref(*args, **kw)
                torch.cuda.synchronize()
                err = check_close(f"[cells] {tag}: gatherdist launch {i}", got, want,
                                  DIST_TOL["float32"])
            k = name.removesuffix("_cuda")
            n, lanes, worst = held.get(k, (0, 0, 0.0))
            held[k] = (n + 1, max(lanes, int(args[-1].shape[0])), max(worst, err))
            del got, want
        missing = {k.removesuffix("_cuda") for k in self.mods} - set(held)
        if missing:
            raise AssertionError(f"[cells] {tag}: no {sorted(missing)} launch was captured")
        return held


def cells_meta_pass(mesh) -> None:
    """[cells] meta pass: every cell of ``all_cells(include_engine=True)``
    built at full width on the meta device (``launch.steps.build_cell``),
    each with its analytic model flops, the bytes of its parameter,
    optimizer-state and input trees (``utils.tree_bytes``) and the compute
    floor of those flops at the bf16 peak."""
    from repro_torch.analysis.roofline import analytic_model_flops
    from repro_torch.configs import all_cells, get_arch
    from repro_torch.launch.steps import build_cell
    from repro_torch.utils import tree_bytes, tree_leaves
    t0 = time.perf_counter()
    cells = all_cells(include_engine=True)
    for aid, name in cells:
        arch = get_arch(aid)
        shape = arch.shapes[name]
        cell = build_cell(arch, name, mesh)
        if any(not x.is_meta for x in tree_leaves(cell.args)):
            raise AssertionError(f"[cells] {aid} {name}: an input was allocated")
        flops = analytic_model_flops(arch, shape, cell.args[0])
        if len(cell.roles) != len(cell.args):
            raise AssertionError(f"[cells] {aid} {name}: roles {cell.roles} for "
                                 f"{len(cell.args)} args")
        params, opt, inputs = (
            tree_bytes([a for a, role in zip(cell.args, cell.roles) if role == want])
            for want in ("params", "opt_state", "inputs"))
        log(f"[cells] {aid} {name} ({shape.kind}): model flops {flops:.4g}, params "
            f"{params / 1e9:.3f} GB, optimizer state {opt / 1e9:.3f} GB, inputs "
            f"{inputs / 1e9:.3f} GB, compute floor at {PEAK_FLOPS / 1e12:.0f} TFLOP/s "
            f"{flops / PEAK_FLOPS * 1e3:.4f} ms")
    log(f"[cells] meta pass: {len(cells)} cells built at full width on the meta device in "
        f"{time.perf_counter() - t0:.2f} s")


def cells_phase(points, graph, queries, queries_64k, r, kernels) -> dict:
    """[cells]: the cell builder (``launch.steps``) and the roofline
    (``analysis.roofline``). The meta pass (``cells_meta_pass``), then the
    range-engine cell materialized on the card: one shard, the main path's
    corpus and k-NN graph (R=32) with its medoid as the start, at
    ``EngineDeployConfig``'s search (greedy, beam 64, visit_cap 256, E=4,
    result_cap 1024) over a one-rank mesh (``make_mesh((1, 1))``, NCCL):
    search_4k in f32 and int8 on the main path's queries, search_64k in f32
    on 65,536 more of the corpus's queries. The cell searches at radius 1.0
    and the distances are squared l2, so corpus and queries are scaled by
    1/sqrt(r): radius 1.0 there is the main path's r. For each run: the
    cell on the first CELL_PLAIN_QUERIES queries, kernel and plain path
    (``use_kernels=False``; AP within CELL_AP_GAP); a direct
    ``range_search_fused`` of the shard (which warms the full batch up);
    then one cell call over the whole batch with every launch count set to
    0 just before and read just after (each kernel of the dtype's path
    launched), its ids, distance bits and counts equal to the direct call
    merged as one shard (``host_union``); in f32 that call's kernels at
    the batch's own lane count (``CellCapture``: every 64th expand launch
    and every gatherdist launch) held against their plain ops at DIST_TOL;
    AP against ``exact_range_search`` at 1.0; the median wall of
    CELL_ITERS more calls (``utils.timeit``), QPS, peak memory over them;
    the engine's analytic flops and their floor at the f32 rate, and the
    reference model's gather bytes (queries x visit_cap x R x
    ``corpus_bytes_per_distance``) and their floor at ``HBM_BW``, each as
    a share of the wall. Returns each kernel's launches summed over the
    counted calls."""
    import torch
    import torch.distributed as dist
    from repro_torch.analysis.roofline import analytic_model_flops, corpus_bytes_per_distance
    from repro_torch.configs.range_engine import ARCH, EngineDeployConfig
    from repro_torch.core import (
        Graph, QuantizedCorpus, average_precision, exact_range_search, match_histogram,
        medoid, quantize_corpus, range_search_fused)
    from repro_torch.dist import make_mesh
    from repro_torch.launch.steps import build_cell
    from repro_torch.utils import block_until_ready, timeit, tree_leaves
    dev = points.device
    card = card_line()
    t_phase = time.perf_counter()
    mesh = make_mesh((1, 1), device_type=dev.type)
    try:
        cells_meta_pass(mesh)
        n, dim = points.shape
        scale = 1.0 / float(np.sqrt(r))
        pts = points * scale
        qsets = {"search_4k": queries * scale, "search_64k": queries_64k * scale}
        nbrs = graph.neighbors
        start = medoid(pts).reshape(1, 1).to(torch.int32)
        offsets = torch.zeros(1, dtype=torch.int32, device=dev)
        qc = quantize_corpus(pts)
        stacked = {"float32": pts[None],
                   "int8": QuantizedCorpus(codes=qc.codes[None], meta=qc.meta[None],
                                           raw=qc.raw[None])}
        unscaled = {"float32": pts, "int8": qc}
        log(f"[cells] card pass: corpus {n} x {dim} and queries scaled by 1/sqrt(r) = "
            f"{scale:.6g} (r={r:.6g}), so the cell's radius 1.0 is r; k-NN graph R="
            f"{nbrs.shape[1]}, start {int(start)}; mesh (1, 1) over {dist.get_backend()}; "
            f"card {card}")
        oracles, launches, summary = {}, {}, {}
        for name, cdt in CELL_RUNS:
            deploy = EngineDeployConfig(shard_corpus=n, dim=dim, corpus_dtype=cdt)
            batch = qsets[name].shape[0]
            shape = dataclasses.replace(ARCH.shapes[name], global_batch=batch)
            arch = dataclasses.replace(ARCH, model_cfg=deploy, shapes={name: shape})
            cell = build_cell(arch, name, mesh)
            cfg = deploy.range_cfg
            qs = qsets[name]
            args = (stacked[cdt], nbrs[None], start, offsets, qs)
            want = [tuple(x.shape) for x in tree_leaves(cell.args)]
            have = [tuple(x.shape) for x in tree_leaves(args)]
            if want != have:
                raise AssertionError(f"[cells] {name} {cdt}: inputs {have}, the cell's {want}")
            # the kernel path against the plain path on the first lanes
            sub = qs[:CELL_PLAIN_QUERIES]
            plain_arch = dataclasses.replace(arch, model_cfg=deploy.overrides(use_kernels=False))
            plain = build_cell(plain_arch, name, mesh)
            gt_ids, _, gt_counts = exact_range_search(pts, sub, 1.0, device=dev)
            gt_ids, gt_counts = gt_ids.cpu().numpy(), gt_counts.cpu().numpy()
            ap_sub = {}
            for path, c in (("kernel", cell), ("plain", plain)):
                ids, _, count = c.fn(*args[:4], sub)
                ap_sub[path] = average_precision(gt_ids, gt_counts, ids.cpu().numpy(),
                                                 count.cpu().numpy())
            if abs(ap_sub["kernel"] - ap_sub["plain"]) > CELL_AP_GAP:
                raise AssertionError(f"[cells] {name} {cdt}: kernel AP {ap_sub['kernel']:.4f}, "
                                     f"plain AP {ap_sub['plain']:.4f}")
            # the direct search of the shard, which also warms the batch up
            radii = torch.full((batch,), 1.0, dtype=torch.float32, device=dev)
            direct = _host(block_until_ready(range_search_fused(
                corpus=unscaled[cdt], graph=Graph(neighbors=nbrs), queries=qs,
                start_ids=start[0], r=radii, cfg=cfg)))
            want = host_union([direct], [0], n, cfg.result_cap)
            capture = CellCapture() if cdt == "float32" and dev.type == "cuda" else None
            reset_counts(kernels)
            with capture or contextlib.nullcontext():
                out = block_until_ready(cell.fn(*args))
            counts, _ = read_counts(kernels)
            missing = [k for k in CELL_PATH[cdt] if counts[k] == 0]
            if missing:
                raise AssertionError(f"[cells] {name} {cdt}: {missing} never launched {counts}")
            for k in CELL_PATH[cdt]:
                launches[k] = launches.get(k, 0) + counts[k]
            ids, dists, count = (x.cpu().numpy() for x in out)
            bad = [f for f, a, b in (("ids", ids, want["ids"]),
                                     ("dists", dists.view(np.int32), want["dists"].view(np.int32)),
                                     ("count", count, want["count"]))
                   if not np.array_equal(a, b)]
            if bad:
                raise AssertionError(f"[cells] {name} {cdt}: {bad} differ from the direct "
                                     "range_search_fused merged as one shard")
            del out, direct
            held = capture.check(f"{name} {cdt}") if capture else {}
            del capture
            if held and held["expand"][1] != batch:
                raise AssertionError(f"[cells] {name} {cdt}: the held expand launches had "
                                     f"{held['expand'][1]} lanes, not {batch}")
            held_txt = "; ".join(
                f"{k} {h[0]} launches at {h[1]} lanes equal to the plain op (max_abs_err "
                f"{h[2]:.3g})" for k, h in held.items()) or "per-kernel holds in [main]"
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats()
            wall = timeit(lambda: cell.fn(*args), warmup=1, iters=CELL_ITERS)
            peak = torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda" else 0.0
            if name not in oracles:
                g_ids, _, g_counts = exact_range_search(pts, qs, 1.0, device=dev)
                oracles[name] = (g_ids.cpu().numpy(), g_counts.cpu().numpy())
            ap = average_precision(*oracles[name], ids, count)
            flops = analytic_model_flops(arch, shape, cell.args[0])
            flops_ms = flops / F32_FLOPS * 1e3
            gather = batch * cfg.search.visit_cap * deploy.max_degree * \
                corpus_bytes_per_distance(dim, cdt)
            gather_ms = gather / HBM_BW * 1e3
            ms = wall * 1e3
            log(f"[cells] range-engine {name} {cdt}: {batch} queries in {ms:.2f} ms wall "
                f"(the median of {CELL_ITERS}; {batch / wall:.1f} QPS), peak device memory "
                f"{peak:.2f} GB, AP={ap:.4f} "
                f"(first {CELL_PLAIN_QUERIES}: kernel {ap_sub['kernel']:.4f}, plain "
                f"{ap_sub['plain']:.4f}); ids, distance bits and counts equal to the direct "
                f"range_search_fused; analytic flops {flops:.4g} (floor at "
                f"{F32_FLOPS / 1e12:.0f} TFLOP/s f32 {flops_ms:.4f} ms, "
                f"{flops_ms / ms:.2%} of the wall); reference gather bytes {gather:.4g} "
                f"({corpus_bytes_per_distance(dim, cdt):.0f} B a distance; floor at "
                f"{HBM_BW / 1e12:.2f} TB/s {gather_ms:.4f} ms, {gather_ms / ms:.2%} of the "
                f"wall); launches {counts}; {held_txt}; results {match_histogram(count)}; "
                f"card {card}")
            summary[f"{name} {cdt}"] = {
                "wall_ms": ms, "qps": batch / wall, "peak_gb": peak, "ap": ap,
                "kernel_ap": ap_sub["kernel"], "plain_ap": ap_sub["plain"],
                "model_flops": flops, "flops_floor_ms": flops_ms, "gather_bytes": gather,
                "gather_floor_ms": gather_ms, "launches": counts,
                "held": {k: {"launches": h[0], "lanes": h[1], "max_abs_err": h[2]}
                         for k, h in held.items()}}
        log(json.dumps({"[cells]": {**summary, "card": card}}))
    finally:
        dist.destroy_process_group()
    log(f"[cells] phase took {time.perf_counter() - t_phase:.1f} s")
    return launches


# each run builds its own Vamana index (1M takes 180 s): cut from 200,000,
# then to 100,000 and 1,024 queries, then 50,000 and 512, then 25,000 and
# 256, to keep the whole script well inside its limit
CLI_N = 25_000
CLI_QUERIES = 256
CLI_RUNS = (("--early-stop", "--mixed-radius"),
            ("--shards", "4", "--replicas", "2", "--hedge-ms", "5", "--down-replicas", "1:0,3:1"),
            ("--churn", "0.05"))
CLI_TIMEOUT_S = 300


def cli_phase() -> None:
    """[cli]: the port's serving CLI, ``python -m repro_torch.launch.serve
    --n CLI_N --queries CLI_QUERIES`` in a subprocess a run, on the card:
    CLI_RUNS. Each must exit 0 and print its AP and rate lines; the
    replicated run must print ``min coverage=1.00`` and
    ``codes={'replica_lost'}``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    card = card_line()
    for extra in CLI_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--n", str(CLI_N),
               "--queries", str(CLI_QUERIES), *extra]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                           timeout=CLI_TIMEOUT_S)
        wall = time.perf_counter() - t0
        name = " ".join(extra)
        if p.returncode != 0:
            raise AssertionError(f"[cli] {name} exited {p.returncode}:\n"
                                 f"{(p.stdout + p.stderr)[-3000:]}")
        lines = [ln for ln in p.stdout.splitlines() if ln.startswith("[serve]")]
        keep = [ln for ln in lines if re.search(r"AP|QPS|req/s|radius |built|replication",
                                                ln) and "stats=" not in ln]
        if not any("AP" in ln for ln in keep) or not any(
                re.search(r"QPS|req/s", ln) for ln in keep):
            raise AssertionError(f"[cli] {name}: no AP or rate line:\n{p.stdout[-3000:]}")
        if "--replicas" in extra and not ("min coverage=1.00" in p.stdout
                                          and "codes={'replica_lost'}" in p.stdout):
            raise AssertionError(f"[cli] {name}: not whole with replicas down:\n"
                                 f"{p.stdout[-3000:]}")
        log(f"[cli] {name} (n={CLI_N}, {CLI_QUERIES} queries): exit 0 in {wall:.1f} s; "
            + " | ".join(ln[len("[serve] "):] for ln in keep) + f"; card {card}")


# ---------------------------------------------------------------------------
# 20-23. Training: the LM, the recsys family, the GCN, the training CLI
# ---------------------------------------------------------------------------

TRAIN_LM_LAYERS = 4         # qwen3-14b at full width, depth cut from 40
TRAIN_LM_BATCH = 2          # train_4k's sequence length; its global batch of 256 cut
TRAIN_LM_SEQ = 4096
TRAIN_LM_STEPS = 8
TRAIN_LM_STATE_GB = 46.0    # f32 masters, gradients, m and v: 16 B a parameter
TRAIN_REL = 1e-4            # card against CPU, one f32 step, every leaf (rel. L2)
TRAIN_GCN_REL = 1e-5
TRAIN_RECSYS_ROWS = 65_536  # the train_batch shape
TRAIN_RECSYS_STEPS = 5
TRAIN_RECSYS = (            # (config module, vocab a field: None keeps the published one)
    ("wide_deep", None), ("autoint", None), ("dlrm_rm2", 2_097_152),
    ("two_tower_retrieval", 1_048_576))
SERVE_RECSYS = ("wide_deep", "dlrm_rm2", "autoint")
GCN_CORA_STEPS = 200
GCN_PRODUCTS = dict(n_nodes=2_449_029, n_classes=47, d_feat=100, avg_degree=25)
GCN_PRODUCTS_STEPS = 5
TRAIN_CLI_ARCHS = ("gemma3-27b", "gcn-cora", "dlrm-rm2")
TRAIN_CLI_RUNS = (("--steps", "20"), ("--steps", "30", "--resume"))
TRAIN_CLI_TIMEOUT_S = 120


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    return tree.to(dev).clone()


def train_card_vs_cpu(family: str, cfg, opt, batch, dev, tol: float, name: str) -> float:
    """One f32 training step (the Trainer's) from the same weights
    on the CPU and on the card; every updated leaf within ``tol`` relative
    L2 and the loss within 1e-5 (asserted). Returns the largest leaf error."""
    import functools

    import torch
    from repro_torch.launch.train import init_params
    from repro_torch.models import gcn_loss, loss_fn, recsys_loss
    from repro_torch.optim import init_adamw, make_train_step
    from repro_torch.utils import tree_leaves
    loss = functools.partial({"lm": loss_fn, "gnn": gcn_loss, "recsys": recsys_loss}[family],
                             cfg=cfg)
    start = init_params(family, cfg, SEED, torch.device("cpu"))
    out = {}
    for d in (torch.device("cpu"), dev):
        tree = _tree_to(start, d)
        tree, _, metrics = make_train_step(loss, opt)(
            tree, init_adamw(tree, opt), batch)
        out[d.type] = (tree_leaves(tree), float(metrics["loss"]))
    (cpu, lc), (card, lg) = out["cpu"], out["cuda"]
    worst = max(rel_l2(a.cpu(), b) for a, b in zip(card, cpu))
    if worst > tol or abs(lc - lg) > 1e-5 * abs(lc):
        raise AssertionError(f"{name}: card against CPU, leaf error {worst:.3g} "
                             f"(limit {tol}), loss {lg} against {lc}")
    return worst


class UpdateTimer:
    """Wraps the optimizer's update, which ``make_train_step`` calls by its
    module name, between two CUDA events: the update's share of a step."""

    def __init__(self):
        from repro_torch.optim import adamw
        self.mod, self.spans = adamw, []

    def __enter__(self):
        import torch
        inner = self.inner = self.mod.adamw_update

        def timed(*a, **k):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            out = inner(*a, **k)
            ev[1].record()
            self.spans.append(ev)
            return out

        self.mod.adamw_update = timed
        return self

    def __exit__(self, *exc):
        self.mod.adamw_update = self.inner

    def ms(self) -> list:
        return [a.elapsed_time(b) for a, b in self.spans]


def timed_steps(step, tree, state, batches, dev):
    """Run ``step`` over ``batches`` (numpy, moved to ``dev``), each to a
    synchronize: (tree, state, per-step seconds, per-step update ms, the
    metrics of each step as floats)."""
    import torch
    secs, metrics = [], []
    with UpdateTimer() as ut:
        for b in batches:
            b = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree, state, m = step(tree, state, b)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            metrics.append({k: float(v) for k, v in m.items()})
    return tree, state, secs, ut.ms(), metrics


def _check_finite(metrics: list, name: str) -> None:
    for i, m in enumerate(metrics):
        if not all(np.isfinite(v) for v in m.values()):
            raise AssertionError(f"{name}: step {i + 1} metrics not finite: {m}")


def train_lm_phase(dev, flash) -> dict:
    """[train lm]: qwen3-14b at full width on TRAIN_LM_LAYERS layers, f32
    masters from SEED computed in bf16 with remat, TRAIN_LM_STEPS steps of
    the Trainer's step at the config's opt_cfg over TRAIN_LM_BATCH x
    TRAIN_LM_SEQ tokens of the LM stream; then the trained weights in bf16
    served: one prefill, flashattn on wgmma once a layer; then the card
    against the CPU on a narrow 2-layer qwen3 in f32."""
    import functools

    import torch
    from repro_torch.configs import qwen3_14b
    from repro_torch.data import LMDataConfig, lm_batch
    from repro_torch.models import (
        init_transformer, loss_fn, prefill, transformer_from_tree, transformer_tree)
    from repro_torch.optim import init_adamw, make_train_step
    from repro_torch.utils import tree_leaves
    card = card_line()
    cfg = dataclasses.replace(qwen3_14b.ARCH.model_cfg, n_layers=TRAIN_LM_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tree = transformer_tree(init_transformer(cfg, seed=SEED, device=dev, f32_masters=True), cfg)
    opt_state = init_adamw(tree, qwen3_14b.ARCH.opt_cfg)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(tree))
    state_gb = 4 * n_params * 4 / 1e9
    log(f"[train lm] qwen3-14b at full width (d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.n_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab:,} untied), depth cut from "
        f"{qwen3_14b.ARCH.model_cfg.n_layers} to {cfg.n_layers}: {n_params:,} f32 masters "
        f"from seed {SEED}, built with the AdamW moments in {time.perf_counter() - t0:.1f} s; "
        f"state (masters, gradients, m, v) {state_gb:.2f} GB; card {card}")
    data = LMDataConfig(vocab=cfg.vocab, seq_len=TRAIN_LM_SEQ, batch=TRAIN_LM_BATCH, seed=SEED)
    batches = [lm_batch(data, s) for s in range(TRAIN_LM_STEPS)]
    step = make_train_step(functools.partial(loss_fn, cfg=cfg), qwen3_14b.ARCH.opt_cfg)
    flash.launches = 0
    tree, opt_state, secs, upd_ms, metrics = timed_steps(step, tree, opt_state, batches, dev)
    train_launches = flash.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_finite(metrics, "[train lm]")
    if train_launches != 0:
        raise AssertionError(f"[train lm]: flashattn launched {train_launches} times in training")
    if not all(t.dtype == torch.float32 for t in tree_leaves(tree)):
        raise AssertionError("[train lm]: a master left f32")
    toks = TRAIN_LM_BATCH * TRAIN_LM_SEQ
    steady = secs[1:]
    log(f"[train lm] {TRAIN_LM_STEPS} steps of {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} tokens "
        f"(bf16 compute, remat, sdpa core, CE chunk {cfg.loss_chunk}): step 1 "
        f"{secs[0] * 1e3:.1f} ms, steps 2-{TRAIN_LM_STEPS} median "
        f"{np.median(steady) * 1e3:.1f} ms (forward+backward "
        f"{(np.median(steady) * 1e3 - np.median(upd_ms[1:])):.1f} ms, update "
        f"{np.median(upd_ms[1:]):.1f} ms), {toks / np.median(steady):.1f} tokens/s; "
        f"losses {[round(m['loss'], 4) for m in metrics]}, grad norms "
        f"{[round(m['grad_norm'], 4) for m in metrics]}, lr {metrics[-1]['lr']:.3g}; "
        f"peak device memory {peak:.2f} GB (state {state_gb:.2f} GB); flashattn launches "
        f"{train_launches}; masters f32; card {card}")
    log(json.dumps({"[train lm]": {
        "step_ms": float(np.median(steady)) * 1e3,
        "update_ms": float(np.median(upd_ms[1:])),
        "tokens_per_s": toks / float(np.median(steady)),
        "peak_gb": peak, "state_gb": state_gb, "card": card}}))
    del opt_state
    torch.cuda.empty_cache()
    model = transformer_from_tree(tree, cfg)           # the trained weights, in bf16
    del tree
    torch.cuda.empty_cache()
    reset_counts({"flashattn": flash})
    prompt = torch.as_tensor(batches[0]["tokens"][:1], device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, _ = prefill(model, prompt, cfg, max_len=TRAIN_LM_SEQ)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    launches, routes = flash.launches, dict(flash.routes)
    if launches != cfg.n_layers or routes["wgmma"] != cfg.n_layers:
        raise AssertionError(f"[train lm] served prefill: flashattn {launches} launches, "
                             f"routes {routes}")
    if not torch.isfinite(logits).all():
        raise AssertionError("[train lm] served prefill: logits not finite")
    log(f"[train lm] the trained weights in bf16 served: one prefill of 1 x {TRAIN_LM_SEQ} "
        f"in {t_prefill * 1e3:.1f} ms, flashattn {launches} launches, routes {routes}, "
        f"logits finite")
    del model, logits
    torch.cuda.empty_cache()
    narrow = dataclasses.replace(qwen3_14b.reduced(), n_layers=2, remat=True)
    batch = lm_batch(LMDataConfig(vocab=narrow.vocab, seq_len=128, batch=2, seed=SEED), 0)
    err = train_card_vs_cpu("lm", narrow, dataclasses.replace(
        qwen3_14b.ARCH.opt_cfg, warmup_steps=1), batch, dev, TRAIN_REL, "[train lm]")
    log(f"[train lm] card against CPU: one f32 step of a 2-layer qwen3 (d_model "
        f"{narrow.d_model}, 2 x 128 tokens), every leaf within {err:.3g} relative L2 "
        f"(limit {TRAIN_REL})")
    return {"train_launches": train_launches, "train_prefill_launches": launches}


def train_recsys_phase(dev) -> None:
    """[train recsys]: TRAIN_RECSYS_STEPS steps of the Trainer's step on
    TRAIN_RECSYS_ROWS rows of the recsys stream for each of TRAIN_RECSYS
    (wide-deep and autoint at full width and vocabulary; dlrm-rm2 and
    two-tower with the vocabulary cut), rows/s, ms a step and peak memory;
    the three CTR kinds' forward served at full vocabulary on serve_p99 and
    serve_bulk rows; each reduced config one step on the card against the
    CPU."""
    import functools
    import importlib

    import torch
    from repro_torch.data import RecsysDataConfig, recsys_batch
    from repro_torch.models import init_recsys, recsys_forward, recsys_loss, recsys_tree
    from repro_torch.optim import init_adamw, make_train_step
    from repro_torch.utils import tree_leaves
    card = card_line()

    def data(cfg, rows, step):
        return recsys_batch(RecsysDataConfig(
            n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, vocab=cfg.vocab, batch=rows,
            seed=SEED, two_tower=cfg.kind == "two_tower", n_sparse_item=cfg.n_sparse_item),
            step)

    for mod_name, vocab in TRAIN_RECSYS:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg = mod.ARCH.model_cfg
        cut = "" if vocab is None else f", vocabulary cut from {cfg.vocab:,} to {vocab:,} a field"
        if vocab is not None:
            cfg = dataclasses.replace(cfg, vocab=vocab)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = recsys_tree(init_recsys(cfg, seed=SEED, device=dev))
        state = init_adamw(tree, mod.ARCH.opt_cfg)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = sum(t.numel() for t in tree_leaves(tree))
        batches = [data(cfg, TRAIN_RECSYS_ROWS, s) for s in range(TRAIN_RECSYS_STEPS)]
        step = make_train_step(functools.partial(recsys_loss, cfg=cfg), mod.ARCH.opt_cfg)
        tree, state, secs, upd_ms, metrics = timed_steps(step, tree, state, batches, dev)
        peak = torch.cuda.max_memory_allocated() / 1e9
        _check_finite(metrics, f"[train recsys] {mod.ARCH.arch_id}")
        steady = float(np.median(secs[1:]))
        log(f"[train recsys] {mod.ARCH.arch_id} ({cfg.kind}{cut}): {n_params:,} f32 "
            f"parameters ({4 * n_params / 1e9:.2f} GB, {16 * n_params / 1e9:.2f} GB with "
            f"gradients and moments), built in {t_init:.1f} s; {TRAIN_RECSYS_STEPS} steps of "
            f"{TRAIN_RECSYS_ROWS:,} rows: step 1 {secs[0] * 1e3:.1f} ms, then median "
            f"{steady * 1e3:.1f} ms (update {np.median(upd_ms[1:]):.1f} ms), "
            f"{TRAIN_RECSYS_ROWS / steady:,.0f} rows/s; losses "
            f"{[round(m['loss'], 4) for m in metrics]}; peak {peak:.2f} GB; card {card}")
        del tree, state
        torch.cuda.empty_cache()
    for mod_name in SERVE_RECSYS:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg = mod.ARCH.model_cfg
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            tree = recsys_tree(init_recsys(cfg, seed=SEED, device=dev))
            parts = []
            for shape in ("serve_p99", "serve_bulk"):
                rows = mod.ARCH.shapes[shape].global_batch
                b = {k: torch.as_tensor(v, device=dev) for k, v in data(cfg, rows, 0).items()
                     if k != "label"}
                recsys_forward(tree, b, cfg)          # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(5):
                    logit = recsys_forward(tree, b, cfg)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) / 5 * 1e3
                if tuple(logit.shape) != (rows,) or not torch.isfinite(logit).all():
                    raise AssertionError(f"[train recsys] {mod.ARCH.arch_id} {shape}: "
                                         f"logits {tuple(logit.shape)} not finite")
                parts.append(f"{shape} ({rows:,} rows) {ms:.3f} ms, {rows / ms * 1e3:,.0f} rows/s")
        log(f"[train recsys] {mod.ARCH.arch_id} served at full vocabulary "
            f"({cfg.vocab:,} a field, "
            f"{sum(t.numel() for t in tree_leaves(tree)) * 4 / 1e9:.2f} GB): "
            + "; ".join(parts) + f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del tree
        torch.cuda.empty_cache()
    for mod_name, _ in TRAIN_RECSYS:
        mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
        cfg = mod.reduced()
        err = train_card_vs_cpu("recsys", cfg, dataclasses.replace(
            mod.ARCH.opt_cfg, warmup_steps=1), data(cfg, 1024, 0), dev, TRAIN_REL,
            f"[train recsys] {mod.ARCH.arch_id}")
        log(f"[train recsys] card against CPU: one f32 step of reduced {mod.ARCH.arch_id} "
            f"on 1,024 rows, every leaf within {err:.3g} relative L2 (limit {TRAIN_REL})")


def train_gcn_phase(dev) -> None:
    """[train gcn]: gcn-cora's published geometry on make_sbm_graph(2708, 7,
    1433, avg_degree=4), GCN_CORA_STEPS steps of its opt_cfg (training
    accuracy); the ogb_products scale (GCN_PRODUCTS), GCN_PRODUCTS_STEPS
    steps (ms a step, peak memory); the card against the CPU at Cora size."""
    import functools

    import torch
    from repro_torch.configs import gcn_cora
    from repro_torch.data import make_sbm_graph
    from repro_torch.models import gcn_loss, init_gcn
    from repro_torch.optim import init_adamw, make_train_step
    card = card_line()
    cfg, opt = gcn_cora.ARCH.model_cfg, gcn_cora.ARCH.opt_cfg
    g = make_sbm_graph(2708, cfg.n_classes, cfg.d_feat, avg_degree=4, seed=SEED)
    batch = {"feats": g.feats, "edge_src": g.edge_src, "edge_dst": g.edge_dst,
             "labels": g.labels}
    params = init_gcn(cfg, seed=SEED, device=dev)
    step = make_train_step(functools.partial(gcn_loss, cfg=cfg), opt)
    params, state, secs, _, metrics = timed_steps(step, params, init_adamw(params, opt),
                                                  [batch] * GCN_CORA_STEPS, dev)
    _check_finite(metrics, "[train gcn] cora")
    log(f"[train gcn] gcn-cora (2 layers, hidden {cfg.d_hidden}, {cfg.d_feat} features, "
        f"{cfg.n_classes} classes) on an SBM graph of 2,708 nodes and {g.n_edges:,} edges: "
        f"{GCN_CORA_STEPS} steps, median {np.median(secs[1:]) * 1e3:.2f} ms a step; loss "
        f"{metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}, training accuracy "
        f"{metrics[0]['acc']:.4f} -> {metrics[-1]['acc']:.4f}; card {card}")
    del params, state
    err = train_card_vs_cpu("gnn", cfg, opt, batch, dev, TRAIN_GCN_REL, "[train gcn]")
    log(f"[train gcn] card against CPU: one f32 step at Cora size, every leaf within "
        f"{err:.3g} relative L2 (limit {TRAIN_GCN_REL})")
    p = GCN_PRODUCTS
    big = dataclasses.replace(cfg, d_feat=p["d_feat"], n_classes=p["n_classes"])
    t0 = time.perf_counter()
    g = make_sbm_graph(p["n_nodes"], p["n_classes"], p["d_feat"], avg_degree=p["avg_degree"],
                       seed=SEED)
    t_graph = time.perf_counter() - t0
    batch = {k: torch.as_tensor(getattr(g, k), device=dev)
             for k in ("feats", "edge_src", "edge_dst", "labels")}
    del g
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_gcn(big, seed=SEED, device=dev)
    step = make_train_step(functools.partial(gcn_loss, cfg=big), opt)
    params, state, secs, _, metrics = timed_steps(step, params, init_adamw(params, opt),
                                                  [batch] * GCN_PRODUCTS_STEPS, dev)
    _check_finite(metrics, "[train gcn] products")
    n_edges = batch["edge_src"].numel()
    log(f"[train gcn] ogb_products scale: {p['n_nodes']:,} nodes, {n_edges:,} edges "
        f"(avg_degree {p['avg_degree']}; the shape has 61,859,140), {p['d_feat']} features, "
        f"{p['n_classes']} classes (graph made on the host in {t_graph:.1f} s): "
        f"{GCN_PRODUCTS_STEPS} steps, step 1 {secs[0] * 1e3:.1f} ms, then median "
        f"{np.median(secs[1:]) * 1e3:.1f} ms, {n_edges / np.median(secs[1:]):,.0f} edges/s; "
        f"loss {metrics[0]['loss']:.4f} -> {metrics[-1]['loss']:.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB (layer 2's messages alone "
        f"{n_edges * p['n_classes'] * 4 / 1e9:.2f} GB); card {card}")
    del params, state, batch
    torch.cuda.empty_cache()


def train_cli_phase() -> None:
    """[train cli]: ``python -m repro_torch.launch.train --arch <id> --smoke
    --steps 20`` for each of TRAIN_CLI_ARCHS, then ``--resume --steps 30``
    on the same checkpoint directory (under build/): each exits 0, and the
    second prints ``resumed from step 20``. The three archs run at once
    (their models are small; most of a run's wall is starting up), each
    arch's two runs in turn."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_root = tempfile.mkdtemp(prefix="train_cli_", dir=os.path.join(ROOT, "build"))
    card = card_line()

    def runs(arch: str) -> str:
        lines = []
        for extra in TRAIN_CLI_RUNS:
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
                   "--smoke", "--ckpt-dir", os.path.join(ckpt_root, arch), *extra]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                               timeout=TRAIN_CLI_TIMEOUT_S)
            wall = time.perf_counter() - t0
            if p.returncode != 0:
                raise AssertionError(f"[train cli] {arch} {' '.join(extra)} exited "
                                     f"{p.returncode}:\n{(p.stdout + p.stderr)[-3000:]}")
            if "--resume" in extra and "[train] resumed from step 20" not in p.stdout:
                raise AssertionError(f"[train cli] {arch}: did not resume:\n{p.stdout[-3000:]}")
            last = [ln for ln in p.stdout.splitlines() if ln.startswith("[trainer] step")]
            lines.append(f"{' '.join(extra)}: exit 0 in {wall:.1f} s, "
                         f"{last[-1] if last else 'no step line'}")
        return f"[train cli] {arch} --smoke: " + " | ".join(lines) + f"; card {card}"

    try:
        with ThreadPoolExecutor(len(TRAIN_CLI_ARCHS)) as pool:
            for line in pool.map(runs, TRAIN_CLI_ARCHS):
                log(line)
    finally:
        shutil.rmtree(ckpt_root, ignore_errors=True)


MESH_TRAIN_LAYERS = 2       # qwen3-14b at full width, depth cut from 40
MESH_TRAIN_STEPS = 3
MESH_TRAIN_REL = 1e-5       # the mesh trainer against the unsharded one (relative)
ELASTIC_LM = dict(name="elastic", n_layers=2, d_model=32, n_heads=4, n_kv=4, d_head=16,
                  d_ff=64, vocab=64, loss_chunk=16, remat=False)   # the reference test's rig
ELASTIC_DATA = dict(vocab=64, seq_len=16, batch=4)
MESH_TRAIN_TIMEOUT_S = 300


def _timed_trainer_steps(tr, batches) -> tuple[list, list]:
    """``Trainer.train_step`` over ``batches``, each to a synchronize:
    (seconds a step, metrics a step as floats)."""
    import torch
    secs, metrics = [], []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = tr.train_step(b)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append({k: float(v) for k, v in m.items()})
    return secs, metrics


def mesh_train_phase(dev, flash) -> dict:
    """[mesh train]: the mesh trainer (``Trainer(mesh=, param_rules=LM_RULES)``,
    parameters and moments DTensors, each step inside the activation scope)
    on a one-rank NCCL (1, 1) mesh; one H100 gives one rank (the 2 x 2 mesh
    is the CPU tests'). qwen3-14b at full width on MESH_TRAIN_LAYERS layers,
    f32 masters from SEED: MESH_TRAIN_STEPS steps of the unsharded Trainer,
    then of the mesh Trainer from the same initial tree on the same
    batches (the first run's leaves kept on the card, 8.9 GB, while the
    second runs; its peak is given without them); each step's loss and
    grad norm and every leaf after the
    last within MESH_TRAIN_REL relative (L2 a leaf). No checkpoint at this
    size. Run by ``mesh_train_process`` in a process of its own.
    Then the elastic restore at the reference test's width: 10 unsharded
    steps and a checkpoint under build/, restored on the mesh at step 10
    and trained to 14, against an unsharded continuation from the same
    checkpoint. flashattn launches 0 times."""
    import functools
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import qwen3_14b
    from repro_torch.data import LMDataConfig, lm_batch, lm_batches
    from repro_torch.dist import LM_RULES, make_mesh
    from repro_torch.models import TransformerConfig, init_transformer, loss_fn, transformer_tree
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.utils import tree_leaves
    card = card_line()
    own_group = not dist.is_initialized()
    mesh = make_mesh((1, 1), device_type=dev.type)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckroot = tempfile.mkdtemp(prefix="mesh_train_", dir=os.path.join(ROOT, "build"))
    cfg = dataclasses.replace(qwen3_14b.ARCH.model_cfg, n_layers=MESH_TRAIN_LAYERS)
    opt = qwen3_14b.ARCH.opt_cfg
    data = LMDataConfig(vocab=cfg.vocab, seq_len=TRAIN_LM_SEQ, batch=TRAIN_LM_BATCH, seed=SEED)
    batches = [lm_batch(data, s) for s in range(MESH_TRAIN_STEPS)]
    flash.launches = 0
    runs = {}
    try:
        for name, kw in (("unsharded", {}), ("mesh", dict(mesh=mesh, param_rules=LM_RULES))):
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            tree = transformer_tree(init_transformer(cfg, seed=SEED, device=dev,
                                                     f32_masters=True), cfg)
            tr = Trainer(functools.partial(loss_fn, cfg=cfg), tree, opt,
                         TrainerConfig(total_steps=MESH_TRAIN_STEPS,
                                       ckpt_dir=os.path.join(ckroot, name)), **kw)
            del tree
            secs, metrics = _timed_trainer_steps(tr, batches)
            leaves = [x.full_tensor() if isinstance(x, DTensor) else x
                      for x in tree_leaves(tr.params)]
            if name == "mesh" and not all(isinstance(x, DTensor) for x in tree_leaves(tr.params)):
                raise AssertionError("[mesh train]: a parameter of the mesh trainer is no DTensor")
            runs[name] = dict(secs=secs, metrics=metrics,
                              peak=torch.cuda.max_memory_allocated() / 1e9,
                              n=sum(x.numel() for x in leaves), leaves=leaves)
            del tr, leaves
        a, b = runs["unsharded"], runs["mesh"]
        # the first run's leaves stay on the card through the second run
        b["peak"] -= sum(x.numel() * x.element_size() for x in a["leaves"]) / 1e9
        for i, (ma, mb) in enumerate(zip(a["metrics"], b["metrics"])):
            for k in ("loss", "grad_norm"):
                if not np.isfinite(mb[k]) or abs(mb[k] - ma[k]) > MESH_TRAIN_REL * abs(ma[k]):
                    raise AssertionError(f"[mesh train] step {i + 1} {k}: mesh {mb[k]!r}, "
                                         f"unsharded {ma[k]!r}")
        worst = max(rel_l2(x, y) for x, y in zip(b["leaves"], a["leaves"]))
        if worst > MESH_TRAIN_REL:
            raise AssertionError(f"[mesh train] a leaf after step {MESH_TRAIN_STEPS} is "
                                 f"{worst:.3g} from the unsharded run (limit {MESH_TRAIN_REL})")
        del a["leaves"], b["leaves"]
        torch.cuda.empty_cache()
        ms = {k: float(np.median(v["secs"][1:]) * 1e3) for k, v in runs.items()}
        log(f"[mesh train] qwen3-14b at full width, depth cut from "
            f"{qwen3_14b.ARCH.model_cfg.n_layers} to {cfg.n_layers} ({b['n']:,} f32 masters "
            f"from seed {SEED}), {MESH_TRAIN_STEPS} steps of {TRAIN_LM_BATCH} x {TRAIN_LM_SEQ} "
            f"tokens: unsharded step 1 {a['secs'][0] * 1e3:.1f} ms then median "
            f"{ms['unsharded']:.1f} ms, peak {a['peak']:.2f} GB; mesh trainer on a one-rank "
            f"NCCL (1, 1) mesh step 1 {b['secs'][0] * 1e3:.1f} ms then median "
            f"{ms['mesh']:.1f} ms, peak {b['peak']:.2f} GB; DTensor overhead "
            f"{ms['mesh'] / ms['unsharded']:.3f}x; losses "
            f"{[round(m['loss'], 6) for m in b['metrics']]}, every loss and grad norm and "
            f"every leaf within {worst:.3g} of the unsharded run (limit {MESH_TRAIN_REL}); "
            f"card {card}")

        # the elastic restore, at the reference test's width
        ecfg = TransformerConfig(**ELASTIC_LM, dtype=torch.float32)
        eloss = functools.partial(loss_fn, cfg=ecfg)
        eopt = AdamWConfig(lr=1e-2, warmup_steps=2)
        edata = LMDataConfig(**ELASTIC_DATA)

        def etree(seed):
            return transformer_tree(init_transformer(ecfg, seed=seed, device=dev,
                                                     f32_masters=True), ecfg)
        d1 = os.path.join(ckroot, "elastic")
        Trainer(eloss, etree(0), eopt, TrainerConfig(total_steps=10, ckpt_every=5,
                                                      log_every=5, ckpt_dir=d1)).fit(
            lm_batches(edata))
        d2 = os.path.join(ckroot, "elastic_plain")
        shutil.copytree(d1, d2)
        out = {}
        for name, d, kw in (("mesh", d1, dict(mesh=mesh, param_rules=LM_RULES)),
                            ("unsharded", d2, {})):
            tr = Trainer(eloss, etree(1), eopt, TrainerConfig(total_steps=14, ckpt_every=50,
                                                              log_every=2, ckpt_dir=d), **kw)
            if not tr.maybe_restore() or tr.step != 10:
                raise AssertionError(f"[mesh train] elastic {name}: restored step {tr.step}")
            hist = tr.fit(lm_batches(edata, start_step=10))["history"]
            out[name] = (hist, [x.full_tensor() if isinstance(x, DTensor) else x
                                for x in tree_leaves(tr.params)])
        (hm, lm), (hu, lu) = out["mesh"], out["unsharded"]
        if [h["step"] for h in hm] != [12, 14] or any(
                abs(x["loss"] - y["loss"]) > MESH_TRAIN_REL * abs(y["loss"])
                for x, y in zip(hm, hu)):
            raise AssertionError(f"[mesh train] elastic: mesh {hm} against unsharded {hu}")
        eworst = max(rel_l2(x.cpu(), y.cpu()) for x, y in zip(lm, lu))
        if eworst > MESH_TRAIN_REL:
            raise AssertionError(f"[mesh train] elastic: a leaf at step 14 is {eworst:.3g} "
                                 f"from the unsharded continuation")
        if flash.launches != 0:
            raise AssertionError(f"[mesh train]: flashattn launched {flash.launches} times")
        log(f"[mesh train] elastic restore (2 layers, d_model 32, 4 heads, vocab 64, f32): 10 "
            f"unsharded steps and a checkpoint, restored on the (1, 1) mesh at step 10 and "
            f"trained to 14: losses {[round(h['loss'], 6) for h in hm]} against the unsharded "
            f"continuation's {[round(h['loss'], 6) for h in hu]}, every leaf within "
            f"{eworst:.3g}; flashattn launches 0")
        log(json.dumps({"[mesh train]": {
            "layers": cfg.n_layers, "params": b["n"],
            "tokens_a_step": TRAIN_LM_BATCH * TRAIN_LM_SEQ,
            "unsharded_ms": ms["unsharded"], "mesh_ms": ms["mesh"],
            "overhead": ms["mesh"] / ms["unsharded"], "unsharded_peak_gb": a["peak"],
            "mesh_peak_gb": b["peak"], "leaf_rel": worst, "elastic_leaf_rel": eworst,
            "flashattn_launches": 0, "card": card}}))
    finally:
        shutil.rmtree(ckroot, ignore_errors=True)
        if own_group:
            dist.destroy_process_group()
    return {"mesh_train_launches": 0}


def mesh_train_process() -> dict:
    """[mesh train] in a process of its own (this script with
    ``--mesh-train``), after the card's cache is emptied: the two trainers
    then meet the same fresh allocator and library state. (After the
    earlier phases, one bf16 step on the same inputs has given grad norms
    1.1e-5 apart from run to run; in a fresh process the two runs agree to
    the bit.) Its lines are printed here; it must exit 0."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.run([sys.executable, os.path.abspath(__file__), "--mesh-train"], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=MESH_TRAIN_TIMEOUT_S)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith(("[mesh train]", "{"))]
    for ln in lines:
        log(ln)
    if p.returncode != 0 or not any(ln.startswith('{"[mesh train]"') for ln in lines):
        raise AssertionError(f"[mesh train] exited {p.returncode}:\n"
                             f"{(p.stdout + p.stderr)[-4000:]}")
    return {"mesh_train_launches": json.loads(lines[-1])["[mesh train]"]["flashattn_launches"]}


def main() -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=1_000_000, help="corpus size")
    ap.add_argument("--profile", action="store_true",
                    help="also trace each mode's main-path run, the two-tower "
                         "brute-force batch, one gemma3 decode step and a MoE "
                         "and an MLA prefill and decode step with "
                         "torch.profiler and print the device-time breakdown")
    ap.add_argument("--result-cap", type=int, default=1024,
                    help="result buffer per query (the deployment's 1024); "
                         "another value is the AP-gap probe, and also runs "
                         "the two-tower graph half's AP probes")
    ap.add_argument("--sharded-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-world", type=int, default=SHARD_RANKS, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-train", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if args.sharded_rank is not None:   # a rank of the [sharded] phase's second run
        return sharded_rank(args.sharded_rank, args.sharded_world, args.sharded_dir,
                            args.sharded_device)
    if args.mesh_train:                 # the [mesh train] phase's own process
        from repro_torch.kernels.flashattn import flash_attention_cuda
        mesh_train_phase(torch.device("cuda"), flash_attention_cuda)
        return 0
    from repro_torch.configs.range_engine import EngineDeployConfig
    from repro_torch.core import (
        RangeSearchEngine, build_knn_graph, match_histogram, quantize_corpus)
    from repro_torch.data import make_corpus
    from repro_torch.kernels import _build
    from repro_torch.kernels.expand import expand_cuda, expand_int8_cuda
    from repro_torch.kernels.flashattn import flash_attention_cuda
    from repro_torch.kernels.gatherdist import gatherdist_cuda, gatherdist_int8_cuda
    from repro_torch.kernels.rangescan import rangescan_cuda
    from repro_torch.kernels.rerank_fetch import rerank_fetch_cuda
    fetch_ops = sys.modules["repro_torch.kernels.rerank_fetch.ops"]

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. kernels ----------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"[build] {len(logs)} kernels built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc sm_90a, one process per source)")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    # -- 9. two-tower retrieval serving (first: its tables need the card) ----
    t0 = time.perf_counter()
    with torch.inference_mode():
        tt_entry = two_tower_phase(dev, {
            "rangescan": rangescan_cuda, "expand": expand_cuda,
            "gatherdist": gatherdist_cuda},
            ap_probes=args.result_cap != ap.get_default("result_cap"), profile=args.profile)
    log(f"[two_tower] peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[two_tower] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- 10. LM serving (second: its 54 GB of weights need the card too) -----
    t0 = time.perf_counter()
    with torch.inference_mode():
        lm_entry = lm_phase(dev, {"flashattn": flash_attention_cuda}, args.profile)
    log(f"[lm] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()

    # -- 10b, 10c. the MoE and MLA members of the LM family ------------------
    t0 = time.perf_counter()
    with torch.inference_mode():
        lm_entry.update(lm_moe_phase(dev, {"flashattn": flash_attention_cuda}, args.profile))
    log(f"[lm moe] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.inference_mode():
        lm_mla_phase(dev, {"flashattn": flash_attention_cuda}, args.profile)
    log(f"[lm mla] phase took {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- 2. data and graph ---------------------------------------------------
    t_main = time.perf_counter()
    t0 = time.perf_counter()
    ds = make_corpus("bigann-like", n=args.n, n_queries=N_QUERIES, seed=SEED)
    points = torch.as_tensor(ds.points, device=dev)
    queries = torch.as_tensor(ds.queries, device=dev)
    log(f"[data] bigann-like n={args.n} d={points.shape[1]} "
        f"queries={N_QUERIES} seed={SEED} "
        f"({time.perf_counter() - t0:.2f} s)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph = build_knn_graph(points, k=32, metric="l2", device=dev)
    torch.cuda.synchronize()
    log(f"[graph] exact k-NN graph R=32 built on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    qc = quantize_corpus(points)
    torch.cuda.synchronize()
    log(f"[int8] corpus quantized on the card in {time.perf_counter() - t0:.3f} s "
        f"(codes {tuple(qc.codes.shape)} int8, meta {tuple(qc.meta.shape)} f32)")

    # -- 3. kernels against their plain versions -----------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    entries = kernel_checks(points, graph.neighbors, queries, gen)
    entries.update(int8_kernel_checks(qc, graph.neighbors, queries, gen))
    del qc

    # -- 4. radius -----------------------------------------------------------
    _, r, _, _, ap_of = radius_and_oracle(ds, points, queries)

    # -- 5. the f32 main path ------------------------------------------------
    engine = RangeSearchEngine.from_graph(points, graph, metric="l2",
                                          n_starts=4, device=dev)
    deploy = EngineDeployConfig().overrides(result_cap=args.result_cap)
    cfgs = {"greedy": deploy.range_cfg,
            "beam": deploy.overrides(mode="beam").range_cfg,
            "doubling": deploy.overrides(mode="doubling", max_beam=256).range_cfg}
    f32_kernels = {"expand": expand_cuda, "gatherdist": gatherdist_cuda}
    launches, aps, qps = {}, {}, {}
    captures = {}   # the expand launches of the greedy batches, for the replay
    for mode, cfg in cfgs.items():
        cap = ExpandCapture() if mode == "greedy" else None
        if cap:
            captures["f32"] = cap
        res, dt, counts, routes = run_mode(engine, queries, r, cfg, f32_kernels,
                                           args.profile, mode, cap)
        if min(counts.values()) == 0:
            raise AssertionError(f"{mode}: a kernel was never launched {counts}")
        check_routes(routes, counts, mode)
        launches[mode] = counts
        check_result(res, points, queries, r, cfg.result_cap, mode)
        aps[mode] = ap_of(res)
        qps[mode] = N_QUERIES / dt
        log(f"[main] {mode}: QPS={N_QUERIES / dt:.1f} ({dt * 1e3:.1f} ms for "
            f"{N_QUERIES} queries), AP={aps[mode]:.4f}, "
            f"mean n_visited={float(res.n_visited.float().mean()):.1f}, "
            f"phase-2 share={float(res.phase2.float().mean()):.4f}, "
            f"overflowed lanes={int(res.overflow.sum())}, "
            f"launches={counts}, expand routes {routes['expand']}, "
            f"results {match_histogram(res.count.cpu().numpy())}")

    # -- 6. the int8 main path -----------------------------------------------
    t0 = time.perf_counter()
    engine_q = RangeSearchEngine.from_graph(points, graph, metric="l2",
                                            n_starts=4, corpus_dtype="int8",
                                            device=dev)
    torch.cuda.synchronize()
    stats = engine_q.stats()
    log(f"[int8] from_graph(corpus_dtype='int8') in {time.perf_counter() - t0:.2f} s: "
        f"corpus_dtype={stats['corpus_dtype']}, hot_bytes_per_vector="
        f"{stats['hot_bytes_per_vector']} (f32: {engine.stats()['hot_bytes_per_vector']})")
    int8_kernels = {"expand_int8": expand_int8_cuda,
                    "gatherdist_int8": gatherdist_int8_cuda,
                    "rerank_fetch": rerank_fetch_cuda}
    deploy_q = deploy.overrides(corpus_dtype="int8")
    q_cfgs = {"greedy f32-query": deploy_q.range_cfg,
              "beam f32-query": deploy_q.overrides(mode="beam").range_cfg,
              "doubling f32-query": deploy_q.overrides(mode="doubling", max_beam=256).range_cfg,
              "greedy int8-query": deploy_q.overrides(use_expand_kernel=True).range_cfg}
    q_launches, q_aps = {}, {}
    for name, cfg in q_cfgs.items():
        cap = ExpandCapture() if name.startswith("greedy") else None
        if cap:
            captures[name] = cap
        res, dt, counts, routes = run_mode(engine_q, queries, r, cfg, int8_kernels,
                                           args.profile, f"int8 {name}", cap)
        band = int(res.n_rerank.sum())
        check_routes(routes, counts, f"int8 {name}",
                     {"rerank_fetch": fetch_ops.plan(band, points.shape[1])})
        # expand-int8 runs every iteration and gatherdist-int8 seeds every
        # lane; rerank_fetch launches once for a batch with a band, and a
        # batch whose every kept candidate is a sure member launches nothing
        if (min(counts["expand_int8"], counts["gatherdist_int8"]) == 0
                or counts["rerank_fetch"] != int(band > 0)
                or (name.startswith("greedy") and band == 0)):
            raise AssertionError(f"int8 {name}: launches {counts} with a band "
                                 f"of {band} pairs")
        q_launches[name] = counts
        check_result_int8(res, points, queries, r, cfg.result_cap, f"int8 {name}")
        ap = q_aps[name] = ap_of(res)
        qps[f"int8 {name}"] = N_QUERIES / dt
        f32_ap = aps[name.split()[0]]
        log(f"[main] int8 {name}: QPS={N_QUERIES / dt:.1f} ({dt * 1e3:.1f} ms for "
            f"{N_QUERIES} queries), AP={ap:.4f} (f32 {f32_ap:.4f}, gap "
            f"{f32_ap - ap:+.4f}), mean n_rerank="
            f"{float(res.n_rerank.float().mean()):.2f}, band P={band}, "
            f"mean n_visited={float(res.n_visited.float().mean()):.1f}, "
            f"phase-2 share={float(res.phase2.float().mean()):.4f}, "
            f"overflowed lanes={int(res.overflow.sum())}, "
            f"launches={counts}, routes {routes}, no false "
            f"positive, results {match_histogram(res.count.cpu().numpy())}")
    entries["rerank_fetch"] = rerank_at_band(
        engine_q, queries, r, q_cfgs["greedy f32-query"],
        q_launches["greedy f32-query"]["rerank_fetch"])

    # the expand launches the greedy batches made, replayed on each route
    dim = points.shape[1]
    entries["expand"].update(served_replay(captures.pop("f32").kept, "greedy f32",
                                           4 * dim))
    entries["expand_int8"].update(served_replay(
        captures.pop("greedy f32-query").kept, "greedy int8 f32-query", dim + 12))
    entries["expand_int8"].update({f"int8_query_{k}": v for k, v in served_replay(
        captures.pop("greedy int8-query").kept, "greedy int8 int8-query",
        dim + 12).items()})
    torch.cuda.empty_cache()

    # -- 7. the guard-band contract ------------------------------------------
    sub = queries[:256]
    for name, cfg in q_cfgs.items():
        n_ok, n_tie = check_guard_band(engine_q, points, sub, r, cfg,
                                       f"int8 {name}")
        log(f"[guard] int8 {name} on 256 queries: post-rerank set == "
            f"rerank-disabled set filtered by the exact distances on {n_ok} "
            f"lanes (the rest overflowed result_cap); {n_tie} pairs within "
            f"1e-6 of r")
    check_sync_count(engine, queries, r, cfgs["greedy"], "greedy f32")
    check_sync_count(engine_q, queries, r, q_cfgs["greedy f32-query"],
                     "greedy int8 f32-query")

    # -- 8. kernel path against the plain path through the engines -----------
    runs = [(mode, engine, cfg) for mode, cfg in cfgs.items()]
    runs += [(f"int8 {name}", engine_q, cfg) for name, cfg in q_cfgs.items()]
    for name, eng, cfg in runs:
        plain_cfg = dataclasses.replace(cfg, search=dataclasses.replace(
            cfg.search, use_kernels=False))
        res_k = eng.range(sub, r, cfg=cfg)
        res_p = eng.range(sub, r, cfg=plain_cfg)
        ap_k, ap_p = ap_of(res_k, 256), ap_of(res_p, 256)
        same = float((res_k.ids == res_p.ids).all(1).float().mean())
        log(f"[plain] {name} on 256 queries: AP kernel={ap_k:.4f} "
            f"plain={ap_p:.4f}, lanes with identical ids={same:.4f}")
        if abs(ap_k - ap_p) > 0.01:
            raise AssertionError(f"{name}: kernel and plain AP differ by "
                                 f"{abs(ap_k - ap_p):.4f}")

    # -- 11. the tiered corpus on the k-NN graph against the resident one ----
    tier_launches = tier_phase(engine_q, points, graph, queries, r,
                               q_cfgs["greedy f32-query"], rerank_fetch_cuda)
    knn = {"greedy f32": (aps["greedy"], qps["greedy"]),
           "greedy int8 f32-query": (q_aps["greedy f32-query"],
                                     qps["int8 greedy f32-query"])}
    del engine, engine_q
    torch.cuda.empty_cache()
    log(f"[main] the engine phases (2-8, 11) took {time.perf_counter() - t_main:.1f} s")

    # -- 12. the Vamana graph built on the card, and searched ----------------
    # The Vamana path (12-15) runs on its own draw of the corpus at VAMANA_N
    # points (the same distribution and seed; its own queries, radius and
    # oracle): the build at 1M took 180 s of the script's limit
    t_v = time.perf_counter()
    ds_v = make_corpus("bigann-like", n=min(VAMANA_N, args.n), n_queries=N_QUERIES, seed=SEED)
    points_v = torch.as_tensor(ds_v.points, device=dev)
    queries_v = torch.as_tensor(ds_v.queries, device=dev)
    log(f"[data vamana] bigann-like n={points_v.shape[0]} d={points_v.shape[1]} "
        f"queries={N_QUERIES} seed={SEED} ({time.perf_counter() - t_v:.2f} s)")
    prof_v, r_v, gt_v_ids, gt_v_counts, ap_of_v = radius_and_oracle(ds_v, points_v, queries_v,
                                                                    " vamana")
    del ds_v
    kernels = {**f32_kernels, **int8_kernels}
    engine_v, build_launches, vamana_aps = vamana_phase(
        points_v, queries_v, r_v, cfgs["greedy"], q_cfgs["greedy f32-query"], ap_of_v, knn,
        kernels, args.profile)

    # -- 13. filtered range search on the Vamana graph -------------------------
    fallback_launches = filtered_phase(engine_v, points_v, queries_v, prof_v, deploy,
                                       rerank_fetch_cuda)

    # -- 14. the serving layer on the Vamana engine ----------------------------
    t0 = time.perf_counter()
    serve_launches = serve_phase(engine_v, points_v, queries_v, r_v, prof_v, cfgs["greedy"],
                                 q_cfgs["greedy f32-query"], kernels, (gt_v_ids, gt_v_counts))
    log(f"[serve] phase took {time.perf_counter() - t0:.1f} s")

    # -- 15. the live index on the Vamana graph ------------------------------
    t0 = time.perf_counter()
    live_launches = live_phase(engine_v.graph, points_v, queries_v, r_v, cfgs["greedy"],
                               q_cfgs["greedy f32-query"], kernels, vamana_aps)
    log(f"[live] phase took {time.perf_counter() - t0:.1f} s")
    del engine_v, points_v, queries_v
    torch.cuda.empty_cache()
    log(f"[vamana] the Vamana path (12-15) took {time.perf_counter() - t_v:.1f} s")

    # -- 16. the sharded engine: the collective, the fan-out, served ----------
    sharded_launches, corpora, shard_graphs = sharded_phase(
        points, queries, r, cfgs["greedy"], q_cfgs["greedy f32-query"], kernels, ap_of,
        {"float32": knn["greedy f32"], "int8": knn["greedy int8 f32-query"]})

    # -- 17. replication over the sharded corpora ---------------------------------
    replicated_launches = replicated_phase(corpora, queries, r, cfgs["greedy"],
                                           q_cfgs["greedy f32-query"], kernels)
    del corpora
    torch.cuda.empty_cache()

    # -- 18. the sharded live index, replica groups and their rebuild -------------
    live_sharded_launches = live_sharded_phase(points, queries, r, cfgs["greedy"],
                                               shard_graphs, graph, kernels)
    del shard_graphs
    torch.cuda.empty_cache()

    # -- 19. the serving CLI, three runs ------------------------------------------
    t0 = time.perf_counter()
    cli_phase()
    log(f"[cli] phase took {time.perf_counter() - t0:.1f} s")

    # -- 19b. the cell builder: every cell on meta, the engine's on the card ------
    t0 = time.perf_counter()
    ds_64k = make_corpus("bigann-like", n=args.n, n_queries=N_QUERIES_64K, seed=SEED)
    if not np.array_equal(ds_64k.points, ds.points):
        raise AssertionError("[cells] the search_64k draw holds another corpus")
    queries_64k = torch.as_tensor(ds_64k.queries, device=dev)
    del ds_64k
    log(f"[cells] {N_QUERIES_64K} more queries of the corpus (seed {SEED}) in "
        f"{time.perf_counter() - t0:.2f} s")
    with torch.inference_mode():
        cells_launches = cells_phase(points, graph, queries, queries_64k, r, kernels)
    del points, queries, queries_64k, graph
    torch.cuda.empty_cache()

    # -- 20-23. training: the LM, the recsys family, the GCN, the CLI ------------
    t_train = time.perf_counter()
    t0 = time.perf_counter()
    lm_entry.update(train_lm_phase(dev, flash_attention_cuda))
    log(f"[train lm] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_recsys_phase(dev)
    log(f"[train recsys] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_gcn_phase(dev)
    log(f"[train gcn] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_cli_phase()
    log(f"[train cli] phase took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lm_entry.update(mesh_train_process())
    log(f"[mesh train] phase took {time.perf_counter() - t0:.1f} s")
    log(f"[train] the five training phases took {time.perf_counter() - t_train:.1f} s")

    for name in ("expand", "gatherdist"):
        entries[name]["launches"] = launches["greedy"][name]
        entries[name]["build_launches"] = build_launches[name]
    for name, n in serve_launches.items():
        entries[name]["serve_launches"] = n
    for name, n in live_launches.items():
        entries[name]["live_launches"] = n
    for name, n in sharded_launches.items():
        entries[name]["sharded_launches"] = n
    for name, n in replicated_launches.items():
        entries[name]["replicated_launches"] = n
    for name, n in live_sharded_launches.items():
        entries[name]["live_sharded_launches"] = n
    for name, n in cells_launches.items():
        entries[name]["cells_launches"] = n
    entries["rerank_fetch"]["fallback_launches"] = fallback_launches
    entries["rerank_fetch"]["tier_launches"] = tier_launches
    for name in ("expand_int8", "gatherdist_int8"):
        entries[name]["launches"] = q_launches["greedy f32-query"][name]
    entries["rangescan"] = tt_entry
    entries["flashattn"] = lm_entry
    log(f"[main] peak device memory of the engine phases "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log(f"[total] the script took {time.perf_counter() - t_script:.1f} s")
    log(card_line())
    extra = ("form", "int8_query_ms", "expand_route", "warp_ms", "served_ms",
             "served_warp_ms", "served_launches", "served_bound_ms",
             "int8_query_warp_ms", "int8_query_served_ms", "int8_query_served_warp_ms",
             "int8_query_served_launches", "int8_query_served_bound_ms", "scan_route", "simt_ms", "f32_bound_ms", "q1_ms",
             "q1_plain_ms", "q1_bound_ms", "q1_bound_by", "q1_library_ms", "q1_scan_route",
             "q1_simt_ms", "q1_f32_bound_ms", "routes", "prefill_route", "local_ms",
             "local_bound_ms", "local_library_ms", "decode_source", "decode_route",
             "decode_ms", "decode_plain_ms", "decode_bound_ms",
             "decode_bound_by", "decode_library_ms", "decode_local_ms",
             "decode_local_bound_ms", "decode_local_library_ms", "gather_route",
             "old_route_ms", "floor_ms", "main_shape_ms", "main_shape_old_route_ms",
             "main_shape_bound_ms", "int8_query_gather_route", "int8_query_old_route_ms",
             "int8_query_main_shape_ms", "int8_query_main_shape_old_route_ms",
             "int8_query_main_shape_bound_ms", "fetch_route", "cold_ms",
             "old_route_cold_ms", "build_launches", "fallback_launches", "tier_launches",
             "serve_launches", "live_launches", "sharded_launches", "replicated_launches",
             "live_sharded_launches", "lm_moe_launches", "moe_ms", "moe_plain_ms",
             "moe_bound_ms", "moe_bound_by", "moe_library_ms", "moe_decode_ms",
             "moe_decode_plain_ms", "moe_decode_bound_ms", "moe_decode_bound_by",
             "moe_decode_library_ms", "train_launches", "train_prefill_launches",
             "cells_launches", "mesh_train_launches")
    log(json.dumps({"kernels": [
        {k: entries[n][k] for k in ENTRY_KEYS + extra if k in entries[n]}
        for n in ("expand", "gatherdist", "expand_int8", "gatherdist_int8",
                  "rerank_fetch", "rangescan", "flashattn")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

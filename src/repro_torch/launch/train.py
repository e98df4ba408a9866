"""Training launcher: end-to-end training runs through the fault-tolerant
``Trainer``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-27b --smoke \\
      --steps 200 --ckpt-dir build/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora --smoke \\
      --steps 20 --device cpu

``--smoke`` uses the arch's ``reduced()`` config (a CPU-trainable geometry
of the same family); without it the full published config is used. The
loop is the fault-tolerant Trainer: atomic checkpoints, resume from the
latest (``--resume``), SIGTERM-safe. The flags and the ``[train]`` lines
are the reference's; ``--device`` is the port's (the card unless ``cpu``
is asked for). Weights are drawn from seed 0 by the port's own
generator (f32 masters, as the reference keeps them).
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import sys

import torch

from ..configs import get_arch
from ..data.graphs import make_sbm_graph
from ..data.lm import LMDataConfig, lm_batches
from ..data.recsys import RecsysDataConfig, recsys_batches
from ..models import gcn as gcn_mod
from ..models import recsys as rec_mod
from ..models import transformer as tf_mod
from ..train import Trainer, TrainerConfig
from ..utils import resolve_device


def init_params(family: str, cfg, seed: int, device) -> dict:
    """The parameter tree a run starts from: the reference's tree, drawn
    from ``seed``."""
    if family == "lm":
        model = tf_mod.init_transformer(cfg, seed=seed, device=device, f32_masters=True)
        return tf_mod.transformer_tree(model, cfg)
    if family == "gnn":
        return gcn_mod.init_gcn(cfg, seed=seed, device=device)
    return rec_mod.recsys_tree(rec_mod.init_recsys(cfg, seed=seed, device=device))


def build_training(arch_id: str, smoke: bool, batch: int, seq_len: int,
                   seed: int = 0, device="cuda"):
    """(params, loss, batches) of an arch: the reference's data for its
    family (the LM stream, a 400-node SBM graph, recsys batches)."""
    arch = get_arch(arch_id)
    cfg = arch.reduced() if smoke else arch.model_cfg
    dev = resolve_device(device)
    params = init_params(arch.family, cfg, seed, dev)
    if arch.family == "lm":
        loss = functools.partial(tf_mod.loss_fn, cfg=cfg)
        data = lm_batches(LMDataConfig(vocab=cfg.vocab, seq_len=seq_len,
                                       batch=batch, seed=seed))
        return params, loss, data
    if arch.family == "gnn":
        g = make_sbm_graph(400, cfg.n_classes, cfg.d_feat, avg_degree=8, seed=seed)
        loss = functools.partial(gcn_mod.gcn_loss, cfg=cfg)

        def batches():
            b = {"feats": torch.as_tensor(g.feats, device=dev),
                 "edge_src": torch.as_tensor(g.edge_src, device=dev),
                 "edge_dst": torch.as_tensor(g.edge_dst, device=dev),
                 "labels": torch.as_tensor(g.labels, device=dev)}
            while True:
                yield b
        return params, loss, batches()
    if arch.family == "recsys":
        loss = functools.partial(rec_mod.recsys_loss, cfg=cfg)
        dcfg = RecsysDataConfig(
            n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, vocab=cfg.vocab,
            batch=batch, seed=seed, two_tower=cfg.kind == "two_tower",
            n_sparse_item=cfg.n_sparse_item)
        return params, loss, recsys_batches(dcfg)
    raise ValueError(f"{arch_id}: family {arch.family} has no training path")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--arch", required=True)
    p.add_argument("--smoke", action="store_true")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=128)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--ckpt-dir", default="build/repro_train")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--metrics", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the run computes: the card (default) or cpu")
    args = p.parse_args(argv)

    arch = get_arch(args.arch)
    params, loss, data = build_training(args.arch, args.smoke, args.batch,
                                        args.seq_len, device=args.device)
    opt_cfg = arch.opt_cfg
    if args.lr is not None:
        opt_cfg = dataclasses.replace(opt_cfg, lr=args.lr)
    opt_cfg = dataclasses.replace(opt_cfg, total_steps=args.steps)
    tr = Trainer(loss, params, opt_cfg,
                 TrainerConfig(total_steps=args.steps,
                               ckpt_every=args.ckpt_every, log_every=10,
                               ckpt_dir=args.ckpt_dir,
                               metrics_path=args.metrics))
    if args.resume and tr.maybe_restore():
        print(f"[train] resumed from step {tr.step}")
    out = tr.fit(data, verbose=True)
    print(f"[train] done at step {out['final_step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""End-to-end training driver. Counterpart of ``repro/launch/train.py``.

The LM path feeds on the WebParF crawl, the paper's system as the data
substrate:

  crawl N steps -> fetched pages -> token stream -> train

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50                                    # on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch dcn-v2 --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch gat-cora --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu

Without ``--full`` the arch's ``reduced()`` config runs, in f32; ``--full``
is the published config (bf16, remat on). Every LM arch trains, dense or
MoE (the MoE aux loss is part of the loss); ``--full`` of an MoE arch is
not refused, but its weights and AdamW state (16.4 B parameters for
deepseek-moe-16b, ~300 GB) exceed one card's memory. Weights are drawn from
``--seed``. The GAT trains on a seeded graph of 256 nodes, a RecSys arch on
``recsys.make_batch``'s batch of ``--batch`` examples, each with AdamW at
``--lr``, as the reference's ``train_other``. It runs on cuda unless
``--device cpu`` is given, and raises when no card is present.

Under ``torch.distributed.run`` (one process a card; ``--device cpu``
runs gloo) the processes form one group, the crawl's and the mesh's:

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --model-parallel 2 ...

Every rank crawls as the crawl group (a shard a rank) and gathers the
fetched pages, so the token stream is the same on every rank; the model
then trains on the (W / k, k) ``DeviceMesh`` of ``make_host_mesh(k)``,
its parameters and optimizer state placed by the reference's rules
(``trainer.place_params``: FSDP over "data", TP and EP over "model") and
each batch split over "data". Only rank 0 prints; checkpoints are written
by rank 0 from every rank's blocks. A ``--model-parallel`` that does not
divide W raises, and without a group anything but 1 raises, as the
reference's ``make_host_mesh`` asserts on a one-device host.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_arch, get_reduced
from repro_torch.configs.base import scaled
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_host_mesh


def crawl_corpus(crawl_cfg, steps: int, device=None):
    """Run the WebParF crawler and return (the fetched URLs, the final
    crawl state): the crawled collection feeding training. Under a group
    of W processes the crawl runs W shards, one a rank; its report holds
    every shard's fetched URLs, so every rank gets the same collection as
    a one-process session of W shards (the state is the rank's own
    shard's)."""
    from repro_torch.api import CrawlSession
    from repro_torch.dist import CrawlGroup
    sess = CrawlSession(crawl_cfg, device, n_shards=CrawlGroup.current().world)
    return sess.run(steps).urls, sess.state


def _mesh(args):
    """(the train mesh, or None on one process, and a print that only
    rank 0 speaks through)."""
    from repro_torch.dist import CrawlGroup
    mesh = make_host_mesh(model=args.model_parallel)
    rank = CrawlGroup.current().rank

    def say(*a, **k):
        if rank == 0:
            print(*a, **k)
    return (None if isinstance(mesh, dict) else mesh), say


def train_lm(args, cfg=None):
    """Crawl, tokenize the crawl and train an LM on it; returns the final
    ``TrainState``. ``cfg`` replaces the arch's config (as
    ``examples/torch_crawl_and_train.py`` sizes its model)."""
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import trainer as TR
    from repro_torch.train.trainer import init_train_state, make_train_step

    dev = resolve_device(args.device)
    mesh, say = _mesh(args)
    if cfg is None:
        cfg = get_arch(args.arch)[0] if args.full else get_reduced(args.arch)
        if not args.full:
            cfg = scaled(cfg, dtype="float32")  # bf16 ulp too coarse at toy lr

    crawl_cfg = get_reduced("webparf")
    urls, _ = crawl_corpus(crawl_cfg, args.crawl_steps, dev)
    say(f"crawled {len(urls)} pages -> token stream")

    params = T.stack_params(T.init_lm(cfg, seed=args.seed, device=dev))
    n_params = sum(p.numel() for p in params.values())
    say(f"{args.arch}: {n_params / 1e6:.2f}M params "
        f"(reduced={not args.full}) on {dev}"
        + ("" if mesh is None else f", mesh {tuple(mesh.shape)}"))
    if mesh is not None:
        params = TR.place_params(params, mesh, "lm")

    opt = adamw(lr=warmup_cosine(args.lr, 10, args.steps))
    step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]), opt,
                           microbatches=args.microbatches)
    state = init_train_state(params, opt)

    batches = list(lm_batches(urls, crawl_cfg, batch=args.batch,
                              seq_len=args.seq_len, vocab=cfg.vocab_size,
                              device=dev))
    if mesh is not None:
        batches = [TR.place_batch(b, mesh) for b in batches]
    if not batches:
        raise SystemExit("not enough crawled data; raise --crawl-steps")
    t0 = time.time()
    i = 0
    while i < args.steps:
        for b in batches:
            if i >= args.steps:
                break
            state, m = step(state, b)
            i += 1
            if i % args.log_every == 0:
                dt = time.time() - t0
                say(f"step {i:5d}  loss {float(m['loss']):.4f}  "
                    f"gnorm {float(m['grad_norm']):.3f}  "
                    f"{i * args.batch * args.seq_len / dt:.0f} tok/s")
            if args.ckpt_dir and i % args.ckpt_every == 0:
                ckpt.save(args.ckpt_dir, i, state)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, i, state)
    say(f"final loss {float(m['loss']):.4f}")
    return state


def train_other(args):
    """The GAT or a RecSys model, trained on a seeded batch; returns the
    final ``TrainState``."""
    import numpy as np
    import torch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as TR
    from repro_torch.train.trainer import init_train_state, make_train_step

    dev = resolve_device(args.device)
    mesh, say = _mesh(args)
    cfg = get_arch(args.arch)[0] if args.full else get_reduced(args.arch)
    if cfg.family == "gnn":
        rng = np.random.default_rng(args.seed)
        N, E, F, C = 256, 1024, 32, 7
        batch = G.Graph(
            features=torch.tensor(rng.normal(size=(N, F)),
                                  dtype=torch.float32, device=dev),
            src=torch.tensor(rng.integers(0, N, E), dtype=torch.int32,
                             device=dev),
            dst=torch.tensor(rng.integers(0, N, E), dtype=torch.int32,
                             device=dev),
            edge_mask=torch.ones(E, dtype=torch.bool, device=dev),
            labels=torch.tensor(rng.integers(0, C, N), dtype=torch.int32,
                                device=dev),
            label_mask=torch.tensor(rng.random(N) < 0.3, device=dev))
        params = G.init_gat(args.seed, cfg, F, C, device=dev)
        loss_fn = lambda p, b: G.gat_loss(p, cfg, b)
    else:
        params = R.INIT[cfg.kind](args.seed, cfg, device=dev)
        batch = R.make_batch(cfg, ShapeSpec("t", "train",
                                            dict(batch=args.batch)),
                             device=dev)
        loss_fn = lambda p, b: R.TRAIN_LOSS[cfg.kind](p, cfg, b)
    n_params = sum(p.numel() for p in params.values())
    say(f"{args.arch}: {n_params / 1e6:.2f}M params "
        f"(reduced={not args.full}) on {dev}")
    if mesh is not None:
        # the graph stays whole on every process (its gathers read any
        # node); a RecSys batch splits over the data axes
        params = TR.place_params(params, mesh, cfg.family)
        if cfg.family == "recsys":
            batch = TR.place_batch(batch, mesh, rows=args.batch)

    opt = adamw(lr=args.lr)
    step = make_train_step(loss_fn, opt)
    state = init_train_state(params, opt)
    for i in range(1, args.steps + 1):
        state, m = step(state, batch)
        if i % args.log_every == 0:
            say(f"step {i:5d}  loss {float(m['loss']):.4f}")
    say(f"final loss {float(m['loss']):.4f}")
    return state


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--crawl-steps", type=int, default=60)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    import os
    from repro_torch.dist import CrawlGroup
    args = build_parser().parse_args(argv)
    cfg, _ = get_arch(args.arch)
    started = ("WORLD_SIZE" in os.environ and CrawlGroup.current().world == 1
               and int(os.environ["WORLD_SIZE"]) > 1)
    if started:
        # started by torch.distributed.run: one rank a card
        from repro_torch.launch.mesh import init_crawl_group
        init_crawl_group(None if args.device == "cuda" else args.device)
    try:
        if cfg.family == "lm":
            train_lm(args)
        else:
            train_other(args)
    finally:
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Quickstart of the PyTorch port: the WebParF system end to end.

1. Build the partitioned Global URL Frontier (Phase I): ``CrawlSession``,
   the one driver API (repro_torch.api).
2. Run the parallel crawl (Phase II): select, fetch, parse, classify,
   dedup, batched dispatch.
3. Train a small LM on the crawled corpus (the collection the paper's
   crawler exists to produce).

    PYTHONPATH=src python examples/torch_quickstart.py              # card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402

from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.data.pipeline import lm_batches  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import (init_train_state,  # noqa: E402
                                       make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # --- crawl ------------------------------------------------------------
    cfg = get_reduced("webparf")
    sess = CrawlSession(cfg, args.device)
    print(f"Phase I: {cfg.n_domains} domain pools seeded, "
          f"{int(sess.state.f_valid.sum())} hub URLs in the Global Frontier "
          f"on {sess.device}")

    report = sess.run(40)
    urls, stats = report.urls, report.stats
    print(f"Phase II: crawled {len(urls)} pages "
          f"({len(np.unique(urls))} unique — C1), "
          f"{stats['dispatch_rounds']} batched exchanges (C5), "
          f"{stats['dedup_bloom']} bloom dedups — {report.summary()}")
    q = report.ordering_quality
    print(f"  ordering[{cfg.ordering}]: importance mass "
          f"{q['importance_mass']:.1f} over {q['unique_pages']} unique pages "
          f"(coverage AUC {q['coverage_auc']:.3f}) — try ordering='opic' "
          f"(repro_torch.ordering registry)")

    # --- coordination modes (the crawl CLI) ---------------------------------
    # the same system under a bounded communication budget: the batched mode
    # ships at most --comm-quota URLs per dispatch and parks the rest in the
    # persistent outbox (the ledger line prints URLs shipped per page)
    from repro_torch.launch.crawl import main as crawl_main
    print("\n-- launch.crawl --coordination batched --comm-quota 64 --")
    crawl_main(["--steps", "8", "--domains", "8", "--capacity", "128",
                "--fetch-batch", "8", "--coordination", "batched",
                "--comm-quota", "64", "--device", args.device])
    print()

    # --- train on the crawl -------------------------------------------------
    lm_cfg = scaled(get_reduced("qwen2-1.5b"), dtype="float32")
    batches = list(lm_batches(urls, cfg, batch=4, seq_len=32,
                              vocab=lm_cfg.vocab_size, device=sess.device))
    params = T.stack_params(T.init_lm(lm_cfg, seed=0, device=sess.device))
    opt = adamw(lr=3e-3)
    step = make_train_step(lambda p, b: T.lm_loss(p, lm_cfg, b[0], b[1]),
                           opt)
    st = init_train_state(params, opt)
    first = last = None
    for i in range(20):
        st, metrics = step(st, batches[i % len(batches)])
        if first is None:
            first = float(metrics["loss"])
        last = float(metrics["loss"])
        if i % 5 == 0:
            print(f"  train step {i:3d}  loss {last:.4f}")
    print(f"loss {first:.3f} -> {last:.3f} on the crawled corpus")
    return {"pages": len(urls), "first_loss": first, "last_loss": last,
            "steps": int(st.step)}


if __name__ == "__main__":
    main()

"""The full cascade of the paper's Figure 1, CRAWL -> INDEX -> SEARCH,
running live as one pipeline on the port (``repro_torch.serve.ServeSession``):
the index is updated between dispatch intervals and a Zipfian query load is
answered from it while the crawl runs.

    PYTHONPATH=src python examples/torch_search_engine.py            # card
    PYTHONPATH=src python examples/torch_search_engine.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core import webgraph as W  # noqa: E402
from repro_torch.serve import QueryLoad, ServeSession  # noqa: E402

VOCAB, DOC_LEN = 4096, 64


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced("webparf")
    load = QueryLoad(cfg, qps=4.0, seed=7)
    sess = ServeSession(cfg, args.device, load=load, index_capacity=4096,
                        doc_len=DOC_LEN, vocab=VOCAB, top_k=5)

    # one live segment per dispatch-interval pair: queries are served
    # mid-crawl, pages stream into the index between intervals
    for seg in range(48 // 8):
        rep = sess.run(8)
        print(f"segment {seg}: {rep.crawl.fetched} pages crawled, "
              f"{rep.n_queries} queries served live "
              f"(p50 {rep.p50_ms:.1f}ms, lag {rep.freshness_lag:.0f} steps, "
              f"recall@{rep.k} "
              f"{-1.0 if rep.recall_at_k is None else rep.recall_at_k:.2f})")
    print(f"\nindexed {sess.index_stats()['index_docs']} crawled pages "
          f"(incremental folds, watermark step {sess.watermark})")

    # one query per domain against the live index: results should come
    # from that domain
    doms = np.arange(min(cfg.n_domains, 4))
    scores, urls = sess.answer(doms, seeds=42 + doms)
    hits = 0.0
    for d, u in zip(doms, urls):
        got = W.domain_of(torch.from_numpy(np.asarray(u, np.int64)),
                          cfg).numpy()
        ok = float((got == d).mean())
        hits += ok
        print(f"  query[domain {d}] -> top-5 doc domains "
              f"{[int(x) for x in got[:5]]} ({100 * ok:.0f}% on-topic)")
    print(f"mean on-topic rate: {100 * hits / len(doms):.0f}%")
    return hits / len(doms)


if __name__ == "__main__":
    main()

"""Learned URL ranker on the port: train a small MLP on crawl telemetry
(URL features -> popularity), then plug it into the crawler as the
session's ``score_fn``: the paper's "URL ranker" upgraded from
hand-crafted metrics to a model. Both crawls run through
``repro_torch.api.CrawlSession``.

    PYTHONPATH=src python examples/torch_learned_ranker.py           # card
    PYTHONPATH=src python examples/torch_learned_ranker.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch  # noqa: E402

from repro_torch.api import CrawlSession  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.core.ranker import make_learned_scorer  # noqa: E402
from repro_torch.core.webgraph import popularity  # noqa: E402
from repro_torch.data.pipeline import ranker_examples  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models.recsys import init_mlp_params, mlp  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train.trainer import (init_train_state,  # noqa: E402
                                       make_train_step)


def crawl(cfg, steps, device, score_fn=None):
    u = CrawlSession(cfg, device, score_fn=score_fn).run(steps).urls
    pop = popularity(torch.from_numpy(u.astype("int64")).to(device), cfg)
    return u, float(pop.mean())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = get_reduced("webparf")

    # phase 1: bootstrap crawl with the hand-crafted ranker
    urls, base_quality = crawl(cfg, 40, dev)
    X, y = ranker_examples(urls, cfg, device=dev)
    print(f"bootstrap crawl: {len(urls)} pages, mean fetched-page quality "
          f"{base_quality:.3f}; {len(X)} ranker examples")

    # phase 2: train the ranker (features -> popularity regression)
    params = init_mlp_params(0, (8, 32, 16, 1), device=dev)
    opt = adamw(lr=1e-2)
    step = make_train_step(
        lambda p, b: torch.mean((mlp(p, b[0])[:, 0] - b[1]) ** 2), opt)
    state = init_train_state(params, opt)
    for _ in range(200):
        state, m = step(state, (X, y))
    print(f"ranker trained: mse {float(m['loss']):.5f}")

    # phase 3: crawl again with the LEARNED ranker driving the queues
    def apply_fn(p, feats):
        shp = feats.shape[:-1]
        out = torch.sigmoid(mlp(p, feats.reshape(-1, feats.shape[-1]))[:, 0]
                            * 4.0 - 2.0)
        return out.reshape(shp)
    learned = make_learned_scorer(apply_fn, state.params)
    urls2, learned_quality = crawl(cfg, 40, dev, score_fn=learned)
    print(f"learned-ranker crawl: {len(urls2)} pages, mean quality "
          f"{learned_quality:.3f} (hand-crafted: {base_quality:.3f})")
    return base_quality, learned_quality


if __name__ == "__main__":
    main()

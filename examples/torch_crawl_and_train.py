"""Crawl the synthetic web and train an LM of ~100M parameters (12 layers
x 512 wide, 8 heads, d_ff 2048, vocab 32768, tied embeddings, f32) on the
crawled corpus for a few hundred steps, through the port's train driver
(``repro_torch.launch.train``).

    PYTHONPATH=src python examples/torch_crawl_and_train.py --steps 200
    PYTHONPATH=src python examples/torch_crawl_and_train.py --small \\
        --device cpu     # 2 layers x 128 wide, 4 heads, vocab 2048
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import qwen2_1_5b as Q  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.launch import train as TR  # noqa: E402


def model_config(small: bool):
    cfg = scaled(Q.CONFIG, name="lm-100m", n_layers=12, d_model=512,
                 n_heads=8, n_kv_heads=8, head_dim=64, d_ff=2048,
                 vocab_size=32768, tie_embeddings=True, dtype="float32",
                 remat=False)
    if small:
        # 4 KV heads: the reference example's --small keeps 8 KV heads
        # for 4 query heads, which no attention takes
        cfg = scaled(cfg, n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
                     head_dim=32, d_ff=512, vocab_size=2048)
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        targs = TR.build_parser().parse_args(
            ["--arch", "qwen2-1.5b", "--steps", str(args.steps),
             "--batch", "8", "--seq-len", "256", "--crawl-steps", "200",
             "--lr", "3e-4", "--log-every", "10", "--ckpt-dir", ckpt_dir,
             "--ckpt-every", "50", "--device", args.device])
        return TR.train_lm(targs, cfg=model_config(args.small))


if __name__ == "__main__":
    main()

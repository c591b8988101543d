"""Batched LM serving on the port: prefill a prompt batch, then decode
greedily from a KV cache, for the MoE model DeepSeekMoE-16B (its reduced
config: one dense prefix layer, then routed and shared experts) through
``repro_torch.launch.serve``.

    PYTHONPATH=src python examples/torch_serve_lm.py                # card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main as serve_main  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return serve_main(["--arch", "deepseek-moe-16b", "--batch", "4",
                       "--prompt-len", "16", "--gen", "12",
                       "--device", args.device])


if __name__ == "__main__":
    raise SystemExit(main())

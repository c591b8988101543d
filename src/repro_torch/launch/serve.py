"""Batched LM serving: prefill a batch of prompts, then decode greedily from
a KV cache. Counterpart of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --batch 4 --prompt-len 32 --gen 16            # on the card
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve \
      --arch deepseek-moe-16b --full               # MoE at full width

Any LM arch serves: the dense ones and the MoE ones (deepseek-moe-16b,
arctic-480b; ``--full`` arctic-480b needs more than one card's memory).
Without ``--full`` the arch's ``reduced()`` config runs; weights are drawn
from ``--seed`` (there are no pretrained weights), prompts from a numpy
generator of the same seed. It runs on cuda unless ``--device cpu`` is
given, and raises when no card is present.
"""
from __future__ import annotations

import argparse
import time
from typing import Tuple

import numpy as np
import torch

from repro_torch.configs import get_arch, get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve(model: T.LM, prompts: torch.Tensor,
          gen: int) -> Tuple[torch.Tensor, float, float]:
    """Greedy generation of ``gen`` tokens after ``prompts`` (B, P) int64:
    one prefill into a KV cache of P + gen slots, then gen - 1 decode
    steps. Returns (tokens (B, gen), prefill seconds, decode seconds), each
    time on the host clock after the device finished. ``argmax`` takes the
    first maximum, as the reference's does. Raises FloatingPointError if
    any step's logits were not finite."""
    if gen < 1:
        raise ValueError(f"serve: gen={gen} < 1")
    dev = prompts.device
    B, P = prompts.shape
    with torch.inference_mode():
        _sync(dev)
        t0 = time.perf_counter()
        logits, cache = T.prefill_step(model, prompts, max_len=P + gen)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True)
        finite = torch.isfinite(logits).all()
        _sync(dev)
        t1 = time.perf_counter()
        out = [tok]
        for _ in range(gen - 1):
            logits, cache = T.decode_step(model, tok, cache)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            finite &= torch.isfinite(logits).all()
            out.append(tok)
        _sync(dev)
        t2 = time.perf_counter()
    if not bool(finite):
        raise FloatingPointError("serve: non-finite logits")
    return torch.cat(out, dim=1), t1 - t0, t2 - t1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch)[0] if args.full else get_reduced(args.arch)
    if cfg.family != "lm":
        raise ValueError(f"serve is for the LM family, not {cfg.family}")
    model = T.init_lm(cfg, seed=args.seed, device=dev)
    prompts = torch.tensor(np.random.default_rng(args.seed).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len)), device=dev)
    toks, t_pre, t_dec = serve(model, prompts, args.gen)
    dt = t_pre + t_dec
    print(f"{args.arch}: generated {tuple(toks.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s) on {dev}: prefill "
          f"{1e3 * t_pre:.1f} ms, decode "
          f"{1e3 * t_dec / max(args.gen - 1, 1):.2f} ms/token")
    print("sample:", toks[0][:16].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

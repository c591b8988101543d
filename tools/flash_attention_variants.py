#!/usr/bin/env python3
"""Time the f32 flash_attention kernel's design choices against each other
on one NVIDIA card, in one run.

    python3 tools/flash_attention_variants.py [--also NAME=old.cu]

Builds ``src/repro_torch/csrc/flash_attention.cu`` as it stands (split
TF32 on mma.sync, K/V tiles double buffered by cp.async, 8 warps of 16
rows a block) and with one of its choices changed at a time (each a
constant or a call of the source, replaced in a copy under ``build/``):

- ``mma_sync``: both products as mma.sync.m16n8k8 (a warp's 16 rows, the
  hi/lo fragments loaded by each thread) at every head dim, where the
  source takes wgmma (a warpgroup's 64 rows, B read from shared memory)
  from head dim 64;
- ``single_buffer``: one f32 K/V stage, so each tile's copy waits for the
  last tile's split, where the source keeps tile j + 1 in flight;
- ``no_cp_async``: the f32 tiles loaded by the threads (load, store),
  where the source copies them with cp.async;
- ``4_warps``: blocks of 4 warps and 64 query rows, where the source takes
  8 warps and 128 rows;
- ``chain_1`` / ``chain_2`` / ``chain_16``: q.k^T's products of 1, 2 or
  16 k-steps (at hd 128, the whole row) chained in the tensor cores, which
  round toward zero, before their sum is added to the f32 scores, where
  the source chains 4;
- ``cost_one_product`` / ``cost_no_split_pass``: not exact, they show what
  a piece costs: hi.hi alone where the source makes three TF32 products
  per f32 product, and the hi/lo split of each tile left out;

``--also`` adds any other source with the same C entry, such as an
earlier commit's (``git show <rev>:src/repro_torch/csrc/flash_attention.cu
> build/parent.cu``).

Inputs: the q, k and v that layer 0 of Qwen2-1.5B's full-width bf16
prefill hands to attention (4 prompts of 2,048 tokens, 12 query and 2 KV
heads, hd 128, seeded weights; ``chip_smoke.capture_flash``), cast to f32
as the f32 route receives them, causal. Each variant is held to the plain
version (``ref.flash_ref``), 2e-5 x (1 + |want|), there and on small cases
(every head dim, ragged lengths, GQA, not causal); one that strays past it
is timed all the same and listed under ``past_2e-5``. Times, in
milliseconds a call by CUDA events over 20 calls, best and median of four
(two in the listed order, two in reverse), beside the library's fused
attention on the same f32 inputs (a yardstick, its backend named; also
with K and V repeated to every query head, which takes another backend), the
plain version, and the bounds: three TF32 passes over 495 TFLOP/s (split
TF32), the f32 bytes over 3.35 TB/s, and the CUDA cores' FMA floor at 67
TFLOP/s. The card's name and power limit come last.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCE = ROOT / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
OUT = ROOT / "build" / "flash_attention_variants"
# name -> [(text in the source, its replacement)]
CHANGES = {
    "mma_sync": [("kWgmmaFrom = 64;", "kWgmmaFrom = 1024;")],
    "single_buffer": [("kStages = 2;", "kStages = 1;")],
    "no_cp_async": [("launch_hd<float, true>(hd, a, Hq, B, nq, st)",
                     "launch_hd<float, false>(hd, a, Hq, B, nq, st)")],
    "4_warps": [("kWarps = 8;", "kWarps = 4;")],
    "chain_1": [("kChain = 4;", "kChain = 1;")],
    "chain_2": [("kChain = 4;", "kChain = 2;")],
    "chain_16": [("kChain = 4;", "kChain = 16;")],
    # what a piece costs, not exact: timed, listed under past_2e-5
    "cost_one_product": [
        ("          wgmma_n32(acc[b], al[b][c], hi, c > 0);\n"
         "          wgmma_n32(acc[b], ah[b][c], lo, 1);\n"
         "          wgmma_n32(acc[b], ah[b][c], hi, 1);\n",
         "          wgmma_n32(acc[b], ah[b][c], hi, c > 0);\n"),
        ("        wgmma_pv<HD>(ot, pl[n], hi, n > 0);\n"
         "        wgmma_pv<HD>(ot, ph[n], lo, 1);\n"
         "        wgmma_pv<HD>(ot, ph[n], hi, 1);\n",
         "        wgmma_pv<HD>(ot, ph[n], hi, n > 0);\n")],
    "cost_no_split_pass": [(
        "      split_tile_wg<HD>(Ks + (j % kStages) * S::kK,\n"
        "                        Vs + (j % kStages) * S::kV, K2, K2 + S::kK2, "
        "V2,\n                        V2 + S::kV2);\n",
        "      asm volatile(\"\" ::: \"memory\");\n")],
}


def sources(also):
    """{variant name: source text}."""
    text = SOURCE.read_text()
    out = {"as_shipped": text}
    for name, edits in CHANGES.items():
        t = text
        for old, new in edits:
            if t.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {SOURCE} once")
            t = t.replace(old, new)
        out[name] = t
    for spec in also:
        name, path = spec.split("=", 1)
        out[name] = Path(path).read_text()
    return out


def build(texts):
    """One nvcc per variant, all started together; {name: C entry}."""
    from repro_torch.kernels.build import build_sources
    fns = {}
    for name, (lib, log) in build_sources(texts, OUT).items():
        fn = lib.flash_attention_launch
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 20 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
        # ptxas's lines for the f32 instantiation at hd 128
        lines, keep = [], False
        for ln in log.splitlines():
            if "Compiling entry" in ln:
                keep = "kernelIfLi128E" in ln
            elif keep and ("registers" in ln or "spill" in ln):
                lines.append(ln.strip())
        print(json.dumps({"variant": name, "ptxas_f32_hd128": lines}),
              flush=True)
    return fns


def caller(entry, q, k, v, causal):
    """A call of one variant's entry (the CUDA-core route of
    ``kernels.flash_attention.ops.launch``); returns (B, Hq, Sq, hd)."""
    import torch
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]

    def call():
        out = torch.empty((B, Sq, Hq, hd), dtype=q.dtype,
                          device=q.device).transpose(1, 2)
        strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
        rc = entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   B, Hq, Hkv, Sq, Skv, hd, int(q.dtype == torch.bfloat16),
                   int(causal), *strides,
                   torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return out
    return call


def check(name, got, q, k, v, causal, label):
    """Max |got - want| against the plain version, and whether it stays
    within 2e-5 x (1 + |want|)."""
    import torch
    from repro_torch.kernels.flash_attention.ops import _gqa_fold
    from repro_torch.kernels.flash_attention.ref import flash_ref
    qg, kf, vf, group = _gqa_fold(q, k, v)
    want = flash_ref(qg, kf, vf, causal=causal, group=group).reshape(q.shape)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and \
        float((err - 2e-5 * (1 + want.float().abs())).max()) <= 0
    return float(err.max()), ok


def small_cases(rng):
    from chip_smoke import flash_inputs
    for hd in (8, 16, 32, 64, 96, 128):
        for group, S, causal in ((1, 65, True), (6, 200, False),
                                 (3, 257, True)):
            q, k, v = flash_inputs(rng, 2, 2 * group, 2, S, hd, "float32",
                                   strided=S % 2 == 1)
            yield f"hd={hd} group={group} S={S} causal={causal}", \
                q, k, v, causal


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--also", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import (H100_F32_FLOPS, H100_TF32_FLOPS, HBM_BYTES_PER_S,
                            LM_ARCH, LM_BATCH, LM_PROMPT, SPLIT_TF32_PASSES,
                            attention_flops, capture_flash, cuda_ms,
                            nvidia_smi, sdpa_backend)
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention.ops import _gqa_fold
    from repro_torch.kernels.flash_attention.ref import flash_ref
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = build(sources(args.also))
    errs = {name: 0.0 for name in fns}
    fails = {name: [] for name in fns}

    def held(name, got, q, k, v, causal, label):
        e, ok = check(name, got, q, k, v, causal, label)
        errs[name] = max(errs[name], e)
        if not ok:
            fails[name].append(label)
    for label, q, k, v, causal in small_cases(np.random.default_rng(
            args.seed)):
        for name, entry in fns.items():
            held(name, caller(entry, q, k, v, causal)(), q, k, v, causal,
                 label)
    cfg = get_arch(LM_ARCH)[0]
    model = T.init_lm(cfg, seed=0, device="cuda")
    prompts = torch.tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), device="cuda")
    q, k, v = (x.float() for x in capture_flash(model, prompts, {0})[0])
    del model
    torch.cuda.empty_cache()
    calls = {name: caller(entry, q, k, v, True)
             for name, entry in fns.items()}
    for name, call in calls.items():
        held(name, call(), q, k, v, True, "layer 0 as f32")
    sdpa = torch.nn.functional.scaled_dot_product_attention
    calls["library"] = lambda: sdpa(q, k, v, is_causal=True,
                                    enable_gqa=True)
    # K and V repeated to every query head: the library's other f32 path
    g = q.shape[1] // k.shape[1]
    kr, vr = (x.repeat_interleave(g, dim=1) for x in (k, v))
    calls["library_repeated_kv"] = lambda: sdpa(q, kr, vr, is_causal=True)
    times = {}
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            for _ in range(2):
                times.setdefault(name, []).append(cuda_ms(calls[name], 20))
    qg, kf, vf, group = _gqa_fold(q, k, v)
    plain = cuda_ms(lambda: flash_ref(qg, kf, vf, causal=True, group=group),
                    5)
    flops = attention_flops(q)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * 4
    backend, kernel, ops = sdpa_backend(calls["library"])
    backend_rep = sdpa_backend(calls["library_repeated_kv"])[0]
    print(json.dumps({
        "input": "qwen2-1.5b layer 0 prefill inputs cast to f32",
        "shape": {"q": list(q.shape), "kv": list(k.shape), "causal": True},
        "ms_best": {n: min(t) for n, t in times.items()},
        "ms_median": {n: float(np.median(t)) for n, t in times.items()},
        "plain_ms": plain, "library_backend": backend,
        "library_kernel": kernel, "library_ops": ops,
        "library_repeated_kv_backend": backend_rep,
        "split_tf32_bound_ms": 1e3 * SPLIT_TF32_PASSES * flops
        / H100_TF32_FLOPS,
        "bytes_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
        "fma_floor_ms": 1e3 * flops / H100_F32_FLOPS,
        "max_abs_err": errs,
        "past_2e-5": {n: f for n, f in fails.items() if f}}), flush=True)
    print(nvidia_smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

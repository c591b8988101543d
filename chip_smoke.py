#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (a phase that fails raises, and the script exits
non-zero):

  1. build   — nvcc builds every kernel's library from csrc/, one process
               per source, all started together (nine kernels, six
               sources: select_harvest shares frontier_select.cu,
               bloom_packed bloom.cu, dedup_deposit_packed
               dedup_deposit.cu); flash_attention_tc's SASS must hold
               HGMMA, and flash_attention's HGMMA and HMMA (cuobjdump);
               then bloom_kernel's registers and shared memory (ptxas),
               on a line of their own.
     dryrun_cell — ``python -m repro_torch.launch.dryrun --all`` (the 40
               cells and the crawl cell reckoned on meta, in a process
               that never touches the card): one line a cell (fits in
               ``launch/mesh.HBM_BYTES``, peak GiB, FLOP, bound ms, the
               largest batch that fits).
     lm_zoo  — every LM serving cell of LM_SHAPES that the dry run fits
               (prefill_32k, decode_32k, long_500k; train_4k is left out),
               at the dry run's batch, before anything else touches the
               card, each in a fresh process (``chip_smoke.py --zoo-cell
               ARCH SHAPE BATCH``) so that its weights meet an empty
               allocator: the full-width model from the port's seeded
               init, bf16; RoPE on the card against the CPU (the inverse
               frequencies bit for bit, apply_rope at 524,272-524,287
               within 1e-6); a prefill cell through ``launch.serve.serve``
               (S + 4 cache slots, 4 tokens, after a small warm-up serve):
               one flash_attention_tc launch a layer and no
               flash_attention (counts zeroed just before, read just
               after), finite logits, layer 0's and the last layer's
               attention captured in that serve (batch row 0, KV head 0's
               query group, and the kernel's own output) and held to the
               plain version and tc_plain's bound, the kernel's largest
               size and stride against int32; a decode cell: 4 greedy
               decode_steps against a cache of S slots of seeded bf16
               values, S - 4 valid, layer 0's decode attention of row 0
               held to the CPU's within 2e-2 (1 + |want|); each cell's
               measured peak (max_memory_allocated from before the
               weights) within 15% of the dry run's reckoning of the same
               cell at the same batch, the allocator's reserved peak
               beside the dry run's replay of it, the headroom under
               HBM_BYTES, the ms beside the dry run's bound_ms, and
               HBM_BYTES no more than the card's reported total.
  2. parity  — each kernel against its plain PyTorch version on the card,
               exact equality, at the main paths' shapes and at small
               shapes with ties, duplicates, ragged tiles and masked rows
               (the pop kernels also on C not a multiple of 4, unaligned
               views, k = C, rows past register and shared-memory
               residency, sparse and all-equal rows, the CLI's and the
               reduced widths, reaching both their vector and scalar
               path; the Bloom kernels also on sparse rows whose live lanes
               span many tiles; the packed kernels also on rows of one to
               four words and on words with bit 31 set; opic_update also
               on skewed items, one target for all, N past one chunk, R
               past one range, each case with its longest per-target
               chain).
  3. main    — three crawls at the full webparf.CONFIG (256 domains, 512
               frontier rows of 4096, 512 Bloom rows of 2^24 bytes), one
               at a time, each session freed before the next is built:
               ordering="opic_url" (fused dispatch) for 64 steps, which must
               launch select_harvest, dedup_deposit and opic_update and
               conserve cash; "opic" for 16 steps (frontier_select, bloom,
               opic_update, cash conserved); "backlink" for 32 steps
               (frontier_select, bloom). Launch counts are zeroed just
               before each run and read just after it.
     profile — per crawl path (opic_url, backlink): the device's busy time
               over two more intervals (torch.profiler), its idle share,
               the device time of each launch of the port's crawl
               kernels by name, and the host syncs per step.
     each path's session also yields its kernels' timing inputs: the
               frontier and Bloom batches (backlink), the spend scatter
               (opic), the harvest, the dispatch batch and the cell scatter
               (opic_url), captured from the path itself.
     main_sharded — the opic_url (64 steps) and backlink (32 steps) paths
               again at webparf.CONFIG with 4 shards batched on the card
               (128 rows a shard, the per-shard budget of 64 reached every
               step, exchange buckets of 1,024), counted and profiled as
               the one-shard path: every shard fetched, cash conserved,
               and each crawl kernel launched exactly as many times as on
               the one-shard path (a loop over the shards would launch it
               4x); a "shards" line puts pages/s, the fetch- and
               dispatch-step ms, the device events, host syncs and idle
               share of 1 and 4 shards side by side. sharded_parity: the
               path's kernels against their plain versions, exact, on the
               4-shard session's own next calls (the pop; for opic_url
               a row-sum scatter over the 4 shards' slot cash and a cell
               scatter; 8 Bloom dispatches, bloom or dedup_deposit,
               replayed on the filter with what they touch restored,
               beside the bound their data needs).
     packed  — the packed Bloom family's entry points on the opic_url
               session's filter (512 x 2^24 bits, packed once into 1 GiB
               of int32 words): bloom_packed and dedup_deposit_packed
               beside the byte-per-bit kernels over dispatch batches laid
               out as the path's, re-sending queued and inserted URLs so
               that seen, twin deposits and refunds are non-zero; every
               output identical; then dedup_deposit(..., packed=True)
               against the byte-per-bit call. Counts zeroed just before,
               read just after. bloom_packed and bloom are also timed
               in a CUDA graph on the same fresh batches.
  4. trajectory — the CLI-sized config runs on the card and on the CPU
               (plain versions) for backlink, opic, opic_url fused and
               opic_url unfused (link_pop_bias=1.0, so twins are hit), with
               1 and with 4 shards; every output and state leaf must match.
     heal    — C4 at the CLI size with 4 shards, backlink and opic_url, on
               the card and on the CPU: shard 1 fails at a dispatch
               boundary and is healed at the next; the state before the
               heal, the heal and the run after it identical on both in
               every leaf, every URL queued on the card's dead shard
               queued on a survivor after its heal, and
               under opic_url the cash balanced across the heal and the
               run.
     serve   — the live crawl -> index -> serve path (ServeSession) at
               webparf.CONFIG, backlink, 4 shards, 64 steps, the serve
               CLI's load and widths and an index of 65,536 docs, beside
               the same crawl without serving in this call: latency
               p50/p95/p99, QPS, freshness lag, recall@10, the index's
               docs and drops (none), pages/s both ways, the device ms
               of one query batch and of one index fold (torch.profiler),
               the host syncs of each, and the crawl kernels' launches,
               which must equal the crawl's without serving (counts
               zeroed just before each run, read just after).
     serve_trajectory — the serve CLI's config with 4 shards, 48 steps,
               on the card and on the CPU: shard 1 fails at 16, a
               checkpoint at 24 is restored into a fresh session, the
               crawl heals at 32; index leaves, answers, lags, arrivals,
               recall and the crawl identical (scores within 2 ulp); then
               CrawlSession(score_fn=ranker.score_urls) on the card equal
               to the default crawl in every leaf.
     dist    — the crawl group, one crawl process a card
               (``repro_torch.dist``; every card of the machine, W = 1
               on one): webparf.CONFIG at N = 4 for backlink 32 steps,
               opic_url 64, the four modes under opic_url 32 and one
               serve interval, first as one-card 4-shard sessions (and
               1-shard ones for backlink and opic_url) in this process,
               then in W fresh processes over NCCL (``chip_smoke.py
               --dist-rank OUT``, a failed or hung rank fails the phase):
               every report and every leaf of the final state equal to
               the one-card session's bit for bit on every rank (the
               Bloom filter by two 64-bit digests a shard); each rank's
               launches zeroed just before each run and read just after;
               on the profiled paths, device events, host syncs, idle and
               collective time a step, and each crawl kernel's next call
               on each rank held to its plain version; pages/s beside the
               one-card 4- and 1-shard sessions', step ms, the
               all_to_all's ms a dispatch in the crawl and alone, peak
               GiB.
     dist_train — the train mesh, one fresh process a card over NCCL
               (``chip_smoke.py --dist-train-rank OUT``; every card), each
               case held to the same rank's one-card run: C1 the reduced
               f32 deepseek-moe-16b, 3 AdamW steps at (2, 2) and (4, 1)
               ((1, 1) on one card): loss and grad norm within 1e-5 a
               step, the state within 2 * lr * steps (mean 1e-6 * steps),
               the rank's routes equal to its group's of the one-card
               grouped routing, flash_attention launched once a layer a
               step and its first call held to the plain version; C5 its
               (2, 2) state saved and restored onto (4, 1) and (1, 4), bit
               for bit, one more step equal on every rank; C2 Qwen2-1.5B
               bf16 4 x 4096 a data rank at (2, 2) and (4, 1): the first
               loss and grad norm against one card's step on the same
               global batch in microbatches (2e-2, 5% relative), step ms,
               tokens/s, peak GiB, state bytes == its specs' reckoning,
               the collectives' share of a profiled step,
               flash_attention_tc 56 a step and held to plain; C3
               DeepSeekMoE-16B at 8 of 28 layers, 2 x 4096 a data rank, at
               (1, 4) and (2, 2): drop shares beside the one-card group's,
               the second step's ms and all_to_all ms a layer; C4 DCN-v2
               and Wide&Deep at 65,536 at (2, 2): the step within 1e-5 of
               one card's, the sharded lookup bit-equal. C2-C5 need four
               cards. ``chip_smoke.py --dist`` runs the build, ``dist``
               and this phase alone, on every card of the machine.
  5. lm      — flash_parity: both attention kernels against the plain
               version on small cases (every head dim, GQA groups 1/3/6,
               lengths 32, 192 and 256, causal on and off, f32 and bf16),
               each case checked to launch the kernel its route names
               (bf16 at hd 64/96/128: flash_attention_tc, also held to a
               plain version that rounds p to bf16 as it does; the rest:
               flash_attention);
               lm_serve: Qwen2-1.5B at full width (28 layers, d 1536,
               12/2 heads, hd 128, vocab 151936) from a seeded init, bf16,
               prefill of 4 x 2048 prompts and 32 greedy tokens through
               ``launch.serve.serve``, one flash_attention_tc launch per
               layer and no flash_attention launch (counts zeroed just
               before, read just after), no non-finite
               logits, and a profile of one prefill and of four decode
               steps; lm_long: one serve of a 32768-token prompt (batch
               1) and 8 tokens, counted as lm_serve is;
               lm_captured_parity: the kernels against the plain version
               on the q, k, v of layer 0 and layer 27 of the 4 x 2048
               prefill, in bf16 (flash_attention_tc, also against the
               plain version that rounds p, and flash_attention launched
               directly) and cast to f32 (flash_attention);
               lm_cpu: the reduced qwen2-1.5b, phi3-mini-3.8b and
               deepseek-coder-33b in f32 on the card and the CPU, logits
               within 1e-4 over a prefill and 16 teacher-forced decode
               steps, each prefill launching flash_attention once a layer
               (its f32 path).
     train   — Qwen2-1.5B at full width (bf16, remat on) trained on the
               train CLI's corpus (its crawl of the reduced webparf config,
               60 steps, on the card: frontier_select and bloom launch):
               batches of 4 x 4096 tokens (train_4k's length, its batch of
               256 cut to 4 for the time limit), 4 AdamW steps on
               warmup-cosine from 3e-4: each step's loss, grad norm and ms,
               tokens/s, peak memory, and its launches (zeroed just before
               the step, read just after): 56 flash_attention_tc (28
               forward, 28 remat recomputes; the backward is plain
               PyTorch) and nothing else; a profile of one more step (the
               plain backward's device ms marked by a record_function
               range) and the backward's standalone ms on the captured
               call; then, on layer 0's q, k, v of the first step, the
               kernel forward against the plain version and the autograd
               backward against autograd through flash_ref with a seeded
               dO, in bf16 and cast to f32.
     train_f32 — the CLI's reduced f32 model, 20 steps on the card and the
               CPU from the same weights and batches: losses within 1e-4,
               parameters within 2 * sum(lr) (mean within 1e-6),
               flash_attention launched once a layer a step; then
               run_with_failures on the card with a failure at step 8,
               equal to the uninterrupted card run bit for bit.
     moe_serve — DeepSeekMoE-16B at its published config (28 layers: 1
               dense of d_ff 10944, then 27 MoE of 64 routed experts top-6
               of 1408 and 2 shared; d 2048, 16/16 heads, hd 128, vocab
               102400; 16.38 B parameters), bf16, seeded weights, 4 x
               2048 prompts + 32 tokens through ``launch.serve.serve``
               (prefill_32k's 32 x 32768 cut for memory, as for Qwen):
               layer 0's and 27's attention inputs held to the plain
               version, 28 flash_attention_tc and 0 flash_attention
               launches a prefill (counts zeroed just before the counted
               serve, read just after), prefill ms, decode ms a token,
               tok/s, peak GiB (< 80), each MoE layer's share of dropped
               assignments, a profile of a prefill and of decode tokens
               split into expert bmm, dispatch, scatter/combine, attention,
               dense GEMMs, f32 elementwise and the rest, the host syncs a
               decode token, and the bounds (prefill FLOP over 989
               TFLOP/s, the routed GEMMs over E x C slots; a token's bytes,
               every expert's weights and the k/v, over 3.35 TB/s).
     moe_arctic — Arctic at its published widths (d 7168, 56/8 heads,
               128 experts top-2 of 4864 beside a dense residual of 4864,
               vocab 32000), depth cut from 35 to 2 layers (27.7 B
               parameters), bf16, 1 x 2048 + 8 tokens, counted and
               bounded as moe_serve (2 flash_attention_tc a prefill).
     moe_cpu — the reduced deepseek-moe-16b and arctic-480b in f32 on the
               card and the CPU (TF32 off): logits within 1e-4 over a
               prefill and 16 teacher-forced decode steps, argmax, experts
               and keep equal, flash_attention once a layer a prefill;
               again at capacity factor 0.5 (assignments must drop); 4
               AdamW steps of the reduced deepseek-moe-16b, losses within
               1e-4.
     examples — examples/torch_quickstart.py's main on the card, and
               examples/torch_serve_lm.py's (the reduced deepseek-moe-16b:
               2 flash_attention launches, finite logits); then the train
               CLI (``launch.train.main``, its default device) for
               gat-cora and dcn-v2, 10 steps each, finite losses.
     gnn     — gat-cora at its published config (2 layers, 8 hidden x 8
               heads, f32, TF32 off), seeded synthetic data:
               full_graph_sm (2,708 nodes, 10,556 edges, 1,433 features,
               140 labelled; 10 AdamW steps: losses, ms, peak GiB, a
               profile of a step with its host syncs), minibatch_lg
               (synthetic_csr at Reddit's 232,965 nodes and ~109 M edges
               on the host; a fresh sample_fanout block of 1,024 seeds,
               fanouts (15, 10), a step, its 602-wide features gathered on
               the card: the sampler's host ms beside the device step's
               ms), molecule (gat_batched_loss, 128 graphs of 30 nodes and
               64 edges); ogb_products is reckoned on a line of its own
               (its last layer's messages alone are 93.0 GB), not run.
               Each step beside its bound (bytes over 3.35 TB/s, FLOP
               over 67 TFLOP/s f32).
     recsys  — bert4rec, dien, wide-deep and dcn-v2 at their published
               configs (the full tables), seeded weights, make_batch's
               batches, one arch at a time: train_batch (4 AdamW steps),
               serve_p99 (512), serve_bulk (262,144) and retrieval_cand (1
               x 1,000,000): ms, examples/s, peak GiB, a profile of a
               train step and of a serve_p99 call (idle share, events, the
               top three device ops), each beside its bound; a batch is
               cut by powers of two only while its peak, reckoned by the
               dry run on meta (launch/dryrun.py), exceeds 60 GiB (3/4 of
               the card), and each cut is printed with its bytes;
               retrieval ids valid, every output finite.
     gnn_recsys_cpu — the five reduced configs in f32 (TF32 off) on the
               card and the CPU from the same weights and batches: 4 AdamW
               steps' losses within 1e-4, serve outputs within 1e-5,
               retrieval ids equal under the tie rule; the same 4 steps
               again on the card, bit for bit (the first differing leaf
               named otherwise); run_with_failures for dcn-v2 and gat-cora
               with a failure at step 3 against the uninterrupted run.
               No port kernel launches in gnn, recsys (counted).
     moe_groups — DeepSeekMoE-16B at full width (bf16, 4 x 2048 + 32
               tokens) served with no mesh and under activation_mesh
               shapes (4, 1) and (2, 2), where each (data, model) block of
               tokens routes as a group with its own capacity (the
               reference's _moe_spmd): layers 0 and 27 held to the plain
               attention, 28 flash_attention_tc a prefill, prefill ms,
               decode ms a token, groups and drop shares side by side;
               the reduced grouped MoE on the card against the CPU (1e-4,
               routes equal, drops at 0.5); a checkpoint in the
               reference's format restored and reshard()ed onto the card
               bit for bit, then a step under (2, 4) on both devices.
     trace_labels — REPRO_TRACE_KERNELS=1: a profiled CLI-sized crawl
               (opic_url, backlink) has one kernel/<family>.cuda range per
               launch of each launched kernel and no other.
     dryrun  — the cells this script runs (Qwen2-1.5B prefill 4 x 2048
               + 32 and train 4 x 4096, DeepSeekMoE-16B prefill, Arctic at
               2 layers, the three GAT cells, the four RecSys trains at
               their cut batches, CONFIG's crawl at 1 and 4 shards)
               reckoned on meta and run once on the card from zeros:
               reckoned peak within 15% of torch.cuda.max_memory_allocated.
  6. kernels — each kernel's time (CUDA events; for the crawl kernels also
               in a CUDA graph, warm and cold, by the profiler, and per
               launch inside the profiled crawl; dedup_deposit also on the
               crawl's own next calls, replayed with the state they touch
               restored, beside the bound their data needs) beside its
               plain version's (the packed ones on their words, with the
               boundary call's time beside its bound), a library call's
               where one computes the same function, and its bound: the
               bytes it must move over 3.35 TB/s, or for the attention
               kernels (timed on layer 0's inputs in the same run:
               flash_attention_tc on the bf16 ones, flash_attention on
               them cast to f32, its contract) the larger of that and
               their operations over 989 TFLOP/s (bf16) or, three TF32
               products per f32 product, 495 TFLOP/s (f32); the attention
               rows also carry their launches per train step and per MoE
               prefill (28 DeepSeekMoE and 2 Arctic flash_attention_tc;
               2 flash_attention for each reduced f32 model) and
               flash_attention_tc's per zoo prefill; the crawl kernels'
               rows also carry their launches on each rank of ``dist``.

Then the card's name and power limit as nvidia-smi gives them, and last the
line {"ok": true, "device": {...}}. Without a CUDA device, or without the
rest of the repository beside it, the script fails before printing a result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import subprocess
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# the card's rates and the reckoners of a run's bound: one copy, the port's
from repro_torch.launch.dryrun import (cut_batch, gat_cost,  # noqa: E402
                                       moe_bounds, recsys_cost, tensors)
from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S  # noqa: E402
from repro_torch.launch.mesh import HBM_BYTES  # noqa: E402
from repro_torch.launch.mesh import PEAK_FLOPS_BF16 as H100_BF16_FLOPS  # noqa
from repro_torch.launch.mesh import PEAK_FLOPS_F32 as H100_F32_FLOPS  # noqa
from repro_torch.launch.mesh import PEAK_FLOPS_TF32 as H100_TF32_FLOPS  # noqa
SEED = 0
DEV = "cuda"
SCORE_ULP = 2                       # served TF-IDF scores, card vs CPU
CASH_RTOL = 1e-4                    # OPIC cash drift allowed over a run:
                                    # the f32 rounding of the spend split


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean milliseconds of ``fn()`` over n calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


# ---------------------------------------------------------------------------
# inputs, made with numpy from a seed
# ---------------------------------------------------------------------------

def frontier_rows(rng, R, C, *, fill=0.6, ties=False, equal=False):
    """Frontier-like rows: invalid cells hold NEG; valid priorities are
    distinct f32 integers, or drawn from 4 values when ``ties``; with
    ``equal`` the last row holds one key in every cell."""
    from repro_torch.kernels.frontier_select.ref import NEG
    url = rng.integers(1, 1 << 30, (R, C)).astype(np.int64)
    valid = rng.random((R, C)) < fill
    if R > 1:
        valid[0] = False                    # an empty row
        valid[1] = True                     # a full row
    pri = (rng.integers(0, 4, (R, C)) if ties else
           rng.permutation(R * C).reshape(R, C)).astype(np.float32)
    pri = np.where(valid, pri, np.float32(NEG)).astype(np.float32)
    if equal:
        pri[-1], valid[-1] = 7.0, True
    return url, pri, valid


def pop_tensors(url, pri, valid, unaligned=False):
    """The pop's (url, pri, valid) on the card; ``unaligned``: pri and
    valid as contiguous views one element into larger buffers, which the
    kernel reads by its scalar path."""
    import torch
    u = torch.tensor(url, device=DEV)
    p, v = torch.tensor(pri, device=DEV), torch.tensor(valid, device=DEV)
    if unaligned:
        R, C = pri.shape
        p = torch.empty(R * C + 1, device=DEV)[1:].view(R, C).copy_(p)
        v = torch.empty(R * C + 1, dtype=torch.bool,
                        device=DEV)[1:].view(R, C).copy_(v)
    return u, p, v


def bloom_batch(rng, R, M, *, dup=0.3, fill=0.8):
    """URL batches with repeats inside and across 256-URL tiles."""
    urls = rng.integers(0, 1 << 30, (R, M)).astype(np.int64)
    src = rng.integers(0, M, (R, M))
    rep = rng.random((R, M)) < dup
    rows = np.arange(R)[:, None]
    urls = np.where(rep, urls[rows, src], urls)
    mask = rng.random((R, M)) < fill
    if R > 1:
        mask[R - 1] = False                 # a fully masked row
    return urls, mask


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def sass_lines(kernel, op):
    """Lines of the kernel's machine code (cuobjdump's SASS) holding op."""
    from repro_torch.kernels.build import find_nvcc
    sass = subprocess.run(
        [str(Path(find_nvcc()).with_name("cuobjdump")), "-sass",
         str(kernel.library)], check=True, capture_output=True, text=True,
        timeout=120).stdout
    return sum(op in ln for ln in sass.splitlines())


def ptxas_usage(log, fn):
    """The registers, shared memory and spills ptxas reports (nvcc's
    ``-Xptxas -v`` output ``log``) for each entry whose name holds
    ``fn``."""
    out, cur = [], None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            cur = {"entry": ln.split("'")[1]} if fn in ln else None
            if cur is not None:
                out.append(cur)
        elif cur is not None and "spill" in ln:
            cur["stack_and_spill"] = ln.strip()
        elif cur is not None and "registers" in ln:
            cur["used"] = ln.split(":", 1)[1].strip()
    return out


def phase_build():
    """Builds every kernel; fails unless the attention kernels' machine code
    holds the tensor cores' products: flash_attention_tc's warpgroup
    products (HGMMA in cuobjdump's SASS), and flash_attention's TF32
    warpgroup products (head dims 64-128) and mma.sync (HMMA, the small
    head dims). Then bloom_kernel's registers and shared memory, on a line
    of their own."""
    from repro_torch.kernels import all_kernels, build_all
    from repro_torch.kernels.bloom.ops import KERNEL as BLOOM
    from repro_torch.kernels.flash_attention.ops import KERNEL, TC_KERNEL
    t0 = time.time()
    secs = build_all(all_kernels())
    ptxas = {k.name: [ln.strip() for ln in k.build_log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln]
             for k in all_kernels()}
    hgmma = sass_lines(TC_KERNEL, "HGMMA")
    if hgmma == 0:
        raise AssertionError("flash_attention_tc: no HGMMA in its SASS")
    hmma = sass_lines(KERNEL, "HMMA")
    hgmma_f32 = sass_lines(KERNEL, "HGMMA")
    if hmma == 0 or hgmma_f32 == 0:
        raise AssertionError(f"flash_attention: {hmma} HMMA and "
                             f"{hgmma_f32} HGMMA lines in its SASS")
    emit({"phase": "build", "seconds": round(time.time() - t0, 3),
          "per_kernel_s": secs, "ptxas": ptxas,
          "flash_attention_tc_hgmma_sass_lines": hgmma,
          "flash_attention_hgmma_sass_lines": hgmma_f32,
          "flash_attention_hmma_sass_lines": hmma, "card": nvidia_smi()})
    usage = ptxas_usage(BLOOM.build_log, "bloom_kernel")
    if BLOOM.build_log and len(usage) != 2:   # empty: built before this run
        raise AssertionError(f"bloom_kernel: ptxas reported {usage}")
    emit({"phase": "build", "ptxas_bloom_kernel": usage})


def _select_pair(url, pri, valid, k, unaligned=False):
    """Kernel and plain version of frontier_select on the same inputs;
    returns the largest absolute difference over every output."""
    import torch
    from repro_torch.kernels.frontier_select.ops import select
    from repro_torch.kernels.frontier_select.ref import select_ref
    u, p1, v1 = pop_tensors(url, pri, valid, unaligned)
    p2, v2 = p1.clone(), v1.clone()
    got = select(u, p1, v1, k=k, return_idx=True)
    want = select_ref(u, p2, v2, k=k, return_idx=True)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("sel_url", "sel_pri", "sel_mask", "idx", "pri'",
                           "valid'"), (*got, p1, v1), (*want, p2, v2)):
        if not torch.equal(a, b):
            raise AssertionError(f"frontier_select {tuple(url.shape)} k={k}:"
                                 f" {name} differs from the plain version")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def _bloom_pair(bits, urls, mask, k, *, packed=False):
    """bloom (or, ``packed``, bloom_packed on the words of ``bits``) and its
    plain version on the same inputs."""
    import torch
    from repro_torch.kernels.bloom.ops import probe_insert, probe_insert_packed
    from repro_torch.kernels.bloom.ref import (bloom_packed_ref, bloom_ref,
                                               pack_bits)
    dev = DEV
    name = "bloom_packed" if packed else "bloom"
    b1 = torch.tensor(bits, device=dev)
    if packed:
        b1 = pack_bits(b1)
    b2 = b1.clone()
    u = torch.tensor(urls, device=dev)
    m = torch.tensor(mask, device=dev)
    fn, ref = ((probe_insert_packed, bloom_packed_ref) if packed else
               (probe_insert, bloom_ref))
    s1 = fn(b1, u, m, k=k)
    s2 = ref(b2, u, m, k=k, url_tile=min(256, u.shape[1]))
    torch.cuda.synchronize()
    if not torch.equal(s1, s2):
        raise AssertionError(f"{name} {tuple(urls.shape)} k={k}: seen differs")
    if not torch.equal(b1, b2):
        raise AssertionError(f"{name} {tuple(urls.shape)} k={k}: the filter "
                             f"differs")
    return max(float((s1.int() - s2.int()).abs().max()),
               float((b1.long() - b2.long()).abs().max())), int(s1.sum())


def _harvest_pair(url, pri, valid, k, unaligned=False):
    """select_harvest and its plain version on the url lane as the stages
    hold it (a strided view of a wider array, 0 cash on invalid cells)."""
    import torch
    from repro_torch.kernels.frontier_select.ops import select_harvest
    from repro_torch.kernels.frontier_select.ref import select_harvest_ref
    dev = DEV
    R, C = url.shape
    lane = np.random.default_rng(R + C).random((R, C)) * valid
    w1 = torch.zeros((R, 2 + C), device=dev)
    w1[:, 2:] = torch.tensor(lane, dtype=torch.float32, device=dev)
    u, p1, v1 = pop_tensors(url, pri, valid, unaligned)
    p2, v2, w2 = p1.clone(), v1.clone(), w1.clone()
    got = select_harvest(u, p1, v1, w1[:, 2:], k=k)
    want = select_harvest_ref(u, p2, v2, w2[:, 2:], k=k)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("sel_url", "sel_pri", "sel_mask", "idx", "cash",
                           "pri'", "valid'", "order_state'"),
                          (*got, p1, v1, w1), (*want, p2, v2, w2)):
        if not torch.equal(a, b):
            raise AssertionError(f"select_harvest {(R, C)} k={k}: {name} "
                                 f"differs from the plain version")
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def _scatter_pair(B, R, N, tile, rng, *, aligned=False, skew=None):
    """opic_update and its plain version: duplicate targets, rows that wrap
    or fall out of range, a fully masked batch row. ``aligned``: the url
    lane's row-aligned cells form (B rows of R cells, strided view).
    ``skew``: "half" sends every other item to one target, "one" every
    item. Returns (max |diff|, the longest per-target chain)."""
    import torch
    from repro_torch.kernels.opic_update.ops import (scatter_cash,
                                                     scatter_cash_cells)
    from repro_torch.kernels.opic_update.ref import opic_ref
    dev = DEV
    rows = rng.integers(-R - 2, R + 2, (B, N))
    if skew == "half":
        rows[:, ::2] = R // 3
    elif skew == "one":
        rows[:] = R - 1 if aligned else -1      # -1 wraps to R - 1
    rows = torch.tensor(rows, device=dev)
    contrib = torch.tensor(rng.random((B, N)) * 10.0 ** rng.integers(
        -6, 3, (B, N)), dtype=torch.float32, device=dev)
    mask = torch.tensor(rng.random((B, N)) < 0.8, device=dev)
    if B > 1:
        mask[-1] = False
    if aligned:
        w1 = torch.zeros((B, 2 + R), device=dev)
        w1[:, 2:] = torch.tensor(rng.random((B, R)), dtype=torch.float32,
                                 device=dev)
        w2 = w1.clone()
        scatter_cash_cells(w1[:, 2:], None, rows, contrib, mask, tile=tile)
        ok = mask & (rows >= 0) & (rows < R)
        opic_ref(w2[:, 2:], rows, contrib, ok, tile=tile)
        a, b = w1, w2
    else:
        a = torch.tensor(rng.random((B, R)), dtype=torch.float32, device=dev)
        b = a.clone()
        scatter_cash(a, rows, contrib, mask, tile=tile)
        opic_ref(b, rows, contrib, mask, tile=tile)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        raise AssertionError(f"opic_update {(B, R, N)} tile={tile} "
                             f"aligned={aligned} skew={skew}: differs from "
                             f"the plain version")
    ok = mask & (rows >= (0 if aligned else -R)) & (rows < R)
    return (float((a.double() - b.double()).abs().max()),
            max_items_per_target(a[:, 2:] if aligned else a, rows, ok))


def max_items_per_target(cash, rows, live):
    """The longest per-target chain of a scatter: the most live items that
    one (batch row, target) receives."""
    import torch
    B, R = cash.shape
    tgt = torch.where(rows < 0, rows + R, rows)
    flat = (torch.arange(B, device=rows.device)[:, None] * R + tgt)[live]
    return int(torch.bincount(flat).max()) if flat.numel() else 0


def dedup_batch(rng, R, M, C, b, *, dup=0.5, k=4):
    """A dispatch-like batch with planted queued twins (one URL queued
    twice per row), URLs inserted before and gone, fresh URLs, repeats
    within and across tiles, and a fully masked row. Returns numpy
    (bits, urls, mask, val, f_url, f_valid, lane)."""
    import torch
    from repro_torch.kernels.bloom.ref import bloom_ref
    f_url = rng.integers(1, 1 << 20, (R, C))
    f_url[:, 1] = f_url[:, 2]
    f_valid = rng.random((R, C)) < 0.7
    gone = rng.integers(1 << 20, 1 << 21, (R, M))
    pick = rng.random((R, M))
    queued = np.take_along_axis(f_url, rng.integers(0, C, (R, M)), axis=1)
    urls = np.where(pick < dup / 2, queued,
                    np.where(pick < dup, gone,
                             rng.integers(1 << 21, 1 << 22, (R, M))))
    h = M // 2
    urls[:, h:] = np.where(rng.random((R, M - h)) < dup, urls[:, :M - h],
                           urls[:, h:])
    mask = rng.random((R, M)) < 0.8
    if R > 1:
        mask[-1] = False
    bits = torch.zeros((R, 1 << b), dtype=torch.uint8)
    bloom_ref(bits, torch.tensor(np.concatenate([f_url, gone], 1)),
              torch.tensor(np.concatenate([f_valid, np.ones_like(mask)], 1)),
              k=k)
    val = rng.random((R, M)).astype(np.float32)
    lane = (rng.random((R, C)) * f_valid).astype(np.float32)
    return bits.numpy(), urls, mask, val, f_url, f_valid, lane


def _dedup_pair(bits, urls, mask, val, f_url, f_valid, lane, k, tile=256,
                *, packed=False):
    """dedup_deposit (or, ``packed``, dedup_deposit_packed on the words of
    ``bits``) and its plain version on the same inputs."""
    import torch
    from repro_torch.kernels.bloom.ref import pack_bits
    from repro_torch.kernels.dedup_deposit.ops import (dedup_deposit,
                                                       dedup_deposit_packed)
    from repro_torch.kernels.dedup_deposit.ref import (
        dedup_deposit_packed_ref, dedup_deposit_ref)
    dev = DEV
    kname = "dedup_deposit_packed" if packed else "dedup_deposit"
    R, C = f_url.shape
    t = [torch.tensor(a, device=dev) for a in (urls, mask, val, f_url,
                                                f_valid)]
    b1 = torch.tensor(bits, device=dev)
    if packed:
        b1 = pack_bits(b1)
    w1 = torch.zeros((R, 2 + C), device=dev)
    w1[:, 2:] = torch.tensor(lane, device=dev)
    b2, w2 = b1.clone(), w1.clone()
    fn, ref = ((dedup_deposit_packed, dedup_deposit_packed_ref) if packed
               else (dedup_deposit, dedup_deposit_ref))
    s1, r1 = fn(b1, *t, w1[:, 2:], k=k, url_tile=tile)
    s2, r2 = ref(b2, *t, w2[:, 2:], k=k, url_tile=min(tile, urls.shape[1]))
    torch.cuda.synchronize()
    for name, a, b in (("seen", s1, s2), ("filter", b1, b2),
                       ("order_state", w1, w2), ("refund", r1, r2)):
        if not torch.equal(a, b):
            raise AssertionError(f"{kname} {tuple(urls.shape)} C={C}:"
                                 f" {name} differs from the plain version")
    n_hit = int((w1[:, 2:] != torch.tensor(lane, device=dev)).sum())
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in ((s1, s2), (b1, b2), (w1, w2), (r1, r2)))
    return err, int(s1.sum()), n_hit


def set_bit31(bits):
    """Bit 31 of every other 32-bit word set, so packed words go negative
    as int32."""
    bits = bits.copy()
    bits[:, 31::64] = 1
    return bits


def phase_parity():
    rng = np.random.default_rng(SEED)
    out = {"phase": "parity", "tolerance": "exact (max_abs_err 0)"}
    # frontier_select and select_harvest: the main path's (512, 4096, k=1),
    # then small shapes with ties; C not a multiple of 4 (the scalar path),
    # k = C, unaligned views (the scalar path at C % 4 == 0), rows past
    # register residency (C > 8192: keys in shared memory; 70000: a read of
    # the row a round), fewer valid cells than k ("sparse"), an all-equal
    # row, the CLI's and the reduced config's widths (several rows a block)
    from repro_torch.kernels.frontier_select.ops import vector_path
    pops = [(512, 4096, 1, False, None), (4, 64, 1, True, None),
            (4, 64, 4, True, None), (2, 128, 8, True, None),
            (3, 37, 4, False, None), (2, 128, 8, False, None),
            (1, 32, 1, True, None), (3, 1001, 5, False, None),
            (2, 37, 37, False, None), (4, 4096, 3, False, "unaligned"),
            (2, 16384, 4, False, None), (2, 20000, 3, True, None),
            (2, 70000, 3, False, None), (4, 128, 8, False, "sparse"),
            (3, 256, 6, True, "equal"), (64, 512, 1, False, None),
            (16, 64, 1, False, None), (64, 512, 3, True, None),
            (16, 64, 5, False, None)]
    for name, pair in (("frontier_select", _select_pair),
                       ("select_harvest", _harvest_pair)):
        err, cases = 0.0, []
        for R, C, k, ties, layout in pops:
            rows_ = frontier_rows(rng, R, C, ties=ties, equal=layout ==
                                  "equal",
                                  fill=0.03 if layout == "sparse" else 0.6)
            unaligned = layout == "unaligned"
            err = max(err, pair(*rows_, k, unaligned))
            vec = vector_path(*pop_tensors(*rows_, unaligned)[1:])
            cases.append((R, C, k, ties, layout, vec))
        if {c[-1] for c in cases} != {True, False}:
            raise AssertionError(f"{name}: the parity cases do not reach "
                                 f"both the vector and the scalar path")
        out[name] = {"max_abs_err": err, "cases": cases,
                     "case_fields": ["R", "C", "k", "ties", "layout",
                                     "vector_path"]}
    # bloom: the main path's (R, 4096) at b=24, k=4 on a 16-row slice of
    # the filter (pre-filled so seen is often true), then small shapes
    R, M, b, k = 16, 4096, 24, 4
    bits = np.zeros((R, 1 << b), np.uint8)
    from repro_torch.kernels.bloom.ref import bloom_ref
    import torch
    pre_u, pre_m = bloom_batch(rng, R, M)
    bt = torch.tensor(bits)
    bloom_ref(bt, torch.tensor(pre_u), torch.tensor(pre_m), k=k)
    urls, mask = bloom_batch(rng, R, M)
    urls[:, ::3] = pre_u[:, ::3]            # a third were inserted before
    urls_main, mask_main = urls, mask
    err, n_seen = _bloom_pair(bt.numpy(), urls, mask, k)
    cases = [(R, M, b, k, n_seen)]
    for R, M, b, k, dup in [(1, 256, 10, 2, 0.5), (4, 256, 12, 4, 0.3),
                            (2, 512, 14, 3, 0.6), (8, 512, 11, 5, 0.3),
                            (3, 300, 10, 4, 0.5), (2, 100, 9, 4, 0.9)]:
        urls, mask = bloom_batch(rng, R, M, dup=dup)
        e, n_seen = _bloom_pair(np.zeros((R, 1 << b), np.uint8), urls, mask,
                                k)
        err = max(err, e)
        cases.append((R, M, b, k, n_seen))
    # sparse rows: ~8 live lanes scattered over 16 tiles, each tile walked
    # after the one before inserted; URLs from a pool of 16, so that later
    # tiles re-send earlier ones
    urls, mask = bloom_batch(rng, 64, 4096, fill=0.002)
    sparse = (urls % 16, mask)
    e, n_seen = _bloom_pair(np.zeros((64, 1 << 12), np.uint8), *sparse, 4)
    err = max(err, e)
    cases.append((64, 4096, 12, 4, n_seen))
    out["bloom"] = {"max_abs_err": err, "cases": cases}
    # bloom_packed: the same main-path slice on its words, then small
    # shapes: rows of 1, 2 and 4 words (every URL of a tile collides),
    # repeats within and across tiles, ragged M, a fully masked row, words
    # with bit 31 set, a quarter of the lanes inserted before
    err, n_seen = _bloom_pair(bt.numpy(), urls_main, mask_main, 4,
                              packed=True)
    cases = [(16, 4096, 24, 4, n_seen)]
    for R, M, b, k, dup in [(1, 256, 5, 2, 0.5), (4, 256, 6, 4, 0.3),
                            (2, 512, 7, 3, 0.6), (8, 512, 11, 5, 0.3),
                            (3, 300, 10, 4, 0.5), (2, 100, 9, 4, 0.9)]:
        urls, mask = bloom_batch(rng, R, M, dup=dup)
        pre = torch.zeros((R, 1 << b), dtype=torch.uint8)
        bloom_ref(pre, torch.tensor(urls[:, ::4]),
                  torch.ones(urls[:, ::4].shape, dtype=torch.bool), k=k)
        e, n_seen = _bloom_pair(set_bit31(pre.numpy()), urls, mask, k,
                                packed=True)
        err = max(err, e)
        cases.append((R, M, b, k, n_seen))
    e, n_seen = _bloom_pair(set_bit31(np.zeros((64, 1 << 12), np.uint8)),
                            *sparse, 4, packed=True)
    err = max(err, e)
    cases.append((64, 4096, 12, 4, n_seen))
    out["bloom_packed"] = {"max_abs_err": err, "cases": cases}
    # dedup_deposit: the dispatch's (16 rows of the 512) x M 4096 against
    # queues of C 4096 at b=24, k=4, then small shapes and tiles
    err, cases = 0.0, []
    for R, M, C, b, k, tile, dup in [
            (16, 4096, 4096, 24, 4, 256, 0.3), (1, 64, 32, 10, 3, 32, 0.5),
            (4, 96, 64, 12, 3, 32, 0.5), (3, 300, 50, 10, 4, 128, 0.6),
            (2, 100, 40, 9, 4, 256, 0.9), (4, 256, 8, 12, 4, 64, 0.9)]:
        e, n_seen, n_hit = _dedup_pair(*dedup_batch(rng, R, M, C, b, dup=dup,
                                                    k=k), k, tile)
        if n_seen == 0 or n_hit == 0:
            raise AssertionError(f"dedup_deposit parity {(R, M, C)} hit no "
                                 f"seen URL or no queued twin")
        err = max(err, e)
        cases.append((R, M, C, b, k, tile, n_seen, n_hit))
    out["dedup_deposit"] = {"max_abs_err": err, "cases": cases}
    # dedup_deposit_packed: the same shapes, rows of one word among them,
    # words with bit 31 set
    err, cases = 0.0, []
    for R, M, C, b, k, tile, dup in [
            (16, 4096, 4096, 24, 4, 256, 0.3), (1, 64, 32, 10, 3, 32, 0.5),
            (4, 96, 64, 12, 3, 32, 0.5), (3, 300, 50, 10, 4, 128, 0.6),
            (2, 100, 40, 5, 4, 256, 0.9), (4, 256, 8, 6, 4, 64, 0.9)]:
        bits, *rest = dedup_batch(rng, R, M, C, b, dup=dup, k=k)
        e, n_seen, n_hit = _dedup_pair(set_bit31(bits), *rest, k, tile,
                                       packed=True)
        if n_seen == 0 or n_hit == 0:
            raise AssertionError(f"dedup_deposit_packed parity {(R, M, C)} "
                                 f"hit no seen URL or no queued twin")
        err = max(err, e)
        cases.append((R, M, C, b, k, tile, n_seen, n_hit))
    out["dedup_deposit_packed"] = {"max_abs_err": err, "cases": cases}
    # opic_update: the opic spend (1 x 8192 items onto 512 slots), the url
    # lane's cells (512 rows of 4096 cells, 4096 items a row), then small
    # shapes; then the spend skewed (half the items on one target), every
    # item on one target, N past one chunk (8192 items), R past one range
    # (4096 targets) with B = 1 and B > 1, and the strided lane
    err, cases = 0.0, []
    for B, R, N, tile, aligned, skew in [
            (1, 512, 8192, 256, False, None),
            (512, 4096, 4096, 256, True, None),
            (3, 5, 300, 64, False, None), (2, 64, 77, 256, False, None),
            (4, 3, 40, 16, False, None), (5, 16, 40, 16, True, None),
            (1, 512, 8192, 256, False, "half"),
            (1, 512, 8192, 256, False, "one"),
            (3, 64, 4000, 32, False, "one"),
            (2, 100, 20000, 1024, False, None),
            (1, 300, 17000, 256, False, "half"),
            (1, 10000, 3000, 256, False, None),
            (3, 9000, 5000, 128, False, None),
            (4, 5000, 9000, 256, True, "half"),
            (64, 4096, 4096, 256, True, "one")]:
        e, chain = _scatter_pair(B, R, N, tile, rng, aligned=aligned,
                                 skew=skew)
        err = max(err, e)
        cases.append((B, R, N, tile, aligned, skew, chain))
    out["opic_update"] = {"max_abs_err": err, "cases": cases,
                          "case_fields": ["B", "R", "N", "tile", "aligned",
                                          "skew", "max_items_per_target"]}
    emit(out)
    return {name: out[name]["max_abs_err"] for name in
            ("frontier_select", "select_harvest", "bloom", "dedup_deposit",
             "opic_update", "bloom_packed", "dedup_deposit_packed")}


# flash_attention against its plain version: the reference's tolerances
# (tests/test_kernels.py), as |got - want| <= tol + tol * |want|
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# flash_attention_tc also against tc_plain, the plain arithmetic that rounds
# p to bf16 for p.v as the kernel does: |got - want| <= TC_ULPS bf16 ulps of
# |want| (the output's own rounding, f32 sums in another order) + TC_FLIPS
# * 2^-7 * max|v| / l. The second term allows TC_FLIPS p's whose f32 value,
# summed in another order, rounds to the other bf16 neighbour: each moves
# the output by at most one bf16 ulp of p_j (<= 2^-7 p_j, and p_j <= 1)
# times |v_j| / l, l the row's softmax sum in units of its largest term.
TC_ULPS, TC_FLIPS = 2, 2


def tc_plain(q, k, v, causal, block=64):
    """What flash_attention_tc computes, in plain PyTorch, in f32: the
    online softmax over ``block``-key tiles in order, the scores scaled by
    1/sqrt(hd) and log2(e) in f32, p = exp2(s - m) with the running max m, l
    the sum of the f32 p, acc += bf16(p) . v. Returns acc / max(l, 1e-30),
    (B, Hq, Sq, hd), and l (B, Hq, Sq, 1). The only differences from
    flash_ref are p's rounding and the exp2 form."""
    import math
    import torch
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    f32 = torch.float32
    qf = q.to(f32)
    kf = k.to(f32).repeat_interleave(Hq // Hkv, dim=1)
    vf = v.to(f32).repeat_interleave(Hq // Hkv, dim=1)
    scale2 = (torch.tensor(1 / math.sqrt(hd), dtype=f32)
              * torch.tensor(1.4426950408889634, dtype=f32)).item()
    m = torch.full((B, Hq, Sq, 1), -1e30, dtype=f32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hq, Sq, hd), dtype=f32, device=q.device)
    rows = torch.arange(Sq, device=q.device)[:, None]
    for k0 in range(0, Skv, block):
        kt, vt = kf[:, :, k0:k0 + block], vf[:, :, k0:k0 + block]
        s = (qf @ kt.transpose(-1, -2)) * scale2
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2], device=q.device)
            s = s.masked_fill(rows < cols, -1e30)
        n = torch.maximum(m, s.amax(-1, keepdim=True))
        c = torch.exp2(m - n)
        p = torch.exp2(s - n)
        l = l * c + p.sum(-1, keepdim=True)
        acc = acc * c + p.to(torch.bfloat16).to(f32) @ vt
        m = n
    return acc / l.clamp_min(1e-30), l


def tc_share(got, q, k, v, causal):
    """The largest |got - want| / tol over the output, want from tc_plain
    and tol as TC_ULPS and TC_FLIPS state it: at most 1 passes."""
    import torch
    want, l = tc_plain(q, k, v, causal)
    a = want.abs()
    _, e = torch.frexp(a)
    ulp = torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8),
                      torch.zeros_like(a))
    vmax = v.float().abs().amax(dim=2, keepdim=True).repeat_interleave(
        q.shape[1] // k.shape[1], dim=1)
    tol = TC_ULPS * ulp + TC_FLIPS * 2.0 ** -7 * vmax / l
    return float(((got - want).abs() / tol.clamp_min(1e-30)).max())


def flash_inputs(rng, B, Hq, Hkv, S, hd, dtype, *, strided=True):
    """q (B, Hq, S, hd), k, v (B, Hkv, S, hd) on the card, drawn with
    numpy; ``strided`` lays them out as the projections do, (B, S, H, hd)
    transposed."""
    import torch
    dt = getattr(torch, dtype)
    out = []
    for H in (Hq, Hkv, Hkv):
        x = torch.tensor(rng.standard_normal((B, S, H, hd)),
                         dtype=torch.float32, device=DEV).to(dt)
        out.append(x.transpose(1, 2) if strided else
                   x.transpose(1, 2).contiguous())
    return out


def flash_pair(q, k, v, causal, label, kernel=None):
    """A kernel and the plain version on the same inputs: the kernel that
    ``attention`` routes to (checked to be the one that launched, once), or
    ``kernel`` launched directly. Raises past the dtype's tolerance, on a
    non-finite output, and for flash_attention_tc past the tolerance from
    tc_plain (``tc_share`` above 1); returns (kernel name, max |diff| from
    the plain version, ``tc_share`` or None)."""
    from repro_torch.kernels.flash_attention import ops as FA
    if kernel is None:
        kernel = FA.route(q.device.type, q.dtype, q.shape[3])
        before = (FA.KERNEL.launches, FA.TC_KERNEL.launches)
        got = FA.attention(q, k, v, causal=causal)
        after = (FA.KERNEL.launches, FA.TC_KERNEL.launches)
        want_after = tuple(c + (kern is kernel) for c, kern in
                           zip(before, (FA.KERNEL, FA.TC_KERNEL)))
        if after != want_after:
            raise AssertionError(f"flash_attention {label}: routed to "
                                 f"{kernel.name}, but launches went "
                                 f"{before} -> {after}")
    else:
        got = FA.launch(kernel, q, k, v, causal)
    return (kernel.name,) + hold_flash(got, q, k, v, causal,
                                       f"{kernel.name} {label}",
                                       tc=kernel is FA.TC_KERNEL)


def hold_flash(got, q, k, v, causal, label, tc):
    """A kernel's output ``got`` on q, k, v held to the plain version:
    raises past the dtype's tolerance, on a non-finite output, and for
    flash_attention_tc (``tc``) past the tolerance from tc_plain
    (``tc_share`` above 1); returns (max |diff|, ``tc_share`` or None)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_ref
    qg, kf, vf, group = FA._gqa_fold(q, k, v)
    want = flash_ref(qg, kf, vf, causal=causal, group=group
                     ).reshape(q.shape)
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    tol = FLASH_TOL[str(q.dtype).split(".")[-1]]
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    excess = (got - want).abs() - tol * (1 + want.abs())
    if float(excess.max()) > 0:
        raise AssertionError(f"{label}: differs from the plain version "
                             f"beyond {tol}: max |diff| "
                             f"{float((got - want).abs().max())}")
    share = None
    if tc:
        share = tc_share(got, q, k, v, causal)
        if share > 1:
            raise AssertionError(f"{label}: {share} times the tolerance "
                                 f"from tc_plain")
    return float((got - want).abs().max()), share


def phase_flash_parity():
    """Both attention kernels against the plain version on small cases:
    every head dim, GQA groups 1, 3 and 6, lengths 32, 192 (ragged tiles)
    and 256, causal on and off, f32 and bf16, strided and contiguous
    layouts. Each case goes through ``attention``, which must launch the
    kernel its route names (bf16 at 64/96/128: flash_attention_tc; the
    rest: flash_attention); the bf16 cases at those head dims also run
    flash_attention, launched directly, so it stays held at every head dim
    it instantiates."""
    from repro_torch.kernels.flash_attention import ops as FA
    rng = np.random.default_rng(SEED + 3)
    errs = {FA.KERNEL.name: {"float32": 0.0, "bfloat16": 0.0},
            FA.TC_KERNEL.name: {"bfloat16": 0.0}}
    tc_max_share = 0.0
    n, routed = 0, Counter()
    for hd in (8, 16, 32, 64, 96, 128):
        for group in (1, 3, 6):
            for S in (32, 192, 256):
                for causal in (True, False):
                    for dtype in ("float32", "bfloat16"):
                        q, k, v = flash_inputs(rng, 2, 2 * group, 2, S, hd,
                                               dtype, strided=n % 2 == 0)
                        label = (f"hd={hd} group={group} S={S} "
                                 f"causal={causal} {dtype}")
                        name, e, share = flash_pair(q, k, v, causal,
                                                    label)
                        routed[name] += 1
                        errs[name][dtype] = max(errs[name][dtype], e)
                        if name == FA.TC_KERNEL.name:
                            tc_max_share = max(tc_max_share, share)
                            _, e, _ = flash_pair(q, k, v, causal, label,
                                                 kernel=FA.KERNEL)
                            errs[FA.KERNEL.name][dtype] = max(
                                errs[FA.KERNEL.name][dtype], e)
                        n += 1
    out = {"phase": "flash_parity", "cases": n, "routed": dict(routed),
           "max_abs_err": errs,
           "tolerance": "|got - want| <= tol * (1 + |want|), tol "
                        f"{FLASH_TOL}",
           "tc_max_share_of_tc_plain_tolerance": tc_max_share,
           "tc_tolerance": f"|got - tc_plain| <= {TC_ULPS} bf16 ulps of "
                           f"|want| + {TC_FLIPS} * 2^-7 * max|v| / l"}
    emit(out)
    return out


# the LM serving path: qwen2-1.5b at full width, prefill_32k's shape cut
# from batch 32 x 32768 to batch 4 x 2048, then 32 greedy tokens; the
# kernel's timings and parity run at this shape. A second serve keeps
# prefill_32k's length with the batch cut to 1 (32 x 32768 in one prefill
# would not fit the card's memory).
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "qwen2-1.5b", 4, 2048, 32
LM_LONG_PROMPT, LM_LONG_GEN = 32768, 8
LM_CPU_TOL = 1e-4                   # cuda vs cpu logits, reduced f32 model
LM_CPU_ARCHS = (LM_ARCH, "phi3-mini-3.8b", "deepseek-coder-33b")
SPLIT_TF32_PASSES = 3               # hi.hi + hi.lo + lo.hi per f32 product


def capture_flash(model, prompts, layers):
    """{layer: (q, k, v)} as one prefill hands them to ``flash_attention``
    at the given layers."""
    import itertools
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import transformer as T
    call = itertools.count()
    picked = sorted(layers)
    got = capture_calls([FA], "attention",
                        lambda: T.prefill_step(model, prompts), len(picked),
                        pick=lambda args: next(call) in layers)
    return {layer: tuple(args[:3]) for layer, (args, _) in zip(picked, got)}


def profile_lm(model, prompts, decode_steps=4):
    """One prefill, then ``decode_steps`` decode steps, each under
    torch.profiler: the device's busy time, its idle share, the device
    events (kernels and copies) per call, and the kernels that took most
    of the time."""
    from repro_torch.models import transformer as T
    P = prompts.shape[1]
    pre = profile_device(lambda: T.prefill_step(model, prompts), 1)
    logits, cache = T.prefill_step(model, prompts, max_len=P + decode_steps)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)

    def decode():
        nonlocal cache
        for _ in range(decode_steps):
            _, cache = T.decode_step(model, tok, cache)
    return {"prefill": pre, "decode": profile_device(decode, decode_steps)}


def profile_device(fn, calls):
    """``fn()`` (``calls`` calls of the path) under torch.profiler: the
    device's busy time over the wall time (the profiler's own overhead
    included), so its idle share, the device events, the kernels that took
    most of the time and the host's runtime calls, each per call. NCCL
    kernels count as events, and their time (mostly the wait for the
    other ranks) as ``collective_ms_per_call``, not as busy time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    per_name, n, runtime, port = {}, 0, Counter(), {}
    coll_us = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            n += 1
            if "nccl" in e.name.lower():
                # a collective's kernel spins until its peers arrive: its
                # span is waiting, not work, and is reported on its own
                coll_us += us
                continue
            per_name[e.name] = per_name.get(e.name, 0.0) + us
            if any(f in e.name for f in PORT_KERNEL_FNS):
                c = port.setdefault(e.name[:120], [0, 0.0])
                c[0] += 1
                c[1] += us
        elif e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaMemcpyAsync", "cudaLaunchKernel"):
            runtime[e.name] += 1
    busy_us = sum(per_name.values())
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_ms_per_call": wall_us / 1e3 / calls,
            "device_events_per_call": n / calls,
            "device_busy_ms_per_call": busy_us / 1e3 / calls,
            "device_idle_share": 1 - busy_us / wall_us if n else None,
            "top_device_ms_per_call": {k[:80]: v / 1e3 / calls
                                       for k, v in top},
            "runtime_calls_per_call": {k: v / calls
                                       for k, v in runtime.items()},
            "collective_ms_per_call": coll_us / 1e3 / calls,
            "port_kernels": {k: {"launches": c, "ms_per_launch": us / 1e3 / c}
                             for k, (c, us) in port.items()}}


# the device functions of the port's crawl kernels, as the profiler names
# them (each launch wrapper's kernel name, without its template arguments)
PORT_KERNEL_FNS = {"frontier_select": "frontier_select_kernel",
                   "select_harvest": "select_harvest_kernel",
                   "bloom": "bloom_kernel", "dedup_deposit":
                   "dedup_deposit_kernel", "opic_update": "opic_update_kernel"}


def in_crawl_ms(prof, name):
    """Mean device ms of one launch of kernel ``name`` inside a profiled
    crawl (``profile_device``'s ``port_kernels``); None if it never ran."""
    hits = [v for k, v in prof["port_kernels"].items()
            if PORT_KERNEL_FNS[name] in k]
    n = sum(v["launches"] for v in hits)
    return (sum(v["ms_per_launch"] * v["launches"] for v in hits) / n
            if n else None)


def check_prefill_launches(counts, n_layers, label):
    """One bf16 prefill at hd 128 launches flash_attention_tc once per
    layer and the f32 route's flash_attention never."""
    if counts["flash_attention_tc"] != n_layers or \
            counts["flash_attention"] != 0:
        raise AssertionError(f"{label}: want {n_layers} flash_attention_tc "
                             f"and 0 flash_attention launches in one "
                             f"prefill of {n_layers} layers: {counts}")


def phase_lm_serve():
    """Qwen2-1.5B at full width (28 layers, d 1536, 12/2 heads, hd 128,
    vocab 151936) from the port's seeded init, bf16 on the card: a first
    prefill captures layer 0's and the last layer's attention inputs, a
    short serve warms up, then the counted run: ``serve`` of LM_BATCH x
    LM_PROMPT prompts and LM_GEN tokens, counts zeroed just before it and
    read just after. Fails on non-finite logits (``serve`` raises) and
    unless prefill launched flash_attention_tc once per layer (and
    flash_attention never)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer as T
    cfg = get_arch(LM_ARCH)[0]
    t0 = time.time()
    model = T.init_lm(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    prompts = torch.tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PROMPT)), device=DEV)
    captured = capture_flash(model, prompts, {0, cfg.n_layers - 1})
    serve(model, prompts, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, t_pre, t_dec = serve(model, prompts, LM_GEN)
    counts = launch_counts()
    check_prefill_launches(counts, cfg.n_layers, "lm")
    if toks.shape != (LM_BATCH, LM_GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"lm: tokens malformed: {tuple(toks.shape)}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = profile_lm(model, prompts)
    out = {"phase": "lm_serve", "arch": LM_ARCH,
           "config": dataclasses.asdict(cfg), "n_params": cfg.n_params,
           "batch": LM_BATCH, "prompt_len": LM_PROMPT, "gen": LM_GEN,
           "init_s": init_s, "prefill_ms": 1e3 * t_pre,
           "decode_ms_per_token": 1e3 * t_dec / (LM_GEN - 1),
           "generated_tok_per_s": LM_BATCH * LM_GEN / (t_pre + t_dec),
           "decode_tok_per_s": LM_BATCH * (LM_GEN - 1) / t_dec,
           "prefill_tok_per_s": LM_BATCH * LM_PROMPT / t_pre,
           "peak_mem_gib": peak, "launches": counts,
           "first_tokens": toks[:, :8].tolist(), "profile": prof}
    emit(out)
    return model, captured, counts


def phase_lm_captured(captured):
    """Both attention kernels against the plain version on the attention
    inputs that the full-width prefill itself produced: as captured (bf16,
    routed to flash_attention_tc, which is also held to tc_plain; and
    flash_attention launched directly on the same inputs), and cast to
    f32 (routed to flash_attention, where both compute the same f32
    arithmetic, held to the f32 tolerance over the whole length of the
    prefill). Returns each kernel's
    max |diff| in bf16, the path's dtype."""
    from repro_torch.kernels.flash_attention import ops as FA
    out = {"phase": "lm_captured_parity", "tolerance": FLASH_TOL}
    errs = {FA.TC_KERNEL.name: 0.0, FA.KERNEL.name: 0.0}
    for layer, (q, k, v) in sorted(captured.items()):
        shape = f"layer {layer} {tuple(q.shape)}"
        name, e, share = flash_pair(q, k, v, True, f"{shape} {q.dtype}")
        if name != FA.TC_KERNEL.name:
            raise AssertionError(f"{shape}: bf16 routed to {name}")
        _, e_core, _ = flash_pair(q, k, v, True, f"{shape} {q.dtype}",
                                  kernel=FA.KERNEL)
        name32, e32, _ = flash_pair(q.float(), k.float(), v.float(), True,
                                    f"{shape} as float32")
        if name32 != FA.KERNEL.name:
            raise AssertionError(f"{shape}: f32 routed to {name32}")
        out[f"layer_{layer}"] = {"shape_q": list(q.shape),
                                 "shape_kv": list(k.shape),
                                 "dtype": str(q.dtype), "max_abs_err": e,
                                 "share_of_tc_plain_tolerance": share,
                                 "max_abs_err_cuda_core_bf16": e_core,
                                 "max_abs_err_float32": e32}
        errs[FA.TC_KERNEL.name] = max(errs[FA.TC_KERNEL.name], e)
        errs[FA.KERNEL.name] = max(errs[FA.KERNEL.name], e_core)
    emit(out)
    return errs


def phase_lm_long(model):
    """One ``serve`` at prefill_32k's prompt length (LM_LONG_PROMPT) with
    the batch cut to 1: counts zeroed just before it and read just after,
    one flash_attention_tc launch per layer, finite logits."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    prompts = torch.tensor(np.random.default_rng(SEED + 5).integers(
        0, cfg.vocab_size, (1, LM_LONG_PROMPT)), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, t_pre, t_dec = serve(model, prompts, LM_LONG_GEN)
    counts = launch_counts()
    check_prefill_launches(counts, cfg.n_layers, "lm_long")
    if toks.shape != (1, LM_LONG_GEN):
        raise AssertionError(f"lm_long: tokens malformed: "
                             f"{tuple(toks.shape)}")
    emit({"phase": "lm_long", "arch": LM_ARCH, "batch": 1,
          "prompt_len": LM_LONG_PROMPT, "gen": LM_LONG_GEN,
          "prefill_ms": 1e3 * t_pre,
          "decode_ms_per_token": 1e3 * t_dec / (LM_LONG_GEN - 1),
          "prefill_tok_per_s": LM_LONG_PROMPT / t_pre,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": counts, "tokens": toks.tolist()})


def phase_lm_cpu(arch=LM_ARCH, steps=16):
    """The reduced ``arch`` in f32 with the same weights on the card and
    on the CPU: a 32-token prefill, then ``steps`` teacher-forced decode
    steps; every step's logits must agree within LM_CPU_TOL. TF32 is off:
    it would round the products to 10 bits (flash_attention's split TF32
    is its own, not these flags). This f32 path is flash_attention's:
    counts are zeroed just before the card's run and read just after, one
    launch per layer of its prefill. Returns them."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import transformer as T
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = scaled(get_reduced(arch), dtype="float32")
    cpu = T.init_lm(cfg, seed=SEED, device="cpu")
    card = T.params_from_numpy(cfg, T.params_to_numpy(cpu), device=DEV)
    P = 32
    toks = torch.tensor(np.random.default_rng(SEED + 4).integers(
        0, cfg.vocab_size, (LM_BATCH, P + steps)))
    logits, counts = {}, None
    for name, m in (("cuda", card), ("cpu", cpu)):
        t = toks.to(m.device)
        reset_launches()
        lg, cache = T.prefill_step(m, t[:, :P], max_len=P + steps)
        out = [lg]
        for i in range(P, P + steps):
            lg, cache = T.decode_step(m, t[:, i:i + 1], cache)
            out.append(lg)
        logits[name] = torch.cat(out, 1).cpu()
        counts = launch_counts() if counts is None else counts
    if counts["flash_attention"] != cfg.n_layers or \
            counts["flash_attention_tc"] != 0:
        raise AssertionError(f"lm_cpu: want {cfg.n_layers} flash_attention "
                             f"and 0 flash_attention_tc launches in the f32 "
                             f"prefill: {counts}")
    a, b = logits["cuda"], logits["cpu"]
    err = float((a - b).abs().max())
    if not torch.isfinite(a).all() or err > LM_CPU_TOL:
        raise AssertionError(f"lm {arch}: cuda and cpu logits differ by "
                             f"{err} > {LM_CPU_TOL}")
    emit({"phase": "lm_cpu", "arch": arch,
          "config": dataclasses.asdict(cfg),
          "prefill": P, "decode_steps": steps, "max_abs_err": err,
          "tolerance": LM_CPU_TOL, "argmax_equal": bool(torch.equal(
              a.argmax(-1), b.argmax(-1))), "launches": counts})
    return counts


# the training path: Qwen2-1.5B at full width (bf16, remat on) on the train
# CLI's corpus (its crawl of the reduced webparf config, 60 steps, on the
# card), at train_4k's length with its batch of 256 cut to 4 for the time
# limit, and the CLI's optimizer (AdamW on warmup-cosine from 3e-4, 10
# warmup steps)
TRAIN_SEQ, TRAIN_BATCH, TRAIN_STEPS = 4096, 4, 4
TRAIN_CRAWL_STEPS = 60
TRAIN_LR, TRAIN_WARMUP = 3e-4, 10
# the autograd backward's dq, dk, dv against autograd through flash_ref on
# the same inputs and dO: |got - want| <= tol * max|want| (bf16: the
# gradients' own rounding and the tc forward's p rounding, which enters
# through rowsum(dO * O); f32: the split-TF32 forward's O)
TRAIN_BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the reduced f32 model, card against CPU: each step's loss within
# TRAIN_F32_LOSS_TOL; the final parameters within 2 * sum(lr) (Adam's
# step of +-lr on a gradient whose sign is rounding) and their mean
# |difference| within TRAIN_F32_MEAN_TOL (a wrong step moves every entry by
# ~lr)
TRAIN_F32_STEPS = 20
TRAIN_F32_LOSS_TOL, TRAIN_F32_MEAN_TOL = 1e-4, 1e-6
TRAIN_F32_FAIL_AT, TRAIN_F32_CKPT_EVERY = (8,), 5


def train_bwd_pair(q, k, v, label):
    """The gradient of ``attention`` (the kernel forward, the plain
    backward) against autograd through the plain forward ``flash_ref``,
    on the card, on the same q, k, v and a seeded dO; raises past
    TRAIN_BWD_TOL. Returns each gradient's max |diff|, max |want| and
    share of the tolerance."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_ref
    do = torch.tensor(np.random.default_rng(SEED + 9).standard_normal(
        tuple(q.shape)), dtype=torch.float32, device=DEV).to(q.dtype)

    def grads(fn):
        xs = [x.detach().requires_grad_() for x in (q, k, v)]
        return torch.autograd.grad(fn(*xs), xs, do)

    def plain(a, b, c):
        qg, kf, vf, group = FA._gqa_fold(a, b, c)
        return flash_ref(qg, kf, vf, causal=True,
                         group=group).reshape(a.shape)
    got = grads(lambda a, b, c: FA.attention(a, b, c, causal=True))
    want = grads(plain)
    torch.cuda.synchronize()
    tol = TRAIN_BWD_TOL[str(q.dtype).split(".")[-1]]
    out = {}
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        a, b = a.float(), b.float()
        err, top = float((a - b).abs().max()), float(b.abs().max())
        if not torch.isfinite(a).all() or err > tol * top:
            raise AssertionError(f"flash backward {label} {name}: max "
                                 f"|diff| {err} > {tol} * {top}")
        out[name] = {"max_abs_err": err, "max_abs_want": top,
                     "share_of_tolerance": err / (tol * top)}
    return out


def profile_train_step(step, state, batch):
    """One training step under torch.profiler, the plain attention
    backward marked by a ``record_function`` range: the device's busy
    and idle share, the device events, the top kernels, and the device ms
    of the kernels the marked backward launched. The step's state is
    dropped."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels.flash_attention import ops as FA
    orig = FA.flash_backward

    def marked(*args, **kw):
        with record_function("flash_backward"):
            return orig(*args, **kw)
    FA.flash_backward = marked
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        FA.flash_backward = orig
    per_name, n = Counter(), 0
    bwd_us, bwd_span_us, bwd_calls = 0.0, 0.0, 0
    for e in prof.events():
        if e.name == "flash_backward":
            # the range shows twice: on the host, where its kernels' device
            # time is summed, and as a span on the device's timeline,
            # which is not a kernel
            if e.device_type == DeviceType.CUDA:
                bwd_span_us += e.time_range.elapsed_us()
            else:
                bwd_calls += 1
                bwd_us += e.device_time_total
        elif e.device_type == DeviceType.CUDA:
            per_name[e.name[:80]] += e.time_range.elapsed_us()
            n += 1
    busy = sum(per_name.values())
    return {"wall_ms": wall_us / 1e3, "device_events": n,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1 - busy / wall_us,
            "top_device_ms": {k: v / 1e3
                              for k, v in per_name.most_common(10)},
            "flash_backward_calls": bwd_calls,
            "flash_backward_device_ms": bwd_us / 1e3,
            "flash_backward_span_ms": bwd_span_us / 1e3,
            "flash_backward_share_of_busy": bwd_us / busy if busy else None}


def phase_train():
    """The training path at Qwen2-1.5B's full width (bf16, remat on): the
    train CLI's corpus crawl on the card (counts zeroed just before it,
    read just after: frontier_select and bloom must launch), its pages as
    TRAIN_BATCH x TRAIN_SEQ token batches, TRAIN_STEPS AdamW steps, each
    timed (host clock between synchronisations) with its launches counted
    (zeroed just before the step, read just after): 2 flash_attention_tc
    a layer (the forward and the remat recompute; the backward is plain)
    and nothing else. Layer 0's q, k, v of the first step are captured;
    after the state is freed the kernel forward is held to the plain
    version and the autograd backward to autograd through flash_ref, in
    bf16 and cast to f32. Then a profile of one more step and the plain
    backward's standalone time on the captured call."""
    import torch
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.train import crawl_corpus
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg = get_arch(LM_ARCH)[0]
    if not cfg.remat or cfg.dtype != "bfloat16":
        raise AssertionError(f"train: want bf16 with remat, got {cfg}")
    crawl_cfg = get_reduced("webparf")
    reset_launches()
    t0 = time.perf_counter()
    urls, _ = crawl_corpus(crawl_cfg, TRAIN_CRAWL_STEPS, DEV)
    torch.cuda.synchronize()
    crawl_s = time.perf_counter() - t0
    crawl_counts = launch_counts()
    if not crawl_counts["frontier_select"] or not crawl_counts["bloom"]:
        raise AssertionError(f"train: the corpus crawl launched "
                             f"{crawl_counts}")
    batches = list(lm_batches(urls, crawl_cfg, batch=TRAIN_BATCH,
                              seq_len=TRAIN_SEQ, vocab=cfg.vocab_size,
                              device=DEV))
    if len(batches) < TRAIN_STEPS + 1:
        raise AssertionError(f"train: {len(batches)} batches from "
                             f"{len(urls)} pages")
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device=DEV))
    opt = adamw(lr=warmup_cosine(TRAIN_LR, TRAIN_WARMUP, TRAIN_STEPS))
    step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]), opt)
    state = init_train_state(params, opt)
    del params
    captured = []
    orig = FA.attention

    def spy(q, k, v, **kw):
        if not captured:
            captured.append(tuple(x.detach().clone() for x in (q, k, v)))
        return orig(q, k, v, **kw)
    losses, gnorms, step_ms, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        FA.attention = spy if i == 0 else orig
        try:
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batches[i])
            torch.cuda.synchronize()
            step_ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(launch_counts())
        finally:
            FA.attention = orig
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = {k: 0 for k in per_step[0]}
    want[FA.TC_KERNEL.name] = 2 * cfg.n_layers
    for i, c in enumerate(per_step):
        if c != want:
            raise AssertionError(f"train step {i}: launches {c}, want "
                                 f"{want}")
    if not all(np.isfinite(losses + gnorms)):
        raise AssertionError(f"train: losses {losses}, norms {gnorms}")
    prof = profile_train_step(step, state, batches[TRAIN_STEPS])
    del state, batches, m
    free_card()
    q, k, v = captured[0]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    fwd = {"bfloat16": flash_pair(q, k, v, True, "train layer 0"),
           "float32": flash_pair(q.float(), k.float(), v.float(), True,
                                 "train layer 0 as float32")}
    if fwd["bfloat16"][0] != FA.TC_KERNEL.name or \
            fwd["float32"][0] != FA.KERNEL.name:
        raise AssertionError(f"train: routed {fwd}")
    bwd = {"bfloat16": train_bwd_pair(q, k, v, "bf16"),
           "float32": train_bwd_pair(q.float(), k.float(), v.float(),
                                     "as float32")}
    o = FA.attention(q, k, v, causal=True)
    do = torch.randn_like(o)
    bwd_ms = cuda_ms(lambda: FA.flash_backward(q, k, v, o, do, causal=True),
                     3)
    fwd_ms = cuda_ms(lambda: FA.launch(FA.TC_KERNEL, q, k, v, True), 10)
    steady = step_ms[1:] or step_ms
    out = {"phase": "train", "arch": LM_ARCH,
           "config": dataclasses.asdict(cfg), "n_params": cfg.n_params,
           "batch": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
           "cut": "train_4k's global batch 256 cut to 4 for the time limit",
           "steps": TRAIN_STEPS, "optimizer": f"adamw(warmup_cosine("
           f"{TRAIN_LR}, {TRAIN_WARMUP}, {TRAIN_STEPS}))",
           "corpus": {"crawl_steps": TRAIN_CRAWL_STEPS, "pages": len(urls),
                      "seconds": crawl_s, "launches": crawl_counts},
           "losses": losses, "grad_norms": gnorms, "step_ms": step_ms,
           "tokens_per_s": tokens * len(steady) / (sum(steady) / 1e3),
           "tokens_per_s_first_step": tokens / (step_ms[0] / 1e3),
           "peak_mem_gib": peak, "launches_per_step": per_step[0],
           "profile_one_step": prof,
           "flash_backward_ms_per_call": bwd_ms,
           "flash_backward_ms_per_step": bwd_ms * cfg.n_layers,
           "flash_backward_share_of_step": bwd_ms * cfg.n_layers
           / (sum(steady) / len(steady)),
           "flash_attention_tc_ms_per_call": fwd_ms,
           "captured": {"shape_q": list(q.shape), "shape_kv": list(k.shape)},
           "forward_max_abs_err": {d: f[1] for d, f in fwd.items()},
           "forward_tc_share_of_tc_plain_tolerance": fwd["bfloat16"][2],
           "backward": bwd, "backward_tolerance":
           f"|got - want| <= tol * max|want|, tol {TRAIN_BWD_TOL}"}
    emit(out)
    return out


def phase_train_f32():
    """The train CLI's reduced f32 model (its defaults: corpus crawl of
    60 steps, batch 8 x 128, AdamW on warmup-cosine from 3e-4) for
    TRAIN_F32_STEPS steps on the card and on the CPU from the same numpy
    weights and batches: losses and final parameters within the stated
    bounds, flash_attention (split TF32) launched once a layer a step on
    the card (counts zeroed just before the card's run, read just after);
    then run_with_failures on the card with one injected failure, equal to
    the uninterrupted card run bit for bit. TF32 is off for the GEMMs."""
    import shutil
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.train import build_parser, crawl_corpus
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw, warmup_cosine
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train.trainer import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cli = build_parser().parse_args([])
    cfg = scaled(get_reduced(LM_ARCH), dtype="float32")
    crawl_cfg = get_reduced("webparf")
    urls, _ = crawl_corpus(crawl_cfg, cli.crawl_steps, "cpu")
    host = list(lm_batches(urls, crawl_cfg, batch=cli.batch,
                           seq_len=cli.seq_len, vocab=cfg.vocab_size,
                           device="cpu"))
    batches = [host[i % len(host)] for i in range(TRAIN_F32_STEPS)]
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device="cpu"))
    lr = warmup_cosine(cli.lr, TRAIN_WARMUP, TRAIN_F32_STEPS)
    opt = adamw(lr=lr)
    step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]), opt)

    def start(dev):
        return (init_train_state({k: v.to(dev) for k, v in params.items()},
                                 opt),
                [tuple(x.to(dev) for x in b) for b in batches])
    runs, counts = {}, None
    for dev in (DEV, "cpu"):
        st, bs = start(dev)
        reset_launches()
        losses = []
        for b in bs:
            st, m = step(st, b)
            losses.append(float(m["loss"]))
        counts = launch_counts() if counts is None else counts
        runs[dev] = (st, losses)
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.n_layers * TRAIN_F32_STEPS
    if counts != want:
        raise AssertionError(f"train_f32: launches {counts}, want {want}")
    (card, l_card), (cpu, l_cpu) = runs[DEV], runs["cpu"]
    loss_err = max(abs(a - b) for a, b in zip(l_card, l_cpu))
    d = torch.cat([(card.params[k].cpu() - v).abs().ravel()
                   for k, v in cpu.params.items()])
    bound = 2 * sum(float(lr(torch.tensor(i, dtype=torch.int32)))
                    for i in range(1, TRAIN_F32_STEPS + 1))
    if not np.isfinite(l_card).all() or loss_err > TRAIN_F32_LOSS_TOL \
            or float(d.max()) > bound or float(d.mean()) > TRAIN_F32_MEAN_TOL:
        raise AssertionError(f"train_f32: card vs cpu: losses {loss_err}, "
                             f"params max {float(d.max())} (bound {bound}),"
                             f" mean {float(d.mean())}")
    ckpt_dir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    try:
        st, bs = start(DEV)
        replayed = fault.run_with_failures(
            step, st, bs, ckpt_dir=str(ckpt_dir),
            ckpt_every=TRAIN_F32_CKPT_EVERY,
            plan=fault.FailurePlan(fail_at=TRAIN_F32_FAIL_AT))
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    a, b = ckpt.flatten(card), ckpt.flatten(replayed)
    differ = sorted(k for k in a if a[k].tobytes() != b[k].tobytes())
    if differ or int(replayed.step) != TRAIN_F32_STEPS:
        raise AssertionError(f"train_f32: the replay on the card differs "
                             f"from the uninterrupted run in {differ}")
    out = {"phase": "train_f32", "config": dataclasses.asdict(cfg),
           "batch": cli.batch, "seq_len": cli.seq_len,
           "steps": TRAIN_F32_STEPS, "pages": len(urls),
           "losses_cuda": l_card, "losses_cpu": l_cpu,
           "max_loss_err": loss_err, "loss_tolerance": TRAIN_F32_LOSS_TOL,
           "params_max_abs_err": float(d.max()), "params_bound": bound,
           "params_mean_abs_err": float(d.mean()),
           "params_mean_tolerance": TRAIN_F32_MEAN_TOL,
           "launches": counts,
           "launches_per_step": {k: c / TRAIN_F32_STEPS
                                 for k, c in counts.items()},
           "replay": {"fail_at": list(TRAIN_F32_FAIL_AT),
                      "ckpt_every": TRAIN_F32_CKPT_EVERY,
                      "bitwise_equal": True}}
    emit(out)
    return out


def run_example(name):
    """``examples/<name>.py``'s ``main`` on the card, counts zeroed just
    before and read just after: (its result, seconds, counts)."""
    import importlib.util
    from repro_torch.kernels import launch_counts, reset_launches
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    reset_launches()
    t0 = time.perf_counter()
    got = mod.main(["--device", DEV])
    return got, time.perf_counter() - t0, launch_counts()


def phase_examples():
    """``examples/torch_quickstart.py``'s ``main`` on the card (crawl, the
    crawl CLI in batched mode, 20 training steps): its kernels launched
    and finite losses; ``examples/torch_serve_lm.py`` (the reduced
    deepseek-moe-16b, bf16 at hd 16: flash_attention once a layer in its
    prefill, nothing else; ``serve`` raises on non-finite logits)."""
    from repro_torch.configs import get_reduced
    got, seconds, counts = run_example("torch_quickstart")
    if got["steps"] != 20 or not np.isfinite(
            [got["first_loss"], got["last_loss"]]).all() or not all(
            counts[k] for k in ("frontier_select", "bloom",
                                "flash_attention")):
        raise AssertionError(f"examples: quickstart gave {got}, launches "
                             f"{counts}")
    rc, serve_s, serve_counts = run_example("torch_serve_lm")
    want = {k: 0 for k in serve_counts}
    want["flash_attention"] = get_reduced(MOE_ARCH).n_layers
    if rc != 0 or serve_counts != want:
        raise AssertionError(f"examples: serve_lm returned {rc}, launches "
                             f"{serve_counts}, want {want}")
    zoo = {arch: dict(zip(("losses", "seconds"), run_train_cli(arch)))
           for arch in ("gat-cora", "dcn-v2")}
    emit({"phase": "examples", "quickstart": got, "seconds": seconds,
          "launches": counts, "serve_lm_seconds": serve_s,
          "serve_lm_launches": serve_counts, "train_cli": zoo})


# ---------------------------------------------------------------------------
# GNN and RecSys: plain PyTorch on the card (their reference reaches no
# Pallas kernel), in f32 with TF32 off, so their bounds take the f32 rate
# of the CUDA cores
# ---------------------------------------------------------------------------

CUT_BUDGET = 0.75 * HBM_BYTES  # a batch is halved while its reckoned peak
                                # exceeds this (the rest: the allocator's
                                # slack and what the reckoning leaves out)
GNN_LR, RECSYS_LR = 5e-3, 1e-3  # the reference's cells (launch/specs.py)
GNN_STEPS, MINIBATCH_STEPS, MOLECULE_STEPS = 10, 3, 10
CORA_LABELLED = 140             # Planetoid's labelled nodes of Cora
RECSYS_ARCHS = ("bert4rec", "dien", "wide-deep", "dcn-v2")
RECSYS_TRAIN_STEPS = 4
SERVE_CALLS, BULK_CALLS, RETRIEVAL_CALLS = 5, 2, 3   # the first warms up
ZOO_CPU_STEPS = 4
ZOO_LOSS_TOL, ZOO_OUT_TOL = 1e-4, 1e-5
ZOO_FAIL_AT = (3,)


def timed_steps(step, state, batch, n):
    """n train steps, each timed by the host clock up to its loss on the
    host: (state, losses, ms)."""
    import torch
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        ms.append(1e3 * (time.perf_counter() - t0))
    return state, losses, ms


def timed_calls(fn, n):
    """n calls of fn, each timed by the host clock between
    synchronisations: (the last output, ms)."""
    import torch
    ms, out = [], None
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def top3(prof):
    """A profile's idle share, events, host syncs and its three device ops
    that took most time, per call."""
    rt = prof["runtime_calls_per_call"]
    return {"device_idle_share": prof["device_idle_share"],
            "device_events": prof["device_events_per_call"],
            "device_busy_ms": prof["device_busy_ms_per_call"],
            "wall_ms": prof["wall_ms_per_call"],
            "host_syncs": rt.get("cudaStreamSynchronize", 0.0),
            "top3_device_ms": dict(list(
                prof["top_device_ms_per_call"].items())[:3])}


def finite(*xs):
    return all(bool(np.isfinite(np.asarray(x, dtype=np.float64)).all())
               for x in xs)


def gat_graph(rng, N, E, F, C, labelled, dev):
    """A seeded graph on the device (features N(0, 1), edges uniform)."""
    import torch
    from repro_torch.models import gnn as G
    return G.Graph(
        torch.tensor(rng.normal(size=(N, F)), dtype=torch.float32,
                     device=dev),
        torch.tensor(rng.integers(0, N, E), dtype=torch.int32, device=dev),
        torch.tensor(rng.integers(0, N, E), dtype=torch.int32, device=dev),
        torch.ones(E, dtype=torch.bool, device=dev),
        torch.tensor(rng.integers(0, C, N), dtype=torch.int32, device=dev),
        torch.tensor(labelled, device=dev))


def gat_train(cfg, loss, F, C):
    """A GAT train step (AdamW at GNN_LR) and its initial state."""
    from repro_torch.models import gnn as G
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import init_train_state, make_train_step
    opt = adamw(lr=GNN_LR)
    step = make_train_step(lambda p, b: loss(p, cfg, b), opt)
    return step, init_train_state(G.init_gat(SEED, cfg, F, C, device=DEV),
                                  opt)


def phase_gnn():
    """gat-cora at its published config (2 layers, 8 hidden x 8 heads,
    f32) on three of its four shape cells, seeded synthetic data (Cora,
    Reddit and the molecules are not in the repo): full_graph_sm (GNN_STEPS
    AdamW steps: loss, ms, peak GiB, host syncs and a profile of a step),
    minibatch_lg (synthetic_csr at Reddit's size on the host, a fresh
    sample_fanout block of 1,024 seeds and fanouts (15, 10) a step, its
    602-wide features gathered on the card: the sampler's host ms beside
    the device step's ms, a profile of one more step), molecule
    (gat_batched_loss over 128 graphs);
    ogb_products is reckoned, not run. Each step beside its bound. No port
    kernel launches (counts zeroed at the start, read at the end)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import sampler as S
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import gnn as G
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, shapes = get_arch("gat-cora")
    shapes = {s.name: s for s in shapes}
    rng = np.random.default_rng(SEED)
    reset_launches()
    out = {"phase": "gnn", "config": dataclasses.asdict(cfg),
           "lr": GNN_LR}

    s = shapes["full_graph_sm"]
    N, E, F, C = (s[k] for k in ("n_nodes", "n_edges", "d_feat",
                                 "n_classes"))
    g = gat_graph(rng, N, E, F, C, np.arange(N) < CORA_LABELLED, DEV)
    step, state = gat_train(cfg, G.gat_loss, F, C)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, ms = timed_steps(step, state, g, GNN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = top3(profile_device(lambda: step(state, g), 1))
    out["full_graph_sm"] = {
        "nodes": N, "edges": E, "d_feat": F, "classes": C,
        "labelled": CORA_LABELLED, "losses": losses, "step_ms": ms,
        "peak_gib": peak, "profile_one_step": prof,
        "host_syncs_per_step": prof["host_syncs"],
        **gat_cost(cfg, N, E, F, C)}
    del g, step, state
    free_card()

    s = shapes["minibatch_lg"]
    N, F, C = s["n_nodes"], s["d_feat"], s["n_classes"]
    fan, seeds_n = (s["fanout0"], s["fanout1"]), s["batch_nodes"]
    t0 = time.perf_counter()
    csr = S.synthetic_csr(N, round(s["n_edges"] / N), seed=SEED)
    csr_s = time.perf_counter() - t0
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    feats = torch.randn((N, F), generator=gen, device=DEV)
    labels = torch.randint(0, C, (N,), generator=gen, device=DEV,
                           dtype=torch.int32)
    step, state = gat_train(cfg, G.gat_loss, F, C)
    srng = np.random.default_rng(SEED + 1)
    sample_ms, step_ms, losses, blocks = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(MINIBATCH_STEPS):
        t0 = time.perf_counter()
        seeds = srng.choice(N, seeds_n, replace=False)
        blk = S.sample_fanout(csr, seeds, fan, rng=srng)
        sample_ms.append(1e3 * (time.perf_counter() - t0))
        ids = torch.tensor(blk.node_ids, dtype=torch.long, device=DEV)
        gb = G.Graph(feats.index_select(0, ids.clamp(min=0)),
                     torch.tensor(blk.src, device=DEV),
                     torch.tensor(blk.dst, device=DEV),
                     torch.tensor(blk.edge_mask, device=DEV),
                     labels.index_select(0, ids.clamp(min=0)),
                     torch.tensor(np.isin(blk.node_ids, seeds), device=DEV))
        state, (loss,), (ms,) = timed_steps(step, state, gb, 1)
        losses.append(loss)
        step_ms.append(ms)
        blocks.append({"nodes": blk.n_valid_nodes,
                       "edges": int(blk.edge_mask.sum())})
    peak = torch.cuda.max_memory_allocated() / 2**30
    prof = top3(profile_device(lambda: step(state, gb), 1))
    out["minibatch_lg"] = {
        "graph_nodes": N, "graph_edges": int(csr.indptr[-1]),
        "csr_index_bytes": int(csr.indices.nbytes + csr.indptr.nbytes),
        "csr_build_host_s": csr_s, "seeds": seeds_n, "fanouts": list(fan),
        "max_nodes": S._block_max_nodes(seeds_n, fan),
        "max_edges": S._block_max_edges(seeds_n, fan),
        "blocks": blocks, "sampler_host_ms": sample_ms,
        "device_step_ms": step_ms, "losses": losses, "peak_gib": peak,
        "profile_one_step": prof, **gat_cost(cfg, S._block_max_nodes(seeds_n, fan),
                   S._block_max_edges(seeds_n, fan), F, C)}
    del csr, feats, labels, step, state, gb
    free_card()

    s = shapes["molecule"]
    B, n, e, F, C = (s[k] for k in ("batch", "n_nodes", "n_edges",
                                    "d_feat", "n_classes"))
    shp = lambda *d: (B,) + d
    gb = G.Graph(
        torch.tensor(rng.normal(size=shp(n, F)), dtype=torch.float32,
                     device=DEV),
        torch.tensor(rng.integers(0, n, shp(e)), dtype=torch.int32,
                     device=DEV),
        torch.tensor(rng.integers(0, n, shp(e)), dtype=torch.int32,
                     device=DEV),
        torch.ones(shp(e), dtype=torch.bool, device=DEV),
        torch.tensor(rng.integers(0, C, shp(n)), dtype=torch.int32,
                     device=DEV),
        torch.ones(shp(n), dtype=torch.bool, device=DEV))
    step, state = gat_train(cfg, G.gat_batched_loss, F, C)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, losses, ms = timed_steps(step, state, gb, MOLECULE_STEPS)
    out["molecule"] = {
        "graphs": B, "nodes": n, "edges": e, "losses": losses,
        "step_ms": ms, "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
        "profile_one_step": top3(profile_device(lambda: step(state, gb), 1)),
        **gat_cost(cfg, B * n, B * e, F, C)}
    del gb, step, state
    free_card()

    s = shapes["ogb_products"]
    msg = s["n_edges"] * cfg.n_heads * s["n_classes"] * 4
    emit({"phase": "gnn_ogb_products", "run": False,
          "last_layer_message_bytes": msg,
          "reckoning": f"{s['n_edges']} edges x {cfg.n_heads} heads x "
                       f"{s['n_classes']} classes x 4 B = {msg / 1e9:.1f} GB"
                       f" of f32 messages in the last layer alone, more "
                       f"than the card's {HBM_BYTES / 2 ** 30:.0f} GiB "
                       f"before any gradient"})
    out["launches"] = launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"gnn: port kernels launched {out['launches']}")
    for cell in ("full_graph_sm", "minibatch_lg", "molecule"):
        if not finite(out[cell]["losses"]):
            raise AssertionError(f"gnn: {cell} losses {out[cell]['losses']}")
    emit(out)
    return out


def phase_recsys():
    """bert4rec, dien, wide-deep and dcn-v2 at their published configs
    (full tables, f32, TF32 off), seeded weights and make_batch's batches,
    one arch at a time, each freed before the next: train_batch (65,536,
    cut by powers of two only as far as the dry run's reckoned peak
    forces (``cut_batch``), each
    cut printed with its bytes; RECSYS_TRAIN_STEPS AdamW steps: loss, ms,
    examples/s, peak GiB, a profile of one more step), serve_p99 (512:
    SERVE_CALLS calls and a profile of one), serve_bulk (262,144, cut as
    train_batch; BULK_CALLS calls) and retrieval_cand (1 query, 1,000,000
    candidates: RETRIEVAL_CALLS calls; ids valid, scores descending), each
    beside its bound; rates from the calls after the first. No port
    kernel launches."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import recsys as R
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    out = {"phase": "recsys", "lr": RECSYS_LR,
           "cut_budget_bytes": CUT_BUDGET, "archs": {}}
    for arch in RECSYS_ARCHS:
        cfg, shapes = get_arch(arch)
        kind = cfg.kind
        t0 = time.perf_counter()
        params = R.INIT[kind](SEED, cfg, device=DEV)
        torch.cuda.synchronize()
        rec = {"config": dataclasses.asdict(cfg), "total_rows":
               cfg.total_rows, "init_s": time.perf_counter() - t0,
               "params": sum(p.numel() for p in params.values())}
        for s in shapes:
            B, cuts = cut_batch(arch, s.name, s.get("batch", 1),
                                CUT_BUDGET)
            assert B, f"{arch} {s.name}: does not fit at batch 1: {cuts}"
            if len(cuts) > 1:
                emit({"phase": "recsys_cut", "arch": arch, "cell": s.name,
                      "reckoned": cuts, "budget_bytes": CUT_BUDGET})
            shape = ShapeSpec(s.name, s.kind, dict(s.dims, batch=B))
            batch = R.make_batch(cfg, shape, rng_key=SEED, device=DEV)
            cell = {"batch": B, "published_batch": s.get("batch", 1),
                    "reckoned_bytes": cuts[-1]["reckoned_bytes"]}
            nbytes = sum(t.numel() * t.element_size()
                         for t in leaves(batch))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if s.kind == "train":
                opt = adamw(lr=RECSYS_LR)
                step = make_train_step(
                    lambda p, b: R.TRAIN_LOSS[kind](p, cfg, b), opt)
                # no name holds the initial state: its zero moments would
                # stay alive beside the trained ones
                state, losses, ms = timed_steps(
                    step, init_train_state(params, opt), batch,
                    RECSYS_TRAIN_STEPS)
                cell.update(losses=losses, step_ms=ms,
                            examples_per_s=1e3 * B / float(
                                np.median(ms[1:])))
                cell["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                cell["profile_one_step"] = top3(profile_device(
                    lambda: step(state, batch), 1))
                if not finite(losses):
                    raise AssertionError(f"recsys {arch}: losses {losses}")
                del state, step, opt
                cost = recsys_cost(cfg, "train", B, batch_bytes=nbytes)
            else:
                fn = R.SERVE[kind] if s.kind == "serve" else R.RETRIEVAL[kind]
                n = (BULK_CALLS if s.name == "serve_bulk" else SERVE_CALLS
                     if s.kind == "serve" else RETRIEVAL_CALLS)
                with torch.no_grad():
                    got, ms = timed_calls(lambda: fn(params, cfg, batch), n)
                    if s.name == "serve_p99":
                        cell["profile_one_call"] = top3(profile_device(
                            lambda: fn(params, cfg, batch), 1))
                cell.update(call_ms=ms, examples_per_s=1e3 * B / float(
                    np.median(ms[1:])))
                cell["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                scores = got[0] if isinstance(got, tuple) else got
                if not bool(torch.isfinite(scores).all()):
                    raise AssertionError(f"recsys {arch} {s.name}: "
                                         f"non-finite output")
                if isinstance(got, tuple):
                    hi = s["n_candidates"] if s.kind == "retrieval" \
                        else cfg.tables["item"]
                    ids = got[1]
                    ok = bool(((ids >= 0) & (ids < hi)).all()) and bool(
                        (scores[:, 1:] <= scores[:, :-1]).all())
                    if not ok:
                        raise AssertionError(f"recsys {arch} {s.name}: "
                                             f"ids or order invalid")
                    cell["ids_valid"] = True
                cost = recsys_cost(cfg, s.kind, B, s.get("n_candidates", 0),
                                   nbytes)
                del got
            cell.update(cost)
            times = cell.get("step_ms", cell.get("call_ms"))[1:]
            cell["ms_over_bound"] = float(np.median(times)) / \
                cost["bound_ms"]
            rec[s.name] = cell
            del batch
            free_card()
        out["archs"][arch] = rec
        emit({"phase": "recsys_arch", "arch": arch, **rec})
        del params
        free_card()
    out["launches"] = launch_counts()
    if any(out["launches"].values()):
        raise AssertionError(f"recsys: port kernels launched "
                             f"{out['launches']}")
    emit({"phase": "recsys", "launches": out["launches"]})
    return out


def zoo_cases():
    """The five reduced GNN/RecSys configs: (arch, loss, serve, retrieval
    or None, params on the CPU, train, serve and retrieval batches as
    numpy trees)."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    rng = np.random.default_rng(SEED)
    N, E, F, C = 96, 384, 16, 5
    g = G.Graph(rng.normal(size=(N, F)).astype(np.float32),
                rng.integers(0, N, E).astype(np.int32),
                rng.integers(0, N, E).astype(np.int32), rng.random(E) < 0.9,
                rng.integers(0, C, N).astype(np.int32), rng.random(N) < 0.5)
    cfg = get_reduced("gat-cora")
    yield ("gat-cora", lambda p, b, c=cfg: G.gat_loss(p, c, b),
           lambda p, b, c=cfg: G.gat_forward(p, c, b), None,
           G.init_gat(SEED, cfg, F, C, device="cpu"), g, g, None)
    for arch in RECSYS_ARCHS:
        cfg = get_reduced(arch)
        k = cfg.kind
        mk = lambda kind, **d: R.make_batch(
            cfg, ShapeSpec(kind, kind, d), rng_key=SEED, numpy=True)
        yield (arch, lambda p, b, c=cfg: R.TRAIN_LOSS[c.kind](p, c, b),
               lambda p, b, c=cfg: R.SERVE[c.kind](p, c, b),
               lambda p, b, c=cfg: R.RETRIEVAL[c.kind](p, c, b),
               R.INIT[k](SEED, cfg, device="cpu"), mk("train", batch=32),
               mk("serve", batch=16),
               mk("retrieval", batch=1, n_candidates=4096))


def leaves(x):
    """The tensors of a batch (a dict, possibly nested)."""
    if isinstance(x, dict):
        for v in x.values():
            yield from leaves(v)
    else:
        yield x


def ids_under_tie_rule(want_s, want_i, got_s, got_i, ulp=4):
    """Ids equal where the reference's neighbouring scores are more than
    ``ulp`` apart, equal as sets inside a run of near-ties (a run that
    reaches the last rank holds only its scores)."""
    ws = np.asarray(want_s, np.float32)
    for r in range(ws.shape[0]):
        key = ws[r].view(np.int32).astype(np.int64)
        key = np.where(key < 0, -(2**31) - key, key)
        lo, k = 0, ws.shape[1]
        while lo < k:
            hi = lo + 1
            while hi < k and abs(key[hi] - key[hi - 1]) <= ulp:
                hi += 1
            if hi < k and sorted(want_i[r, lo:hi]) != sorted(
                    got_i[r, lo:hi]):
                return False
            lo = hi
    return True


def phase_gnn_recsys_cpu():
    """The five reduced GNN/RecSys configs in f32 (TF32 off) on the card
    and on the CPU from the same weights and batches: ZOO_CPU_STEPS AdamW
    steps' losses within ZOO_LOSS_TOL, the serve outputs within
    ZOO_OUT_TOL, the retrieval scores within ZOO_OUT_TOL and their ids
    equal under the tie rule. Then, on the card, the same steps run a
    second time (every leaf compared bit for bit; the first leaf that
    differs is named) and, for dcn-v2 and gat-cora, run_with_failures
    with a failure at step 3 against the uninterrupted run (bit for bit,
    else the largest difference)."""
    import shutil
    import torch
    from repro_torch.models.recsys import to_device as tree_to
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import fault
    from repro_torch.train.trainer import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"phase": "gnn_recsys_cpu", "steps": ZOO_CPU_STEPS,
           "loss_tolerance": ZOO_LOSS_TOL, "out_tolerance": ZOO_OUT_TOL,
           "archs": {}}
    for arch, loss, serve, retr, params, tb, sb, rb in zoo_cases():
        step = make_train_step(loss, adamw(lr=RECSYS_LR))

        def start(dev):
            return (init_train_state({k: v.to(dev) for k, v in
                                      params.items()}, adamw(lr=RECSYS_LR)),
                    tree_to(tb, dev))

        def run(dev):
            st, b = start(dev)
            losses = []
            for _ in range(ZOO_CPU_STEPS):
                st, m = step(st, b)
                losses.append(float(m["loss"]))
            with torch.no_grad():
                p = {k: v.to(dev) for k, v in params.items()}
                sv = serve(p, tree_to(sb, dev))
                rt = retr(p, tree_to(rb, dev)) if retr else None
            return st, losses, sv, rt
        card, cpu, again = run(DEV), run("cpu"), run(DEV)
        rec = {"losses_cuda": card[1], "losses_cpu": cpu[1],
               "max_loss_err": max(abs(a - b) for a, b in
                                   zip(card[1], cpu[1]))}
        sv_c, sv_h = (x[0] if isinstance(x, tuple) else x
                      for x in (card[2], cpu[2]))
        rec["serve_max_abs_err"] = float((sv_c.cpu() - sv_h).abs().max())
        if isinstance(card[2], tuple):
            rec["serve_ids_tie_rule"] = ids_under_tie_rule(
                cpu[2][0].numpy(), cpu[2][1].numpy(),
                card[2][0].cpu().numpy(), card[2][1].cpu().numpy())
        if retr:
            rec["retrieval_max_abs_err"] = float(
                (card[3][0].cpu() - cpu[3][0]).abs().max())
            rec["retrieval_ids_tie_rule"] = ids_under_tie_rule(
                cpu[3][0].numpy(), cpu[3][1].numpy(),
                card[3][0].cpu().numpy(), card[3][1].cpu().numpy())
        a, b = ckpt.flatten(card[0]), ckpt.flatten(again[0])
        differ = [k for k in sorted(a) if a[k].tobytes() != b[k].tobytes()]
        rec["rerun_bitwise_equal"] = not differ
        rec["rerun_first_differing_leaf"] = differ[0] if differ else None
        if arch in ("dcn-v2", "gat-cora"):
            ckpt_dir = ROOT / "build" / "zoo_ckpt"
            shutil.rmtree(ckpt_dir, ignore_errors=True)
            st, bt = start(DEV)
            try:
                replayed = fault.run_with_failures(
                    step, st, [bt] * ZOO_CPU_STEPS, ckpt_dir=str(ckpt_dir),
                    ckpt_every=2, plan=fault.FailurePlan(
                        fail_at=ZOO_FAIL_AT))
            finally:
                shutil.rmtree(ckpt_dir, ignore_errors=True)
            r = ckpt.flatten(replayed)
            diff = max(float(np.abs(r[k].astype(np.float64)
                                    - a[k].astype(np.float64)).max())
                       for k in a)
            rec["replay"] = {"fail_at": list(ZOO_FAIL_AT),
                             "bitwise_equal": all(
                                 r[k].tobytes() == a[k].tobytes()
                                 for k in a),
                             "max_abs_diff": diff}
        bad = (rec["max_loss_err"] > ZOO_LOSS_TOL
               or rec["serve_max_abs_err"] > ZOO_OUT_TOL
               or rec.get("retrieval_max_abs_err", 0) > ZOO_OUT_TOL
               or not rec.get("retrieval_ids_tie_rule", True)
               or not rec.get("serve_ids_tie_rule", True)
               or not finite(card[1]))
        if bad:
            raise AssertionError(f"gnn_recsys_cpu {arch}: {rec}")
        out["archs"][arch] = rec
    emit(out)
    return out


def run_train_cli(arch, steps=10):
    """``python -m repro_torch.launch.train --arch <arch>`` on the card
    (its default device): (the losses it printed, seconds)."""
    import contextlib
    import io
    from repro_torch.launch import train
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train.main(["--arch", arch, "--steps", str(steps),
                         "--log-every", "1"])
    losses = [float(line.split()[-1]) for line in buf.getvalue().splitlines()
              if line.startswith("step")]
    if rc != 0 or len(losses) != steps or not finite(losses):
        raise AssertionError(f"examples: train CLI {arch}: rc {rc}, "
                             f"output {buf.getvalue()!r}")
    return losses, time.perf_counter() - t0


# the MoE LM family: DeepSeekMoE-16B at its published config (28 layers, 1
# dense then 27 MoE, d 2048, 16/16 heads, hd 128, 64 routed experts top-6 of
# 1408 plus 2 shared, dense d_ff 10944, vocab 102400), bf16, seeded weights,
# prefill_32k's 32 x 32768 cut to 4 x 2048 (as for Qwen2-1.5B) and 32
# greedy tokens; Arctic at its published widths (d 7168, 56/8 heads, hd
# 128, 128 experts top-2 of 4864 beside a dense residual of 4864, vocab
# 32000) with its depth cut from 35 to 2 layers (476.9 B parameters do not
# fit one card; 2 layers are 27.7 B, 55.4 GB in bf16), 1 x 2048 + 8
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN = "deepseek-moe-16b", 4, 2048, 32
ARCTIC_ARCH, ARCTIC_LAYERS = "arctic-480b", 2
ARCTIC_BATCH, ARCTIC_PROMPT, ARCTIC_GEN = 1, 2048, 8
MOE_CPU_ARCHS = ("deepseek-moe-16b", "arctic-480b")
MOE_DROP_FACTOR = 0.5       # moe_cpu's capacity factor that must drop
MOE_TRAIN_STEPS = 4
MOE_PROFILE_DECODE = 4      # decode steps profiled (one token each)
# the MoE block's parts, as ranges wrapped around the layers' functions
# while a prefill or a decode step is profiled; what no range covers is
# split by the launching op (aten::mm / aten::addmm: the dense GEMMs) and
# by the kernel's element type (f32 elementwise) into the rest
MOE_RANGES = {"moe_dispatch": "dispatch", "_moe_scatter": "scatter_combine",
              "_moe_combine": "scatter_combine",
              "chunked_attention": "attention",
              "decode_attention": "attention"}


def record_dispatch(fn):
    """``fn()`` with ``layers.moe_dispatch`` spied on: (its result, each
    call's (expert_idx, keep) on the host, in call order)."""
    from repro_torch.models import layers as L
    got, orig = [], L.moe_dispatch

    def spy(logits, m, capacity):
        out = orig(logits, m, capacity)
        got.append((out[1].cpu(), out[3].cpu()))
        return out
    L.moe_dispatch = spy
    try:
        return fn(), got
    finally:
        L.moe_dispatch = orig


def profile_moe(fn, calls):
    """``fn()`` (``calls`` calls) under torch.profiler with the MoE
    block's parts and the attention marked by ``record_function`` ranges
    (MOE_RANGES; ``torch.bmm``, which only the expert products call from
    Python, as ``expert_bmm``): per call the device ms of each part, the
    dense GEMMs (aten::mm / addmm outside the ranges), the f32 elementwise
    kernels outside them, the rest, the device's busy ms and idle share,
    the device events and the kernels that took most of the time. Each
    kernel counts once, in the innermost range around the op that launched
    it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import layers as L

    def marked(name, f):
        def run(*args, **kw):
            with record_function(name):
                return f(*args, **kw)
        return run
    patched = [(L, n, getattr(L, n)) for n in MOE_RANGES]
    patched.append((torch, "bmm", torch.bmm))
    for mod, name, f in patched:
        setattr(mod, name, marked(f"moe::{name}", f))
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
    finally:
        for mod, name, f in patched:
            setattr(mod, name, f)
    cats = {f"moe::{n}": c for n, c in MOE_RANGES.items()}
    cats["moe::bmm"] = "expert_bmm"
    split, per_name, n = Counter(), Counter(), 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name not in cats:       # a range's span is no kernel
                per_name[e.name[:80]] += e.time_range.elapsed_us()
                n += 1
            continue
        if not e.kernels:
            continue
        cat, p = None, e
        while p is not None and cat is None:
            cat, p = cats.get(p.name), p.cpu_parent
        for k in e.kernels:
            if cat is None:
                f32 = "float" in k.name and "BFloat16" not in k.name
                c = ("dense_gemm" if e.name in ("aten::mm", "aten::addmm")
                     else "f32_elementwise" if f32 else "other")
            else:
                c = cat
            split[c] += k.duration
    busy = sum(per_name.values())
    return {"wall_ms_per_call": wall_us / 1e3 / calls,
            "device_busy_ms_per_call": busy / 1e3 / calls,
            "device_idle_share": 1 - busy / wall_us if n else None,
            "device_events_per_call": n / calls,
            "split_ms_per_call": {k: v / 1e3 / calls
                                  for k, v in sorted(split.items())},
            "split_covers_busy": sum(split.values()) / busy if busy
            else None,
            "top_device_ms_per_call": {k: v / 1e3 / calls for k, v in
                                       per_name.most_common(8)}}


def record_serve(model, prompts, gen):
    """One greedy ``serve`` with every MoE call's route recorded (a host
    copy a call, so it is timed nowhere): (tokens, the prefill's
    (expert_idx, keep) per MoE layer, per decode step the same)."""
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import n_prefix
    (toks, _, _), routes = record_dispatch(lambda: serve(model, prompts,
                                                         gen))
    n_moe = model.cfg.n_layers - n_prefix(model.cfg)
    if len(routes) != n_moe * gen:
        raise AssertionError(f"record_serve: {len(routes)} MoE calls, "
                             f"want {n_moe * gen}")
    return toks, routes[:n_moe], [routes[i:i + n_moe]
                                  for i in range(n_moe, len(routes), n_moe)]


def moe_serve(model, prompts, gen, label):
    """One counted ``serve`` after a warm-up: counts zeroed just before
    and read just after, flash_attention_tc once a layer (every layer,
    prefix included) and flash_attention never, well-formed tokens.
    Returns (tokens, prefill s, decode s, counts, peak GiB)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    serve(model, prompts, 2)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    toks, t_pre, t_dec = serve(model, prompts, gen)
    counts = launch_counts()
    check_prefill_launches(counts, cfg.n_layers, label)
    B = prompts.shape[0]
    if toks.shape != (B, gen) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"{label}: tokens malformed: "
                             f"{tuple(toks.shape)}")
    return (toks, t_pre, t_dec, counts,
            torch.cuda.max_memory_allocated() / 2 ** 30)


def serve_line(label, cfg, B, P, gen, t_pre, t_dec, peak, counts,
               bounds):
    return {"phase": label, "arch": cfg.name,
            "config": dataclasses.asdict(cfg), "n_params": cfg.n_params,
            "batch": B, "prompt_len": P, "gen": gen,
            "prefill_ms": 1e3 * t_pre,
            "decode_ms_per_token": 1e3 * t_dec / (gen - 1),
            "generated_tok_per_s": B * gen / (t_pre + t_dec),
            "decode_tok_per_s": B * (gen - 1) / t_dec,
            "prefill_tok_per_s": B * P / t_pre, "peak_mem_gib": peak,
            "launches": counts, **bounds,
            "prefill_share_of_bound": bounds["prefill_bound_ms"]
            / (1e3 * t_pre),
            "decode_share_of_bound": bounds["decode_bound_ms"]
            / (1e3 * t_dec / (gen - 1)),
            "prefill_share_of_bucketed_bound":
                bounds["bucketed_prefill_bound_ms"] / (1e3 * t_pre),
            "decode_share_of_bucketed_bound":
                bounds["bucketed_decode_bound_ms"]
                / (1e3 * t_dec / (gen - 1))}


def moe_flash_parity(model, prompts, label):
    """Layer 0's and the last layer's attention inputs captured from a
    prefill and held to the plain version: each must route to
    flash_attention_tc. Returns the max |diff|."""
    from repro_torch.kernels.flash_attention import ops as FA
    captured = capture_flash(model, prompts, {0, model.cfg.n_layers - 1})
    err = 0.0
    for layer, (q, k, v) in sorted(captured.items()):
        name, e, _ = flash_pair(q, k, v, True, f"{label} layer {layer}")
        if name != FA.TC_KERNEL.name:
            raise AssertionError(f"{label} layer {layer}: routed to {name}")
        err = max(err, e)
    return err


def moe_routes(model, prompts, gen, toks):
    """The bounds from a recorded ``serve`` (``record_serve``,
    ``moe_bounds``), the share of each MoE layer's prefill assignments
    that capacity dropped, and whether the recorded run generated the
    counted run's ``toks`` (the routes are then that run's)."""
    import torch
    got, pre, dec = record_serve(model, prompts, gen)
    drops = [float((~keep).float().mean()) for _, keep in pre]
    bounds = moe_bounds(model, prompts.shape[0], prompts.shape[1], gen,
                        pre, dec)
    bounds.update(prefill_drop_share_per_moe_layer=drops,
                  prefill_drop_share_max=max(drops),
                  routes_of_counted_tokens=torch.equal(got.cpu(),
                                                       toks.cpu()))
    return bounds


def phase_moe_serve():
    """DeepSeekMoE-16B at full width from the port's seeded init, bf16 on
    the card: the captured attention parity (``moe_flash_parity``), the
    counted ``serve`` of MOE_BATCH x MOE_PROMPT prompts and MOE_GEN tokens
    (``moe_serve``), the drop shares and the bounds from the run's routes
    (``moe_routes``), a profile of one prefill and of decode tokens split
    by part, and the host syncs of a decode token (torch's sync debug
    mode). Returns the prefill's counts and the captured parity's max
    |diff|."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(MOE_ARCH)[0]
    t0 = time.time()
    model = T.init_lm(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    prompts = torch.tensor(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)), device=DEV)
    err = moe_flash_parity(model, prompts, "moe_serve")
    toks, t_pre, t_dec, counts, peak = moe_serve(
        model, prompts, MOE_GEN, "moe_serve")
    if peak >= 80:
        raise AssertionError(f"moe_serve: peak {peak} GiB")
    bounds = moe_routes(model, prompts, MOE_GEN, toks)
    P = MOE_PROMPT
    pre = profile_moe(lambda: T.prefill_step(model, prompts), 1)
    logits, cache = T.prefill_step(model, prompts,
                                   max_len=P + 2 * MOE_PROFILE_DECODE)
    tok = logits[:, -1].argmax(dim=-1, keepdim=True)

    def decode():
        nonlocal cache
        for _ in range(MOE_PROFILE_DECODE):
            _, cache = T.decode_step(model, tok, cache)
    dec = profile_moe(decode, MOE_PROFILE_DECODE)
    n_sync, sync_lines = count_call_syncs(decode)
    out = serve_line("moe_serve", cfg, MOE_BATCH, P, MOE_GEN, t_pre, t_dec,
                     peak, counts, bounds)
    out.update(init_s=init_s, first_tokens=toks[:, :8].tolist(),
               captured_flash_max_abs_err=err,
               profile={"prefill": pre, "decode_token": dec},
               host_syncs_per_decode_token=n_sync / MOE_PROFILE_DECODE,
               sync_lines=sync_lines)
    emit(out)
    return counts, err


def phase_moe_arctic():
    """Arctic at its published widths with the depth cut to ARCTIC_LAYERS,
    bf16 on the card: the captured attention parity at its GQA group of 7
    (``moe_flash_parity``), the counted ``serve`` of ARCTIC_BATCH x
    ARCTIC_PROMPT and ARCTIC_GEN tokens (one flash_attention_tc launch a
    layer), the drop shares, and prefill and decode beside their bounds
    (``moe_routes``). Returns the prefill's counts and the captured
    parity's max |diff|."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import scaled
    from repro_torch.models import transformer as T
    cfg = scaled(get_arch(ARCTIC_ARCH)[0], n_layers=ARCTIC_LAYERS)
    t0 = time.time()
    model = T.init_lm(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    prompts = torch.tensor(np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (ARCTIC_BATCH, ARCTIC_PROMPT)), device=DEV)
    err = moe_flash_parity(model, prompts, "moe_arctic")
    toks, t_pre, t_dec, counts, peak = moe_serve(
        model, prompts, ARCTIC_GEN, "moe_arctic")
    bounds = moe_routes(model, prompts, ARCTIC_GEN, toks)
    out = serve_line("moe_arctic", cfg, ARCTIC_BATCH, ARCTIC_PROMPT,
                     ARCTIC_GEN, t_pre, t_dec, peak, counts, bounds)
    out.update(init_s=init_s, reduced={"n_layers": [35, ARCTIC_LAYERS]},
               tokens=toks.tolist(), captured_flash_max_abs_err=err)
    emit(out)
    return counts, err


def _moe_card_cpu(cfg, toks, P):
    """The same f32 weights on the card and the CPU: a P-token prefill,
    then teacher-forced decode over the rest of ``toks``; returns per
    device the logits (on the host) and each MoE call's keep, and the
    card's launch counts (zeroed just before its run)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import transformer as T
    cpu = T.init_lm(cfg, seed=SEED, device="cpu")
    card = T.params_from_numpy(cfg, T.params_to_numpy(cpu), device=DEV)
    out, counts = {}, None
    for name, m in (("cuda", card), ("cpu", cpu)):
        t = toks.to(m.device)

        def run():
            lg, cache = T.prefill_step(m, t[:, :P], max_len=t.shape[1])
            logs = [lg]
            for i in range(P, t.shape[1]):
                lg, cache = T.decode_step(m, t[:, i:i + 1], cache)
                logs.append(lg)
            return torch.cat(logs, 1).cpu()
        reset_launches()
        logits, routes = record_dispatch(run)
        counts = launch_counts() if counts is None else counts
        out[name] = (logits, [keep for _, keep in routes],
                     [e for e, _ in routes])
    return out, counts


def phase_moe_cpu(steps=16):
    """The reduced deepseek-moe-16b and arctic-480b in f32, the same
    weights on the card and the CPU: a 32-token prefill and ``steps``
    teacher-forced decode steps, logits within LM_CPU_TOL and argmax
    equal, every route equal, flash_attention launched once a layer in
    the prefill; again at capacity factor MOE_DROP_FACTOR, whose prefill
    must drop, with the same keep on both; then MOE_TRAIN_STEPS AdamW
    steps through make_train_step on both, each loss (aux included)
    within TRAIN_F32_LOSS_TOL, flash_attention once a layer a step. TF32
    is off: it would round the f32 router's products to 10 bits and flip
    experts. Returns the f32 prefill's flash_attention launches by
    arch."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import init_train_state, make_train_step
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    P = 32
    res, per_arch = {"phase": "moe_cpu", "tolerance": LM_CPU_TOL}, {}
    for arch in MOE_CPU_ARCHS:
        cfg = scaled(get_reduced(arch), dtype="float32")
        toks = torch.tensor(np.random.default_rng(SEED + 8).integers(
            0, cfg.vocab_size, (LM_BATCH, P + steps)))
        line = {}
        for factor in (cfg.moe.capacity_factor, MOE_DROP_FACTOR):
            c = scaled(cfg, moe=scaled(cfg.moe, capacity_factor=factor))
            got, counts = _moe_card_cpu(c, toks, P)
            (a, ka, ea), (b, kb, eb) = got["cuda"], got["cpu"]
            err = float((a - b).abs().max())
            if not torch.isfinite(a).all() or err > LM_CPU_TOL:
                raise AssertionError(f"moe_cpu {arch} factor {factor}: "
                                     f"logits differ by {err}")
            if not (all(torch.equal(x, y) for x, y in zip(ka, kb))
                    and all(torch.equal(x, y) for x, y in zip(ea, eb))):
                raise AssertionError(f"moe_cpu {arch} factor {factor}: "
                                     f"routes differ on card and CPU")
            n_moe = cfg.n_layers - T.n_prefix(cfg)
            dropped = int(sum((~k).sum() for k in ka[:n_moe]))
            if counts["flash_attention"] != cfg.n_layers or \
                    counts["flash_attention_tc"] != 0:
                raise AssertionError(f"moe_cpu {arch}: launches {counts}")
            if factor == MOE_DROP_FACTOR and dropped == 0:
                raise AssertionError(f"moe_cpu {arch}: nothing dropped at "
                                     f"capacity factor {factor}")
            line[f"factor_{factor}"] = {
                "max_abs_err": err, "argmax_equal": bool(torch.equal(
                    a.argmax(-1), b.argmax(-1))),
                "prefill_dropped_assignments": dropped,
                "launches": counts}
        per_arch[arch] = counts["flash_attention"]
        res[arch] = line
    cfg = scaled(get_reduced(MOE_CPU_ARCHS[0]), dtype="float32")
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device="cpu"))
    rng = np.random.default_rng(SEED + 9)
    batches = [tuple(torch.tensor(rng.integers(0, cfg.vocab_size, (4, 64)),
                                  dtype=torch.int32) for _ in range(2))
               for _ in range(MOE_TRAIN_STEPS)]
    opt = adamw(lr=TRAIN_LR)
    step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]), opt)
    losses, counts = {}, None
    for dev in (DEV, "cpu"):
        st = init_train_state({k: v.to(dev) for k, v in params.items()},
                              opt)
        reset_launches()
        losses[dev] = []
        for b in batches:
            st, m = step(st, tuple(x.to(dev) for x in b))
            losses[dev].append(float(m["loss"]))
        counts = launch_counts() if counts is None else counts
    loss_err = max(abs(x - y) for x, y in zip(losses[DEV], losses["cpu"]))
    if not np.isfinite(losses[DEV]).all() or loss_err > TRAIN_F32_LOSS_TOL \
            or counts["flash_attention"] != cfg.n_layers * MOE_TRAIN_STEPS:
        raise AssertionError(f"moe_cpu train: losses {losses}, launches "
                             f"{counts}")
    res["train"] = {"arch": cfg.name, "steps": MOE_TRAIN_STEPS,
                    "losses_cuda": losses[DEV], "losses_cpu": losses["cpu"],
                    "max_loss_err": loss_err,
                    "loss_tolerance": TRAIN_F32_LOSS_TOL,
                    "launches": counts}
    emit(res)
    return per_arch


def attention_flops(q):
    """The two causal products' operations at q's shape (B, Hq, S, hd)."""
    B, Hq, S, hd = q.shape
    return 4 * B * Hq * hd * (S * (S + 1) // 2)


def sdpa_backend(fn):
    """The backend of a library attention call ``fn()``, from the ATen op it
    dispatched to (torch.profiler's host events): flash, memory-efficient
    (CUTLASS fmha), cuDNN or math; and the device kernel that took most of
    the call's time, where the profiler saw one."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ops, dev = set(), Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            dev[e.name[:120]] += e.time_range.elapsed_us()
        elif "scaled_dot_product" in e.name or "attention" in e.name:
            ops.add(e.name)
    names = " ".join(sorted(ops)).lower()
    backend = ("flash" if "flash" in names else
               "memory_efficient" if "efficient" in names else
               "cudnn" if "cudnn" in names else
               "math" if "math" in names else None)
    return backend, (dev.most_common(1)[0][0] if dev else None), sorted(ops)


def kernels_lm(captured, counts, errs, counts_f32):
    """Both attention kernels on layer 0's captured inputs, in one run.
    flash_attention_tc (the bf16 prefill's route) on the bf16 inputs. The
    f32 route (flash_attention: f32 at every head dim) on the same
    inputs cast to f32, its contract, beside the plain version and the
    library's fused attention on the same f32 inputs (a yardstick only; its
    backend named from the profiler), and its f32 bound: the larger of
    three TF32 tensor-core passes (split TF32) over 495 TFLOP/s and the
    f32 bytes of q, k, v and o over 3.35 TB/s; the FMA floor (the
    operations over the CUDA cores' 67 TFLOP/s) beside it. Its figures on
    the bf16 inputs stay as secondary keys. The bf16 kernel's bound is the
    larger of the operations over 989 TFLOP/s and its bytes.
    flash_attention's launches are those of the f32 path (lm_cpu)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention.ref import flash_ref
    sdpa = torch.nn.functional.scaled_dot_product_attention
    q, k, v = captured[0]
    q32, k32, v32 = q.float(), k.float(), v.float()
    n = 50
    flops = attention_flops(q)

    def timed(q, k, v):
        qg, kf, vf, group = FA._gqa_fold(q, k, v)
        ms = {kern.name: cuda_ms(lambda: FA.launch(kern, q, k, v, True), n)
              for kern in (FA.TC_KERNEL, FA.KERNEL)
              if kern is FA.KERNEL or q.dtype == torch.bfloat16}
        lib_call = lambda: sdpa(q, k, v, is_causal=True,  # noqa: E731
                                enable_gqa=True)
        return (ms, cuda_ms(lambda: flash_ref(qg, kf, vf, causal=True,
                                              group=group), n),
                cuda_ms(lib_call, n), sdpa_backend(lib_call),
                (2 * q.numel() + k.numel() + v.numel()) * q.element_size())
    ms, plain, lib, (backend, lib_kernel, lib_ops), nbytes = timed(q, k, v)
    ms32, plain32, lib32, (backend32, lib_kernel32, lib_ops32), nbytes32 = \
        timed(q32, k32, v32)
    # with GQA the library takes its math path in f32; with K and V repeated
    # to every query head (a copy the kernel does not make) it may take
    # another
    g = q.shape[1] // k.shape[1]
    k32r, v32r = (x.repeat_interleave(g, dim=1) for x in (k32, v32))
    rep_call = lambda: sdpa(q32, k32r, v32r, is_causal=True)  # noqa: E731
    lib32_rep = cuda_ms(rep_call, n)
    backend32_rep = sdpa_backend(rep_call)
    del k32r, v32r
    t_ops = 1e3 * flops / H100_BF16_FLOPS
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_split = 1e3 * SPLIT_TF32_PASSES * flops / H100_TF32_FLOPS
    t_bytes32 = 1e3 * nbytes32 / HBM_BYTES_PER_S
    shape = {"q": list(q.shape), "kv": list(k.shape), "causal": True}
    tc = {"name": FA.TC_KERNEL.name, "route": "cuda",
          "source": "src/repro_torch/csrc/flash_attention_tc.cu",
          "replaces": "src/repro/kernels/flash_attention/"
                      "flash_attention.py:63",
          "launches": counts[FA.TC_KERNEL.name],
          "launches_per_prefill": counts[FA.TC_KERNEL.name],
          "max_abs_err": errs[FA.TC_KERNEL.name], "ms": ms[FA.TC_KERNEL.name],
          "path": "lm serve (bf16 prefill)", "plain_ms": plain,
          "bound_ms": max(t_ops, t_bytes),
          "bound_by": "operations" if t_ops >= t_bytes else "bytes",
          "library_ms": lib, "library_backend": backend,
          "library_kernel": lib_kernel, "library_ops": lib_ops,
          "shape": {**shape, "dtype": str(q.dtype)}, "flops": flops,
          "bytes": nbytes, "ops_bound_ms": t_ops, "bytes_bound_ms": t_bytes}
    core = {"name": FA.KERNEL.name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:63",
            "launches": counts_f32[FA.KERNEL.name],
            "launches_bf16_prefill": counts[FA.KERNEL.name],
            "max_abs_err": errs[FA.KERNEL.name], "ms": ms32[FA.KERNEL.name],
            "path": "lm f32 prefill (lm_cpu); timed on layer 0's inputs "
                    "cast to f32", "plain_ms": plain32,
            "bound_ms": max(t_split, t_bytes32),
            "bound_by": "operations" if t_split >= t_bytes32 else "bytes",
            "library_ms": lib32, "library_backend": backend32,
            "library_kernel": lib_kernel32, "library_ops": lib_ops32,
            "library_ms_repeated_kv": lib32_rep,
            "library_backend_repeated_kv": backend32_rep[0],
            "library_kernel_repeated_kv": backend32_rep[1],
            "shape": {**shape, "dtype": str(q32.dtype)}, "flops": flops,
            "bytes": nbytes32, "split_tf32_bound_ms": t_split,
            "bytes_bound_ms": t_bytes32,
            "fma_floor_ms": 1e3 * flops / H100_F32_FLOPS,
            "ms_bf16_inputs": ms[FA.KERNEL.name],
            "plain_ms_bf16_inputs": plain, "library_ms_bf16_inputs": lib,
            "bound_ms_bf16_inputs": max(t_ops, t_bytes)}
    return [tc, core]


# each crawl path of the main phase, and the kernels it must launch
PATHS = {
    "opic_url": (64, ("select_harvest", "dedup_deposit", "opic_update")),
    "opic": (16, ("frontier_select", "bloom", "opic_update")),
    "backlink": (32, ("frontier_select", "bloom")),
}


def free_card():
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def step_ms(sess, n):
    """Mean fetch- and dispatch-step ms over ``n`` eager steps, each
    between device syncs."""
    import torch
    fetch, disp = [], []
    iv = sess.cfg.dispatch_interval
    for _ in range(n):
        d = (sess.t + 1) % iv == 0
        torch.cuda.synchronize()
        t = time.perf_counter()
        sess.step()
        torch.cuda.synchronize()
        (disp if d else fetch).append(1e3 * (time.perf_counter() - t))
    return float(np.mean(fetch)), float(np.mean(disp))


def phase_main(ordering, n_shards=1):
    """One crawl path at the full config over ``n_shards`` shards: counts
    zeroed just before the run and read just after it; the path's kernels
    must all have launched, and every shard must have fetched."""
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.ordering.opic import total_cash
    steps, need = PATHS[ordering]
    cfg = scaled(webparf.CONFIG, ordering=ordering)
    label = f"{ordering} n_shards={n_shards}"
    t0 = time.time()
    sess = CrawlSession(cfg, device=DEV, n_shards=n_shards)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    cash0 = total_cash(sess.state) if ordering != "backlink" else None
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    rep = sess.run(steps)
    torch.cuda.synchronize()
    counts = launch_counts()
    missing = [n for n in need if counts[n] < 1]
    if missing:
        raise AssertionError(f"{label}: {missing} never launched on the "
                             f"path: {counts}")
    stats = rep.stats
    if rep.steps != steps or rep.fetched != stats["fetched"] or \
            (rep.per_step <= 0).any() or rep.fetched != len(rep.urls):
        raise AssertionError(f"{label}: output malformed: {stats}")
    per_shard = rep.stats_per_shard["fetched"]
    if len(per_shard) != n_shards or (per_shard <= 0).any():
        raise AssertionError(f"{label}: a shard fetched nothing: "
                             f"{per_shard}")
    out = {"phase": "main" if n_shards == 1 else "main_sharded",
           "config": f"webparf.CONFIG ordering={ordering}",
           "n_shards": n_shards, "steps": steps,
           "fetched_per_shard": per_shard.tolist()}
    if cash0 is not None:
        cash = total_cash(sess.state)
        if not np.isfinite(cash) or abs(cash - cash0) > CASH_RTOL * cash0:
            raise AssertionError(f"{label}: total cash {cash} drifted "
                                 f"from {cash0} beyond rtol {CASH_RTOL}")
        out.update(total_cash_start=cash0, total_cash_end=cash,
                   cash_rel_drift=(cash - cash0) / cash0,
                   cash_rtol=CASH_RTOL)
    # per-step times, eager, after the run (not part of the launch counts)
    fetch_ms, disp_ms = step_ms(sess, 3 * cfg.dispatch_interval)
    out.update(init_s=init_s, seconds=rep.seconds,
               pages_per_s=rep.pages_per_sec, fetched=rep.fetched,
               fetch_step_ms=fetch_ms, dispatch_step_ms=disp_ms,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               url_dup=rep.overlap["url_dup"],
               content_dup=rep.overlap["content_dup"],
               queued_urls=int(sess.state.f_valid.sum()), launches=counts,
               launches_per_step={n: c / steps for n, c in counts.items()},
               stats=stats)
    emit(out)
    return sess, counts, out


SHARDS = 4                  # the partitioned crawl's shards on one card


def phase_shards(ordering, one, four):
    """The 4-shard path against the one-shard path of the same run: each
    crawl kernel launched as many times in as many steps (the shards are
    batched, not looped), and the end-to-end numbers side by side. ``one``
    and ``four`` are (launch counts, main phase line, profile)."""
    (c1, m1, p1), (c4, m4, p4) = one, four
    diff = {k: (c1[k], c4[k]) for k in PORT_KERNEL_FNS if c1[k] != c4[k]}
    if diff:
        raise AssertionError(f"{ordering}: {SHARDS} shards launch the crawl "
                             f"kernels other than one shard in "
                             f"{PATHS[ordering][0]} steps: {diff}")

    def side(m, p):
        return {"pages_per_s": m["pages_per_s"], "fetched": m["fetched"],
                "fetch_step_ms": m["fetch_step_ms"],
                "dispatch_step_ms": m["dispatch_step_ms"],
                "device_events_per_step": p["device_events_per_call"],
                "device_busy_ms_per_step": p["device_busy_ms_per_call"],
                "host_syncs_per_step": p["sync_debug_syncs_per_step"],
                "stream_syncs_per_step": p["runtime_calls_per_call"].get(
                    "cudaStreamSynchronize", 0.0),
                "device_idle_share": p["device_idle_share"]}
    emit({"phase": "shards", "ordering": ordering, "steps":
          PATHS[ordering][0], "launches_equal": True,
          "launches": {k: c4[k] for k in PORT_KERNEL_FNS},
          "one_shard": side(m1, p1), f"{SHARDS}_shards": side(m4, p4)})


def count_syncs(sess, steps):
    """Host syncs in ``steps`` steps (``count_call_syncs``) and the
    source lines that synced most."""
    n, where = count_call_syncs(lambda: [sess.step() for _ in range(steps)])
    return n, dict(Counter(where).most_common(16))


def count_call_syncs(fn):
    """Host syncs of one ``fn()`` call: torch's sync debug mode warns on
    every synchronizing CUDA call (a device-to-host copy, a boolean-mask
    index, a tensor's truth value). Returns the count and the count by
    source line."""
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode's own notice that it is a prototype names no sync
    syncs = [w for w in caught if "synchroniz" in str(w.message)
             and "prototype" not in str(w.message)]
    return len(syncs), dict(Counter(f"{Path(w.filename).name}:{w.lineno}"
                                    for w in syncs))


def phase_profile(sess, steps):
    """Where a step's time goes: ``profile_device`` over whole dispatch
    intervals, one call a step; the host syncs are counted twice, by the
    profiler's runtime calls and by torch's sync debug mode over as many
    steps again."""
    prof = profile_device(lambda: [sess.step() for _ in range(steps)],
                          steps)
    n_sync, sync_lines = count_syncs(sess, steps)
    prof["sync_debug_syncs_per_step"] = n_sync / steps
    emit({"phase": "profile", "ordering": sess.cfg.ordering,
          "coordination": sess.cfg.coordination,
          "n_shards": sess.n_shards, "steps": steps, **prof,
          "sync_debug_lines": sync_lines})
    return prof


TRAJECTORIES = (("backlink", True), ("opic", True), ("opic_url", True),
                ("opic_url", False))


def cli_config():
    """launch/crawl.py's CLI size: 32 domains x 512, Bloom rows of 2^16."""
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    return scaled(webparf.CONFIG, n_domains=32, frontier_capacity=512,
                  fetch_batch=32, bloom_bits_log2=16, dispatch_capacity=1024,
                  url_space_log2=24)


def diff_runs(reps, states):
    """The outputs and state leaves in which the cuda and cpu runs
    differ."""
    a, b = reps["cuda"], reps["cpu"]
    diffs = [n for n in ("urls", "per_step")
             if not np.array_equal(getattr(a, n), getattr(b, n))]
    diffs += ["stats"] if a.stats != b.stats else []
    diffs += [n for n in ("fetched", "dispatch_sent", "dispatch_recv")
              if not np.array_equal(a.stats_per_shard[n],
                                    b.stats_per_shard[n])]
    diffs += [n for n in states["cuda"]
              if not np.array_equal(states["cuda"][n], states["cpu"][n])]
    return diffs


CLI_QUOTA = 512             # batched at the CLI size: half a shard's
                            # 1,024 staged URLs
# the slice-10 paths at the CLI size with SHARDS shards: label ->
# (config overrides, extra stages)
MODE_TRAJECTORIES = {
    **{f"{m}/{o}": (dict(coordination=m, ordering=o,
                         comm_quota=CLI_QUOTA if m == "batched" else -1),
                    ())
       for m in ("firewall", "crossover", "batched")
       for o in ("opic_url", "backlink")},
    "politeness/opic_url": (dict(ordering="opic_url"), (("politeness", 1),)),
    "revisit/backlink": (dict(), (("revisit", 32),)),
    "telemetry/opic_url": (dict(ordering="opic_url", telemetry=True), ()),
    "rebalance/opic_url": (dict(ordering="opic_url", telemetry=True,
                                rebalance_threshold=1.01), ()),
}


def extra_stages(spec):
    from repro_torch.core import stages as ST
    return [ST.make_politeness_stage(a) if kind == "politeness"
            else ST.make_revisit_stage(a) for kind, a in spec]


def phase_trajectory(steps=32):
    """Each ordering at the CLI size, on the card and on the CPU, with one
    shard and with SHARDS shards; then each MODE_TRAJECTORIES path with
    SHARDS shards (every coordination mode, the politeness and revisit
    stages, telemetry with its ledger rows, a forced rebalance with its
    events): every output and state leaf identical."""
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.configs.base import scaled
    from repro_torch.core.stages import state_to_numpy
    base = cli_config()
    out = {"phase": "trajectory", "config": dataclasses.asdict(base),
           "steps": steps, "runs": []}
    runs = [(f"{o} fused_dispatch={f}", n,
             dict(ordering=o, fused_dispatch=f), ())
            for n in (1, SHARDS) for o, f in TRAJECTORIES]
    runs += [(k, SHARDS, over, spec)
             for k, (over, spec) in MODE_TRAJECTORIES.items()]
    for label, n_shards, over, spec in runs:
        cfg = scaled(base, link_pop_bias=0.0 if over.get(
            "ordering", "backlink") == "backlink" else 1.0, **over)
        reps, states = {}, {}
        for key, dev in (("cuda", DEV), ("cpu", "cpu")):
            sess = CrawlSession(cfg, device=dev, n_shards=n_shards,
                                extra_stages=extra_stages(spec))
            reps[key] = sess.run(steps)
            states[key] = state_to_numpy(sess.state)
        torch.cuda.synchronize()
        a, b = reps["cuda"], reps["cpu"]
        label = f"{label} n_shards={n_shards}"
        diffs = diff_runs(reps, states)
        if cfg.telemetry and not np.array_equal(a.telemetry.rows,
                                                b.telemetry.rows):
            diffs.append("telemetry rows")
        if a.rebalances != b.rebalances:
            diffs.append("rebalances")
        if diffs:
            raise AssertionError(f"{label}: cuda and cpu trajectories "
                                 f"differ in {diffs}")
        if a.stats["dedup_bloom"] < 1:
            raise AssertionError(f"{label}: the trajectory never "
                                 f"exercised the Bloom dedup")
        if cfg.rebalance_threshold > 0 and not a.rebalances:
            raise AssertionError(f"{label}: no rebalance fired")
        run = {"path": label, "n_shards": n_shards,
               "link_pop_bias": cfg.link_pop_bias, "identical": True,
               "fetched": a.fetched, "dedup_bloom": a.stats["dedup_bloom"],
               "comm": a.comm}
        for k in ("politeness_deferred", "revisit_enqueued"):
            if a.stats[k]:
                run[k] = a.stats[k]
        if cfg.telemetry:
            run["ledger_records"] = a.telemetry.n_records
        if a.rebalances:
            run["rebalances"] = [e.asdict() for e in a.rebalances]
        out["runs"].append(run)
    emit(out)


HEAL_DEAD = 1               # the shard that fails in the heal phase


def phase_heal():
    """C4 at the CLI size over SHARDS shards, on the card and on the CPU:
    shard HEAL_DEAD fails at one dispatch boundary and is healed at the
    next, under backlink, opic_url and the batched mode (opic_url), whose
    dead shard parks what it stages. The state before the heal, the heal
    and the run after it must be identical on both devices in every leaf,
    every URL queued on the card's dead shard must be queued on a survivor
    after the card's heal, and under opic_url the cash (the outbox's
    included) must balance."""
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.configs.base import scaled
    from repro_torch.core.stages import state_to_numpy
    from repro_torch.ordering.opic import total_cash
    base = cli_config()
    iv = base.dispatch_interval
    out = {"phase": "heal", "n_shards": SHARDS, "dead_shard": HEAL_DEAD,
           "runs": []}
    for ordering, mode in (("backlink", "exchange"), ("opic_url", "exchange"),
                           ("opic_url", "batched")):
        cfg = scaled(base, ordering=ordering, coordination=mode,
                     comm_quota=CLI_QUOTA if mode == "batched" else -1,
                     link_pop_bias=0.0 if ordering == "backlink" else 1.0)
        reps, states, before, healed, cash = {}, {}, {}, {}, {}
        for key, dev in (("cuda", DEV), ("cpu", "cpu")):
            sess = CrawlSession(cfg, device=dev, n_shards=SHARDS)
            cash0 = total_cash(sess.state)
            sess.run(2 * iv)
            sess.inject_failure(HEAL_DEAD)
            sess.run(iv)
            before[key] = state_to_numpy(sess.state)
            cash_before = total_cash(sess.state)
            sess.heal()
            healed[key] = state_to_numpy(sess.state)
            cash_healed = total_cash(sess.state)
            reps[key] = sess.run(2 * iv)
            states[key] = state_to_numpy(sess.state)
            cash[key] = (cash0, cash_before, cash_healed,
                         total_cash(sess.state))
        torch.cuda.synchronize()
        label = f"heal {mode}/{ordering}"
        diffs = diff_runs(reps, states) + [
            f"{when}.{n}" for when, s in (("before_heal", before),
                                          ("healed", healed))
            for n in s["cuda"] if not np.array_equal(s["cuda"][n],
                                                     s["cpu"][n])]
        if diffs:
            raise AssertionError(f"{label}: cuda and cpu differ in {diffs}")
        per = cfg.n_slots // SHARDS
        dead = np.zeros(cfg.n_slots, bool)
        dead[HEAL_DEAD * per:(HEAL_DEAD + 1) * per] = True
        pre, after = before["cuda"], healed["cuda"]
        queued = set(pre["f_url"][dead][pre["f_valid"][dead]].tolist())
        kept = set(after["f_url"][~dead][after["f_valid"][~dead]].tolist())
        lost = queued - kept
        if not queued or lost:
            raise AssertionError(f"{label}: {len(lost)} of {len(queued)} "
                                 f"URLs queued on the dead shard lost")
        if reps["cuda"].fetched < 1:
            raise AssertionError(f"{label}: nothing fetched after the heal")
        run = {"ordering": ordering, "coordination": mode, "identical": True,
               "queued_on_dead_shard": len(queued), "lost": 0,
               "parked_on_dead_shard_before_heal": int(
                   pre["outbox_n"][HEAL_DEAD]),
               "fetched_after_heal": reps["cuda"].fetched,
               "fetched_per_shard_whole_run":
                   reps["cuda"].stats_per_shard["fetched"].tolist()}
        if mode == "batched" and not pre["outbox_n"][HEAL_DEAD]:
            raise AssertionError(f"{label}: the dead shard parked nothing")
        if ordering == "opic_url":
            c0, cb, ch, c1 = cash["cuda"]
            if abs(ch - cb) > CASH_RTOL * cb or abs(c1 - c0) > CASH_RTOL * c0:
                raise AssertionError(f"{label}: cash {c0} -> {cb} (before "
                                     f"the heal) -> {ch} (after) -> {c1}")
            run.update(total_cash_start=c0, total_cash_before_heal=cb,
                       total_cash_after_heal=ch, total_cash_end=c1,
                       cash_rtol=CASH_RTOL)
        out["runs"].append(run)
    emit(out)


# the serve phase: webparf.CONFIG (backlink) over SHARDS shards, the serve
# CLI's defaults (launch/serve_search.py) but an index of 65,536 docs,
# which 64 steps' 16,384 pages do not fill
SERVE_STEPS = 64
SERVE_KW = dict(index_capacity=65536, doc_len=64, vocab=4096, top_k=10,
                n_query_terms=8, query_batch=16, index_every=1)
SERVE_QPS, SERVE_BURST = 8.0, 6.0
SERVE_PROFILE_CALLS = 10    # query batches / folds in each profile


def serve_session(cfg, dev, **kw):
    from repro_torch.serve import QueryLoad, ServeSession
    load = QueryLoad(cfg, qps=SERVE_QPS, seed=SEED, burst_mult=SERVE_BURST)
    return ServeSession(cfg, dev, n_shards=SHARDS, load=load,
                        **{**SERVE_KW, **kw})


def phase_serve():
    """The live crawl -> index -> serve path at webparf.CONFIG with SHARDS
    shards for SERVE_STEPS steps, beside the same crawl without serving in
    this call: latency percentiles, QPS, freshness lag, recall@k against
    the full-index oracle, the index's docs and drops (none: the index
    must not fill), pages/s with and without serving, the device ms of
    one query batch and of one index fold (torch.profiler), the host syncs
    of a query batch, and each crawl kernel's launches, which must equal
    the crawl's without serving (counts zeroed just before each run, read
    just after). Returns the serve run's launch counts."""
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.kernels import launch_counts, reset_launches
    cfg = webparf.CONFIG
    sess = CrawlSession(cfg, device=DEV, n_shards=SHARDS)
    torch.cuda.synchronize()
    reset_launches()
    plain = sess.run(SERVE_STEPS, collect="counts")
    torch.cuda.synchronize()
    plain_counts = launch_counts()
    del sess
    free_card()

    t0 = time.time()
    srv = serve_session(cfg, DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    reset_launches()
    rep = srv.run(SERVE_STEPS, recall=True, collect="counts")
    torch.cuda.synchronize()
    counts = launch_counts()
    label = f"serve CONFIG n_shards={SHARDS}"
    diff = {k: (plain_counts[k], counts[k]) for k in PORT_KERNEL_FNS
            if plain_counts[k] != counts[k]}
    if diff:
        raise AssertionError(f"{label}: serving changed the crawl kernels' "
                             f"launches (without, with): {diff}")
    if any(counts[k] < 1 for k in PATHS["backlink"][1]):
        raise AssertionError(f"{label}: a backlink kernel never launched: "
                             f"{counts}")
    if rep.crawl.fetched != plain.fetched or \
            rep.crawl.stats != plain.stats:
        raise AssertionError(f"{label}: serving changed the crawl: "
                             f"{rep.crawl.stats} vs {plain.stats}")
    if rep.index_full or rep.index["index_docs"] != rep.crawl.fetched:
        raise AssertionError(f"{label}: the index holds "
                             f"{rep.index} for {rep.crawl.fetched} pages")
    # the first interval's queries meet an empty index (serve, then fold)
    later = rep.arrival_step > cfg.dispatch_interval
    if not rep.n_queries or rep.recall_at_k is None or not later.any() or \
            not np.isfinite(rep.top_scores[later]).all() or \
            not (rep.top_urls[later] > 0).all():
        raise AssertionError(f"{label}: answers malformed: "
                             f"{rep.n_queries} queries, recall "
                             f"{rep.recall_at_k}")

    # one query batch and one fold, timed on the device
    seeds = torch.arange(1, SERVE_KW["query_batch"] + 1, device=DEV)
    doms = seeds % cfg.n_domains
    query = lambda: srv._query_fn(srv.index, seeds, doms)  # noqa: E731
    q_prof = profile_device(
        lambda: [query() for _ in range(SERVE_PROFILE_CALLS)],
        SERVE_PROFILE_CALLS)
    chunk = srv.crawl.run_chunk()
    fold = lambda: srv._add_fn(srv.index, chunk)  # noqa: E731
    f_prof = profile_device(
        lambda: [fold() for _ in range(SERVE_PROFILE_CALLS)],
        SERVE_PROFILE_CALLS)
    batch_syncs, batch_lines = count_call_syncs(
        lambda: [x.cpu() for x in query()])
    fold_syncs, fold_lines = count_call_syncs(fold)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30

    def brief(p):
        return {k: p[k] for k in ("wall_ms_per_call",
                                  "device_busy_ms_per_call",
                                  "device_events_per_call",
                                  "device_idle_share",
                                  "top_device_ms_per_call")}
    out = {"phase": "serve", "config": "webparf.CONFIG ordering=backlink",
           "n_shards": SHARDS, "steps": SERVE_STEPS, **SERVE_KW,
           "qps_per_step": SERVE_QPS, "burst_mult": SERVE_BURST,
           "init_s": init_s, "n_queries": rep.n_queries,
           "p50_ms": rep.p50_ms, "p95_ms": rep.p95_ms, "p99_ms": rep.p99_ms,
           "qps": rep.qps, "freshness_lag_steps": rep.freshness_lag,
           "max_lag_steps": rep.max_lag, f"recall_at_{rep.k}":
           rep.recall_at_k, "index_docs": rep.index["index_docs"],
           "index_dropped": rep.index["index_dropped"],
           "index_capacity": rep.index["index_capacity"],
           "fetched": rep.crawl.fetched, "seconds": rep.seconds,
           "serve_seconds": rep.serve_seconds,
           "pages_per_s_with_serving": rep.crawl.fetched / rep.seconds,
           "pages_per_s_crawl_part": rep.crawl.pages_per_sec,
           "pages_per_s_without_serving": plain.pages_per_sec,
           "serving_cost_x": plain.pages_per_sec * rep.seconds
           / rep.crawl.fetched,
           "query_batch_device": brief(q_prof),
           "index_fold_device": brief(f_prof),
           "host_syncs_query_batch_with_copies": batch_syncs,
           "host_syncs_index_fold": fold_syncs,
           "sync_lines": {"query_batch": batch_lines, "fold": fold_lines},
           "launches": {k: counts[k] for k in PORT_KERNEL_FNS},
           "launches_equal_without_serving": True,
           "peak_mem_gib": peak}
    emit(out)
    return counts


SERVE_TRAJ_STEPS = 48
SERVE_TRAJ_EVENTS = {16: "fail", 24: "checkpoint", 32: "heal"}


def phase_serve_trajectory():
    """The serve CLI's config with SHARDS shards for SERVE_TRAJ_STEPS
    steps, on the card and on the CPU: shard 1 fails at step 16, a
    checkpoint at step 24 is restored into a fresh session that goes on,
    and the crawl heals at step 32. The index leaves, the served URLs,
    lags, arrivals, recall, index stats and the crawl must be identical on
    both devices, the scores within SCORE_ULP (the largest difference is
    reported). Then CrawlSession(cfg, score_fn=ranker.score_urls) on the
    card must equal the default backlink crawl in every leaf."""
    import shutil
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.core import ranker
    from repro_torch.core.stages import state_to_numpy
    cfg = cli_config()          # launch/serve_search.py's config too
    kw = dict(index_capacity=4096, doc_len=64, vocab=4096, top_k=10,
              query_batch=16, index_every=1)
    runs, index, states = {}, {}, {}
    for key, dev in (("cuda", DEV), ("cpu", "cpu")):
        ckpt = ROOT / "build" / f"serve_ckpt_{key}"
        shutil.rmtree(ckpt, ignore_errors=True)
        sess = serve_session(cfg, dev, **kw)
        reps, t = [], 0
        for nxt in (16, 24, 32, SERVE_TRAJ_STEPS):
            reps.append(sess.run(nxt - t))
            t = nxt
            ev = SERVE_TRAJ_EVENTS.get(t)
            if ev == "fail":
                sess.inject_failure(HEAL_DEAD)
            elif ev == "heal":
                sess.heal()
            elif ev == "checkpoint":
                sess.checkpoint(str(ckpt))
                sess = serve_session(cfg, dev, **kw).restore(str(ckpt))
        runs[key] = reps
        index[key] = [x.cpu().numpy() for x in sess.index]
        states[key] = state_to_numpy(sess.crawl.state)
        shutil.rmtree(ckpt, ignore_errors=True)
    torch.cuda.synchronize()
    diffs, max_ulp = [], 0
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        for f in ("top_urls", "lag_steps", "arrival_step"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                diffs.append(f"run{i}.{f}")
        fin = np.isfinite(a.top_scores)
        if not np.array_equal(fin, np.isfinite(b.top_scores)):
            diffs.append(f"run{i}.top_scores")
        elif fin.any():
            max_ulp = max(max_ulp, int(np.abs(
                a.top_scores[fin].view(np.int32).astype(np.int64)
                - b.top_scores[fin].view(np.int32).astype(np.int64)).max()))
        if (a.recall_at_k, a.index, a.crawl.stats) != \
                (b.recall_at_k, b.index, b.crawl.stats) or \
                not np.array_equal(a.crawl.urls, b.crawl.urls):
            diffs.append(f"run{i}.recall/index/crawl")
    diffs += [f"index.{i}" for i, (x, y) in enumerate(
        zip(index["cuda"], index["cpu"])) if not np.array_equal(x, y)]
    diffs += [n for n in states["cuda"]
              if not np.array_equal(states["cuda"][n], states["cpu"][n])]
    if diffs or max_ulp > SCORE_ULP:
        raise AssertionError(f"serve_trajectory: cuda and cpu differ in "
                             f"{diffs} (scores by up to {max_ulp} ulp)")
    card = runs["cuda"]
    fetched_dead = [r.crawl.stats_per_shard["fetched"][HEAL_DEAD]
                    for r in card]          # cumulative at each segment end
    if not all(r.n_queries for r in card) or card[-1].recall_at_k is None \
            or fetched_dead[1] != fetched_dead[0]:
        raise AssertionError("serve_trajectory: a segment served nothing, "
                             "or the dead shard fetched")
    # score_fn= on the card: the default backlink crawl in every leaf
    legacy = {}
    for name, extra in (("default", {}),
                        ("score_fn", {"score_fn": ranker.score_urls})):
        sess = CrawlSession(cfg, device=DEV, n_shards=SHARDS, **extra)
        rep = sess.run(32)
        legacy[name] = (rep.urls, state_to_numpy(sess.state))
    (ua, sa), (ub, sb) = legacy["default"], legacy["score_fn"]
    bad = [n for n in sa if not np.array_equal(sa[n], sb[n])]
    if bad or not np.array_equal(ua, ub):
        raise AssertionError(f"score_fn=ranker.score_urls differs from the "
                             f"default on the card in {bad or ['urls']}")
    emit({"phase": "serve_trajectory", "config": dataclasses.asdict(cfg),
          "n_shards": SHARDS, "steps": SERVE_TRAJ_STEPS,
          "events": SERVE_TRAJ_EVENTS, "dead_shard": HEAL_DEAD, **kw,
          "identical": True, "max_score_ulp": max_ulp,
          "score_ulp_bound": SCORE_ULP,
          "segments": [{"n_queries": r.n_queries, "recall": r.recall_at_k,
                        "lag": r.freshness_lag, "index": r.index,
                        "fetched": r.crawl.fetched} for r in card],
          "score_fn_equals_default": True, "score_fn_fetched": len(ua)})


def twin(x):
    """A copy of ``x`` laid out as ``x`` is: the same strides and storage
    offset, so a strided view of a wider array stays one."""
    import torch
    span = 1 + sum((n - 1) * s for n, s in zip(x.shape, x.stride()))
    buf = torch.empty(x.storage_offset() + span, dtype=x.dtype,
                      device=x.device)
    y = buf.as_strided(x.shape, x.stride(), x.storage_offset())
    y.copy_(x)
    return y


CAPTURE_DRIVES = 256        # drives capture_calls makes before it fails


def capture_calls(modules, attr, drive, n, pick=lambda args: True,
                  layout=False):
    """The arguments of the next ``n`` calls to ``attr`` (patched on every
    module in ``modules``, where the path looks it up) for which
    ``pick(args)`` holds, cloned as they were passed (``layout``: with
    their strides and offsets, ``twin``), while ``drive()`` (a session's
    step, a prefill) runs, at most CAPTURE_DRIVES times."""
    import torch
    got = []
    origs = [getattr(m, attr) for m in modules]
    copy = twin if layout else (lambda a: a.clone())

    def spy(*args, **kw):
        if len(got) < n and pick(args):
            got.append(([copy(a) if isinstance(a, torch.Tensor) else a
                         for a in args], dict(kw)))
        return origs[0](*args, **kw)
    for m in modules:
        setattr(m, attr, spy)
    try:
        for _ in range(CAPTURE_DRIVES):
            if len(got) >= n:
                break
            drive()
        if len(got) < n:
            raise AssertionError(f"{attr}: {len(got)} of {n} calls in "
                                 f"{CAPTURE_DRIVES} drives")
    finally:
        for m, o in zip(modules, origs):
            setattr(m, attr, o)
    return got


BLOOM_MASKS = 4             # dispatch masks captured for bloom's timing


def capture_dispatch_masks(sess, n):
    """The live-lane masks of the next n dispatches, as dispatch_exchange
    hands its (rows, M) batches to the Bloom dedup: each row's live URLs
    packed at its front by router.pack_buckets."""
    from repro_torch.core import dedup as DD
    return [args[2] for args, _ in
            capture_calls([DD], "probe_insert", sess.step, n)]


def fresh_urls(rng, masks, n, cfg):
    """n + 1 batches laid out as the captured masks, holding fresh URLs."""
    import torch
    out = []
    for i in range(n + 1):
        m = masks[i % len(masks)]
        u = torch.zeros(m.shape, dtype=torch.int64, device=DEV)
        u[m] = torch.tensor(rng.integers(0, 1 << cfg.url_space_log2,
                                         int(m.sum())), device=DEV)
        out.append((u, m))
    return out


def bloom_bytes(batches, kh, b, word_bytes=1):
    """What a Bloom probe-and-insert must move for each batch: every lane's
    mask and seen flag, the live URLs in 32-byte sectors, k probe bytes (k
    words of ``word_bytes`` packed) per live URL; and the filter positions
    it may newly set (to count them around the timed calls). Returns
    (bytes, live URLs, positions)."""
    import torch
    from repro_torch.kernels.bloom.ref import _bit_indices
    nbytes, n_live, pos = 0, 0, []
    for u, m in batches:
        R, M = m.shape
        live = torch.nonzero(m.view(-1))[:, 0]
        n_live += live.numel()
        nbytes += 2 * R * M + 32 * torch.unique(live // 4).numel() \
            + word_bytes * kh * live.numel()
        rows = torch.nonzero(m)[:, :1]
        pos.append((rows * (1 << b) + _bit_indices(u, kh, b)[m]).view(-1))
    return nbytes, n_live, torch.unique(torch.cat(pos))


def row(name, source, replaces, counts, steps, errs, ms, plain, nbytes, lib,
        **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "launches_per_step": counts[name] / steps if steps else None,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain,
            "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S, "bound_by": "bytes",
            "library_ms": lib, **extra}


def pop_bytes(valid, k, harvest=False):
    """What a pop of k cells a row must move: every cell's valid flag and
    each valid cell's priority read; per row k popped url/pri/mask written
    (and the cash, for the harvest); per popped cell its url read, pri and
    valid written (and its cash read and zeroed). Returns (those bytes, the
    same with every priority read)."""
    import torch
    R, C = valid.shape
    popped = int(torch.clamp(valid.sum(dim=1), max=k).sum())
    out = R * k * (8 + 4 + 1) + popped * (8 + 4 + 1)
    if harvest:
        out += 4 * R * k + 8 * popped
    return R * C + 4 * int(valid.sum()) + out, 5 * R * C + out


def kernels_backlink(sess, counts, errs, steps, prof):
    """frontier_select and bloom on the backlink path's own inputs; their
    per-launch device time inside the crawl from its profile ``prof``."""
    import torch
    from repro_torch.kernels.bloom.ops import probe_insert
    from repro_torch.kernels.bloom.ref import bloom_ref
    from repro_torch.kernels.frontier_select.ops import select
    from repro_torch.kernels.frontier_select.ref import NEG, select_ref
    cfg = sess.cfg
    n = 50
    out = []
    # frontier_select on the session's own frontier: (512, 4096), k = 1
    st = sess.state
    R, C = st.f_url.shape
    k = 1
    url = st.f_url
    pri, valid = st.f_pri.clone(), st.f_valid.clone()
    nbytes, dense = pop_bytes(st.f_valid, k)
    n_valid = int(st.f_valid.sum())
    dense = 1e3 * dense / HBM_BYTES_PER_S
    t = pop_times(lambda p, v: lambda: select(url, p, v, k=k),
                  (pri, valid))
    p_r, v_r = pri.clone(), valid.clone()
    plain = cuda_ms(lambda: select_ref(url, p_r, v_r, k=k), n)
    lib = pop_times(lambda p, v: lambda: torch.topk(
        torch.where(v, p, NEG), k, dim=1), (pri, valid))
    out.append(row("frontier_select", "src/repro_torch/csrc/frontier_select.cu",
                   "src/repro/kernels/frontier_select/frontier_select.py:85",
                   counts, steps, errs, t["events_ms"], plain, nbytes,
                   lib["events_ms"], path="backlink", **t,
                   valid_cells=n_valid, dense_bound_ms=dense,
                   in_crawl_device_ms=in_crawl_ms(prof, "frontier_select"),
                   **{f"library_{key}": v for key, v in lib.items()}))
    del pri, valid, p_r, v_r
    # bloom on the session's 8 GiB filter, with batches laid out as the
    # next dispatches lay them out (their masks), holding fresh URLs
    kh, b = cfg.bloom_hashes, cfg.bloom_bits_log2
    masks = capture_dispatch_masks(sess, BLOOM_MASKS)
    R, M = masks[0].shape
    rng = np.random.default_rng(SEED + 1)
    kern_b, plain_b = fresh_urls(rng, masks, n, cfg), \
        fresh_urls(rng, masks, n, cfg)
    nbytes, n_live, pos = bloom_bytes(kern_b, kh, b)
    flat = st.bloom_bits.view(-1)
    before = flat[pos]
    it = iter(kern_b)
    ms = cuda_ms(lambda: probe_insert(st.bloom_bits, *next(it), k=kh), n)
    n_new = int(((before == 0) & (flat[pos] == 1)).sum())
    nbytes = (nbytes + n_new) / len(kern_b)
    it = iter(plain_b)
    plain = cuda_ms(lambda: bloom_ref(st.bloom_bits, *next(it), k=kh), n)
    run = lambda u, m: probe_insert(st.bloom_bits, u, m, k=kh)  # noqa: E731
    graph = {"graph_ms": fresh_graph_ms(run, kern_b[:n], cfg.url_space_log2,
                                        cold=False),
             "graph_cold_ms": fresh_graph_ms(
                 run, [(u, m.clone()) for u, m in plain_b[:n]],
                 cfg.url_space_log2, cold=True)}
    out.append(row("bloom", "src/repro_torch/csrc/bloom.cu",
                   "src/repro/kernels/bloom/bloom.py:61", counts, steps, errs,
                   ms, plain, nbytes, None, path="backlink", shape=[R, M],
                   live_urls=n_live / len(kern_b),
                   new_bytes=n_new / len(kern_b), events_ms=ms, **graph,
                   in_crawl_device_ms=in_crawl_ms(prof, "bloom")))
    return out


def scatter_bytes(cash, rows, mask):
    """What a cash scatter-add must move: every item's mask, each live
    item's row (8 B) and contribution (4 B), and each touched target read
    and written once."""
    import torch
    B, R = cash.shape
    live = mask & (rows >= -R) & (rows < R)
    tgt = torch.where(rows < 0, rows + R, rows)
    b = torch.arange(B, device=rows.device)[:, None].expand_as(rows)
    touched = torch.unique((b * R + tgt)[live]).numel()
    return mask.numel() + 12 * int(live.sum()) + 8 * touched


def graph_ms(fn, n):
    """Milliseconds a call of ``fn()`` takes on the card with the host out
    of the way: n calls captured in one CUDA graph, replayed, timed by
    CUDA events. A kernel of a few microseconds launched from Python is
    timed by ``cuda_ms`` at the host's launch rate, not its own."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    return cuda_ms(g.replay, 5) / n


def device_ms(fn, n):
    """Mean device milliseconds of ``fn()`` over n calls: the time its
    kernels ran on the card (torch.profiler), without the host's launch
    time, which back-to-back CUDA-event timing of a few-microsecond kernel
    measures instead."""
    fn()
    return profile_device(lambda: [fn() for _ in range(n)],
                          n)["device_busy_ms_per_call"]


POP_CALLS = 48              # calls a pop's timing graph holds
WARM_COPIES = 8             # copies of the inputs its warm graph cycles over
FLUSH_BYTES = 128 << 20     # written to push the 50 MB L2 out


def replay_ms(calls, before, reps=5):
    """Milliseconds a call takes in one CUDA graph that makes each of
    ``calls`` once, in order: the median over ``reps`` replays, after one
    that warms up, each preceded by ``before()`` outside the timed span."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for call in calls:
            call()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    times = []
    for r in range(reps + 1):
        before()
        start.record()
        g.replay()
        stop.record()
        torch.cuda.synchronize()
        if r:
            times.append(start.elapsed_time(stop) / len(calls))
    return float(np.median(times))


def pop_times(call_on, inputs, n=POP_CALLS):
    """A pop kernel's (or its yardstick's) times on copies of ``inputs``,
    the tensors it updates in place; ``call_on(*copy)`` makes the call.
    Every copy is restored from ``inputs`` before each timed run, so each
    call pops from the captured frontier, as the crawl's pop does:
    ``events_ms``, n calls on one copy by back-to-back CUDA events;
    ``graph_ms``, n calls cycling over WARM_COPIES copies in one CUDA graph
    (a copy's second to last calls find it in L2); ``graph_cold_ms``, one
    call on each of n copies in one graph, the L2 flushed after the
    restore (each call finds its rows in device memory: n x 2-10 MB);
    ``device_ms``, the kernels' device time over n calls, one a copy."""
    import itertools
    import torch
    copies = [[x.clone() for x in inputs] for _ in range(n)]
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)

    def restore(cold=False):
        for c in copies:
            for a, b in zip(c, inputs):
                a.copy_(b)
        if cold:
            flush.fill_(0)
    calls = [call_on(*c) for c in copies]
    restore()
    out = {"events_ms": cuda_ms(calls[0], n)}
    out["graph_ms"] = replay_ms(
        [calls[i % WARM_COPIES] for i in range(n)], restore)
    out["graph_cold_ms"] = replay_ms(calls, lambda: restore(cold=True))
    restore()
    it = itertools.cycle(calls)
    out["device_ms"] = device_ms(lambda: next(it)(), n - 1)
    return out


def fresh_graph_ms(run, batches, url_space_log2, *, cold, seed=SEED + 7):
    """Milliseconds a call of ``run(*batch)`` takes in one CUDA graph that
    makes one call on each of ``batches`` (static inputs). Before each
    replay, outside the timed span, every batch's live URLs are XORed with
    a fresh draw, so each call probes and inserts URLs the filter has not
    seen, as the crawl's dispatches do (a replayed batch would be all seen:
    no inserts, and for dedup_deposit a twin scan per URL). Warm: that
    rewrite leaves the live URLs in L2, as the router's packing leaves a
    dispatch batch. ``cold``: a buffer of FLUSH_BYTES is written next, so
    the batches (give each its own mask) come from device memory. The
    filter's probed bytes lie at random in 8 GiB either way. Calls on the
    same batches take distinct seeds: the XORs of one seed, made twice,
    would bring the first call's URLs back."""
    import torch
    rng = np.random.default_rng(seed)
    flat = [(b[0].view(-1), torch.nonzero(b[1].view(-1))[:, 0])
            for b in batches]
    flush = (torch.empty(FLUSH_BYTES // 4, dtype=torch.int32, device=DEV)
             if cold else None)

    def refresh():
        c = int(rng.integers(1, 1 << url_space_log2))
        for u, live in flat:
            u[live] = u[live] ^ c
        if cold:
            flush.fill_(0)
    return replay_ms([lambda b=b: run(*b) for b in batches], refresh)


def time_scatter(args, n):
    """opic_update, its plain version and index_add_ (the library call
    that sums the same items into the same targets, in its own order) on
    captured (cash, rows, contrib, mask); for the kernel and index_add_
    also the time a call takes in a CUDA graph (``graph_ms``) and the
    kernel's own time (``device_ms``), both free of the host's launch."""
    import torch
    from repro_torch.kernels.opic_update.ops import scatter_cash
    from repro_torch.kernels.opic_update.ref import opic_ref
    cash, rows, contrib, mask = args
    c1, c2, c3 = cash.clone(), cash.clone(), cash.clone()
    ms = cuda_ms(lambda: scatter_cash(c1, rows, contrib, mask), n)
    plain = cuda_ms(lambda: opic_ref(c2, rows, contrib, mask), n)
    B, R = cash.shape
    live = mask & (rows >= -R) & (rows < R)
    tgt = torch.where(rows < 0, rows + R, rows)
    flat = (torch.arange(B, device=rows.device)[:, None] * R + tgt)[live]
    vals = contrib[live]
    lib = cuda_ms(lambda: c3.view(-1).index_add_(0, flat, vals), n)
    kern = lambda: scatter_cash(c1, rows, contrib, mask)  # noqa: E731
    libc = lambda: c3.view(-1).index_add_(0, flat, vals)  # noqa: E731
    dev = {"graph_ms": graph_ms(kern, n), "device_ms": device_ms(kern, n),
           "library_graph_ms": graph_ms(libc, n),
           "library_device_ms": device_ms(libc, n)}
    return (ms, plain, lib, scatter_bytes(cash, rows, mask),
            max_items_per_target(cash, rows, live), dev)


DEDUP_CALLS = 8             # captured crawl calls of dedup_deposit timed


def capture_dedup(sess, n):
    """The next n ``dedup_deposit`` calls of the fused opic_url path, as
    ``stages.py`` makes them: the batch (urls, mask, val), the frontier
    (f_url, f_valid) and the url lane, cloned before the call (the lane
    into a strided view of a wider array, as ``order_state[:, 2:]`` lays it
    out); the filter bytes the batch probes, with their values before the
    call; and what the call returned in the crawl. The filter itself (8
    GiB) is not copied."""
    import torch
    from repro_torch.core import stages as ST
    from repro_torch.kernels.bloom.ref import _bit_indices
    kh, b = sess.cfg.bloom_hashes, sess.cfg.bloom_bits_log2
    got = []
    orig = ST.dedup_deposit

    def spy(bits, urls, mask, val, f_url, f_valid, table, **kw):
        if len(got) >= n:
            return orig(bits, urls, mask, val, f_url, f_valid, table, **kw)
        rows = torch.nonzero(mask)[:, :1]
        pos = torch.unique(
            (rows * (1 << b) + _bit_indices(urls, kh, b)[mask]).view(-1))
        R, C = table.shape
        lane = torch.empty((R, C + 2), dtype=table.dtype,
                           device=table.device)[:, 2:]
        lane.copy_(table)
        c = {"urls": urls.clone(), "mask": mask.clone(), "val": val.clone(),
             "f_url": f_url.clone(), "f_valid": f_valid.clone(),
             "lane": lane, "lane0": lane.clone(), "pos": pos,
             "bits0": bits.view(-1)[pos].clone()}
        seen, refund = orig(bits, urls, mask, val, f_url, f_valid, table,
                            **kw)
        c["crawl"] = (seen.clone(), refund.clone(), table.clone())
        got.append(c)
        return seen, refund
    ST.dedup_deposit = spy
    try:
        while len(got) < n:
            sess.step()
    finally:
        ST.dedup_deposit = orig
    return got


class DedupReplay:
    """Captured ``dedup_deposit`` calls (``capture_dedup``) replayed on the
    session's own filter. ``restore()`` puts every filter byte the calls
    probe back as it was before the first of them (latest call first, so
    the earliest value wins) and every lane cell a call deposits into back
    as it was before that call; the calls made in capture order then see
    exactly what they saw in the crawl. ``call(i, fn)`` makes call i
    through ``fn`` (``dedup_deposit`` or a variant of the same
    signature). ``check(fn)`` holds fn's seen, refund, lane and filter
    bytes to the plain version's with torch.equal, after holding the
    plain version's to the crawl's own."""

    def __init__(self, bits, caps, k):
        import torch
        from repro_torch.kernels.dedup_deposit.ref import (dedup_deposit_ref,
                                                           first_twin,
                                                           sorted_queue)
        self.bits, self.flat, self.caps, self.k = bits, bits.view(-1), caps, k
        self.cells = [None] * len(caps)
        self.want = self.run_all(dedup_deposit_ref)
        for i, (c, w) in enumerate(zip(caps, self.want)):
            for a, b_, what in zip(w[:3], c["crawl"], ("seen", "refund",
                                                       "lane")):
                if not torch.equal(a, b_):
                    raise AssertionError(f"dedup replay {i}: the plain "
                                         f"version's {what} differs from "
                                         f"the crawl's call (the restore "
                                         f"or the kernel is wrong)")
            changed = torch.nonzero(c["lane"] != c["lane0"])
            ri, ci = changed[:, 0], changed[:, 1]
            self.cells[i] = (ri, ci, c["lane0"][ri, ci])
            c["twins"] = int(first_twin(c["urls"], w[0], sorted_queue(
                c["f_url"], c["f_valid"]))[0].sum())
        self.restore()

    def restore(self):
        for c in reversed(self.caps):
            self.flat[c["pos"]] = c["bits0"]
        for c, cell in zip(self.caps, self.cells):
            if cell is None:
                c["lane"].copy_(c["lane0"])
            else:
                c["lane"][cell[0], cell[1]] = cell[2]

    def call(self, i, fn):
        c = self.caps[i]
        return fn(self.bits, c["urls"], c["mask"], c["val"], c["f_url"],
                  c["f_valid"], c["lane"], k=self.k)

    def run_all(self, fn):
        """Restore, then every call in order: [(seen, refund, lane after,
        filter bytes after)]."""
        self.restore()
        out = []
        for i, c in enumerate(self.caps):
            seen, refund = self.call(i, fn)
            out.append((seen, refund, c["lane"].clone(),
                        self.flat[c["pos"]].clone()))
        return out

    def check(self, fn, label):
        import torch
        got = self.run_all(fn)
        torch.cuda.synchronize()
        self.restore()
        for i, (g, w) in enumerate(zip(got, self.want)):
            for a, b_, what in zip(g, w, ("seen", "refund", "lane",
                                          "filter")):
                if not torch.equal(a, b_):
                    raise AssertionError(f"{label}: captured call {i}: "
                                         f"{what} differs from the plain "
                                         f"version")

    def counts(self):
        """Live URLs, seen URLs and twin hits over the calls."""
        return (sum(int(c["mask"].sum()) for c in self.caps),
                sum(int(w[0].sum()) for w in self.want),
                sum(c["twins"] for c in self.caps))

    def nbytes(self, kh):
        """What the calls must move, each on average, from their data: every
        lane's mask and seen flag (1 B), the live URLs (32-byte sectors) and
        values (4 B), k filter bytes a live URL and the bytes it newly sets,
        the refund; for each row with a seen URL its f_valid bytes and 8 B
        for each valid cell (the URL it compares); each lane cell deposited
        into read and written once."""
        import torch
        total = 0
        for c, w, cell in zip(self.caps, self.want, self.cells):
            R, M = c["mask"].shape
            live = torch.nonzero(c["mask"].view(-1))[:, 0]
            total += 2 * R * M + 32 * torch.unique(live // 4).numel() \
                + (4 + kh) * live.numel() + 4 * R
            total += int(((c["bits0"] == 0) & (w[3] == 1)).sum())
            rows = w[0].any(dim=1)
            total += c["f_valid"].shape[1] * int(rows.sum()) \
                + 8 * int(c["f_valid"][rows].sum())
            total += 8 * cell[0].numel()
        return total / len(self.caps)

    def graph_ms(self, fn, *, cold):
        """Milliseconds a call takes in one CUDA graph that makes every
        captured call once, in order, through ``fn``; before each replay
        the state is restored (outside the timed span) and, ``cold``, the
        L2 flushed."""
        import torch
        flush = (torch.empty(FLUSH_BYTES // 4, dtype=torch.int32,
                             device=DEV) if cold else None)

        def before():
            self.restore()
            if cold:
                flush.fill_(0)
        calls = [lambda i=i: self.call(i, fn) for i in range(len(self.caps))]
        t = replay_ms(calls, before)
        self.restore()
        return t


def capture_bloom(sess, n):
    """The next n ``bloom`` calls of the path's dispatches (``dedup.
    probe_insert``): the batch (urls, mask) cloned, the filter bytes it
    probes with their values before the call, and the call's ``seen`` in
    the crawl."""
    import torch
    from repro_torch.core import dedup as DD
    b = sess.cfg.bloom_bits_log2
    got = []
    orig = DD.probe_insert

    def spy(bl, urls, mask, *, k, url_tile=256):
        if len(got) >= n:
            return orig(bl, urls, mask, k=k, url_tile=url_tile)
        rows = torch.nonzero(mask)[:, :1]
        pos = torch.unique(
            (rows * (1 << b) + DD._bit_indices(urls, k, b)[mask]).view(-1))
        c = {"urls": urls.clone(), "mask": mask.clone(), "tile": url_tile,
             "pos": pos, "bits0": bl.bits.view(-1)[pos].clone()}
        seen, out = orig(bl, urls, mask, k=k, url_tile=url_tile)
        c["crawl"] = seen.clone()
        got.append(c)
        return seen, out
    DD.probe_insert = spy
    try:
        for _ in range(8 * n * sess.cfg.dispatch_interval):
            if len(got) >= n:
                break
            sess.step()
    finally:
        DD.probe_insert = orig
    if len(got) < n:
        raise AssertionError(f"bloom: {len(got)} of {n} dispatches captured")
    return got


class BloomReplay:
    """Captured ``bloom`` calls (``capture_bloom``) replayed on the
    session's own filter, as ``DedupReplay`` replays dedup_deposit's: each
    replay first puts every probed byte back as it was before the first
    call. ``check(fn)`` holds fn's seen and filter bytes to the plain
    version's with torch.equal, after holding the plain version's seen to
    the crawl's own."""

    def __init__(self, bits, caps, k):
        import torch
        from repro_torch.kernels.bloom.ref import bloom_ref
        self.bits, self.flat, self.caps, self.k = bits, bits.view(-1), caps, k
        self.want = self.run_all(bloom_ref)
        for i, (c, w) in enumerate(zip(caps, self.want)):
            if not torch.equal(w[0], c["crawl"]):
                raise AssertionError(f"bloom replay {i}: the plain "
                                     f"version's seen differs from the "
                                     f"crawl's call (the restore or the "
                                     f"kernel is wrong)")

    def restore(self):
        for c in reversed(self.caps):
            self.flat[c["pos"]] = c["bits0"]

    def call(self, i, fn):
        c = self.caps[i]
        return fn(self.bits, c["urls"], c["mask"], k=self.k,
                  url_tile=c["tile"])

    def run_all(self, fn):
        """Restore, then every call in order: [(seen, filter bytes after)];
        the filter is left as the crawl left it."""
        self.restore()
        return [(self.call(i, fn), self.flat[c["pos"]].clone())
                for i, c in enumerate(self.caps)]

    def check(self, fn, label):
        import torch
        got = self.run_all(fn)
        torch.cuda.synchronize()
        for i, (g, w) in enumerate(zip(got, self.want)):
            for a, b_, what in zip(g, w, ("seen", "filter")):
                if not torch.equal(a, b_):
                    raise AssertionError(f"{label}: captured call {i}: "
                                         f"{what} differs from the plain "
                                         f"version")

    def nbytes(self, kh, b):
        """What a call must move, on average (``bloom_bytes``, plus the
        bytes it newly sets)."""
        nbytes, _, _ = bloom_bytes([(c["urls"], c["mask"])
                                    for c in self.caps], kh, b)
        new = sum(int(((c["bits0"] == 0) & (w[1] == 1)).sum())
                  for c, w in zip(self.caps, self.want))
        return (nbytes + new) / len(self.caps)

    def graph_ms(self, fn):
        """Milliseconds a call takes in one CUDA graph that makes every
        captured call once, in order, the filter restored before each
        replay (outside the timed span); the last replay leaves it as the
        crawl left it."""
        calls = [lambda i=i: self.call(i, fn) for i in range(len(self.caps))]
        return replay_ms(calls, self.restore)


def kernels_opic(sess):
    """opic_update at the opic path's spend: the stage's own (1, 8192)
    items onto the 512 slot cash entries, with its longest per-target
    chain."""
    from repro_torch.ordering import opic as OP
    (args, kw), = capture_calls([OP], "scatter_cash", sess.step, 1)
    ms, plain, lib, nbytes, chain, dev = time_scatter(args, 50)
    return {"spend_shape": list(args[1].shape), "spend_ms": ms,
            "spend_plain_ms": plain, "spend_library_ms": lib,
            "spend_bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
            "spend_live_items": int(args[3].sum()),
            "spend_max_items_per_target": chain,
            **{f"spend_{k}": v for k, v in dev.items()}}


def kernels_opic_url(sess, counts, errs, steps, prof):
    """select_harvest, dedup_deposit and opic_update on the opic_url path's
    own inputs: its frontier and url lane, a dispatch batch laid out as the
    path lays it out, and its largest cell scatter (the dispatch's
    place_valued: 512 rows x 4096 items)."""
    import torch
    from repro_torch.core import frontier as F
    from repro_torch.kernels.dedup_deposit.ops import dedup_deposit
    from repro_torch.kernels.dedup_deposit.ref import dedup_deposit_ref
    from repro_torch.kernels.frontier_select.ops import select_harvest
    from repro_torch.kernels.frontier_select.ref import (NEG,
                                                         select_harvest_ref)
    from repro_torch.core import stages as ST
    from repro_torch.ordering.opic_url import url_cash_table
    cfg = sess.cfg
    n = 50
    out = []
    st = sess.state
    R, C = st.f_url.shape
    k = 1
    url = st.f_url
    lane = url_cash_table(st)
    pvt = (st.f_pri.clone(), st.f_valid.clone(), lane.clone())
    nbytes, dense = pop_bytes(st.f_valid, k, harvest=True)
    n_valid = int(st.f_valid.sum())
    dense = 1e3 * dense / HBM_BYTES_PER_S
    t = pop_times(lambda *x: lambda: select_harvest(url, *x, k=k), pvt)
    plain_in = [x.clone() for x in pvt]
    plain = cuda_ms(lambda: select_harvest_ref(url, *plain_in, k=k), n)

    def topk_gather(p, v, tab):
        idx = torch.topk(torch.where(v, p, NEG), k, dim=1).indices
        return torch.gather(tab, 1, idx)
    lib = pop_times(lambda *x: lambda: topk_gather(*x), pvt)
    out.append(row("select_harvest", "src/repro_torch/csrc/frontier_select.cu",
                   "src/repro/kernels/frontier_select/frontier_select.py:116",
                   counts, steps, errs, t["events_ms"], plain, nbytes,
                   lib["events_ms"], path="opic_url", **t,
                   valid_cells=n_valid, dense_bound_ms=dense,
                   in_crawl_device_ms=in_crawl_ms(prof, "select_harvest"),
                   **{f"library_{key}": v for key, v in lib.items()}))
    del pvt, plain_in
    # opic_update: the dispatch's place_valued cell scatter, captured (the
    # allocate give-backs scatter one item a row)
    (args, kw), = capture_calls([F], "scatter_cash_cells", sess.step, 1,
                                pick=lambda a: a[2].shape[1] > 1)
    table, _, cols, vals, fits = args
    # the calls reach scatter_cash as the row-aligned batch
    ok = fits & (cols >= 0) & (cols < C)
    ms_c, plain_c, lib_c, nb_c, chain_c, dev_c = time_scatter(
        (table, cols, vals, ok), n)
    # dedup_deposit: batches laid out as the next dispatches (their
    # masks), fresh URLs and values, against the live frontier and lane
    masks = [args[2] for args, _ in capture_calls(
        [ST], "dedup_deposit", sess.step, 4)]
    Rb, M = masks[0].shape
    rng = np.random.default_rng(SEED + 2)
    kh, b = cfg.bloom_hashes, cfg.bloom_bits_log2

    def batches():
        return [(u, m, torch.tensor(rng.random(m.shape), dtype=torch.float32,
                                    device=DEV))
                for u, m in fresh_urls(rng, masks, n, cfg)]
    kern_b, plain_b = batches(), batches()
    nbytes, n_live, pos = bloom_bytes([(u, m) for u, m, _ in kern_b],
                                      kh, b)
    # plus each live URL's value (4 B) and the (R,) refund; with fresh URLs
    # no URL is seen, so no queue is read and no cell written
    nbytes += 4 * n_live + 4 * Rb * len(kern_b)
    flat = st.bloom_bits.view(-1)
    before = flat[pos]
    lane = url_cash_table(st)
    it = iter(kern_b)
    seen_tot = []

    def kern():
        s, _ = dedup_deposit(st.bloom_bits, *next(it), st.f_url, st.f_valid,
                             lane, k=kh)
        seen_tot.append(s)
    ms_d = cuda_ms(kern, n)
    n_new = int(((before == 0) & (flat[pos] == 1)).sum())
    n_seen = int(sum(int(s.sum()) for s in seen_tot))
    nbytes = (nbytes + n_new) / len(kern_b)
    it = iter(plain_b)
    plain_d = cuda_ms(lambda: dedup_deposit_ref(
        st.bloom_bits, *next(it), st.f_url, st.f_valid, lane, k=kh), n)
    run = lambda u, m, v: dedup_deposit(  # noqa: E731
        st.bloom_bits, u, m, v, st.f_url, st.f_valid, lane, k=kh)
    graph = {"graph_ms": fresh_graph_ms(run, kern_b[:n], cfg.url_space_log2,
                                        cold=False),
             "graph_cold_ms": fresh_graph_ms(
                 run, [(u, m.clone(), v) for u, m, v in plain_b[:n]],
                 cfg.url_space_log2, cold=True)}
    # and on the crawl's own next calls (queued URLs re-sent: seen URLs,
    # twin deposits, refunds), their state restored before each replay
    rep = DedupReplay(sess.state.bloom_bits,
                      capture_dedup(sess, DEDUP_CALLS), kh)
    rep.check(dedup_deposit, "dedup_deposit")
    c_live, c_seen, c_twins = rep.counts()
    n_cap = len(rep.caps)
    graph.update(
        captured_calls=n_cap, captured_live_urls=c_live / n_cap,
        captured_seen=c_seen / n_cap, captured_twins=c_twins / n_cap,
        captured_graph_ms=rep.graph_ms(dedup_deposit, cold=False),
        captured_graph_cold_ms=rep.graph_ms(dedup_deposit, cold=True),
        captured_bound_ms=1e3 * rep.nbytes(kh) / HBM_BYTES_PER_S)
    del rep
    out.append(row("dedup_deposit", "src/repro_torch/csrc/dedup_deposit.cu",
                   "src/repro/kernels/dedup_deposit/dedup_deposit.py:105",
                   counts, steps, errs, ms_d, plain_d, nbytes, None,
                   path="opic_url", shape=[Rb, M, C],
                   live_urls=n_live / len(kern_b),
                   new_bytes=n_new / len(kern_b), seen=n_seen, events_ms=ms_d,
                   **graph, in_crawl_device_ms=in_crawl_ms(prof,
                                                           "dedup_deposit")))
    out.append(row("opic_update", "src/repro_torch/csrc/opic_update.cu",
                   "src/repro/kernels/opic_update/opic_update.py:41",
                   counts, steps, errs, ms_c, plain_c, nb_c, lib_c,
                   path="opic_url", shape=list(cols.shape),
                   live_items=int(ok.sum()), max_items_per_target=chain_c,
                   **dev_c))
    return out


def packed_batches(rng, masks, st, n, url_space_log2):
    """n + 1 batches (urls, mask, values) laid out as the captured dispatch
    masks. The first holds fresh URLs; each later one sends, a third each,
    URLs still queued in the lane's frontier row (seen, with a queued twin),
    URLs of the batch before (inserted by then: seen, a refund unless
    queued) and fresh URLs."""
    import torch
    fu, fv = st.f_url.cpu().numpy(), st.f_valid.cpu().numpy()
    out, prev = [], None
    for i in range(n + 1):
        m = masks[i % len(masks)].cpu().numpy()
        R, M = m.shape
        rows = np.arange(R)[:, None]
        u = rng.integers(0, 1 << url_space_log2, (R, M))
        if prev is not None:
            pick = rng.random((R, M))
            for src, ok, lo, hi in ((fu, fv, 0.0, 1 / 3),
                                    (prev[0], prev[1], 1 / 3, 2 / 3)):
                order = np.argsort(~ok, axis=1, kind="stable")
                cnt = ok.sum(axis=1)[:, None]
                j = np.minimum((rng.random((R, M)) * cnt).astype(np.int64),
                               np.maximum(cnt - 1, 0))
                u = np.where((pick >= lo) & (pick < hi) & (cnt > 0),
                             src[rows, order[rows, j]], u)
        u = np.where(m, u, 0)
        out.append((torch.tensor(u, device=DEV), masks[i % len(masks)],
                    torch.tensor(rng.random((R, M)), dtype=torch.float32,
                                 device=DEV)))
        prev = (u, m)
    return out


def bits_at(words, pos):
    """The filter bits at flat positions ``pos`` of packed int32 words."""
    import torch
    return (words.view(-1)[pos >> 5] >> (pos & 31).to(torch.int32)) & 1


def phase_packed(sess, errs, n_mixed=3, n_boundary=4):
    """The packed Bloom family's entry points at the full CONFIG filter:
    ``st.bloom_bits`` (512 rows of 2^24 bytes) is packed once into 1 GiB of
    words, and dispatch batches laid out as the path's own (their masks,
    captured) go through the byte-per-bit ``bloom`` and ``dedup_deposit``
    and through ``bloom_packed`` and ``dedup_deposit_packed``, each kernel
    on its own filter and lane; after the first batch they re-send queued
    URLs and URLs inserted before, so ``seen``, twin deposits and refunds
    are all non-zero. Every output and the lanes must be identical, and the
    byte rows must pack to the words. Then ``dedup_deposit(..., packed=True)``
    (pack, kernel, unpack) against the byte-per-bit call on more batches.
    Counts are zeroed just before the packed calls and read just after.
    Returns the two kernels' rows for the ``kernels`` line."""
    import torch
    from repro_torch.core import stages as ST
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.bloom.ops import probe_insert, probe_insert_packed
    from repro_torch.kernels.bloom.ref import bloom_packed_ref, pack_bits
    from repro_torch.kernels.dedup_deposit.ops import (dedup_deposit,
                                                       dedup_deposit_packed)
    from repro_torch.kernels.dedup_deposit.ref import (
        dedup_deposit_packed_ref, first_twin, sorted_queue)
    from repro_torch.ordering.opic_url import url_cash_table
    cfg, st = sess.cfg, sess.state
    kh, b = cfg.bloom_hashes, cfg.bloom_bits_log2
    masks = [args[2] for args, _ in capture_calls(
        [ST], "dedup_deposit", sess.step, 4)]
    rng = np.random.default_rng(SEED + 6)
    batches = packed_batches(rng, masks, st, n_mixed, cfg.url_space_log2)
    bound = packed_batches(rng, masks, st, n_boundary, cfg.url_space_log2)
    queue = sorted_queue(st.f_url, st.f_valid)
    bits_b = st.bloom_bits                  # bloom's filter, in place
    bits_d = bits_b.clone()                 # dedup_deposit's
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    words_b = pack_bits(bits_b)
    torch.cuda.synchronize()
    pack_ms = 1e3 * (time.perf_counter() - t0)
    words_d = words_b.clone()
    lane_b = url_cash_table(st).clone()     # byte dedup_deposit's lane
    lane_p = lane_b.clone()                 # dedup_deposit_packed's
    fq = (st.f_url, st.f_valid)
    reset_launches()
    per = []
    for u, m, v in batches:
        s_b = probe_insert(bits_b, u, m, k=kh)
        s_bp = probe_insert_packed(words_b, u, m, k=kh)
        before = lane_b.clone()
        s_d, r_d = dedup_deposit(bits_d, u, m, v, *fq, lane_b, k=kh)
        s_dp, r_dp = dedup_deposit_packed(words_d, u, m, v, *fq, lane_p,
                                          k=kh)
        torch.cuda.synchronize()
        for name, x, y in (("bloom seen", s_b, s_bp),
                           ("dedup_deposit seen", s_d, s_dp),
                           ("lane", lane_b, lane_p), ("refund", r_d, r_dp)):
            if not torch.equal(x, y):
                raise AssertionError(f"packed: {name} differs between the "
                                     f"byte-per-bit and the packed kernel")
        hit, _ = first_twin(u, s_d, queue)
        per.append({"live": int(m.sum()), "seen": int(s_d.sum()),
                    "twins": int(hit.sum()),
                    "refunds": int((s_d & ~hit).sum()),
                    "cells_changed": int((lane_b != before).sum()),
                    "refund_sum": float(r_d.sum())})
    # each kernel's words are its byte-per-bit twin's rows, packed; the two
    # chains inserted the same URLs
    for name, x, w in (("bloom", bits_b, words_b),
                       ("dedup_deposit", bits_d, words_d)):
        if not torch.equal(pack_bits(x), w):
            raise AssertionError(f"packed: {name}'s byte rows do not pack "
                                 f"to its packed twin's words")
    if not torch.equal(bits_b, bits_d):
        raise AssertionError("packed: the byte rows of the two chains differ")
    # the boundary call: pack, kernel, unpack, on byte rows (bits_b)
    # against the byte-per-bit kernel (bits_d) on the same batches
    lane_x, lane_y = lane_b.clone(), lane_b.clone()
    outs_x, outs_y = [], []
    it = iter(bound)
    ms_boundary = cuda_ms(lambda: outs_x.append(dedup_deposit(
        bits_b, *next(it), *fq, lane_x, k=kh, packed=True)), len(bound) - 1)
    counts = launch_counts()
    it = iter(bound)
    ms_boundary_byte = cuda_ms(lambda: outs_y.append(dedup_deposit(
        bits_d, *next(it), *fq, lane_y, k=kh)), len(bound) - 1)
    if counts["bloom_packed"] != len(batches) or \
            counts["dedup_deposit_packed"] != len(batches) + len(bound):
        raise AssertionError(f"packed: launch counts {counts}")
    for (x1, x2), (y1, y2) in zip(outs_x, outs_y):
        if not (torch.equal(x1, y1) and torch.equal(x2, y2)):
            raise AssertionError("packed: dedup_deposit(packed=True) differs "
                                 "from the byte-per-bit call")
    if not torch.equal(lane_x, lane_y):
        raise AssertionError("packed: the boundary call's lane differs")
    tot = {key: sum(p[key] for p in per) for key in per[0]}
    if min(tot["seen"], tot["twins"], tot["refunds"]) == 0 or \
            tot["refund_sum"] <= 0:
        raise AssertionError(f"packed: the batches hit no seen URL, twin or "
                             f"refund: {tot}")
    if not torch.equal(bits_b, bits_d):
        raise AssertionError("packed: the boundary call's byte rows differ "
                             "from the byte-per-bit call's")
    del words_d, bits_d, lane_x, lane_y, outs_x, outs_y
    gc.collect()
    emit({"phase": "packed", "config": "webparf.CONFIG ordering=opic_url",
          "filter_bytes": bits_b.numel(), "words_bytes": 4 * words_b.numel(),
          "pack_ms": pack_ms, "batches": per, "totals": tot,
          "boundary_calls": len(bound), "launches": counts,
          "identical": True})
    # the kernels' times on fresh batches laid out as the path's (as
    # kernels_opic_url times the byte-per-bit ones), then on batches that
    # re-send queued and inserted URLs; each packed kernel beside its
    # byte-per-bit twin on the same batches, each on its own filter and lane
    n = 50
    rows_ = []
    lanes = {True: lane_b.clone(), False: lane_b.clone()}

    def timed(name, batches, packed, plain=False):
        it = iter(batches)
        filt = words_b if packed else bits_b
        if name == "dedup_deposit_packed":
            fn = ((dedup_deposit_packed_ref if plain else dedup_deposit_packed)
                  if packed else dedup_deposit)
            return cuda_ms(lambda: fn(filt, *next(it), *fq, lanes[packed],
                                      k=kh), len(batches) - 1)
        fn = ((bloom_packed_ref if plain else probe_insert_packed) if packed
              else probe_insert)
        return cuda_ms(lambda: fn(filt, *next(it)[:2], k=kh),
                       len(batches) - 1)

    for name in ("bloom_packed", "dedup_deposit_packed"):
        deposit = name == "dedup_deposit_packed"
        kern_b, plain_b = ([(u, m, torch.tensor(rng.random(m.shape),
                                                dtype=torch.float32,
                                                device=DEV))
                            for u, m in fresh_urls(rng, masks, n, cfg)]
                           for _ in range(2))
        hit_b = packed_batches(rng, masks, st, n, cfg.url_space_log2)
        nbytes, n_live, pos = bloom_bytes([(u, m) for u, m, _ in kern_b], kh,
                                          b, word_bytes=4)
        if deposit:       # each live URL's value and the (R,) refund
            nbytes += 4 * n_live + 4 * masks[0].shape[0] * len(kern_b)
        before = bits_at(words_b, pos)
        ms = timed(name, kern_b, True)
        new = (before == 0) & (bits_at(words_b, pos) == 1)
        n_new = torch.unique(pos[new] >> 5).numel()
        nbytes = (nbytes + 4 * n_new) / len(kern_b)
        byte_ms = timed(name, kern_b, False)
        plain = timed(name, plain_b, True, plain=True)
        hit_ms, hit_byte_ms = (timed(name, hit_b, packed)
                               for packed in (True, False))
        graph = {}
        if not deposit:
            # in a CUDA graph, fresh URLs every replay (as kernels_backlink
            # times bloom), beside the byte-per-bit kernel on the same
            # batches; each call on its own seed
            seeds = iter(range(SEED + 200, SEED + 300))
            for packed, key in ((True, ""), (False, "byte_per_bit_")):
                filt = words_b if packed else bits_b
                fn = probe_insert_packed if packed else probe_insert
                run = (lambda u, m, v, fn=fn, filt=filt:  # noqa: E731
                       fn(filt, u, m, k=kh))
                graph[f"{key}graph_ms"] = fresh_graph_ms(
                    run, kern_b[:n], cfg.url_space_log2, cold=False,
                    seed=next(seeds))
                graph[f"{key}graph_cold_ms"] = fresh_graph_ms(
                    run, [(u, m.clone(), v) for u, m, v in kern_b[:n]],
                    cfg.url_space_log2, cold=True, seed=next(seeds))
        src, line = (("dedup_deposit", "dedup_deposit/dedup_deposit.py:105")
                     if deposit else ("bloom", "bloom/bloom.py:137"))
        r = row(name, f"src/repro_torch/csrc/{src}.cu",
                f"src/repro/kernels/{line}", counts, None, errs, ms, plain,
                nbytes, None, path="packed (the entry points, opic_url "
                "CONFIG filter)", launches_crawl_path=0,
                shape=list(masks[0].shape), live_urls=n_live / len(kern_b),
                new_words=n_new / len(kern_b), byte_per_bit_ms=byte_ms,
                resending_ms=hit_ms, resending_byte_per_bit_ms=hit_byte_ms,
                **graph)
        if deposit:
            r.update(boundary_ms=ms_boundary,
                     boundary_byte_per_bit_ms=ms_boundary_byte,
                     boundary_bound_ms=1e3 * 2 * (bits_b.numel()
                                                  + 4 * words_b.numel())
                     / HBM_BYTES_PER_S,
                     boundary_shape=list(bits_b.shape))
        rows_.append(r)
    return rows_


def hold_to_plain(label, kern, plain, args, kw):
    """``kern`` and ``plain`` on copies (``twin``) of one captured call's
    arguments: every output and every argument they update in place must
    be identical. Returns the largest absolute difference, 0."""
    import torch
    a = [twin(x) if isinstance(x, torch.Tensor) else x for x in args]
    b = [twin(x) if isinstance(x, torch.Tensor) else x for x in args]
    got, want = kern(*a, **kw), plain(*b, **kw)
    torch.cuda.synchronize()
    as_tuple = lambda x: x if isinstance(x, tuple) else (x,)  # noqa: E731
    for i, (x, y) in enumerate(zip(as_tuple(got) + tuple(a),
                                   as_tuple(want) + tuple(b))):
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            raise AssertionError(f"{label}: output or argument {i} differs "
                                 f"from the plain version")
    return 0.0


def phase_sharded_parity(sess):
    """The path's crawl kernels against their plain versions on the
    SHARDS-shard session's own next calls, whose inputs differ from one
    shard's (the frontier's content, the row sums into the shards' slot
    cash as n_shards rows of r_local targets, denser dispatch batches):
    the pop (frontier_select; select_harvest with its url lane laid out as
    the path lays it out), for opic_url the first row-sum scatter into the
    slot cash and the first cell scatter (both opic_update), and the Bloom
    dedup (bloom; dedup_deposit) over DEDUP_CALLS dispatches, replayed on
    the 8 GiB filter with what they touch restored. Every output and
    every argument updated in place must be identical. Returns per kernel
    what was checked, with the Bloom dedup's bound and CUDA-graph time at
    this density."""
    import torch
    from repro_torch.core import frontier as F
    from repro_torch.core import stages as ST
    from repro_torch.kernels.bloom.ops import probe_insert
    from repro_torch.kernels.dedup_deposit.ops import dedup_deposit
    from repro_torch.kernels.frontier_select.ops import select, select_harvest
    from repro_torch.kernels.frontier_select.ref import (select_harvest_ref,
                                                         select_ref)
    from repro_torch.kernels.opic_update import ops as OPS
    from repro_torch.kernels.opic_update.ref import opic_ref
    cfg = sess.cfg
    kh, b = cfg.bloom_hashes, cfg.bloom_bits_log2
    label = f"{cfg.ordering} n_shards={sess.n_shards}"
    out = {}

    def pop(name, attr, kern, plain):
        (args, kw), = capture_calls([F], attr, sess.step, 1, layout=True)
        out[name] = {"max_abs_err": hold_to_plain(f"{label} {name}", kern,
                                                  plain, args, kw),
                     "shape": list(args[0].shape), "k": kw["k"],
                     "valid_cells": int(args[2].sum())}

    def scatter(what, module, pick):
        (args, kw), = capture_calls([module], "scatter_cash", sess.step, 1,
                                    pick=lambda a: pick(a) and
                                    bool(a[3].any()), layout=True)
        cash, rows, _, mask = args
        R = cash.shape[1]
        live = mask & (rows >= -R) & (rows < R)
        return {f"{what}_max_abs_err": hold_to_plain(
                    f"{label} opic_update ({what})", OPS.scatter_cash,
                    opic_ref, args, kw),
                f"{what}_shape": [*cash.shape, rows.shape[1]],
                f"{what}_live_items": int(live.sum()),
                f"{what}_max_items_per_target": max_items_per_target(
                    cash, rows, live)}

    def replayed(name, rep, kern, extra):
        rep.check(kern, f"{label} {name}")
        out[name] = {"max_abs_err": 0.0, "captured_calls": len(rep.caps),
                     "shape": list(rep.caps[0]["mask"].shape), **extra}

    if cfg.ordering == "opic_url":
        pop("select_harvest", "_kernel_harvest", select_harvest,
            select_harvest_ref)
        out["opic_update"] = {
            **scatter("row_sum", ST, lambda a: a[0].shape[0] ==
                      sess.n_shards),
            **scatter("cells", OPS, lambda a: a[1].shape[1] > 1)}
        rep = DedupReplay(sess.state.bloom_bits,
                          capture_dedup(sess, DEDUP_CALLS), kh)
        live, seen, twins = rep.counts()
        n = len(rep.caps)
        replayed("dedup_deposit", rep, dedup_deposit, {
            "live_urls": live / n, "seen": seen / n, "twins": twins / n,
            "graph_ms": rep.graph_ms(dedup_deposit, cold=False),
            "graph_cold_ms": rep.graph_ms(dedup_deposit, cold=True),
            "bound_ms": 1e3 * rep.nbytes(kh) / HBM_BYTES_PER_S})
    else:
        pop("frontier_select", "_kernel_select", select, select_ref)
        rep = BloomReplay(sess.state.bloom_bits,
                          capture_bloom(sess, DEDUP_CALLS), kh)
        n = len(rep.caps)
        replayed("bloom", rep, probe_insert, {
            "live_urls": sum(int(c["mask"].sum()) for c in rep.caps) / n,
            "seen": sum(int(w[0].sum()) for w in rep.want) / n,
            "graph_ms": rep.graph_ms(probe_insert),
            "bound_ms": 1e3 * rep.nbytes(kh, b) / HBM_BYTES_PER_S})
    torch.cuda.synchronize()
    emit({"phase": "sharded_parity", "ordering": cfg.ordering,
          "coordination": cfg.coordination,
          "n_shards": sess.n_shards, "tolerance": "exact (torch.equal)",
          "kernels": out})
    return out


def main_sharded(ordering, one):
    """The path over SHARDS shards at the full config, profiled as the
    one-shard path ``one`` was, held against it (``phase_shards``), and its
    kernels held against their plain versions on its own calls
    (``phase_sharded_parity``). Returns its launch counts and what that
    parity check found, and its profile."""
    sess, counts, line = phase_main(ordering, n_shards=SHARDS)
    prof = phase_profile(sess, 2 * sess.cfg.dispatch_interval)
    checked = phase_sharded_parity(sess)
    del sess
    free_card()
    phase_shards(ordering, one, (counts, line, prof))
    return counts, checked, prof


COORD_STEPS = 32            # steps of each coordination mode's run
COORD_QUOTA = 1024          # batched: half of a shard's 2,048 staged URLs
COORD_RUNS = (("exchange", "opic_url"), ("firewall", "opic_url"),
              ("crossover", "opic_url"), ("batched", "opic_url"),
              ("firewall", "backlink"), ("crossover", "backlink"))


def coord_session(mode, ordering, **over):
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    cfg = scaled(webparf.CONFIG, ordering=ordering, coordination=mode,
                 comm_quota=COORD_QUOTA if mode == "batched" else -1,
                 **over)
    return CrawlSession(cfg, device=DEV, n_shards=SHARDS)


def phase_coordination(exchange_sharded):
    """Each coordination mode at webparf.CONFIG with SHARDS shards, nothing
    cut (COORD_RUNS; batched ships at most COORD_QUOTA a shard a dispatch):
    counts zeroed just before COORD_STEPS steps and read just after, the
    path's kernels all launched, every shard fetched, cash conserved under
    opic_url, nothing shipped by firewall and crossover, no shard over its
    quota under batched; then the path's profile (``phase_profile``) and
    its kernels held to their plain versions on its own calls
    (``phase_sharded_parity``). The exchange run's launches a step and host
    syncs a step must equal the exchange path's in ``main_sharded``
    (``exchange_sharded``: its counts and profile); a telemetry-on exchange
    run must follow the same trajectory with the same launches, and its
    syncs a step are printed beside. Returns {mode/ordering: (launch
    counts, what the parity check found)}."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.ordering.opic import total_cash
    out = {}
    for mode, ordering in COORD_RUNS:
        label = f"{mode}/{ordering}"
        steps, need = COORD_STEPS, PATHS[ordering][1]
        sess = coord_session(mode, ordering)
        cfg, iv = sess.cfg, sess.cfg.dispatch_interval
        torch.cuda.synchronize()
        cash0 = total_cash(sess.state) if ordering != "backlink" else None
        reset_launches()
        rep = sess.run(steps)
        torch.cuda.synchronize()
        counts = launch_counts()
        missing = [n for n in need if counts[n] < 1]
        if missing:
            raise AssertionError(f"{label}: {missing} never launched: "
                                 f"{counts}")
        per = rep.stats_per_shard
        if (per["fetched"] <= 0).any() or rep.fetched != len(rep.urls):
            raise AssertionError(f"{label}: output malformed: {rep.stats}")
        comm = rep.comm
        if mode in ("firewall", "crossover") and comm["urls_shipped"]:
            raise AssertionError(f"{label}: shipped {comm['urls_shipped']}")
        rounds = per["dispatch_rounds"]
        if mode == "batched" and (per["dispatch_sent"]
                                  > COORD_QUOTA * rounds).any():
            raise AssertionError(f"{label}: over quota: {per}")
        line = {"phase": "coordination", "coordination": mode,
                "ordering": ordering, "config": "webparf.CONFIG",
                "n_shards": SHARDS, "steps": steps,
                "comm_quota": cfg.comm_quota, "seconds": rep.seconds,
                "pages_per_s": rep.pages_per_sec, "fetched": rep.fetched,
                "comm": comm, "staging_drop": rep.stats["staging_drop"],
                "frontier_drop": rep.stats["frontier_drop"],
                "dedup_bloom": rep.stats["dedup_bloom"],
                "url_dup": rep.overlap["url_dup"],
                "content_dup": rep.overlap["content_dup"],
                "outbox_n": sess.state.outbox_n.tolist(),
                "launches": counts,
                "launches_per_step": {n: c / steps
                                      for n, c in counts.items()}}
        if cash0 is not None:
            cash = total_cash(sess.state)
            if not np.isfinite(cash) or abs(cash - cash0) > CASH_RTOL * cash0:
                raise AssertionError(f"{label}: total cash {cash0} -> "
                                     f"{cash}")
            line["cash_rel_drift"] = (cash - cash0) / cash0
        prof = phase_profile(sess, 2 * iv)
        line.update({
            "device_events_per_step": prof["device_events_per_call"],
            "device_busy_ms_per_step": prof["device_busy_ms_per_call"],
            "host_syncs_per_step": prof["sync_debug_syncs_per_step"],
            "device_idle_share": prof["device_idle_share"],
            "in_crawl_ms_per_launch": {
                n: in_crawl_ms(prof, n) for n in PORT_KERNEL_FNS}})
        if mode == "exchange":
            c64, p64 = exchange_sharded
            ref = {n: c64[n] * steps // PATHS[ordering][0]
                   for n in PORT_KERNEL_FNS}
            got = {n: counts[n] for n in PORT_KERNEL_FNS}
            syncs = (prof["sync_debug_syncs_per_step"],
                     p64["sync_debug_syncs_per_step"])
            if got != ref or syncs[0] != syncs[1]:
                raise AssertionError(f"{label}: launches {got} / syncs "
                                     f"{syncs[0]} a step, the exchange "
                                     f"path's {ref} / {syncs[1]}")
            line["equal_to_main_sharded"] = True
            telemetry = (rep, counts, prof)
        checked = phase_sharded_parity(sess)
        emit(line)
        out[label] = (counts, checked)
        del sess
        free_card()
    emit(phase_telemetry_cost(*telemetry))
    free_card()
    return out


def phase_telemetry_cost(rep0, counts0, prof0):
    """The exchange/opic_url run again with telemetry on: the same URLs,
    stats and crawl kernel launches as with it off (the ledger only reads
    the state), and the host syncs a step it adds (an eager step copies
    its ledger row to the host)."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    sess = coord_session("exchange", "opic_url", telemetry=True)
    torch.cuda.synchronize()
    reset_launches()
    rep = sess.run(COORD_STEPS)
    torch.cuda.synchronize()
    counts = launch_counts()
    label = "exchange/opic_url telemetry=True"
    if not np.array_equal(rep.urls, rep0.urls) or rep.stats != rep0.stats:
        raise AssertionError(f"{label}: the trajectory differs from the "
                             f"untraced run")
    if any(counts[n] != counts0[n] for n in PORT_KERNEL_FNS):
        raise AssertionError(f"{label}: launches {counts}, off {counts0}")
    tel = rep.telemetry
    if tel.n_records != COORD_STEPS or not np.isfinite(tel.rows).all():
        raise AssertionError(f"{label}: ledger {tel.rows.shape}")
    iv = sess.cfg.dispatch_interval
    n_sync, lines = count_syncs(sess, 2 * iv)
    return {"phase": "telemetry", "config": "webparf.CONFIG",
            "coordination": "exchange", "ordering": "opic_url",
            "n_shards": SHARDS, "steps": COORD_STEPS,
            "same_trajectory_and_launches": True,
            "pages_per_s": rep.pages_per_sec,
            "pages_per_s_off": rep0.pages_per_sec,
            "host_syncs_per_step": n_sync / (2 * iv),
            "host_syncs_per_step_off": prof0["sync_debug_syncs_per_step"],
            "added_syncs_per_step": (n_sync / (2 * iv)
                                     - prof0["sync_debug_syncs_per_step"]),
            "sync_debug_lines": lines,
            "ledger_records": tel.n_records, "metrics": tel.metrics()}


# ---------------------------------------------------------------------------
# The mesh paths' single-card meaning: grouped MoE routing (the reference's
# _moe_spmd), reshard, the launch labels, and the dry run of every cell
# ---------------------------------------------------------------------------

MOE_MESHES = (("local", None), ("mesh_4x1", {"data": 4, "model": 1}),
              ("mesh_2x2", {"data": 2, "model": 2}))
GROUPED_CPU_MESHES = ({"data": 2, "model": 2}, {"data": 4, "model": 2})
GROUPED_CPU_SHAPE = (8, 64)     # tokens (B, S) of the reduced grouped MoE
GROUPED_TOL = 1e-4
RESHARD_MESH = {"data": 2, "model": 4}
DRYRUN_JOBS = 8                 # cells reckoned at once, a process each
DRYRUN_MESHES = ("4x1", "2x2", "1x4")   # the per-card reckoning's meshes
DRYRUN_MESH_JOBS = 6            # its cells at once, beside lm_zoo
DRYRUN_MESH_TIMEOUT_S = 900
PEAK_TOL = 0.15                 # reckoned peak within this of the measured
TRACE_STEPS = 8                 # crawl steps profiled with the labels on


def phase_moe_groups():
    """DeepSeekMoE-16B at full width (bf16, seeded), MOE_BATCH x
    MOE_PROMPT prompts and MOE_GEN tokens, routed with no mesh and under
    each activation mesh shape of MOE_MESHES (the reference's _moe_spmd:
    each (data, model) block of tokens routes as a group with its own
    capacity): per shape the captured attention parity of layers 0 and 27
    (``moe_flash_parity``), the counted ``serve`` (28 flash_attention_tc a
    prefill, ``moe_serve``), prefill ms, decode ms a token, the groups of
    a prefill and of a decode step, and each MoE layer's drop share, all
    in this call. Then the reduced grouped MoE (f32, capacity factor 0.5)
    on the card against the CPU under GROUPED_CPU_MESHES (outputs within
    GROUPED_TOL, experts, slots and keeps equal), and a train state saved
    in the reference's checkpoint format, restored and ``reshard``ed onto
    the card, equal bit for bit, then stepped once under RESHARD_MESH on
    the card and the CPU (losses within GROUPED_TOL)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    cfg = get_arch(MOE_ARCH)[0]
    model = T.init_lm(cfg, seed=SEED, device=DEV)
    prompts = torch.tensor(np.random.default_rng(SEED + 6).integers(
        0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT)), device=DEV)
    out = {"phase": "moe_groups", "arch": MOE_ARCH, "batch": MOE_BATCH,
           "prompt_len": MOE_PROMPT, "gen": MOE_GEN, "runs": {}}
    for label, mesh in MOE_MESHES:
        with rules.activation_mesh(mesh):
            err = moe_flash_parity(model, prompts, f"moe_groups {label}")
            toks, t_pre, t_dec, counts, peak = moe_serve(
                model, prompts, MOE_GEN, f"moe_groups {label}")
            _, pre, dec = record_serve(model, prompts, MOE_GEN)
        drops = [float((~keep).float().mean()) for _, keep in pre]
        out["runs"][label] = {
            "mesh": mesh, "prefill_ms": 1e3 * t_pre,
            "decode_ms_per_token": 1e3 * t_dec / (MOE_GEN - 1),
            "peak_gib": peak, "launches": counts,
            "captured_flash_max_abs_err": err,
            "groups_prefill": int(pre[0][1].shape[0]),
            "groups_decode": int(dec[0][0][1].shape[0]),
            "prefill_drop_share_per_moe_layer": drops,
            "prefill_drop_share_mean": sum(drops) / len(drops),
            "first_tokens": toks[:, :8].tolist()}
    del model, prompts
    free_card()
    want = {"local": (1, 1), "mesh_4x1": (4, 4), "mesh_2x2": (4, 1)}
    for label, (g_pre, g_dec) in want.items():
        r = out["runs"][label]
        if (r["groups_prefill"], r["groups_decode"]) != (g_pre, g_dec):
            raise AssertionError(f"moe_groups {label}: groups {r}")
    out["reduced_card_vs_cpu"] = grouped_card_cpu()
    out["reshard"] = reshard_card()
    emit(out)
    return out


def grouped_card_cpu():
    """The reduced f32 MoE blocks of both MoE archs at capacity factor 0.5
    under each of GROUPED_CPU_MESHES, on the card and the CPU from the
    same weights and tokens: max |diff| of the outputs and aux, routes
    equal, and assignments dropped."""
    import copy
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.models import layers as L
    from repro_torch.sharding import rules
    res = {}
    for arch in MOE_CPU_ARCHS:
        base = scaled(get_reduced(arch), dtype="float32")
        cfg = dataclasses.replace(base, moe=dataclasses.replace(
            base.moe, capacity_factor=MOE_DROP_FACTOR))
        p_cpu = L.init_moe(torch.Generator().manual_seed(SEED), cfg,
                           torch.float32, "cpu")
        p_card = copy.deepcopy(p_cpu).to(DEV)
        x = torch.tensor(np.random.default_rng(SEED + 9).standard_normal(
            GROUPED_CPU_SHAPE + (cfg.d_model,)), dtype=torch.float32)
        for mesh in GROUPED_CPU_MESHES:
            got = {}
            for name, dev, p in (("cpu", "cpu", p_cpu),
                                 ("card", DEV, p_card)):
                with rules.activation_mesh(mesh):
                    (o, aux), routes = record_dispatch(
                        lambda: L.moe_block(p, cfg, x.to(dev)))
                got[name] = (o.cpu(), float(aux), routes)
            (oc, ac, rc), (og, ag, rg) = got["cpu"], got["card"]
            err = float((oc - og).abs().max())
            same = all(torch.equal(a, b) for (e1, k1), (e2, k2) in
                       zip(rc, rg) for a, b in ((e1, e2), (k1, k2)))
            keep = rc[0][1]
            key = f"{arch} {mesh['data']}x{mesh['model']}"
            res[key] = {"max_abs_err": err, "aux_err": abs(ac - ag),
                        "routes_equal": same, "groups": int(keep.shape[0]),
                        "drop_share": float((~keep).float().mean())}
            if err > GROUPED_TOL or not same or bool(keep.all()):
                raise AssertionError(f"grouped MoE {key}: {res[key]}")
    return res


def reshard_card():
    """A reduced f32 deepseek-moe-16b train state after one AdamW step
    under activation_mesh (4, 2) on the CPU, saved in the reference's
    checkpoint format, restored and ``reshard``ed onto the card: every
    leaf equal bit for bit. Then one more step under RESHARD_MESH on the
    card and the CPU: losses within GROUPED_TOL."""
    import shutil
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import fault
    from repro_torch.train.trainer import init_train_state, make_train_step
    cfg = scaled(get_reduced(MOE_ARCH), dtype="float32")
    opt = adamw(lr=1e-3)
    step = make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]), opt)
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device="cpu"))
    toks = torch.tensor(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab_size, (8, 16)))
    batch = (toks, torch.roll(toks, -1, 1))
    with rules.activation_mesh({"data": 4, "model": 2}):
        state, _ = step(init_train_state(params, opt), batch)
    ckpt = ROOT / "build" / "reshard_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    try:
        TC.save(str(ckpt), 1, state)
        target = init_train_state({k: torch.zeros_like(v)
                                   for k, v in params.items()}, opt)
        card = fault.reshard(TC.restore(str(ckpt), target), DEV)
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    want, got = TC.flatten(state), TC.flatten(card)
    on_card = all(t.is_cuda for t in tensors(card))
    equal = sorted(want) == sorted(got) and all(
        np.array_equal(want[k], got[k]) for k in want)
    with rules.activation_mesh(RESHARD_MESH):
        _, m_cpu = step(state, batch)
        _, m_card = step(card, tuple(t.to(DEV) for t in batch))
    res = {"leaves": len(want), "on_card": on_card, "bit_equal": equal,
           "next_loss_cpu": float(m_cpu["loss"]),
           "next_loss_card": float(m_card["loss"]),
           "mesh_saved": "4x2",
           "mesh_next": f"{RESHARD_MESH['data']}x{RESHARD_MESH['model']}"}
    if not (on_card and equal) or abs(res["next_loss_cpu"]
                                      - res["next_loss_card"]) > GROUPED_TOL:
        raise AssertionError(f"reshard: {res}")
    return res


def phase_trace_labels():
    """The launch labels: with ``REPRO_TRACE_KERNELS=1`` (set here, and
    unset after) TRACE_STEPS profiled steps of the CLI-sized crawl under
    opic_url (fused dispatch) and backlink: every launched kernel has one
    ``kernel/<family>.cuda`` range a launch on the host, and its range in
    the device trace, and no range names a kernel that did not launch."""
    import os
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import CrawlSession
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, registry, reset_launches
    os.environ["REPRO_TRACE_KERNELS"] = "1"
    res = {}
    try:
        if not registry.annotations_enabled():
            raise AssertionError("trace_labels: REPRO_TRACE_KERNELS=1 "
                                 "left the labels off")
        for ordering in ("opic_url", "backlink"):
            sess = CrawlSession(scaled(cli_config(), ordering=ordering), DEV)
            torch.cuda.synchronize()
            reset_launches()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                sess.run(TRACE_STEPS)
                torch.cuda.synchronize()
            counts = {k: v for k, v in launch_counts().items() if v}
            ranges, on_card = Counter(), Counter()
            for e in prof.events():
                if e.name.startswith("kernel/"):
                    (ranges if e.device_type == DeviceType.CPU
                     else on_card)[e.name] += 1
            want = {f"kernel/{k}.cuda": v for k, v in counts.items()}
            res[ordering] = {"launches": counts, "ranges": dict(ranges),
                             "ranges_in_device_trace": dict(on_card)}
            if dict(ranges) != want or not counts \
                    or set(on_card) != set(want):
                raise AssertionError(f"trace_labels {ordering}: ranges "
                                     f"{dict(ranges)}, launches {counts}")
            del sess
    finally:
        del os.environ["REPRO_TRACE_KERNELS"]
    if registry.annotations_enabled():
        raise AssertionError("trace_labels: labels still on")
    emit({"phase": "trace_labels", "steps": TRACE_STEPS, **res})
    return res


def peak_cells():
    """The cells chip_smoke runs, as the dry run sizes them: (label, arch,
    shape, build_cell keywords)."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import scaled
    arctic = scaled(get_arch(ARCTIC_ARCH)[0], n_layers=ARCTIC_LAYERS)
    cells = [
        ("qwen2 prefill 4x2048+32", LM_ARCH, "prefill_32k",
         dict(batch=LM_BATCH, seq_len=LM_PROMPT,
              cache_len=LM_PROMPT + LM_GEN)),
        ("qwen2 train 4x4096", LM_ARCH, "train_4k",
         dict(batch=TRAIN_BATCH, seq_len=TRAIN_SEQ)),
        ("deepseek-moe prefill 4x2048+32", MOE_ARCH, "prefill_32k",
         dict(batch=MOE_BATCH, seq_len=MOE_PROMPT,
              cache_len=MOE_PROMPT + MOE_GEN)),
        (f"arctic ({ARCTIC_LAYERS} layers) prefill 1x2048+8", ARCTIC_ARCH,
         "prefill_32k", dict(batch=ARCTIC_BATCH, seq_len=ARCTIC_PROMPT,
                             cache_len=ARCTIC_PROMPT + ARCTIC_GEN,
                             cfg=arctic)),
        ("gat full_graph_sm", "gat-cora", "full_graph_sm", {}),
        ("gat minibatch_lg", "gat-cora", "minibatch_lg", {}),
        ("gat molecule", "gat-cora", "molecule", {})]
    for arch in RECSYS_ARCHS:
        B, cuts = cut_batch(arch, "train_batch", 65536, CUT_BUDGET)
        assert B, f"{arch} train_batch: does not fit at batch 1: {cuts}"
        cells.append((f"{arch} train {B}", arch, "train_batch",
                      dict(batch=B)))
    for n in (1, SHARDS):
        cells.append((f"crawl CONFIG {n} shard(s)", "webparf", "crawl_step",
                      dict(n_shards=n)))
    return cells


def measured_peak(arch, shape, kw):
    """One run of the cell built on the card (``specs.build_cell``, zeros
    of the meta cell's shapes; the crawl's state from ``init_state``, a
    dispatch step): the peak bytes allocated from before its arguments
    were made to the end of the run."""
    import torch
    from repro_torch.launch import specs
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    cell = specs.build_cell(arch, shape, device=DEV, **kw)
    out = cell.fn(*cell.args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out, cell
    free_card()
    return peak


def dryrun_all():
    """``python -m repro_torch.launch.dryrun --all`` (the 40 cells and the
    crawl cell on meta, DRYRUN_JOBS at once, in a process of its own that
    never touches the card): one line a cell, fits, peak GiB, FLOP, bound
    ms on this card and, for a cell that does not fit, the largest batch
    that does. Returns (the records, the seconds it took)."""
    import os
    import shutil
    out_dir = ROOT / "build" / "dryrun_torch"
    shutil.rmtree(out_dir, ignore_errors=True)
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--all", "--jobs", str(DRYRUN_JOBS), "--out",
                        str(out_dir)], capture_output=True, text=True,
                       cwd=str(ROOT), timeout=600,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    all_s = time.time() - t0
    if r.returncode != 0:
        raise AssertionError(f"dryrun --all: rc {r.returncode}\n"
                             f"{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    recs = [json.loads(p.read_text()) for p in sorted(out_dir.glob("*.json"))]
    if len(recs) != 41:
        raise AssertionError(f"dryrun --all: {len(recs)} records")
    for rec in recs:
        emit({"phase": "dryrun_cell", "arch": rec["arch"],
              "shape": rec["shape"], "fits": rec["fits"],
              "peak_gib": rec["memory"]["total_per_device"] / 2 ** 30,
              "segments_gib": rec["memory"]["reserved_needed"] / 2 ** 30,
              "capacity_gib": HBM_BYTES / 2 ** 30,
              "flops": rec["cost"]["flops"], "bound_ms": rec["bound_ms"],
              "bound_by": rec["bound_by"],
              "largest_batch_that_fits": rec.get("largest_batch_that_fits"),
              **({"peak_gib_4_shards": rec["n_shards_4"]["memory"][
                  "total_per_device"] / 2 ** 30} if "n_shards_4" in rec
                 else {})})
    return recs, all_s


def dryrun_mesh_start():
    """``python -m repro_torch.launch.dryrun --all --mesh 4x1,2x2,1x4``
    started in the background (DRYRUN_MESH_JOBS processes that never touch
    the card) beside ``phase_lm_zoo`` alone, whose readings are the card's
    (``dryrun_mesh_finish`` waits for it before any phase that times the
    host): (the process, its output directory, its start time)."""
    import os
    import shutil
    out_dir = ROOT / "build" / "dryrun_torch_mesh"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    log = open(out_dir / "log.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", ",".join(DRYRUN_MESHES), "--jobs", str(DRYRUN_MESH_JOBS),
         "--out", str(out_dir)], stdout=log, stderr=subprocess.STDOUT,
        cwd=str(ROOT), env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    log.close()
    # stopped with the script if it fails before reading the records
    import atexit
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, out_dir, time.time()


def dryrun_mesh_finish(started):
    """The per-card records of every cell at each of DRYRUN_MESHES, as
    ``dryrun_mesh_start`` left them, waited for: a ``dryrun_mesh_cell`` line
    a record
    (the card's memory, fits, collectives, or why the mesh program is not
    ported); the three long_500k cells that no single card holds must fit
    a card of (1, 4). Returns (a summary, the seconds since the start)."""
    proc, out_dir, t0 = started
    try:
        rc = proc.wait(timeout=max(1.0, DRYRUN_MESH_TIMEOUT_S
                                   - (time.time() - t0)))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError("dryrun --mesh: timed out")
    secs = time.time() - t0
    if rc != 0:
        raise AssertionError(f"dryrun --mesh: rc {rc}\n"
                             f"{(out_dir / 'log.txt').read_text()[-3000:]}")
    recs = {m: [json.loads(p.read_text()) for p in
                sorted((out_dir / m).glob("*.json"))] for m in DRYRUN_MESHES}
    summary = {}
    for m, rs in recs.items():
        if len(rs) != 41:
            raise AssertionError(f"dryrun --mesh {m}: {len(rs)} records")
        for rec in rs:
            line = {"phase": "dryrun_mesh_cell", "mesh": m,
                    "arch": rec["arch"], "shape": rec["shape"],
                    "n_devices": rec["n_devices"]}
            if rec.get("mesh_program") == "not ported":
                line.update(mesh_program="not ported", why=rec["why"])
            else:
                line.update(
                    fits=rec["fits"],
                    peak_gib=rec["memory"]["total_per_device"] / 2 ** 30,
                    segments_gib=rec["memory"]["reserved_needed"] / 2 ** 30,
                    flops=rec["cost"]["flops"], bound_ms=rec["bound_ms"],
                    bound_by=rec["bound_by"],
                    collectives=rec["collectives"],
                    collective_bytes=rec["collective_bytes"],
                    largest_batch_that_fits=rec.get(
                        "largest_batch_that_fits"))
            emit(line)
        summary[m] = {"fits": sum(bool(r.get("fits")) for r in rs),
                      "not_ported": sum(r.get("mesh_program") ==
                                        "not ported" for r in rs)}
    long = {r["arch"]: r["fits"] for r in recs["1x4"]
            if r["shape"] == "long_500k" and r["arch"] in DS_LONG}
    if len(long) != len(DS_LONG) or not all(long.values()):
        raise AssertionError(f"dryrun --mesh 1x4: long_500k fits {long}")
    import shutil
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"meshes": summary, "long_500k_fits_1x4": long}, secs


def phase_dryrun(recs, all_s, mesh=None):
    """Each cell that chip_smoke runs (``peak_cells``) reckoned on meta at
    chip_smoke's sizes and run once on the card: the reckoned peak within
    PEAK_TOL of the measured one (``measured_peak``; cuBLAS's workspace
    made before). ``recs`` and ``all_s`` are ``dryrun_all``'s; ``mesh``
    ``dryrun_mesh_finish``'s (summary, seconds)."""
    import torch
    from repro_torch.launch import dryrun
    a = torch.ones(64, 64, device=DEV)
    (a @ a).sum().item()
    (a.bfloat16() @ a.bfloat16()).sum().item()
    checks, bad = [], []
    for label, arch, shape, kw in peak_cells():
        n4 = kw.get("n_shards", 1) == SHARDS
        rec = dryrun.run_cell(arch, shape, **{k: v for k, v in kw.items()
                                              if k != "n_shards"})
        reckoned = (rec["n_shards_4"] if n4 else rec)["memory"][
            "total_per_device"]
        measured = measured_peak(arch, shape, kw)
        ratio = reckoned / measured
        checks.append({"cell": label, "reckoned_gib": reckoned / 2 ** 30,
                       "measured_gib": measured / 2 ** 30, "ratio": ratio})
        if abs(ratio - 1) > PEAK_TOL:
            bad.append(label)
    out = {"phase": "dryrun", "cells": len(recs), "all_s": all_s,
           "jobs": DRYRUN_JOBS, "peak_tolerance": PEAK_TOL,
           "peaks": checks}
    if mesh is not None:
        out["mesh"], out["mesh_all_s"] = mesh
        out["mesh_jobs"] = DRYRUN_MESH_JOBS
    emit(out)
    if bad:
        raise AssertionError(f"dryrun: reckoned peaks off by more than "
                             f"{PEAK_TOL:.0%}: {bad}")
    return out


# ---------------------------------------------------------------------------
# The LM zoo at its published long-context shapes: every LM serving cell of
# LM_SHAPES (prefill_32k, decode_32k, long_500k) that the dry run fits on
# the card, at the dry run's batch, each in a process of its own
# ---------------------------------------------------------------------------

ZOO_GEN = 4                 # a prefill cell's tokens (its cache: prompt + 4);
                            # a decode cell's steps (its cache: S, S - 4 full)
ZOO_WARM = (1, 256)         # the warm-up serve's prompts: loads the kernels
ZOO_ROPE_POS = 524272       # apply_rope on the card against the CPU at
ZOO_ROPE_TOL = 1e-6         # positions 524272-524287, f32
DECODE_TOL = FLASH_TOL["bfloat16"]  # decode attention, card vs CPU, bf16
ZOO_CELL_TIMEOUT = 300      # seconds a cell's process may take
INT32_MAX = 2 ** 31 - 1


def zoo_cells(recs):
    """(arch, shape, batch) of every LM serving cell that fits: the
    published batch where the dry run's record fits, else its
    ``largest_batch_that_fits`` (0: none). train_4k is left out."""
    out = []
    for rec in recs:
        meta = rec["meta"]
        if meta.get("family") != "lm" or rec["shape"] == "train_4k":
            continue
        B = meta["batch"] if rec["fits"] else \
            rec.get("largest_batch_that_fits")
        if B:
            out.append((rec["arch"], rec["shape"], B))
    return out


def phase_lm_zoo(recs):
    """Each cell of ``zoo_cells`` run by ``zoo_cell`` in a fresh process
    (``chip_smoke.py --zoo-cell ARCH SHAPE BATCH``), one after another, so
    that a cell's weights meet an empty allocator: one line a cell, with
    the card's name and power limit. Runs before anything else of this
    script touches the card. Returns {cell label: its line}."""
    cells = zoo_cells(recs)
    if not cells:
        raise AssertionError("lm_zoo: the dry run fits no LM cell")
    card, out, t0 = nvidia_smi(), {}, time.time()
    for arch, shape, B in cells:
        t1 = time.time()
        r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"),
                            "--zoo-cell", arch, shape, str(B)],
                           capture_output=True, text=True, cwd=str(ROOT),
                           timeout=ZOO_CELL_TIMEOUT)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith('{"phase": "lm_zoo"')]
        if r.returncode != 0 or len(lines) != 1:
            raise AssertionError(f"lm_zoo {arch} {shape} at {B}: rc "
                                 f"{r.returncode}\n{r.stdout[-2000:]}\n"
                                 f"{r.stderr[-4000:]}")
        line = {**json.loads(lines[0]), "process_s": time.time() - t1,
                "card": card}
        emit(line)
        out[f"{arch} {shape}"] = line
    emit({"phase": "lm_zoo_done", "cells": len(out),
          "seconds": time.time() - t0, "card": card})
    return out


def zoo_rope(cfg):
    """RoPE on the card against the CPU for the arch: ``rope_freqs`` bit
    for bit, ``apply_rope`` in f32 at positions ZOO_ROPE_POS.. +15 within
    ZOO_ROPE_TOL."""
    import torch
    from repro_torch.models import layers as L
    hd, theta = cfg.head_dim, cfg.rope_theta
    card = L.rope_freqs(hd, theta, DEV).cpu()
    host = L.rope_freqs(hd, theta, "cpu")
    differ = int((card.view(torch.int32) != host.view(torch.int32)).sum())
    x = torch.tensor(np.random.default_rng(SEED + 12).standard_normal(
        (2, cfg.n_kv_heads, 16, hd)), dtype=torch.float32)
    pos = torch.arange(ZOO_ROPE_POS, ZOO_ROPE_POS + 16)
    err = float((L.apply_rope(x.to(DEV), pos.to(DEV), theta).cpu()
                 - L.apply_rope(x, pos, theta)).abs().max())
    if differ or err > ZOO_ROPE_TOL:
        raise AssertionError(f"rope {cfg.name}: {differ} inverse "
                             f"frequencies differ from the CPU's; "
                             f"apply_rope at {ZOO_ROPE_POS}.. differs by "
                             f"{err} > {ZOO_ROPE_TOL}")
    return {"freqs_differing": differ, "apply_rope_max_abs_err": err,
            "positions": [ZOO_ROPE_POS, ZOO_ROPE_POS + 15],
            "head_dim": hd, "theta": theta}


def spy_on(module, attr, keep):
    """Patches ``module.attr`` with a spy that calls it and hands
    (call index, args, result) to ``keep``; returns the undo."""
    import itertools
    orig, calls = getattr(module, attr), itertools.count()

    def spy(*args, **kw):
        out = orig(*args, **kw)
        keep(next(calls), args, out)
        return out
    setattr(module, attr, spy)
    return lambda: setattr(module, attr, orig)


def int32_extent(*ts):
    """The largest size and stride of the tensors, against int32 (what
    ``flash_attention.ops.launch`` takes)."""
    sizes = max(n for t in ts for n in t.shape)
    strides = max(st for t in ts for st in t.stride())
    return {"largest_size": sizes, "largest_stride": strides,
            "q_elements": ts[0].numel(), "int32_max": INT32_MAX,
            "within_int32": max(sizes, strides) <= INT32_MAX}


def zoo_prefill(model, B, S):
    """``serve`` of B seeded prompts of S tokens and ZOO_GEN tokens, after
    a small warm-up serve; counts zeroed just before, read just after. The
    flash_attention call of layer 0 and of the last layer is captured in
    that serve: batch row 0 and KV head 0's query group, its inputs and
    the kernel's own output, held to the plain version after the run."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch.serve import serve
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 13)
    serve(model, torch.tensor(rng.integers(0, cfg.vocab_size, ZOO_WARM),
                              device=DEV), 2)
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           device=DEV)
    layers, got, extent = {0, cfg.n_layers - 1}, {}, {}

    def keep(i, args, out):
        q, k, v = args[:3]
        if i in layers:
            g = q.shape[1] // k.shape[1]
            got[i] = (q[:1, :g].clone(), k[:1, :1].clone(),
                      v[:1, :1].clone(), out[:1, :g].clone())
            extent.update(int32_extent(q, k, v, out))
    undo = spy_on(FA, "attention", keep)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    try:
        toks, t_pre, t_dec = serve(model, prompts, ZOO_GEN)
    finally:
        undo()
    counts = launch_counts()
    check_prefill_launches(counts, cfg.n_layers, f"lm_zoo {cfg.name}")
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    if toks.shape != (B, ZOO_GEN) or int(toks.min()) < 0 \
            or int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"lm_zoo {cfg.name}: tokens malformed: "
                             f"{tuple(toks.shape)}")
    flash = {}
    for i, (q, k, v, out) in sorted(got.items()):
        e, share = hold_flash(out, q, k, v, True,
                              f"lm_zoo {cfg.name} layer {i}", tc=True)
        flash[f"layer_{i}"] = {"max_abs_err": e,
                               "share_of_tc_plain_tolerance": share,
                               "slice_q": list(q.shape)}
    del got
    return {"prompt_len": S, "cache_len": S + ZOO_GEN, "gen": ZOO_GEN,
            "prefill_ms": 1e3 * t_pre,
            "decode_ms_per_token": 1e3 * t_dec / (ZOO_GEN - 1),
            "prefill_tok_per_s": B * S / t_pre,
            "generated_tok_per_s": B * ZOO_GEN / (t_pre + t_dec),
            "launches": counts,
            "flash_attention_tc_launches": counts[FA.TC_KERNEL.name],
            "flash_captured": flash,
            "flash_max_abs_err": max(f["max_abs_err"]
                                     for f in flash.values()),
            "flash_int32": extent, "first_tokens": toks[0].tolist()}, peak


def zoo_decode(model, B, S):
    """ZOO_GEN greedy decode steps against a KV cache of S slots filled
    with seeded bf16 values, S - ZOO_GEN of them counted as valid (the
    spec's decode cell takes the cache as an input); counts zeroed just
    before, read just after. Layer 0's decode attention of the first step
    is captured (batch row 0: q, the cache, its length and the card's
    output) and held to the CPU's decode_attention after the run."""
    import torch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 14)
    small = T.init_cache(cfg, 1, 8, device=DEV)
    for _ in range(2):
        _, small = T.decode_step(model, torch.zeros(
            (1, 1), dtype=torch.int64, device=DEV), small)
    del small
    cache = T.init_cache(cfg, B, S, device=DEV)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 15)
    for t in (cache.prefix_k, cache.prefix_v, cache.main_k, cache.main_v):
        if t is not None:
            t.normal_(generator=gen)
    cache = cache._replace(length=torch.full(
        (B,), S - ZOO_GEN, dtype=torch.int32, device=DEV))
    tok = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 1)), device=DEV)
    got = {}

    def keep(i, args, out):
        if i == 0:   # the cache's slots below n are never written again:
            q, kc, vc, n = args     # later steps write at n and after
            got.update(q=q[:1].clone(), k=kc[:1], v=vc[:1],
                       n=n[:1].clone(), out=out[:1].clone())
    undo = spy_on(L, "decode_attention", keep)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    finite = torch.ones((), dtype=torch.bool, device=DEV)
    try:
        t0 = time.perf_counter()
        for _ in range(ZOO_GEN):
            logits, cache = T.decode_step(model, tok, cache)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            finite &= torch.isfinite(logits).all()
        torch.cuda.synchronize()
        t_dec = time.perf_counter() - t0
    finally:
        undo()
    counts = launch_counts()
    peak = (torch.cuda.max_memory_allocated(),
            torch.cuda.max_memory_reserved())
    if not bool(finite):
        raise FloatingPointError(f"lm_zoo {cfg.name}: non-finite logits")
    if any(counts.values()) or int(cache.length[0]) != S \
            or int(tok.min()) < 0 or int(tok.max()) >= cfg.vocab_size:
        raise AssertionError(f"lm_zoo {cfg.name} decode: launches "
                             f"{counts}, length {int(cache.length[0])} of "
                             f"{S}, tokens {tok.flatten().tolist()[:8]}")
    want = L.decode_attention(*(got[k].cpu() for k in ("q", "k", "v", "n")))
    have = got["out"].cpu().float()
    want = want.float()
    excess = float(((have - want).abs()
                    - DECODE_TOL * (1 + want.abs())).max())
    err = float((have - want).abs().max())
    if excess > 0 or not torch.isfinite(have).all():
        raise AssertionError(f"lm_zoo {cfg.name}: layer 0's decode "
                             f"attention differs from the CPU's by {err} "
                             f"(gate {DECODE_TOL} (1 + |want|))")
    return {"cache_len": S, "valid_at_start": S - ZOO_GEN,
            "decode_steps": ZOO_GEN,
            "decode_ms_per_token": 1e3 * t_dec / ZOO_GEN,
            "decode_tok_per_s": B * ZOO_GEN / t_dec, "launches": counts,
            "decode_attention_max_abs_err": err,
            "decode_attention_live_slots": int(got["n"][0]),
            "decode_attention_tolerance": f"{DECODE_TOL} (1 + |want|)",
            "last_tokens": tok[:8, 0].tolist()}, peak


def zoo_cell(arch, shape, B):
    """One zoo cell in this process, on a card nothing else holds: the
    dry run's record of the same cell at batch B (a prefill's cache S +
    ZOO_GEN), the weights from the port's seeded init, RoPE on the card
    against the CPU, then ``zoo_prefill`` or ``zoo_decode``; the measured
    peak (``max_memory_allocated`` from before the weights, cuBLAS's
    workspace made before) within PEAK_TOL of the reckoned one, and beside
    it the segments the allocator reserved (``max_memory_reserved``, the
    cache emptied first) against the dry run's replay of the allocator.
    Emits one lm_zoo line."""
    import torch
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    cfg = get_arch(arch)[0]
    spec = get_shape(arch, shape)
    S = spec["seq_len"]
    free, total = torch.cuda.mem_get_info()
    if HBM_BYTES > total:
        raise AssertionError(f"HBM_BYTES {HBM_BYTES} exceeds the card's "
                             f"reported total {total}")
    a = torch.ones(64, 64, device=DEV)
    (a @ a).sum().item()
    (a.bfloat16() @ a.bfloat16()).sum().item()
    del a
    torch.cuda.empty_cache()
    base = (torch.cuda.memory_allocated(), torch.cuda.memory_reserved())
    rope = zoo_rope(cfg)
    kw = {"cache_len": S + ZOO_GEN} if spec.kind == "prefill" else {}
    rec = dryrun.run_cell(arch, shape, batch=B, search=False, **kw)
    reckoned = rec["memory"]["total_per_device"]
    segments = rec["memory"]["reserved_needed"]
    t0 = time.time()
    model = T.init_lm(cfg, seed=SEED, device=DEV)
    torch.cuda.synchronize()
    init_s = time.time() - t0
    run = zoo_prefill if spec.kind == "prefill" else zoo_decode
    out, peak = run(model, B, S)
    measured, reserved = (p - b for p, b in zip(peak, base))
    ratio = reckoned / measured
    ms = out["prefill_ms"] if spec.kind == "prefill" else \
        out["decode_ms_per_token"]
    line = {"phase": "lm_zoo", "arch": arch, "cell": shape, "batch": B,
            "n_params": cfg.n_params, "dtype": cfg.dtype, "init_s": init_s,
            **out, "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "bound_of": "prefill" if spec.kind == "prefill"
            else "one decode step",
            "share_of_bound": rec["bound_ms"] / ms,
            "reckoned_peak_gib": reckoned / 2 ** 30,
            "measured_peak_gib": measured / 2 ** 30, "peak_ratio": ratio,
            "capacity_gib": HBM_BYTES / 2 ** 30,
            "headroom_gib": (HBM_BYTES - measured) / 2 ** 30,
            "reckoned_segments_needed_gib": segments / 2 ** 30,
            "reckoned_segments_peak_gib":
                rec["memory"]["reserved_peak"] / 2 ** 30,
            "measured_reserved_peak_gib": reserved / 2 ** 30,
            "segment_headroom_gib": (HBM_BYTES - segments) / 2 ** 30,
            "card_total_gib": total / 2 ** 30,
            "card_free_at_start_gib": free / 2 ** 30,
            "hbm_bytes_within_total": HBM_BYTES <= total, "rope": rope}
    emit(line)
    if abs(ratio - 1) > PEAK_TOL:
        raise AssertionError(f"lm_zoo {arch} {shape}: reckoned peak "
                             f"{reckoned} is {ratio:.3f} of the measured "
                             f"{measured}, beyond {PEAK_TOL:.0%}")


# ---------------------------------------------------------------------------
# the crawl group: one crawl process a card (repro_torch.dist)
# ---------------------------------------------------------------------------

DIST_SHARDS = 4             # N: the shards the group splits, L = N / W a rank
# (case, ordering, coordination, steps): CONFIG crawls, comm_quota
# COORD_QUOTA under batched
DIST_CASES = (("backlink", "backlink", "exchange", 32),
              ("opic_url", "opic_url", "exchange", 64),
              ("mode_exchange", "opic_url", "exchange", 32),
              ("mode_firewall", "opic_url", "firewall", 32),
              ("mode_crossover", "opic_url", "crossover", 32),
              ("mode_batched", "opic_url", "batched", 32))
DIST_PROFILED = ("backlink", "opic_url")   # profiled, kernels held to plain
DIST_A2A_CALLS = 20         # back-to-back all_to_alls timed on their own
DIST_TIMEOUT_S = 420        # the group's whole run, every rank
DIST_GROUP_TIMEOUT_S = 300  # one collective's wait before the group fails
DIGEST_CHUNK = 1 << 24      # words of a Bloom shard hashed at once
DIGEST_KEYS = (0x9E3779B97F4A7C15, 0xC2B2AE3D27D4EB4F)


def dist_config(ordering, coordination, **over):
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    return scaled(webparf.CONFIG, ordering=ordering,
                  coordination=coordination,
                  comm_quota=COORD_QUOTA if coordination == "batched" else -1,
                  **over)


# heal and load-driven rebalance across the group: (case, ordering, steps,
# (the step shard DIST_DEAD fails at, the step it is healed at) or None,
# config overrides); CONFIG crawls under exchange
DIST_HEAL_CASES = (
    ("heal_backlink", "backlink", 32, (8, 12), {}),
    ("heal_opic_url", "opic_url", 32, (8, 12), {}),
    ("rebalance_opic_url", "opic_url", 32, None,
     {"telemetry": True, "rebalance_threshold": 1.01}))
DIST_DEAD = 1               # the shard that fails in the heal cases
HEAL_SLACK = 64 << 20       # bytes a heal may add to a rank beyond the rows
                            # it sends and receives


class MoveMeter:
    """While active, counts the rows and bytes each
    ``CrawlGroup.move_rows`` call sends and receives on this rank (a row
    that stays on the rank counts once each way)."""

    def __enter__(self):
        from repro_torch.dist import CrawlGroup
        self.moves, orig = [], CrawlGroup.move_rows
        self._orig = orig

        def counted(group, leaves, src):
            plan = orig(group, leaves, src)
            row = sum(v[0].numel() * v.element_size() for v in leaves.values())
            sent, got = len(plan.send_rows), len(plan.recv_rows)
            self.moves.append({"rows_sent": sent, "rows_received": got,
                               "bytes_sent": sent * row,
                               "bytes_received": got * row})
            return plan
        CrawlGroup.move_rows = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.dist import CrawlGroup
        CrawlGroup.move_rows = self._orig

    def total(self, start=0):
        """The moves from the ``start``-th on, summed."""
        keys = ("rows_sent", "rows_received", "bytes_sent", "bytes_received")
        return {k: sum(m[k] for m in self.moves[start:]) for k in keys}


def queued_urls(sess, group, dead):
    """The URLs queued on shard DIST_DEAD's rows (``dead``) or on every
    other shard's, from the whole frontier (gathered under a group)."""
    per = sess.cfg.n_slots // DIST_SHARDS
    rows = np.zeros(sess.cfg.n_slots, bool)
    rows[DIST_DEAD * per:(DIST_DEAD + 1) * per] = True
    rows = rows if dead else ~rows
    url = group.gather(sess.state.f_url).cpu().numpy()[rows]
    ok = group.gather(sess.state.f_valid).cpu().numpy()[rows]
    return set(url[ok].tolist())


def timed_heal(sess, group, meter, captured):
    """``sess.heal()`` between CUDA events, the peak allocation it adds
    (``max_memory_allocated`` reset before it), the rows and bytes it
    moves, the launches it makes, and its ``opic_update`` call (the merge
    refund) captured into ``captured``; every URL queued on the dead shard
    must be queued on a survivor after it, and the cash must stay within
    CASH_RTOL."""
    import torch
    from repro_torch.core import stages
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.opic_update.ops import scatter_cash
    from repro_torch.kernels.opic_update.ref import opic_ref
    from repro_torch.ordering.opic import total_cash
    opic = sess.cfg.ordering != "backlink"
    queued = queued_urls(sess, group, True)
    cash0 = total_cash(sess.state) if opic else None
    n0, before = len(meter.moves), launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def heal():
        start.record()
        sess.heal()
        stop.record()
    (args, kw), = capture_calls([stages], "scatter_cash", heal, 1,
                                layout=True)
    torch.cuda.synchronize()
    out = {"heal_ms": start.elapsed_time(stop),
           "peak_added_bytes": torch.cuda.max_memory_allocated() - base,
           **meter.total(n0),
           "launches_in_heal": {k: v - before[k]
                                for k, v in launch_counts().items()
                                if v > before[k]}}
    captured.append(("opic_update (heal)", scatter_cash, opic_ref, args, kw))
    lost = queued - queued_urls(sess, group, False)
    if not queued or lost:
        raise AssertionError(f"heal: {len(lost)} of {len(queued)} URLs "
                             f"queued on shard {DIST_DEAD} lost")
    out["queued_on_dead_shard"] = len(queued)
    if opic:
        cash1 = total_cash(sess.state)
        if abs(cash1 - cash0) > CASH_RTOL * cash0:
            raise AssertionError(f"heal: cash {cash0} -> {cash1}")
        out.update(cash_before=cash0, cash_after=cash1)
    return out


def heal_drive(sess, steps, fail_heal, group, meter, after_heal=None):
    """A heal case: run to the failure, fail shard DIST_DEAD, run to the
    heal, heal (``timed_heal``), hand ``after_heal`` a function that steps once
    (the kernels' next calls are captured there), and run to ``steps``;
    or, without ``fail_heal``, run ``steps``. Returns (the whole drive's
    report, the heal's numbers or None, the captured calls)."""
    from repro_torch.api.report import (CrawlReport, stats_dict,
                                        stats_per_shard)
    reps, heal, captured = [], None, []
    if fail_heal is None:
        reps.append(sess.run(steps))
    else:
        fail_at, heal_at = fail_heal
        reps.append(sess.run(fail_at))
        sess.inject_failure(DIST_DEAD)
        reps.append(sess.run(heal_at - fail_at))
        heal = timed_heal(sess, group, meter, captured)
        if after_heal is not None:
            after_heal(lambda: reps.append(sess.run(1)), captured)
        reps.append(sess.run(steps - sess.t))
    rep = CrawlReport(
        urls=np.concatenate([r.urls for r in reps]),
        per_step=np.concatenate([r.per_step for r in reps]),
        stats=stats_dict(sess.state), seconds=sum(r.seconds for r in reps),
        cfg=sess.cfg, stats_per_shard=stats_per_shard(sess.state),
        rebalances=tuple(e for r in reps for e in r.rebalances))
    return rep, heal, captured


def heal_records(sess, rep, group):
    """``dist_records`` and the rebalance events at full precision."""
    import dataclasses
    rec = dist_records(sess, rep, group)
    rec["rebalances"] = np.array(json.dumps(
        [dataclasses.asdict(e) for e in rep.rebalances]))
    return rec


def rebalance_numbers(sess, rep, meter):
    """A rebalance run's events, the rows and bytes its moves sent and
    received, and each move's wall ms (its span: the move and a sync)."""
    return {"rebalances": [e.asdict() for e in rep.rebalances],
            **meter.total(),
            "rebalance_ms": [1e3 * e.dur for e in sess.tracer.events
                             if e.name == "rebalance" and e.ph == "X"]}


def bloom_digests(bits, n):
    """(n, 2) int64: each of ``n`` equal runs of rows of a Bloom filter (a
    shard's) hashed by two keys: the sum over its bytes read as int64
    words w_i of w_i times an odd multiplier drawn from i and the key, mod
    2^64. A differing word changes both sums; the 8 GiB filter is not
    copied to compare it."""
    import torch
    words = bits.reshape(n, -1).view(torch.int64)
    keys = [k - (1 << 64) if k >= 1 << 63 else k for k in DIGEST_KEYS]
    out = torch.zeros((n, 2), dtype=torch.int64, device=bits.device)
    for s in range(n):
        for lo in range(0, words.shape[1], DIGEST_CHUNK):
            w = words[s, lo:lo + DIGEST_CHUNK]
            i = torch.arange(lo, lo + w.shape[0], dtype=torch.int64,
                             device=bits.device)
            for j, key in enumerate(keys):
                out[s, j] += (w * ((i * key + keys[1 - j]) | 1)).sum()
    return out


def dist_records(sess, rep, group):
    """What a crawl must agree on, as numpy on every rank: the report
    (urls, per-step counts, stats per shard, comm), every state leaf but
    the Bloom filter whole (gathered), and the filter's shard digests."""
    from repro_torch.core.stages import CrawlState, state_specs
    rec = {"urls": rep.urls, "per_step": rep.per_step,
           "comm": np.array(json.dumps(rep.comm, sort_keys=True))}
    for k, v in rep.stats_per_shard.items():
        rec[f"stats.{k}"] = np.asarray(v)
    specs = state_specs()
    for name in CrawlState._fields:
        leaf = getattr(sess.state, name)
        if name == "bloom_bits":
            leaf = group.gather(bloom_digests(leaf, leaf.shape[0] // (
                sess.cfg.n_slots // DIST_SHARDS)))
        elif getattr(specs, name) is not None:
            leaf = group.gather(leaf)
        rec[f"state.{name}"] = leaf.cpu().numpy()
    return rec


def serve_records(rep):
    """What a serve interval must agree on: the answers, lags, recall,
    the index's counts and the crawl's pages."""
    rec = {f: getattr(rep, f) for f in ("top_urls", "top_scores",
                                        "lag_steps")}
    rec["recall"] = np.float64(rep.recall_at_k)
    rec["index"] = np.array(json.dumps(rep.index, sort_keys=True))
    rec["crawl.urls"] = rep.crawl.urls
    rec["crawl.per_step"] = rep.crawl.per_step
    return rec


def dist_warm(dev):
    """One dispatch interval of each ordering's path, so that the timed
    crawls find the kernels' libraries loaded."""
    from repro_torch.api import CrawlSession
    for ordering in ("backlink", "opic_url"):
        sess = CrawlSession(dist_config(ordering, "exchange"), device=dev,
                            n_shards=DIST_SHARDS)
        sess.run(sess.cfg.dispatch_interval)
        del sess
        free_card()


def dist_serve(dev):
    from repro_torch.serve import QueryLoad, ServeSession
    cfg = dist_config("backlink", "exchange")
    load = QueryLoad(cfg, qps=SERVE_QPS, seed=SEED, burst_mult=SERVE_BURST)
    return ServeSession(cfg, dev, n_shards=DIST_SHARDS, load=load,
                        **SERVE_KW)


def dist_one_card(out):
    """The parent's half: the one-card sessions of N shards for every
    case (their records to ``out``) and of 1 shard for the profiled paths;
    returns {case: {"one_card_<n>_shards": pages/s and step ms}}."""
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.dist import CrawlGroup
    dist_warm(DEV)
    one = CrawlGroup()
    times = {name: {} for name, _, _, _ in DIST_CASES}
    for name, ordering, mode, steps in DIST_CASES:
        for n in ((DIST_SHARDS, 1) if name in DIST_PROFILED
                  else (DIST_SHARDS,)):
            sess = CrawlSession(dist_config(ordering, mode), device=DEV,
                                n_shards=n)
            torch.cuda.synchronize()
            rep = sess.run(steps)
            torch.cuda.synchronize()
            if n == DIST_SHARDS:
                np.savez(out / f"{name}.one.npz",
                         **dist_records(sess, rep, one))
            f_ms, d_ms = step_ms(sess, 3 * sess.cfg.dispatch_interval)
            times[name][f"one_card_{n}_shards"] = {
                "pages_per_s": rep.pages_per_sec, "fetch_step_ms": f_ms,
                "dispatch_step_ms": d_ms}
            del sess
            free_card()
    for name, ordering, steps, fail_heal, over in DIST_HEAL_CASES:
        sess = CrawlSession(dist_config(ordering, "exchange", **over),
                            device=DEV, n_shards=DIST_SHARDS)
        with MoveMeter() as meter:
            rep, heal, _ = heal_drive(sess, steps, fail_heal, one, meter)
        np.savez(out / f"{name}.one.npz", **heal_records(sess, rep, one))
        times[name] = {"one_card_4_shards": heal or rebalance_numbers(
            sess, rep, meter)}
        del sess, rep
        free_card()
    srv = dist_serve(DEV)
    np.savez(out / "serve.one.npz", **serve_records(srv.run(
        srv.cfg.dispatch_interval)))
    del srv
    free_card()
    return times


def dist_rank(out):
    """One rank of the crawl group (``chip_smoke.py --dist-rank OUT``,
    started by ``phase_dist`` with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
    and MASTER_PORT): every case over NCCL on its own card, each run with
    the launch counts zeroed just before and read just after, the
    all_to_all timed by CUDA events; the profiled paths profiled, and one
    captured call of each of their kernels held to its plain version. Its
    records to ``out/<case>.r<rank>.npz``, its numbers to
    ``out/rank<rank>.json``."""
    import torch
    import torch.distributed as dist
    from repro_torch.api import CrawlSession
    from repro_torch.core import dedup, frontier, router, stages
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.bloom.ops import probe_insert
    from repro_torch.kernels.bloom.ref import bloom_ref
    from repro_torch.kernels.dedup_deposit.ops import dedup_deposit
    from repro_torch.kernels.dedup_deposit.ref import dedup_deposit_ref
    from repro_torch.kernels.frontier_select.ops import select, select_harvest
    from repro_torch.kernels.frontier_select.ref import (select_harvest_ref,
                                                         select_ref)
    from repro_torch.kernels.opic_update.ops import scatter_cash
    from repro_torch.kernels.opic_update.ref import opic_ref
    from repro_torch.launch.mesh import init_crawl_group
    # on the card (DEV "cuda") the group is NCCL's and the rank's device
    # its own card, which ``device=None`` names
    group = init_crawl_group(None if DEV == "cuda" else DEV,
                             timeout_s=DIST_GROUP_TIMEOUT_S)
    dev = None if DEV == "cuda" else DEV
    # each profiled path's kernels: (name, the module the path calls it
    # through, the attribute it calls, the launching wrapper, the plain
    # version)
    checks = {"backlink": (
        ("frontier_select", frontier, "_kernel_select", select, select_ref),
        ("bloom", dedup, "_kernel_probe", probe_insert, bloom_ref)),
        "opic_url": (
        ("select_harvest", frontier, "_kernel_harvest", select_harvest,
         select_harvest_ref),
        ("dedup_deposit", stages, "dedup_deposit", dedup_deposit,
         dedup_deposit_ref),
        ("opic_update", stages, "scatter_cash", scatter_cash, opic_ref))}
    a2a, last = [], []
    exchange = router.exchange

    def timed_exchange(buckets, group):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        got = exchange(buckets, group)
        stop.record()
        a2a.append((start, stop))
        last[:] = [buckets]
        return got

    lines = []
    try:
        dist_warm(dev)
        for name, ordering, mode, steps in DIST_CASES:
            sess = CrawlSession(dist_config(ordering, mode), device=dev,
                                n_shards=DIST_SHARDS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            a2a.clear()
            router.exchange = timed_exchange
            reset_launches()
            try:
                rep = sess.run(steps)
                torch.cuda.synchronize()
            finally:
                router.exchange = exchange
            counts = launch_counts()
            line = {
                "case": name, "steps": steps, "seconds": rep.seconds,
                "pages_per_s": rep.pages_per_sec, "fetched": rep.fetched,
                "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                "dispatches": len(a2a),
                "all_to_all_ms_per_dispatch": float(np.mean(
                    [a.elapsed_time(b) for a, b in a2a])) if a2a else None,
                "launches": {k: counts[k] for k in PORT_KERNEL_FNS},
                "fetched_per_shard": rep.stats_per_shard["fetched"].tolist()}
            missing = [k for k in PATHS[ordering][1] if counts[k] < 1]
            if missing:
                raise AssertionError(f"rank {group.rank} {name}: {missing} "
                                     f"never launched: {counts}")
            if last:
                # the last dispatch's buckets exchanged again, back to
                # back after a barrier: the collective without the wait
                # for a slower rank's host
                group.barrier()
                line.update(
                    all_to_all_bytes=last[0].numel() * last[0].element_size(),
                    all_to_all_isolated_ms=cuda_ms(
                        lambda: exchange(last[0], group), DIST_A2A_CALLS))
                last.clear()
            np.savez(out / f"{name}.r{group.rank}.npz",
                     **dist_records(sess, rep, group))
            f_ms, d_ms = step_ms(sess, 3 * sess.cfg.dispatch_interval)
            line.update(fetch_step_ms=f_ms, dispatch_step_ms=d_ms)
            if name in DIST_PROFILED:
                iv = sess.cfg.dispatch_interval
                prof = profile_device(
                    lambda: [sess.step() for _ in range(2 * iv)], 2 * iv)
                n_sync, _ = count_syncs(sess, 2 * iv)
                line.update(
                    device_events_per_step=prof["device_events_per_call"],
                    device_busy_ms_per_step=prof["device_busy_ms_per_call"],
                    collective_ms_per_step=prof["collective_ms_per_call"],
                    device_idle_share=prof["device_idle_share"],
                    host_syncs_per_step=n_sync / (2 * iv))
                # each kernel's next call (the same step on every rank)
                # against its plain version
                errs = line["plain_max_abs_err"] = {}
                for kname, module, attr, kern, plain in checks[ordering]:
                    (args, kw), = capture_calls([module], attr, sess.step, 1,
                                                layout=True)
                    errs[kname] = hold_to_plain(f"rank {group.rank} {kname}",
                                                kern, plain, args, kw)
                    del args
            lines.append(line)
            del sess, rep
            free_card()
        for name, ordering, steps, fail_heal, over in DIST_HEAL_CASES:
            lines.append(dist_heal_case(sess_args=(name, ordering, steps,
                                                   fail_heal, over),
                                        dev=dev, group=group, out=out,
                                        checks=checks[ordering]))
            free_card()
        srv = dist_serve(dev)
        np.savez(out / f"serve.r{group.rank}.npz", **serve_records(
            srv.run(srv.cfg.dispatch_interval)))
        del srv
        free_card()
        group.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"rank{group.rank}.json").write_text(json.dumps(
        {"rank": group.rank, "world": group.world,
         "device": torch.cuda.get_device_name(), "cases": lines}))


def dist_heal_case(sess_args, dev, group, out, checks):
    """One heal or rebalance case on a rank: the run with the launch
    counts zeroed just before and read just after, the heal's numbers
    (``timed_heal``), and, after the run, the heal's ``opic_update`` call
    and the next call of each of the path's kernels held to their plain
    versions. Its records to ``out/<case>.r<rank>.npz``; returns its
    line."""
    import torch
    from repro_torch.api import CrawlSession
    from repro_torch.kernels import launch_counts, reset_launches
    name, ordering, steps, fail_heal, over = sess_args
    sess = CrawlSession(dist_config(ordering, "exchange", **over),
                        device=dev, n_shards=DIST_SHARDS)
    torch.cuda.synchronize()

    def after_heal(step1, captured):
        for kname, module, attr, kern, plain in checks:
            (args, kw), = capture_calls([module], attr, step1, 1,
                                        layout=True)
            captured.append((kname, kern, plain, args, kw))
    reset_launches()
    with MoveMeter() as meter:
        rep, heal, captured = heal_drive(sess, steps, fail_heal, group,
                                         meter, after_heal)
    torch.cuda.synchronize()
    counts = launch_counts()
    missing = [k for k in PATHS[ordering][1] if counts[k] < 1]
    if missing:
        raise AssertionError(f"rank {group.rank} {name}: {missing} never "
                             f"launched: {counts}")
    line = {"case": name, "steps": steps, "seconds": rep.seconds,
            "pages_per_s": rep.pages_per_sec, "fetched": rep.fetched,
            "launches": {k: counts[k] for k in PORT_KERNEL_FNS},
            "fetched_per_shard": rep.stats_per_shard["fetched"].tolist()}
    if heal is not None:
        line["heal"] = heal
    else:
        line["rebalance"] = rebalance_numbers(sess, rep, meter)
        if not rep.rebalances:
            raise AssertionError(f"rank {group.rank} {name}: no rebalance")
    errs = line["plain_max_abs_err"] = {}
    for kname, kern, plain, args, kw in captured:
        errs[kname] = hold_to_plain(f"rank {group.rank} {name} {kname}",
                                    kern, plain, args, kw)
    del captured
    np.savez(out / f"{name}.r{group.rank}.npz",
             **heal_records(sess, rep, group))
    return line


def free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(world=None):
    """The crawl group at webparf.CONFIG, N = DIST_SHARDS: the one-card
    N-shard sessions first (``dist_one_card``), then ``world`` fresh
    processes (default: every card), rank r on card r over NCCL
    (``dist_rank``), waited for at most DIST_TIMEOUT_S; a failed or hung
    rank fails the phase. Every rank's final state and reports must equal
    the one-card session's bit for bit (the Bloom filter by its shard
    digests), and its kernels their plain versions. Prints a line a rank
    and a ``dist`` line. Returns {rank: its numbers}."""
    import os
    import shutil
    import torch
    world = world or torch.cuda.device_count()
    out = ROOT / "build" / f"dist_{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.time()
    one = dist_one_card(out)
    run_ranks("--dist-rank", out, world, DIST_TIMEOUT_S)
    ranks = {r: json.loads((out / f"rank{r}.json").read_text())
             for r in range(world)}
    heal_names = [c[0] for c in DIST_HEAL_CASES]
    for name in [c[0] for c in DIST_CASES] + heal_names + ["serve"]:
        with np.load(out / f"{name}.one.npz") as z:
            want = dict(z)
        for r in range(world):
            with np.load(out / f"{name}.r{r}.npz") as z:
                got = dict(z)
            diff = sorted(k for k in set(want) | set(got)
                          if k not in want or k not in got
                          or want[k].dtype != got[k].dtype
                          or want[k].shape != got[k].shape
                          or want[k].tobytes() != got[k].tobytes())
            if diff:
                raise AssertionError(f"dist: rank {r} of {world}, {name}: "
                                     f"{diff} differ from the one-card "
                                     f"{DIST_SHARDS}-shard session")
    card = nvidia_smi()
    for r, rk in ranks.items():
        for line in rk["cases"]:
            emit({"phase": "dist_rank", "world": world, "rank": r,
                  "card": card, **line})
    heals = {}
    for name in heal_names:
        per_rank = [next(c for c in ranks[r]["cases"] if c["case"] == name)
                    for r in range(world)]
        key = "heal" if "heal" in per_rank[0] else "rebalance"
        for r, c in enumerate(per_rank):
            h = c[key]
            if key == "heal" and h["peak_added_bytes"] > (
                    h["bytes_sent"] + h["bytes_received"] + HEAL_SLACK):
                raise AssertionError(
                    f"dist: rank {r} {name}: the heal added "
                    f"{h['peak_added_bytes']} B, beyond the "
                    f"{h['bytes_sent']} sent + {h['bytes_received']} "
                    f"received + {HEAL_SLACK}")
        heals[name] = {"per_rank": [c[key] for c in per_rank],
                       "plain_max_abs_err": [c["plain_max_abs_err"]
                                             for c in per_rank],
                       "one_card_4_shards": one[name]["one_card_4_shards"]}
    emit({"phase": "dist_heal", "world": world, "n_shards": DIST_SHARDS,
          "config": "webparf.CONFIG", "card": card, "dead_shard": DIST_DEAD,
          "bit_equal_to_one_card": heal_names, "lost": 0, "cases": heals})
    pages = {}
    for name, _, _, _ in DIST_CASES:
        got = [c["pages_per_s"] for r in range(world)
               for c in ranks[r]["cases"] if c["case"] == name]
        pages[name] = {f"{world}_cards": got[0],
                       f"{world}_cards_slowest_rank": min(got),
                       **{k: v["pages_per_s"] for k, v in one[name].items()}}
    shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "dist", "world": world, "n_shards": DIST_SHARDS,
          "config": "webparf.CONFIG", "card": card,
          "bit_equal_to_one_card": [c[0] for c in DIST_CASES]
          + heal_names + ["serve"],
          "pages_per_s": pages, "one_card": one,
          "seconds": time.time() - t0})
    return ranks


# ---------------------------------------------------------------------------
# dist_train: training on the train mesh, one process a card
# ---------------------------------------------------------------------------

DT_LR = 1e-3                # every case's AdamW lr (constant)
DT_MOE_STEPS = 3            # C1: the reduced f32 MoE's steps
DT_MOE_TB, DT_MOE_TS = 8, 64   # C1: a data process's batch
DT_QWEN_STEPS = 3           # C2: Qwen2-1.5B's steps (the first warms up)
DT_BIG_MOE_LAYERS = 8       # C3: DeepSeekMoE-16B cut to 1 dense + 7 MoE
DT_BIG_MOE_TB = 2           # C3: a data process's sequences of TRAIN_SEQ
DT_RECSYS = ("dcn-v2", "wide-deep")
DT_RECSYS_BATCH = 65536     # C4: the published train_batch, global
DT_BF16_LOSS_TOL = 1e-3     # C2: bf16 loss, the mesh against one card
DT_BF16_GNORM_RTOL = 1e-2   # C2: bf16 grad norm, relative
DT_RECSYS_TIMED = 5         # C4: timed steps, one card's and the mesh's
DT_TIMEOUT_S = 900          # the ranks' whole run
DT_REMESH = ((4, 1), (1, 4))


def dt_cases(world):
    """{case: [meshes]} this world runs: every case on four cards, the
    reduced MoE alone at (W, 1) on fewer."""
    if world == 4:
        return {"moe_f32": [(2, 2), (4, 1)], "qwen2_bf16": [(2, 2), (4, 1)],
                "moe_16b": [(1, 4), (2, 2)], "recsys": [(2, 2)]}
    return {"moe_f32": [(world, 1)]}


class DispatchSpy:
    """``layers.moe_dispatch`` watched: each call's (e, slot, keep) on
    the host (``w`` too when ``weights``)."""

    def __init__(self, weights=False):
        from repro_torch.models import layers as TL
        self.mod, self.orig, self.calls = TL, TL.moe_dispatch, []
        self.weights = weights

    def __enter__(self):
        def spy(logits, m, capacity):
            out = self.orig(logits, m, capacity)
            keep = out[:4] if self.weights else out[1:4]
            self.calls.append(tuple(t.detach().cpu().numpy() for t in keep))
            return out
        self.mod.moe_dispatch = spy
        return self

    def __exit__(self, *a):
        self.mod.moe_dispatch = self.orig


def dt_first_attention(step, state, batch):
    """``step(state, batch)`` with its first attention call's q, k, v
    captured: (state, metrics, (q, k, v))."""
    from repro_torch.kernels.flash_attention import ops as FA
    got, orig = [], FA.attention

    def spy(q, k, v, **kw):
        if not got:
            got.append(tuple(x.detach().clone() for x in (q, k, v)))
        return orig(q, k, v, **kw)
    FA.attention = spy
    try:
        st, m = step(state, batch)
    finally:
        FA.attention = orig
    return st, m, got[0]


def dt_state_bytes(state, shardings, mesh):
    """(the bytes of this process's blocks of a placed state, the bytes
    its specs reckon a process holds, the whole state's bytes)."""
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as TC
    specs = dict(dt_spec_items(shardings))
    held = reckoned = whole = 0
    for k, leaf in TC._items(state):
        size = leaf.element_size()
        held += leaf.to_local().numel() * size
        blk = rules.local_slices(leaf.shape, rules.NamedSharding(
            mesh, specs[k].spec))
        reckoned += int(np.prod([b.stop - b.start for b in blk])) * size
        whole += leaf.numel() * size
    return held, reckoned, whole


def dt_param_bytes(params, mesh):
    """(the bytes of this process's parameter blocks, the bytes of its
    parameters joined over the data axes: what a step that joined the
    whole tree would hold)."""
    from repro_torch.sharding import rules
    block = joined = 0
    for leaf in params.values():
        sh = rules.drop_fsdp(rules.sharding_of(leaf))
        blk = rules.local_slices(leaf.shape, sh)
        block += leaf.to_local().numel() * leaf.element_size()
        joined += int(np.prod([b.stop - b.start for b in blk])) * \
            leaf.element_size()
    return block, joined


def dt_spec_items(tree, prefix=""):
    from repro_torch.sharding import rules
    if isinstance(tree, rules.NamedSharding):
        yield prefix[:-1], tree
    else:
        items = (tree.items() if isinstance(tree, dict) else
                 zip(tree._fields, tree))
        for k, v in items:
            yield from dt_spec_items(v, f"{prefix}{k}/")


def dt_flash_counts(cfg):
    """The launches a step of ``cfg`` must make: its attention kernel
    once a layer, twice under remat (the recompute), nothing else."""
    from repro_torch.kernels import launch_counts
    from repro_torch.kernels.flash_attention import ops as FA
    kern = FA.route("cuda", getattr(__import__("torch"), cfg.dtype),
                    cfg.head_dim)
    want = {k: 0 for k in launch_counts()}
    want[kern.name] = cfg.n_layers * (2 if cfg.remat else 1)
    return want


def dt_lm_batches(cfg, steps, rows, seq):
    """``steps`` (tokens, labels) batches of ``rows`` sequences, seeded."""
    import torch
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, cfg.vocab_size, (steps, rows, seq + 1)
                        ).astype(np.int32)
    dev = None if DEV == "cuda" else DEV
    out = []
    for t in toks:
        t = torch.from_numpy(t).to(dev or "cuda")
        out.append((t[:, :-1].contiguous(), t[:, 1:].contiguous()))
    return out


def dt_moe_small(shape, group, out):
    """C1: the reduced f32 MoE, DT_MOE_STEPS AdamW steps on the mesh
    against the one-card port's under ``activation_mesh`` of the same
    shape: each step's loss and grad norm, the final state, and this
    process's routes (its group of the one-card grouped routing) bit for
    bit. Returns (its line, the final state)."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import trainer as TR
    dev = DEV
    cfg = scaled(get_reduced(MOE_ARCH), dtype="float32")
    dp, tp = shape
    batches = dt_lm_batches(cfg, DT_MOE_STEPS, dp * DT_MOE_TB, DT_MOE_TS)
    loss_fn = lambda p, b: T.lm_loss(p, cfg, b[0], b[1])    # noqa: E731
    opt = adamw(lr=DT_LR)
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device=dev))
    step = TR.make_train_step(loss_fn, opt)
    st = TR.init_train_state(dict(params), opt)
    ref = []
    with rules.activation_mesh({"data": dp, "model": tp}), \
            DispatchSpy() as one_routes:
        for b in batches:
            st, m = step(st, b)
            ref.append((float(m["loss"]), float(m["grad_norm"])))
    ref_flat = TC.flatten(st)
    n_moe = cfg.n_layers - cfg.first_k_dense
    one_routes = one_routes.calls[:n_moe]
    del st
    mesh = make_host_mesh(model=tp)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    g = coord["data"] * tp + coord["model"]
    state = TR.init_train_state(TR.place_params(params, mesh, "lm"), opt)
    got, counts = [], []
    for i, b in enumerate(batches):
        placed = TR.place_batch(b, mesh)
        reset_launches()
        with DispatchSpy() as routes:
            if i == 0:
                state, m, qkv = dt_first_attention(step, state, placed)
            else:
                state, m = step(state, placed)
        torch.cuda.synchronize()
        counts.append(launch_counts())
        got.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            mine = routes.calls[:n_moe]
    for i, ((l0, n0), (l1, n1)) in enumerate(zip(ref, got)):
        if abs(l1 - l0) > 1e-5 or abs(n1 / n0 - 1) > 1e-5:
            raise AssertionError(f"dist_train moe_f32 {shape} step {i}: "
                                 f"loss {l1} / {l0}, grad norm {n1} / {n0}")
    for layer, (one, me) in enumerate(zip(one_routes, mine)):
        for name, a, b in zip(("e", "slot", "keep"), one, me):
            if not np.array_equal(a[g], b[0]):
                raise AssertionError(f"dist_train moe_f32 {shape}: layer "
                                     f"{layer} {name} of group {g} differs "
                                     f"from the one-card grouped routing")
    flat = TC.flatten(state)
    worst = {"max": 0.0, "mean": 0.0}
    for k, v in ref_flat.items():
        if v.dtype.kind != "f":
            if not np.array_equal(flat[k], v):
                raise AssertionError(f"dist_train moe_f32 {shape}: {k}")
            continue
        d = np.abs(flat[k].astype(np.float64) - v)
        worst = {"max": max(worst["max"], float(d.max())),
                 "mean": max(worst["mean"], float(d.mean()))}
    if worst["max"] > 2 * DT_LR * DT_MOE_STEPS or \
            worst["mean"] > 1e-6 * DT_MOE_STEPS:
        raise AssertionError(f"dist_train moe_f32 {shape}: state differs "
                             f"{worst}")
    want = dt_flash_counts(cfg)
    if any(c != want for c in counts):
        raise AssertionError(f"dist_train moe_f32 {shape}: launches "
                             f"{counts}, want {want} a step")
    kname, err, _ = flash_pair(*qkv, True, f"rank {group.rank} moe_f32 "
                               f"{shape}")
    line = {"case": "moe_f32", "mesh": list(shape), "arch": cfg.name,
            "steps": DT_MOE_STEPS, "batch_per_data_rank": DT_MOE_TB,
            "seq_len": DT_MOE_TS, "losses": [l for l, _ in got],
            "one_card_losses": [l for l, _ in ref],
            "grad_norms": [n for _, n in got],
            "state_max_abs_diff": worst["max"],
            "state_worst_mean_abs_diff": worst["mean"],
            "routes_bit_equal_group": g, "launches_per_step": counts[0],
            "flash_kernel": kname, "flash_max_abs_err": err}
    return line, state, params


def dt_remesh(state, params, group, out):
    """C5: the (2, 2) state saved, restored onto each of DT_REMESH: every
    leaf's bits, then one more step, finite and the same on every rank."""
    import shutil
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import trainer as TR
    cfg = scaled(get_reduced(MOE_ARCH), dtype="float32")
    ckpt = out / "remesh_ckpt"
    TC.save(str(ckpt), 1, state)
    saved = TC.load(str(ckpt))
    opt = adamw(lr=DT_LR)
    step = TR.make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]),
                              opt)
    line = {"case": "remesh", "from": [2, 2], "to": {}}
    for shape in DT_REMESH:
        mesh = make_host_mesh(model=shape[1])
        target = TR.init_train_state(TR.place_params(params, mesh, "lm"),
                                     opt)
        restored = TC.restore(str(ckpt), target, shardings=TR.state_shardings(
            target, mesh, "lm"))
        flat = TC.flatten(restored)
        if sorted(flat) != sorted(saved) or any(
                flat[k].tobytes() != saved[k].tobytes() for k in saved):
            raise AssertionError(f"dist_train remesh {shape}: restored "
                                 f"leaves differ from the saved ones")
        b = dt_lm_batches(cfg, 1, shape[0] * DT_MOE_TB, DT_MOE_TS)[0]
        _, m = step(restored, TR.place_batch(b, mesh))
        loss = torch.tensor([float(m["loss"])],
                            device=torch.cuda.current_device()
                            if DEV == "cuda" else DEV)
        all_l = [torch.zeros_like(loss) for _ in range(group.world)]
        torch.distributed.all_gather(all_l, loss)
        ls = [float(x) for x in all_l]
        if len(set(ls)) != 1 or not np.isfinite(ls[0]):
            raise AssertionError(f"dist_train remesh {shape}: losses {ls}")
        line["to"][f"{shape[0]}x{shape[1]}"] = {"bit_equal": True,
                                                "next_loss": ls[0]}
    group.barrier()
    if group.rank == 0:
        shutil.rmtree(ckpt, ignore_errors=True)
    return line


def dt_profile_collectives(step, state, batch):
    """One step under torch.profiler: its wall ms, the NCCL kernels' ms
    (the collectives, waits included) and the other kernels' busy ms."""
    prof = profile_device(lambda: step(state, batch), 1)
    return {"wall_ms": prof["wall_ms_per_call"],
            "collective_ms": prof["collective_ms_per_call"],
            "busy_ms": prof["device_busy_ms_per_call"],
            "collective_share_of_wall": prof["collective_ms_per_call"]
            / prof["wall_ms_per_call"],
            "device_idle_share": prof["device_idle_share"]}


def dt_qwen(shape, group):
    """C2: Qwen2-1.5B at full width and depth, bf16, remat: TRAIN_BATCH x
    TRAIN_SEQ a data process, DT_QWEN_STEPS AdamW steps on the mesh; the
    first step's loss and grad norm against one card's step on the same
    global batch in dp microbatches. Per rank: step ms, tokens/s, peak
    GiB, its state bytes against its specs' reckoning, the collectives'
    share of a profiled step, flash_attention_tc launches a step and its
    first call held to the plain version."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train import trainer as TR
    cfg = get_arch(LM_ARCH)[0]
    dp, tp = shape
    batches = dt_lm_batches(cfg, DT_QWEN_STEPS + 1, dp * TRAIN_BATCH,
                            TRAIN_SEQ)
    loss_fn = lambda p, b: T.lm_loss(p, cfg, b[0], b[1])    # noqa: E731
    opt = adamw(lr=DT_LR)
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device=DEV))
    one = TR.make_train_step(loss_fn, opt, microbatches=dp)
    _, m = one(TR.init_train_state(params, opt), batches[0])
    ref = (float(m["loss"]), float(m["grad_norm"]))
    del m, one
    free_card()
    mesh = make_host_mesh(model=tp)
    state = TR.init_train_state(TR.place_params(params, mesh, "lm"), opt)
    del params
    free_card()
    held, reckoned, whole = dt_state_bytes(
        state, TR.state_shardings(state, mesh, "lm"), mesh)
    grads, joined = dt_param_bytes(state.params, mesh)
    step = TR.make_train_step(loss_fn, opt)
    placed = [TR.place_batch(b, mesh) for b in batches]
    losses, norms, ms, counts = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(DT_QWEN_STEPS):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            state, m, qkv = dt_first_attention(step, state, placed[i])
        else:
            state, m = step(state, placed[i])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        counts.append(launch_counts())
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    prof = dt_profile_collectives(step, state, placed[DT_QWEN_STEPS])
    del state, placed, m
    free_card()
    if abs(losses[0] - ref[0]) > DT_BF16_LOSS_TOL or \
            abs(norms[0] / ref[1] - 1) > DT_BF16_GNORM_RTOL or \
            not finite(losses, norms):
        raise AssertionError(f"dist_train qwen2_bf16 {shape}: loss "
                             f"{losses[0]} / {ref[0]}, grad norm "
                             f"{norms[0]} / {ref[1]}")
    want = dt_flash_counts(cfg)
    if any(c != want for c in counts):
        raise AssertionError(f"dist_train qwen2_bf16 {shape}: launches "
                             f"{counts}, want {want} a step")
    if held != reckoned:
        raise AssertionError(f"dist_train qwen2_bf16 {shape}: holds {held} "
                             f"B, its specs reckon {reckoned}")
    kname, err, share = flash_pair(*qkv, True, f"rank {group.rank} "
                                   f"qwen2_bf16 {shape}")
    steady = ms[1:]
    tokens = TRAIN_BATCH * TRAIN_SEQ
    return {"case": "qwen2_bf16", "mesh": list(shape), "arch": LM_ARCH,
            "batch_per_data_rank": TRAIN_BATCH, "seq_len": TRAIN_SEQ,
            "global_batch": dp * TRAIN_BATCH, "losses": losses,
            "grad_norms": norms, "one_card_loss": ref[0],
            "one_card_grad_norm": ref[1], "one_card_microbatches": dp,
            "step_ms": ms, "tokens_per_s_rank": tokens / (
                np.mean(steady) / 1e3),
            "tokens_per_s_global": dp * tokens / (np.mean(steady) / 1e3),
            "peak_gib": peak, "state_bytes": held,
            "state_bytes_reckoned": reckoned, "state_bytes_whole": whole,
            "grad_bytes": grads, "params_joined_over_data_bytes": joined,
            "state_plus_grads_gib": (held + grads) / 2 ** 30,
            "peak_over_state_plus_grads_gib": peak - (held + grads) / 2 ** 30,
            "profile_one_step": prof, "launches_per_step": counts[0],
            "flash_kernel": kname, "flash_max_abs_err": err,
            "flash_tc_share_of_tolerance": share}


def dt_moe_16b(shape, group):
    """C3: DeepSeekMoE-16B at full width, cut to DT_BIG_MOE_LAYERS layers,
    bf16, remat, DT_BIG_MOE_TB x TRAIN_SEQ a data process: two steps on
    the mesh; the first's drop share a layer on this process beside its
    group's in the one-card grouped routing of the same shape; the
    second's step ms and all_to_all ms a layer (CUDA events around every
    exchange: the forward's, the remat recompute's and the backward's);
    peak GiB."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import scaled
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules, spmd
    from repro_torch.train import trainer as TR
    cfg = scaled(get_arch(MOE_ARCH)[0], n_layers=DT_BIG_MOE_LAYERS)
    dp, tp = shape
    n_moe = cfg.n_layers - cfg.first_k_dense
    (tok, lab), = dt_lm_batches(cfg, 1, dp * DT_BIG_MOE_TB, TRAIN_SEQ)
    params = T.stack_params(T.init_lm(cfg, seed=SEED, device=DEV))
    with torch.no_grad(), rules.activation_mesh({"data": dp, "model": tp}), \
            DispatchSpy() as one:
        T.train_forward(params, cfg, tok)
    one_keep = [c[2] for c in one.calls[:n_moe]]
    free_card()
    mesh = make_host_mesh(model=tp)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    g = coord["data"] * tp + coord["model"]
    opt = adamw(lr=DT_LR)
    state = TR.init_train_state(TR.place_params(params, mesh, "lm"), opt)
    del params
    free_card()
    held, reckoned, whole = dt_state_bytes(
        state, TR.state_shardings(state, mesh, "lm"), mesh)
    step = TR.make_train_step(lambda p, b: T.lm_loss(p, cfg, b[0], b[1]),
                              opt)
    placed = TR.place_batch((tok, lab), mesh)
    events, orig = [], spmd._a2a

    def timed(x, axis):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        y = orig(x, axis)
        stop.record()
        events.append((start, stop, x.numel() * x.element_size()))
        return y
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the first step (routes against the one-card grouped routing) starts
    # the mesh's NCCL communicators; the second is timed
    with DispatchSpy() as mine:
        t0 = time.perf_counter()
        state, m = step(state, placed)
        torch.cuda.synchronize()
        first_ms = 1e3 * (time.perf_counter() - t0)
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    spmd._a2a = timed
    try:
        t0 = time.perf_counter()
        state, m = step(state, placed)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0)
    finally:
        spmd._a2a = orig
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    a2a_ms = sum(a.elapsed_time(b) for a, b, _ in events)
    my_keep = [c[2][0] for c in mine.calls[:n_moe]]
    del state, placed, m
    free_card()
    if not finite(loss, norm) or held != reckoned:
        raise AssertionError(f"dist_train moe_16b {shape}: loss {loss}, "
                             f"grad norm {norm}, holds {held} B of "
                             f"{reckoned} reckoned")
    drop = [1 - float(k.mean()) for k in my_keep]
    one_drop = [1 - float(k[g].mean()) for k in one_keep]
    return {"case": "moe_16b", "mesh": list(shape), "arch": MOE_ARCH,
            "layers": cfg.n_layers, "moe_layers": n_moe,
            "cut": f"depth {cfg.n_layers} of 28 (1 dense + {n_moe} MoE)",
            "batch_per_data_rank": DT_BIG_MOE_TB, "seq_len": TRAIN_SEQ,
            "loss": loss, "grad_norm": norm, "first_step_ms": first_ms,
            "step_ms": step_ms, "peak_gib": peak, "state_bytes": held,
            "state_bytes_reckoned": reckoned, "state_bytes_whole": whole,
            "all_to_all_calls": len(events),
            "all_to_all_bytes_per_call": events[0][2] if events else 0,
            "all_to_all_ms_per_layer": a2a_ms / n_moe,
            "all_to_all_share_of_step": a2a_ms / step_ms,
            "drop_share_per_layer": drop,
            "one_card_group_drop_share_per_layer": one_drop,
            "group": g}


def dt_timed_steps(step, state, batch):
    """The ms of each of DT_RECSYS_TIMED steps from ``state`` on the same
    batch (each a fresh state: the steps' results are dropped)."""
    import torch
    out = []
    for _ in range(DT_RECSYS_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def dt_recsys(arch, shape, group):
    """C4: a RecSys arch at its published widths and train batch with
    ``recsys_specs`` (tables row-sharded over "model", the batch over
    "data"): the first step against one card's on the same batch (loss
    1e-5, grad norm 1e-5 relative, every block of the state within 2 *
    lr, mean 1e-6), the second step timed beside one card's second, and
    ``sharded_lookup`` of this process's ids in the first table against
    ``embedding_lookup`` of the whole table, bit for bit. Then
    DT_RECSYS_TIMED steps of one card and of the mesh, each timed
    (``dt_timed_steps``)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys as R
    from repro_torch.optim import adamw
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import trainer as TR
    cfg = get_arch(arch)[0]
    batch = R.make_batch(cfg, ShapeSpec("t", "train", dict(
        batch=DT_RECSYS_BATCH)), rng_key=SEED, device=DEV)
    params = R.INIT[cfg.kind](SEED, cfg, device=DEV)
    opt = adamw(lr=RECSYS_LR)
    loss_fn = lambda p, b: R.TRAIN_LOSS[cfg.kind](p, cfg, b)  # noqa: E731
    step = TR.make_train_step(loss_fn, opt)
    ref, m1 = step(TR.init_train_state(params, opt), batch)
    one_ms = dt_timed_steps(step, ref, batch)
    mesh = make_host_mesh(model=shape[1])
    state = TR.init_train_state(TR.place_params(params, mesh, "recsys"),
                                opt)
    placed = TR.place_batch(batch, mesh, rows=DT_RECSYS_BATCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step(state, placed)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    step_ms = dt_timed_steps(step, state, placed)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    loss, norm = float(m["loss"]), float(m["grad_norm"])
    want_l, want_n = float(m1["loss"]), float(m1["grad_norm"])
    worst = torch.zeros(2, dtype=torch.float64, device=m["loss"].device)
    ref_items = dict(TC._items(ref))
    for k, leaf in TC._items(state):
        blk = rules.local_slices(leaf.shape, rules.sharding_of(leaf))
        d = (leaf.to_local().double() - ref_items[k][blk].double()).abs()
        if d.numel():
            worst = torch.maximum(worst, torch.stack([d.max(), d.mean()]))
    torch.distributed.all_reduce(worst, op=torch.distributed.ReduceOp.MAX)
    first = sorted(cfg.tables)[0]
    table = params[f"tables/{first}"]
    sh = rules.NamedSharding(mesh, ("model", None))
    ids = placed["sparse_ids"].to_local()[:, 0]
    got = R.sharded_lookup(table[rules.local_slices(table.shape, sh)], ids,
                           mesh=mesh)
    bit_equal = bool(torch.equal(got.view(torch.int32), R.embedding_lookup(
        table, ids).view(torch.int32)))
    held, reckoned, whole = dt_state_bytes(
        state, TR.state_shardings(state, mesh, "recsys"), mesh)
    del state, ref, placed, batch, params
    free_card()
    if abs(loss - want_l) > 1e-5 or abs(norm / want_n - 1) > 1e-5 or \
            worst[0] > 2 * RECSYS_LR or worst[1] > 1e-6 or not bit_equal \
            or held != reckoned:
        raise AssertionError(f"dist_train recsys {arch} {shape}: loss "
                             f"{loss} / {want_l}, grad norm {norm} / "
                             f"{want_n}, state {worst.tolist()}, lookup "
                             f"bit-equal {bit_equal}, {held} B of "
                             f"{reckoned}")
    return {"case": f"recsys_{arch}", "mesh": list(shape), "arch": arch,
            "batch": DT_RECSYS_BATCH, "loss": loss, "one_card_loss": want_l,
            "grad_norm": norm, "one_card_grad_norm": want_n,
            "state_max_abs_diff": float(worst[0]),
            "state_worst_mean_abs_diff": float(worst[1]),
            "sharded_lookup_bit_equal": bit_equal,
            "first_step_ms": first_ms, "step_ms": step_ms,
            "one_card_step_ms": one_ms,
            "mesh_over_one_card_median": float(np.median(step_ms)
                                               / np.median(one_ms)),
            "peak_gib": peak, "state_bytes": held,
            "state_bytes_reckoned": reckoned, "state_bytes_whole": whole}


def dist_train_rank(out):
    """One rank of the train mesh (``chip_smoke.py --dist-train-rank
    OUT``, started by ``phase_dist_train`` as ``phase_dist`` starts its
    ranks): every case of ``dt_cases(W)`` on its own card over NCCL, each
    held to its one-card run on this rank's card. Its lines to
    ``out/train_rank<rank>.json``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_crawl_group
    group = init_crawl_group(None if DEV == "cuda" else DEV,
                             timeout_s=DIST_GROUP_TIMEOUT_S)
    lines = []
    try:
        cases = dt_cases(group.world)
        for shape in cases["moe_f32"]:
            line, state, params = dt_moe_small(shape, group, out)
            lines.append(line)
            if group.world == 4 and shape == (2, 2):
                lines.append(dt_remesh(state, params, group, out))
            del state, params
            free_card()
        for shape in cases.get("qwen2_bf16", []):
            lines.append(dt_qwen(shape, group))
            free_card()
        for shape in cases.get("moe_16b", []):
            lines.append(dt_moe_16b(shape, group))
            free_card()
        for shape in cases.get("recsys", []):
            for arch in DT_RECSYS:
                lines.append(dt_recsys(arch, shape, group))
                free_card()
        group.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"train_rank{group.rank}.json").write_text(json.dumps(
        {"rank": group.rank, "world": group.world, "cases": lines}))


def run_ranks(flag, out, world, timeout_s):
    """``world`` fresh processes of ``chip_smoke.py <flag> <out>``, rank r
    on card r (RANK, WORLD_SIZE, LOCAL_RANK, a free MASTER_PORT), each
    logging to ``out/<flag>.rank<r>.log``; waited for at most
    ``timeout_s``. Raises if any failed or hung, with its log's tail."""
    import os
    port = free_port()
    procs = []
    tag = flag.strip("-")
    try:
        for r in range(world):
            env = {**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                   "MASTER_PORT": str(port)}
            env.setdefault("NCCL_SOCKET_IFNAME", "lo")
            log = open(out / f"{tag}.rank{r}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"), flag,
                 str(out)], env=env, stdout=log, stderr=subprocess.STDOUT),
                log))
        deadline = time.time() + timeout_s
        while any(p.poll() is None for p, _ in procs):
            if time.time() > deadline or any(
                    p.poll() not in (None, 0) for p, _ in procs):
                break
            time.sleep(0.5)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    bad = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if bad:
        tail = (out / f"{tag}.rank{bad[0]}.log").read_text()[-4000:]
        raise AssertionError(f"{tag}: ranks {bad} of {world} failed or hung "
                             f"(rc {[procs[r][0].returncode for r in bad]})"
                             f":\n{tail}")


def phase_dist_train(world=None):
    """The train mesh on ``world`` cards (default: every card), one fresh
    process a card (``dist_train_rank``): C1 the reduced f32 MoE against
    the one-card port (bit-equal routes), C5 its (2, 2) state re-meshed,
    C2 Qwen2-1.5B and C3 DeepSeekMoE-16B at full width, C4 DCN-v2 and
    Wide&Deep at their published widths (C2-C5 on four cards). Prints a
    ``dist_train`` line a rank and case. Returns {rank: its lines}."""
    import os
    import shutil
    import torch
    world = world or torch.cuda.device_count()
    out = ROOT / "build" / f"dist_train_{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.time()
    run_ranks("--dist-train-rank", out, world, DT_TIMEOUT_S)
    ranks = {r: json.loads((out / f"train_rank{r}.json").read_text())
             for r in range(world)}
    card = nvidia_smi()
    for r, rk in ranks.items():
        for line in rk["cases"]:
            emit({"phase": "dist_train_rank", "world": world, "rank": r,
                  "card": card, **line})
    shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "dist_train", "world": world, "card": card,
          "cases": {k: [list(m) for m in v]
                    for k, v in dt_cases(world).items()},
          "seconds": time.time() - t0})
    return ranks


# ---------------------------------------------------------------------------
# dist_serve: LM serving on a (data, model) mesh, one process a card
# ---------------------------------------------------------------------------

DS_P, DS_M, DS_GEN, DS_B = 28, 64, 8, 2   # S1: prompt, cache slots, tokens,
                                          # batch (its slots cross slot 32)
DS_TOL = 1e-5               # S1: f32 logits, the mesh against one card
DS_PREFILL_B = 32           # S2: Qwen2-1.5B prefill_32k's published batch
DS_DECODE_B = 128           # S3: decode_32k's published batch
DS_LONG = ("phi3-mini-3.8b", "deepseek-coder-33b", MOE_ARCH)   # S4
DS_DECODE_REL = 2.0 ** -6   # S4: layer 0's merged attention, |err| / |want|
                            # (norms), against one card (bf16)
DS_TOKENS = 8               # S3/S4: decode tokens timed
DS_EXTRA = 3                # S3/S4: a warm-up token, a profiled one and one
                            # under the sync counter, before and after them
DS_TIMEOUT_S = 900          # the ranks' whole run


def ds_decode_tol(want, vmax):
    """A bf16 mesh decode's worst case against one card's
    ``decode_attention``: one card rounds p / l to bf16 before its product
    with v (at most 2^-8 of each p / l, so 2^-8 max|v| over the output),
    the merge normalises after the sum; each output then rounds to bf16
    (2^-8 of |want| each way). Over long_500k's slots it outgrows the
    output itself, so the case also holds the error's norm to
    DS_DECODE_REL of the output's and shows a merge missing a segment
    failing that. ``tests/test_torch_dist_serve.py`` states and measures
    both."""
    return 2.0 ** -8 * vmax + 2.0 ** -7 * want.abs()


def ds_cases(world):
    """{case: [meshes]} this world runs: every case on four cards, S1
    alone at (W, 1) on fewer."""
    if world == 4:
        return {"s1": [(4, 1), (2, 2), (1, 4)], "s2": [(4, 1)],
                "s3": [(4, 1)], "s4": [(1, 4)]}
    return {"s1": [(world, 1)]}


def ds_reckon(arch, shape, mesh_shape, rank, **kw):
    """The dry run's per-card record of this process of a (data, model)
    mesh for the cell (``dryrun.run_cell`` under a ``spmd.MetaMesh``)."""
    from repro_torch.launch import dryrun
    from repro_torch.sharding import spmd
    return dryrun.run_cell(arch, shape, search=False, mesh=spmd.MetaMesh(
        {"data": mesh_shape[0], "model": mesh_shape[1]}, rank), **kw)


def ds_blocks(cfg, shardings):
    """This process's block of every parameter of ``cfg``, drawn on the
    card from a generator seeded by the leaf's path and the block's place
    in the whole leaf (processes that hold the same block draw the same
    values; no process holds the whole tree): norms 1, biases 0, the
    rest N(0, 1/fan_in) (the embedding's N(0, 1/d))."""
    import zlib
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    out = {}
    for k, v in T.stack_params(T.LM(cfg, "meta")).items():
        sl = rules.local_slices(v.shape, shardings[k])
        t = torch.empty(tuple(s.stop - s.start for s in sl), dtype=v.dtype,
                        device=DEV)
        name = k.rsplit("/", 1)[-1]
        if name in ("ln1", "ln2", "final_norm"):
            t.fill_(1.0)
        elif name in ("bq", "bk", "bv"):
            t.zero_()
        else:
            seed = SEED + zlib.crc32(f"{k}@{[s.start for s in sl]}".encode())
            g = torch.Generator(device=DEV).manual_seed(seed)
            fan = v.shape[-1] if k == "embed" else v.shape[-2]
            t.normal_(0.0, fan ** -0.5, generator=g)
        out[k] = t
    return out


def ds_setup(cfg, shape, B, max_len):
    """(mesh, shardings, layout, this process's token-row slice) of a
    serving case on a fresh (data, model) mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    mesh = make_host_mesh(model=shape[1])
    psh = rules.lm_specs(T.stack_params(T.LM(cfg, "meta")), mesh)
    layout = T.serve_layout(mesh, cfg, B, max_len)
    rows = (layout.rows[0] if len(layout.rows) == 1 else
            (layout.rows or None))
    sl = rules.local_slices((B, 1), rules.NamedSharding(mesh, (rows, None)))
    return mesh, psh, layout, sl[0]


def ds_tokens(cfg, B, n, rows, seed):
    import torch
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n))
    return torch.tensor(toks[rows], dtype=torch.int64, device=DEV)


def ds_peak_line(rec, base, colls, label, gate=True):
    """Measured peaks (from ``base``) beside the per-card reckoning, and
    the collectives counted against the reckoned ones; raises past
    PEAK_TOL (``gate``) or when the collectives differ."""
    import torch
    measured = torch.cuda.max_memory_allocated() - base[0]
    reserved = torch.cuda.max_memory_reserved() - base[1]
    reckoned = rec["memory"]["total_per_device"]
    ratio = reckoned / measured
    if gate and abs(ratio - 1) > PEAK_TOL:
        raise AssertionError(f"dist_serve {label}: reckoned peak {reckoned} "
                             f"is {ratio:.3f} of the measured {measured}")
    if colls != rec["collectives"]:
        raise AssertionError(f"dist_serve {label}: collectives {colls}, "
                             f"reckoned {rec['collectives']}")
    return {"measured_peak_gib": measured / 2 ** 30,
            "reckoned_peak_gib": reckoned / 2 ** 30, "peak_ratio": ratio,
            "peak_gated": gate,
            "measured_reserved_gib": reserved / 2 ** 30,
            "reckoned_segments_gib": rec["memory"]["reserved_peak"] / 2 ** 30,
            "reckoned_fits": rec["fits"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "collectives": colls,
            "collective_bytes": sum(c["bytes"] for c in colls.values()),
            "reckoned_collective_bytes": rec["collective_bytes"]}


def ds_base():
    """cuBLAS's workspaces made, the cache emptied, the peaks reset:
    (allocated, reserved) to measure a case's peaks from."""
    import torch
    a = torch.ones(64, 64, device=DEV)
    (a @ a).sum().item()
    (a.bfloat16() @ a.bfloat16()).sum().item()
    del a
    free_card()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated(), torch.cuda.memory_reserved()


def ds_small(arch, shape, group):
    """S1: the reduced f32 model, a DS_B x DS_P prompt prefilled into
    DS_M slots and DS_GEN teacher-forced tokens on the mesh against this
    card's one-card port under ``activation_mesh`` of the same shape:
    logits of this process's rows within DS_TOL, its routes bit-equal to
    its group's of the one-card routing, flash_attention once a layer a
    prefill, rank 0's first call held to the plain version."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules, spmd
    cfg = scaled(get_reduced(arch), dtype="float32")
    dp, tp = shape
    rec = ds_reckon(arch, "prefill_32k", shape, group.rank, cfg=cfg,
                    batch=DS_B, seq_len=DS_P, cache_len=DS_M)
    model = T.init_lm(cfg, seed=SEED, device=DEV)
    params = T.stack_params(model)
    toks = np.random.default_rng(SEED + 31).integers(
        0, cfg.vocab_size, (DS_B, DS_P + DS_GEN))
    whole = torch.tensor(toks, dtype=torch.int64, device=DEV)
    ref = []
    with rules.activation_mesh({"data": dp, "model": tp}), \
            DispatchSpy() as one:
        lg, cache = T.prefill_step(model, whole[:, :DS_P], max_len=DS_M)
        ref.append(lg)
        for i in range(DS_GEN):
            lg, cache = T.decode_step(model, whole[:, DS_P + i:DS_P + i + 1],
                                      cache)
            ref.append(lg)
    del model, cache
    mesh, psh, layout, rows = ds_setup(cfg, shape, DS_B, DS_M)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    g = coord["data"] * tp + coord["model"]
    base = ds_base()
    blocks = {k: v[rules.local_slices(v.shape, psh[k])].clone()
              for k, v in params.items()}
    mine = whole[rows]
    J = spmd.Joined(blocks, psh)
    got, qkv, orig = [], [], FA.attention

    def first(q, k, v, **kw):
        out = orig(q, k, v, **kw)
        if not qkv:
            qkv.append(tuple(x.detach().clone() for x in (q, k, v)))
        return out
    with rules.activation_mesh(mesh), DispatchSpy() as me:
        reset_launches()
        spmd.reset_collectives()
        FA.attention = first
        try:
            lg, cache = T.prefill_step(J, mine[:, :DS_P], max_len=DS_M,
                                       cfg=cfg, layout=layout)
        finally:
            FA.attention = orig
        torch.cuda.synchronize()
        counts, colls = launch_counts(), spmd.collectives()
        peaks = ds_peak_line(rec, base, colls, f"s1 {arch} {shape}",
                             gate=False)
        got.append(lg)
        for i in range(DS_GEN):
            lg, cache = T.decode_step(J, mine[:, DS_P + i:DS_P + i + 1],
                                      cache, cfg=cfg, layout=layout)
            got.append(lg)
        prof = profile_device(lambda: T.decode_step(
            J, mine[:, -1:], cache, cfg=cfg, layout=layout), 1)
        syncs = count_call_syncs(lambda: T.decode_step(
            J, mine[:, -1:], cache, cfg=cfg, layout=layout))[0]
    errs = [float((a - b[rows]).abs().max()) for a, b in zip(got, ref)]
    if max(errs) > DS_TOL or not all(torch.isfinite(x).all() for x in got):
        raise AssertionError(f"dist_serve s1 {arch} {shape} rank "
                             f"{group.rank}: logits differ by {max(errs)}")
    for i, (a, b) in enumerate(zip(one.calls, me.calls)):
        for name, x, y in zip(("e", "slot", "keep"), a, b):
            want = x[g] if x.shape[0] > 1 else x[0]
            if not np.array_equal(want, y[0]):
                raise AssertionError(f"dist_serve s1 {arch} {shape}: call "
                                     f"{i} {name} differs from the "
                                     f"one-card routing")
    want = {k: 0 for k in counts}
    want["flash_attention"] = cfg.n_layers
    if counts != want:
        raise AssertionError(f"dist_serve s1 {arch} {shape}: launches "
                             f"{counts}, want {want}")
    line = {"case": "s1", "mesh": list(shape), "arch": cfg.name,
            "batch": DS_B, "prompt": DS_P, "cache_len": DS_M,
            "decode_tokens": DS_GEN, "layout": layout._asdict(),
            "logits_max_abs_err": max(errs), "tolerance": DS_TOL,
            "routes_bit_equal": len(me.calls), "group": g,
            "launches_per_prefill": counts,
            "decode_device_events_per_token": prof["device_events_per_call"],
            "decode_host_syncs_per_token": syncs, "prefill": peaks}
    if group.rank == 0:
        line["flash_kernel"], line["flash_max_abs_err"], _ = flash_pair(
            *qkv[0], True, f"dist_serve s1 {arch} {shape}")
    return line


def ds_timed(fn, n):
    """ms of each of ``n`` calls of ``fn``, each waited for."""
    import torch
    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def ds_prefill(shape, group):
    """S2: Qwen2-1.5B prefill_32k at DS_PREFILL_B (or the per-card
    reckoning's cut) on the mesh, bf16, seeded blocks: a warm-up prefill
    (launches zeroed just before, read just after: flash_attention_tc once
    a layer), a timed one (its collectives counted), the peaks beside the
    reckoning, then rank 0's layers 0 and 27 held to the plain version and
    tc_plain's bound on batch row 0."""
    import torch
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.kernels import launch_counts, reset_launches
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules, spmd
    cfg = get_arch(LM_ARCH)[0]
    S = get_shape(LM_ARCH, "prefill_32k")["seq_len"]
    B, cut = DS_PREFILL_B, None
    rec = ds_reckon(LM_ARCH, "prefill_32k", shape, group.rank, batch=B)
    if not rec["fits"]:
        B = cut = dryrun.mesh_record(LM_ARCH, "prefill_32k",
                                     f"{shape[0]}x{shape[1]}",
                                     rank=group.rank)[
            "largest_batch_that_fits"]
        rec = ds_reckon(LM_ARCH, "prefill_32k", shape, group.rank, batch=B)
    mesh, psh, layout, rows = ds_setup(cfg, shape, B, S)
    base = ds_base()
    J = spmd.Joined(ds_blocks(cfg, psh), psh)
    tok = ds_tokens(cfg, B, S, rows, SEED + 32)

    def prefill():
        with rules.activation_mesh(mesh):
            return T.prefill_step(J, tok, max_len=S, cfg=cfg, layout=layout)
    reset_launches()
    out = prefill()
    torch.cuda.synchronize()
    counts = launch_counts()
    finite = bool(torch.isfinite(out[0]).all())
    del out
    spmd.reset_collectives()
    ms = ds_timed(prefill, 1)[0]
    colls = spmd.collectives()
    peaks = ds_peak_line(rec, base, colls, f"s2 {shape}")
    prof = profile_device(prefill, 1)
    syncs = count_call_syncs(prefill)[0]
    want = {k: 0 for k in counts}
    want["flash_attention_tc"] = cfg.n_layers
    if counts != want or not finite:
        raise AssertionError(f"dist_serve s2 {shape}: launches {counts}, "
                             f"want {want}; finite {finite}")
    line = {"case": "s2", "mesh": list(shape), "arch": LM_ARCH,
            "cell": "prefill_32k", "batch": B, "batch_per_data_rank":
            tok.shape[0], "published_batch": DS_PREFILL_B,
            "cut_to_largest_batch_that_fits": cut, "seq_len": S,
            "prefill_ms": ms, "tok_per_s_rank": tok.numel() / (ms / 1e3),
            "tok_per_s_mesh": B * S / (ms / 1e3),
            "launches_per_prefill": counts,
            "prefill_device_events": prof["device_events_per_call"],
            "prefill_device_idle_share": prof["device_idle_share"],
            "prefill_collective_ms": prof["collective_ms_per_call"],
            "prefill_host_syncs": syncs, **peaks}
    # every rank prefills once more (the collectives are the group's);
    # rank 0 keeps its layers 0 and 27
    got, orig = {}, FA.attention

    def spy(q, k, v, **kw):
        o = orig(q, k, v, **kw)
        i = len(got)
        got[i] = ((q[:1].clone(), k[:1].clone(), v[:1].clone(),
                   o[:1].clone()) if group.rank == 0
                  and i in (0, cfg.n_layers - 1) else None)
        return o
    FA.attention = spy
    try:
        prefill()
    finally:
        FA.attention = orig
    if group.rank == 0:
        for i in (0, cfg.n_layers - 1):
            q, k, v, o = got[i]
            err, share = hold_flash(o, q, k, v, True,
                                    f"dist_serve s2 layer {i}", tc=True)
            line[f"layer{i}_flash_max_abs_err"] = err
            line[f"layer{i}_tc_share_of_tolerance"] = share
        del got
    return line


def ds_decode(arch, shape_name, shape, B, group, check_layer0=False):
    """S3/S4: ``arch``'s decode cell on the mesh, bf16, seeded blocks and a
    seeded cache whose last DS_TOKENS + DS_EXTRA slots are free: a
    warm-up token, DS_TOKENS timed (the first's collectives counted; an
    MoE's routes gathered and held equal on every rank), one profiled, one
    under the sync counter; the peaks beside the reckoning. With
    ``check_layer0``, layer 0's merged attention output of the first timed
    token held to one card's ``decode_attention`` over the layer-0 cache
    gathered on rank 0 (``ds_decode_tol``)."""
    import hashlib
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules, spmd
    cfg = get_arch(arch)[0]
    S = get_shape(arch, shape_name)["seq_len"]
    cut = None
    rec = ds_reckon(arch, shape_name, shape, group.rank, batch=B)
    if not rec["fits"]:
        B = cut = dryrun.mesh_record(arch, shape_name,
                                     f"{shape[0]}x{shape[1]}",
                                     rank=group.rank)[
            "largest_batch_that_fits"]
        rec = ds_reckon(arch, shape_name, shape, group.rank, batch=B)
    mesh, psh, layout, rows = ds_setup(cfg, shape, B, S)
    whole = T.init_cache(cfg, B, S, device="meta")
    csh = rules.cache_specs(whole, mesh, B)
    base = ds_base()
    J = spmd.Joined(ds_blocks(cfg, psh), psh)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 33 + group.rank)
    parts = []
    for t, sh in zip(whole, csh):
        if t is None:
            parts.append(None)
            continue
        blk = torch.empty(tuple(s.stop - s.start for s in
                                rules.local_slices(t.shape, sh)),
                          dtype=t.dtype, device=DEV)
        if blk.is_floating_point():
            blk.normal_(generator=gen)
        else:
            blk.fill_(S - DS_TOKENS - DS_EXTRA)
        parts.append(blk)
    cache = [T.LMCache(*parts)]
    tok = ds_tokens(cfg, B, 1, rows, SEED + 34)

    def step():
        with rules.activation_mesh(mesh):
            logits, cache[0] = T.decode_step(J, tok, cache[0], cfg=cfg,
                                             layout=layout)
        return logits
    finite = bool(torch.isfinite(step()).all())
    q0, merged = [], []
    undo = [spy_on(L, "decode_attention_partial",
                   lambda i, a, o: q0.append(a[0].clone()) if i == 0
                   else None),
            spy_on(spmd, "merge_softmax",
                   lambda i, a, o: merged.append(o.clone()) if i == 0
                   else None)]
    n0 = int(cache[0].length[0]) + 1
    routes = DispatchSpy()
    spmd.reset_collectives()
    try:
        with routes:
            ms = []
            for i in range(DS_TOKENS):
                ms += ds_timed(step, 1)
                if i == 0:
                    colls = spmd.collectives()
                    for u in undo:
                        u()
                    undo = []
    finally:
        for u in undo:
            u()
    peaks = ds_peak_line(rec, base, colls, f"{shape_name} {arch} {shape}")
    prof = profile_device(step, 1)
    syncs = count_call_syncs(step)[0]
    if int(cache[0].length[0]) != S or not finite:
        raise AssertionError(f"dist_serve {arch} {shape_name}: length "
                             f"{int(cache[0].length[0])} of {S}, finite "
                             f"{finite}")
    line = {"case": "s3" if shape_name == "decode_32k" else "s4",
            "mesh": list(shape), "arch": arch, "cell": shape_name,
            "batch": B, "published_batch": get_shape(arch, shape_name)[
                "global_batch"], "cut_to_largest_batch_that_fits": cut,
            "cache_len": S, "cache_len_per_rank": parts[2].shape[3],
            "valid_at_start": S - DS_TOKENS - DS_EXTRA,
            "layout": layout._asdict(), "decode_tokens": DS_TOKENS,
            "decode_ms_per_token": float(np.mean(ms)), "decode_ms": ms,
            "decode_device_events_per_token": prof["device_events_per_call"],
            "decode_device_idle_share": prof["device_idle_share"],
            "decode_collective_ms_per_token": prof["collective_ms_per_call"],
            "decode_host_syncs_per_token": syncs, **peaks}
    if routes.calls:
        h = hashlib.sha256()
        for c in routes.calls:
            for a in c:
                h.update(a.tobytes())
        mine = torch.tensor(list(h.digest()), dtype=torch.uint8, device=DEV)
        every = group.gather(mine[None]).cpu()
        if not all(torch.equal(every[r], every[0])
                   for r in range(group.world)):
            raise AssertionError(f"dist_serve {arch}: routes differ "
                                 f"between ranks")
        line["routes_equal_on_every_rank"] = len(routes.calls)
    if check_layer0:
        first = cache[0].prefix_k is not None
        k0 = (cache[0].prefix_k if first else cache[0].main_k)[0].clone()
        v0 = (cache[0].prefix_v if first else cache[0].main_v)[0].clone()
        cache.clear()
        parts.clear()
        del J
        free_card()
        ks = [torch.empty_like(k0) for _ in range(group.world)] \
            if group.rank == 0 else None
        dist.gather(k0, ks, dst=0)
        del k0
        vs = [torch.empty_like(v0) for _ in range(group.world)] \
            if group.rank == 0 else None
        dist.gather(v0, vs, dst=0)
        del v0
        if group.rank == 0:
            K, V = torch.cat(ks, dim=2), torch.cat(vs, dim=2)
            seg = ks[0].shape[2]
            del ks, vs
            q = q0[0]
            n = torch.full((q.shape[0],), n0, dtype=torch.int32, device=DEV)
            want = L.decode_attention(q, K, V, n).float()
            vmax = float(V[:, :, :n0].float().abs().max())
            # a planted fault: the merge without the last segment that
            # holds valid slots
            planted = L.decode_attention(q, K, V, torch.full_like(
                n, (n0 - 1) // seg * seg)).float()
            del K, V
            have = merged[0].reshape(want.shape).to(q.dtype).float()
            share = float(((have - want).abs() / ds_decode_tol(
                want, vmax)).max())
            rel = float((have - want).norm() / want.norm())
            rel_planted = float((planted - want).norm() / want.norm())
            line.update(layer0_decode_max_abs_err=float(
                (have - want).abs().max()), layer0_live_slots=n0,
                layer0_share_of_worst_case=share,
                layer0_worst_case="2^-8 max|v| + 2^-7 |want|",
                layer0_rel_err=rel, layer0_rel_tolerance=DS_DECODE_REL,
                layer0_rel_err_without_last_segment=rel_planted,
                layer0_max_abs_want=float(want.abs().max()))
            if (share > 1 or rel > DS_DECODE_REL
                    or not torch.isfinite(have).all()):
                raise AssertionError(f"dist_serve {arch}: layer 0's merged "
                                     f"attention is {rel} of one card's "
                                     f"decode_attention ({share} of the "
                                     f"worst case)")
            if rel_planted <= DS_DECODE_REL:
                raise AssertionError(f"dist_serve {arch}: a merge without "
                                     f"the last segment reads {rel_planted},"
                                     f" within the tolerance")
        group.barrier()
    return line


def dist_serve_rank(out):
    """One rank of the serving mesh (``chip_smoke.py --dist-serve-rank
    OUT``, started by ``phase_dist_serve``): every case of
    ``ds_cases(W)`` on its own card over NCCL. Its lines to
    ``out/serve_rank<rank>.json``, each also printed to its log as its
    case ends."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_crawl_group
    group = init_crawl_group(None if DEV == "cuda" else DEV,
                             timeout_s=DIST_GROUP_TIMEOUT_S)
    lines = []

    def done(line):
        print(json.dumps(line), flush=True)
        lines.append(line)
        free_card()
    try:
        cases = ds_cases(group.world)
        for shape in cases.get("s1", []):
            for arch in (LM_ARCH, MOE_ARCH):
                done(ds_small(arch, shape, group))
        for shape in cases.get("s2", []):
            done(ds_prefill(shape, group))
        for shape in cases.get("s3", []):
            done(ds_decode(LM_ARCH, "decode_32k", shape, DS_DECODE_B, group))
        for shape in cases.get("s4", []):
            for arch in DS_LONG:
                done(ds_decode(arch, "long_500k", shape, 1, group,
                               check_layer0=True))
        group.barrier()
    finally:
        dist.destroy_process_group()
    (out / f"serve_rank{group.rank}.json").write_text(json.dumps(
        {"rank": group.rank, "world": group.world, "cases": lines}))


def phase_dist_serve(world=None):
    """LM serving on ``world`` cards (default: every card), one fresh
    process a card (``dist_serve_rank``): S1 the reduced f32 Qwen2 and
    DeepSeekMoE against the one-card port, S2 Qwen2-1.5B prefill_32k at
    batch 32, S3 its decode_32k at 128, S4 the three long_500k cells that
    no single card holds (S2-S4 on four cards). Prints a ``dist_serve``
    line a rank and case. Returns {rank: its lines}."""
    import os
    import shutil
    import torch
    world = world or torch.cuda.device_count()
    out = ROOT / "build" / f"dist_serve_{os.getpid()}"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    t0 = time.time()
    run_ranks("--dist-serve-rank", out, world, DS_TIMEOUT_S)
    ranks = {r: json.loads((out / f"serve_rank{r}.json").read_text())
             for r in range(world)}
    card = nvidia_smi()
    for r, rk in ranks.items():
        for line in rk["cases"]:
            emit({"phase": "dist_serve_rank", "world": world, "rank": r,
                  "card": card, **line})
    shutil.rmtree(out, ignore_errors=True)
    emit({"phase": "dist_serve", "world": world, "card": card,
          "cases": {k: [list(m) for m in v]
                    for k, v in ds_cases(world).items()},
          "seconds": time.time() - t0})
    return ranks


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    if sys.argv[1:2] == ["--zoo-cell"]:
        arch, shape, batch = sys.argv[2:5]
        zoo_cell(arch, shape, int(batch))
        return 0
    if sys.argv[1:2] == ["--dist-rank"]:
        dist_rank(Path(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--dist-train-rank"]:
        dist_train_rank(Path(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--dist-serve-rank"]:
        dist_serve_rank(Path(sys.argv[2]))
        return 0
    if sys.argv[1:2] == ["--dist"]:
        # the crawl group, the train mesh and the serving mesh alone, on
        # every card
        phase_build()
        phase_dist()
        free_card()
        phase_dist_train()
        free_card()
        phase_dist_serve()
        print(nvidia_smi(), flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    phase_build()
    recs, dryrun_s = dryrun_all()
    mesh_dryrun = dryrun_mesh_start()
    zoo = phase_lm_zoo(recs)
    mesh_dryrun = dryrun_mesh_finish(mesh_dryrun)
    errs = phase_parity()
    rows_, sharded, checked, profs = {}, {}, {}, {}
    sess, counts, main1 = phase_main("opic_url")
    steps = PATHS["opic_url"][0]
    prof = phase_profile(sess, 2 * sess.cfg.dispatch_interval)
    rows_["opic_url"] = kernels_opic_url(sess, counts, errs, steps, prof)
    rows_["packed"] = phase_packed(sess, errs)
    del sess
    free_card()
    sharded["opic_url"], checked["opic_url"], profs["opic_url"] = \
        main_sharded("opic_url", (counts, main1, prof))
    sess, counts_opic, _ = phase_main("opic")
    spend = kernels_opic(sess)
    del sess
    free_card()
    sess, counts_bl, main1 = phase_main("backlink")
    prof = phase_profile(sess, 2 * sess.cfg.dispatch_interval)
    rows_["backlink"] = kernels_backlink(sess, counts_bl, errs,
                                         PATHS["backlink"][0], prof)
    del sess
    free_card()
    sharded["backlink"], checked["backlink"], profs["backlink"] = \
        main_sharded("backlink", (counts_bl, main1, prof))
    modes = phase_coordination((sharded["opic_url"], profs["opic_url"]))
    phase_trajectory()
    free_card()
    phase_trace_labels()
    free_card()
    phase_heal()
    free_card()
    serve_counts = phase_serve()
    free_card()
    phase_serve_trajectory()
    free_card()
    dist_ranks = phase_dist()
    free_card()
    train_ranks = phase_dist_train()
    free_card()
    serve_ranks = phase_dist_serve()
    free_card()
    flash = phase_flash_parity()
    model, captured, counts_lm = phase_lm_serve()
    phase_lm_long(model)
    del model
    free_card()
    err_captured = phase_lm_captured(captured)
    err_lm = {name: max(max(e.values()), err_captured[name])
              for name, e in flash["max_abs_err"].items()}
    counts_f32 = phase_lm_cpu()
    for arch in LM_CPU_ARCHS[1:]:
        phase_lm_cpu(arch)
    rows_["lm"] = kernels_lm(captured, counts_lm, err_lm, counts_f32)
    tc_row, core_row = rows_["lm"]
    del captured
    free_card()
    train = phase_train()
    free_card()
    train_f32 = phase_train_f32()
    free_card()
    counts_moe, err_moe = phase_moe_serve()
    free_card()
    counts_arctic, err_arctic = phase_moe_arctic()
    free_card()
    phase_moe_groups()
    free_card()
    moe_f32 = phase_moe_cpu()
    phase_examples()
    free_card()
    phase_gnn()
    free_card()
    phase_recsys()
    free_card()
    phase_gnn_recsys_cpu()
    free_card()
    phase_dryrun(recs, dryrun_s, mesh_dryrun)
    tc_row["max_abs_err"] = max(tc_row["max_abs_err"], err_moe, err_arctic,
                                *(c["flash_max_abs_err"] for c in zoo.values()
                                  if "flash_max_abs_err" in c))
    tc_row["launches_per_zoo_prefill"] = {
        f"{label} (batch {c['batch']})": c["flash_attention_tc_launches"]
        for label, c in zoo.items() if "flash_attention_tc_launches" in c}
    tc_row["launches_per_moe_prefill"] = {
        MOE_ARCH: counts_moe["flash_attention_tc"],
        f"{ARCTIC_ARCH} ({ARCTIC_LAYERS} layers)":
            counts_arctic["flash_attention_tc"]}
    core_row["launches_per_moe_f32_prefill"] = moe_f32
    per_train_step = {
        "flash_attention_tc": train["launches_per_step"][
            "flash_attention_tc"],
        "flash_attention": train_f32["launches_per_step"]["flash_attention"]}
    kernels = (rows_["backlink"] + rows_["opic_url"] + rows_["lm"]
               + rows_["packed"])
    for r in kernels:
        if r.get("path") in sharded:
            r[f"launches_{SHARDS}_shards"] = sharded[r["path"]][r["name"]]
            r[f"checked_on_{SHARDS}_shard_calls"] = checked[r["path"]][
                r["name"]]
        if r["name"] in PORT_KERNEL_FNS:
            r[f"launches_serve_{SHARDS}_shards_{SERVE_STEPS}_steps"] = \
                serve_counts[r["name"]]
            r[f"launches_by_mode_{SHARDS}_shards_{COORD_STEPS}_steps"] = {
                k: c[r["name"]] for k, (c, _) in modes.items()}
            r["checked_on_mode_calls"] = {
                k: chk[r["name"]] for k, (_, chk) in modes.items()
                if r["name"] in chk}
        if r["name"] in PORT_KERNEL_FNS:
            r[f"launches_dist_{len(dist_ranks)}_cards_per_rank"] = {
                c["case"]: [next(x for x in rk["cases"] if x["case"] ==
                                 c["case"])["launches"][r["name"]]
                            for rk in dist_ranks.values()]
                for c in dist_ranks[0]["cases"]}
        if r["name"] in ("flash_attention", "flash_attention_tc"):
            r[f"launches_per_mesh_prefill_{len(serve_ranks)}_cards"] = {
                f"rank {rk} {c['case']} {c['arch']} {c['mesh']}":
                    c["launches_per_prefill"][r["name"]]
                for rk, lines in serve_ranks.items()
                for c in lines["cases"] if "launches_per_prefill" in c}
        if r["name"] == "flash_attention":
            r[f"launches_per_mesh_train_step_{len(train_ranks)}_cards"] = {
                f"rank {rk} {c['case']} {c['mesh']}":
                    c["launches_per_step"]["flash_attention"]
                for rk, lines in train_ranks.items()
                for c in lines["cases"] if "launches_per_step" in c}
        if r["name"] in per_train_step:
            r["launches_per_train_step"] = per_train_step[r["name"]]
            r["train_path"] = (
                "qwen2-1.5b bf16 train step (forward + remat recompute; "
                "backward plain)" if r["name"] == "flash_attention_tc" else
                "reduced f32 train step (train_f32; backward plain)")
        if r["name"] in ("frontier_select", "bloom"):
            r["launches_train_corpus_crawl"] = \
                train["corpus"]["launches"][r["name"]]
        if r["name"] == "opic_update":
            r.update(spend, launches_opic_path=counts_opic["opic_update"],
                     launches_per_step_opic_path=(
                         counts_opic["opic_update"] / PATHS["opic"][0]))
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

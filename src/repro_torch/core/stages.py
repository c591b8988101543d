"""The staged crawl pipeline — WebParF's Phase II step as composable stages.
Counterpart of ``repro/core/stages.py``.

    allocate -> fetch_analyze -> extract_stage  [-> dispatch_exchange]

Every stage has the signature ``stage(ctx, state, carry) -> (state, carry,
StatsDelta)``. The frontier pop runs through the ``frontier_select`` kernel
and the Bloom dedup through the ``bloom`` kernel (their plain versions when
the state lies on the CPU). The state's tensors are updated in place where
the JAX stages returned new arrays, so a stage's input state is consumed.

This slice of the port covers the default configuration: a stateless
ordering (``backlink``, ``fifo``, ``learned``), ``exchange`` coordination,
any partitioning policy, and one shard. ``check_supported`` refuses the
rest with the ROADMAP item that will port it. None of these orderings
carries values, so the OPIC value channel (link cash, ``staging_val``, the
payload's value lane, the slot-cash refunds) is not run: ``order_state`` and
``staging_val`` stay at their zero init, as they do in the JAX package.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.coordination import get_coordination
from repro_torch.core import classifier as CLS
from repro_torch.core import dedup as DD
from repro_torch.core import frontier as F
from repro_torch.core import partitioner as PT
from repro_torch.core import router as RT
from repro_torch.core import webgraph as W
from repro_torch.device import resolve_device
from repro_torch.ordering.policies import get_ordering

# stats counters (per shard)
STATS = ("fetched", "fetch_own", "fetch_foreign", "discovered", "dedup_exact",
         "dedup_bloom", "staging_drop", "frontier_drop", "dispatch_sent",
         "dispatch_recv", "dispatch_rounds", "revived",
         "politeness_deferred", "revisit_enqueued",
         "coord_dropped", "coord_deferred")
NSTAT = len(STATS)
SIDX = {n: i for i, n in enumerate(STATS)}

StatsDelta = Dict[str, torch.Tensor]


class CrawlState(NamedTuple):
    # row-indexed (n_slots, ...)
    f_url: torch.Tensor          # int64 holding uint32 URL ids
    f_pri: torch.Tensor
    f_valid: torch.Tensor
    f_arrival: torch.Tensor
    f_dropped: torch.Tensor
    f_inserted: torch.Tensor
    f_rebased: torch.Tensor
    bloom_bits: torch.Tensor     # (n_slots, 2^b) uint8, updated in place
    slot_domain: torch.Tensor
    order_state: torch.Tensor    # (n_slots, ORD_WIDTH) f32; zero here
    # shard-indexed (n_shards, ...)
    staging_url: torch.Tensor    # (n_shards, S) int64 holding uint32
    staging_src: torch.Tensor    # (n_shards, S) int32 source-page domain
    staging_val: torch.Tensor    # (n_shards, S) f32 URL values; zero here
    staging_n: torch.Tensor      # (n_shards,) int32
    outbox_url: torch.Tensor     # (n_shards, B) — the batched mode's carry
    outbox_src: torch.Tensor     # buffer; zeros under exchange
    outbox_val: torch.Tensor
    outbox_n: torch.Tensor
    stats: torch.Tensor          # (n_shards, NSTAT) int32
    # replicated
    slot_of_domain: torch.Tensor
    shard_alive: torch.Tensor
    step: torch.Tensor           # () int32


# The dtype of each leaf in the JAX package's CrawlState; the port differs
# only in URL leaves, which it carries as int64.
JAX_DTYPES = dict(
    f_url=np.uint32, f_pri=np.float32, f_valid=np.bool_, f_arrival=np.int32,
    f_dropped=np.int32, f_inserted=np.int32, f_rebased=np.int32,
    bloom_bits=np.uint8, slot_domain=np.int32, order_state=np.float32,
    staging_url=np.uint32, staging_src=np.int32, staging_val=np.float32,
    staging_n=np.int32, outbox_url=np.uint32, outbox_src=np.int32,
    outbox_val=np.float32, outbox_n=np.int32, stats=np.int32,
    slot_of_domain=np.int32, shard_alive=np.bool_, step=np.int32)
_URL_LEAVES = ("f_url", "staging_url", "outbox_url")


def state_from_numpy(arrays: Dict[str, np.ndarray], device) -> CrawlState:
    """A CrawlState from numpy leaves keyed by field name (a JAX state's
    leaves, or a checkpoint's). The leaves are copied."""
    dev = resolve_device(device)
    out = {}
    for name in CrawlState._fields:
        a = np.asarray(arrays[name])
        want = np.int64 if name in _URL_LEAVES else JAX_DTYPES[name]
        out[name] = torch.tensor(a.astype(want), device=dev)
    return CrawlState(**out)


def state_to_numpy(state: CrawlState) -> Dict[str, np.ndarray]:
    """The state's leaves as numpy arrays in the JAX package's dtypes."""
    return {name: getattr(state, name).cpu().numpy().astype(JAX_DTYPES[name])
            for name in CrawlState._fields}


class StageContext(NamedTuple):
    """Static per-build inputs every stage shares."""
    cfg: CrawlConfig
    n_shards: int
    shard: int                   # this shard's index
    score_fn: Callable           # (urls, cfg, state) -> scores in [0, 1)
    classify_accuracy: float
    cumw: torch.Tensor           # static Zipf cumulative weights
    k_row: int                   # URLs popped per domain row per step
    S: int                       # staging (dispatch buffer) capacity
    cap_ex: int                  # per-destination exchange bucket size
    policy: PT.PartitionPolicy   # resolved from cfg.partitioning
    ordering: object             # resolved from cfg.ordering
    coord: object                # resolved from cfg.coordination


class StepCarry(NamedTuple):
    """Intra-step dataflow between stages (one shard's view)."""
    alive: torch.Tensor          # () bool
    urls: torch.Tensor           # (r, k) URLs popped this step (0 if masked)
    sel: torch.Tensor            # (r, k) actually-fetched mask
    true_dom: torch.Tensor       # (r, k) analyzer's domain


class FetchReport(NamedTuple):
    """Per-step observables (host-side analysis)."""
    fetched_urls: torch.Tensor   # (n_slots, k_row) int64 (0 = none)
    fetched_mask: torch.Tensor   # (n_slots, k_row) bool


Stage = Callable[[StageContext, CrawlState, Optional[StepCarry]],
                 Tuple[CrawlState, StepCarry, StatsDelta]]


def check_supported(cfg: CrawlConfig, n_shards: int) -> None:
    """Refuse what this slice of the port does not cover, naming the
    ROADMAP item that will."""
    get_ordering(cfg.ordering)            # opic / opic_url raise
    get_coordination(cfg.coordination)    # firewall/crossover/batched raise
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry=True is not ported yet (ROADMAP Queue 1: obs/ledger.py)")
    if cfg.rebalance_threshold > 0:
        raise NotImplementedError(
            "rebalance_threshold > 0 is not ported yet (ROADMAP Queue 1: "
            "rebalance/policy.py, after the C4 heal slice)")
    if n_shards != 1:
        raise NotImplementedError(
            "n_shards > 1 is not ported yet (ROADMAP Queue 1, slice 1b: "
            "multi-shard emulation over a leading shard axis)")
    if cfg.kernel_impl != "auto":
        raise ValueError(
            f"kernel_impl={cfg.kernel_impl!r}: the port dispatches by device "
            f"(CUDA tensor -> hand-written kernel, CPU tensor -> plain "
            f"version) and accepts only 'auto'")


# ---------------------------------------------------------------------------
# state plumbing
# ---------------------------------------------------------------------------

def frontier_view(s: CrawlState) -> F.Frontier:
    return F.Frontier(s.f_url, s.f_pri, s.f_valid, s.f_arrival,
                      s.f_dropped, s.f_inserted, s.f_rebased)


def with_frontier(s: CrawlState, f: F.Frontier) -> CrawlState:
    return s._replace(f_url=f.url, f_pri=f.priority, f_valid=f.valid,
                      f_arrival=f.arrival, f_dropped=f.n_dropped,
                      f_inserted=f.n_inserted, f_rebased=f.n_rebased)


def apply_delta(state: CrawlState, delta: StatsDelta) -> CrawlState:
    """Fold a stage's stat increments into the shard-local stats row."""
    for name, val in delta.items():
        state.stats[0, SIDX[name]] += torch.as_tensor(val).to(torch.int32)
    return state


def init_state(cfg: CrawlConfig, n_shards: int, device) -> CrawlState:
    """The initial crawl state on ``device`` (``None`` means cuda; a CUDA
    request without a card raises). The seeds are registered in the Bloom
    filters through the ``bloom`` kernel."""
    check_supported(cfg, n_shards)
    dev = resolve_device(device)
    if cfg.n_domains % n_shards or cfg.n_slots % n_shards:
        raise ValueError(f"{cfg.n_domains} domains / {cfg.n_slots} slots do "
                         f"not split over {n_shards} shards")
    f = PT.seed_frontier(cfg, n_shards, dev)
    dm = PT.identity_map(cfg, n_shards, dev)
    bloom = DD.init_bloom(cfg.n_slots, cfg.bloom_bits_log2, dev)
    DD.probe_insert(bloom, f.url, f.valid, k=cfg.bloom_hashes)
    S = B = cfg.dispatch_capacity

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    return CrawlState(
        f_url=f.url, f_pri=f.priority, f_valid=f.valid, f_arrival=f.arrival,
        f_dropped=f.n_dropped, f_inserted=f.n_inserted, f_rebased=f.n_rebased,
        bloom_bits=bloom.bits, slot_domain=dm.domain_of_slot,
        order_state=get_ordering(cfg.ordering).init_state(cfg, n_shards, dev),
        staging_url=zeros((n_shards, S), torch.int64),
        staging_src=zeros((n_shards, S), torch.int32),
        staging_val=zeros((n_shards, S), torch.float32),
        staging_n=zeros((n_shards,), torch.int32),
        outbox_url=zeros((n_shards, B), torch.int64),
        outbox_src=zeros((n_shards, B), torch.int32),
        outbox_val=zeros((n_shards, B), torch.float32),
        outbox_n=zeros((n_shards,), torch.int32),
        stats=zeros((n_shards, NSTAT), torch.int32),
        slot_of_domain=dm.slot_of_domain, shard_alive=dm.shard_alive,
        step=zeros((), torch.int32))


def make_context(cfg: CrawlConfig, *, n_shards: int, device,
                 shard: int = 0, classify_accuracy: float) -> StageContext:
    """The static inputs of shard ``shard``'s stages; ``cfg.ordering``
    names the scorer."""
    check_supported(cfg, n_shards)
    r_local = cfg.n_slots // n_shards
    S = cfg.dispatch_capacity
    ordering = get_ordering(cfg.ordering)
    return StageContext(
        cfg=cfg, n_shards=n_shards, shard=shard,
        score_fn=ordering.make_score_fn(cfg, n_shards=n_shards),
        classify_accuracy=classify_accuracy,
        cumw=W.zipf_cumweights(cfg, resolve_device(device)),
        k_row=max(1, cfg.fetch_batch // r_local), S=S,
        cap_ex=max(8, -(-S // n_shards) * 2),
        policy=PT.get_policy(cfg.partitioning), ordering=ordering,
        coord=get_coordination(cfg.coordination))


# ---------------------------------------------------------------------------
# the four core stages
# ---------------------------------------------------------------------------

def allocate(ctx: StageContext, state: CrawlState,
             carry: Optional[StepCarry] = None
             ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """URL allocator: pop the top-k of each local domain queue, then enforce
    the per-process fetch budget; candidates beyond it go back to their
    queues, and a dead shard gives back all its pops."""
    cfg = ctx.cfg
    alive = state.shard_alive[ctx.shard]
    urls, pri, pre_sel, fr = F.select(frontier_view(state), ctx.k_row)

    def give_back(fr, mask):
        return F.insert(fr, urls, ctx.score_fn(urls, cfg, state), mask,
                        n_buckets=cfg.n_priority_buckets)

    if urls.shape[0] * ctx.k_row > cfg.fetch_batch:
        flat_pri = torch.where(pre_sel, pri,
                               torch.full_like(pri, F.NEG)).reshape(-1)
        kth = torch.sort(flat_pri, descending=True).values[cfg.fetch_batch - 1]
        budget = (flat_pri >= kth).reshape(pre_sel.shape)
        # ties at the threshold may pass a few URLs over the budget
        fr = give_back(fr, pre_sel & ~budget)
        pre_sel = pre_sel & budget
    sel = pre_sel & alive
    dead_gb = pre_sel & ~alive
    fr = give_back(fr, dead_gb)
    carry = StepCarry(
        alive=alive, urls=urls, sel=sel,
        true_dom=torch.zeros(urls.shape, dtype=torch.int64,
                             device=urls.device))
    return with_frontier(state, fr), carry, {"revived": dead_gb.sum()}


def fetch_analyze(ctx: StageContext, state: CrawlState, carry: StepCarry
                  ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """Document loader (simulated fetch) + page analyzer: recover each
    fetched page's true domain and split own- vs foreign-partition
    fetches."""
    true_dom = CLS.page_domain(carry.urls, ctx.cfg)
    own, foreign = ctx.policy.split_ownership(ctx.cfg, state, true_dom,
                                              carry.sel)
    delta = {"fetched": carry.sel.sum(), "fetch_own": own.sum(),
             "fetch_foreign": foreign.sum()}
    return state, carry._replace(true_dom=true_dom), delta


def extract_stage(ctx: StageContext, state: CrawlState, carry: StepCarry
                  ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """Parser + URL database: extract outlinks, canonicalize (C2),
    exact-dedup the batch, and append to the staging buffer."""
    cfg, S = ctx.cfg, ctx.S
    links = W.outlinks(carry.urls, cfg, ctx.cumw)         # (r, k, O)
    flat_u = links.reshape(-1)
    lmask = carry.sel[..., None].expand(links.shape).reshape(-1)
    flat_s = carry.true_dom[..., None].expand(links.shape).reshape(-1)
    discovered = lmask.sum()

    if ctx.policy.canonicalize:
        flat_u = W.canonical(flat_u, cfg)
    flat_m = DD.exact_dedup(flat_u[None], lmask[None])[0]
    dedup_exact = discovered - flat_m.sum()

    # stage into the URL database (the batched exchange buffer)
    n0 = state.staging_n[0].to(torch.int64)         # a copy, not a view
    pos = n0 + torch.cumsum(flat_m.to(torch.int64), dim=0) - 1
    fits = flat_m & (pos < S)
    p = pos[fits]
    state.staging_url[0, p] = flat_u[fits]
    state.staging_src[0, p] = flat_s[fits].to(torch.int32)
    state.staging_n[0] = n0 + fits.sum().to(torch.int32)
    delta = {"discovered": discovered, "dedup_exact": dedup_exact,
             "staging_drop": (flat_m & ~fits).sum()}
    return state, carry, delta


def dispatch_exchange(ctx: StageContext, state: CrawlState, carry: StepCarry
                      ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """URL dispatcher (C5): predict each staged URL's owner, ship it through
    the exchange, dedup what arrived (exact, then the Bloom kernel), and
    insert the survivors into the local frontier rows."""
    cfg, S, n_shards, shard = ctx.cfg, ctx.S, ctx.n_shards, ctx.shard
    u, src = state.staging_url[0], state.staging_src[0]
    r_slots = state.slot_domain.shape[0]

    staged = torch.arange(S, device=u.device) < state.staging_n[0]
    # a dead process sends nothing
    valid = staged & state.shard_alive[shard]
    pred = CLS.predict_domain(u, src, cfg, step=state.step,
                              accuracy=ctx.classify_accuracy)
    dest = ctx.policy.route(cfg, state, n_shards, u, pred, state.step)
    plan = ctx.coord.plan(ctx, state, shard, u, src, state.staging_val[0],
                          dest, staged, valid)
    delta = {"dispatch_sent": plan.ship.sum(),
             "dispatch_rounds": 1,
             "coord_dropped": plan.drop.sum()}

    # the payload lanes: url, predicted domain, shipped flag (no value
    # lane: no ported ordering carries values)
    payload = torch.stack([u, pred, plan.ship.to(torch.int64)], dim=-1)
    buckets, _, dropped = RT.pack_buckets(payload, dest, n_shards,
                                          ctx.cap_ex, valid=plan.ship)
    delta["staging_drop"] = dropped
    recv = RT.exchange(buckets[None])[0]           # (n_shards, cap_ex, 3)
    r_u = recv[..., 0].reshape(-1)
    r_pred = recv[..., 1].reshape(-1)
    r_has = recv[..., 2].reshape(-1) > 0

    delta["dispatch_recv"] = r_has.sum()
    r_m = DD.exact_dedup(r_u[None], r_has[None])[0]
    delta["dedup_exact"] = delta["dispatch_recv"] - r_m.sum()

    row, ok = ctx.policy.local_row(cfg, state, shard, r_slots, r_u, r_pred)
    r_m = r_m & ok
    M = min(r_u.shape[0], cfg.frontier_capacity)

    # bucket per local row, Bloom-dedup, insert into the frontier
    rbp, rbmask, rdrop = RT.pack_buckets(r_u[:, None], row, r_slots, M,
                                         valid=r_m)
    rb = rbp[..., 0].contiguous()                  # (r_slots, M)
    delta["frontier_drop"] = rdrop
    bloom = DD.Bloom(state.bloom_bits, cfg.bloom_bits_log2)
    seen, _ = DD.probe_insert(bloom, rb, rbmask, k=cfg.bloom_hashes)
    fresh = rbmask & ~seen
    delta["dedup_bloom"] = (rbmask & seen).sum()
    fr = F.insert(frontier_view(state), rb, ctx.score_fn(rb, cfg, state),
                  fresh, n_buckets=cfg.n_priority_buckets)

    for t in (state.staging_url, state.staging_src, state.staging_n):
        t.zero_()
    return with_frontier(state, fr), carry, delta


def assemble_pipeline(ctx: StageContext,
                      extra_stages: Sequence[Stage] = ()
                      ) -> Tuple[Stage, ...]:
    """allocate -> fetch_analyze -> [ordering update] -> extract. Scenario
    stages (politeness, revisit) are not ported yet."""
    if extra_stages:
        raise NotImplementedError(
            "extra_stages are not ported yet (ROADMAP Queue 1: the scenario "
            "stages make_politeness_stage / make_revisit_stage)")
    upd = ctx.ordering.update_stage
    return tuple([allocate, fetch_analyze, *([] if upd is None else [upd]),
                  extract_stage])

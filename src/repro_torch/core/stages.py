"""The staged crawl pipeline — WebParF's Phase II step as composable stages.
Counterpart of ``repro/core/stages.py``.

    allocate -> fetch_analyze -> [ordering update] -> extract_stage
             [-> dispatch_exchange]

Every stage has the signature ``stage(ctx, state, carry) -> (state, carry,
StatsDelta)``. The frontier pop runs through the ``frontier_select`` kernel
and the Bloom dedup through the ``bloom`` kernel (their plain versions when
the state lies on the CPU). The state's tensors are updated in place where
the JAX stages returned new arrays, so a stage's input state is consumed.

Stateful orderings (``opic``, ``opic_url``) run the OPIC value channel: a
per-outlink value (``StepCarry.link_cash``) is staged in ``staging_val``,
rides the dispatch payload's fourth lane as the f32's bits, and is
delivered to its row's slot cash (``opic``) or into the frontier cell its
URL wins (``opic_url``, the url lane ``order_state[:, 2:]``); whatever is
dropped on the way refunds to a slot's cash. Every f32 scatter-add with
possible duplicate targets goes through the ``opic_update`` kernel (item
order on every device), every f32 row sum through ``kernels.rowsum``. The
url lane's pop uses ``select_harvest`` and its fused dispatch
``dedup_deposit`` (``cfg.fused_dispatch``, the default). Stateless
orderings carry zeros through the channel in the JAX package; here they
skip it, which leaves ``order_state`` and ``staging_val`` at the same zeros.

Scores are computed from the slot columns of ``order_state`` as they were
when the stage began, as in the JAX stages; a stage that changes slot cash
works on a copy of column 0 and writes it back at its end.

The shards are batched along the leading axis. The mesh's shard axis of
the JAX package becomes the state's own layout: row-indexed leaves hold
every shard's rows (shard s owns rows [s * r, (s + 1) * r)) and
shard-indexed leaves one row per shard. Every stage runs once for all
shards: a kernel sees all the process's rows (the spend scatter all its
shards' rows) in one launch, per-shard work (the fetch budget, exact
dedup, staging, the exchange's buckets) runs along a leading shard axis,
and ``lax.axis_index`` becomes the shard vector ``StageContext.shard``.
Stat deltas are (n_local,) vectors, or scalars that every shard adds.

Under a crawl group of W processes (``repro_torch.dist.CrawlGroup``, one a
card) the state is this rank's share: its L = N / W shards' rows and
shard rows (``state_specs`` says which leaves split and which every rank
copies). ``StageContext.n_shards`` stays the global N, which routing and
the exchange's bucket size read; ``n_local`` and ``shard0`` are the
rank's own, and every shard id is global. The exchange is
``core/router.exchange`` over the group (an ``all_to_all``; at W = 1 the
one-card transpose).

Coordination is the fourth registry (``repro_torch/coordination``):
``ctx.coord`` decides what ``dispatch_exchange`` does with each staged
URL — ship it (``exchange``), keep or drop it locally without the
exchange (``crossover``, ``firewall``), or ship a bounded top-k and park
the rest in ``CrawlState.outbox_*`` (``batched``). The stage runs only the
machinery the mode's flags ask for. Scenario stages (politeness, revisit)
slot into the pipeline by their ``placement``; ``ledger_view`` names what
the telemetry ledger may read. Any partitioning policy, ordering,
coordination mode and shard count that divides the domains and slots is
covered; ``check_supported`` refuses the rest.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import CrawlConfig
from repro_torch.coordination import get_coordination
from repro_torch.coordination import outbox as OB
from repro_torch.core import classifier as CLS
from repro_torch.core import dedup as DD
from repro_torch.core import freshness as FR
from repro_torch.core import frontier as F
from repro_torch.core import partitioner as PT
from repro_torch.core import router as RT
from repro_torch.core import webgraph as W
from repro_torch.device import resolve_device
from repro_torch.dist import CrawlGroup
from repro_torch.kernels.dedup_deposit.ops import dedup_deposit
from repro_torch.kernels.dedup_deposit.ref import first_twin, sorted_queue
from repro_torch.kernels.opic_update.ops import (scatter_cash,
                                                 scatter_cash_cells)
from repro_torch.kernels.rowsum import row_sum
from repro_torch.ordering.policies import (ORD_URL0, as_score_fn,
                                           get_ordering)

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
    # row-indexed (n_slots, ...): under a crawl group, the rank's own rows
    # (n_local * r, ...), and shard-indexed leaves its own shards' rows
    f_url: torch.Tensor          # int64 holding uint32 URL ids
    f_pri: torch.Tensor
    f_valid: torch.Tensor
    f_arrival: torch.Tensor
    f_dropped: torch.Tensor
    f_inserted: torch.Tensor
    f_rebased: torch.Tensor
    bloom_bits: torch.Tensor     # (n_slots, 2^b) uint8, updated in place
    slot_domain: torch.Tensor
    order_state: torch.Tensor    # (n_slots, ORD_WIDTH[+C]) f32 ordering
                                 # state (OPIC: [:, 0] slot cash, [:, 1]
                                 # history, [:, 2:] the url lane; zeros for
                                 # stateless orderings)
    # shard-indexed (n_shards, ...)
    staging_url: torch.Tensor    # (n_shards, S) int64 holding uint32
    staging_src: torch.Tensor    # (n_shards, S) int32 source-page domain
    staging_val: torch.Tensor    # (n_shards, S) f32 piggybacked URL values
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
    n_shards: int                # N, every process's shards together
    shard: torch.Tensor          # (n_local * r,) int64: the global shard
                                 # of each of this process's rows
    score_fn: Callable           # (urls, cfg, state, val=None) -> [0, 1)
    classify_accuracy: float
    cumw: torch.Tensor           # static Zipf cumulative weights
    k_row: int                   # URLs popped per domain row per step
    S: int                       # staging (dispatch buffer) capacity
    cap_ex: int                  # per-destination exchange bucket size
    policy: PT.PartitionPolicy   # resolved from cfg.partitioning
    ordering: object             # resolved from cfg.ordering
    coord: object                # resolved from cfg.coordination
    url_lane: bool = False       # the ordering keeps a cell-aligned
                                 # per-URL value lane in order_state[:, 2:]
    n_local: int = 0             # L, the shards this process owns
    shard0: int = 0              # the first of them (a global id)
    group: CrawlGroup = CrawlGroup()


class StepCarry(NamedTuple):
    """Intra-step dataflow between stages (every shard's rows)."""
    shard: torch.Tensor          # (n_slots,) the shard of each row
    alive: torch.Tensor          # (n_slots,) bool: the row's shard is alive
    urls: torch.Tensor           # (r, k) URLs popped this step (0 if masked)
    sel: torch.Tensor            # (r, k) actually-fetched mask
    true_dom: torch.Tensor       # (r, k) analyzer's domain
    link_cash: Optional[torch.Tensor] = None
                                 # (r, k, O) per-outlink value to piggyback
                                 # on dispatch (an ordering's update stage
                                 # fills it; None stages zeros)
    links: Optional[torch.Tensor] = None
                                 # (r, k, O) outlink parse cached by an
                                 # ordering's update stage
    url_cash: Optional[torch.Tensor] = None
                                 # (r, k) cash harvested from the popped
                                 # cells (url-lane orderings only)


class FetchReport(NamedTuple):
    """Per-step observables (host-side analysis)."""
    fetched_urls: torch.Tensor   # (n_slots, k_row) int64 (0 = none)
    fetched_mask: torch.Tensor   # (n_slots, k_row) bool


Stage = Callable[[StageContext, CrawlState, Optional[StepCarry]],
                 Tuple[CrawlState, StepCarry, StatsDelta]]


def check_supported(cfg: CrawlConfig, n_shards: int) -> None:
    """Refuse what the port cannot run: unknown ordering or coordination
    names, a shard count that does not divide the domains and slots, a
    crawl group whose size does not divide the shards, and a kernel knob
    other than ``auto``."""
    get_ordering(cfg.ordering)            # unknown names raise
    get_coordination(cfg.coordination)
    if n_shards < 1 or cfg.n_domains % n_shards or cfg.n_slots % n_shards:
        raise ValueError(f"{cfg.n_domains} domains / {cfg.n_slots} slots do "
                         f"not split over {n_shards} shards")
    CrawlGroup.current().split(n_shards)               # raises ValueError
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


def ledger_view(state: CrawlState) -> Dict[str, object]:
    """What the telemetry ledger (``repro_torch/obs/ledger.py``) may read,
    named by role: every shard's rows at once, read only. This module owns
    the CrawlState layout, so a layout change updates this one mapping."""
    return dict(
        frontier=frontier_view(state),      # (n_slots, C) every shard's rows
        stats=state.stats,                  # (n_shards, NSTAT) counters
        staging_n=state.staging_n,          # (n_shards,) outbound backlog
        staging_val=state.staging_val,      # (n_shards, S) in-transit cash
        outbox_n=state.outbox_n,            # (n_shards,) parked backlog
        outbox_val=state.outbox_val,        # (n_shards, B) parked cash
        order_state=state.order_state,      # (n_slots, ORD_WIDTH[+C])
        shard_alive=state.shard_alive,      # (n_shards,)
        step=state.step,                    # ()
    )


def add_to_rows(slot_cash: torch.Tensor, rows: torch.Tensor,
                vals: torch.Tensor, mask: torch.Tensor, n_shards: int
                ) -> None:
    """slot_cash (n_shards * r,) += the masked values at their rows, in
    item order (the ``opic_update`` kernel, one launch for all shards); the
    JAX stages' ``.at[...].add`` with masked items dropped. rows/vals/mask
    hold each shard's items along a leading axis (n_shards, ...), and a
    row is local to its shard, so a shard's items reach only its own rows.
    ``n_shards`` counts the shards ``slot_cash`` holds (a process's own)."""
    scatter_cash(slot_cash.view(n_shards, -1),
                 rows.reshape(n_shards, -1).to(torch.int64).contiguous(),
                 vals.reshape(n_shards, -1).contiguous(),
                 mask.reshape(n_shards, -1).contiguous())


def per_shard(ctx: StageContext, x: torch.Tensor) -> torch.Tensor:
    """Count a row-indexed mask (n_local * r, ...) per shard: (n_local,)."""
    return x.reshape(ctx.n_local, -1).sum(1)


def apply_delta(state: CrawlState, delta: StatsDelta) -> CrawlState:
    """Fold a stage's stat increments into the stats rows: an (n_local,)
    vector adds per shard, a scalar to every shard."""
    for name, val in delta.items():
        state.stats[:, SIDX[name]] += torch.as_tensor(
            val, device=state.stats.device).to(torch.int32)
    return state


def init_state(cfg: CrawlConfig, n_shards: int, device) -> CrawlState:
    """The initial crawl state of ``n_shards`` shards on ``device``
    (``None`` means cuda; a CUDA request without a card raises): under a
    crawl group, this rank's share of it (``state_specs``), whose rows
    equal the one-process state's bit for bit. The seeds are registered
    in the Bloom filters through the ``bloom`` kernel."""
    check_supported(cfg, n_shards)
    dev = resolve_device(device)
    group = CrawlGroup.current()
    n_local, _ = group.split(n_shards)
    f = PT.seed_frontier(cfg, n_shards, dev)
    dm = PT.identity_map(cfg, n_shards, dev)
    bloom = DD.init_bloom(f.url.shape[0], cfg.bloom_bits_log2, dev)
    DD.probe_insert(bloom, f.url, f.valid, k=cfg.bloom_hashes)
    S = cfg.dispatch_capacity

    def zeros(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    order = get_ordering(cfg.ordering).init_state(cfg, n_shards, dev)
    return CrawlState(
        f_url=f.url, f_pri=f.priority, f_valid=f.valid, f_arrival=f.arrival,
        f_dropped=f.n_dropped, f_inserted=f.n_inserted, f_rebased=f.n_rebased,
        bloom_bits=bloom.bits,
        slot_domain=group.local(dm.domain_of_slot, n_shards),
        order_state=group.local(order, n_shards),
        staging_url=zeros((n_local, S), torch.int64),
        staging_src=zeros((n_local, S), torch.int32),
        staging_val=zeros((n_local, S), torch.float32),
        staging_n=zeros((n_local,), torch.int32),
        **OB.init_outbox(cfg, n_local, dev),
        stats=zeros((n_local, NSTAT), torch.int32),
        slot_of_domain=dm.slot_of_domain, shard_alive=dm.shard_alive,
        step=zeros((), torch.int32))


def state_specs(axes="data") -> CrawlState:
    """Which leaves a crawl group splits: ``axes`` (the mesh axis the
    shards lie on) for a leaf cut along its leading axis, row-indexed
    leaves by their shard's rows and shard-indexed leaves by shard; None
    for a leaf every rank holds whole (the reference's ``P()``):
    ``slot_of_domain``, ``shard_alive`` and ``step``. ``local_state`` and
    ``join_state`` apply it."""
    return CrawlState(**{
        name: None if name in ("slot_of_domain", "shard_alive", "step")
        else axes for name in CrawlState._fields})


def local_state(arrays: Dict[str, object],
                n_shards: int) -> Dict[str, object]:
    """This rank's share of a whole state's leaves (tensors or numpy
    arrays keyed by field name, e.g. a checkpoint's), cut by
    ``state_specs``: every rank restores any checkpoint of ``n_shards``
    shards, whatever the world that wrote it."""
    group = CrawlGroup.current()
    specs = state_specs()
    return {name: arrays[name] if getattr(specs, name) is None
            else group.local(arrays[name], n_shards)
            for name in CrawlState._fields}


def join_state(state: CrawlState) -> CrawlState:
    """The whole state on every rank: each split leaf gathered from every
    rank in shard order (``state_specs``); the copied leaves as they
    are. The one-process state is its own whole."""
    group = CrawlGroup.current()
    specs = state_specs()
    return CrawlState(**{
        name: getattr(state, name) if getattr(specs, name) is None
        else group.gather(getattr(state, name))
        for name in CrawlState._fields})


def make_context(cfg: CrawlConfig, *, n_shards: int, device,
                 score_fn: Optional[Callable] = None,
                 classify_accuracy: float) -> StageContext:
    """The static inputs of the stages of this process's shards of
    ``n_shards`` (all of them without a crawl group). A ``score_fn``
    override (stateless ``(urls, cfg)``, e.g. a learned scorer) wins over
    the registry; by default ``cfg.ordering`` names the scorer."""
    check_supported(cfg, n_shards)
    dev = resolve_device(device)
    group = CrawlGroup.current()
    r_local = cfg.n_slots // n_shards          # rows a shard owns
    n_local, shard0 = group.split(n_shards)
    S = cfg.dispatch_capacity
    ordering = get_ordering(cfg.ordering)
    shard = PT.shard_of_slot(
        torch.arange(shard0 * r_local, (shard0 + n_local) * r_local,
                     device=dev), cfg.n_slots, n_shards)
    score = (as_score_fn(score_fn) if score_fn is not None else
             ordering.make_score_fn(cfg, n_shards=n_shards, shard=shard))
    return StageContext(
        cfg=cfg, n_shards=n_shards, shard=shard, score_fn=score,
        classify_accuracy=classify_accuracy,
        cumw=W.zipf_cumweights(cfg, dev),
        k_row=max(1, cfg.fetch_batch // r_local), S=S,
        cap_ex=max(8, -(-S // n_shards) * 2),
        policy=PT.get_policy(cfg.partitioning), ordering=ordering,
        coord=get_coordination(cfg.coordination), url_lane=ordering.url_lane,
        n_local=n_local, shard0=shard0, group=group)


# ---------------------------------------------------------------------------
# the four core stages
# ---------------------------------------------------------------------------

def allocate(ctx: StageContext, state: CrawlState,
             carry: Optional[StepCarry] = None
             ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """URL allocator: pop the top-k of each domain queue, then enforce each
    shard's fetch budget over its own rows; candidates beyond it go back to
    their queues, and a dead shard gives back all its pops. On the url lane
    each pop harvests its cell's cash, and a give-back re-deposits it."""
    cfg, n = ctx.cfg, ctx.n_local
    alive = state.shard_alive[ctx.shard]                 # (n_local * r,)
    fr = frontier_view(state)
    url_cash = slot_cash = None
    if ctx.url_lane:
        table = state.order_state[:, ORD_URL0:]          # a strided view
        slot_cash = state.order_state[:, 0].clone()
    if ctx.url_lane and cfg.fused_dispatch:
        # one select_harvest launch pops, reads the popped cells' cash and
        # zeroes them (invalid cells already hold exactly 0)
        urls, pri, pre_sel, fr, _, url_cash = F.select_harvest(
            fr, table, ctx.k_row)
    elif ctx.url_lane:
        urls, pri, pre_sel, fr, idx = F.select(fr, ctx.k_row,
                                               return_idx=True)
        url_cash = torch.where(pre_sel, torch.gather(table, 1, idx),
                               torch.zeros_like(pri))
        table.masked_fill_(~fr.valid, 0.0)
    else:
        urls, pri, pre_sel, fr = F.select(fr, ctx.k_row)

    def give_back(fr, url_cash, mask):
        """Return popped URLs (and, on the url lane, their cash) to the
        frontier; insert overflow refunds to the row's slot cash."""
        if not ctx.url_lane:
            fr = F.insert(fr, urls, ctx.score_fn(urls, cfg, state), mask,
                          n_buckets=cfg.n_priority_buckets)
            return fr, url_cash
        scores = ctx.score_fn(urls, cfg, state, val=url_cash)
        zero = torch.zeros_like(url_cash)
        fr, _, refund = F.insert_valued(
            fr, table, urls, scores, mask, torch.where(mask, url_cash, zero),
            n_buckets=cfg.n_priority_buckets)
        slot_cash.add_(refund)
        return fr, torch.where(mask, zero, url_cash)

    if urls.shape[0] // n * ctx.k_row > cfg.fetch_batch:
        # each shard's budget over its own r_local * k_row pops
        flat_pri = torch.where(pre_sel, pri,
                               torch.full_like(pri, F.NEG)).reshape(n, -1)
        kth = torch.sort(flat_pri, dim=1,
                         descending=True).values[:, cfg.fetch_batch - 1]
        budget = (flat_pri >= kth[:, None]).reshape(pre_sel.shape)
        # ties at the threshold may pass a few URLs over the budget
        fr, url_cash = give_back(fr, url_cash, pre_sel & ~budget)
        pre_sel = pre_sel & budget
    sel = pre_sel & alive[:, None]
    dead_gb = pre_sel & ~alive[:, None]
    fr, url_cash = give_back(fr, url_cash, dead_gb)
    if ctx.url_lane:
        state.order_state[:, 0] = slot_cash
    carry = StepCarry(
        shard=ctx.shard, alive=alive, urls=urls, sel=sel,
        true_dom=torch.zeros(urls.shape, dtype=torch.int64,
                             device=urls.device), url_cash=url_cash)
    return with_frontier(state, fr), carry, {"revived": per_shard(ctx,
                                                                 dead_gb)}


def fetch_analyze(ctx: StageContext, state: CrawlState, carry: StepCarry
                  ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """Document loader (simulated fetch) + page analyzer: recover each
    fetched page's true domain and split own- vs foreign-partition
    fetches."""
    true_dom = CLS.page_domain(carry.urls, ctx.cfg)
    own, foreign = ctx.policy.split_ownership(ctx.cfg, state, true_dom,
                                              carry.sel)
    delta = {"fetched": per_shard(ctx, carry.sel),
             "fetch_own": per_shard(ctx, own),
             "fetch_foreign": per_shard(ctx, foreign)}
    return state, carry._replace(true_dom=true_dom), delta


def extract_stage(ctx: StageContext, state: CrawlState, carry: StepCarry
                  ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """Parser + URL database: extract outlinks, canonicalize (C2),
    exact-dedup each shard's batch, and append it to that shard's staging
    buffer. On the value channel each link's value is staged beside it,
    and the value of a link dropped here (batch dedup, staging overflow)
    refunds to its source row's slot cash."""
    cfg, S, n = ctx.cfg, ctx.S, ctx.n_local
    links = (W.outlinks(carry.urls, cfg, ctx.cumw) if carry.links is None
             else carry.links)                                # (R, k, O)
    # each shard's links in its rows' order: (n_local, r_local * k * O)
    flat_u = links.reshape(n, -1)
    lmask = carry.sel[..., None].expand(links.shape).reshape(n, -1)
    flat_s = carry.true_dom[..., None].expand(links.shape).reshape(n, -1)
    discovered = lmask.sum(1)

    if ctx.policy.canonicalize:
        flat_u = W.canonical(flat_u, cfg)
    flat_m = DD.exact_dedup(flat_u, lmask)
    dedup_exact = discovered - flat_m.sum(1)

    # stage into each shard's URL database (the batched exchange buffer)
    n0 = state.staging_n.to(torch.int64)            # a copy, not a view
    pos = n0[:, None] + torch.cumsum(flat_m.to(torch.int64), dim=1) - 1
    fits = flat_m & (pos < S)
    item = fits.nonzero(as_tuple=True)              # (shard, link) pairs
    p = (item[0], pos[item])
    state.staging_url[p] = flat_u[item]
    state.staging_src[p] = flat_s[item].to(torch.int32)
    if carry.link_cash is not None:
        flat_v = carry.link_cash.reshape(n, -1)
        state.staging_val[p] = flat_v[item]
        # refund what was lost here to the source row's slot cash
        r_local = links.shape[0] // n
        flat_r = (torch.arange(links.shape[0], device=links.device)
                  % r_local)[:, None, None].expand(links.shape)
        slot_cash = state.order_state[:, 0].clone()
        add_to_rows(slot_cash, flat_r, flat_v, lmask & ~fits, n)
        state.order_state[:, 0] = slot_cash
    state.staging_n.copy_(n0 + fits.sum(1))
    delta = {"discovered": discovered, "dedup_exact": dedup_exact,
             "staging_drop": (flat_m & ~fits).sum(1)}
    return state, carry, delta


def _f32_bits(val: torch.Tensor) -> torch.Tensor:
    """An f32 tensor's bits as an int64 payload lane (bit-exact round
    trip through ``_from_bits``)."""
    return val.contiguous().view(torch.int32).to(torch.int64)


def _from_bits(lane: torch.Tensor) -> torch.Tensor:
    return lane.to(torch.int32).view(torch.float32)


def _entry_scores(ctx: StageContext, state: CrawlState, rb: torch.Tensor,
                  rbf: Optional[torch.Tensor],
                  val: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Entry scores of received URLs about to enter the frontier.
    ``rbf`` marks crossover's kept-foreign URLs, which enter at the lowest
    priority bucket (fetched once the local queue runs dry)."""
    scores = (ctx.score_fn(rb, ctx.cfg, state, val=val) if val is not None
              else ctx.score_fn(rb, ctx.cfg, state))
    if rbf is not None:
        scores = torch.where(rbf, torch.zeros_like(scores), scores)
    return scores


def dispatch_exchange(ctx: StageContext, state: CrawlState, carry: StepCarry
                      ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
    """URL dispatcher (C5): predict each staged URL's owner, let the
    coordination mode (``ctx.coord``) give every candidate a fate — ship
    it through the exchange, keep it locally, park it in the outbox, or
    drop it — then dedup what arrived (exact, then the Bloom filter) and
    insert the survivors into the receiving shard's frontier rows. Every
    source shard packs its own buckets, the exchange transposes them, and
    every receiving shard buckets its arrivals per row: one (n_slots, M)
    batch for the Bloom kernels. A mode that does not communicate skips
    the exchange: what it keeps is its "received" set, bucketed per row
    on its own shard. On the value channel every staged value is
    delivered, parked or refunded: to the receiving row's slot cash
    (``opic``), or into the cell its URL wins or its queued twin holds
    (``opic_url``)."""
    cfg, S, n, nl = ctx.cfg, ctx.S, ctx.n_shards, ctx.n_local
    coord = ctx.coord
    valued = ctx.ordering.stateful
    u, src, val = state.staging_url, state.staging_src, state.staging_val
    r_slots = cfg.n_slots // n                     # rows a shard owns
    n_rows = nl * r_slots                          # this process's rows
    # each item's shard, a global id
    sid = torch.arange(ctx.shard0, ctx.shard0 + nl, device=u.device)[:, None]

    # the candidate pool: the staging batch, after the parked outbox for
    # modes that carry one (retries first)
    staged = torch.arange(S, device=u.device)[None] < state.staging_n[:, None]
    if coord.uses_outbox:
        u, src, val, staged, _ = OB.merge_pool(state, u, src, val, staged)
    # a dead process sends nothing (the batched mode still parks)
    valid = staged & state.shard_alive[ctx.shard0:ctx.shard0 + nl, None]
    pred = CLS.predict_domain(u, src, cfg, step=state.step,
                              accuracy=ctx.classify_accuracy)
    # outbox retries route through the live domain map
    dest = ctx.policy.route(cfg, state, n, u, pred, state.step)
    plan = coord.plan(ctx, state, sid, u, src, val, dest, staged, valid)
    delta = {"dispatch_sent": plan.ship.sum(1),
             "dispatch_rounds": 1,
             "coord_dropped": plan.drop.sum(1)}

    outbox = {}
    if coord.uses_outbox:
        outbox, parked_ok = OB.park(u, src, val, plan.defer,
                                    OB.outbox_capacity(cfg))
        delta["coord_deferred"] = parked_ok.sum(1)
        delta["coord_dropped"] = (delta["coord_dropped"]
                                  + (plan.defer & ~parked_ok).sum(1))

    r_foreign = None
    if coord.communicates:
        # the payload lanes: url, predicted domain, shipped flag [, the
        # value's f32 bits]; buckets (n_src, n_dest, cap_ex, L)
        lanes = [u, pred, plan.ship.to(torch.int64)]
        if valued:
            lanes.append(_f32_bits(val))
        buckets, _, dropped, sent = RT.pack_buckets(
            torch.stack(lanes, dim=-1), dest, n, ctx.cap_ex,
            valid=plan.ship, return_keep=True)
        delta["staging_drop"] = dropped
        # shard j receives every source's bucket j, in source order: the
        # crawl group's all_to_all (a transpose within one process)
        recv = RT.exchange(buckets, ctx.group).reshape(nl, -1, len(lanes))
        r_u = recv[..., 0]
        r_pred = recv[..., 1]
        r_has = recv[..., 2] > 0
        if valued:
            r_val = _from_bits(recv[..., 3])
    else:
        # no communication: the "received" set is the kept slice of each
        # shard's own pool
        sent = torch.zeros_like(staged)
        zero = torch.zeros_like(u)
        r_u = torch.where(plan.keep, u, zero)
        r_pred = torch.where(plan.keep, pred, zero)
        r_has = plan.keep
        if valued:
            r_val = torch.where(plan.keep, val, torch.zeros_like(val))
        if coord.keeps_foreign:
            r_foreign = plan.foreign

    if valued:
        # the sender half: a staged value neither sent (dead shard, bucket
        # overflow), kept nor parked refunds to the source page's own row,
        # clamped into the sending shard's rows (firewall's drops too)
        slot_cash = state.order_state[:, 0].clone()
        own_slot = state.slot_of_domain.to(torch.int64)[
            torch.clamp(src.to(torch.int64), 0, cfg.n_domains - 1)]
        own_row = torch.clamp(own_slot - sid * r_slots, 0, r_slots - 1)
        leftover = staged & ~sent & ~plan.keep
        if coord.uses_outbox:
            leftover = leftover & ~parked_ok
        add_to_rows(slot_cash, own_row, val, leftover, nl)

    delta["dispatch_recv"] = r_has.sum(1)
    r_m = DD.exact_dedup(r_u, r_has)
    delta["dedup_exact"] = delta["dispatch_recv"] - r_m.sum(1)

    # from here on sid is each received item's (receiving) shard
    row, ok = ctx.policy.local_row(cfg, state, sid, r_slots, r_u, r_pred)
    if r_foreign is not None:
        # crossover: a kept-foreign URL has no owner row here; it is queued
        # in a hashed local row instead
        hrow = W.hash2(r_u, 63) % r_slots
        row = torch.where(r_foreign & ~ok, hrow, row)
        ok = ok | (r_foreign & r_has)
    r_m = r_m & ok
    M = min(r_u.shape[1], cfg.frontier_capacity)

    # bucket per local row, Bloom-dedup, insert into the frontier; the
    # foreign flag rides as a lane of its own
    extra = [] if r_foreign is None else [r_foreign.to(torch.int64)]
    if ctx.url_lane:
        # the value travels through the per-row bucketing to the cell its
        # URL wins; items that never reach a bucket (exact dup, unowned,
        # overflow) refund to the receiving row here
        rbp, rbmask, rdrop, rkeep = RT.pack_buckets(
            torch.stack([r_u, _f32_bits(r_val), *extra], dim=-1), row,
            r_slots, M, valid=r_m, return_keep=True)
        rv = _from_bits(rbp[..., 1]).reshape(n_rows, M)
        add_to_rows(slot_cash, row, r_val, r_has & ~rkeep, nl)
    else:
        if valued:
            # the receiver half: every received value goes to its row
            # before dedup
            add_to_rows(slot_cash, row, r_val, r_has, nl)
        payload = (r_u[..., None] if not extra
                   else torch.stack([r_u, *extra], dim=-1))
        rbp, rbmask, rdrop = RT.pack_buckets(payload, row, r_slots, M,
                                             valid=r_m)
    # (n_local, r_slots, M) -> one row-aligned (n_rows, M) batch
    rb = rbp[..., 0].reshape(n_rows, M).contiguous()
    rbf = None if r_foreign is None else \
        (rbp[..., -1] > 0).reshape(n_rows, M)
    rbmask = rbmask.reshape(n_rows, M)
    delta["frontier_drop"] = rdrop

    fr = frontier_view(state)
    if ctx.url_lane:
        table = state.order_state[:, ORD_URL0:]
        if cfg.fused_dispatch:
            # one dedup_deposit pass: Bloom probe and insert, queued-twin
            # match, twin deposit and no-twin refund; fresh URLs enter at
            # placeholder priorities, and the rescore below is the only
            # scoring pass (it subsumes crossover's lowest-bucket entry)
            seen, dup_refund = dedup_deposit(
                state.bloom_bits, rb, rbmask, rv, fr.url, fr.valid, table,
                k=cfg.bloom_hashes)
            fresh = rbmask & ~seen
            fr, _, ins_refund = F.place_valued(
                fr, table, rb, fresh, torch.where(fresh, rv,
                                                  torch.zeros_like(rv)))
        else:
            bloom = DD.Bloom(state.bloom_bits, cfg.bloom_bits_log2)
            seen, _ = DD.probe_insert(bloom, rb, rbmask, k=cfg.bloom_hashes)
            fresh = rbmask & ~seen
            # a Bloom-dup'd arrival whose URL is still queued in the row
            # adds its cash to that cell; one with no queued twin refunds
            dupm = rbmask & seen
            hit, cell = first_twin(rb, dupm, sorted_queue(fr.url, fr.valid))
            scatter_cash_cells(table, None, cell, rv, hit)
            dup_refund = row_sum(torch.where(dupm & ~hit, rv,
                                             torch.zeros_like(rv)))
            fr, _, ins_refund = F.insert_valued(
                fr, table, rb, _entry_scores(ctx, state, rb, rbf, val=rv),
                fresh, torch.where(fresh, rv, torch.zeros_like(rv)),
                n_buckets=cfg.n_priority_buckets)
        delta["dedup_bloom"] = per_shard(ctx, rbmask & seen)
        slot_cash.add_(dup_refund + ins_refund)
        # re-bucket the whole queue from the cells' current cash
        fr = F.rescore(fr, ctx.score_fn(fr.url, cfg, state, val=table),
                       n_buckets=cfg.n_priority_buckets)
    else:
        bloom = DD.Bloom(state.bloom_bits, cfg.bloom_bits_log2)
        seen, _ = DD.probe_insert(bloom, rb, rbmask, k=cfg.bloom_hashes)
        fresh = rbmask & ~seen
        delta["dedup_bloom"] = per_shard(ctx, rbmask & seen)
        fr = F.insert(fr, rb, _entry_scores(ctx, state, rb, rbf), fresh,
                      n_buckets=cfg.n_priority_buckets)

    if valued:
        state.order_state[:, 0] = slot_cash
    for t in (state.staging_url, state.staging_src, state.staging_val,
              state.staging_n):
        t.zero_()
    for name, leaf in outbox.items():
        getattr(state, name).copy_(leaf)
    return with_frontier(state, fr), carry, delta


DEFAULT_PIPELINE: Tuple[Stage, ...] = (allocate, fetch_analyze, extract_stage)


def assemble_pipeline(ctx: StageContext,
                      extra_stages: Sequence[Stage] = ()
                      ) -> Tuple[Stage, ...]:
    """Compose the step around the core stages:

        allocate -> [post_allocate extras] -> fetch_analyze
                 -> [post_fetch extras] -> [ordering update] -> extract

    ``extra_stages`` slot in by their ``placement`` attribute
    (``"post_allocate"`` or the default ``"post_fetch"``) in the given
    order; the ordering's update stage runs last before extract."""
    post_alloc = [s for s in extra_stages
                  if getattr(s, "placement", "post_fetch") == "post_allocate"]
    post_fetch = [s for s in extra_stages
                  if getattr(s, "placement", "post_fetch") != "post_allocate"]
    upd = ctx.ordering.update_stage
    return tuple([allocate, *post_alloc, fetch_analyze, *post_fetch,
                  *([] if upd is None else [upd]), extract_stage])


# ---------------------------------------------------------------------------
# scenario stages — insertable without touching the core four
# ---------------------------------------------------------------------------

def make_politeness_stage(max_per_row: int) -> Stage:
    """Per-domain politeness budget: at most ``max_per_row`` fetches per
    domain queue per step; the overflow re-enters the frontier at its
    score (a per-host rate limit, placed after ``allocate``). On the url
    lane a deferred URL takes its cash back into its new cell, and what
    does not fit refunds to the row's slot cash."""

    def politeness(ctx: StageContext, state: CrawlState, carry: StepCarry
                   ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
        order = torch.cumsum(carry.sel.to(torch.int32), dim=1) - 1
        over = carry.sel & (order >= max_per_row)
        fr = frontier_view(state)
        if carry.url_cash is None:
            fr = F.insert(fr, carry.urls,
                          ctx.score_fn(carry.urls, ctx.cfg, state), over,
                          n_buckets=ctx.cfg.n_priority_buckets)
        else:
            zero = torch.zeros_like(carry.url_cash)
            scores = ctx.score_fn(carry.urls, ctx.cfg, state,
                                  val=carry.url_cash)
            fr, _, refund = F.insert_valued(
                fr, state.order_state[:, ORD_URL0:], carry.urls, scores,
                over, torch.where(over, carry.url_cash, zero),
                n_buckets=ctx.cfg.n_priority_buckets)
            state.order_state[:, 0] += refund
            carry = carry._replace(
                url_cash=torch.where(over, zero, carry.url_cash))
        return (with_frontier(state, fr), carry._replace(sel=carry.sel & ~over),
                {"politeness_deferred": per_shard(ctx, over)})

    politeness.placement = "post_allocate"
    return politeness


def make_revisit_stage(age_steps: int = 32) -> Stage:
    """Freshness-driven revisits (``core/freshness.py``): fetched URLs
    re-enter their domain queue at an age-discounted score, so that the
    allocator interleaves revisits with discovery (placed after
    ``fetch_analyze``). Revisits bypass the Bloom filter by design."""

    def revisit(ctx: StageContext, state: CrawlState, carry: StepCarry
                ) -> Tuple[CrawlState, StepCarry, StatsDelta]:
        age = torch.full(carry.urls.shape, age_steps, dtype=torch.int32,
                         device=carry.urls.device)
        fr = FR.reenqueue(frontier_view(state), carry.urls, carry.sel, age,
                          ctx.cfg)
        return (with_frontier(state, fr), carry,
                {"revisit_enqueued": per_shard(ctx, carry.sel)})

    revisit.placement = "post_fetch"
    return revisit

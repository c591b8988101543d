"""Shared harness of the crawl-group tests: the port's crawl over a
``torch.distributed`` group of W processes (gloo on the CPU, one spawn a
world size, a ``FileStore`` for the rendezvous) against the one-process
port at the same shard count. It imports no JAX: the cards' machine runs
the same play.

A case is ``{"over": config overrides, "stages": [["politeness", n] |
["revisit", age]], "ops": [...]}`` at ``webparf.reduced()`` and N = 4:

  ["run", steps]         CrawlSession.run (mode "auto")
  ["run_eager", steps]   the same in mode "eager" (the one-process
                         reference of an ``eager_vs`` case runs "scan")
  ["fail", shard]        inject_failure
  ["heal"]               heal every dead shard (``["heal", [shards]]``:
                         those); records the state before and after
  ["checkpoint"]         checkpoint into <ckpt>/<case>
  ["restore", dir]       restore a checkpoint directory (relative to
                         <ckpt>)
  ["serve", steps]       a ServeSession of SERVE_KW instead of a
                         CrawlSession, run for ``steps``, checkpointed into
                         <ckpt>/<case>, and a fresh ServeSession restored
                         from it and run for ``steps`` more
  ["serve_heal", steps, shard]
                         a ServeSession run for ``steps``, ``shard``
                         failed, run, healed, run
  ["cli", argv]          the crawl CLI (``launch.crawl.main``); records
                         rank 0's output without its timings, and whether
                         every other rank kept silent

``records`` are the numpy arrays a play leaves: each run's urls,
per-step counts, stats per shard, comm ledger and telemetry window (the
ledger rows and its metrics without timings) and rebalance events, the
trace's events without their times, the served answers, lags and recall,
and the final state's every leaf, gathered. ``assert_same``
holds two plays bit for bit: every array of the same dtype, shape and
bytes (f32 included).
"""
import contextlib
import dataclasses
import io
import json
import os
import time
import traceback

import numpy as np

N_SHARDS = 4
IV = 4                          # webparf.reduced()'s dispatch interval
OPIC_URL = {"ordering": "opic_url", "link_pop_bias": 1.0}
SERVE_KW = dict(qps=3.0, load_seed=0, doc_len=16, vocab=512, top_k=5,
                index_capacity=1024)
GROUP_TIMEOUT_S = 120           # a collective's wait before the group fails

CASES = {
    "backlink": {"over": {}, "ops": [["run", 3 * IV]]},
    "opic": {"over": {"ordering": "opic", "link_pop_bias": 1.0},
             "ops": [["run", 3 * IV]]},
    "opic_url-fused": {"over": OPIC_URL, "ops": [["run", 3 * IV]]},
    "opic_url-unfused": {"over": {**OPIC_URL, "fused_dispatch": False},
                         "ops": [["run", 3 * IV]]},
    "firewall": {"over": {**OPIC_URL, "coordination": "firewall"},
                 "ops": [["run", 3 * IV]]},
    "crossover": {"over": {**OPIC_URL, "coordination": "crossover"},
                  "ops": [["run", 3 * IV]]},
    "batched": {"over": {**OPIC_URL, "coordination": "batched",
                         "comm_quota": 8},
                "ops": [["run", 3 * IV]]},
    "url_hash": {"over": {"partitioning": "url_hash"},
                 "ops": [["run", 3 * IV]]},
    # eager steps here, whole chunks ("scan") in the reference
    "eager_vs_scan": {"over": OPIC_URL, "ops": [["run_eager", 3 * IV]]},
    "stages_telemetry": {"over": {**OPIC_URL, "telemetry": True},
                         "stages": [["politeness", 1], ["revisit", 32]],
                         "ops": [["run", 2 * IV], ["run_eager", IV]]},
    # shard 1 dies mid-interval with values staged
    "inject_failure": {"over": OPIC_URL,
                       "ops": [["run", IV + 2], ["fail", 1],
                               ["run_eager", 2], ["run", IV]]},
    "serve": {"over": {}, "ops": [["serve", 3 * IV]]},
    # a checkpoint taken mid-interval, then a step through a dispatch
    "checkpoint": {"over": OPIC_URL,
                   "ops": [["run", 2 * IV - 1], ["checkpoint"], ["run", 1]]},
}

# heal and load-driven rebalance across ranks (tests/test_torch_dist_heal.py)
REBALANCE = {"telemetry": True, "rebalance_threshold": 1.01}
CLI = ["--device", "cpu", "--shards", str(N_SHARDS)]
HEAL_CASES = {
    "heal_backlink": {"over": {},
                      "ops": [["run", IV], ["fail", 1], ["run", IV],
                              ["heal"], ["run", 2 * IV]]},
    # shard 1 dies mid-interval with values staged
    "heal_opic_url": {"over": OPIC_URL,
                      "ops": [["run", IV + 2], ["fail", 1], ["run_eager", 2],
                              ["heal"], ["run", 2 * IV]]},
    # the dead shard parks its outbox
    "heal_batched": {"over": {**OPIC_URL, "coordination": "batched",
                              "comm_quota": 8},
                     "ops": [["run", IV], ["fail", 1], ["run", IV],
                             ["heal"], ["run", IV]]},
    # url_hash fills every row: the heal overwrites displaced rows
    "heal_url_hash": {"over": {**OPIC_URL, "partitioning": "url_hash"},
                      "ops": [["run", IV], ["fail", 1], ["run", IV],
                              ["heal"], ["run", IV]]},
    # at W = 2 rank 1 owns only dead shards
    "heal_two_dead": {"over": OPIC_URL,
                      "ops": [["run", IV], ["fail", 2], ["fail", 3],
                              ["run", IV], ["heal"], ["run", IV]]},
    # 6 orphans, 2 free slots: the merge fallback, cash across ranks
    "heal_three_dead": {"over": OPIC_URL,
                        "ops": [["run", IV], ["fail", 1], ["fail", 2],
                                ["fail", 3], ["run", IV],
                                ["heal", [1, 2, 3]], ["run", IV]]},
    "rebalance_opic_url": {"over": {**OPIC_URL, **REBALANCE},
                           "ops": [["run", 4 * IV]]},
    "rebalance_url_hash": {"over": {"partitioning": "url_hash",
                                    **REBALANCE},
                           "ops": [["run", 4 * IV]]},
    "rebalance_eager": {"over": {**OPIC_URL, **REBALANCE,
                                 "rebalance_max_domains": 1},
                        "ops": [["run_eager", 3 * IV]]},
    # the checkpoint holds the stale rows the heal leaves on shard 1
    "heal_checkpoint": {"over": OPIC_URL,
                        "ops": [["run", IV], ["fail", 1], ["run", 2],
                                ["heal"], ["run", 2], ["checkpoint"],
                                ["run", IV]]},
    "serve_heal": {"over": {}, "ops": [["serve_heal", IV, 1]]},
    "cli_heal": {"over": {}, "ops": [["cli", CLI + [
        "--domains", "8", "--steps", "12", "--fail-shard", "1",
        "--fail-at", "4", "--heal-at", "8"]]]},
    "cli_rebalance": {"over": {}, "ops": [["cli", CLI + [
        "--domains", "16", "--steps", "12", "--rebalance-threshold",
        "1.01"]]]},
}

WORLDS = (2, 4)                 # every case is played at both
# the JAX package's checkpoint of the "checkpoint" case (its
# ``<out>/jax.ckpt``), restored in the group and stepped through the
# dispatch
RESTORE_JAX = {"over": OPIC_URL, "ops": [["restore", "jax.ckpt"],
                                         ["run", 1]]}


def port_stages(spec):
    from repro_torch.core import stages as ST
    return [ST.make_politeness_stage(a) if kind == "politeness"
            else ST.make_revisit_stage(a) for kind, a in spec]


def case_config(case):
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
    return scaled(webparf.reduced(), **case["over"])


def run_records(rec, key, rep):
    """A CrawlReport's records under ``key``."""
    rec[f"{key}.urls"] = rep.urls
    rec[f"{key}.per_step"] = rep.per_step
    for k, v in rep.stats_per_shard.items():
        rec[f"{key}.stats.{k}"] = np.asarray(v)
    rec[f"{key}.comm"] = np.array(json.dumps(rep.comm, sort_keys=True))
    rec[f"{key}.rebalances"] = np.array(json.dumps(
        [dataclasses.asdict(e) for e in rep.rebalances]))
    if rep.telemetry is not None:
        tel = rep.telemetry
        rec[f"{key}.ledger.names"] = np.array(json.dumps(tel.names))
        rec[f"{key}.ledger.steps"] = tel.steps
        rec[f"{key}.ledger.rows"] = tel.rows
        rec[f"{key}.ledger.metrics"] = np.array(json.dumps(
            {k: v for k, v in tel.metrics().items()
             if not k.startswith(("wall_", "n_"))
             or k in ("n_records", "n_shards")}, sort_keys=True))


def serve_records(rec, key, r):
    """A ServeReport's records under ``key``."""
    for f in ("top_urls", "top_scores", "lag_steps", "arrival_step"):
        rec[f"{key}.{f}"] = getattr(r, f)
    rec[f"{key}.recall"] = np.float64(r.recall_at_k)
    rec[f"{key}.index"] = np.array(json.dumps(r.index, sort_keys=True))
    run_records(rec, f"{key}.crawl", r.crawl)


def state_records(rec, key, state):
    """Every leaf of a crawl state, gathered, under ``key``."""
    from repro_torch.core.stages import join_state, state_to_numpy
    for k, v in state_to_numpy(join_state(state)).items():
        rec[f"{key}.{k}"] = v


def trace_records(rec, tracer):
    """The trace's events without their times: names, kinds, arguments."""
    rec["trace"] = np.array(json.dumps(
        [[e.name, e.cat, e.ph, e.args] for e in tracer.events],
        sort_keys=True, default=str))


def scrub_cli(text):
    """The crawl CLI's output without what depends on the clock: the
    pages-in-seconds line and the span table."""
    text = text.split("== spans ==")[0]
    return "\n".join(line for line in text.splitlines()
                     if " pages in " not in line)


def play_cli(rec, key, argv):
    """Run the crawl CLI, every rank; record rank 0's output."""
    import torch
    from repro_torch.dist import CrawlGroup
    from repro_torch.launch.crawl import main as crawl_cli
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert crawl_cli(argv) == 0
    group = CrawlGroup.current()
    text = out.getvalue()
    rec[f"{key}.out"] = np.array(scrub_cli(group.broadcast(text)))
    spoke = torch.tensor(int(group.rank > 0 and bool(text)))
    rec[f"{key}.others_silent"] = np.bool_(int(group.sum_int(spoke)) == 0)


def play(case, *, ckpt_root=None, name="case", mode=None):
    """Play a case on the CPU in this process: across the crawl group
    when one is started, else in one process. ``mode`` replaces every
    run's mode (the reference of ``eager_vs_scan``). Returns the
    records."""
    from repro_torch.api import CrawlSession
    from repro_torch.serve import ServeSession
    cfg = case_config(case)
    rec = {}
    crawl = None
    for i, op in enumerate(case["ops"]):
        if op[0] == "serve":
            kw = dict(SERVE_KW)
            sess = ServeSession(cfg, "cpu", n_shards=N_SHARDS, **kw)
            serve_records(rec, f"run{i}", sess.run(op[1]))
            sess.checkpoint(os.path.join(ckpt_root, name))
            sess = ServeSession(cfg, "cpu", n_shards=N_SHARDS, **kw)
            sess.restore(os.path.join(ckpt_root, name))
            serve_records(rec, f"run{i}.restored", sess.run(op[1]))
            crawl = sess.crawl
            continue
        if op[0] == "serve_heal":
            sess = ServeSession(cfg, "cpu", n_shards=N_SHARDS, **SERVE_KW)
            serve_records(rec, f"run{i}", sess.run(op[1]))
            sess.inject_failure(op[2])
            serve_records(rec, f"run{i}.failed", sess.run(op[1]))
            sess.heal()
            serve_records(rec, f"run{i}.healed", sess.run(op[1]))
            crawl = sess.crawl
            continue
        if op[0] == "cli":
            play_cli(rec, f"cli{i}", op[1])
            continue
        if crawl is None:
            crawl = CrawlSession(cfg, "cpu", n_shards=N_SHARDS,
                                 extra_stages=port_stages(
                                     case.get("stages", [])))
        if op[0] in ("run", "run_eager"):
            run_mode = mode or ("eager" if op[0] == "run_eager" else "auto")
            run_records(rec, f"run{i}", crawl.run(op[1], mode=run_mode))
        elif op[0] == "fail":
            crawl.inject_failure(op[1])
        elif op[0] == "heal":
            state_records(rec, f"preheal{i}", crawl.state)
            crawl.heal(op[1] if len(op) > 1 else None)
            state_records(rec, f"heal{i}", crawl.state)
        elif op[0] == "checkpoint":
            crawl.checkpoint(os.path.join(ckpt_root, name))
        elif op[0] == "restore":
            crawl.restore(os.path.join(ckpt_root, op[1]))
        else:
            raise ValueError(op)
    if crawl is not None:
        state_records(rec, "final", crawl.state)
        trace_records(rec, crawl.tracer)
    return rec


def assert_same(want, got, label):
    """Two plays' records bit for bit."""
    assert sorted(want) == sorted(got), (label, sorted(
        set(want) ^ set(got)))
    for k in sorted(want):
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (label, k, a.dtype,
                                                          b.dtype)
        assert a.tobytes() == b.tobytes(), f"{label}: {k} differs"


class Played:
    """A play's final state and config, as ``_torch_play.assert_case``
    reads a session."""

    def __init__(self, rec, case):
        from repro_torch.core.stages import CrawlState, state_from_numpy
        self.cfg = case_config(case)
        self.state = state_from_numpy(
            {k: rec[f"final.{k}"] for k in CrawlState._fields}, "cpu")


def reports(rec, cfg, rename=None):
    """A play's runs as CrawlReports (with their telemetry windows and
    rebalance events) and its healed states, keyed as
    ``_torch_play.assert_case`` reads the JAX package's records."""
    from repro_torch.api.report import CrawlReport
    from repro_torch.core.stages import CrawlState
    from repro_torch.obs.health import CrawlTelemetry
    from repro_torch.rebalance import RebalanceEvent
    out = {}
    for key in sorted({k.split(".")[0] for k in rec
                       if k.startswith(("run", "heal"))}):
        name = (rename or {}).get(key, key)
        if key.startswith("heal"):
            out[name] = {k: rec[f"{key}.{k}"] for k in CrawlState._fields}
            continue
        per = {k.split(".stats.")[1]: rec[k] for k in rec
               if k.startswith(f"{key}.stats.")}
        tel = None
        if f"{key}.ledger.rows" in rec:
            tel = CrawlTelemetry(
                steps=rec[f"{key}.ledger.steps"],
                rows=rec[f"{key}.ledger.rows"],
                names=tuple(json.loads(str(rec[f"{key}.ledger.names"]))),
                interval=cfg.dispatch_interval)
        events = tuple(
            RebalanceEvent(**{**e, "moves": tuple(map(tuple, e["moves"]))})
            for e in json.loads(str(rec[f"{key}.rebalances"])))
        out[name] = CrawlReport(
            urls=rec[f"{key}.urls"], per_step=rec[f"{key}.per_step"],
            stats={k: int(v.sum()) for k, v in per.items()}, seconds=0.0,
            cfg=cfg, stats_per_shard=per, telemetry=tel, rebalances=events)
    return out


def refusals(world):
    """What a rank of a ``world``-process group must refuse, as
    {name: the error's type and message}."""
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    out = {}

    def catch(name, fn):
        try:
            fn()
            out[name] = "no error"
        except Exception as e:                       # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"

    cfg = webparf.reduced()
    # a world that does not divide the shards (1 shard, or 2 under 4)
    catch("divide", lambda: CrawlSession(cfg, "cpu",
                                         n_shards=world // 2 if world > 2
                                         else 1))
    catch("device_none", lambda: CrawlSession(cfg, None, n_shards=N_SHARDS))
    return out


def in_group(rank, world, out, body):
    """Start rank ``rank`` of a ``world``-process gloo group (a
    ``FileStore`` in ``out``), run ``body(group)``, and end the group; a
    failure is written to ``<out>/error.r<rank>.txt``."""
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_crawl_group, make_host_mesh
    store = dist.FileStore(os.path.join(out, "store"), world)
    group = init_crawl_group("cpu", store=store, rank=rank,
                             world_size=world, timeout_s=GROUP_TIMEOUT_S)
    try:
        assert (group.world, group.rank) == (world, rank)
        assert make_host_mesh() == {"data": world, "model": 1}
        body(group)
        group.barrier()
    except BaseException:
        with open(os.path.join(out, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def rank_main(rank, world, out, jax_ckpt):
    """One rank of a ``world``-process gloo group: every case of CASES,
    then restores of the checkpoints a one-process port and the JAX
    package wrote (``jax_ckpt``, waited for), then the refusals. Each
    rank writes its records to ``<out>/<case>.r<rank>.npz``."""
    def body(group):
        ckpt_root = os.path.join(out, "ckpt")
        for name, case in CASES.items():
            np.savez(os.path.join(out, f"{name}.r{rank}.npz"),
                     **play(case, ckpt_root=ckpt_root, name=name))
        # the one-process port's checkpoint and the JAX package's
        deadline = time.time() + 600
        while not os.path.exists(os.path.join(jax_ckpt, "done")):
            if time.time() > deadline:
                raise TimeoutError(f"no JAX checkpoint in {jax_ckpt}")
            time.sleep(0.2)
        np.savez(os.path.join(out, f"restore_jax.r{rank}.npz"),
                 **play(RESTORE_JAX, ckpt_root=jax_ckpt))
        with open(os.path.join(out, f"refusals.r{rank}.json"), "w") as f:
            json.dump(refusals(world), f)
    in_group(rank, world, out, body)


def heal_rank_main(rank, world, out):
    """One rank of a ``world``-process gloo group playing every case of
    HEAL_CASES, its records to ``<out>/<case>.r<rank>.npz``, and the row
    move of ``chain_move`` (``<out>/chain.r<rank>.npz``)."""
    def body(group):
        ckpt_root = os.path.join(out, "ckpt")
        for name, case in HEAL_CASES.items():
            np.savez(os.path.join(out, f"{name}.r{rank}.npz"),
                     **play(case, ckpt_root=ckpt_root, name=name))
        np.savez(os.path.join(out, f"chain.r{rank}.npz"),
                 **chain_move(group))
    in_group(rank, world, out, body)


# a row move in which slots vacated by moves are other moves' targets
# (0 -> 5 -> 9 -> 2 -> 0 and 7 -> 12 -> 3 -> 7, a cycle each), slots 4
# and 14 pull from two others, and the rest keep their rows: (16,) the
# source slot of every slot
CHAIN_SRC = np.arange(16)
CHAIN_SRC[[5, 9, 2, 0]] = [0, 5, 9, 2]
CHAIN_SRC[[12, 3, 7]] = [7, 12, 3]
CHAIN_SRC[[4, 14]] = [15, 1]
CHAIN_WIDTHS = {"url": ((3,), "int64"), "valid": ((5,), "bool"),
                "pri": ((2, 2), "float32"), "bits": ((), "uint8")}


def chain_leaves(rows=slice(None)):
    """The chain move's leaves, drawn from a seed: every slot's rows (or
    ``rows``)."""
    import torch
    rng = np.random.default_rng(7)
    out = {}
    for name, (shape, dtype) in CHAIN_WIDTHS.items():
        a = rng.integers(0, 1 << 31, (len(CHAIN_SRC),) + shape)
        if dtype == "float32":
            a = rng.standard_normal((len(CHAIN_SRC),) + shape)
        out[name] = torch.from_numpy(np.ascontiguousarray(
            a.astype(dtype)[rows]))
    return out


def chain_move(group):
    """Move this rank's rows of the chain leaves; returns the moved rows
    and the plan's sizes."""
    import torch
    n = len(CHAIN_SRC)
    per = n // group.world
    leaves = chain_leaves(slice(group.rank * per, (group.rank + 1) * per))
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    plan = group.move_rows(leaves, torch.from_numpy(CHAIN_SRC))
    assert all(v.data_ptr() == ptrs[k] for k, v in leaves.items())
    rec = {f"leaf.{k}": v.numpy() for k, v in leaves.items()}
    rec["send_rows"] = plan.send_rows.numpy()
    rec["recv_rows"] = plan.recv_rows.numpy()
    rec["send_splits"] = np.asarray(plan.send_splits)
    rec["recv_splits"] = np.asarray(plan.recv_splits)
    return rec


def build_main(barrier, build_dir, nvcc_home, out):
    """One of two processes that reach a kernel's first build at once:
    ``nvcc_home/bin/nvcc`` is a stub compiler that counts its runs. Waits
    at ``barrier``, builds, loads the library, and writes what it
    loaded to ``out``."""
    import ctypes
    from pathlib import Path
    from repro_torch.kernels import build
    os.environ["CUDA_HOME"] = nvcc_home
    build.BUILD_DIR = Path(build_dir)
    kernel = build.Kernel("bloom", 0, 0)
    barrier.wait()
    kernel.finish_build(kernel.start_build())
    ctypes.CDLL(str(kernel.library))
    with open(out, "w") as f:
        f.write(str(kernel.library))

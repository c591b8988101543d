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
  ["checkpoint"]         checkpoint into <ckpt>/<case>
  ["restore", dir]       restore a checkpoint directory (relative to
                         <ckpt>)
  ["serve", steps]       a ServeSession of SERVE_KW instead of a
                         CrawlSession, run for ``steps``, checkpointed into
                         <ckpt>/<case>, and a fresh ServeSession restored
                         from it and run for ``steps`` more

``records`` are the numpy arrays a play leaves: each run's urls,
per-step counts, stats per shard, comm ledger and telemetry window (the
ledger rows and its metrics without timings), the served answers, lags
and recall, and the final state's every leaf, gathered. ``assert_same``
holds two plays bit for bit: every array of the same dtype, shape and
bytes (f32 included).
"""
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
    if rep.telemetry is not None:
        tel = rep.telemetry
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


def play(case, *, ckpt_root=None, name="case", mode=None):
    """Play a case on the CPU in this process: across the crawl group
    when one is started, else in one process. ``mode`` replaces every
    run's mode (the reference of ``eager_vs_scan``). Returns the
    records."""
    from repro_torch.api import CrawlSession
    from repro_torch.core.stages import join_state, state_to_numpy
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
        if crawl is None:
            crawl = CrawlSession(cfg, "cpu", n_shards=N_SHARDS,
                                 extra_stages=port_stages(
                                     case.get("stages", [])))
        if op[0] in ("run", "run_eager"):
            run_mode = mode or ("eager" if op[0] == "run_eager" else "auto")
            run_records(rec, f"run{i}", crawl.run(op[1], mode=run_mode))
        elif op[0] == "fail":
            crawl.inject_failure(op[1])
        elif op[0] == "checkpoint":
            crawl.checkpoint(os.path.join(ckpt_root, name))
        elif op[0] == "restore":
            crawl.restore(os.path.join(ckpt_root, op[1]))
        else:
            raise ValueError(op)
    whole = state_to_numpy(join_state(crawl.state))
    for k, v in whole.items():
        rec[f"final.{k}"] = v
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


def refusals(world):
    """What a rank of a ``world``-process group must refuse, as
    {name: the error's type and message}."""
    from repro_torch.api import CrawlSession
    from repro_torch.configs import webparf
    from repro_torch.configs.base import scaled
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

    def heal():
        sess = CrawlSession(cfg, "cpu", n_shards=N_SHARDS)
        sess.inject_failure(1)
        sess.heal()
    catch("heal", heal)
    catch("rebalance", lambda: CrawlSession(
        scaled(cfg, telemetry=True, rebalance_threshold=1.5), "cpu",
        n_shards=N_SHARDS))

    def apply():
        from repro_torch.core import crawler as CR
        from repro_torch.core import partitioner as PT
        sess = CrawlSession(cfg, "cpu", n_shards=N_SHARDS)
        st = sess.state
        CR.apply_rebalance(st, cfg, PT.DomainMap(
            st.slot_of_domain, PT.identity_map(cfg, N_SHARDS,
                                               "cpu").domain_of_slot,
            st.shard_alive))
    catch("apply_rebalance", apply)
    from repro_torch.launch.crawl import main as crawl_cli
    cli = ["--device", "cpu", "--shards", str(N_SHARDS), "--domains", "8",
           "--steps", "8"]
    catch("cli_heal_at", lambda: crawl_cli(
        cli + ["--fail-shard", "1", "--fail-at", "4", "--heal-at", "8"]))
    catch("cli_rebalance", lambda: crawl_cli(
        cli + ["--rebalance-threshold", "1.5"]))
    return out


def rank_main(rank, world, out, jax_ckpt):
    """One rank of a ``world``-process gloo group: every case of CASES,
    then restores of the checkpoints a one-process port and the JAX
    package wrote (``jax_ckpt``, waited for), then the refusals. Each
    rank writes its records to ``<out>/<case>.r<rank>.npz``."""
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
        group.barrier()
    except BaseException:
        with open(os.path.join(out, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


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

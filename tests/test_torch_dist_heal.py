"""Heal and load-driven rebalance across a crawl group: the port's crawl
over W gloo processes (``launch.mesh.init_crawl_group`` on the CPU) moves
frontier, Bloom and ordering rows between ranks (``dist.CrawlGroup.
move_rows``), and every record equals the one-process port's at N = 4
shards of ``webparf.reduced()``, bit for bit.

One spawn a world size (W = 2, two shards a rank; W = 4, one) plays every
case of ``tests/_torch_dist_play.HEAL_CASES`` (heals under backlink,
opic_url, the batched mode and url_hash; a whole rank dead; three dead
shards and the merge fallback; forced rebalances; a heal before a
checkpoint; a serve session's heal; the crawl CLI's ``--heal-at`` and
``--rebalance-threshold``) and the row move of ``chain_move``; this
process plays the same cases in one process. Held bit for bit: every
report, ledger row, rebalance event and trace event, the state before and
after each heal and at the end. The opic_url heal and rebalance are also
held to the JAX package's 4-device records with
``tests/_torch_play.assert_case``'s tolerances.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_play as D  # noqa: E402
from _torch_play import CASH_RTOL, JAX_SCRIPT, assert_case  # noqa: E402
from _torch_play import jax_env, niced, numpy_cash  # noqa: E402

from repro_torch.core.stages import CrawlState  # noqa: E402
from repro_torch.dist import CrawlGroup  # noqa: E402

FIXTURE_TIMEOUT_S = 300
# the JAX package's records of the cases held to it
HELD_TO_JAX = ("heal_opic_url", "rebalance_opic_url")
JAX_CASES = {name: {"over": D.HEAL_CASES[name]["over"], "shards": 4,
                    "ops": D.HEAL_CASES[name]["ops"]}
             for name in HELD_TO_JAX}
HEALS = sorted(name for name, case in D.HEAL_CASES.items()
               if any(op[0] == "heal" for op in case["ops"]))


@pytest.fixture(scope="module")
def plays(tmp_path_factory):
    """Run the JAX subprocess and both groups side by side; meanwhile
    play every case in this process. Returns {"tmp", "ref"}."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("heal")
    env = jax_env(tmp)
    deadline = time.time() + FIXTURE_TIMEOUT_S
    (tmp / "jax").mkdir()
    jax = subprocess.Popen(
        [sys.executable, "-c", niced(JAX_SCRIPT), str(tmp / "jax"),
         json.dumps(JAX_CASES)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=".", env=env)
    ctxs = []
    try:
        for w in D.WORLDS:
            (tmp / f"w{w}").mkdir()
            ctxs.append(mp.start_processes(
                D.heal_rank_main, args=(w, str(tmp / f"w{w}")), nprocs=w,
                join=False, start_method="spawn"))
        ref = {name: D.play(case, ckpt_root=str(tmp / "ref"), name=name)
               for name, case in D.HEAL_CASES.items()}
        out, err = jax.communicate(timeout=max(deadline - time.time(), 1))
    except BaseException:
        jax.kill()
        for ctx in ctxs:
            for p in ctx.processes:
                p.kill()
        raise
    for ctx in ctxs:
        while not ctx.join(max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("a crawl group did not finish")
    if jax.returncode != 0 or "jax cases: OK" not in out:
        raise AssertionError(f"JAX:\n{out[-3000:]}\n{err[-3000:]}")
    return {"tmp": tmp, "ref": ref}


def _rank_records(plays, world, name):
    out = plays["tmp"] / f"w{world}"
    errs = sorted(out.glob("error.r*.txt"))
    assert not errs, errs[0].read_text()
    return [dict(np.load(out / f"{name}.r{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", D.WORLDS)
@pytest.mark.parametrize("name", sorted(D.HEAL_CASES))
def test_heal_group_equals_one_process(plays, world, name):
    """Every rank's reports, rebalance events, trace events, the state
    before and after each heal, and the final state equal the
    one-process port's bit for bit (the CLI cases: rank 0's output
    without timings, every other rank silent)."""
    for r, got in enumerate(_rank_records(plays, world, name)):
        D.assert_same(plays["ref"][name], got, f"W={world} rank {r} {name}")
        for k in got:
            if k.endswith(".others_silent"):
                assert got[k], (world, name)


@pytest.mark.parametrize("world", D.WORLDS)
@pytest.mark.parametrize("name", HELD_TO_JAX)
def test_heal_group_held_to_jax(plays, world, name):
    """The group's records against the JAX package's 4-device records
    (``assert_case``: ints identical, f32 leaves to 8 ulp, cash to 1e-6,
    the rebalance events' moves and imbalances as JAX rounds them)."""
    rec = _rank_records(plays, world, name)[0]
    case = D.HEAL_CASES[name]
    sess = D.Played(rec, case)
    reps = D.reports(rec, sess.cfg)
    if name.startswith("rebalance"):
        assert any(r.rebalances for r in reps.values()), name
    assert_case(str(plays["tmp"] / "jax" / f"{name}.npz"), sess, reps,
                f"W={world} {name}",
                valid_pri_only=name.startswith("rebalance"))


def _heal_states(name):
    """The index of a case's heal and its records' key prefixes."""
    (i,) = [i for i, op in enumerate(D.HEAL_CASES[name]["ops"])
            if op[0] == "heal"]
    return i


@pytest.mark.parametrize("name", HEALS)
def test_heal_keeps_queued_urls_and_cash(plays, name):
    """Every URL queued on a dead shard before the heal, in a row whose
    domain gets a slot of its own, is queued on a survivor after it (a
    merged domain's queue stays behind, as in the reference); and the
    cash (staging and outbox included) is the same within CASH_RTOL."""
    rec = plays["ref"][name]
    i = _heal_states(name)
    pre = {k: rec[f"preheal{i}.{k}"] for k in CrawlState._fields}
    post = {k: rec[f"heal{i}.{k}"] for k in CrawlState._fields}
    n_slots = pre["f_url"].shape[0]
    dead = np.repeat(~pre["shard_alive"], n_slots // D.N_SHARDS)
    dom = pre["slot_domain"]
    placed = post["slot_domain"][post["slot_of_domain"]] == np.arange(
        len(post["slot_of_domain"]))
    rows = dead & (dom >= 0) & placed[np.maximum(dom, 0)]
    queued = set(pre["f_url"][rows][pre["f_valid"][rows]].tolist())
    kept = set(post["f_url"][~dead][post["f_valid"][~dead]].tolist())
    assert queued and queued <= kept, len(queued - kept)
    if "ordering" in D.HEAL_CASES[name]["over"]:
        np.testing.assert_allclose(numpy_cash(post), numpy_cash(pre),
                                   rtol=CASH_RTOL)


def test_three_dead_merges_domains(plays):
    """Three dead shards leave 2 free slots for 6 orphans: four domains
    share a row, every domain now lives on shard 0, and the merged
    domains' cash (on ranks other than shard 0's under W = 4) stays."""
    rec = plays["ref"]["heal_three_dead"]
    i = _heal_states("heal_three_dead")
    sod = rec[f"heal{i}.slot_of_domain"]
    dos = rec[f"heal{i}.slot_domain"]
    merged = dos[sod] != np.arange(len(sod))
    assert merged.sum() == 4, merged
    assert (sod // (len(dos) // D.N_SHARDS) == 0).all()


@pytest.mark.parametrize("world", D.WORLDS)
def test_healed_checkpoint_restores_in_one_process(plays, world):
    """The group's checkpoint after a heal holds the files a one-process
    session writes (the stale rows on the dead shard included), and a
    one-process session restores it and steps as the group went on."""
    ckpt = plays["tmp"] / f"w{world}" / "ckpt" / "heal_checkpoint"
    ref = plays["tmp"] / "ref" / "heal_checkpoint"
    (step,) = os.listdir(ckpt)
    with np.load(ckpt / step / "arrays.npz") as a, \
            np.load(ref / step / "arrays.npz") as b:
        D.assert_same(dict(b), dict(a), f"W={world} checkpoint files")
    ops = D.HEAL_CASES["heal_checkpoint"]["ops"]
    got = D.play({"over": D.OPIC_URL, "ops": [["restore", "heal_checkpoint"],
                                             ops[-1]]},
                 ckpt_root=str(ckpt.parent))
    last = f"run{len(ops) - 1}."
    want = {k.replace(last, "run1.", 1): v for k, v in
            _rank_records(plays, world, "heal_checkpoint")[0].items()
            if k.startswith((last, "final."))}
    got = {k: v for k, v in got.items() if k.startswith(("run1.", "final."))}
    D.assert_same(want, got, f"W={world} restored in one process")


def _moved(world, rank):
    """``chain_move``'s result on ``rank`` of ``world``, emulated in this
    process: every rank's plan, the all-to-all done by hand."""
    n = len(D.CHAIN_SRC)
    per = n // world
    src = torch.from_numpy(D.CHAIN_SRC)
    plans = [CrawlGroup(world, r).plan_move(src) for r in range(world)]
    rows = [D.chain_leaves(slice(r * per, (r + 1) * per))
            for r in range(world)]
    for name in D.CHAIN_WIDTHS:
        sends = [p.pack(rows[r][name]) for r, p in enumerate(plans)]
        for r, p in enumerate(plans):
            # rank q's chunk of each sender, in sender order
            parts = []
            for q, send in enumerate(sends):
                lo = sum(plans[q].send_splits[:r])
                parts.append(send[lo:lo + plans[q].send_splits[r]])
            assert [len(x) for x in parts] == p.recv_splits
            p.unpack(rows[r][name], torch.cat(parts))
    return plans, rows


@pytest.mark.parametrize("world", (1, 2, 4))
def test_row_move_chain(world):
    """A row move whose vacated slots are other moves' targets (two
    cycles) and whose sources are read twice equals the reference's
    gather ``old[src]`` on every rank, in place; each rank's buffers hold
    exactly the rows it sends and receives, never a whole leaf."""
    n = len(D.CHAIN_SRC)
    per = n // world
    whole = D.chain_leaves()
    plans, rows = _moved(world, 0)
    moving = D.CHAIN_SRC != np.arange(n)
    for r, plan in enumerate(plans):
        owned = slice(r * per, (r + 1) * per)
        src_rank = D.CHAIN_SRC // per
        assert len(plan.send_rows) == (moving & (src_rank == r)).sum()
        assert len(plan.recv_rows) == moving[owned].sum()
        assert sum(plan.send_splits) == len(plan.send_rows)
        assert plan.n_moved == moving.sum()
        for name, leaf in whole.items():
            np.testing.assert_array_equal(
                rows[r][name].numpy(),
                leaf.numpy()[D.CHAIN_SRC][owned], err_msg=f"{world} {r}")
            sent = plan.pack(leaf[owned])
            assert sent.numel() == len(plan.send_rows) * leaf[0].numel()


@pytest.mark.parametrize("world", D.WORLDS)
def test_row_move_chain_in_group(plays, world):
    """The chain move over the spawned group: each rank's rows equal the
    gather, its plan the emulated one."""
    plans, rows = _moved(world, 0)
    for r, got in enumerate(_rank_records(plays, world, "chain")):
        for name in D.CHAIN_WIDTHS:
            np.testing.assert_array_equal(got[f"leaf.{name}"],
                                          rows[r][name].numpy())
        np.testing.assert_array_equal(got["send_rows"], plans[r].send_rows)
        np.testing.assert_array_equal(got["recv_splits"],
                                      plans[r].recv_splits)


def test_move_rows_one_process_is_in_place():
    """Without a group ``move_rows`` makes no collective: the leaves are
    written in place, and a leaf of no moved row is left alone."""
    g = CrawlGroup.current()
    assert g.world == 1
    leaves = D.chain_leaves()
    want = {k: v[torch.from_numpy(D.CHAIN_SRC)] for k, v in leaves.items()}
    ptrs = {k: v.data_ptr() for k, v in leaves.items()}
    plan = g.move_rows(leaves, torch.from_numpy(D.CHAIN_SRC))
    for k, v in leaves.items():
        assert v.data_ptr() == ptrs[k] and torch.equal(v, want[k]), k
    assert plan.send_splits == plan.recv_splits == [plan.n_moved]
    still = {"a": torch.arange(16)}
    assert g.move_rows(still, torch.arange(16)).n_moved == 0
    assert torch.equal(still["a"], torch.arange(16))

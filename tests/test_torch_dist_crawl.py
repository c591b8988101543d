"""The parallel crawl with one process a card: the port's crawl over a
crawl group of W processes (``launch.mesh.init_crawl_group``, gloo on the
CPU) against the one-process port at the same shard count, N = 4 at
``webparf.reduced()``.

One spawn a world size (W = 2, two shards a rank; W = 4, one) plays every
case of ``tests/_torch_dist_play.CASES``, each rank writing its records
(every report, gathered, and the final state, joined); this process plays
the same cases in one process. Held bit for bit: every int, bool, uint32
and f32 leaf and output. Two cases are also held to the JAX package's
4-device records with ``tests/_torch_play.assert_case``'s tolerances, and
a JAX checkpoint restores into the group. A ``FileStore`` in the test's
temporary directory is the rendezvous, so that test workers running side
by side share no port.
"""
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_play as D  # noqa: E402
from _torch_play import JAX_SCRIPT, assert_case  # noqa: E402

from repro_torch.dist import CrawlGroup  # noqa: E402

FIXTURE_TIMEOUT_S = 300
# the JAX package's records: two cases, one also writing the checkpoint
JAX_CASES = {
    "backlink": {"over": {}, "shards": 4, "ops": D.CASES["backlink"]["ops"]},
    "jax": {"over": D.OPIC_URL, "shards": 4,
            "ops": D.CASES["checkpoint"]["ops"]},
}
HELD_TO_JAX = {"backlink": "backlink", "checkpoint": "jax"}


def _join(ctxs, jax, jax_dir, deadline):
    """Wait for the JAX subprocess, then for every rank (they restore
    JAX's checkpoint last, once ``done`` marks it written), or fail."""
    try:
        out, err = jax.communicate(timeout=max(deadline - time.time(), 1))
    except subprocess.TimeoutExpired:
        jax.kill()
        out, err = jax.communicate()
    finally:
        (jax_dir / "done").touch()
    for ctx in ctxs:
        while not ctx.join(max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("a crawl group did not finish")
    if jax.returncode != 0 or "jax cases: OK" not in out:
        raise AssertionError(f"JAX:\n{out[-3000:]}\n{err[-3000:]}")


@pytest.fixture(scope="module")
def plays(tmp_path_factory):
    """Run the JAX subprocess and both groups side by side; meanwhile
    play every case in this process. Returns {"tmp", "ref"}."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("dist")
    jax_dir = tmp / "jax"
    jax_dir.mkdir()
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("REPRO_TELEMETRY", None)
    deadline = time.time() + FIXTURE_TIMEOUT_S
    jax = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(jax_dir),
         json.dumps(JAX_CASES)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=".", env=env)
    ctxs = []
    try:
        for w in D.WORLDS:
            (tmp / f"w{w}").mkdir()
            ctxs.append(mp.start_processes(
                D.rank_main, args=(w, str(tmp / f"w{w}"), str(jax_dir)),
                nprocs=w, join=False, start_method="spawn"))
        ref = {name: D.play(case, ckpt_root=str(tmp / "ref"), name=name,
                            mode="scan" if name == "eager_vs_scan" else None)
               for name, case in D.CASES.items()}
    except BaseException:
        jax.kill()
        raise
    _join(ctxs, jax, jax_dir, deadline)
    ref["restore_jax"] = D.play(D.RESTORE_JAX, ckpt_root=str(jax_dir))
    return {"tmp": tmp, "ref": ref}


def _rank_records(plays, world, name):
    out = plays["tmp"] / f"w{world}"
    errs = sorted(out.glob("error.r*.txt"))
    assert not errs, errs[0].read_text()
    return [dict(np.load(out / f"{name}.r{r}.npz")) for r in range(world)]


@pytest.mark.parametrize("world", D.WORLDS)
@pytest.mark.parametrize("name", sorted(D.CASES) + ["restore_jax"])
def test_group_equals_one_process(plays, world, name):
    """Every rank's reports and joined final state equal the one-process
    port's bit for bit (``restore_jax``: a JAX checkpoint restored and
    stepped through a dispatch in the group and in one process)."""
    for r, got in enumerate(_rank_records(plays, world, name)):
        D.assert_same(plays["ref"][name], got, f"W={world} rank {r} {name}")


@pytest.mark.parametrize("world", D.WORLDS)
@pytest.mark.parametrize("name", sorted(HELD_TO_JAX))
def test_group_held_to_jax(plays, world, name):
    """The group's records against the JAX package's 4-device records
    (``assert_case``: ints identical, f32 leaves to 8 ulp, cash to 1e-6)."""
    rec = _rank_records(plays, world, name)[0]
    sess = D.Played(rec, D.CASES[name])
    assert_case(str(plays["tmp"] / "jax" / f"{HELD_TO_JAX[name]}.npz"),
                sess, D.reports(rec, sess.cfg), f"W={world} {name}")


@pytest.mark.parametrize("world", D.WORLDS)
def test_jax_checkpoint_restores_into_group(plays, world):
    """JAX's checkpoint of the "checkpoint" case, restored into the group
    and stepped through the dispatch, meets JAX's own continuation."""
    rec = _rank_records(plays, world, "restore_jax")[0]
    sess = D.Played(rec, D.RESTORE_JAX)
    assert_case(str(plays["tmp"] / "jax" / "jax.npz"), sess,
                D.reports(rec, sess.cfg, rename={"run1": "run2"}),
                f"W={world} restore_jax")


@pytest.mark.parametrize("world", D.WORLDS)
def test_group_checkpoint_restores_in_one_process(plays, world):
    """The group's checkpoint holds the files a one-process session
    writes, and a one-process session restores it and steps as the
    group went on."""
    ckpt = plays["tmp"] / f"w{world}" / "ckpt" / "checkpoint"
    ref = plays["tmp"] / "ref" / "checkpoint"
    (step,) = os.listdir(ckpt)
    with np.load(ckpt / step / "arrays.npz") as a, \
            np.load(ref / step / "arrays.npz") as b:
        D.assert_same(dict(b), dict(a), f"W={world} checkpoint files")
    got = D.play({"over": D.OPIC_URL,
                  "ops": [["restore", "checkpoint"], ["run", 1]]},
                 ckpt_root=str(ckpt.parent))
    want = _rank_records(plays, world, "checkpoint")[0]
    want = {k.replace("run2.", "run1."): v for k, v in want.items()
            if not k.startswith("run0.")}
    D.assert_same(want, got, f"W={world} restored in one process")


REFUSALS = {"divide": "ValueError: a world of",
            "device_none": "RuntimeError: repro_torch runs on cuda"}


@pytest.mark.parametrize("world", D.WORLDS)
@pytest.mark.parametrize("what", sorted(REFUSALS))
def test_group_refuses(plays, world, what):
    """Under W > 1: a world that does not divide the shards and
    ``device=None`` on a rank without a card raise."""
    for r in range(world):
        got = json.loads((plays["tmp"] / f"w{world}" /
                          f"refusals.r{r}.json").read_text())[what]
        assert got.startswith(REFUSALS[what]), got


def test_one_process_group_is_the_transpose():
    """Without a process group the group is one process: the exchange
    over it is the one-card transpose, its gathers and sums the input."""
    from repro_torch.core import router as RT
    from repro_torch.launch.mesh import make_host_mesh
    g = CrawlGroup.current()
    assert (g.world, g.rank) == (1, 0)
    b = torch.arange(4 * 4 * 3 * 2).reshape(4, 4, 3, 2)
    assert torch.equal(RT.exchange(b, g), b.transpose(0, 1))
    assert g.gather(b) is b and g.split(4) == (4, 0)
    assert make_host_mesh() == {"data": 1, "model": 1}
    assert CrawlGroup(4, 2).split(4) == (1, 2)
    with pytest.raises(ValueError, match="does not divide"):
        CrawlGroup(3, 0).split(4)
    with pytest.raises(TypeError):
        g.sum_int(torch.ones(2))


def test_init_crawl_group_needs_a_card():
    """On cuda (the default) a rank without a card raises before any
    rendezvous."""
    from repro_torch.launch.mesh import init_crawl_group
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        init_crawl_group(None, rank=0, world_size=1, local_rank=0)
    assert not torch.distributed.is_initialized()


def test_build_lock_compiles_once(tmp_path):
    """Two processes reach a kernel's first build at once: one runs the
    compiler (a stub that counts its runs and copies a real shared
    library), the other waits on the lock, and both load the library."""
    lib = os.path.join(os.path.dirname(torch.__file__), "lib",
                       "libtorch_global_deps.so")
    (tmp_path / "bin").mkdir()
    stub = tmp_path / "bin" / "nvcc"
    count = tmp_path / "runs.txt"
    stub.write_text(
        f"#!{sys.executable}\n"
        "import os, shutil, sys, time\n"
        f"open({str(count)!r}, 'a').write(str(os.getpid()) + '\\n')\n"
        "time.sleep(1.0)\n"
        f"shutil.copy({lib!r}, sys.argv[sys.argv.index('-o') + 1])\n")
    stub.chmod(0o755)
    ctx = multiprocessing.get_context("spawn")
    barrier = ctx.Barrier(2)
    procs = [ctx.Process(target=D.build_main,
                         args=(barrier, str(tmp_path / "build"),
                               str(tmp_path), str(tmp_path / f"out{i}")))
             for i in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=120)
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    assert len(count.read_text().split()) == 1
    loaded = {(tmp_path / f"out{i}").read_text() for i in range(2)}
    assert len(loaded) == 1 and os.path.exists(loaded.pop())
    shutil.rmtree(tmp_path / "build")

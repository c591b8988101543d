"""Training on a train mesh, one process a card: the port's train step on
the (data, model) ``DeviceMesh`` of W gloo processes, its state placed by
the reference's rules (FSDP over "data", TP and EP over "model"), against
the one-process port under ``activation_mesh`` of the same shape and the
JAX package's SPMD step.

One spawn a world size (W = 2 and W = 4, ``tests/_torch_dist_train_play``)
plays every case of its world beside one JAX subprocess with 8 host
devices (the reference's SPMD step at (2, 2) for every family, and Qwen2's
at (1, 4), whose 2 KV heads the model axis splits; it also writes the
(2, 2) MoE state as a checkpoint). The families: the reduced f32
deepseek-moe-16b and qwen2-1.5b (LM), dcn-v2 and wide-deep (RecSys), the
GAT on the train CLI's graph (whole on every process) and on a batch of
molecule graphs (split over "data").

Tolerances, ``tests/test_torch_sharding.py``'s: loss within 1e-5, grad
norm within 1e-5 relative, parameters and optimizer moments within 2 *
lr with a mean difference within 1e-6 (gradients are summed across
processes in the collectives' order). One leaf is held to 2 * lr alone:
Qwen2's k bias ``attn/bk``, whose gradient is zero but for rounding (a k
bias shifts all of a query's scores alike, which the softmax cancels), so
AdamW's first step moves each element by about lr either way; its mean
difference measured 1.2e-6 against the one-process port at (2, 2). MoE
routes, slots and keeps, the sharded lookup (-0.0 included), a re-meshed
checkpoint and a JAX checkpoint placed on the mesh are held bit for bit;
the top-k weights within 16 f32 ulps of 1, their sum (each process's
router product has its own row count, so the logits, and a small weight,
may differ in the last bits).
"""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_train_play as D  # noqa: E402
from _torch_play import jax_env, niced  # noqa: E402

FIXTURE_TIMEOUT_S = 300
WORLDS = (2, 4)


@pytest.fixture(scope="module")
def plays(tmp_path_factory):
    """The JAX subprocess and both worlds side by side; meanwhile every
    case's one-process step here. Returns {"tmp", "jax", "ref"}."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("dist_train")
    params, jax_dir = tmp / "params", tmp / "jax"
    jax_dir.mkdir()
    D.write_params(str(params))
    env = jax_env(tmp)
    deadline = time.time() + FIXTURE_TIMEOUT_S
    jax = subprocess.Popen(
        [sys.executable, "-c", niced(D.JAX_SCRIPT), str(params),
         str(jax_dir), json.dumps(D.ARCHS), json.dumps(D.JAX_MESHES), str(D.TB),
         str(D.TS), str(D.RB), repr(D.LR)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=".", env=env)
    ctxs = []
    threads = torch.get_num_threads()
    try:
        for w in WORLDS:
            (tmp / f"w{w}").mkdir()
            ctxs.append(mp.start_processes(
                D.rank_main, args=(w, str(tmp / f"w{w}"), str(jax_dir)),
                nprocs=w, join=False, start_method="spawn"))
        # one thread: the ranks and the JAX subprocess share the cores
        torch.set_num_threads(1)
        ref = {D.case_name(f, m): D.one_process(f, m)
               for f, m in D.STEP_CASES}
        ref["gather_once"] = D.one_process("moe", (2, 2), microbatches=2)
        ref["adafactor"] = D.one_process("dense", (2, 2),
                                         optimizer="adafactor")
    except BaseException:
        jax.kill()
        raise
    finally:
        torch.set_num_threads(threads)
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
                raise TimeoutError("a train mesh did not finish")
    if jax.returncode != 0 or "jax train: OK" not in out:
        raise AssertionError(f"JAX:\n{out[-3000:]}\n{err[-3000:]}")
    return {"tmp": tmp, "jax": jax_dir, "ref": ref}


def _ranks(plays, world, name):
    out = plays["tmp"] / f"w{world}"
    errs = sorted(out.glob("error.r*.txt"))
    assert not errs, errs[0].read_text()
    return [dict(np.load(out / f"{name}.r{r}.npz")) for r in range(world)]


def _assert_step(loss, gnorm, state, want_loss, want_gnorm, want_state,
                 what):
    assert abs(loss - want_loss) <= 1e-5, (what, loss, want_loss)
    assert abs(gnorm / want_gnorm - 1) <= 1e-5, (what, gnorm, want_gnorm)
    assert sorted(state) == sorted(want_state), what
    for k, v in want_state.items():
        if v.dtype.kind != "f":
            np.testing.assert_array_equal(state[k], v, err_msg=k)
            continue
        diff = np.abs(state[k].astype(np.float64) - v)
        assert diff.max() <= 2 * D.LR, (what, k, diff.max())
        if not k.endswith("attn/bk"):
            assert diff.mean() <= 1e-6, (what, k, diff.mean())


def _state(rec):
    return {k[len("state/"):]: v for k, v in rec.items()
            if k.startswith("state/")}


@pytest.mark.parametrize("fam,mesh", D.STEP_CASES,
                         ids=[D.case_name(*c) for c in D.STEP_CASES])
def test_mesh_step_equals_one_process(plays, fam, mesh):
    """Each rank's loss, grad norm and joined state after one AdamW step
    on the mesh against the one-process port's under the mesh's shape;
    every rank reports the same loss."""
    recs = _ranks(plays, mesh[0] * mesh[1], D.case_name(fam, mesh))
    loss, gnorm, state, _ = plays["ref"][D.case_name(fam, mesh)]
    for r, rec in enumerate(recs):
        _assert_step(float(rec["loss"]), float(rec["gnorm"]), _state(rec),
                     loss, gnorm, state, f"{fam} {mesh} rank {r}")
        assert rec["loss"] == recs[0]["loss"]


JAX_CASES = [(f, tuple(m)) for f, ms in D.JAX_MESHES.items() for m in ms]


@pytest.mark.parametrize("fam,mesh", JAX_CASES,
                         ids=[D.case_name(*c) for c in JAX_CASES])
def test_mesh_step_held_to_jax_spmd(plays, fam, mesh):
    """Rank 0's step on the mesh against the JAX package's SPMD step on a
    mesh of the same shape (its MoE routes each device's own tokens)."""
    rec = _ranks(plays, mesh[0] * mesh[1], D.case_name(fam, mesh))[0]
    ref = dict(np.load(plays["jax"] / f"{D.case_name(fam, mesh)}.npz"))
    _assert_step(float(rec["loss"]), float(rec["gnorm"]), _state(rec),
                 float(ref["loss"]), float(ref["gnorm"]), _state(ref),
                 f"{fam} {mesh} vs JAX")


MOE_MESHES = [m for f, m in D.STEP_CASES if f == "moe"]


@pytest.mark.parametrize("mesh", MOE_MESHES,
                         ids=[f"{m[0]}x{m[1]}" for m in MOE_MESHES])
def test_moe_routes_equal_one_process_groups(plays, mesh):
    """Process (i, j) routes group i * tp + j of the one-process grouped
    routing: equal experts, slots and keeps in every layer; top-k weights
    within 16 f32 ulps of their sum, 1."""
    recs = _ranks(plays, mesh[0] * mesh[1], D.case_name("moe", mesh))
    calls = plays["ref"][D.case_name("moe", mesh)][3]
    assert len(calls) == sum(k.endswith("/e") for k in recs[0])
    for layer, (w, e, slot, keep) in enumerate(calls):
        for g, rec in enumerate(recs):
            key = f"route{layer}/"
            np.testing.assert_array_equal(rec[key + "e"][0], e[g])
            np.testing.assert_array_equal(rec[key + "slot"][0], slot[g])
            np.testing.assert_array_equal(rec[key + "keep"][0], keep[g])
            np.testing.assert_array_less(
                np.abs(rec[key + "w"][0] - w[g]), 16 * np.spacing(
                    np.float32(1)))


def test_gather_once_with_microbatches(plays):
    """Two microbatches with ``param_resharding=trainer.gather_once`` (the
    parameters joined over "data" once, gradients reduced once) against
    the one-process port's two microbatches."""
    loss, gnorm, state, _ = plays["ref"]["gather_once"]
    for r, rec in enumerate(_ranks(plays, 4, "gather_once")):
        _assert_step(float(rec["loss"]), float(rec["gnorm"]), _state(rec),
                     loss, gnorm, state, f"gather_once rank {r}")


def test_microbatches_on_the_mesh(plays):
    """Two microbatches without the gather-once layout (each layer joined
    in each microbatch, its gradient reduce-scattered there) against the
    one-process port's two microbatches."""
    loss, gnorm, state, _ = plays["ref"]["gather_once"]
    for r, rec in enumerate(_ranks(plays, 4, "microbatches")):
        _assert_step(float(rec["loss"]), float(rec["gnorm"]), _state(rec),
                     loss, gnorm, state, f"microbatches rank {r}")


@pytest.mark.parametrize("fam", ["dense", "moe"])
def test_fsdp_releases_each_layer(plays, fam):
    """At (4, 1), where the data axis splits the parameters, no process
    holds the layers joined when the forward ends (remat off: the saved
    weights are kept as blocks and joined again in the backward; remat
    on: recomputed): at most the global leaves' joined bytes are alive,
    less than the whole tree's. The step's loss and grad norm are the
    same bits with remat off and on."""
    for r, rec in enumerate(_ranks(plays, 4, f"release_{fam}")):
        assert int(rec["globals"]) < int(rec["whole"])
        for remat in (0, 1):
            assert int(rec[f"remat{remat}/alive"]) <= int(rec["globals"]), \
                (r, remat, int(rec[f"remat{remat}/alive"]))
        assert rec["remat0/loss"] == rec["remat1/loss"]
        assert rec["remat0/gnorm"] == rec["remat1/gnorm"]


def test_adafactor_on_the_mesh(plays):
    """Adafactor's factored moments placed by ``opt_state_specs`` and its
    row and column means taken over split dims."""
    loss, gnorm, state, _ = plays["ref"]["adafactor"]
    for r, rec in enumerate(_ranks(plays, 4, "adafactor")):
        _assert_step(float(rec["loss"]), float(rec["gnorm"]), _state(rec),
                     loss, gnorm, state, f"adafactor rank {r}")


def test_sharded_lookup_bit_equal(plays):
    """Each model process gathers its row range and the axis adds the
    parts: the lookup's bits (a row of -0.0 included)."""
    for rec in _ranks(plays, 4, "lookup"):
        assert rec["got"].tobytes() == rec["want"].tobytes()


def test_constrain_redistributes_on_the_mesh(plays):
    """``constrain(x, None, "tp")`` of a DTensor split over "data" gives
    it the pattern's placement (a dim of 3 under a model axis of 2 left
    whole, as ``_guard`` leaves it); a plain tensor is returned as it
    is."""
    for rec in _ranks(plays, 4, "constrain"):
        assert str(rec["y_spec"]) == "(None, 'model')"
        assert str(rec["z_spec"]) == "(None, None)"
        assert bool(rec["y_full_equal"]) and bool(rec["plain_same"])


@pytest.mark.parametrize("mesh", D.REMESH,
                         ids=[f"{m[0]}x{m[1]}" for m in D.REMESH])
def test_elastic_remesh_restores_bit_equal(plays, mesh):
    """The (2, 2) state saved and restored onto another mesh
    (``checkpoint.restore(..., shardings=)``), and placed there live
    (``fault.reshard(tree, mesh, specs)``): every leaf's bits, and one
    more step gives a finite loss, the same on every rank."""
    recs = _ranks(plays, 4, "remesh")
    tag = D.case_name("remesh", mesh)
    assert all(bool(rec[tag + "/equal"]) for rec in recs)
    assert all(bool(rec[tag + "/reshard_equal"]) for rec in recs)
    losses = {float(rec[tag + "/loss"]) for rec in recs}
    assert len(losses) == 1 and np.isfinite(losses.pop())


def test_jax_checkpoint_placed_on_the_mesh(plays):
    """JAX's (2, 2) state, restored onto the port's (2, 2) mesh, joined
    back: bit for bit."""
    want = _state(dict(np.load(plays["jax"] / "moe_2x2.npz")))
    for rec in _ranks(plays, 4, "jax_ckpt"):
        got = _state(rec)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert got[k].tobytes() == v.tobytes(), k


def test_train_cli_on_the_mesh(plays):
    """``launch.train`` with ``--model-parallel 2`` in a group of 4: it
    trains on the pages a one-process crawl of 4 shards fetches (every
    page once, in the same order, on every rank) and checkpoints;
    ``--model-parallel 3`` raises."""
    from repro_torch.api import CrawlSession
    from repro_torch.configs import get_reduced
    want = CrawlSession(get_reduced("webparf"), "cpu",
                        n_shards=4).run(D.CLI_CRAWL).urls
    for rec in _ranks(plays, 4, "cli"):
        np.testing.assert_array_equal(rec["urls"], want)
        assert int(rec["loss_steps"]) == 2 and bool(rec["params_finite"])
        assert "model=3 does not divide" in str(rec["refused"])

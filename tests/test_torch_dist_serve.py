"""LM serving on a serving mesh, one process a card: the port's
``prefill_step`` and ``decode_step`` on the (data, model) ``DeviceMesh``
of W gloo processes, the parameters placed by the reference's
``lm_specs`` and the KV cache by its decode cell's specs
(``rules.cache_specs``: the rows over "data" and the sequence over
"model", or with fewer rows than data processes the sequence over every
axis), against the one-process port under ``activation_mesh`` of the same
shape and the JAX package's sharded steps.

One spawn a world size (W = 2: meshes (2, 1), (1, 2); W = 4: (4, 1), (2,
2), (1, 4); ``tests/_torch_dist_serve_play``) plays every case of its
world beside one JAX subprocess with 8 host devices (the reference's
``prefill_step`` and ``decode_step`` jitted with the cell's in-shardings
on (2, 2) at batch 4 and (1, 4) at batch 1). Each case: the reduced f32
qwen2-1.5b (2 KV heads: split by the model axis at 2, joined whole at 4)
or deepseek-moe-16b, batch 1 and 4, a 28-token prompt in a cache of 64
slots, then 8 decode steps whose slots cross slot 32 (a segment boundary
at 2 and 4 parts) while the last segment of 4 is still empty.

Tolerances: logits within 1e-5 of the one-process port (the mesh adds
f32 partial sums in the collectives' order and normalises decode
attention after its merge), each rank's cache block within 1e-5 of the
matching slice of the one-process cache, MoE routes (experts, slots,
keeps) bit for bit (prefill: the process's group of the one-process
grouped routing; decode: one group of every token at a model axis > 1,
the data process's group at 1); against JAX 1e-4, as
``tests/test_torch_lm.py`` holds f32 prefill and decode.
"""
import json
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_dist_serve_play as D  # noqa: E402
from _torch_play import jax_env, niced  # noqa: E402

FIXTURE_TIMEOUT_S = 300
WORLDS = (2, 4)
MESH_TOL = 1e-5
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def plays(tmp_path_factory):
    """The JAX subprocess and both worlds side by side; meanwhile every
    case's one-process run here. Returns {"tmp", "jax", "ref"}."""
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("dist_serve")
    params, jax_dir = tmp / "params", tmp / "jax"
    jax_dir.mkdir()
    D.write_params(str(params))
    deadline = time.time() + FIXTURE_TIMEOUT_S
    jax = subprocess.Popen(
        [sys.executable, "-c", niced(D.JAX_SCRIPT), str(params),
         str(jax_dir), json.dumps(D.ARCHS), json.dumps(D.JAX_CASES),
         str(D.P), str(D.M), str(D.GEN)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=".", env=jax_env(tmp))
    ctxs = []
    threads = torch.get_num_threads()
    try:
        for w in WORLDS:
            (tmp / f"w{w}").mkdir()
            ctxs.append(mp.start_processes(
                D.rank_main, args=(w, str(tmp / f"w{w}")), nprocs=w,
                join=False, start_method="spawn"))
        torch.set_num_threads(1)
        ref = {D.case_name(*c): D.one_process(*c)
               for w in WORLDS for c in D.cases(w)}
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
    for ctx in ctxs:
        while not ctx.join(max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("a serving mesh did not finish")
    if jax.returncode != 0 or "jax serve: OK" not in out:
        raise AssertionError(f"JAX:\n{out[-3000:]}\n{err[-3000:]}")
    return {"tmp": tmp, "jax": jax_dir, "ref": ref}


def _ranks(plays, world, name):
    out = plays["tmp"] / f"w{world}"
    errs = sorted(out.glob("error.r*.txt"))
    assert not errs, errs[0].read_text()
    return [dict(np.load(out / f"{name}.r{r}.npz")) for r in range(world)]


ALL = [(w, c) for w in WORLDS for c in D.cases(w)]
IDS = [D.case_name(*c) for _, c in ALL]


@pytest.mark.parametrize("world,case", ALL, ids=IDS)
def test_attention_head_dim_contiguous(plays, world, case):
    """Every prefill attention on every rank gets q, k and v whose head
    dim is contiguous, as the card's flash kernels require (Qwen2's 2 KV
    heads joined whole over a model axis of 4 included)."""
    for r, rec in enumerate(_ranks(plays, world, D.case_name(*case))):
        strides = rec["attention_head_strides"]
        assert strides.shape[0] > 0 and (strides == 1).all(), (r, strides)


@pytest.mark.parametrize("world,case", ALL, ids=IDS)
def test_logits_match_one_process(plays, world, case):
    """Prefill's and every decode step's logits of each rank's rows within
    1e-5 of the one-process port's."""
    ref = plays["ref"][D.case_name(*case)]
    for r, rec in enumerate(_ranks(plays, world, D.case_name(*case))):
        lo, hi = rec["rows"]
        for i in range(D.GEN + 1):
            got, want = rec[f"logits{i}"], ref[f"logits{i}"][lo:hi]
            assert got.shape == want.shape, (r, i, got.shape)
            err = float(np.abs(got - want).max())
            assert err <= MESH_TOL, (case, r, i, err)


@pytest.mark.parametrize("world,case", ALL, ids=IDS)
def test_cache_blocks_are_slices_of_one_process(plays, world, case):
    """Each rank's cache block (after the 8 decode steps) is the matching
    slice of the one-process cache, rows and sequence as the decode
    cell's specs place them; the lengths equal."""
    ref = plays["ref"][D.case_name(*case)]
    for r, rec in enumerate(_ranks(plays, world, D.case_name(*case))):
        (b0, b1), (h0, h1), (s0, s1), _ = rec["kv_slices"]
        for name in ("main_k", "main_v", "prefix_k", "prefix_v"):
            key = "cache/" + name
            if key not in ref:
                continue
            want = ref[key][:, b0:b1, h0:h1, s0:s1]
            assert rec[key].shape == want.shape, (r, name)
            assert float(np.abs(rec[key] - want).max()) <= MESH_TOL, \
                (case, r, name)
        np.testing.assert_array_equal(rec["cache/length"],
                                      ref["cache/length"][b0:b1])


def test_segments_cross_and_one_is_empty(plays):
    """The cases reach what they claim: at 4 sequence parts the decode
    slots 28-35 write the segments [16, 32) and [32, 48), and [48, 64)
    holds nothing; at 2 parts segment [32, 64) is empty before slot 32."""
    recs = _ranks(plays, 4, D.case_name("dense", (1, 4), 1))
    spans = [tuple(r["kv_slices"][2]) for r in recs]
    assert spans == [(0, 16), (16, 32), (32, 48), (48, 64)]
    assert not np.any(recs[3]["cache/main_k"])
    assert np.any(recs[2]["cache/main_k"][..., :4, :])
    assert not np.any(recs[2]["cache/main_k"][..., 4:, :])
    recs = _ranks(plays, 2, D.case_name("dense", (1, 2), 4))
    assert [tuple(r["kv_slices"][2]) for r in recs] == [(0, 32), (32, 64)]
    assert "'data', 'model'" in str(_ranks(
        plays, 4, D.case_name("dense", (2, 2), 1))[0]["layout"])


@pytest.mark.parametrize("world,case",
                         [(w, c) for w, c in ALL if c[0] == "moe"],
                         ids=[D.case_name(*c) for _, c in ALL
                              if c[0] == "moe"])
def test_moe_routes_bit_equal(plays, world, case):
    """Every MoE call's experts, slots and keeps on each rank equal the
    one-process port's routing of the same tokens: its group of a grouped
    call, the one group otherwise (decode at a model axis > 1, or fewer
    rows than data processes)."""
    ref = plays["ref"][D.case_name(*case)]
    n = len([k for k in ref if k.endswith("/e")])
    assert n > 0
    for r, rec in enumerate(_ranks(plays, world, D.case_name(*case))):
        g = int(rec["group"])
        for i in range(n):
            for name in ("e", "slot", "keep"):
                want, got = ref[f"route{i}/{name}"], rec[f"route{i}/{name}"]
                assert got.shape[0] == 1, (r, i)
                grp = want[g] if want.shape[0] > 1 else want[0]
                np.testing.assert_array_equal(got[0], grp,
                                              err_msg=f"{case} r{r} {i}")


@pytest.mark.parametrize("case", [(m, b) for m, b in D.JAX_CASES],
                         ids=[f"{m[0]}x{m[1]}_b{b}" for m, b in D.JAX_CASES])
@pytest.mark.parametrize("fam", sorted(D.ARCHS))
def test_rank0_matches_jax_sharded_steps(plays, fam, case):
    """Rank 0's logits against the reference's ``prefill_step`` and
    ``decode_step`` jitted with the cell's in-shardings on the same mesh,
    within f32's 1e-4."""
    mesh, b = case
    name = D.case_name(fam, tuple(mesh), b)
    want = dict(np.load(plays["jax"] / f"{name}.npz"))
    rec = _ranks(plays, 4, name)[0]
    lo, hi = rec["rows"]
    for i in range(D.GEN + 1):
        err = float(np.abs(rec[f"logits{i}"] - want[f"logits{i}"][lo:hi])
                    .max())
        assert err <= JAX_TOL, (name, i, err)


def _merged(q, k, v, n, parts):
    """Decode attention over ``parts`` segments of the cache, each a
    ``decode_attention_partial``, merged as ``spmd.merge_softmax`` merges
    them over a mesh (max, rescale, sum, normalise), in the cache's
    dtype."""
    from repro_torch.models import layers as L
    S = k.shape[2]
    seg = S // parts
    got = []
    for i in range(parts):
        slots = i * seg + torch.arange(seg)
        valid = slots[None, :] < n.reshape(-1, 1)
        got.append(L.decode_attention_partial(
            q, k[:, :, i * seg:(i + 1) * seg], v[:, :, i * seg:(i + 1) * seg],
            valid))
    m = torch.stack([g[0] for g in got]).amax(0)
    scale = [torch.exp(g[0] - m) for g in got]
    lsum = sum(g[1] * s for g, s in zip(got, scale))
    acc = sum(g[2] * s for g, s in zip(got, scale))
    B, Hq, _, hd = q.shape
    return (acc / lsum).reshape(B, Hq, 1, hd).to(v.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [8000, 3000])        # 3000: two empty parts
def test_merged_decode_attention_within_stated_bound(dtype, n):
    """The mesh's decode attention (per-segment partial results, merged)
    against one card's ``decode_attention``. f32: within 1e-5 (the order
    of the sums). bf16: one card rounds p / l to bf16 before its product
    with v and the merge normalises after the sum, so the worst case is
    2^-8 max|v| (p / l's rounding over the output) + 2^-7 |want| (each
    output's own bf16 rounding): ``chip_smoke.ds_decode_tol``. Measured
    here: 0.0118 (n 8000) and 0.0236 (n 3000) of it; held to 0.08. Over
    many slots the worst case outgrows the output itself, so the error's
    norm is also held to 2^-6 of the output's (``chip_smoke.DS_DECODE_REL``,
    which holds long_500k's layer 0 on four cards; measured here 0.0026
    / 0.0025), and a merge that leaves out the last segment holding valid
    slots (0.54 / 0.74 here) must fail it."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(5)
    dt = getattr(torch, dtype)
    B, Hkv, grp, S, hd = 2, 2, 4, 8192, 64
    q = torch.randn(B, Hkv * grp, 1, hd, generator=g).to(dt)
    k = torch.randn(B, Hkv, S, hd, generator=g).to(dt)
    v = torch.randn(B, Hkv, S, hd, generator=g).to(dt)
    nn = torch.full((B,), n, dtype=torch.int32)
    want = L.decode_attention(q, k, v, nn).float()
    got = _merged(q, k, v, nn, 4).float()
    assert torch.isfinite(got).all()
    if dtype == "float32":
        assert float((got - want).abs().max()) <= 1e-5
        return
    vmax = float(v[:, :, :n].float().abs().max())
    tol = 2.0 ** -8 * vmax + 2.0 ** -7 * want.abs()
    share = float(((got - want).abs() / tol).max())
    assert share <= 0.08, share
    assert float((got - want).norm() / want.norm()) <= 2.0 ** -6
    seg = S // 4
    short = torch.full((B,), (n - 1) // seg * seg, dtype=torch.int32)
    planted = L.decode_attention(q, k, v, short).float()
    assert float((planted - want).norm() / want.norm()) > 2.0 ** -6

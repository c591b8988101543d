"""The mesh paths' single-card meaning, against the JAX reference on a mesh.

One JAX subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=8``)
writes an ``.npz`` a case:

- ``moe_block`` under ``activation_mesh`` of (2, 2) and (4, 2) meshes, so
  it takes ``_moe_spmd`` (each (data, model) shard routes its own block of
  tokens with its own capacity), for the reduced f32 deepseek-moe-16b and
  arctic-480b at capacity factors 1.25 and 0.5; each shard's routes come
  back through a ``jax.debug.callback`` spy on ``moe_dispatch`` that
  carries the shard's axis indices. The port's ``moe_block`` under
  ``sharding.rules.activation_mesh`` of the same shape (``_moe_grouped``)
  must give equal experts, slots and keeps in every group, top-k weights
  within 16 f32 ulps and outputs within 1e-5 (``test_torch_moe.py``'s f32
  bounds), and ``aux`` within 4 ulps. Drops happen at 0.5.
- one ``lm_loss`` AdamW step of the reduced f32 deepseek-moe-16b, sharded
  on a (4, 2) mesh (the reference's ``tests/test_sharding_spmd.py``); then
  its state saved, restored onto a (2, 4) mesh and stepped once more (the
  elastic re-mesh). The port restores the same checkpoint
  (``checkpoint.restore`` + ``fault.reshard``) equal bit for bit and takes
  the step under ``activation_mesh`` of (2, 4).

Tolerances of the train steps: loss within 1e-5, grad norm within 1e-5
relative, parameters within 2 * lr (AdamW's first steps move a leaf by
about lr whatever its gradient's size, so a gradient of pure rounding
noise may move it either way) and their mean difference within 1e-6.
Measured on the CPU: the (4, 2) step's largest difference 6.15e-6 in
``layers/moe/w_gate``, the re-meshed (2, 4) step's 2.09e-7 in
``layers/moe/w_up``, the largest mean 2.8e-9 (``prefix/0/ln1``).

``test_state_specs_match_reference``: every model arch's parameter and
optimizer-state specs (``lm_specs`` / ``recsys_specs`` / ``gnn_specs``,
``opt_state_specs``, ``drop_fsdp``), built on meta at the published
configs, equal the reference's from the same subprocess on five mesh
shapes (``jax.sharding.AbstractMesh``: no devices needed).
"""
import dataclasses
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_play import jax_env, niced  # noqa: E402

from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.configs.base import scaled  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402
from repro_torch.train import fault  # noqa: E402
from repro_torch.train import trainer as TTR  # noqa: E402

ARCHS = ("deepseek-moe-16b", "arctic-480b")
MESHES = ((2, 2), (4, 2))
FACTORS = (1.25, 0.5)
CASES = [(a, m, f) for a in ARCHS for m in MESHES for f in FACTORS]
B, S = 8, 64                   # (2, 2): 128 tokens a group; (4, 2): 64
TB, TS = 8, 16                 # the train step's batch
LR = 1e-3
BLOCK_TOL = 1e-5


# spec parity: every model arch's state specs, the rules' meshes and the
# production pod's, compared as tuples from the same JAX subprocess
SPEC_ARCHS = ("qwen2-1.5b", "phi3-mini-3.8b", "deepseek-coder-33b",
              "deepseek-moe-16b", "arctic-480b", "bert4rec", "dien",
              "wide-deep", "dcn-v2", "gat-cora")
SPEC_MESHES = {
    "4x2": ((4, 2), ("data", "model")),
    "2x4": ((2, 4), ("data", "model")),
    "pod2x2x2": ((2, 2, 2), ("pod", "data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}

# train cells whose in/out shardings launch/specs.build_cell names
SPEC_CELLS = (("qwen2-1.5b", "train_4k"), ("deepseek-moe-16b", "train_4k"),
              ("dcn-v2", "train_batch"), ("gat-cora", "full_graph_sm"))


def case_name(arch, mesh, cf):
    return f"{arch}_{mesh[0]}x{mesh[1]}_{cf}"


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    import dataclasses, json, sys
    sys.path.insert(0, "src")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax import lax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import make_mesh
    from repro.configs import get_reduced
    from repro.configs.base import scaled
    from repro.models import layers as L
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.sharding import rules
    from repro.train import checkpoint as CK
    from repro.train.trainer import TrainState, init_train_state, \\
        make_train_step

    out, cases = sys.argv[1], json.loads(sys.argv[2])
    B, S, TB, TS, LR = (float(v) if "." in v else int(v)
                        for v in sys.argv[3:8])
    orig = L.moe_dispatch
    routes = {}

    def store(w, e, s, k, aux, i, j):
        routes[(int(i), int(j))] = tuple(np.asarray(a) for a in
                                         (w, e, s, k, aux))

    def spy(logits, m, capacity):
        r = orig(logits, m, capacity)
        jax.debug.callback(store, *r, lax.axis_index("data"),
                           lax.axis_index("model"))
        return r

    def flat(tree):
        return {k: np.asarray(v) for k, v in CK._flatten(tree).items()}

    for arch, (dp, tp), cf in cases:
        cfg = scaled(get_reduced(arch), dtype="float32")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cf))
        p = L.init_moe(jax.random.PRNGKey(1), cfg, jnp.float32)
        x = np.random.default_rng(2).standard_normal(
            (B, S, cfg.d_model)).astype(np.float32)
        mesh = make_mesh((dp, tp), ("data", "model"))
        routes.clear()
        L.moe_dispatch = spy
        with mesh, rules.activation_mesh(mesh):
            o, aux = jax.jit(lambda p, x: L.moe_block(p, cfg, x,
                                                      n_groups=1))(p, x)
            o = np.asarray(o)
        L.moe_dispatch = orig
        assert sorted(routes) == [(i, j) for i in range(dp)
                                  for j in range(tp)], sorted(routes)
        rec = {"x": x, "out": o, "aux": np.asarray(aux)}
        for n, name in enumerate(("w", "e", "slot", "keep", "aux_g")):
            rec[name] = np.stack([routes[(i, j)][n][0] if name != "aux_g"
                                  else routes[(i, j)][n]
                                  for i in range(dp) for j in range(tp)])
        rec.update({"p/" + k: v for k, v in flat(p).items()})
        np.savez(os.path.join(out, f"{arch}_{dp}x{tp}_{cf}.npz"), **rec)
        print("case", arch, dp, tp, cf, flush=True)

    # ---- one sharded train step on (4, 2), then the elastic re-mesh ----
    cfg = scaled(get_reduced("deepseek-moe-16b"), dtype="float32")
    params = jax.jit(lambda k: T.init_lm(k, cfg))(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (TB, TS)).astype(np.int32)
    labels = np.roll(tokens, -1, 1)
    opt = adamw(lr=LR)
    state = jax.jit(lambda p: init_train_state(p, opt))(params)
    step = make_train_step(
        lambda p, b: T.lm_loss(p, cfg, b["tokens"], b["labels"],
                               n_groups=4), opt)

    def sharded(mesh):
        pspec = rules.lm_specs(jax.eval_shape(lambda: params), mesh)
        ospec = rules.opt_state_specs(state.opt_state, pspec, mesh)
        sspec = TrainState(pspec, ospec, NamedSharding(mesh, P()))
        bspec = {k: NamedSharding(mesh, P("data", None))
                 for k in ("tokens", "labels")}
        return sspec, bspec

    mesh = make_mesh((4, 2), ("data", "model"))
    batch = {"tokens": tokens, "labels": labels}
    with mesh, rules.activation_mesh(mesh):
        sspec, bspec = sharded(mesh)
        st1, m1 = jax.jit(step, in_shardings=(sspec, bspec))(
            jax.device_put(state, sspec), jax.device_put(batch, bspec))
    CK.save(os.path.join(out, "ckpt"), 1, st1)
    mesh2 = make_mesh((2, 4), ("data", "model"))
    sspec2, bspec2 = sharded(mesh2)
    restored = CK.restore(os.path.join(out, "ckpt"), st1, shardings=sspec2)
    with mesh2, rules.activation_mesh(mesh2):
        st2, m2 = jax.jit(step, in_shardings=(sspec2, bspec2))(
            restored, jax.device_put(batch, bspec2))
    np.savez(os.path.join(out, "train.npz"), tokens=tokens, labels=labels,
             **{"params0/" + k: v for k, v in flat(params).items()},
             **{"state1/" + k: v for k, v in flat(st1).items()},
             **{"state2/" + k: v for k, v in flat(st2).items()},
             loss1=np.asarray(m1["loss"]), gnorm1=np.asarray(m1["grad_norm"]),
             loss2=np.asarray(m2["loss"]), gnorm2=np.asarray(m2["grad_norm"]))

    # ---- spec parity: every arch's state specs on five mesh shapes ----
    from jax.sharding import AbstractMesh
    from repro.configs import get_arch
    from repro.launch import specs as LS
    from repro.models import gnn as G
    from repro.models import recsys as R
    spec_archs, spec_meshes = json.loads(sys.argv[8]), json.loads(sys.argv[9])

    def paths(tree):
        leaves = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, NamedSharding))[0]
        return {"/".join(CK._fmt(q) for q in path):
                [list(a) if isinstance(a, tuple) else a for a in ns.spec]
                for path, ns in leaves}

    key = jax.random.PRNGKey(0)
    specs = {}
    for arch in spec_archs:
        acfg = get_arch(arch)[0]
        if acfg.family == "lm":
            aopt, fn = LS._lm_optimizer(acfg), rules.lm_specs
            init = lambda: T.init_lm(key, acfg)
        elif acfg.family == "recsys":
            aopt, fn = adamw(lr=1e-3), rules.recsys_specs
            init = lambda: R.INIT[acfg.kind](key, acfg)
        else:
            aopt, fn = adamw(lr=5e-3), rules.gnn_specs
            init = lambda: G.init_gat(key, acfg, 32, 7)
        st = jax.eval_shape(lambda: init_train_state(init(), aopt))
        specs[arch] = {}
        for name, (sizes, axes) in spec_meshes.items():
            m = AbstractMesh(tuple(sizes), tuple(axes))
            ps = fn(st.params, m)
            specs[arch][name] = {
                "params": paths(ps),
                "opt_state": paths(rules.opt_state_specs(st.opt_state, ps,
                                                         m)),
                "drop_fsdp": paths(rules.drop_fsdp(ps, m))}
    # the train cells' shardings (launch/specs.build_cell on the pod)
    pod = AbstractMesh((16, 16), ("data", "model"))
    cells = {}
    for arch, shape in json.loads(sys.argv[10]):
        c = LS.build_cell(arch, shape, pod)
        bleaves = jax.tree_util.tree_leaves(
            c.in_shardings[1], is_leaf=lambda x: isinstance(x, NamedSharding))
        cells[f"{arch}/{shape}"] = {
            "state": paths(c.in_shardings[0]),
            "out_state": paths(c.out_shardings[0]),
            "batch": [[list(a) if isinstance(a, tuple) else a
                       for a in ns.spec] for ns in bleaves],
            "microbatches": c.meta.get("microbatches")}
    specs["cells"] = cells
    with open(os.path.join(out, "specs.json"), "w") as f:
        json.dump(specs, f)
    print("jax sharding: OK", flush=True)
""")


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    """Every case's JAX reference, from one subprocess."""
    out = tmp_path_factory.mktemp("jax_sharding")
    env = jax_env(out)
    r = subprocess.run(
        [sys.executable, "-c", niced(JAX_SCRIPT), str(out),
         json.dumps(CASES), str(B), str(S), str(TB), str(TS), repr(LR),
         json.dumps(SPEC_ARCHS), json.dumps(SPEC_MESHES),
         json.dumps(SPEC_CELLS)],
        capture_output=True, text=True, timeout=600, cwd=".", env=env)
    if r.returncode != 0 or "jax sharding: OK" not in r.stdout:
        raise AssertionError(f"STDOUT:\n{r.stdout[-3000:]}\n"
                             f"STDERR:\n{r.stderr[-3000:]}")
    return out


def moe_cfg(arch, cf):
    cfg = scaled(get_reduced(arch), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def port_moe(cfg, flat):
    """The port's ``MoE`` holding the reference's ``init_moe`` leaves."""
    p = TL.MoE(cfg, torch.float32, "cpu")
    with torch.no_grad():
        for key, v in flat.items():
            obj = p
            *path, leaf = key.split("/")
            for part in path:
                obj = getattr(obj, part)
            getattr(obj, leaf).copy_(torch.from_numpy(v))
    return p


def spy_dispatch(fn):
    """``fn()`` with ``layers.moe_dispatch`` spied on: (its result, each
    call's (w, e, slot, keep))."""
    got, orig = [], TL.moe_dispatch

    def spy(logits, m, capacity):
        out = orig(logits, m, capacity)
        got.append(tuple(t.detach().numpy() for t in out[:4]))
        return out
    TL.moe_dispatch = spy
    try:
        return fn(), got
    finally:
        TL.moe_dispatch = orig


@pytest.mark.parametrize("arch,mesh,cf", CASES,
                         ids=[case_name(*c) for c in CASES])
def test_grouped_moe_matches_moe_spmd(jax_ref, arch, mesh, cf):
    ref = np.load(jax_ref / f"{case_name(arch, mesh, cf)}.npz")
    cfg = moe_cfg(arch, cf)
    p = port_moe(cfg, {k[2:]: ref[k] for k in ref.files
                       if k.startswith("p/")})
    x = torch.from_numpy(ref["x"])
    with rules.activation_mesh({"data": mesh[0], "model": mesh[1]}):
        (out, aux), calls = spy_dispatch(
            lambda: TL.moe_block(p, cfg, x))
    assert len(calls) == 1
    w, e, slot, keep = calls[0]
    G = mesh[0] * mesh[1]
    assert e.shape == ref["e"].shape == (G, B * S // G, cfg.moe.top_k)
    np.testing.assert_array_equal(e, ref["e"])
    np.testing.assert_array_equal(slot, ref["slot"])
    np.testing.assert_array_equal(keep, ref["keep"])
    np.testing.assert_array_less(
        np.abs(w - ref["w"]), 16 * np.spacing(np.abs(ref["w"])) + 1e-30)
    np.testing.assert_allclose(out.numpy(), ref["out"], rtol=0,
                               atol=BLOCK_TOL)
    want = np.float32(ref["aux"])
    assert abs(np.float32(aux.item()) - want) <= 4 * np.spacing(want), \
        (aux.item(), want)
    if cf == 0.5:
        assert not keep.all(), "no assignment dropped at capacity 0.5"


def test_grouped_routing_differs_from_local(jax_ref):
    """The groups' capacities are not the whole batch's: at 0.5 the local
    path (no mesh) drops another set of assignments, as the reference's
    ``_moe_local`` does against ``_moe_spmd``."""
    arch, mesh, cf = ARCHS[0], MESHES[1], 0.5
    ref = np.load(jax_ref / f"{case_name(arch, mesh, cf)}.npz")
    cfg = moe_cfg(arch, cf)
    p = port_moe(cfg, {k[2:]: ref[k] for k in ref.files
                       if k.startswith("p/")})
    x = torch.from_numpy(ref["x"])
    (out, _), calls = spy_dispatch(lambda: TL.moe_block(p, cfg, x))
    keep_local = calls[0][3]
    assert keep_local.shape == (1, B * S, cfg.moe.top_k)
    assert keep_local.sum() != ref["keep"].sum() or \
        not np.allclose(out.numpy(), ref["out"], atol=BLOCK_TOL)
    # decode (S = 1) under a model axis > 1 takes the local path
    with rules.activation_mesh({"data": 2, "model": 2}):
        _, calls = spy_dispatch(lambda: TL.moe_block(p, cfg, x[:, :1]))
    assert calls[0][1].shape == (1, B, cfg.moe.top_k)


def _train_params(ref, prefix):
    return {k[len(prefix):]: torch.from_numpy(ref[k]) for k in ref.files
            if k.startswith(prefix)}


def _assert_state(got, ref, prefix):
    for k, v in got.items():
        want = ref[prefix + k]
        diff = np.abs(v.numpy() - want)
        assert diff.max() <= 2 * LR, (k, diff.max())
        assert diff.mean() <= 1e-6, (k, diff.mean())


def _port_step(cfg):
    opt = adamw(lr=LR)
    return opt, TTR.make_train_step(
        lambda p, b: TT.lm_loss(p, cfg, b[0], b[1]), opt)


def test_sharded_train_step_matches_reference(jax_ref):
    ref = np.load(jax_ref / "train.npz")
    cfg = scaled(get_reduced("deepseek-moe-16b"), dtype="float32")
    opt, step = _port_step(cfg)
    state = TTR.init_train_state(_train_params(ref, "params0/"), opt)
    batch = (torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"]))
    with rules.activation_mesh({"data": 4, "model": 2}):
        st, m = step(state, batch)
    assert abs(float(m["loss"]) - float(ref["loss1"])) <= 1e-5
    assert abs(float(m["grad_norm"]) / float(ref["gnorm1"]) - 1) <= 1e-5
    _assert_state(st.params, ref, "state1/params/")
    # without the mesh the whole batch routes as one group: another loss
    _, m0 = step(state, batch)
    assert float(m0["loss"]) != float(m["loss"])


def test_elastic_remesh_restores_and_steps(jax_ref):
    """The (4, 2) state restored by the port (``checkpoint.restore`` +
    ``reshard``) equals JAX's bit for bit; one more step under (2, 4)
    matches JAX's step on its (2, 4) mesh."""
    ref = np.load(jax_ref / "train.npz")
    cfg = scaled(get_reduced("deepseek-moe-16b"), dtype="float32")
    opt, step = _port_step(cfg)
    target = TTR.init_train_state(
        {k: torch.zeros_like(v) for k, v in
         _train_params(ref, "params0/").items()}, opt)
    restored = fault.reshard(TC.restore(str(jax_ref / "ckpt"), target),
                             "cpu")
    flat = TC.flatten(restored)
    want = {k[len("state1/"):]: ref[k] for k in ref.files
            if k.startswith("state1/")}
    assert sorted(flat) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    batch = (torch.from_numpy(ref["tokens"]), torch.from_numpy(ref["labels"]))
    with rules.activation_mesh({"data": 2, "model": 4}):
        st2, m2 = step(restored, batch)
    assert abs(float(m2["loss"]) - float(ref["loss2"])) <= 1e-5
    assert abs(float(m2["grad_norm"]) / float(ref["gnorm2"]) - 1) <= 1e-5
    _assert_state(st2.params, ref, "state2/params/")


def test_reshard_places_whole_leaves_only():
    tree = {"a": torch.arange(4), "b": [torch.ones(2), (torch.zeros(1),)]}
    out = fault.reshard(tree, "cpu", {"a": None, "b": [(), ((None,),)]})
    assert torch.equal(out["a"], tree["a"]) and out["b"][1][0].shape == (1,)
    with pytest.raises(ValueError, match="one card"):
        fault.reshard(tree, "cpu", {"a": ("data",), "b": [None, (None,)]})
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            fault.reshard(tree, "cuda")


@pytest.mark.parametrize("microbatches", [1, 2])
def test_param_resharding_once_a_step_with_microbatches(microbatches):
    """Applied once a step before the microbatch loop when microbatches >
    1, never otherwise, as the reference's ``make_train_step``; the
    gradients are taken at what it returns, the update applies to the
    state's parameters."""
    calls = []

    def reshard(params):
        calls.append(1)
        return {k: 2 * v for k, v in params.items()}
    loss = lambda p, b: ((p["w"] * b).sum()) ** 2
    opt = adamw(lr=0.1)
    state = TTR.init_train_state({"w": torch.ones(3)}, opt)
    batch = torch.arange(4, dtype=torch.float32).reshape(2, 2)[:, :1] \
        .expand(2, 3).contiguous()
    step = TTR.make_train_step(loss, opt, microbatches=microbatches,
                               param_resharding=reshard)
    plain = TTR.make_train_step(loss, opt, microbatches=microbatches)
    for _ in range(3):
        st, m = step(state, batch)
    assert len(calls) == (3 if microbatches > 1 else 0)
    _, m_plain = plain(state, batch)
    if microbatches > 1:
        # the loss at the doubled parameters: 4x the plain one
        assert float(m["loss"]) == pytest.approx(4 * float(m_plain["loss"]))
        assert float(st.params["w"][0]) == pytest.approx(1 - 0.1, abs=1e-3)
    else:
        assert float(m["loss"]) == float(m_plain["loss"])


def test_activation_mesh_shapes():
    assert rules.active_groups() is None
    with rules.activation_mesh((("pod", 2), ("data", 2), ("model", 2))):
        assert rules.dp_axes(rules._ACT["mesh"]) == ("pod", "data")
        assert rules.active_groups() == (4, 2)
        with rules.activation_mesh(None):
            assert rules.active_groups() is None
        assert rules.active_groups() == (4, 2)
    assert rules.active_groups() is None
    x = torch.ones(2, 3)
    assert rules.constrain(x, "dp", None) is x
    with pytest.raises(ValueError, match="no axis"):
        rules.set_activation_mesh({"data": 2})


def _port_state_on_meta(arch):
    """(the port's TrainState of ``arch``'s published config on meta, its
    rules family), with the optimizer its train cell takes."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import specs as LS
    from repro_torch.models import gnn as G
    from repro_torch.models import recsys as R
    cfg = get_arch(arch)[0]
    meta = torch.device("meta")
    if cfg.family == "lm":
        return TTR.init_train_state(LS._lm_params(cfg, meta),
                                    LS._lm_optimizer(cfg)), "lm"
    shapes = (R.param_shapes(cfg) if cfg.family == "recsys" else
              G.param_shapes(cfg, 32, 7))
    params = {k: torch.empty(s, device=meta) for k, (s, _) in shapes.items()}
    return TTR.init_train_state(params, adamw()), cfg.family


def _spec_paths(tree, prefix=""):
    """{path: spec as lists} of a tree of ``rules.NamedSharding``."""
    if isinstance(tree, rules.NamedSharding):
        return {prefix[:-1]: [list(a) if isinstance(a, tuple) else a
                              for a in tree.spec]}
    items = (tree.items() if isinstance(tree, dict) else
             zip(tree._fields, tree))
    out = {}
    for k, v in items:
        out.update(_spec_paths(v, f"{prefix}{k}/"))
    return out


@pytest.mark.parametrize("arch", SPEC_ARCHS)
def test_state_specs_match_reference(jax_ref, arch):
    """``lm_specs`` / ``recsys_specs`` / ``gnn_specs``, ``opt_state_specs``
    (AdamW with f32 or bf16 moments, Adafactor's factored moments) and
    ``drop_fsdp`` of every parameter and optimizer-state leaf, on (4, 2),
    (2, 4), (2, 2, 2) with "pod" and the production (16, 16) and
    (2, 16, 16) shapes: the reference's specs, entry for entry."""
    want = json.loads((jax_ref / "specs.json").read_text())[arch]
    state, family = _port_state_on_meta(arch)
    for name, (sizes, axes) in SPEC_MESHES.items():
        mesh = tuple(zip(axes, sizes))
        ps = TTR.param_shardings(state.params, mesh, family)
        got = {"params": _spec_paths(ps),
               "opt_state": _spec_paths(rules.opt_state_specs(
                   state.opt_state, ps, mesh)),
               "drop_fsdp": _spec_paths(rules.drop_fsdp(ps))}
        for part in got:
            assert got[part] == want[name][part], (arch, name, part)


@pytest.mark.parametrize("arch,shape", SPEC_CELLS,
                         ids=[f"{a}-{s}" for a, s in SPEC_CELLS])
def test_train_cell_shardings_match_reference(jax_ref, arch, shape):
    """``launch/specs.build_cell(..., mesh=)`` of a train cell on the
    (16, 16) pod: its state's in and out shardings the reference's
    ``_lm_state_shardings`` (or its GNN and RecSys counterparts) entry
    for entry, its batch split over "data" as the reference's (a
    one-axis tuple read as the axis), its microbatches the reference's
    count per data process."""
    from repro_torch.launch import specs as LS
    want = json.loads((jax_ref / "specs.json").read_text())["cells"][
        f"{arch}/{shape}"]
    cell = LS.build_cell(arch, shape, mesh={"data": 16, "model": 16},
                         device="meta")
    assert _spec_paths(cell.in_shardings[0]) == want["state"]
    assert _spec_paths(cell.out_shardings[0]) == want["out_state"]

    def norm(spec):
        return json.dumps([list(a) if isinstance(a, (list, tuple))
                           and len(a) > 1 else a[0]
                           if isinstance(a, (list, tuple)) else a
                           for a in spec])
    got = sorted(norm(ns.spec)
                 for ns in _sharding_leaves(cell.in_shardings[1]))
    assert got == sorted(norm(b) for b in want["batch"])
    assert cell.meta.get("microbatches") == want["microbatches"]


def _sharding_leaves(tree):
    """The ``rules.NamedSharding`` leaves of a tree (dicts, tuples and
    NamedTuples)."""
    if isinstance(tree, rules.NamedSharding):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items for x in _sharding_leaves(v)]

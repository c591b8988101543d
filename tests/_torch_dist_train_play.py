"""Training on a train mesh of W processes (gloo on the CPU), for
``tests/test_torch_dist_train.py``: each family's setup from seeds, the
ranks' cases, and the JAX package's SPMD steps on 4 of 8 host devices.

Every setup is made the same way in each rank, in the test process (the
one-process port under ``activation_mesh`` of the case's shape) and, for
the JAX package, from the port's parameters saved as a checkpoint.
"""
import os
import textwrap
import time
import traceback

import numpy as np

LR = 1e-3
TB, TS = 8, 16                     # an LM batch
RB = 8                             # a RecSys batch
GRAPH = (256, 1024, 32, 7)         # the train CLI's graph: N, E, F, C
MOLS = (8, 16, 32)                 # molecule batch: graphs, nodes, edges
GROUP_TIMEOUT_S = 240

ARCHS = {"moe": "deepseek-moe-16b", "dense": "qwen2-1.5b",
         "dcn": "dcn-v2", "wd": "wide-deep", "gat": "gat-cora",
         "mol": "gat-cora"}
# (family key, mesh) of every step case; the world is the mesh's size
STEP_CASES = [(f, m) for f in ("moe", "dense", "dcn", "wd", "gat", "mol")
              for m in ((2, 2), (4, 1), (1, 4))] + [
    (f, m) for f in ("moe", "dense") for m in ((2, 1), (1, 2))]
JAX_MESHES = {f: [(2, 2)] for f in ARCHS}
JAX_MESHES["dense"] = [(2, 2), (1, 4)]       # (1, 4): 2 KV heads under 4
REMESH = ((4, 1), (1, 4))
CLI_CRAWL = 12                     # the train CLI case's crawl steps


def case_name(fam, mesh):
    return f"{fam}_{mesh[0]}x{mesh[1]}"


def _cfg(fam):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    cfg = get_reduced(ARCHS[fam])
    return scaled(cfg, dtype="float32") if cfg.family == "lm" else cfg


def _graph(rng, n, e, f, c, lead=()):
    import torch
    from repro_torch.models import gnn as G
    return G.Graph(
        features=torch.tensor(rng.normal(size=lead + (n, f)),
                              dtype=torch.float32),
        src=torch.tensor(rng.integers(0, n, lead + (e,)), dtype=torch.int32),
        dst=torch.tensor(rng.integers(0, n, lead + (e,)), dtype=torch.int32),
        edge_mask=torch.ones(lead + (e,), dtype=torch.bool),
        labels=torch.tensor(rng.integers(0, c, lead + (n,)),
                            dtype=torch.int32),
        label_mask=torch.tensor(rng.random(lead + (n,)) < 0.3))


def setup(fam):
    """(cfg, whole parameters, whole batch, loss_fn, rules family) of a
    family key, on the CPU, from seeds."""
    import torch
    cfg = _cfg(fam)
    if cfg.family == "lm":
        from repro_torch.models import transformer as T
        params = T.stack_params(T.init_lm(cfg, seed=0, device="cpu"))
        tok = np.random.default_rng(3).integers(
            0, cfg.vocab_size, (TB, TS)).astype(np.int32)
        batch = (torch.from_numpy(tok),
                 torch.from_numpy(np.roll(tok, -1, 1)))
        return cfg, params, batch, \
            (lambda p, b: T.lm_loss(p, cfg, b[0], b[1])), "lm"
    if cfg.family == "recsys":
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.models import recsys as R
        params = R.INIT[cfg.kind](0, cfg, device="cpu")
        batch = R.make_batch(cfg, ShapeSpec("t", "train", dict(batch=RB)),
                             device="cpu")
        return cfg, params, batch, \
            (lambda p, b: R.TRAIN_LOSS[cfg.kind](p, cfg, b)), "recsys"
    from repro_torch.models import gnn as G
    n, e, f, c = GRAPH
    params = G.init_gat(0, cfg, f, c, device="cpu")
    rng = np.random.default_rng(5)
    if fam == "gat":
        return cfg, params, _graph(rng, n, e, f, c), \
            (lambda p, b: G.gat_loss(p, cfg, b)), "gnn"
    B, n, e = MOLS
    return cfg, params, _graph(rng, n, e, f, c, lead=(B,)), \
        (lambda p, b: G.gat_batched_loss(p, cfg, b)), "gnn"


def place_case_batch(fam, batch, mesh):
    """The batch as the train CLI places it: split over the data axes,
    but the single graph whole on every process."""
    from repro_torch.train import trainer as TR
    return batch if fam == "gat" else TR.place_batch(batch, mesh)


def flat_numpy(tree):
    from repro_torch.train import checkpoint as TC
    return TC.flatten(tree)


class Spy:
    """``layers.moe_dispatch`` watched: each call's (w, e, slot, keep)."""

    def __init__(self):
        from repro_torch.models import layers as TL
        self.mod, self.orig, self.calls = TL, TL.moe_dispatch, []

    def __enter__(self):
        def spy(logits, m, capacity):
            out = self.orig(logits, m, capacity)
            self.calls.append(tuple(t.detach().numpy() for t in out[:4]))
            return out
        self.mod.moe_dispatch = spy
        return self

    def __exit__(self, *a):
        self.mod.moe_dispatch = self.orig


def one_process(fam, mesh, *, optimizer="adamw", microbatches=1):
    """The one-process port's step under ``activation_mesh`` of ``mesh``:
    (loss, grad norm, flat state after, dispatch calls)."""
    from repro_torch.optim import adafactor, adamw
    from repro_torch.sharding import rules
    from repro_torch.train import trainer as TR
    cfg, params, batch, loss_fn, _ = setup(fam)
    opt = adamw(lr=LR) if optimizer == "adamw" else adafactor(lr=LR)
    step = TR.make_train_step(loss_fn, opt, microbatches=microbatches)
    with rules.activation_mesh({"data": mesh[0], "model": mesh[1]}), \
            Spy() as spy:
        st, m = step(TR.init_train_state(params, opt), batch)
    return float(m["loss"]), float(m["grad_norm"]), flat_numpy(st), \
        spy.calls


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------

def spec_items(tree, prefix=""):
    """(path, NamedSharding) pairs of a tree of shardings, in the
    checkpoint's paths."""
    from repro_torch.sharding import rules
    if isinstance(tree, rules.NamedSharding):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from spec_items(v, f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from spec_items(v, f"{prefix}{k}/")


def _check_blocks(state, shardings, mesh):
    """Every leaf's block is the size its spec gives on ``mesh``."""
    from repro_torch.sharding import rules
    from repro_torch.train import checkpoint as TC
    specs = dict(spec_items(shardings))
    for k, leaf in TC._items(state):
        sh = rules.NamedSharding(mesh, specs[k].spec)
        want = tuple(s.stop - s.start for s in
                     rules.local_slices(leaf.shape, sh))
        got = tuple(leaf.to_local().shape)
        if got != want:
            raise AssertionError(f"{k}: block {got}, spec {sh.spec} "
                                 f"gives {want}")
        if rules.sharding_of(leaf).spec != rules._guard(sh.spec, leaf.shape,
                                                        mesh):
            raise AssertionError(f"{k}: placed {rules.sharding_of(leaf)}, "
                                 f"spec {sh.spec}")


def mesh_step(fam, mesh_shape, *, optimizer="adamw", microbatches=1,
              once=False):
    """This rank's step of a case on a fresh mesh: (records, the mesh,
    the state after, the placed batch, the step)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adafactor, adamw
    from repro_torch.train import trainer as TR
    mesh = make_host_mesh(model=mesh_shape[1])
    assert tuple(mesh.shape) == tuple(mesh_shape)
    cfg, params, batch, loss_fn, family = setup(fam)
    opt = adamw(lr=LR) if optimizer == "adamw" else adafactor(lr=LR)
    state = TR.init_train_state(TR.place_params(params, mesh, family), opt)
    _check_blocks(state, TR.state_shardings(state, mesh, family), mesh)
    step = TR.make_train_step(loss_fn, opt, microbatches=microbatches,
                              param_resharding=TR.gather_once if once
                              else None)
    placed = place_case_batch(fam, batch, mesh)
    with Spy() as spy:
        st, m = step(state, placed)
    _check_blocks(st, TR.state_shardings(st, mesh, family), mesh)
    rec = {"loss": np.float32(m["loss"]), "gnorm": np.float32(m["grad_norm"])}
    for i, call in enumerate(spy.calls):
        for n, name in enumerate(("w", "e", "slot", "keep")):
            rec[f"route{i}/{name}"] = call[n]
    flat = flat_numpy(st)             # a collective: every rank joins
    rec.update({"state/" + k: v for k, v in flat.items()})
    return rec, mesh, st, placed, step


def _release_case(fam, mesh_shape):
    """The LM step's joined parameters on a mesh whose data axis splits
    them, with remat off and on: the bytes of joined tensors still alive
    when the forward ends (a layer's are released after it; the global
    leaves' the head may keep), the bytes of the global leaves and of
    every leaf joined, and the step's loss and grad norm."""
    import weakref
    from repro_torch.configs.base import scaled
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.sharding import spmd
    from repro_torch.train import trainer as TR
    mesh = make_host_mesh(model=mesh_shape[1])
    cfg, params, batch, _, family = setup(fam)
    placed = TR.place_params(params, mesh, family)
    size = {k: spmd.gather_params(p.to_local(), TR.rules.sharding_of(p))
            .nbytes for k, p in placed.items()}
    rec = {"whole": np.int64(sum(size.values())),
           "globals": np.int64(sum(n for k, n in size.items() if not
                                   k.startswith(("layers/", "prefix/"))))}
    made, orig = [], spmd.joined

    def spy(x):
        out = orig(x)
        if isinstance(x, spmd.Block):
            made.append((weakref.ref(out), out.nbytes))
        return out

    for remat in (False, True):
        c = scaled(cfg, remat=remat)
        alive = []

        def loss_fn(p, b):
            loss = T.lm_loss(p, c, b[0], b[1])
            alive.append(sum(n for r, n in made if r() is not None))
            return loss
        opt = adamw(lr=LR)
        step = TR.make_train_step(loss_fn, opt)
        spmd.joined = spy
        try:
            _, m = step(TR.init_train_state(placed, opt),
                        TR.place_batch(batch, mesh))
        finally:
            spmd.joined = orig
        made.clear()
        tag = f"remat{int(remat)}/"
        rec[tag + "alive"] = np.int64(alive[0])
        rec[tag + "loss"] = np.float32(m["loss"])
        rec[tag + "gnorm"] = np.float32(m["grad_norm"])
    return rec


def _lookup_case(mesh_shape):
    """``sharded_lookup`` on the mesh against ``embedding_lookup``."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import recsys as R
    from repro_torch.sharding import rules
    mesh = make_host_mesh(model=mesh_shape[1])
    g = torch.Generator().manual_seed(7)
    table = torch.randn(64, 4, generator=g)
    table[3] = -0.0                   # a row of -0.0 stays -0.0
    ids = torch.randint(0, 64, (16, 3), generator=g)
    ids[0, 0] = 3
    sh = rules.NamedSharding(mesh, ("model", None))
    block = table[rules.local_slices(table.shape, sh)]
    dp_rows = rules.local_slices(ids.shape, rules.NamedSharding(
        mesh, ("data", None)))
    got = R.sharded_lookup(block, ids[dp_rows], mesh=mesh,
                           model_axis="model", data_axes=("data",))
    want = R.embedding_lookup(table, ids[dp_rows])
    return {"got": got.numpy(), "want": want.numpy()}


def _constrain_case(mesh_shape):
    """``rules.constrain`` on the real mesh: a DTensor redistributed to
    its pattern, a dim the axis does not divide left whole, a plain
    tensor returned as it is."""
    import torch
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import rules
    mesh = make_host_mesh(model=mesh_shape[1])
    full = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    x = rules.place(full, rules.NamedSharding(mesh, ("data", None)))
    odd = rules.place(torch.ones(8, 3), rules.NamedSharding(
        mesh, ("data", None)))
    plain = torch.ones(3)
    with rules.activation_mesh(mesh):
        y = rules.constrain(x, None, "tp")
        z = rules.constrain(odd, None, "tp")
        same = rules.constrain(plain, "dp") is plain
    return {"y_spec": np.array(str(rules.sharding_of(y).spec)),
            "z_spec": np.array(str(rules.sharding_of(z).spec)),
            "y_full_equal": np.array(torch.equal(y.full_tensor(), full)),
            "plain_same": np.array(same)}


def _remesh_case(ckpt_dir, state_after, fam="moe"):
    """The (2, 2) state saved, restored onto each of ``REMESH`` and
    stepped once more."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import fault
    from repro_torch.train import trainer as TR
    rec = {}
    TC.save(ckpt_dir, 1, state_after)
    saved = TC.load(ckpt_dir)
    cfg, params, batch, loss_fn, family = setup(fam)
    opt = adamw(lr=LR)
    for shape in REMESH:
        mesh = make_host_mesh(model=shape[1])
        target = TR.init_train_state(TR.place_params(params, mesh, family),
                                     opt)
        restored = TC.restore(ckpt_dir, target, shardings=TR.state_shardings(
            target, mesh, family))
        _check_blocks(restored, TR.state_shardings(restored, mesh, family),
                      mesh)
        flat = flat_numpy(restored)
        tag = case_name("remesh", shape)
        rec[tag + "/equal"] = np.array(
            sorted(flat) == sorted(saved) and all(
                flat[k].tobytes() == saved[k].tobytes() for k in saved))
        # the live (2, 2) state placed onto the new mesh by its specs
        moved = flat_numpy(fault.reshard(state_after, mesh,
                                          TR.state_shardings(
                                              target, mesh, family)))
        rec[tag + "/reshard_equal"] = np.array(all(
            moved[k].tobytes() == saved[k].tobytes() for k in saved))
        step = TR.make_train_step(loss_fn, opt)
        _, m = step(restored, place_case_batch(fam, batch, mesh))
        rec[tag + "/loss"] = np.float32(m["loss"])
    return rec


def _jax_ckpt_case(jax_dir):
    """JAX's (2, 2) checkpoint of the "moe" step restored onto the port's
    (2, 2) mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as TC
    from repro_torch.train import trainer as TR
    deadline = time.time() + 600
    while not os.path.exists(os.path.join(jax_dir, "done")):
        if time.time() > deadline:
            raise TimeoutError(f"no JAX checkpoint in {jax_dir}")
        time.sleep(0.2)
    mesh = make_host_mesh(model=2)
    cfg, params, _, _, family = setup("moe")
    opt = adamw(lr=LR)
    target = TR.init_train_state(TR.place_params(params, mesh, family), opt)
    got = TC.restore(os.path.join(jax_dir, "ckpt"), target,
                     shardings=TR.state_shardings(target, mesh, family))
    return {"state/" + k: v for k, v in flat_numpy(got).items()}


def _cli_case(out):
    """The train CLI under the group: ``--model-parallel 2`` trains the
    MoE LM a few steps and checkpoints; 3 does not divide the world."""
    from repro_torch.launch import train as TT
    from repro_torch.train import checkpoint as TC
    ckpt = os.path.join(out, "cli_ckpt")
    argv = ["--device", "cpu", "--model-parallel", "2", "--steps", "2",
            "--arch", "deepseek-moe-16b", "--crawl-steps", str(CLI_CRAWL),
            "--batch", "4", "--seq-len", "32", "--ckpt-dir", ckpt,
            "--log-every", "1"]
    crawled, corpus = [], TT.crawl_corpus

    def spy(*a, **k):
        crawled.append(corpus(*a, **k)[0])
        return crawled[-1], None
    TT.crawl_corpus = spy
    try:
        state = TT.train_lm(TT.build_parser().parse_args(argv))
    finally:
        TT.crawl_corpus = corpus
    rec = {"loss_steps": np.int32(TC.latest_step(ckpt)),
           "urls": np.asarray(crawled[0]),
           "params_finite": np.array(all(
               np.isfinite(v).all() for v in TC.load(ckpt).values()
               if v.dtype.kind == "f"))}
    try:
        TT.main(argv[:3] + ["3"] + argv[4:])
        rec["refused"] = np.array("no error")
    except ValueError as e:
        rec["refused"] = np.array(str(e))
    del state
    return rec


def rank_main(rank, world, out, jax_dir):
    """One rank of a ``world``-process gloo group playing every case of
    its world, its records to ``<out>/<case>.r<rank>.npz``; a failure is
    written to ``<out>/error.r<rank>.txt``."""
    import torch
    import torch.distributed as dist
    from _torch_play import background
    background()
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_crawl_group
    store = dist.FileStore(os.path.join(out, "store"), world)
    init_crawl_group("cpu", store=store, rank=rank, world_size=world,
                     timeout_s=GROUP_TIMEOUT_S)
    try:
        def save(name, rec):
            np.savez(os.path.join(out, f"{name}.r{rank}.npz"), **rec)

        for fam, mesh in STEP_CASES:
            if mesh[0] * mesh[1] != world:
                continue
            rec, _, st, _, _ = mesh_step(fam, mesh)
            save(case_name(fam, mesh), rec)
            if world == 4 and fam == "moe" and mesh == (2, 2):
                save("remesh", _remesh_case(os.path.join(out, "ckpt"), st))
        if world == 4:
            save("gather_once", mesh_step("moe", (2, 2), microbatches=2,
                                          once=True)[0])
            save("microbatches", mesh_step("moe", (2, 2),
                                           microbatches=2)[0])
            for fam in ("dense", "moe"):
                save(f"release_{fam}", _release_case(fam, (4, 1)))
            save("adafactor", mesh_step("dense", (2, 2),
                                        optimizer="adafactor")[0])
            save("lookup", _lookup_case((2, 2)))
            save("constrain", _constrain_case((2, 2)))
            save("cli", _cli_case(out))
            save("jax_ckpt", _jax_ckpt_case(jax_dir))
        dist.barrier()
    except BaseException:
        with open(os.path.join(out, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX package's SPMD steps
# ---------------------------------------------------------------------------

def write_params(root):
    """Every family's parameters (and the GNN batches) for the JAX
    subprocess: a checkpoint a family in the reference's layout."""
    from repro_torch.train import checkpoint as TC
    for fam in ARCHS:
        _, params, batch, _, _ = setup(fam)
        TC.save(os.path.join(root, fam), 0, params)
        if fam in ("gat", "mol"):
            np.savez(os.path.join(root, f"{fam}_graph.npz"),
                     **{k: v.numpy() for k, v in batch._asdict().items()})


JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ.setdefault("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"
    import json, sys
    sys.path.insert(0, "src")
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.compat import make_mesh
    from repro.configs import get_reduced
    from repro.configs.base import ShapeSpec, scaled
    from repro.models import gnn as G
    from repro.models import recsys as R
    from repro.models import transformer as T
    from repro.optim import adamw
    from repro.sharding import rules
    from repro.train import checkpoint as CK
    from repro.train.trainer import TrainState, init_train_state, \\
        make_train_step

    root, out = sys.argv[1], sys.argv[2]
    archs, meshes = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    TB, TS, RB, LR = (float(v) if "." in v else int(v)
                      for v in sys.argv[5:9])

    def flat(tree):
        return {k: np.asarray(v) for k, v in CK._flatten(tree).items()}

    for fam, arch in archs.items():
        cfg = get_reduced(arch)
        key = jax.random.PRNGKey(0)
        if cfg.family == "lm":
            cfg = scaled(cfg, dtype="float32")
            shape = jax.eval_shape(lambda: T.init_lm(key, cfg))
            tok = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (TB, TS)).astype(np.int32)
            batch = {"tokens": tok, "labels": np.roll(tok, -1, 1)}
            loss = lambda p, b: T.lm_loss(p, cfg, b["tokens"], b["labels"])
            specs = rules.lm_specs
        elif cfg.family == "recsys":
            shape = jax.eval_shape(lambda: R.INIT[cfg.kind](key, cfg))
            batch = R.make_batch(cfg, ShapeSpec("t", "train",
                                                dict(batch=RB)))
            loss = lambda p, b: R.TRAIN_LOSS[cfg.kind](p, cfg, b)
            specs = rules.recsys_specs
        else:
            g = dict(np.load(os.path.join(root, f"{fam}_graph.npz")))
            batch = G.Graph(**{k: jnp.asarray(v) for k, v in g.items()})
            shape = jax.eval_shape(lambda: G.init_gat(
                key, cfg, g["features"].shape[-1], 7))
            fn = G.gat_loss if fam == "gat" else G.gat_batched_loss
            loss = lambda p, b, fn=fn: fn(p, cfg, b)
            specs = rules.gnn_specs
        params = CK.restore(os.path.join(root, fam), jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), shape))
        opt = adamw(lr=LR)
        state = init_train_state(params, opt)
        step = make_train_step(loss, opt)
        for dp, tp in meshes[fam]:
            mesh = make_mesh((dp, tp), ("data", "model"))
            with mesh, rules.activation_mesh(mesh):
                pspec = specs(jax.eval_shape(lambda: params), mesh)
                ospec = rules.opt_state_specs(state.opt_state, pspec, mesh)
                sspec = TrainState(pspec, ospec, NamedSharding(mesh, P()))
                rows = jax.tree.leaves(batch)[0].shape[0]
                bspec = jax.tree.map(
                    lambda x: NamedSharding(mesh, P("data") if fam != "gat"
                                            and x.ndim and x.shape[0] == rows
                                            else P()), batch)
                st, m = jax.jit(step, in_shardings=(sspec, bspec))(
                    jax.device_put(state, sspec),
                    jax.device_put(batch, bspec))
            np.savez(os.path.join(out, f"{fam}_{dp}x{tp}.npz"),
                     loss=np.asarray(m["loss"]),
                     gnorm=np.asarray(m["grad_norm"]),
                     **{"state/" + k: v for k, v in flat(st).items()})
            if fam == "moe" and (dp, tp) == (2, 2):
                CK.save(os.path.join(out, "ckpt"), 1, st)
            print("case", fam, dp, tp, flush=True)
    print("jax train: OK", flush=True)
""")

"""LM serving on a (data, model) mesh of W processes (gloo on the CPU),
for ``tests/test_torch_dist_serve.py``: the cases, the one-process port's
runs they are held to, the ranks, and the JAX package's sharded
``prefill_step`` and ``decode_step``.

A case is (arch, mesh, batch): the reduced f32 model from seed 0, a
prompt of ``P`` tokens prefilled into a cache of ``M`` slots, then ``GEN``
teacher-forced decode steps, whose slots (``P`` ... ``P + GEN - 1``)
cross from one process's segment of the cache into the next (at slot
32, where the sequence is split 2 or 4 ways) while a later segment is
still empty.
"""
import os
import textwrap
import traceback

import numpy as np

P, M, GEN = 28, 64, 8
ARCHS = {"dense": "qwen2-1.5b", "moe": "deepseek-moe-16b"}
MESHES = {2: ((2, 1), (1, 2)), 4: ((4, 1), (2, 2), (1, 4))}
BATCHES = (1, 4)           # 1: the sequence over every axis when dp > 1
JAX_CASES = (((2, 2), 4), ((1, 4), 1))
GROUP_TIMEOUT_S = 240


def cases(world):
    return [(fam, mesh, b) for mesh in MESHES[world] for fam in ARCHS
            for b in BATCHES]


def case_name(fam, mesh, b):
    return f"{fam}_{mesh[0]}x{mesh[1]}_b{b}"


def setup(fam, b):
    """(cfg, the one-card model, its stacked parameters, tokens (b, P +
    GEN) int64) from seeds, on the CPU."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    from repro_torch.models import transformer as T
    cfg = scaled(get_reduced(ARCHS[fam]), dtype="float32")
    model = T.init_lm(cfg, seed=0, device="cpu")
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (b, P + GEN)).astype(np.int64)
    return cfg, model, T.stack_params(model), torch.from_numpy(toks)


class Spy:
    """``layers.moe_dispatch`` watched: each call's (e, slot, keep); and
    the last-axis strides of each prefill attention's q, k and v (the
    card's kernels take only a contiguous head dim)."""

    def __init__(self):
        from repro_torch.kernels.flash_attention import ops as FA
        from repro_torch.models import layers as TL
        self.mod, self.orig, self.calls = TL, TL.moe_dispatch, []
        self.fa, self.fa_orig, self.head_strides = FA, FA.attention, []

    def __enter__(self):
        def spy(logits, m, capacity):
            out = self.orig(logits, m, capacity)
            self.calls.append(tuple(t.detach().numpy() for t in out[1:4]))
            return out

        def attention(q, k, v, **kw):
            self.head_strides.append([t.stride(-1) for t in (q, k, v)])
            return self.fa_orig(q, k, v, **kw)
        self.mod.moe_dispatch = spy
        self.fa.attention = attention
        return self

    def __exit__(self, *a):
        self.mod.moe_dispatch = self.orig
        self.fa.attention = self.fa_orig


def _records(logits, cache, calls):
    rec = {f"logits{i}": l.numpy() for i, l in enumerate(logits)}
    for name in ("prefix_k", "prefix_v", "main_k", "main_v", "length"):
        t = getattr(cache, name)
        if t is not None:
            rec["cache/" + name] = t.numpy()
    for i, call in enumerate(calls):
        for n, name in enumerate(("e", "slot", "keep")):
            rec[f"route{i}/{name}"] = call[n]
    return rec


def one_process(fam, mesh, b):
    """The one-process port's prefill and decodes under ``activation_mesh``
    of the case's shape (the reference's MoE groups)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    cfg, model, _, toks = setup(fam, b)
    logits = []
    with rules.activation_mesh({"data": mesh[0], "model": mesh[1]}), \
            Spy() as spy:
        lg, cache = T.prefill_step(model, toks[:, :P], max_len=M)
        logits.append(lg)
        for i in range(GEN):
            lg, cache = T.decode_step(model, toks[:, P + i:P + i + 1], cache)
            logits.append(lg)
    return _records(logits, cache, spy.calls)


def mesh_case(fam, mesh_shape, b):
    """This rank's prefill and decodes on a fresh mesh: its token rows,
    its cache block and its routes, with the layout and the slices of
    the whole that it holds."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules, spmd
    mesh = make_host_mesh(model=mesh_shape[1])
    cfg, _, params, toks = setup(fam, b)
    sh = rules.lm_specs(params, mesh)
    blocks = {k: v[rules.local_slices(v.shape, sh[k])].contiguous()
              for k, v in params.items()}
    layout = T.serve_layout(mesh, cfg, b, M)
    rows = (layout.rows[0] if len(layout.rows) == 1 else
            (layout.rows or None))
    tok_rows = rules.local_slices(toks.shape, rules.NamedSharding(
        mesh, (rows, None)))
    mine = toks[tok_rows]
    J = spmd.Joined(blocks, sh)
    logits = []
    with rules.activation_mesh(mesh), Spy() as spy:
        lg, cache = T.prefill_step(J, mine[:, :P], max_len=M, cfg=cfg,
                                   layout=layout)
        logits.append(lg)
        for i in range(GEN):
            lg, cache = T.decode_step(J, mine[:, P + i:P + i + 1], cache,
                                      cfg=cfg, layout=layout)
            logits.append(lg)
    rec = _records(logits, cache, spy.calls)
    rec["attention_head_strides"] = np.array(spy.head_strides)
    whole = (cfg.n_layers, b, cfg.n_kv_heads, M, cfg.head_dim)
    kv = rules.cache_specs(T.LMCache(None, None, whole, whole, (b,)), mesh,
                           b).main_k
    blk = rules.local_slices(whole, kv)
    rec["rows"] = np.array([tok_rows[0].start, tok_rows[0].stop])
    rec["kv_slices"] = np.array([[s.start, s.stop] for s in blk[1:]])
    rec["layout"] = np.array(repr(tuple(layout)))
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    rec["group"] = np.int64(coord["data"] * mesh_shape[1] + coord["model"])
    return rec


def rank_main(rank, world, out):
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
        for case in cases(world):
            np.savez(os.path.join(out, f"{case_name(*case)}.r{rank}.npz"),
                     **mesh_case(*case))
        dist.barrier()
    except BaseException:
        with open(os.path.join(out, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The JAX package's sharded steps
# ---------------------------------------------------------------------------

def write_params(root):
    """Each arch's parameters in the reference's layout, for the JAX
    subprocess."""
    from repro_torch.train import checkpoint as TC
    for fam in ARCHS:
        TC.save(os.path.join(root, fam), 0, setup(fam, 1)[2])


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
    from repro.configs.base import scaled
    from repro.models import transformer as T
    from repro.sharding import rules
    from repro.train import checkpoint as CK

    root, out = sys.argv[1], sys.argv[2]
    archs, cases = json.loads(sys.argv[3]), json.loads(sys.argv[4])
    NP, NM, NG = (int(v) for v in sys.argv[5:8])

    for fam, arch in archs.items():
        cfg = scaled(get_reduced(arch), dtype="float32")
        shape = jax.eval_shape(lambda: T.init_lm(jax.random.PRNGKey(0), cfg))
        params = CK.restore(os.path.join(root, fam), jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), shape))
        for (dp, tp), B in cases:
            toks = np.random.default_rng(3).integers(
                0, cfg.vocab_size, (B, NP + NG)).astype(np.int32)
            mesh = make_mesh((dp, tp), ("data", "model"))
            dpa = rules.dp_axes(mesh)
            ns = lambda *s: NamedSharding(mesh, P(*s))
            # the reference's _lm_cell in-shardings (launch/specs.py)
            with mesh, rules.activation_mesh(mesh):
                psh = rules.lm_specs(shape, mesh)
                pre = jax.jit(lambda p, t: T.prefill_step(p, cfg, t),
                              in_shardings=(psh, ns(dpa, None)))
                logits, cache = pre(jax.device_put(params, psh),
                                    jnp.asarray(toks[:, :NP]))
                grow = lambda x: jnp.pad(
                    x, ((0, 0), (0, 0), (0, 0), (0, NM - NP), (0, 0)))
                cache = T.LMCache(
                    None if cache.prefix_k is None else grow(cache.prefix_k),
                    None if cache.prefix_v is None else grow(cache.prefix_v),
                    grow(cache.main_k), grow(cache.main_v), cache.length)
                n = int(np.prod([mesh.shape[a] for a in dpa]))
                if B >= n:
                    kv, tok, ln = (P(None, dpa, None, "model", None),
                                   P(dpa, None), P(dpa))
                else:
                    kv, tok, ln = (P(None, None, None, dpa + ("model",),
                                     None), P(None, None), P(None))

                def csh(leaf):
                    if leaf is None:
                        return None
                    spec = kv if leaf.ndim == 5 else ln
                    return NamedSharding(mesh, rules._guard(
                        spec, leaf.shape, mesh))
                cache_sh = jax.tree.map(csh, cache,
                                        is_leaf=lambda x: x is None)
                dec = jax.jit(lambda p, t, c: T.decode_step(p, cfg, t, c),
                              in_shardings=(psh, NamedSharding(mesh, tok),
                                            cache_sh))
                got = [np.asarray(logits)]
                cache = jax.device_put(cache, cache_sh)
                for i in range(NG):
                    logits, cache = dec(params, jnp.asarray(
                        toks[:, NP + i:NP + i + 1]), cache)
                    got.append(np.asarray(logits))
            np.savez(os.path.join(out, f"{fam}_{dp}x{tp}_b{B}.npz"),
                     **{f"logits{i}": g for i, g in enumerate(got)})
            print("case", fam, dp, tp, B, flush=True)
    print("jax serve: OK", flush=True)
""")


# ---------------------------------------------------------------------------
# The bytes each process holds, for the dry run's per-card reckoning
# ---------------------------------------------------------------------------

HELD_MESHES = ((2, 2), (4, 1))
# (arch, shape, build_cell keywords) of the reduced cells reckoned per card
HELD_CELLS = (("qwen2-1.5b", "train_4k", dict(batch=8, seq_len=16)),
              ("qwen2-1.5b", "prefill_32k", dict(batch=4, seq_len=16)),
              ("deepseek-moe-16b", "decode_32k", dict(batch=4, seq_len=32)))


def held_cfg(arch):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import scaled
    return scaled(get_reduced(arch), dtype="float32")


def _local_bytes(tree) -> int:
    from repro_torch.launch.dryrun import tensors
    from repro_torch.optim.common import local
    return sum(local(t).numel() * local(t).element_size()
               for t in tensors(tree))


def held_main(rank, world, out):
    """One rank of a gloo group of ``world``: for each of ``HELD_CELLS`` on
    each of ``HELD_MESHES``, the bytes of the blocks it holds (a train
    cell's state placed as the trainer places it and its rows of the
    batch; a serving cell built on the mesh, placed, and run once), to
    ``<out>/held.r<rank>.json``."""
    import json
    import torch
    import torch.distributed as dist
    from _torch_play import background
    background()
    torch.set_num_threads(1)
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import init_crawl_group, make_host_mesh
    from repro_torch.train import trainer as TR
    store = dist.FileStore(os.path.join(out, "held_store"), world)
    init_crawl_group("cpu", store=store, rank=rank, world_size=world,
                     timeout_s=GROUP_TIMEOUT_S)
    rec = {}
    try:
        for shape in HELD_MESHES:
            mesh = make_host_mesh(model=shape[1])
            for arch, cell_shape, kw in HELD_CELLS:
                cfg = held_cfg(arch)
                cell = specs.build_cell(arch, cell_shape, cfg=cfg,
                                        device="cpu", mesh=mesh, **kw)
                if cell_shape == "train_4k":
                    state, batch = cell.args
                    placed = TR.init_train_state(TR.place_params(
                        state.params, mesh, "lm"), cell.step_parts[1])
                    held = _local_bytes(placed) + _local_bytes(
                        TR.place_batch(batch, mesh))
                else:
                    held = _local_bytes(cell.args)
                    logits = cell.fn(*cell.args)[0]
                    assert logits.shape[-1] == cfg.vocab_size
                rec[f"{arch}/{cell_shape}/{shape[0]}x{shape[1]}"] = held
        dist.barrier()
    except BaseException:
        with open(os.path.join(out, f"error.r{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"held.r{rank}.json"), "w") as f:
        json.dump(rec, f)

"""The dry run's per-card reckoning under a mesh (``launch/dryrun.py
--mesh``): each cell reckoned as one process's program on meta under a
``sharding.spmd.MetaMesh``, the same code a card of the mesh runs, its
collectives counted by their meta route.

Held to: the bytes each process of a gloo group of 4 holds for the same
reduced cells on (2, 2) and (4, 1) (a train step's placed state and
rows; a prefill and a decode cell built on the mesh), exactly; equal
peaks for the first and the last process; the one-card record at one
device; a reduced train step's collectives against the closed form of
its FSDP gathers, reduce-scatters and all-reduces; ``not ported``
records for the cells whose mesh program the port does not run; and at
full size, the three long_500k cells that fit no single card fitting a
card of (1, 4).
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")

import _torch_dist_serve_play as D  # noqa: E402

WORLD = 4
TIMEOUT_S = 120


@pytest.fixture(scope="module")
def held(tmp_path_factory):
    """{rank: {cell/mesh: bytes held}} from one gloo group of 4."""
    import torch.multiprocessing as mp
    out = tmp_path_factory.mktemp("dryrun_mesh")
    ctx = mp.start_processes(D.held_main, args=(WORLD, str(out)),
                             nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    while not ctx.join(max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError("the held-bytes group did not finish")
    errs = sorted(out.glob("error.r*.txt"))
    assert not errs, errs[0].read_text()
    return {r: json.loads((out / f"held.r{r}.json").read_text())
            for r in range(WORLD)}


def _reckon(arch, shape, kw, mesh, rank):
    from repro_torch.launch import dryrun as DR
    from repro_torch.sharding import spmd
    return DR.run_cell(arch, shape, search=False, cfg=D.held_cfg(arch),
                       mesh=spmd.MetaMesh({"data": mesh[0],
                                           "model": mesh[1]}, rank), **kw)


def _args_bytes(arch, shape, kw, mesh, rank):
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import tensors
    from repro_torch.sharding import spmd
    cell = specs.build_cell(arch, shape, cfg=D.held_cfg(arch), mesh=(
        spmd.MetaMesh({"data": mesh[0], "model": mesh[1]}, rank)), **kw)
    return sum(t.numel() * t.element_size() for t in tensors(cell.args))


CELLS = [(m, c) for m in D.HELD_MESHES for c in D.HELD_CELLS]


@pytest.mark.parametrize("mesh,cell", CELLS,
                         ids=[f"{c[1]}-{m[0]}x{m[1]}" for m, c in CELLS])
def test_state_bytes_reckoned_exactly(held, mesh, cell):
    """Each process's blocks, reckoned on meta, are the bytes the gloo
    process of the same rank holds."""
    arch, shape, kw = cell
    key = f"{arch}/{shape}/{mesh[0]}x{mesh[1]}"
    for r in range(WORLD):
        assert _args_bytes(arch, shape, kw, mesh, r) == held[r][key], (r,)


@pytest.mark.parametrize("mesh,cell", CELLS,
                         ids=[f"{c[1]}-{m[0]}x{m[1]}" for m, c in CELLS])
def test_first_and_last_rank_reckon_equal_peaks(mesh, cell):
    arch, shape, kw = cell
    a = _reckon(arch, shape, kw, mesh, 0)
    b = _reckon(arch, shape, kw, mesh, WORLD - 1)
    for k in ("total_per_device", "reserved_needed", "reserved_peak"):
        assert a["memory"][k] == b["memory"][k], k
    assert a["cost"]["flops"] == b["cost"]["flops"]
    assert a["devices"] == ["meta"]


@pytest.mark.parametrize("cell", D.HELD_CELLS, ids=[c[1] for c in
                                                    D.HELD_CELLS])
def test_one_device_mesh_is_the_one_card_record(cell):
    from repro_torch.launch import dryrun as DR
    arch, shape, kw = cell
    cfg = D.held_cfg(arch)
    one = DR.run_cell(arch, shape, cfg=cfg, **kw)
    mesh = DR.run_cell(arch, shape, cfg=cfg, mesh="1x1", **kw)
    assert mesh["n_devices"] == 1 and mesh["collective_bytes"] == 0
    for k in ("memory", "cost", "bound_ms", "fits"):
        assert mesh[k] == one[k], k


def test_train_step_collectives_in_closed_form():
    """A reduced f32 Qwen2 train step at (4, 1): every data-split leaf is
    joined (all-gather of its block) in the forward and again when the
    backward reads it (``spmd.released``), its gradient reduce-scattered
    from the joined size; every data-replicated leaf's gradient
    all-reduced (the tied embedding twice: the lookup and the head), and
    the loss and the global norm's per-leaf sums (f32 scalars)."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import rules
    arch, shape, kw = D.HELD_CELLS[0]
    cfg = D.held_cfg(arch)
    rec = _reckon(arch, shape, kw, (4, 1), 0)
    leaves = T.stack_params(T.LM(cfg, "meta"))
    mesh = {"data": 4, "model": 1}
    sh = rules.lm_specs(leaves, mesh)
    gather = scatter = reduce = 0
    for k, v in leaves.items():
        nbytes = v.numel() * v.element_size()
        if any("data" in rules._axes(e) for e in sh[k].spec):
            gather += 2 * nbytes // 4
            scatter += nbytes
        else:
            reduce += (2 if k == "embed" else 1) * nbytes
    reduce += 4 + 4 * len(leaves)
    got = {k: c["bytes"] for k, c in rec["collectives"].items()}
    assert got == {"all-gather": gather, "reduce-scatter": scatter,
                   "all-reduce": reduce}
    assert rec["collective_bytes"] == gather + scatter + reduce


def test_not_ported_records():
    from repro_torch.configs import get_arch
    from repro_torch.launch import dryrun as DR
    for arch in ("bert4rec", "dien", "wide-deep", "dcn-v2"):
        for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
            rec = DR.run_cell(arch, shape, mesh="4x1")
            assert rec["mesh_program"] == "not ported", (arch, shape)
            assert rec["why"] and rec["n_devices"] == 4
    for s in get_arch("gat-cora")[1]:
        rec = DR.run_cell("gat-cora", s.name, mesh="2x2")
        assert (rec["mesh_program"] == "not ported") == (
            s.kind == "full_graph"), s.name


def test_mesh_names():
    from repro_torch.launch import dryrun as DR
    assert DR.mesh_shape("single") == {"data": 16, "model": 16}
    assert DR.mesh_shape("multi") == (("pod", 2), ("data", 16),
                                      ("model", 16))
    assert DR.mesh_shape("2x4") == {"data": 2, "model": 4}


@pytest.mark.parametrize("arch", ["phi3-mini-3.8b", "deepseek-coder-33b",
                                  "deepseek-moe-16b"])
def test_long_500k_fits_a_card_of_four(arch):
    """At full size on meta: one card's arguments alone (the 512k cache
    and the weights) exceed what a card can allocate; a card of (1, 4)
    fits its process's program."""
    from repro_torch.launch import dryrun as DR, specs
    from repro_torch.launch.mesh import HBM_BYTES
    one = specs.build_cell(arch, "long_500k")
    assert sum(DR.storage_bytes(one.args).values()) > HBM_BYTES
    del one
    rec = DR.run_cell(arch, "long_500k", mesh="1x4", search=False)
    assert rec["fits"] and rec["n_devices"] == 4
    assert rec["memory"]["reserved_needed"] <= HBM_BYTES
    assert rec["collective_bytes"] > 0

"""The port's boundaries: it imports nothing of JAX or of the JAX package,
its config mirrors the reference's, what earlier slices refused now runs,
and what has no single-card meaning (model parallelism over a mesh)
raises or is listed in ROADMAP.md as not ported."""
import ast
import dataclasses
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as jbase  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import webparf as tweb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PACKAGE_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
PORT_FILES = PACKAGE_FILES + [ROOT / "chip_smoke.py"] + sorted(
    (ROOT / "tools").glob("*.py")) + sorted(
    (ROOT / "examples").glob("torch_*.py")) + [
    ROOT / "tests" / "_torch_dist_play.py"]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_no_jax_and_no_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__"):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path.name} imports {bad}"


def test_crawl_config_mirrors_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tbase.CrawlConfig) == fields(jbase.CrawlConfig)
    assert tbase.CrawlConfig().n_slots == jbase.CrawlConfig().n_slots


def test_webparf_configs_mirror_reference():
    from repro.configs import webparf as jweb
    assert dataclasses.asdict(tweb.CONFIG) == dataclasses.asdict(jweb.CONFIG)
    assert dataclasses.asdict(tweb.reduced()) == \
        dataclasses.asdict(jweb.reduced())


@pytest.mark.parametrize("override", [
    dict(ordering="opic", telemetry=True),
    dict(ordering="opic_url", coordination="firewall"),
    dict(coordination="firewall"), dict(coordination="crossover"),
    dict(coordination="batched"), dict(telemetry=True),
    dict(rebalance_threshold=1.5)])
def test_unported_features_raise(override):
    """The crawl features earlier slices refused are ported: each builds
    and steps. What still raises is the reference's own config error:
    a rebalance threshold without telemetry."""
    from repro_torch.api import CrawlSession
    from repro_torch.core.stages import init_state
    cfg = tbase.scaled(tweb.reduced(), **override)
    assert init_state(cfg, 1, "cpu").stats.shape[0] == 1
    if cfg.rebalance_threshold > 0 and not cfg.telemetry:
        with pytest.raises(ValueError, match="telemetry"):
            CrawlSession(cfg, device="cpu")
        cfg = tbase.scaled(cfg, telemetry=True)
    rep = CrawlSession(cfg, device="cpu", n_shards=2).run(
        cfg.dispatch_interval)
    assert rep.fetched > 0 and (rep.telemetry is not None) == cfg.telemetry


def test_unported_shapes_raise():
    from repro_torch.api import CrawlSession
    from repro_torch.core.stages import init_state
    # any shard count that divides the domains and slots is ported
    assert init_state(tweb.reduced(), 2, "cpu").stats.shape[0] == 2
    with pytest.raises(ValueError, match="split"):
        init_state(tweb.reduced(), 3, "cpu")
    # extra stages are ported: a stage with no effect leaves the crawl as
    # it was
    plain = CrawlSession(tweb.reduced(), device="cpu").run(4)
    extra = CrawlSession(tweb.reduced(), device="cpu",
                         extra_stages=[lambda ctx, st, c: (st, c, {})]
                         ).run(4)
    assert (plain.urls == extra.urls).all()
    with pytest.raises(ValueError, match="auto"):
        init_state(tbase.scaled(tweb.reduced(), kernel_impl="ref"), 1, "cpu")
    with pytest.raises(KeyError, match="unknown coordination"):
        init_state(tbase.scaled(tweb.reduced(), coordination="nope"), 1,
                   "cpu")


def test_init_state_needs_a_card_by_default():
    from repro_torch.core.stages import init_state
    if torch.cuda.is_available():
        assert init_state(tweb.reduced(), 1, None).f_url.is_cuda
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            init_state(tweb.reduced(), 1, None)


def test_kernels_build_nothing_at_import():
    """Importing every module of the port neither builds nor needs nvcc."""
    import importlib
    for p in PACKAGE_FILES:
        rel = p.relative_to(ROOT / "src").with_suffix("")
        importlib.import_module(".".join(
            rel.parts[:-1] if rel.name == "__init__" else rel.parts))
    from repro_torch.kernels import all_kernels, launch_counts
    names = {"frontier_select", "select_harvest", "bloom", "dedup_deposit",
             "opic_update", "flash_attention", "bloom_packed",
             "dedup_deposit_packed", "flash_attention_tc"}
    assert {k.name for k in all_kernels()} == names
    assert all(k.source.exists() for k in all_kernels())
    assert set(launch_counts()) == names


DENSE_LMS = ("qwen2-1.5b", "phi3-mini-3.8b", "deepseek-coder-33b")
MOE_LMS = ("deepseek-moe-16b", "arctic-480b")


def test_lm_config_classes_mirror_reference():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tbase.LMConfig) == fields(jbase.LMConfig)
    assert fields(tbase.MoEConfig) == fields(jbase.MoEConfig)
    assert fields(tbase.ShapeSpec) == fields(jbase.ShapeSpec)
    assert [dataclasses.asdict(s) for s in tbase.LM_SHAPES] == \
        [dataclasses.asdict(s) for s in jbase.LM_SHAPES]
    moe = dict(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1)
    for kw in ({}, {"moe": "moe", "first_k_dense": 1}):
        kt = {k: tbase.MoEConfig(**moe) if v == "moe" else v
              for k, v in kw.items()}
        kj = {k: jbase.MoEConfig(**moe) if v == "moe" else v
              for k, v in kw.items()}
        t = tbase.LMConfig("x", 3, 64, 4, 2, 128, 256, qkv_bias=True, **kt)
        j = jbase.LMConfig("x", 3, 64, 4, 2, 128, 256, qkv_bias=True, **kj)
        assert (t.n_params, t.n_active_params, t.head_dim) == \
            (j.n_params, j.n_active_params, j.head_dim)


GNN_RECSYS = ("gat-cora", "bert4rec", "dien", "wide-deep", "dcn-v2")


@pytest.mark.parametrize("arch", DENSE_LMS + MOE_LMS + GNN_RECSYS
                         + ("webparf",))
def test_ported_arch_configs_mirror_reference(arch):
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    (tc, ts), (jc, js) = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tconfigs.get_reduced(arch)) == \
        dataclasses.asdict(jconfigs.get_reduced(arch))
    assert [dataclasses.asdict(s) for s in ts] == \
        [dataclasses.asdict(s) for s in js]
    if tc.family == "lm":
        assert tc.n_params == jc.n_params
    if tc.family == "recsys":
        assert tc.total_rows == jc.total_rows


@pytest.mark.parametrize("arch", GNN_RECSYS)
def test_unported_archs_raise(arch):
    """The GNN and RecSys archs earlier slices refused are ported: each
    resolves, mirrors the reference's config and shapes, and its shape
    cells resolve by name."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    assert arch in tconfigs.ARCH_NAMES and arch in jconfigs.ARCH_NAMES
    (tc, ts), (jc, js) = tconfigs.get_arch(arch), jconfigs.get_arch(arch)
    assert type(tc).__name__ == type(jc).__name__
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert dataclasses.asdict(tconfigs.get_reduced(arch)) == \
        dataclasses.asdict(jconfigs.get_reduced(arch))
    for s in js:
        assert dataclasses.asdict(tconfigs.get_shape(arch, s.name)) == \
            dataclasses.asdict(s)
    with pytest.raises(KeyError, match="no shape"):
        tconfigs.get_shape(arch, "nope")


def test_gnn_recsys_config_classes_mirror_reference():
    """GNNConfig, RecSysConfig (with ``total_rows``), GNN_SHAPES,
    RECSYS_SHAPES and the registry's 40 cells, field for field."""
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert fields(tbase.GNNConfig) == fields(jbase.GNNConfig)
    assert [(f.name, f.default_factory() if f.default_factory
             is not dataclasses.MISSING else f.default)
            for f in dataclasses.fields(tbase.RecSysConfig)] == \
        [(f.name, f.default_factory() if f.default_factory
          is not dataclasses.MISSING else f.default)
         for f in dataclasses.fields(jbase.RecSysConfig)]
    for name in ("GNN_SHAPES", "RECSYS_SHAPES"):
        assert [dataclasses.asdict(s) for s in getattr(tbase, name)] == \
            [dataclasses.asdict(s) for s in getattr(jbase, name)]
    t = tbase.RecSysConfig("x", "dien", 8, tables=dict(a=3, b=4))
    assert t.total_rows == jbase.RecSysConfig(
        "x", "dien", 8, tables=dict(a=3, b=4)).total_rows == 7
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    assert tconfigs.all_cells() == jconfigs.all_cells()
    assert len(tconfigs.all_cells()) == 40
    covered = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"src/repro_torch/models/gnn.py", "src/repro_torch/models/recsys.py",
            "src/repro_torch/data/sampler.py",
            "src/repro_torch/models/segment.py"} <= covered


def test_serve_and_init_lm_need_a_card_by_default():
    from repro_torch.configs import get_reduced
    from repro_torch.launch import serve
    from repro_torch.models import init_lm
    cfg = get_reduced("qwen2-1.5b")
    if torch.cuda.is_available():
        assert init_lm(cfg).embed.is_cuda
        assert serve.main(["--gen", "2"]) == 0
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            init_lm(cfg)
        with pytest.raises(RuntimeError, match="cuda"):
            serve.main(["--gen", "2"])
    assert serve.main(["--gen", "2", "--device", "cpu"]) == 0


def test_serve_and_quality_copies_mirror_reference():
    """The port copies of numpy-only modules (serve/load.py,
    ordering/quality.py, launch/trace_report.py) and the serve layer's
    signatures keep the reference's names and defaults; the sessions add
    only ``device`` and ``n_shards`` (the JAX mesh's counterpart)."""
    import inspect
    from repro import serve as jserve
    from repro.launch import trace_report as jtr
    from repro.ordering import quality as jq
    from repro_torch import serve as tserve
    from repro_torch.launch import trace_report as ttr
    from repro_torch.ordering import quality as tq

    def params(fn, drop=()):
        return [(p.name, p.default) for p in
                inspect.signature(fn).parameters.values()
                if p.name not in drop]
    assert params(tserve.QueryLoad) == params(jserve.QueryLoad)
    assert [f.name for f in dataclasses.fields(tserve.ServeReport)] == \
        [f.name for f in dataclasses.fields(jserve.ServeReport)]
    assert params(tserve.ServeSession, ("device", "n_shards")) == \
        params(jserve.ServeSession, ("mesh",))
    assert tq.HOT_THRESHOLD == jq.HOT_THRESHOLD
    for name in ("coverage_curve", "ordering_quality", "pooled_hot_set",
                 "hot_page_recall"):
        assert params(getattr(tq, name)) == params(getattr(jq, name))
    for name in ("load_trace", "telemetry_from_trace", "render_ledger_table",
                 "render_spans", "render_report", "main"):
        assert params(getattr(ttr, name)) == params(getattr(jtr, name))
    from repro.api import session as jsess
    from repro_torch.api import session as tsess
    assert params(tsess.CrawlSession, ("device", "n_shards")) == \
        params(jsess.CrawlSession, ("mesh", "axes"))


def test_train_cli_flags_mirror_reference():
    """The train CLI takes the reference's flags with their defaults, plus
    ``--device``."""
    import argparse
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    class Parsed(Exception):
        pass

    def flags(ap):
        return {a.dest: a.default for a in ap._actions
                if a.dest != "help"}
    seen = []

    def capture(self, argv=None, namespace=None):
        seen.append(self)
        raise Parsed

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(Parsed):
            jtrain.main([])
    finally:
        argparse.ArgumentParser.parse_args = orig
    want = flags(seen[0])
    got = flags(ttrain.build_parser())
    assert got.pop("device") == "cuda"
    assert got == want


def test_training_needs_a_card_by_default():
    from repro_torch.launch import train as ttrain
    argv = ["--steps", "1", "--crawl-steps", "1"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.main(argv)


def test_unported_training_raises():
    """What this test once refused now runs: GNN/RecSys training, and
    ``param_resharding`` (applied once a step before the microbatch loop,
    as the reference applies it). Without a process group
    ``--model-parallel`` other than 1 still raises: one card is the
    host's mesh, where the reference's ``make_host_mesh`` takes only 1
    too (under ``torch.distributed.run`` it trains on the mesh:
    ``tests/test_torch_dist_train.py``). Every name of the reference's
    recsys module resolves."""
    from repro.models import recsys as jrecsys
    from repro_torch.launch import train as ttrain
    from repro_torch.models import recsys
    from repro_torch.optim import adamw
    from repro_torch.train.trainer import init_train_state, make_train_step
    base = ["--steps", "1", "--crawl-steps", "1", "--device", "cpu"]
    for arch in ("gat-cora", "dcn-v2", "bert4rec"):
        assert ttrain.main(["--arch", arch] + base) == 0
    with pytest.raises(ValueError, match="one card"):
        ttrain.main(["--model-parallel", "2"] + base)
    state = ttrain.train_other(ttrain.build_parser().parse_args(
        ["--arch", "dcn-v2"] + base))
    assert int(state.step) == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ttrain.train_other(ttrain.build_parser().parse_args(
                ["--arch", "dcn-v2", "--steps", "1"]))
    seen = []
    step = make_train_step(lambda p, b: (p["w"] * b).sum() ** 2, adamw(),
                           microbatches=2,
                           param_resharding=lambda p: seen.append(1) or p)
    st, m = step(init_train_state({"w": torch.ones(2)}, adamw()),
                 torch.ones(4, 2))
    assert seen == [1] and int(st.step) == 1
    public = [n for n in vars(jrecsys) if not n.startswith("__")
              and n not in ("annotations", "math", "partial", "jax", "jnp",
                            "lax", "opt_barrier", "shard_map", "RecSysConfig",
                            "Any", "Dict", "NamedTuple", "Optional",
                            "Tuple", "Params")]
    missing = [n for n in public if not hasattr(recsys, n)]
    assert not missing, missing
    with pytest.raises(AttributeError):
        recsys.no_such_name


def _module_name(path: Path, package: str) -> str:
    rel = path.relative_to(ROOT / "src" / package).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join((package,) + parts)


# every module of the reference that has a port file at the same place, and
# that file: the Pallas kernel bodies (ported as csrc/*.cu) and compat.py
# have none
MODULES = {_module_name(p, "repro"): p for p in sorted(
    (ROOT / "src" / "repro").rglob("*.py"))
    if (ROOT / "src" / "repro_torch" / p.relative_to(
        ROOT / "src" / "repro")).exists()}


def _not_ported(ref_name: str) -> set:
    """The names ``ROADMAP.md`` lists under "Not ported" for the module: a
    bullet whose first line names the module's path (``launch/mesh.py``)
    names them."""
    import re
    text = (ROOT / "ROADMAP.md").read_text()
    i = text.index("### Not ported")
    section = text[i:text.index("\n### ", i + 1)]
    rel = MODULES[ref_name].relative_to(ROOT / "src" / "repro").as_posix()
    out = set()
    for bullet in re.split(r"\n- ", section)[1:]:
        if f"`{rel}`" in bullet.split("\n")[0]:
            out |= set(re.findall(r"`([A-Za-z_][A-Za-z0-9_]*)`", bullet))
    return out


def _reference_public(ref_name: str) -> list:
    """The public names a reference module defines at its top level
    (functions, classes, constants and type aliases; a package's
    ``__init__`` also what it imports from the package), read from its
    source: the reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` to 512
    host devices when imported, which would change every later JAX test
    of this process."""
    out = []
    init = MODULES[ref_name].name == "__init__.py"
    for node in ast.parse(MODULES[ref_name].read_text()).body:
        if init and isinstance(node, ast.ImportFrom) and (
                node.level or node.module.split(".")[0] == "repro"):
            out += [a.asname or a.name for a in node.names]
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.append(node.name)
        elif isinstance(node, ast.Assign):
            out += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(
                node.target, ast.Name):
            out.append(node.target.id)
    return [n for n in out if not n.startswith("_")]


def test_every_module_has_a_counterpart():
    """Each reference file without a port file at the same place is a
    Pallas kernel body (ported as ``csrc/*.cu``) or ``compat.py``, which
    ROADMAP.md lists as not ported."""
    ref = ROOT / "src" / "repro"
    rest = {p.relative_to(ref).as_posix() for p in ref.rglob("*.py")} - {
        MODULES[m].relative_to(ref).as_posix() for m in MODULES}
    assert {p for p in rest if p.startswith("kernels/")
            and (ref / p).read_text().count("pl.pallas_call(")} | {
        "compat.py"} == rest
    assert len(MODULES) > 60


@pytest.mark.parametrize("ref_name", sorted(MODULES))
def test_mesh_modules_mirror_reference(ref_name):
    """The reference's public names resolve in the port's counterpart,
    for every module (the name is from when only the five mesh-path
    modules were checked), apart from those ROADMAP.md lists as not
    ported for that module (no single-card meaning); the port file imports
    no JAX (checked above with every file of the package)."""
    import importlib
    port_path = ROOT / "src" / "repro_torch" / MODULES[ref_name].relative_to(
        ROOT / "src" / "repro")
    tmod = importlib.import_module(_module_name(port_path, "repro_torch"))
    public = _reference_public(ref_name)
    missing = [n for n in public if not hasattr(tmod, n)]
    assert set(missing) <= _not_ported(ref_name), sorted(
        set(missing) - _not_ported(ref_name))
    assert port_path in PORT_FILES


def test_latest_step_reads_as_the_reference(tmp_path):
    """``train/checkpoint.latest_step``: the newest complete checkpoint of
    a directory, None when there is none, as the reference reads it."""
    import numpy as np
    from repro.train import checkpoint as jckpt
    from repro_torch.train import checkpoint as tckpt
    d = str(tmp_path / "ckpt")
    assert tckpt.latest_step(d) is None is jckpt.latest_step(d)
    for step in (3, 12, 7):
        tckpt.save(d, step, {"w": np.arange(4, dtype=np.float32)})
    (tmp_path / "ckpt" / f"step_{99:010d}").mkdir()      # no manifest
    assert tckpt.latest_step(d) == jckpt.latest_step(d) == 12
    assert tckpt.load(d)["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_default_pipeline_and_opic_stages_mirror_reference():
    """``core/stages.DEFAULT_PIPELINE`` names the reference's stages in its
    order; the OPIC stage factories return the stages their orderings
    register; ``U32`` carries a uint32 id; ``ArchConfig`` covers every
    family's config."""
    import typing
    from repro.core import stages as jstages
    from repro_torch.configs import get_arch
    from repro_torch.core import stages, webgraph
    from repro_torch.ordering import get_ordering, opic, opic_url
    assert [f.__name__ for f in stages.DEFAULT_PIPELINE] == \
        [f.__name__ for f in jstages.DEFAULT_PIPELINE]
    assert opic.make_opic_update_stage() is \
        get_ordering("opic").update_stage
    assert opic_url.make_opic_url_update_stage() is \
        get_ordering("opic_url").update_stage
    assert torch.tensor([0xFFFFFFFF], dtype=webgraph.U32).item() == \
        0xFFFFFFFF
    kinds = typing.get_args(tbase.ArchConfig)
    for arch in ("qwen2-1.5b", "gat-cora", "dien", "webparf"):
        assert isinstance(get_arch(arch)[0], kinds), arch

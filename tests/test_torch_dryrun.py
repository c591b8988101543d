"""The port's dry run (``launch/specs.py`` + ``launch/dryrun.py``) against
the reference's cells, on the CPU, with nothing allocated.

- ``--list`` gives the reference's 40 cells.
- For every LM, GNN and RecSys cell the arguments' bytes equal the summed
  leaf bytes of ``jax.eval_shape`` over the reference's
  ``build_cell(...).args`` on a (1, 1) mesh, at the full configs. The crawl
  cell's state differs in one way only, named here: the port carries the
  URL lanes (``f_url``, ``staging_url``, ``outbox_url``) as int64 holding
  uint32 (8 bytes a URL, the reference's 4); every other leaf has the
  reference's shape and dtype.
- On the reduced Qwen2 and DeepSeekMoE prefills (4 x 256 tokens) the
  reckoned operations agree within 1% with
  ``benchmarks.hlo_analysis.analyze_hlo``'s dot FLOPs of the reference's
  lowered cell. XLA's chunked attention computes the full masked (S, S)
  square of both products, 4 B Hq S^2 hd a layer, where the port's kernel
  counts the causal half (``flash_attention.ops.attention_flops``), so the
  two attention counts are taken out and the rest compared.

``test_torch_dryrun_cells.py`` reckons every cell on meta.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import all_cells as jall_cells  # noqa: E402
from repro_torch.configs import all_cells, get_reduced  # noqa: E402
from repro_torch.launch import dryrun, specs  # noqa: E402

URL_LANES = ("f_url", "staging_url", "outbox_url")


def test_list_gives_reference_cells(capsys):
    assert dryrun.main(["--list"]) == 0
    got = [tuple(line.split()) for line in
           capsys.readouterr().out.splitlines()]
    assert got == [tuple(c) for c in jall_cells()]
    assert len(got) == 40


def _jax_cell(arch, shape):
    from repro.compat import make_mesh
    from repro.launch.specs import build_cell
    return build_cell(arch, shape, make_mesh((1, 1), ("data", "model")))


def _leaf_bytes(tree):
    return sum(int(np.prod(x.shape)) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


def _port_bytes(args):
    return sum(t.numel() * t.element_size()
               for t in dict((t.untyped_storage()._cdata, t)
                             for t in dryrun.tensors(args)).values())


@pytest.mark.parametrize("arch,shape", all_cells(),
                         ids=[f"{a}-{s}" for a, s in all_cells()])
def test_argument_bytes_match_reference(arch, shape):
    want = _leaf_bytes(_jax_cell(arch, shape).args)
    cell = specs.build_cell(arch, shape)
    assert _port_bytes(cell.args) == want


def test_crawl_state_differs_only_in_url_lanes():
    jstate = _jax_cell("webparf", "crawl_step").args[0]
    state = specs.build_cell("webparf", "crawl_step").args[0]
    for name, j, t in zip(state._fields, jstate, state):
        assert tuple(t.shape) == tuple(j.shape), name
        if name in URL_LANES:
            assert (np.dtype(j.dtype), t.dtype) == (np.uint32, torch.int64)
        else:
            assert np.dtype(str(t.dtype).split(".")[-1]) == \
                np.dtype(j.dtype), name
    extra = sum(getattr(state, n).numel() * 4 for n in URL_LANES)
    assert _port_bytes((state,)) == _leaf_bytes(jstate) + extra


# ---- reckoned operations against XLA's dot FLOPs ------------------------

FLOP_B, FLOP_S = 4, 256


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-moe-16b"])
def test_reckoned_flops_match_hlo_dots(arch):
    from benchmarks.hlo_analysis import analyze_hlo
    from repro.compat import make_mesh
    from repro.configs import get_reduced as jget
    from repro.configs.base import ShapeSpec as JShape
    from repro.launch.specs import _lm_cell
    mesh = make_mesh((1, 1), ("data", "model"))
    jcell = _lm_cell(arch, jget(arch), JShape(
        "p", "prefill", dict(seq_len=FLOP_S, global_batch=FLOP_B)), mesh)
    hlo = jax.jit(jcell.fn).lower(*jcell.args).compile().as_text()
    xla = analyze_hlo(hlo)["flops"]
    cfg = get_reduced(arch)
    rec = dryrun.run_cell(arch, "prefill_32k", cfg=cfg, batch=FLOP_B,
                          seq_len=FLOP_S)
    B, S, hd = FLOP_B, FLOP_S, cfg.head_dim
    square = cfg.n_layers * 4 * B * cfg.n_heads * S * S * hd
    kern = rec["cost"]["kernels"]
    causal = sum(kern[k]["flops"] for k in kern if k.startswith("flash"))
    assert causal == cfg.n_layers * 4 * B * cfg.n_heads * hd * \
        (S * (S + 1) // 2)
    rest_xla, rest_port = xla - square, rec["cost"]["flops"] - causal
    assert abs(rest_port / rest_xla - 1) <= 0.01, (rest_port, rest_xla)

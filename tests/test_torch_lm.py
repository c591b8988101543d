"""The port's dense LM serving path against the JAX reference, on the CPU.

The same weights (JAX's ``init_lm``, carried by ``params_from_numpy`` in the
reference's checkpoint form) and the same numpy inputs go through
``repro.models`` and ``repro_torch.models``, for the reduced qwen2-1.5b (QKV
bias, tied head, GQA group 2), phi3-mini-3.8b (untied head, group 1) and
deepseek-coder-33b (untied head, group 4, head dim 8).

Tolerances:
- float32: logits within 1e-4 and greedy tokens equal. Measured: at most
  2.4e-6 (different summation orders; logits of magnitude ~3).
- bfloat16: logits within 0.1 abs. Measured: at most 0.047 (qwen2) and
  0.039 (phi3).
- RoPE: the inverse frequencies equal bit for bit for every LM config's
  (head_dim, rope_theta) and a grid of both; ``apply_rope`` in f32 within
  1e-6 at positions near 32k and 512k, where ``pos * inv`` multiplies any
  error in the frequencies by the position (an f32 ``pow`` 1 ulp off gave
  2.66e-3 for phi3 at 524,272-524,287). The reference's ``chunked_attention`` rounds the scaled q
  and ``p`` to bf16; the port keeps both in f32, as the TPU kernel does
  (ROADMAP Queue 3), and JAX bf16 against JAX f32 already differs by
  ~0.04 here. Tokens are not compared in bf16: qwen2-smoke's top-2 margin
  can be 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jarch  # noqa: E402
from repro.configs import get_reduced as jget  # noqa: E402
from repro.configs.base import scaled as jscaled  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.train import checkpoint as JC  # noqa: E402
from repro_torch.configs import get_reduced as tget  # noqa: E402
from repro_torch.configs.base import scaled as tscaled  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.train import checkpoint as TC  # noqa: E402

ARCHS = ("qwen2-1.5b", "phi3-mini-3.8b", "deepseek-coder-33b")
LM_ARCHS = ("qwen2-1.5b", "phi3-mini-3.8b", "deepseek-coder-33b",
            "deepseek-moe-16b", "arctic-480b")
# (head_dim, rope_theta) of every LM config, full and reduced, then a grid
ROPE_PAIRS = sorted({(c.head_dim, c.rope_theta) for a in LM_ARCHS
                     for c in (jarch(a)[0], jget(a))} | {
    (hd, theta) for hd in (8, 16, 64, 96, 128)
    for theta in (1e4, 1e5, 5e5, 1e6)})
ROPE_POSITIONS = (32752, 524272)    # 16 positions from each
TOL = {"float32": 1e-4, "bfloat16": 0.1}
B, S = 2, 24


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=tol)


_PAIRS = {}


def pair(arch, dtype):
    """(JAX config, JAX params, port config, port model), built once."""
    if (arch, dtype) not in _PAIRS:
        jcfg = jscaled(jget(arch), dtype=dtype)
        tcfg = tscaled(tget(arch), dtype=dtype)
        params = JT.init_lm(jax.random.PRNGKey(0), jcfg)
        model = TT.params_from_numpy(tcfg, JC._flatten(params), device="cpu")
        _PAIRS[arch, dtype] = (jcfg, params, tcfg, model)
    return _PAIRS[arch, dtype]


def tokens(vocab, n=S, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (B, n))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_and_rope_match_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 4, S, 16)).astype(np.float32)
    scale = rng.random(16).astype(np.float32) + 0.5
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (B, S))
    jx = jnp.asarray(x, dtype)
    tx = torch.tensor(x).to(getattr(torch, dtype))
    tol = 1e-6 if dtype == "float32" else 1e-2
    _close(JL.rms_norm(jx, jnp.asarray(scale), 1e-6),
           TL.rms_norm(tx, torch.tensor(scale), 1e-6), tol)
    for theta in (1e4, 1e6):
        _close(JL.apply_rope(jx, jnp.asarray(pos)[:, None, :], theta),
               TL.apply_rope(tx, torch.tensor(pos)[:, None, :], theta), tol)


@pytest.mark.parametrize("hd,theta", ROPE_PAIRS,
                         ids=[f"hd{hd}-theta{t:g}" for hd, t in ROPE_PAIRS])
def test_rope_freqs_equal_reference_bit_for_bit(hd, theta):
    want = np.asarray(JL.rope_freqs(hd, theta))
    got = TL.rope_freqs(hd, theta).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), \
        np.nonzero(got != want)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_apply_rope_at_long_positions_matches_reference(arch):
    cfg = jarch(arch)[0]
    x = np.random.default_rng(5).standard_normal(
        (1, 2, 32, cfg.head_dim)).astype(np.float32)
    pos = np.concatenate([np.arange(p, p + 16) for p in ROPE_POSITIONS]
                         ).astype(np.float32)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), cfg.rope_theta)
    got = TL.apply_rope(torch.tensor(x), torch.tensor(pos), cfg.rope_theta)
    _close(want, got, 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_attn_block_matches_reference(arch, dtype):
    jcfg, params, tcfg, model = pair(arch, dtype)
    x = np.random.default_rng(2).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.float32), (B, S))
    lp = jax.tree.map(lambda a: a[0], params["layers"])
    want, _ = JL.attn_block(lp["attn"], jcfg, jnp.asarray(x, jcfg.dtype),
                            positions=jnp.asarray(pos))
    got, _ = TL.attn_block(model.layers[0].attn, tcfg,
                           torch.tensor(x).to(getattr(torch, dtype)),
                           positions=torch.tensor(pos))
    assert got.dtype == getattr(torch, dtype)
    _close(want, got, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """prefill_step's last logits and cache, then decode_step
    teacher-forced over 8 tokens from an empty cache."""
    jcfg, params, tcfg, model = pair(arch, dtype)
    toks = tokens(jcfg.vocab_size)
    jl, jc = jax.jit(lambda p, t: JT.prefill_step(p, jcfg, t))(
        params, jnp.asarray(toks))
    tl, tc = TT.prefill_step(model, torch.tensor(toks))
    assert tl.shape == (B, 1, jcfg.vocab_size) and tl.dtype == torch.float32
    assert tc.main_k.shape == jc.main_k.shape and int(tc.length[0]) == S
    _close(jl, tl, TOL[dtype])
    _close(jc.main_k, tc.main_k, TOL[dtype])
    _close(jc.main_v, tc.main_v, TOL[dtype])
    if dtype == "float32":
        assert np.array_equal(np.asarray(jl).argmax(-1), tl.argmax(-1))

    dec = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    jcache = JT.init_cache(jcfg, B, 8)
    tcache = TT.init_cache(tcfg, B, 8, device="cpu")
    for i in range(8):
        jl, jcache = dec(params, jnp.asarray(toks[:, i:i + 1]), jcache)
        tl, tcache = TT.decode_step(model, torch.tensor(toks[:, i:i + 1]),
                                    tcache)
        _close(jl, tl, TOL[dtype])
        if dtype == "float32":
            assert np.array_equal(np.asarray(jl).argmax(-1), tl.argmax(-1))
    assert int(tcache.length[0]) == 8
    _close(jcache.main_k, tcache.main_k, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference_greedy(arch):
    """The slice end to end in f32: ``serve`` against the reference's
    launcher loop (prefill, the cache grown to prompt + gen, greedy
    decode): the same tokens."""
    jcfg, params, tcfg, model = pair(arch, "float32")
    gen = 6
    toks = tokens(jcfg.vocab_size, n=12, seed=3)
    logits, cache = JT.prefill_step(params, jcfg, jnp.asarray(toks))

    def grow(x):
        return jnp.pad(x, ((0, 0), (0, 0), (0, 0), (0, gen), (0, 0)))
    cache = JT.LMCache(None, None, grow(cache.main_k), grow(cache.main_v),
                       cache.length)
    tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
    want = [tok]
    dec = jax.jit(lambda p, t, c: JT.decode_step(p, jcfg, t, c))
    for _ in range(gen - 1):
        logits, cache = dec(params, tok, cache)
        tok = jnp.argmax(logits[:, -1], axis=-1)[:, None]
        want.append(tok)
    got, t_pre, t_dec = serve(model, torch.tensor(toks), gen)
    assert got.shape == (B, gen) and t_pre > 0 and t_dec > 0
    assert np.array_equal(np.concatenate(want, 1), got.numpy())


def test_port_decode_matches_its_forward():
    """Teacher-forced decode reproduces the port's own full forward (the
    reference's test_prefill_decode_matches_forward, f32)."""
    _, _, tcfg, model = pair("qwen2-1.5b", "float32")
    toks = torch.tensor(tokens(tcfg.vocab_size, n=8))
    hidden, aux = TT.forward(model, toks)
    full = (hidden @ TT.lm_head_weight(model)).float()
    cache = TT.init_cache(tcfg, B, 8, device="cpu")
    outs = []
    for i in range(8):
        lg, cache = TT.decode_step(model, toks[:, i:i + 1], cache)
        outs.append(lg)
    _close(torch.cat(outs, 1), full, 1e-4)
    assert float(aux) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_mirrors_reference_shapes_and_scales(arch):
    jcfg, params, tcfg, _ = pair(arch, "bfloat16")
    model = TT.init_lm(tcfg, seed=0, device="cpu")
    want = JC._flatten(params)
    got = TT.params_to_numpy(model)
    assert set(got) == set(want)
    for key in want:
        assert got[key].shape == want[key].shape, key
        assert got[key].dtype.itemsize == want[key].dtype.itemsize, key
    vals = TT.params_to_numpy(TT.init_lm(tscaled(tcfg, dtype="float32"),
                                         seed=0, device="cpu"))
    assert np.std(vals["embed"]) == pytest.approx(tcfg.d_model ** -0.5,
                                                  rel=0.05)
    assert np.std(vals["layers/mlp/w_down"]) == pytest.approx(
        tcfg.d_ff ** -0.5, rel=0.05)
    assert (vals["layers/ln1"] == 1).all() and (vals["final_norm"] == 1).all()
    if tcfg.qkv_bias:
        assert (vals["layers/attn/bq"] == 0).all()
    again = TT.params_to_numpy(TT.init_lm(tcfg, seed=0, device="cpu"))
    assert all(np.array_equal(again[k], got[k]) for k in got)


def test_params_carry_through_a_reference_checkpoint(tmp_path):
    """A JAX LM checkpoint (bf16 leaves stored as npz voids) loads through
    the port's checkpoint reader into ``params_from_numpy`` bit for bit,
    and ``params_to_numpy`` gives the same bits back."""
    jcfg, params, tcfg, _ = pair("qwen2-1.5b", "bfloat16")
    JC.save(str(tmp_path), 3, params)
    flat = TC.load(str(tmp_path))
    model = TT.params_from_numpy(tcfg, flat, device="cpu")
    back = TT.params_to_numpy(model)
    want = JC._flatten(params)
    for key in want:
        a = want[key]
        b = back[key].view(a.dtype) if a.dtype.kind == "V" else back[key]
        assert a.tobytes() == b.tobytes(), key
    with pytest.raises(KeyError):
        TT.params_from_numpy(tcfg, {k: v for k, v in flat.items()
                                    if k != "embed"}, device="cpu")
    with pytest.raises(TypeError):
        TT.params_from_numpy(tcfg, {**flat, "embed": np.zeros(
            flat["embed"].shape, np.float32)}, device="cpu")

"""The port's ``flash_attention`` (its plain version, which the CPU runs)
against the JAX reference's ``attention``: ``impl="ref"`` (naive softmax)
over the sweep of tests/test_kernels.py and more head dims and lengths, and
``impl="interpret"`` (the Pallas kernel's body) on two cases.

Tolerances are the reference's own (tests/test_kernels.py): 2e-5 for f32,
2e-2 for bf16, as rtol = atol. The inputs are drawn with numpy and handed
to both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import attention as jattention  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_ref  # noqa: E402

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def inputs(B, Hq, Hkv, S, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, H, S, hd)).astype(np.float32)
            for H in (Hq, Hkv, Hkv)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, tx


def check(got, want, dtype):
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


SWEEP = [
    (1, 2, 2, 128, 32),
    (2, 4, 2, 128, 64),
    (1, 8, 1, 256, 64),     # MQA
    (2, 6, 2, 192, 32),     # group=3, non-pow2 S
    # the port's head dims and ragged lengths
    (2, 4, 2, 32, 16),      # the reduced configs' hd
    (1, 4, 4, 100, 8),      # deepseek-coder-smoke's hd, ragged tiles
    (1, 6, 1, 64, 96),      # phi3's hd, group 6
    (1, 12, 2, 160, 128),   # qwen2's heads and hd
]


@pytest.mark.parametrize("B,Hq,Hkv,S,hd", SWEEP)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_reference(B, Hq, Hkv, S, hd, causal, dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs(B, Hq, Hkv, S, hd, dtype,
                                        B * S + hd)
    want = jattention(jq, jk, jv, causal=causal, impl="ref")
    got = FA.attention(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    check(got, want, dtype)


@pytest.mark.parametrize("B,Hq,Hkv,S,hd,causal,dtype", [
    (2, 6, 2, 192, 32, True, "float32"),
    (1, 8, 1, 128, 64, False, "bfloat16"),
])
def test_plain_flash_matches_pallas_interpret(B, Hq, Hkv, S, hd, causal,
                                              dtype):
    (jq, jk, jv), (tq, tk, tv) = inputs(B, Hq, Hkv, S, hd, dtype, 5)
    want = jattention(jq, jk, jv, causal=causal, impl="interpret",
                      block_q=64, block_k=64)
    got = FA.attention(tq, tk, tv, causal=causal, block_q=64, block_k=64)
    check(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("group", [1, 3])
def test_attention_ref_matches_reference(group, causal):
    """``ref.attention_ref``, the reference's name for its plain attention
    on folded heads (BH, S, hd), against the reference's own."""
    from repro.kernels.flash_attention.ref import attention_ref as jref
    from repro_torch.kernels.flash_attention.ref import attention_ref
    (jq, jk, jv), (tq, tk, tv) = inputs(1, 2 * group, 2, 96, 32,
                                         "float32", 11)
    want = jref(jq[0], jk[0], jv[0], causal=causal, group=group)
    got = attention_ref(tq[0], tk[0], tv[0], causal=causal, group=group)
    check(got, want, "float32")


def test_plain_flash_block_size_invariance():
    _, (q, k, v) = inputs(1, 2, 2, 256, 32, "float32", 7)
    a = FA.attention(q, k, v, causal=True, block_q=64, block_k=64)
    b = FA.attention(q, k, v, causal=True, block_q=128, block_k=32)
    c = FA.attention(q, k, v, causal=True, block_k=100)   # ragged tiles
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)


def test_strided_views_fold_like_contiguous():
    """q, k, v as the projections make them ((B, S, H, hd) transposed):
    the GQA fold reads them right, and the result equals the contiguous
    inputs' bit for bit."""
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, hd = 2, 48, 6, 2, 16
    q, k, v = (torch.tensor(rng.standard_normal((B, S, H, hd)),
                            dtype=torch.float32).transpose(1, 2)
               for H in (Hq, Hkv, Hkv))
    assert not q.is_contiguous()
    got = FA.attention(q, k, v, causal=True)
    want = FA.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=True)
    assert torch.equal(got, want)
    # each query head reads KV head h // group
    ref0 = flash_ref(q[:, 4:5].reshape(B, S, hd), k[:, 1], v[:, 1],
                     causal=True)
    assert torch.equal(got[:, 4], ref0)


def test_masked_rows_and_tails():
    """Causal row 0 attends to key 0 alone (its output is v[0]); with
    Sq < Skv the keys past the last query add exactly nothing, whatever
    (finite) values they hold."""
    _, (q, k, v) = inputs(1, 2, 2, 70, 16, "float32", 13)
    out = FA.attention(q, k, v, causal=True, block_k=32)
    assert torch.equal(out[:, :, 0], v[:, :, 0])
    short = FA.attention(q[:, :, :40], k, v, causal=True, block_k=32)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 40:] *= 1e3
    v2[:, :, 40:] *= -1e3
    assert torch.equal(short, FA.attention(q[:, :, :40], k2, v2,
                                           causal=True, block_k=32))
    np.testing.assert_allclose(short.numpy(), out[:, :, :40].numpy(),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["shape", "group", "dtype", "block"])
def test_wrapper_rejects_what_it_does_not_take(bad):
    _, (q, k, v) = inputs(1, 4, 2, 32, 16, "float32", 0)
    kw = {}
    if bad == "shape":
        k = k[:, :, :, :8]
    elif bad == "group":
        q = q[:, :3]
    elif bad == "dtype":
        q = q.double()
    else:
        kw = {"block_k": 0}
    with pytest.raises((ValueError, TypeError)):
        FA.attention(q, k, v, **kw)


@pytest.mark.parametrize("device,dtype,hd,want", [
    ("cpu", "float32", 128, "plain"),
    ("cpu", "bfloat16", 128, "plain"),
    ("cuda", "bfloat16", 128, "flash_attention_tc"),
    ("cuda", "bfloat16", 96, "flash_attention_tc"),
    ("cuda", "bfloat16", 64, "flash_attention_tc"),
    ("cuda", "bfloat16", 32, "flash_attention"),
    ("cuda", "bfloat16", 16, "flash_attention"),
    ("cuda", "bfloat16", 8, "flash_attention"),
    ("cuda", "float32", 128, "flash_attention"),
    ("cuda", "float32", 64, "flash_attention"),
    ("cuda", "float32", 8, "flash_attention"),
    ("meta", "bfloat16", 128, "flash_attention_tc"),
    ("meta", "float32", 64, "flash_attention"),
])
def test_route_names_the_kernel(device, dtype, hd, want):
    """The route table: bf16 at the tensor-core head dims goes to
    flash_attention_tc, the rest of the card's cases to the CUDA-core
    kernel, the CPU to the plain version (no kernel: None); each kernel
    counts its own launches. On meta (the dry run's route) the kernel the
    card would launch records its work."""
    got = FA.route(device, getattr(torch, dtype), hd)
    if want == "plain":
        assert got is None
    else:
        assert got in (FA.KERNEL, FA.TC_KERNEL) and got.name == want


@pytest.mark.parametrize("device,dtype,hd", [("cuda", "float32", 48),
                                             ("cuda", "bfloat16", 40),
                                             ("xpu", "float32", 64)])
def test_route_refuses_what_no_kernel_takes(device, dtype, hd):
    with pytest.raises(ValueError):
        FA.route(device, getattr(torch, dtype), hd)

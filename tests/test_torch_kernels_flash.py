"""Port parity: the flash-attention wrappers and their plain versions.

On a CPU tensor ``repro_torch.kernels.flash_attention.ops`` runs the
kernel's plain version (the blocked online-softmax schedule). It is held
against the reference Pallas kernel in interpret mode on the grid of
``tests/test_kernels_flash.py``, at that file's tolerances: f32 atol 2e-5
(the two sum the same f32 products in another order), bf16 2e-2 (one bf16
rounding of the output, ~4e-3 relative, on values up to ~3), gradients
through the ``autograd.Function`` atol 1e-4. The LM-layout entry
(``ops.attention``, with ``q_offset`` and T != S) is held against the
reference's ``models.layers.xla_flash`` at ragged lengths, where the
kernel masks a short last tile. Its differentiable twin
(``ops.flash_attention_lm``, the chunked recompute backward
``ops.attention_backward``) is held against ``jax.vjp`` of ``xla_flash``
at atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro.models import layers as jlayers
from repro_torch.kernels.flash_attention import ops, ref

GRID = [
    (2, 4, 2, 256, 64, True, 0),
    (1, 8, 1, 128, 32, True, 64),     # MQA + sliding window
    (2, 4, 4, 256, 64, False, 0),     # encoder
    (1, 2, 2, 512, 128, True, 128),
]


def _qkv(seed, B, H, KH, S, D, T=None):
    rng = np.random.default_rng(seed)
    T = S if T is None else T
    return (rng.normal(0, 1, (B, H, S, D)).astype(np.float32),
            rng.normal(0, 1, (B, KH, T, D)).astype(np.float32),
            rng.normal(0, 1, (B, KH, T, D)).astype(np.float32))


@pytest.mark.parametrize("B,H,KH,S,D,causal,window", GRID)
def test_plain_version_matches_pallas_f32(B, H, KH, S, D, causal, window):
    q, k, v = _qkv(S + D, B, H, KH, S, D)
    scale = 1.0 / np.sqrt(D)
    want = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                   causal, window, 64, 64, True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), scale, causal, window)
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    oracle = ref.attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), scale=scale,
                               causal=causal, window=window)
    j_oracle = j_attention_ref(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), scale=scale, causal=causal,
                               window=window)
    np.testing.assert_allclose(oracle.numpy(), np.asarray(j_oracle),
                               atol=2e-5)


def test_plain_version_matches_pallas_bf16():
    q, k, v = _qkv(7, 2, 4, 2, 256, 64)
    jb = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)]
    want = j_flash(*jb, 0.125, True, 0, 128, 128, True)
    tb = [torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
          for x in jb]
    got = ops.flash_attention(*tb, 0.125, True, 0)
    assert got.dtype == torch.bfloat16
    err = np.max(np.abs(got.float().numpy()
                        - np.asarray(want, np.float32)))
    assert err < 2e-2


def test_gradients_match_reference():
    q, k, v = _qkv(3, 1, 2, 2, 128, 32)

    def f_jax(q, k, v):
        return jnp.sum(j_flash(q, k, v, 0.17, True, 0, 64, 64, True) ** 2)

    want = jax.grad(f_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (ops.flash_attention(tq, tk, tv, 0.17, True, 0) ** 2).sum().backward()
    for g, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("S,T,q_offset,causal,window", [
    (1, 1, 0, True, 0),
    (37, 37, 0, True, 0),
    (37, 37, 0, False, 16),
    (1, 40, 39, True, 8),               # one query after a prefix
    (50, 1100, 1050, True, 300),        # ragged key chunk past 1,024
    (70, 70, 0, False, 0),
])
def test_lm_layout_matches_xla_flash(S, T, q_offset, causal, window):
    B, H, KH, D = 2, 4, 2, 8
    q, k, v = _qkv(S + T, B, H, KH, S, D, T)
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
               for x in (q, k, v))                     # (B, S, H, D)
    want = jlayers.xla_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=0.3, causal=causal, window=window,
                             q_offset=q_offset)
    got = ops.attention(torch.from_numpy(q), torch.from_numpy(k),
                        torch.from_numpy(v), scale=0.3, causal=causal,
                        window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_strided_views_equal_contiguous():
    """The LM entry reads the projections' views as they are; the (B, H, S,
    D) entry hands the same data through transposed strides."""
    q, k, v = _qkv(11, 1, 4, 2, 45, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    a = ops.flash_attention(tq, tk, tv, 0.25, True, 20)
    b = ops.attention(tq.transpose(1, 2), tk.transpose(1, 2),
                      tv.transpose(1, 2), scale=0.25, causal=True, window=20)
    torch.testing.assert_close(a, b.transpose(1, 2), rtol=0, atol=0)


def test_wrapper_checks_and_no_silent_path():
    q, k, v = map(torch.from_numpy, _qkv(5, 1, 4, 2, 8, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k[:, :1].expand(1, 3, 8, 8), v, 0.3)
    with pytest.raises(TypeError):
        ops.flash_attention(q.double(), k.double(), v.double(), 0.3)
    with pytest.raises(ValueError):
        ops.attention(q.to("meta"), k.to("meta"), v.to("meta"), scale=0.3,
                      causal=True)
    with pytest.raises(RuntimeError):
        ops.attention(q.requires_grad_(), k, v, scale=0.3, causal=True)
    launches = ops.launches
    ops.attention(q.detach(), k, v, scale=0.3, causal=True)
    assert ops.launches == launches          # the CPU runs no kernel


def test_three_bf16_terms_hold_p_exactly():
    """The premise of the bf16 kernel's P.V on the tensor cores: each f32 p
    (an exp of a score at most 0) splits into p1 = bf16(p), p2 = bf16(p -
    p1), p3 = bf16(p - p1 - p2), which sum back to p exactly in f32 while
    the residuals stay normal (p >= 2^-80), and each term's product with a
    bf16 v is exact in f32; below that the sum misses by far less than the
    kernel's 2e-5 limit. Two terms miss by at most 2^-17 of p, one term (p
    rounded to bf16) by more than 2^-10 somewhere."""
    rng = np.random.default_rng(16)
    scores = rng.uniform(-104.0, 0.0, 200_000).astype(np.float32)
    p = torch.cat([torch.exp(torch.from_numpy(scores)),
                   torch.tensor([0.0, 1.0])])
    t1 = p.bfloat16()
    r1 = p - t1.float()
    t2 = r1.bfloat16()
    t3 = (r1 - t2.float()).bfloat16()
    terms = [t.float() for t in (t1, t2, t3)]
    normal = p >= 2.0 ** -80
    assert 0 < int((~normal).sum()) < p.numel()
    total = terms[0] + terms[1] + terms[2]
    assert torch.equal(total[normal], p[normal])
    assert float((total - p).abs().max()) <= 1e-38
    mag = torch.from_numpy(rng.uniform(0.01, 4.0, p.numel()).astype(
        np.float32))
    v = (mag * torch.from_numpy(rng.choice([-1.0, 1.0], p.numel()).astype(
        np.float32))).bfloat16().float()
    for t in terms:
        exact = t.double() * v.double()
        assert torch.equal((t * v).double()[normal], exact[normal])
    rel2 = ((terms[0] + terms[1]) - p).abs()[normal] / p[normal]
    rel1 = (terms[0] - p).abs()[normal] / p[normal]
    assert float(rel2.max()) <= 2.0 ** -17
    assert float(rel1.max()) > 2.0 ** -10


# (B, S, T, H, KH, D, causal, window, q_offset, block) of the LM-layout
# autograd entry: causal, sliding window, GQA, MQA (KH = 1), no mask, a
# ragged last query block (S % block != 0) and a continued prefill
LM_GRAD_CASES = [
    (2, 64, 64, 4, 2, 16, True, 0, 0, 16),
    (2, 70, 70, 4, 2, 8, True, 12, 0, 16),          # window, ragged
    (1, 50, 50, 8, 1, 16, True, 0, 0, 16),          # MQA, ragged
    (1, 45, 45, 4, 4, 8, False, 0, 0, 32),          # encoder, ragged
    (2, 33, 33, 6, 2, 8, False, 7, 0, 8),           # window, not causal
    (1, 20, 60, 4, 2, 8, True, 16, 40, 8),          # q_offset 40
]


def _lm_qkv(seed, B, S, T, H, KH, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (B, S, H, D)).astype(np.float32),
            rng.normal(0, 1, (B, T, KH, D)).astype(np.float32),
            rng.normal(0, 1, (B, T, KH, D)).astype(np.float32),
            rng.normal(0, 1, (B, S, H, D)).astype(np.float32))


@pytest.mark.parametrize("B,S,T,H,KH,D,causal,window,q_offset,block",
                         LM_GRAD_CASES)
def test_lm_layout_gradients_match_xla_flash_vjp(B, S, T, H, KH, D, causal,
                                                 window, q_offset, block,
                                                 monkeypatch):
    """``flash_attention_lm``'s forward and its chunked recompute backward
    against ``jax.vjp`` of the reference's ``xla_flash`` (JAX
    differentiates its scan), f32, atol 2e-5 / 1e-5 on each gradient (the
    same f32 products summed in another order)."""
    q, k, v, g = _lm_qkv(S * 7 + T, B, S, T, H, KH, D)
    kw = dict(scale=D ** -0.5, causal=causal, window=window,
              q_offset=q_offset)
    out, vjp = jax.vjp(lambda *a: jlayers.xla_flash(*a, **kw),
                       *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    monkeypatch.setattr(ops, "BWD_BLOCK", block)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ops.flash_attention_lm(tq, tk, tv, **kw)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               atol=2e-5)
    got.backward(torch.from_numpy(g))
    for t, w in zip((tq, tk, tv), want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=1e-5)


def test_lm_layout_gradients_bf16_in_input_types():
    q, k, v, g = _lm_qkv(2, 1, 40, 40, 4, 2, 16)
    tb = [torch.from_numpy(x).bfloat16().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention_lm(*tb, scale=0.25, causal=True, window=0)
    assert out.dtype == torch.bfloat16
    out.backward(torch.from_numpy(g).bfloat16())
    f32 = [x.detach().float().requires_grad_() for x in tb]
    ref.attention_ref(*(x.transpose(1, 2) for x in f32), scale=0.25,
                      causal=True).transpose(1, 2).backward(
        torch.from_numpy(g).bfloat16().float())
    for t, w in zip(tb, f32):
        assert t.grad.dtype == torch.bfloat16
        # the f32 gradient rounded once to bf16
        np.testing.assert_allclose(t.grad.float().numpy(), w.grad.numpy(),
                                   rtol=2 ** -8, atol=1e-6)


def test_chunked_backward_equal_at_two_block_sizes():
    """Blocks of 16 and 64 queries reach other key ranges (masked keys add
    exact zeros) and sum in other products: equal within 2e-6 (measured:
    9.5e-7 on dv)."""
    q, k, v, g = map(torch.from_numpy, _lm_qkv(4, 2, 90, 90, 4, 2, 16))
    kw = dict(scale=0.25, causal=True, window=30)
    a = ops.attention_backward(q, k, v, g, block=16, **kw)
    b = ops.attention_backward(q, k, v, g, block=64, **kw)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=2e-6, atol=2e-6)


def test_chunked_backward_largest_tensor_is_one_block():
    """Nothing of (B, H, S, T) is made: the largest tensor the backward
    allocates holds (B, H, block, T) f32 elements."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel,
                                        t.untyped_storage().nbytes() // 4)
            return out

    B, S, H, KH, D, block = 2, 256, 8, 2, 16, 32
    q, k, v, g = map(torch.from_numpy, _lm_qkv(5, B, S, S, H, KH, D))
    with Largest():
        ops.attention_backward(q, k, v, g, scale=0.25, causal=False,
                               window=0, block=block)
    assert Largest.numel == B * H * block * S
    # causal: a block reaches the keys up to its last query only
    Largest.numel = 0
    with Largest():
        ops.attention_backward(q, k, v, g, scale=0.25, causal=True,
                               window=0, block=block)
    assert Largest.numel == B * H * block * S


def test_differentiable_entries_launch_nothing_on_the_cpu():
    q, k, v, g = _lm_qkv(6, 1, 24, 24, 4, 2, 8)
    launches = ops.launches
    tq = torch.from_numpy(q).requires_grad_()
    ops.flash_attention_lm(tq, torch.from_numpy(k), torch.from_numpy(v),
                           scale=0.3, causal=True).sum().backward()
    assert tq.grad is not None and ops.launches == launches

"""Port parity: AdamW (``repro_torch.train.optimizer``) against
``repro.train.optimizer`` on the same numpy params, grads and state, over
three chained updates from each side: during warmup, past it, with the
global-norm clip active and inactive, with f32 and bf16 parameters.

Params, m, v, ``grad_norm`` and ``lr`` agree within 1e-6 relative, each
element against 1e-6 of itself plus 1e-6 of its leaf's largest value (a
moment that two steps of opposite sign bring near zero keeps the
absolute error of its terms). ``lr`` and the step count are
bitwise equal (the same f32 operations on the count); m and v are
bitwise equal where no clip scales the gradients (the same f32 products
and sums, element by element); the norm sums each leaf in another order
than XLA's reduction, so it and everything the clip scales agree to the
last bits only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import optimizer as jopt
from repro_torch.train import optimizer as topt

RTOL = 1e-6
SHAPES = {"a": (7, 5), "b": {"c": (3,), "d": (4, 6, 2)}, "e": (50,)}


def _tree(rng, scale, dtype=np.float32):
    def make(shape):
        if isinstance(shape, dict):
            return {k: make(v) for k, v in shape.items()}
        return (rng.normal(0, scale, shape)).astype(dtype)
    return make(SHAPES)


def _to_t(tree, dtype=None):
    return topt.tree_map(lambda x: torch.from_numpy(np.array(x, np.float32)
                                                    ).to(dtype or
                                                         torch.float32),
                         tree)


def _close(a, b, exact=False):
    a = np.asarray(a.float() if isinstance(a, torch.Tensor) else a,
                   np.float32)
    b = np.asarray(b, np.float32)
    if exact:
        assert np.array_equal(a, b)
    else:
        np.testing.assert_allclose(a, b, rtol=RTOL,
                                   atol=RTOL * float(np.abs(b).max()))


# (config, gradient scale, parameter type): warmup with the clip active,
# warmup without a clip, past warmup (warmup_steps=1) clipped and not,
# bf16 parameters
CASES = [
    (dict(), 1.0, "f32"),
    (dict(grad_clip=1e9), 0.05, "f32"),
    (dict(warmup_steps=1, lr=1e-2), 3.0, "f32"),
    (dict(warmup_steps=1, grad_clip=1e9, weight_decay=0.0), 0.2, "f32"),
    (dict(warmup_steps=2), 0.5, "bf16"),
]


@pytest.mark.parametrize("kw,gscale,ptype", CASES)
def test_update_matches_reference(kw, gscale, ptype):
    rng = np.random.default_rng(len(kw) + int(gscale * 10))
    jcfg, tcfg = jopt.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    pdt = (jnp.bfloat16, torch.bfloat16) if ptype == "bf16" else \
        (jnp.float32, torch.float32)
    p0 = _tree(rng, 1.0)
    jp = jax.tree.map(lambda x: jnp.asarray(x, pdt[0]), p0)
    tp = _to_t(jax.tree.map(lambda x: np.asarray(x, np.float32), jp),
               pdt[1])
    js, ts = jopt.init(jp), topt.init(tp)
    clipped = False
    for i in range(3):
        g = _tree(rng, gscale)
        jp, js, jm = jopt.update(jp, jax.tree.map(jnp.asarray, g), js, jcfg)
        tp, ts, tm = topt.update(tp, _to_t(g), ts, tcfg)
        gn = float(jm["grad_norm"])
        clipped |= gn > tcfg.grad_clip
        _close(tm["grad_norm"], jm["grad_norm"])
        _close(tm["lr"], jm["lr"], exact=True)
        assert int(ts.count) == int(js.count) == i + 1
        exact = gn <= tcfg.grad_clip and not clipped
        for a, b in zip(topt.tree_leaves(ts.m), jax.tree.leaves(js.m)):
            _close(a, b, exact=exact)
        for a, b in zip(topt.tree_leaves(ts.v), jax.tree.leaves(js.v)):
            _close(a, b, exact=exact)
        for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == pdt[1]
            if ptype == "bf16":
                # one bf16 rounding of a value within 1e-6 of the other's
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           rtol=2 ** -8)
            else:
                _close(a, b)
    assert clipped == (kw.get("grad_clip", 1.0) < 1e9 and gscale >= 0.5)


def test_global_norm_and_init():
    rng = np.random.default_rng(9)
    g = _tree(rng, 2.0)
    np.testing.assert_allclose(float(topt.global_norm(_to_t(g))),
                               float(jopt.global_norm(g)), rtol=RTOL)
    st = topt.init(_to_t(g, torch.bfloat16))
    assert st.count.dtype == torch.int32 and int(st.count) == 0
    for m in topt.tree_leaves(st.m) + topt.tree_leaves(st.v):
        assert m.dtype == torch.float32 and not bool(m.any())


def test_tree_helpers_keep_flatten_order():
    tree = {"z": [torch.zeros(1), torch.ones(2)], "a": torch.full((3,), 2.)}
    leaves = topt.tree_leaves(tree)
    assert [x.numel() for x in leaves] == [3, 1, 2]     # sorted keys
    back = topt.tree_unflatten(tree, [x + 1 for x in leaves])
    assert torch.equal(back["z"][1], torch.full((2,), 2.))
    assert torch.equal(topt.tree_map(lambda x: x * 2, tree)["a"],
                       torch.full((3,), 4.))

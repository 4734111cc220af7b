"""The port's sharding planner (``repro_torch.models.sharding_plan``) and
step inputs (``repro_torch.launch.steps``) against the reference's, on the
reference's ``jax.sharding.AbstractMesh`` (no devices) at the production
sizes, for every arch of ``ALL_ARCHS`` (full and smoke configs) on meshes
(1, 1), (2, 2), (16, 16) and (2, 16, 16):

* ``param_spec`` of every parameter leaf equals the reference's function
  on the same per-layer shape; against the reference's stacked
  ``params_pspecs``, matched by path with the stack dims dropped, every
  leaf is equal except the dense MLP weights: the reference's rule reads
  a stacked (layers, D, F) weight as an MoE (experts, D, F) one and puts
  the layer dim on ``model``, while the port's per-layer (D, F) weight
  gets the 2-D rule, F on ``model``;
* ``cache_pspecs`` (decode_32k and long_500k caches), ``batch_pspecs``,
  ``make_shard_fns``' names and specs, ``input_specs`` and
  ``microbatches_for`` equal the reference's;
* the parameters a rank on the production meshes: llama3.2-1b's
  4,894,720 on 16 x 16 (the reference's too), kimi-k2's on 2 x 16 x 16 the
  reference's 2,013,760,000 less the one difference above (its dense
  prefix MLP split over the data axes only there).

Each (arch, mesh) is one case of one test, plus the reference's
``test_skip_rules`` cases.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_arch as j_get_arch
from repro.launch import steps as jsteps
from repro.models import sharding_plan as jsp
from repro.models.transformer import init_cache as j_init_cache
from repro.models.transformer import init_params as j_init_params
from repro_torch.configs import ALL_ARCHS, SHAPES, get_arch, shape_applicable
from repro_torch.dist.sharding import Mesh
from repro_torch.launch import steps
from repro_torch.models import sharding_plan as sp
from repro_torch.models.transformer import (group_pattern, init_cache,
                                            init_params)

MESHES = {"1x1": ((1, 1), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
MLP = ("w_gate", "w_up", "w_down")


def _meshes(key):
    shape, names = MESHES[key]
    return (AbstractMesh(shape, names),
            Mesh(shape, names, None, 0, int(np.prod(shape)),
                 torch.device("cpu")))


def _fake(fn):
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn()


def _ref_layer(cfg, i):
    """The reference's (subtree path, stack index) of the port's layer i."""
    if i < cfg.first_dense:
        return ("prefix", "l0"), i
    j = i - cfg.first_dense
    n = len(group_pattern(cfg))
    return ("blocks", f"l{j % n}"), j // n


def _port_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _port_leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _port_leaves(x, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _ref_of(cfg, path):
    """The reference tree's path of a port leaf path; the number of stack
    dims to drop."""
    if path[0] != "layers":
        return path, 0
    sub, _ = _ref_layer(cfg, path[1])
    return sub + tuple(path[2:]), 1


def _entry(e):
    """One spec entry in PartitionSpec's normal form (a 1-tuple of axes is
    its axis, an empty one None)."""
    if isinstance(e, tuple):
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


def _norm(spec, ndim):
    """A spec as a tuple of ndim normalized entries (a PartitionSpec may
    be short)."""
    return tuple(_entry(e) for e in tuple(spec) + (None,) * (ndim -
                                                            len(spec)))


def _check_params(cfg, jcfg, jm, pm):
    port = _fake(lambda: init_params(cfg, 0, device="cpu"))
    pspecs = sp.params_pspecs(port, pm)
    ref_shapes = jax.eval_shape(functools.partial(j_init_params, jcfg),
                                jax.random.PRNGKey(0))
    ref_specs = jsp.params_pspecs(ref_shapes, jm)
    n = 0
    for path, leaf in _port_leaves(port):
        name = path[-1]
        shape = tuple(leaf.shape)
        got = _norm(_get(pspecs, path), len(shape))
        # the same rule on the same per-layer shape
        assert got == _norm(jsp.param_spec(name, shape, jm), len(shape)), \
            (cfg.name, path)
        rpath, lead = _ref_of(cfg, path)
        rshape = tuple(_get(ref_shapes, rpath).shape)
        assert rshape[lead:] == shape, (cfg.name, path, rshape, shape)
        rspec = _norm(_get(ref_specs, rpath), len(rshape))[lead:]
        if lead and name in MLP and len(shape) == 2:
            # the reference's 3-D rule on a stacked dense MLP weight
            continue
        assert got == rspec, (cfg.name, path, got, rspec)
        n += 1
    assert n > 0
    return port, pspecs


def _check_caches(cfg, jcfg, jm, pm):
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if not shape_applicable(cfg, shape)[0]:
            continue
        B, S = shape.global_batch, shape.seq_len
        cache = init_cache(cfg, B, S, device="meta")
        got = sp.cache_pspecs(cfg, cache, B, pm)
        ref_shape = jax.eval_shape(functools.partial(j_init_cache, jcfg, B,
                                                     S))
        ref = jsp.cache_pspecs(jcfg, ref_shape, B, jm)
        for path, leaf in _port_leaves(cache):
            layer, key = path[1], path[2]
            sub, _ = _ref_layer(cfg, layer)
            rleaf = ref_shape[sub[0]][sub[1]][key]
            rspec = _norm(ref[sub[0]][sub[1]][key], rleaf.ndim)
            assert tuple(rleaf.shape[1:]) == tuple(leaf.shape)
            assert _norm(_get(got, path), leaf.ndim) == rspec[1:], \
                (cfg.name, shape_name, path)


def _check_inputs(arch, cfg, jcfg, jm, pm):
    fns = sp.make_shard_fns(cfg, pm, 256)
    jfns = jsp.make_shard_fns(jcfg, jm, 256)
    assert set(fns) == set(jfns)
    for name, fn in jfns.items():
        ns = fn.__closure__[0].cell_contents
        n = len(fns.specs[name])
        assert _norm(ns.spec, n) == _norm(fns.specs[name], n), (arch, name)
    if cfg is not get_arch(arch).config:
        return
    for shape_name, shape in SHAPES.items():
        ok, _ = shape_applicable(cfg, shape)
        assert ok == shape_applicable(jcfg, J_SHAPES[shape_name])[0]
        if not ok:
            continue
        got = steps.input_specs(arch, shape_name)
        want = jsteps.input_specs(arch, shape_name)
        assert list(got) == list(want)
        for k in got:
            assert tuple(got[k].shape) == tuple(want[k].shape)
            assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype)
        if shape.kind in ("train", "prefill"):
            b = sp.batch_pspecs(cfg, shape.kind, shape.global_batch, pm, got)
            jb = jsp.batch_pspecs(jcfg, shape.kind, shape.global_batch, jm,
                                  want)
            assert {k: _norm(v, len(got[k].shape)) for k, v in b.items()} \
                == {k: _norm(v, len(want[k].shape)) for k, v in jb.items()}
        assert steps.microbatches_for(arch, shape_name, pm) == \
            jsteps.microbatches_for(arch, shape_name, jm)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_plan_equals_reference(arch, mesh):
    jm, pm = _meshes(mesh)
    spec, jspec = get_arch(arch), j_get_arch(arch)
    for cfg, jcfg in ((spec.smoke, jspec.smoke), (spec.config,
                                                  jspec.config)):
        assert cfg == type(cfg)(**{f: getattr(jcfg, f)
                                   for f in cfg.__dataclass_fields__})
        _check_params(cfg, jcfg, jm, pm)
        _check_caches(cfg, jcfg, jm, pm)
        _check_inputs(arch, cfg, jcfg, jm, pm)


def _rank_params(arch, mesh):
    _, pm = _meshes(mesh)
    cfg = get_arch(arch).config

    def count():
        p = init_params(cfg, 0, device="cpu")
        return sp.planned_bytes(p, sp.params_pspecs(p, pm), pm) // 4, p
    return _fake(count)


def test_params_a_rank_on_the_production_meshes():
    n, _ = _rank_params("llama3.2-1b", "16x16")
    assert n == 4_894_720
    n, p = _rank_params("kimi-k2-1t-a32b", "2x16x16")
    # the reference splits the dense prefix layer's MLP over the 32 data
    # ranks only (module doc); the port splits its F over the model axis
    mlp = sum(t.numel() for t in p["layers"][0]["mlp"].values())
    assert n == 2_013_760_000 - (mlp // 32 - mlp // 512)


def test_skip_rules():
    assert not shape_applicable(get_arch("gemma-2b").config,
                                SHAPES["long_500k"])[0]
    assert not shape_applicable(get_arch("hubert-xlarge").config,
                                SHAPES["decode_32k"])[0]
    assert shape_applicable(get_arch("mamba2-130m").config,
                            SHAPES["long_500k"])[0]
    assert shape_applicable(get_arch("h2o-danube-3-4b").config,
                            SHAPES["long_500k"])[0]
    assert shape_applicable(get_arch("jamba-1.5-large-398b").config,
                            SHAPES["long_500k"])[0]


def test_spec_to_placements():
    """A dim split over ("pod", "data") is Shard(d) on both mesh dims, in
    mesh order; other mesh dims replicate."""
    from torch.distributed.tensor import Replicate, Shard
    _, pm = _meshes("2x16x16")
    assert sp.placements(pm, sp.P(("pod", "data"), "model"), 2) == \
        [Shard(0), Shard(0), Shard(1)]
    assert sp.placements(pm, sp.P(None, "model"), 3) == \
        [Replicate(), Replicate(), Shard(1)]
    with pytest.raises(ValueError):
        sp.placements(pm, sp.P(("data", "pod")), 1)
    assert isinstance(sp.P("data"), tuple) and \
        tuple(PartitionSpec("data")) == tuple(sp.P("data"))

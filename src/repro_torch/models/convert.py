"""Carry the JAX package's LM parameters and caches into the port, and the
port's caches back out as numpy.

``params_from_jax`` takes the reference's parameter pytree
(``repro.models.transformer.init_params``) with numpy leaves
(``jax.tree.map(np.asarray, params)``), unstacks the leading layer axis of
``"prefix"`` and the group axis of ``"blocks"`` (``l0``..``l{size-1}`` of
each group, in layer order) into one dict per layer, and returns the
port's parameters (``transformer`` layout). A tied ``"embed"`` serves as
the head, as in the reference: no ``"head"`` entry is made for it; a model
that takes embeddings has no ``"embed"``.

``cache_from_jax`` does the same for the reference's cache
(``init_cache`` or a prefill's), and ``cache_to_numpy`` returns a port
cache as one dict of numpy arrays a layer, so that the two packages'
caches compare layer by layer.

``train_state_from_jax`` carries the reference's ``TrainState`` (params,
``OptState(m, v, count)``, step; numpy leaves) into the port's
``train_step.TrainState``: m and v have the params' structure and are
unstacked the same way. ``train_state_to_numpy`` returns a port state
with numpy leaves, in the port's per-layer layout (a DTensor leaf as its
full array, gathered: every rank of its mesh must make the call).
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from ..device import resolve_device
from ..train.optimizer import OptState, tree_map
from ..train.train_step import TrainState
from .transformer import group_pattern, n_groups


def _tensors(tree, index, dev):
    if isinstance(tree, dict):
        return {k: _tensors(v, index, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    a = a if index is None else a[index]
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch twin
        return torch.from_numpy(a.astype(np.float32)).to(
            dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _unstack(tree, cfg, dev) -> List[Dict[str, Any]]:
    """The reference's stacked ``prefix`` and ``blocks`` -> one entry a
    layer, in the port's order."""
    out = [_tensors(tree["prefix"]["l0"], i, dev)
           for i in range(cfg.first_dense)]
    pattern = group_pattern(cfg)
    out += [_tensors(tree["blocks"][f"l{i}"], g, dev)
            for g in range(n_groups(cfg)) for i in range(len(pattern))]
    return out


def params_from_jax(tree: Dict[str, Any], cfg, device="cuda"
                    ) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy leaves) -> port parameters
    on ``device``."""
    dev = resolve_device(device)
    p = {}
    if cfg.embed_input:
        p["embed"] = _tensors(tree["embed"], None, dev)
    p["layers"] = _unstack(tree, cfg, dev)
    p["final_norm"] = _tensors(tree["final_norm"], None, dev)
    if "head" in tree:
        p["head"] = _tensors(tree["head"], None, dev)
    return p


def cache_from_jax(tree: Dict[str, Any], cfg, device="cuda"
                   ) -> Dict[str, Any]:
    """The reference's cache pytree (numpy leaves) -> a port cache on
    ``device``, in the reference's types."""
    return {"layers": _unstack(tree, cfg, resolve_device(device))}


def cache_to_numpy(cache: Dict[str, Any]) -> List[Dict[str, np.ndarray]]:
    """A port cache -> one dict of numpy arrays a layer (bf16 entries as
    f32, which holds them exactly)."""
    return [{k: _numpy(v) for k, v in layer.items()}
            for layer in cache["layers"]]


def _numpy(t) -> np.ndarray:
    from .sharding_plan import _is_dtensor
    if _is_dtensor(t):
        t = t.full_tensor()             # a collective every rank joins
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def train_state_from_jax(state, cfg, device="cuda"):
    """The reference's ``TrainState`` (numpy leaves) -> the port's on
    ``device``."""
    dev = resolve_device(device)
    params, (m, v, count), step = state
    return TrainState(params_from_jax(params, cfg, dev),
                      OptState(params_from_jax(m, cfg, dev),
                               params_from_jax(v, cfg, dev),
                               _tensors(count, None, dev)),
                      _tensors(step, None, dev))


def train_state_to_numpy(state):
    """A port ``TrainState`` -> the same structure with numpy leaves (bf16
    as f32, which holds it exactly)."""
    return tree_map(_numpy, state)

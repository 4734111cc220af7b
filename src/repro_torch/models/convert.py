"""Carry the JAX package's LM parameters into the port.

``params_from_jax`` takes the reference's parameter pytree
(``repro.models.transformer.init_params``) with numpy leaves
(``jax.tree.map(np.asarray, params)``), unstacks the leading group axis of
``"blocks"`` into one dict per layer, and returns the port's parameters
(``transformer`` layout). A tied ``"embed"`` serves as the head, as in the
reference: no ``"head"`` entry is made for it.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import resolve_device
from .transformer import check_ported, group_pattern, n_groups


def _tensors(tree, index, dev):
    if isinstance(tree, dict):
        return {k: _tensors(v, index, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    return torch.from_numpy(np.array(a if index is None else a[index])
                            ).to(dev)


def params_from_jax(tree: Dict[str, Any], cfg, device="cuda"
                    ) -> Dict[str, Any]:
    """The reference's parameter pytree (numpy leaves) -> port parameters
    on ``device``."""
    check_ported(cfg)
    dev = resolve_device(device)
    pattern = group_pattern(cfg)
    layers = [_tensors(tree["blocks"][f"l{i}"], g, dev)
              for g in range(n_groups(cfg)) for i in range(len(pattern))]
    p = {"embed": _tensors(tree["embed"], None, dev), "layers": layers,
         "final_norm": _tensors(tree["final_norm"], None, dev)}
    if "head" in tree:
        p["head"] = _tensors(tree["head"], None, dev)
    return p

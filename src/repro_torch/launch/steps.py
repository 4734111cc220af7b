"""Step builders for the dry run and launchers: the port of
``repro/launch/steps.py``. Per (arch x shape x mesh), ``build_step``
returns the step as a callable and stand-ins for every argument, placed
by the plan (``models/sharding_plan``).

The reference's ``jax.ShapeDtypeStruct`` is ``TensorSpec`` here, a
(shape, dtype) record (``input_specs``). A stand-in is a DTensor whose
local block is an uninitialized tensor of the rank's local shape: under
``FakeTensorMode`` (the dry run) it allocates nothing, on a real mesh it
is each rank's shard. The full shapes come from the model's own
``init_params``/``init_cache``, run on fake tensors or on the meta
device.

``roofline=True`` is kept and recorded: the port has no layer scan to
unroll (every layer and every microbatch is a step of a Python loop, so
each one is counted already), so the flag changes nothing else.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..configs import SHAPES, get_arch, shape_applicable
from ..models import sharding_plan as sp
from ..train.optimizer import AdamWConfig


class TensorSpec(NamedTuple):
    """The reference's ``ShapeDtypeStruct``: a shape and a dtype."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def input_specs(arch_id: str, shape_name: str) -> Dict[str, TensorSpec]:
    """TensorSpecs for the model inputs of this (arch, shape) cell."""
    cfg = get_arch(arch_id).config
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        if cfg.embed_input:
            specs["tokens"] = TensorSpec((B, S), torch.int32)
        else:
            specs["embeds"] = TensorSpec((B, S, cfg.d_model), torch.bfloat16)
        if cfg.m_rope:
            specs["pos3"] = TensorSpec((3, B, S), torch.int32)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, S), torch.int32)
    else:  # decode
        if cfg.embed_input:
            specs["token"] = TensorSpec((B,), torch.int32)
        else:
            specs["token"] = TensorSpec((B, cfg.d_model), torch.bfloat16)
        specs["pos"] = TensorSpec((B,), torch.int32)
    return specs


def microbatches_for(arch_id: str, shape_name: str, mesh) -> int:
    spec = get_arch(arch_id)
    mu = spec.microbatch_overrides.get(shape_name, 1)
    shape = SHAPES[shape_name]
    dp_size = sp.sh.axis_size(mesh, sp._dp_axes(mesh))
    while mu > 1 and (shape.global_batch // mu) % dp_size != 0:
        mu //= 2
    return max(mu, 1)


def stand_in(mesh, shape, dtype, spec):
    """A DTensor of global ``shape`` placed by ``spec`` whose local block
    is uninitialized (module doc)."""
    shape = torch.Size(shape)
    pl = sp.placements(mesh, spec, len(shape))
    local, _ = sp.local_box(shape, mesh.shape,
                            [mesh.coords()[a] for a in mesh.axis_names], pl)
    t = torch.empty(tuple(local), dtype=dtype, device=mesh.device)
    return sp.wrap_global(mesh, t, pl, shape)


def _stand_ins(mesh, tree, specs, dtype=None):
    return sp._zip_specs(
        lambda t, s: stand_in(mesh, t.shape, dtype or t.dtype, s), tree,
        specs)


def build_step(arch_id: str, shape_name: str, mesh, *,
               adamw: AdamWConfig = AdamWConfig(), roofline: bool = False):
    """-> (step, args): ``step(*args)`` runs the cell's step (train,
    prefill, encoder forward or decode) on the mesh; ``args`` are
    stand-ins in the plan's placements. Run it under ``FakeTensorMode``
    to allocate nothing (``launch/dryrun.py``)."""
    from ..models.transformer import apply_model, init_params
    from ..train.optimizer import OptState
    from ..train.serve_step import make_decode_step, make_prefill_step
    from ..train.train_step import TrainState, make_train_step
    spec = get_arch(arch_id)
    cfg = spec.config
    if roofline:
        cfg = dataclasses.replace(cfg, unroll_layers=True)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch_id} x {shape_name} skipped: {why}")
    B = shape.global_batch
    batch_specs = input_specs(arch_id, shape_name)
    shard_fns = sp.make_shard_fns(cfg, mesh, B)
    full = init_params(cfg, 0, device=mesh.device)      # shapes only
    pspecs = sp.params_pspecs(full, mesh)
    params = _stand_ins(mesh, full, pspecs)
    del full

    def batch_of(kind):
        bspecs = sp.batch_pspecs(cfg, kind, B, mesh, batch_specs)
        return {k: stand_in(mesh, v.shape, v.dtype, bspecs[k])
                for k, v in batch_specs.items()}

    if shape.kind == "train":
        mu = microbatches_for(arch_id, shape_name, mesh)
        state = TrainState(
            params, OptState(_stand_ins(mesh, params, pspecs, torch.float32),
                             _stand_ins(mesh, params, pspecs, torch.float32),
                             torch.zeros((), dtype=torch.int32,
                                         device=mesh.device)),
            torch.zeros((), dtype=torch.int32, device=mesh.device))
        fn = make_train_step(cfg, adamw, microbatches=mu,
                             shard_fns=shard_fns,
                             grad_shardings=sp.Shardings(mesh, pspecs))
        return fn, (state, batch_of("train"))

    if shape.kind == "prefill":
        batch = batch_of("prefill")
        if not cfg.has_decode:
            @torch.inference_mode()
            def enc_fn(params, batch):
                logits, _, _ = apply_model(params, cfg, batch,
                                           shard_fns=shard_fns)
                return logits
            return enc_fn, (params, batch)
        fn = make_prefill_step(cfg, shard_fns=shard_fns,
                               max_len=shape.seq_len)
        return fn, (params, batch)

    # decode
    from ..models.transformer import init_cache
    cache = init_cache(cfg, B, shape.seq_len, shard_fns=shard_fns,
                       device=mesh.device)
    dp = sp._dp_axes(mesh)
    tok_ax = dp if B % sp.sh.axis_size(mesh, dp) == 0 else None
    tok = batch_specs["token"]
    token = stand_in(mesh, tok.shape, tok.dtype,
                     sp.P(tok_ax) if cfg.embed_input else sp.P(tok_ax, None))
    pos = stand_in(mesh, batch_specs["pos"].shape, torch.int32, sp.P(tok_ax))
    fn = make_decode_step(cfg, shard_fns=shard_fns)
    return fn, (params, cache, token, pos)


# --------------------------------------------------------- MSA (paper) cells

MSA_CELLS = {
    # name: (N sequences, padded length, method, alphabet, k, map_chunks)
    "halign-dna-1000x": (671744, 16576, "kmer", "dna", 11, 1),
    "halign-rna-large": (1011712, 1600, "kmer", "dna", 11, 1),
    "halign-protein-100x": (1789952, 512, "sw", "protein", 0, 1),
    # the local shard processed in sequential chunks to bound a rank's
    # temporary memory
    "halign-dna-1000x-chunked": (671744, 16576, "kmer", "dna", 11, 8),
    "halign-protein-100x-chunked": (1789952, 512, "sw", "protein", 0, 8),
}


def build_msa_step(cell: str, mesh):
    """The distributed center-star MSA (the paper's own workload) for this
    cell: -> (fn, args), ``fn(Q, lens, center, lc[, table])`` the
    pipeline of ``dist/mapreduce.py`` and ``args`` TensorSpecs of the
    rank's arguments (its block of Q and lens, the broadcast center, its
    length, the k-mer table), as the reference's ShapeDtypeStructs."""
    from ..core import alphabet as ab
    from ..dist import mapreduce
    N, L, method, alpha_name, k, map_chunks = MSA_CELLS[cell]
    alpha = ab.PROTEIN if alpha_name == "protein" else ab.DNA
    sub = (ab.blosum62() if alpha_name == "protein"
           else ab.dna_matrix()).astype("float32")
    out_len = L + 4096
    fn = mapreduce.distributed_center_star(
        mesh, method=method, sub=sub, gap_code=alpha.gap_code,
        out_len=out_len, num_slots=L + 1,
        gap_open=11 if alpha_name == "protein" else 3, gap_extend=1,
        k=k or 11, max_anchors=256, max_seg=64, map_chunks=map_chunks)
    n_data = mesh.axis_sizes["data"]        # rows split over "data" only
    args: Tuple[Any, ...] = (TensorSpec((N // n_data, L), torch.int8),
                             TensorSpec((N // n_data,), torch.int32),
                             TensorSpec((L,), torch.int8),
                             TensorSpec((), torch.int32))
    if method == "kmer":
        args += (TensorSpec((4 ** (k or 11), 4), torch.int32),)
    return fn, args

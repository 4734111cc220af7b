"""Sharding planner: (config, mesh, shape) -> specs for everything; the port
of ``repro/models/sharding_plan.py``, and the runtime that places tensors
by those specs.

Layout policy (Megatron TP x FSDP, divisibility-checked per dim), as in the
reference:
  * column-parallel weights (wq/wk/wv, mlp up/gate, router, in_proj, embed^T):
    output dim over 'model', input dim over the FSDP axes ('pod','data').
  * row-parallel weights (wo, w_down, out_proj): input dim over 'model',
    output dim over FSDP axes.
  * MoE experts over 'model' (expert parallelism), expert-internal dims over
    FSDP axes where divisible.
  * activations: batch over ('pod','data'); attention shards heads over
    'model' when head count divides, else the *sequence* (context
    parallelism); KV caches shard batch when divisible, otherwise the cache
    length (distributed decode for global_batch=1 long-context).
Every rule falls back to replication rather than failing.

Specs. The reference's ``PartitionSpec`` is ``P`` here, a tuple with one
entry a tensor dim: an axis name, a tuple of axis names, or None. The
port's parameters are per layer (``convert._unstack``), so the reference's
leading entries for stacked layers have no counterpart; the trailing-dims
rules are the reference's, line for line.

Placement. A spec becomes DTensor placements over the DeviceMesh of the
port's ``dist.sharding.Mesh`` (``Mesh.device_mesh``): dim d split over
``("pod", "data")`` is ``Shard(d)`` on both mesh dims, in mesh order, and
every mesh dim no entry names is ``Replicate()``. ``Plan.sharding(specs)``
is a ``Shardings``: called on a tree of full tensors, it keeps each rank's
shard of every leaf (no communication: every rank holds the full tree,
made from one seeded generator). ``make_shard_fns`` returns the
reference's names; each is a ``redistribute`` of a DTensor to its spec's
placements and the identity on a plain tensor.

Compute (the runtime below, used by ``models/layers.py``, ``mamba2.py``,
``transformer.py`` and ``train/train_step.py``). Parameters, optimizer
moments and the residual stream are DTensors; each block runs its
products on local tensors, Megatron-style, and joins the stream again
through ``from_local`` + ``redistribute``. Weights are gathered over the
FSDP axes just before use (``weight``), so every rank holds exactly its
plan shard between uses, and the backward pass reduce-scatters their
gradients back to it. That is a route beside DTensor's own operator
rules, taken for two reasons: kernel 5, the MoE dispatch, the ring
cache's writes and the SSD chunk loop have no DTensor rule, and DTensor's
sharding propagation may pick a layout (say, a partial sum over the batch)
that the plan does not name. Each ``to_local`` states the gradient
placement its uses imply: ``Partial`` where the model axis's ranks use a
replicated tensor for different heads, experts, sequence blocks or vocab
rows, ``Replicate`` where they compute the same thing. The MoE experts run
on the whole (E, C, D) buffer of the global batch, replicated over the
data axes, as the reference's ``moe_xe`` spec says; the reference's (T, E,
C) ``moe_dispatch`` one-hot is never built (the port dispatches from
indices), so that name is accepted and applied to nothing.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Any, Callable, Dict, Tuple

import torch

from ..dist import sharding as sh


class P(tuple):
    """A PartitionSpec: ``P("data", None)``, one entry a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


def _dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _axis(mesh, name: str) -> int:
    return mesh.axis_sizes[name]


def param_spec(name: str, shape: Tuple[int, ...], mesh) -> P:
    """Trailing-dims rule (the reference's; a leading dim of an MoE
    expert weight is its expert dim)."""
    dp = _dp_axes(mesh)
    mdl = "model"

    def m(dim, axes):
        return sh.maybe(mesh, dim, axes)

    nd = len(shape)
    if nd == 0:
        return P()
    if name in ("embed",):
        return P(m(shape[0], mdl), m(shape[1], dp))
    if name == "head":
        return P(m(shape[0], dp), m(shape[1], mdl))
    if name in ("wq", "wk", "wv", "in_proj", "router") or \
       (name in ("w_gate", "w_up") and nd >= 2):
        if nd >= 3 and name in ("w_gate", "w_up"):   # MoE (.., E, D, F)
            lead = (None,) * (nd - 3)
            return P(*lead, m(shape[-3], mdl), m(shape[-2], dp), None)
        lead = (None,) * (nd - 2)
        return P(*lead, m(shape[-2], dp), m(shape[-1], mdl))
    if name in ("wo", "out_proj") or (name == "w_down" and nd >= 2):
        if nd >= 3 and name == "w_down":             # MoE (.., E, F, D)
            lead = (None,) * (nd - 3)
            return P(*lead, m(shape[-3], mdl), None, m(shape[-1], dp))
        lead = (None,) * (nd - 2)
        return P(*lead, m(shape[-2], mdl), m(shape[-1], dp))
    if name == "conv_w":
        lead = (None,) * (nd - 2)
        return P(*lead, None, m(shape[-1], mdl))
    # biases, norms, A_log, D, dt_bias, conv_b: replicate
    return P(*(None,) * nd)


def map_named(fn, tree, name: str = ""):
    """``fn(name, leaf)`` over a tree of dicts, lists and tuples (named
    tuples too), ``name`` the leaf's last dict key; None stays None."""
    if isinstance(tree, dict):
        return {k: map_named(fn, v, str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        items = [map_named(fn, v, name) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return None if tree is None else fn(name, tree)


def params_pspecs(params_shape, mesh):
    """A spec a leaf of a parameter tree (tensors or anything with a
    ``.shape``)."""
    return map_named(lambda name, leaf: param_spec(name, tuple(leaf.shape),
                                                   mesh), params_shape)


def batch_pspecs(cfg, shape_kind: str, global_batch: int, mesh,
                 batch_shape: Dict[str, Any]):
    dp = _dp_axes(mesh)
    bs_ax = dp if global_batch % sh.axis_size(mesh, dp) == 0 else None
    out = {}
    for k, v in batch_shape.items():
        nd = len(v.shape)
        if k == "pos3":
            out[k] = P(None, bs_ax, *([None] * (nd - 2)))
        else:
            out[k] = P(bs_ax, *([None] * (nd - 1)))
    return out


def cache_pspecs(cfg, cache_shape, global_batch: int, mesh):
    dp = _dp_axes(mesh)
    b_ok = global_batch % sh.axis_size(mesh, dp) == 0
    bs_ax = dp if b_ok else None
    seq_axes = ("model",) if b_ok else tuple(mesh.axis_names)

    def mk(name, leaf):
        shp = tuple(leaf.shape)
        if name in ("k", "v"):
            # (stack.., B, W, KH, hd)
            lead = (None,) * (len(shp) - 4)
            w_ax = sh.maybe(mesh, shp[-3], seq_axes)
            kv_ax = None if w_ax else sh.maybe(mesh, shp[-2], "model")
            return P(*lead, bs_ax, w_ax, kv_ax, None)
        if name == "slot_pos":
            lead = (None,) * (len(shp) - 2)
            return P(*lead, bs_ax, sh.maybe(mesh, shp[-1], seq_axes))
        if name == "ssm":
            lead = (None,) * (len(shp) - 4)
            return P(*lead, bs_ax, sh.maybe(mesh, shp[-3], "model"), None,
                     None)
        if name == "conv":
            lead = (None,) * (len(shp) - 3)
            return P(*lead, bs_ax, None, sh.maybe(mesh, shp[-1], "model"))
        return P(*(None,) * len(shp))
    return map_named(mk, cache_shape)


class ShardFns(dict):
    """The reference's name -> constraint dict, with the mesh it places
    on: ``mesh`` (``dist.sharding.Mesh``), ``batch_split`` (the global
    batch divides the data axes) and ``specs`` (name -> spec)."""

    def __init__(self, mesh, batch_split: bool):
        super().__init__()
        self.mesh = mesh
        self.batch_split = batch_split
        self.specs: Dict[str, P] = {}

    @property
    def dmesh(self):
        return self.mesh.device_mesh()


def make_shard_fns(cfg, mesh, global_batch: int) -> ShardFns:
    dp = _dp_axes(mesh)
    b_ok = global_batch % sh.axis_size(mesh, dp) == 0
    bs_ax = dp if b_ok else None
    fns = ShardFns(mesh, b_ok)

    def cons(name, spec):
        fns.specs[name] = spec

        def fn(x):
            if not _is_dtensor(x):
                return x
            pl = placements(mesh, spec, x.ndim)
            if tuple(x.placements) == tuple(pl):
                return x
            return x.redistribute(x.device_mesh, pl)
        fns[name] = fn

    cons("hidden", P(bs_ax, None, None))
    ff = cfg.d_ff_dense or cfg.d_ff
    if ff:
        ff_ax = sh.maybe(mesh, ff, "model")
        cons("mlp_hidden", P(bs_ax, None, ff_ax))
    if cfg.n_heads:
        h_ok = cfg.n_heads % _axis(mesh, "model") == 0
        if h_ok:
            cons("attn_q", P(bs_ax, None, "model", None))
        else:
            cons("attn_q", P(bs_ax, "model", None, None))
        kv_ok = cfg.n_kv_heads % _axis(mesh, "model") == 0
        cons("attn_kv", P(bs_ax, None, "model" if kv_ok else None, None))
    if cfg.n_experts:
        e_ax = sh.maybe(mesh, cfg.n_experts, "model")
        # the (T, E, C) one-hot this names is never built (module doc)
        cons("moe_dispatch", P(bs_ax, e_ax, None))
        cons("moe_xe", P(e_ax, None, None))
    if cfg.ssm_state:
        nh_ax = sh.maybe(mesh, cfg.ssm_heads, "model")
        cons("ssm_x", P(bs_ax, None, nh_ax, None))
    return fns


# ------------------------------------------------------------ placements

def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(mesh, spec, ndim: int) -> list:
    """A spec's DTensor placements over ``mesh``'s dims (module doc)."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate() for _ in mesh.axis_names]
    entries = tuple(spec) + (None,) * (ndim - len(spec))
    for d, entry in enumerate(entries):
        axes = sh._as_tuple(entry)
        idx = [mesh.axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} out of mesh order "
                             f"{mesh.axis_names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def distribute(t, mesh, spec):
    """``t`` (the full tensor, equal on every rank) as a DTensor of
    ``spec``: each rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh.device_mesh(),
                             placements(mesh, spec, t.ndim),
                             src_data_rank=None)


def _zip_specs(fn, tree, specs):
    if isinstance(specs, P):
        return fn(tree, specs)
    if isinstance(tree, dict):
        return {k: _zip_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_zip_specs(fn, a, b) for a, b in zip(tree, specs)]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


@dataclasses.dataclass
class Shardings:
    """A tree of specs on a mesh; called on a tree of full tensors of the
    same structure it distributes each leaf (``distribute``)."""
    mesh: Any
    specs: Any

    def __call__(self, tree):
        return _zip_specs(lambda t, s: distribute(t, self.mesh, s), tree,
                          self.specs)


@dataclasses.dataclass
class Plan:
    mesh: Any
    param_specs: Any
    shard_fns: Dict[str, Callable]

    def sharding(self, spec_tree) -> Shardings:
        return Shardings(self.mesh, spec_tree)


def plan_for(cfg, mesh, global_batch: int, params_shape) -> Plan:
    return Plan(mesh=mesh,
                param_specs=params_pspecs(params_shape, mesh),
                shard_fns=make_shard_fns(cfg, mesh, global_batch))


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree's tensors (a DTensor's local
    shard)."""
    total = 0
    for x in _leaves(tree):
        t = x.to_local() if _is_dtensor(x) else x
        total += t.numel() * t.element_size()
    return total


def planned_bytes(tree, specs, mesh) -> int:
    """The plan's arithmetic for ``local_bytes``: each leaf's bytes over
    the product of the mesh extents its spec names (every split divides,
    by the plan's rules)."""
    total = 0
    for x, s in zip(_leaves(tree), _leaves(specs)):
        n = x.numel() * x.element_size()
        for entry in s:
            n //= sh.axis_size(mesh, entry)
        total += n
    return total


def _leaves(tree) -> list:
    if isinstance(tree, P):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for item in tree for x in _leaves(item)]
    return [] if tree is None else [tree]


# ---------------------------------------------------------------- runtime
#
# The helpers the blocks compute with. ``sf`` is a ``ShardFns``; an
# activation's placements put its batch dim over the data axes where the
# global batch divides them (``sf.batch_split``) and ``model`` on the
# model axis.

def model_size(sf) -> int:
    return _axis(sf.mesh, "model")


def model_rank(sf) -> int:
    return sf.mesh.coords()["model"]


def act(sf, model=None, bdim: int = 0) -> list:
    """An activation's placements: the batch dim ``bdim`` over the data
    axes (or replicated), ``model`` (a placement, default Replicate) on
    the model axis."""
    from torch.distributed.tensor import Replicate, Shard
    dp = _dp_axes(sf.mesh)
    out = []
    for a in sf.mesh.axis_names:
        if a == "model":
            out.append(model if model is not None else Replicate())
        elif a in dp and sf.batch_split:
            out.append(Shard(bdim))
        else:
            out.append(Replicate())
    return out


def partial():
    from torch.distributed.tensor import Partial
    return Partial()


def replicate():
    from torch.distributed.tensor import Replicate
    return Replicate()


def shard_dim(d: int):
    from torch.distributed.tensor import Shard
    return Shard(d)


def wrap(sf, t, pl, shape=None):
    """A local tensor as the DTensor of placements ``pl`` (``shape`` the
    global shape where the split may be uneven)."""
    return wrap_global(sf.mesh, t, pl, shape)


def wrap_global(mesh, t, pl, shape=None):
    """``wrap`` on a ``dist.sharding.Mesh``."""
    from torch.distributed.tensor import DTensor
    if shape is None:
        return DTensor.from_local(t, mesh.device_mesh(), pl, run_check=False)
    shape = torch.Size(shape)
    stride, n = [], 1
    for d in reversed(shape):
        stride.append(n)
        n *= d
    return DTensor.from_local(t, mesh.device_mesh(), pl, run_check=False,
                              shape=shape, stride=tuple(reversed(stride)))


def local(x, grad=None):
    """``x``'s local tensor; ``grad`` the placements its gradient has
    (default: ``x``'s own)."""
    return x.to_local(grad_placements=grad)


def join(sf, t, pl, dtype=None, shape=None):
    """A block's local output of placements ``pl`` back on the residual
    stream: redistributed to the ``hidden`` layout (an all-reduce of a
    partial sum, an all-gather of a sequence block), then cast."""
    from torch.distributed.tensor import Replicate
    out = wrap(sf, t, pl, shape).redistribute(
        sf.dmesh, act(sf, Replicate(), bdim=0))
    return out if dtype is None else out.to(dtype)


def psum_model(sf, t, grad_partial: bool = True, bdim: int = 0):
    """The sum of ``t`` over the model axis, differentiable; with
    ``grad_partial`` each rank's uses of the sum differ (its own heads),
    so the backward sums their gradients too."""
    if model_size(sf) == 1:
        return t
    full = wrap(sf, t, act(sf, partial(), bdim)).redistribute(
        sf.dmesh, act(sf, replicate(), bdim))
    return full.to_local(grad_placements=act(
        sf, partial() if grad_partial else replicate(), bdim))


def weight(sf, w, *, keep_model: bool = True, model_grad=None,
           dp_grad=None, dtype=None):
    """A weight gathered for use: every FSDP axis replicated, the model
    axis kept as the plan splits it (``keep_model``) or replicated.

    The gradient's placements: ``Partial`` over the data axes (their
    ranks see different rows; ``dp_grad`` overrides, e.g. Replicate for a
    computation that every data rank repeats), and on the model axis the
    kept split or ``model_grad`` (Partial where the ranks use the
    gathered weight for different parts of the output, Replicate where
    they repeat one computation). A plain tensor passes through.
    ``dtype`` (the compute type) is cast to before the gather where no
    gradient is recorded, after it otherwise (the gradient's sums over the
    data axes stay f32)."""
    if not _is_dtensor(w):
        return w
    if dtype is not None and not (torch.is_grad_enabled()
                                  and w.requires_grad):
        w = w.to(dtype)
    from torch.distributed.tensor import Replicate
    names = sf.mesh.axis_names
    dp = _dp_axes(sf.mesh)
    comp, grad = [], []
    for a, p in zip(names, w.placements):
        if a == "model":
            c = p if keep_model else Replicate()
            comp.append(c)
            grad.append(c if c.is_shard() else
                        (model_grad if model_grad is not None
                         else partial()))
        else:
            comp.append(Replicate())
            if a in dp:
                grad.append(dp_grad if dp_grad is not None else
                            (partial() if sf.batch_split else Replicate()))
            else:
                grad.append(Replicate())
    return w.redistribute(sf.dmesh, comp).to_local(grad_placements=grad)


class Lazy(Mapping):
    """A block's parameters for its plain version: each entry a tensor, or
    a callable (a gather, ``weight``) run when the block reads it, so the
    mesh holds no more gathered weights at once than the plain block
    holds casts."""

    def __init__(self, **items):
        self._items = items

    def __getitem__(self, name):
        v = self._items[name]
        return v() if callable(v) else v

    def __iter__(self):
        return iter(self._items)

    def __len__(self):
        return len(self._items)


def local_fns(sf, **layouts):
    """``shard_fns`` for a plain block run on local tensors: each named
    constraint (``layouts``: name -> its local tensor's placements) wraps
    the tensor as a DTensor, applies the plan's constraint and returns the
    local tensor."""
    return {name: (lambda t, f=sf[name], pl=pl: f(wrap(sf, t, pl))
                   .to_local())
            for name, pl in layouts.items() if name in sf}


def model_sharded(w) -> bool:
    """Whether the plan splits ``w`` over the model axis."""
    if not _is_dtensor(w):
        return False
    names = w.device_mesh.mesh_dim_names
    return w.placements[names.index("model")].is_shard()


def local_box(shape, mesh_shape, coord, pl):
    """(local shape, global offset) of the block at mesh coordinate
    ``coord`` of a tensor of global ``shape`` placed by ``pl``: DTensor's
    ``Shard`` split (``torch.chunk``'s sizes, mesh dims in order),
    computed on the host (DTensor's own helper reads tensors, which a fake
    tensor cannot give)."""
    size, off = list(shape), [0] * len(shape)
    for n, c, p in zip(mesh_shape, coord, pl):
        if p.is_shard():
            d = p.dim
            chunk = -(-size[d] // n)
            off[d] += min(c * chunk, size[d])
            size[d] = max(0, min(chunk, size[d] - c * chunk))
    return tuple(size), tuple(off)


def local_offset(x, dim: int) -> int:
    """A DTensor's global offset of its local block along ``dim``."""
    dm = x.device_mesh
    _, off = local_box(x.shape, dm.shape, dm.get_coordinate(), x.placements)
    return off[dim]


def all_reduce(sf, t, op: str, axes):
    """A non-differentiable all-reduce of a local tensor over ``axes``
    (one axis after another)."""
    import torch.distributed._functional_collectives as funcol
    for a in axes:
        if _axis(sf.mesh, a) > 1:
            t = funcol.all_reduce(t, op, (sf.dmesh,
                                          sf.mesh.axis_names.index(a)))
    return t


def dp_prefix(sf, t):
    """The sum of ``t`` (a local int tensor) over the data-axis ranks
    before this one, in the global batch's row order (pod-major)."""
    import torch.distributed._functional_collectives as funcol
    dp = _dp_axes(sf.mesh) if sf.batch_split else ()
    rows = t[None]
    for a in reversed(dp):
        n = _axis(sf.mesh, a)
        if n > 1:
            rows = funcol.all_gather_tensor(
                rows, 0, (sf.dmesh, sf.mesh.axis_names.index(a)))
    # rows is (n_dp, ...) in pod-major order after the gathers above
    me = sf.mesh.block_index(dp) if dp else 0
    return rows[:me].sum(0) if me else torch.zeros_like(t)


def dp_count(sf) -> int:
    """The ranks the global batch's rows are split over."""
    dp = _dp_axes(sf.mesh)
    return sh.axis_size(sf.mesh, dp) if sf.batch_split else 1


# ------------------------------------------------- gloo on the card's tensors

_OPS = {"sum": "SUM", "max": "MAX", "min": "MIN", "product": "PRODUCT"}


def _pg(group, tag=""):
    import torch.distributed._functional_collectives as funcol
    from torch.distributed import distributed_c10d as c10d
    resolve = getattr(funcol, "_resolve_group", None) or \
        funcol._resolve_group_name
    name = resolve(group, tag)
    return name if not isinstance(name, str) else \
        c10d._resolve_process_group(name)


def _c10d_all_gather(self, gather_dim, group, tag=""):
    import torch.distributed as dist
    pg = _pg(group, tag)
    n = dist.get_world_size(pg)
    x = self.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=pg)
    if gather_dim != 0:
        out = torch.cat(out.chunk(n, 0), dim=gather_dim)
    return out


def _c10d_reduce_scatter(self, reduceOp, scatter_dim, group, tag=""):
    import torch.distributed as dist
    pg = _pg(group, tag)
    n = dist.get_world_size(pg)
    x = self
    if scatter_dim != 0:
        x = torch.cat(x.chunk(n, scatter_dim), dim=0)
    x = x.contiguous()
    out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(
        out, x, op=getattr(dist.ReduceOp, _OPS[reduceOp.lower()]), group=pg)
    return out


def _c10d_all_reduce(self, reduceOp, group, tag=""):
    import torch.distributed as dist
    out = self.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=getattr(dist.ReduceOp, _OPS[reduceOp.lower()]),
                    group=_pg(group, tag))
    return out


_C10D = {"all_gather_tensor": _c10d_all_gather,
         "all_gather_single": _c10d_all_gather,
         "reduce_scatter_tensor": _c10d_reduce_scatter,
         "reduce_scatter_single": _c10d_reduce_scatter,
         "all_reduce": _c10d_all_reduce}


def collective_route(mesh) -> str:
    """``"c10d"`` where the world is ``gloo`` and the mesh's tensors live on
    the card, else ``"functional"``. PyTorch's functional collectives
    (the ones DTensor calls) crash a process in that case (SIGSEGV, seen
    on an H100 with PyTorch 2.11), while gloo's own in-place collectives
    take CUDA tensors; ``collectives(mesh)`` then routes the former
    through the latter."""
    import torch.distributed as dist
    if mesh.device.type == "cuda" and dist.is_initialized() and \
            dist.get_backend() == "gloo":
        return "c10d"
    return "functional"


class collectives:
    """A context in which DTensor's and the plan's collectives take
    ``collective_route(mesh)``: with ``"c10d"`` the functional
    ``all_gather``/``reduce_scatter``/``all_reduce`` run as gloo's
    blocking ``all_gather_into_tensor``/``reduce_scatter_tensor``/
    ``all_reduce`` (the same sums, in place of a crash); else nothing
    changes."""

    def __init__(self, mesh):
        self.route = collective_route(mesh)
        self._saved = {}

    def __enter__(self):
        if self.route == "c10d":
            import torch.distributed._functional_collectives as funcol
            for name, fn in _C10D.items():
                if hasattr(funcol, name):
                    self._saved[name] = getattr(funcol, name)
                    setattr(funcol, name, fn)
        return self

    def __exit__(self, *exc):
        import torch.distributed._functional_collectives as funcol
        for name, fn in self._saved.items():
            setattr(funcol, name, fn)
        self._saved.clear()

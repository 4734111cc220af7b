"""Multi-pod dry run: every (arch x shape) cell's step on the production
meshes, as rank 0 of a fake world, recording a rank's memory, FLOPs,
operator traffic and collectives; the port of ``repro.launch.dryrun``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh both --out results/dryrun.json
  python -m repro_torch.launch.dryrun --msa halign-dna-1000x --mesh multipod

The reference lowers and compiles each step on 512 forced host devices
and reads XLA's analyses. The port has no compiler to ask: ``run_cell``
makes a fake world of 256 (``--mesh pod``, 16 x 16) or 512 (``multipod``,
2 x 16 x 16) ranks in this one process (``FakeStore`` and the ``"fake"``
backend of ``torch.testing._internal.distributed.fake_pg``, made inside
the call and destroyed after it, never at import), builds the cell's step
with the plan's placements (``launch/steps.py``) on ``FakeTensorMode``
tensors, and runs it once as rank 0: nothing is allocated, collectives
return at once, and kernel 5 runs its fake implementation. A dispatch
mode sees every operation rank 0 runs on its local tensors (a DTensor's
operation reaches it as the local operations DTensor dispatches), and
gives the record:

  argument_size_in_bytes     the rank's local bytes of the step's arguments
  output_size_in_bytes       its local bytes of the step's outputs
  temp_size_in_bytes         the peak of its live local bytes during the
                             step, less the arguments (storages created in
                             the step and not yet freed)
  flops_per_device           FLOPs of its operations at their local shapes
                             (``torch.utils.flop_counter``'s formulas;
                             kernel 5's own formula, ``ops.pairs``)
  bytes_accessed_per_device  input plus output bytes of every operation it
                             runs (views excluded). The port runs unfused,
                             so this is its operator traffic, not XLA's
                             post-fusion estimate
  collective_bytes_per_device, collective_counts
                             operand bytes and counts of its collectives
                             under the reference's names (COLLECTIVE_OPS)
  collective_bytes_by_computation
                             the same bytes by the kind of layer running
                             (``attn``, ``mamba``, ... as
                             ``transformer.layer_kinds`` names them;
                             ``backward`` for the autograd pass outside a
                             layer's recompute, ``step`` for the rest)
  microbatches, lower_s (the fake run's seconds), roofline_mode
  params_per_device          the rank's local parameter elements

``compile_s`` and ``generated_code_size_in_bytes`` have no counterpart and
are left out. ``--device cpu`` runs the fake tensors as CPU tensors,
``--device cuda`` (the default) as the card's, which needs a machine
whose PyTorch has CUDA (no card is touched); both give the same record.

MSA cells (``run_msa_cell``). The port's ``distributed_center_star``
reads data on the host (the failed k-mer chains, the center's length,
the chaining), which a fake tensor cannot give, so it is not run: the
record gives what the shapes give exactly (a rank's argument and output
bytes, and its one collective: the reduce(1) MAX all-reduce of the
(num_slots,) int32 profile) and ``null`` with a ``why`` for every field
it cannot fill.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
from pathlib import Path

import torch

from ..configs import ALL_ARCHS, SHAPES, get_arch, shape_applicable
from .steps import MSA_CELLS, build_msa_step, build_step, microbatches_for

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")

_FUNCTIONAL = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


def _tensors(tree):
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _tensors(v)]
    if isinstance(tree, DTensor):
        return [tree.to_local()]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _storage_bytes(tree) -> int:
    """Local bytes of a tree's tensors, each storage once."""
    seen, total = set(), 0
    for t in _tensors(tree):
        st = t.untyped_storage()
        key = st._cdata
        if key not in seen:
            seen.add(key)
            total += st.nbytes()
    return total


_LAYER = ["step"]


class RankCounter:
    """A dispatch mode counting rank 0's local operations (module doc):
    FLOPs, operator traffic, collectives and live storage bytes."""

    def __init__(self, device: str):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        counter = self
        self.flops = 0
        self.bytes = 0
        self.coll = {op: 0 for op in COLLECTIVE_OPS}
        self.coll_n = {op: 0 for op in COLLECTIVE_OPS}
        self.by_comp = {}
        self.live = {}
        self.live_bytes = 0
        self.peak = 0
        self._n = 0
        self.device = device
        self._shape_inference = [0]

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                from torch.distributed.tensor import DTensor
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                counter._op(func, args, kwargs, out, flop_registry)
                return out
        self.mode = Mode()

    def __enter__(self):
        # DTensor infers each op's global output shape by running it on
        # fake tensors of the global shape: those operations are not
        # rank 0's work, and are not counted
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator as SP
        flag = self._shape_inference
        self._patched = []
        for name in ("_propagate_tensor_meta_non_cached",
                     "_propagate_tensor_meta"):
            orig = getattr(SP, name, None)
            if orig is None:
                continue

            def wrapped(*a, _orig=orig, **k):
                flag[0] += 1
                try:
                    return _orig(*a, **k)
                finally:
                    flag[0] -= 1
            self._patched.append((SP, name, orig))
            setattr(SP, name, wrapped)
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        out = self.mode.__exit__(*exc)
        for cls, name, orig in self._patched:
            setattr(cls, name, orig)
        return out

    def close(self):
        """Drop the freed storages from the live bytes and read the
        peak."""
        for key in [k for k, (r, _) in self.live.items() if r.expired()]:
            self.live_bytes -= self.live.pop(key)[1]
        self.peak = max(self.peak, self.live_bytes)

    def _op(self, func, args, kwargs, out, registry):
        from torch.multiprocessing.reductions import StorageWeakRef
        import torch.utils._pytree as pytree
        ins = [a for a in pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        outs = [o for o in pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        if self._shape_inference[0] or any(
                t.device.type != self.device for t in ins + outs):
            return      # DTensor's shape inference, not rank 0's work
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns == "_c10d_functional":
            op = _FUNCTIONAL.get(name)
            if op is not None:
                b = sum(t.numel() * t.element_size() for t in ins)
                self.coll[op] += b
                self.coll_n[op] += 1
                key = _LAYER[0]
                if key == "step" and torch._C._current_autograd_node() \
                        is not None:
                    key = "backward"
                self.by_comp[key] = self.by_comp.get(key, 0) + b
        elif not func.is_view and ns not in ("prim",):
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
            f = registry.get(func._overloadpacket)
            if f is not None:
                self.flops += int(f(*args, **kwargs, out_val=out))
            elif name == "matmul":      # not decomposed under inference_mode
                self.flops += 2 * out.numel() * args[0].shape[-1]
            elif name == "einsum":
                self.flops += _einsum_flops(args[0], args[1])
        seen = {t.untyped_storage()._cdata for t in ins}
        for o in outs:                  # an in-place op's or a view's
            st = o.untyped_storage()    # storage is an input's
            key = st._cdata
            if key not in self.live and key not in seen:
                n = st.nbytes()
                self.live[key] = (StorageWeakRef(st), n)
                self.live_bytes += n
        # live_bytes counts freed storages until a purge drops them, so it
        # bounds the live bytes from above: a purge whenever it passes the
        # peak keeps the peak exact
        self._n += 1
        if self.live_bytes > self.peak or self._n % 256 == 0:
            self.close()


def _einsum_flops(eq: str, operands) -> int:
    """2 x the product of every index's extent (a contraction of two
    operands without ellipsis, as the port writes them)."""
    ins = eq.split("->")[0].split(",")
    size = {}
    for spec, t in zip(ins, operands):
        for c, n in zip(spec, t.shape):
            size[c] = n
    out = 2
    for n in size.values():
        out *= n
    return out if len(ins) == 2 else 0


@contextlib.contextmanager
def fake_world(n: int):
    """A world of ``n`` ranks in this process, this one rank 0: the
    ``fake`` backend of ``torch.testing._internal.distributed.fake_pg``
    (every collective returns at once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world; a process "
                           "group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _layer_labels():
    """Label collectives with the kind of layer whose forward (or
    recompute) is running."""
    from ..models import transformer as tt
    orig = tt._block_apply

    def labeled(kind, *args, **kw):
        prev = _LAYER[0]
        _LAYER[0] = kind
        try:
            return orig(kind, *args, **kw)
        finally:
            _LAYER[0] = prev
    tt._block_apply = labeled
    try:
        yield
    finally:
        tt._block_apply = orig


def _device(device: str) -> str:
    from ..device import resolve_device
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.backends.cuda.is_built():
        resolve_device(dev)             # raises: this PyTorch has no CUDA
    return dev.type


def _params_of(args):
    """The parameter tree among a step's arguments."""
    first = args[0]
    return first.params if hasattr(first, "params") else first


def run_cell(arch: str, shape: str, mesh_kind: str, verbose: bool = True,
             roofline: bool = False, device: str = "cuda", mesh_shape=None):
    """One cell's record (module doc). ``mesh_shape`` (pod, data, model)
    or (data, model) runs it on a fake world of that shape instead of the
    production mesh ``mesh_kind`` names."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from .mesh import make_production_mesh
    cfg = get_arch(arch).config
    ok, why = shape_applicable(cfg, SHAPES[shape])
    if not ok:
        return {"arch": arch, "shape": shape, "mesh": mesh_kind,
                "skipped": why}
    multi = mesh_kind == "multipod"
    dev = _device(device)
    t0 = time.time()
    n = 512 if multi else 256
    if mesh_shape is not None:
        n = 1
        for d in mesh_shape:
            n *= d
    with fake_world(n):
        if mesh_shape is None:
            mesh = make_production_mesh(multi_pod=multi, device=dev)
        else:
            from ..dist.sharding import Mesh
            axes = ("pod", "data", "model")[-len(mesh_shape):]
            mesh = Mesh(tuple(mesh_shape), axes, None, 0, n,
                        torch.device(dev))
        mesh.device_mesh()              # real rank lists, before fake mode
        with FakeTensorMode(allow_non_fake_inputs=True):
            fn, args = build_step(arch, shape, mesh, roofline=roofline)
            arg_bytes = _storage_bytes(args)
            n_params = sum(t.numel() for t in _tensors(_params_of(args)))
            counter = RankCounter(dev)
            with _layer_labels(), counter:
                out = fn(*args)
            counter.close()
            out_bytes = _storage_bytes(out)
        t_lower = time.time() - t0
        mu = (microbatches_for(arch, shape, mesh)
              if SHAPES[shape].kind == "train" else 1)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_kind,
        "roofline_mode": roofline, "microbatches": mu,
        "flops_per_device": float(counter.flops),
        "bytes_accessed_per_device": float(counter.bytes),
        "collective_bytes_per_device": counter.coll,
        "collective_counts": counter.coll_n,
        "collective_bytes_by_computation": counter.by_comp,
        "lower_s": round(t_lower, 2),
        "argument_size_in_bytes": arg_bytes,
        "output_size_in_bytes": out_bytes,
        "temp_size_in_bytes": counter.peak,
        "params_per_device": n_params,
        "device": dev,
    }
    if verbose:
        print(json.dumps(rec))
    return rec


def run_msa_cell(cell: str, mesh_kind: str, verbose: bool = True,
                 device: str = "cuda"):
    """An MSA cell's record from its shapes (module doc)."""
    from .mesh import make_production_mesh
    multi = mesh_kind == "multipod"
    dev = _device(device)
    t0 = time.time()
    with fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi_pod=multi, device=dev)
        N, L, method, _, _, chunks = MSA_CELLS[cell]
        _, args = build_msa_step(cell, mesh)
    arg_bytes = sum(_spec_bytes(a) for a in args)
    n_q = args[0].shape[0]
    out_len, slots = L + 4096, L + 1
    host = ("the port's distributed_center_star reads data on the host "
            "(torch.nonzero of the failed k-mer chains, int(lc), the "
            "chaining), which a fake tensor cannot give; the step is not "
            "run")
    coll = {op: 0 for op in COLLECTIVE_OPS}
    coll_n = {op: 0 for op in COLLECTIVE_OPS}
    coll["all-reduce"], coll_n["all-reduce"] = 4 * slots, 1
    rec = {
        "arch": cell, "shape": "msa", "mesh": mesh_kind,
        "microbatches": chunks,
        "argument_size_in_bytes": arg_bytes,
        # the rank's (shard, out_len) int8 rows and the (num_slots,) profile
        "output_size_in_bytes": n_q * out_len + 4 * slots,
        "collective_bytes_per_device": coll,
        "collective_counts": coll_n,
        "collective_bytes_by_computation": {"reduce(1)": 4 * slots},
        "collectives_why": "from the shapes: reduce(1) is one MAX all_reduce "
                           "of the (num_slots,) int32 profile; the rows "
                           "stay on their rank (the launcher gathers them "
                           "after the step)",
        "flops_per_device": None, "bytes_accessed_per_device": None,
        "temp_size_in_bytes": None,
        "why": {"flops_per_device": host, "bytes_accessed_per_device": host,
                "temp_size_in_bytes": host},
        "lower_s": round(time.time() - t0, 2), "device": dev,
    }
    if verbose:
        print(json.dumps(rec))
    return rec


def _spec_bytes(spec) -> int:
    n = 1
    for d in spec.shape:
        n *= d
    return n * torch.empty((), dtype=spec.dtype).element_size()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--msa", default=None, choices=list(MSA_CELLS) + [None])
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--roofline", action="store_true",
                    help="kept for the reference's sake: the port counts "
                         "every layer and microbatch already (recorded as "
                         "roofline_mode)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device: cuda (default; needs "
                         "a PyTorch built with CUDA, no card is used) or "
                         "cpu")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    results = []
    dev = args.device
    if args.msa:
        for mk in meshes:
            results.append(run_msa_cell(args.msa, mk, device=dev))
    elif args.all:
        for arch in ALL_ARCHS:
            for shape in SHAPES:
                for mk in meshes:
                    try:
                        results.append(run_cell(arch, shape, mk,
                                                roofline=args.roofline,
                                                device=dev))
                    except Exception as e:  # a failure here is a bug: record it
                        results.append({"arch": arch, "shape": shape,
                                        "mesh": mk, "error": repr(e)})
                        print(f"FAIL {arch} {shape} {mk}: {e!r}")
        for cell in MSA_CELLS:
            for mk in meshes:
                try:
                    results.append(run_msa_cell(cell, mk, device=dev))
                except Exception as e:
                    results.append({"arch": cell, "shape": "msa", "mesh": mk,
                                    "error": repr(e)})
                    print(f"FAIL {cell} {mk}: {e!r}")
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, --msa, or --all")
        for mk in meshes:
            results.append(run_cell(args.arch, args.shape, mk,
                                    roofline=args.roofline, device=dev))

    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        with open(out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {len(results)} records to {out}")
    return results


if __name__ == "__main__":
    main()

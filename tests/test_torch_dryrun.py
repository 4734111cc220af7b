"""The port's dry run (``repro_torch.launch.dryrun``) and kernel 5's
custom op, on the CPU.

The fake world is process-global, so the cells run in one subprocess
with a time limit (one fixture for the module):

* qwen1.5-0.5b decode_32k on a (2, 2, 2) (pod, data, model) fake mesh,
  the reference's ``tests/test_dryrun_small.py`` cell: its
  ``argument_size_in_bytes`` equals the reference's
  ``compiled.memory_analysis().argument_size_in_bytes`` for the same cell
  on 8 forced host devices (another subprocess), byte for byte: the
  parameters (f32), the KV caches and the token and position vectors, at
  the same placements;
* llama3.2-1b train_4k on the 16 x 16 pod mesh: 4,894,720 parameters a
  rank, and its FLOPs a rank x 256 within 15 % of the step's model FLOPs
  (6·N·tokens for the layers and the head, 2·N_layers·tokens for remat's
  recompute, and causal attention, 4·head_dim FLOP a kept (query, key)
  pair forward, twice that backward, once more for the recompute), which
  a count of global shapes would miss 16-fold;
* one MSA cell's record: the fields its shapes give, and ``null`` with a
  ``why`` for the others.

In this process: ``torch.library.opcheck`` on ``repro_torch::flash_
attention`` at three shapes (causal, window, GQA) and its FLOP formula
against a pair count made from the mask.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.kernels.flash_attention import ops

SRC = str(Path(__file__).resolve().parents[1] / "src")
TIMEOUT = 400

PORT = r'''
import json, sys, warnings
warnings.simplefilter("ignore")
sys.path.insert(0, %r)
from repro_torch.launch import dryrun
out = {
    "small": dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "pod",
                             verbose=False, device="cpu",
                             mesh_shape=(2, 2, 2)),
    "llama": dryrun.run_cell("llama3.2-1b", "train_4k", "pod",
                             verbose=False, device="cpu"),
    "msa": dryrun.run_msa_cell("halign-protein-100x", "pod", verbose=False,
                               device="cpu"),
}
print("RESULT " + json.dumps(out))
'''

REFERENCE = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import json, sys
sys.path.insert(0, %r)
import numpy as np
import jax
from repro.launch.steps import build_step
mesh = jax.sharding.Mesh(
    np.asarray(jax.devices()[:8]).reshape(2, 2, 2), ("pod", "data", "model"))
with mesh:
    jitted, args = build_step("qwen1.5-0.5b", "decode_32k", mesh)
    mem = jitted.lower(*args).compile().memory_analysis()
print("RESULT " + json.dumps({"argument_size_in_bytes":
                              int(mem.argument_size_in_bytes)}))
'''


def _run(script: str) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script % SRC],
                          capture_output=True, text=True, timeout=TIMEOUT,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines()
            if x.startswith("RESULT ")][-1]
    return json.loads(line[len("RESULT "):])


@pytest.fixture(scope="module")
def cells():
    return _run(PORT)


def test_small_mesh_arguments_equal_reference(cells):
    want = _run(REFERENCE)["argument_size_in_bytes"]
    rec = cells["small"]
    assert rec["argument_size_in_bytes"] == want
    assert rec["flops_per_device"] > 0
    assert rec["collective_counts"]["all-gather"] > 0
    assert "compile_s" not in rec


def model_flops(cfg, B: int, S: int) -> float:
    """The step's model FLOPs (module doc) for a dense causal model."""
    D, V, L = cfg.d_model, cfg.vocab_size, cfg.n_layers
    n_layers = cfg.param_count() - V * D * (1 if cfg.tie_embeddings else 2)
    tokens = B * S
    attn_fwd = 4 * cfg.head_dim * ops.pairs(S, S, True, 0) * \
        cfg.n_heads * B * L
    return 6 * (n_layers + V * D) * tokens + 2 * n_layers * tokens + \
        4 * attn_fwd


def test_llama_train_cell_counts_a_rank(cells):
    rec = cells["llama"]
    assert rec["params_per_device"] == 4_894_720
    assert rec["microbatches"] == 4 and rec["roofline_mode"] is False
    want = model_flops(get_arch("llama3.2-1b").config, 256, 4096)
    got = rec["flops_per_device"] * 256
    assert abs(got - want) <= 0.15 * want, (got, want)
    # parameters, Adam's m and v (f32), the batch's two int32 arrays, and
    # the step count and step (int32 scalars)
    assert rec["argument_size_in_bytes"] == 3 * 4 * 4_894_720 + \
        2 * 4 * 256 * 4096 // 16 + 2 * 4
    coll = rec["collective_bytes_per_device"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert rec["temp_size_in_bytes"] > 0


def test_msa_cell_record(cells):
    rec = cells["msa"]
    assert rec["shape"] == "msa" and rec["mesh"] == "pod"
    # Q (N/16, 512) int8, lens int32, center (512,) int8, lc int32
    n = 1789952 // 16
    assert rec["argument_size_in_bytes"] == n * 512 + 4 * n + 512 + 4
    assert rec["collective_counts"]["all-reduce"] == 1
    assert rec["collective_bytes_per_device"]["all-reduce"] == 4 * 513
    for k in ("flops_per_device", "bytes_accessed_per_device",
              "temp_size_in_bytes"):
        assert rec[k] is None and rec["why"][k]


def _mask_pairs(S, T, causal, window, q_offset):
    p = q_offset + np.arange(S)[:, None]
    k = np.arange(T)[None, :]
    keep = np.ones((S, T), bool)
    if causal:
        keep &= k <= p
    if window > 0:
        keep &= (p - k) < window
    return int(keep.sum())


@pytest.mark.parametrize("case", [
    dict(B=2, S=24, T=24, H=4, KH=4, D=16, causal=True, window=0, off=0),
    dict(B=1, S=16, T=40, H=2, KH=2, D=8, causal=True, window=7, off=24),
    dict(B=2, S=12, T=12, H=8, KH=2, D=16, causal=False, window=0, off=0),
], ids=["causal", "window", "gqa"])
def test_flash_custom_op(case):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(case["B"], case["S"], case["H"], case["D"], generator=g)
    k = torch.randn(case["B"], case["T"], case["KH"], case["D"], generator=g)
    v = torch.randn(case["B"], case["T"], case["KH"], case["D"], generator=g)
    args = (q, k, v, 0.25, case["causal"], case["window"], case["off"])
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          args)
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention(*args)
    pairs = _mask_pairs(case["S"], case["T"], case["causal"],
                        case["window"], case["off"])
    assert ops.pairs(case["S"], case["T"], case["causal"], case["window"],
                     case["off"]) == pairs
    assert fc.get_total_flops() == \
        4 * case["D"] * case["B"] * case["H"] * pairs

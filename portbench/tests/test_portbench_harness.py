"""The benchmark harness on the CPU: cells, metrics and configurations
found from files, the imports it may not make, the roofline's counts and
the result line's keys. No card is needed."""
from __future__ import annotations

import ast
import json
import shutil
from pathlib import Path

import pytest

from portbench import roofline
from portbench import run as prun

HERE = Path(prun.__file__).resolve().parent
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def _top_imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_or_reference_package_imported(path):
    names = _top_imports(path)
    assert not names & {"jax", "jaxlib", "flax", "repro"}, names
    if "reference" in path.parts:
        assert "repro_torch" not in names, names


def test_banned_modules_compare_whole_top_level_names():
    mods = {"repro_torch": 1, "repro_torch.core.msa": 1, "reprox": 1,
            "repro": 1, "repro.core": 1, "jax.numpy": 1, "flax": 1,
            "numpy": 1}
    assert prun.banned_modules(mods) == ["flax", "jax.numpy", "repro",
                                         "repro.core"]


def test_symmetric_kernel2_call_counts_distinct_pairs():
    N, L = 4096, 6344
    sym = roofline.match_valid_bound_s(N, N, L, True)
    full = roofline.match_valid_bound_s(N, N, L, False)
    ops_sym = 2 * (N * (N + 1) // 2) * L / roofline.INT8_OPS_PER_S
    assert sym == pytest.approx(max(ops_sym, (N * L + 8 * N * N)
                                    / roofline.HBM_BYTES_PER_S))
    assert sym < 0.51 * full


def test_kernel1_bound_counts_true_lengths():
    import numpy as np
    la = np.array([10.0, 20.0])
    lb = np.array([30.0, 40.0])
    t = roofline.sw_bound_s(la, lb, 70.0)
    ops = 20 * (300 + 800) / roofline.F32_OPS_PER_S
    nbytes = (30 + 70 + 10 * 31 + 20 * 41 + 80) / roofline.HBM_BYTES_PER_S
    assert t == pytest.approx(max(ops, nbytes))


def _tiny(cell):
    if cell.kind == "msa_nj":
        cell.traffic.update(n_seqs=24, pool=2)
        cell.config["family"]["root_len"] = 200
        cell.check["pairs"] = 6
    else:
        cell.traffic.update(n_leaves=8, pool=2, ml_steps=6, nni_rounds=2)
        cell.config["family"].update(root_len=240, branch_sub=0.05)
        cell.check["fits"] = 2
    return cell


def _copy_with_new_cell(tmp_path: Path) -> Path:
    """A checkout with one configuration, cell and per-layer metric added
    as files and entries only."""
    root = tmp_path / "checkout"
    here = root / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cfg = json.loads((here / "configs" / "rna16s.json").read_text())
    cfg.update(name="rna16s_short")
    cfg["family"]["root_len"] = 200
    (here / "configs" / "rna16s_short.json").write_text(json.dumps(cfg))
    wl = json.loads((here / "workloads" / "rna16s.msa_nj.json").read_text())
    wl["traffic"].update(n_seqs=20, pool=1)
    wl["check"]["pairs"] = 4
    (here / "workloads" / "rna16s_short.msa_nj.json").write_text(
        json.dumps(wl))
    (here / "metrics" / "jobs_traced.py").write_text(
        "def read(ctx):\n    return len(ctx.records)\n")
    bench["configs"].append({"name": "rna16s_short", "source": "x",
                             "file": "portbench/configs/rna16s_short.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "rna16s_short.msa_nj",
                               "config": "rna16s_short",
                               "traffic": "msa_nj", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "jobs_traced", "unit": "jobs",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "msa_seqs_per_s",
                               "workloads": ["rna16s_short.msa_nj"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "rna16s.msa_nj" in m["workloads"]:
            m["workloads"].append("rna16s_short.msa_nj")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def test_cell_config_and_metric_found_from_files(tmp_path):
    root = _copy_with_new_cell(tmp_path)
    cell = prun.Cell("rna16s_short.msa_nj", root=root,
                     here=root / "portbench")
    assert cell.config["family"]["root_len"] == 200
    assert cell.traffic["n_seqs"] == 20
    assert [m["name"] for m in cell.per_layer] == ["jobs_traced"]
    out = prun.run(cell.name, 2 ** 31 + 7, 0.1, True, device="cpu",
                   cell=cell)
    assert out["correct"], out["checks"]
    assert out["metrics"]["jobs_traced"] == {"value": out["attempted"],
                                             "unit": "jobs"}


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    cell = _tiny(prun.Cell("rna16s.msa_nj"))
    out = prun.run(cell.name, 2 ** 33 + 5, 0.05, trace, device="cpu",
                   cell=cell)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == want + (["breakdown"] if trace else []) + ["checks"]
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert set(out["device"]) >= {"busy_s", "window_s"}
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == {"msa_seqs_per_s", "peak_gib.msa",
                                       "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_main_refuses_without_a_card(monkeypatch, capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines "
                    "without one")
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", "unset")
    monkeypatch.setenv("TRITON_CACHE_DIR", "unset")
    monkeypatch.setattr("sys.path", list(__import__("sys").path))
    rc = prun.main(["--workload", "rna16s.msa_nj", "--seed", "1",
                    "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err

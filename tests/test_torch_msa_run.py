"""The slice gate: ``repro_torch.launch.msa_run`` against ``repro.launch.msa_run``.

Both launchers run in process on the same FASTA; the port on the CPU.
``aligned.fasta`` must be byte-identical, ``tree.nwk`` at RF = 0, and the
report fields equal except the backend name and the timings
(``avg_sp_penalty`` at rtol=1e-5: float32 sums in another order). Also:
the port refuses to run on a missing card instead of falling back, and
neither the port nor ``chip_smoke.py`` imports JAX or the reference.
"""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import treeio
from repro.data import SimConfig, simulate_family, write_fasta
from repro.launch import msa_run as jrun
from repro_torch.core import msa as tmsa
from repro_torch.launch import msa_run as trun

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: the port's CPU paths
    issue many small operations, and under the suite's parallel workers
    torch's thread pools oversubscribe the cores (my CPU runs: 10-25x
    slower). Modules that import this fixture get it too."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _splits(newick: str, names):
    """Non-trivial bipartitions of a Newick tree, as sets of leaf names."""
    everyone = frozenset(names)
    splits, stack = set(), [set()]
    for tok in re.findall(r"\(|\)|[^(),:;]+(?=:)|,", newick):
        if tok == "(":
            stack.append(set())
        elif tok == ")":
            clade = stack.pop()
            stack[-1] |= clade
            if 1 < len(clade) < len(names) - 1:
                splits.add(treeio.canonical_split(frozenset(clade),
                                                  everyone))
        elif tok != ",":
            stack[-1].add(tok)
    return splits


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("msa_run")
    fam = simulate_family(SimConfig(n_leaves=12, root_len=300, seed=1,
                                    branch_sub=0.03))
    write_fasta(d / "in.fa", fam.names, fam.seqs)
    jrun.main(["--fasta", str(d / "in.fa"), "--out", str(d / "jax")])
    trun.main(["--fasta", str(d / "in.fa"), "--out", str(d / "torch"),
               "--device", "cpu"])
    return d, fam.names


def test_aligned_fasta_byte_identical(runs):
    d, _ = runs
    assert (d / "torch" / "aligned.fasta").read_bytes() == \
        (d / "jax" / "aligned.fasta").read_bytes()


def test_tree_rf_zero(runs):
    d, names = runs
    ref = _splits((d / "jax" / "tree.nwk").read_text(), names)
    out = _splits((d / "torch" / "tree.nwk").read_text(), names)
    assert len(ref) == len(names) - 3
    assert out == ref


def test_report_fields_match(runs):
    d, _ = runs
    ref = json.loads((d / "jax" / "report.json").read_text())
    out = json.loads((d / "torch" / "report.json").read_text())
    assert ref["backend"] == "jnp" and out["backend"] == "torch"
    skip = {"backend", "msa_seconds", "tree_seconds", "avg_sp_penalty"}
    assert set(out) == set(ref)
    assert {k: out[k] for k in out if k not in skip} == \
        {k: ref[k] for k in ref if k not in skip}
    np.testing.assert_allclose(out["avg_sp_penalty"], ref["avg_sp_penalty"],
                               rtol=1e-5)


def test_cuda_request_without_card_raises(runs, monkeypatch):
    d, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--fasta", str(d / "in.fa"), "--out", str(d / "never"),
                   "--device", "cuda"])
    assert not (d / "never").exists()


@pytest.mark.parametrize("entry", ["matrix", "engine"])
def test_msa_config_entry_points_default_to_the_card(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(tmsa.MSAConfig(), entry)()
    assert getattr(tmsa.MSAConfig(), entry)("cpu") is not None


@pytest.mark.parametrize("flags", [["--dist"], ["--dist", "--tree", "tiled"],
                                   ["--tree", "ml"],
                                   ["--tree", "ml", "--tree-ll"]])
def test_unported_flags_name_the_roadmap(runs, flags, tmp_path, capsys):
    """``--tree ml`` is ported and reports its model and logL
    before/after. ``--dist`` is ported: in a world of one on the CPU its
    files are the host run's (``--tree tiled`` against the same run
    without ``--dist``) and its report's ``kmer_fallbacks`` is null."""
    d, names = runs
    if "ml" in flags:
        trun.main(["--fasta", str(d / "in.fa"), "--device", "cpu",
                   "--out", str(tmp_path), *flags])
        report = json.loads((tmp_path / "report.json").read_text())
        assert report["tree_backend"] == "dense+ml"
        assert report["tree_model"] in ("jc69", "k80", "hky85", "gtr")
        assert report["tree_logl"]["final"] >= report["tree_logl"]["initial"]
        assert ("log_likelihood" in report) == ("--tree-ll" in flags)
        assert len(_splits((tmp_path / "tree.nwk").read_text(),
                           names)) == len(names) - 3
        return
    host = d / "torch"
    if "tiled" in flags:
        host = tmp_path / "host"
        trun.main(["--fasta", str(d / "in.fa"), "--device", "cpu",
                   "--out", str(host), *flags[1:]])
    trun.main(["--fasta", str(d / "in.fa"), "--device", "cpu",
               "--out", str(tmp_path / "dist"), *flags])
    for f in ("aligned.fasta", "tree.nwk"):
        assert (tmp_path / "dist" / f).read_bytes() == \
            (host / f).read_bytes(), f
    report = json.loads((tmp_path / "dist" / "report.json").read_text())
    assert report["kmer_fallbacks"] is None
    assert report["tree_backend"] == ("tiled-exact" if "tiled" in flags
                                      else "dense")


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_and_no_reference():
    files = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
             + sorted((ROOT / "tools").glob("*.py")))
    assert len(files) > 20
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_every_port_module_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'repro' or k.startswith('repro.')"
        " for k in sys.modules), 'reference imported'\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20

"""Generate src/repro_torch/CLI.md from the port's launchers' own argparse
definitions.

The reference is generated once (``PYTHONPATH=src python -m
repro_torch.launch.cli_docs``) and committed;
``tests/test_torch_cli_docs.py`` regenerates it in memory and fails when a
flag changed without the doc. Width is pinned via COLUMNS so the
rendering is terminal-independent. ``docs/CLI.md`` is the JAX package's
reference and stays its own.
"""
from __future__ import annotations

import importlib
import os
from pathlib import Path

# the port's launchers (all expose build_parser())
CLIS = [
    "repro_torch.launch.msa_run",
    "repro_torch.launch.tree_run",
    "repro_torch.launch.search_run",
    "repro_torch.launch.serve_msa",
    "repro_torch.launch.serve",
    "repro_torch.launch.train",
]

OUT = Path(__file__).resolve().parents[1] / "CLI.md"

HEADER = """\
# CLI reference of the PyTorch/CUDA port

Generated from each launcher's `argparse` definition by
`PYTHONPATH=src python -m repro_torch.launch.cli_docs` — do not edit by
hand; `tests/test_torch_cli_docs.py` fails when a flag changes without
regenerating. Every launcher takes the JAX package's flags
(`docs/CLI.md`) and `--device` (default `cuda`; `cpu` runs the plain
PyTorch path).
"""


def render() -> str:
    old = os.environ.get("COLUMNS")
    os.environ["COLUMNS"] = "79"            # argparse help wraps on this
    try:
        parts = [HEADER]
        for mod_name in CLIS:
            mod = importlib.import_module(mod_name)
            helptext = mod.build_parser().format_help().rstrip()
            parts.append(f"\n## `python -m {mod_name}`\n\n"
                         f"```text\n{helptext}\n```\n")
        return "".join(parts)
    finally:
        if old is None:
            os.environ.pop("COLUMNS", None)
        else:
            os.environ["COLUMNS"] = old


def main():
    OUT.write_text(render())
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()

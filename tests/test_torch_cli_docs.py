"""The port's CLI reference: ``src/repro_torch/CLI.md`` is what
``repro_torch.launch.cli_docs.render()`` gives (regenerate with
``PYTHONPATH=src python -m repro_torch.launch.cli_docs``), and each port
launcher takes its reference launcher's options, with the same
destinations, defaults, choices, arities and types, plus ``--device``.
Help texts may differ: each names its own package."""
import importlib

import pytest

from repro_torch.launch import cli_docs


def test_cli_reference_not_drifted():
    assert cli_docs.OUT.read_text() == cli_docs.render(), (
        "src/repro_torch/CLI.md is stale: run PYTHONPATH=src python -m "
        "repro_torch.launch.cli_docs")
    assert cli_docs.OUT.name == "CLI.md" and \
        cli_docs.OUT.parent.name == "repro_torch"


def _options(mod_name):
    parser = importlib.import_module(mod_name).build_parser()
    return {tuple(a.option_strings): (
        a.dest, a.default, tuple(a.choices) if a.choices else None, a.nargs,
        a.const, a.required, getattr(a.type, "__name__", a.type))
        for a in parser._actions}


@pytest.mark.parametrize("mod_name", cli_docs.CLIS)
def test_port_launcher_flags_equal_reference(mod_name):
    port = _options(mod_name)
    ref = _options(mod_name.replace("repro_torch.", "repro.", 1))
    device = port.pop(("--device",))
    assert device[:2] == ("device", "cuda")
    assert port == ref

"""The port's example scripts import names that exist.

The probes and profilers under ``examples/`` run only on the card, where a
name that moved (a helper of ``chip_smoke.py`` that went to
``utils/profiling``, say) fails only when the script is run.  Here every
``from X import a, b`` in them — at the top or inside a function — whose
module is ``chip_smoke``, the port's package or another example is
resolved on the CPU, without running the script; and so is every
``alias.name`` used on such a module imported whole (``import X as alias``),
in the examples and in ``chip_smoke.py``.
"""
import ast
import glob
import importlib
import importlib.util
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples", "*_torch.py")))
LOCAL = {os.path.splitext(os.path.basename(p))[0] for p in EXAMPLES} | {"chip_smoke"}


def _imports(path):
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            top = node.module.split(".")[0]
            if top == "points_matching_tpu_torch" or node.module in LOCAL:
                yield node.module, [a.name for a in node.names], node.lineno


@pytest.mark.parametrize("path", EXAMPLES, ids=os.path.basename)
def test_example_imports_resolve(path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    monkeypatch.syspath_prepend(ROOT)
    missing = []
    for module, names, line in _imports(path):
        mod = importlib.import_module(module)
        for n in names:
            submodule = hasattr(mod, "__path__") and importlib.util.find_spec(f"{module}.{n}")
            if n != "*" and not hasattr(mod, n) and not submodule:
                missing.append(f"{module}.{n} (line {line})")
    assert not missing, missing


def _module_attributes(path):
    """(module, attribute, line) for each ``alias.attr`` of a module of
    ``LOCAL`` imported whole in ``path``."""
    with open(path, encoding="utf-8") as f:
        tree = ast.parse(f.read(), path)
    aliases = {a.asname or a.name: a.name for node in ast.walk(tree)
               if isinstance(node, ast.Import) for a in node.names if a.name in LOCAL}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
                and node.value.id in aliases):
            yield aliases[node.value.id], node.attr, node.lineno


@pytest.mark.parametrize("path", EXAMPLES + [os.path.join(ROOT, "chip_smoke.py")],
                         ids=os.path.basename)
def test_module_attributes_resolve(path, monkeypatch):
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    monkeypatch.syspath_prepend(ROOT)
    missing = [f"{module}.{name} (line {line})" for module, name, line in _module_attributes(path)
               if not hasattr(importlib.import_module(module), name)]
    assert not missing, missing

"""Import hygiene of the PyTorch port.

The port stands on its own: no module under ``src/repro_torch/`` and not
``chip_smoke.py`` may import JAX, ``ml_dtypes`` (absent on the machine
with the card) or anything of the reference package ``repro`` — not even
its modules that import no JAX.  Only the tests import both packages.
"""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, (node.module or "").split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args:
            arg = node.args[0]
            # an f-string's leading constant names its package
            if isinstance(arg, ast.JoinedStr) and arg.values:
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node.lineno, arg.value.split(".")[0]


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert (ROOT / "chip_smoke.py").is_file()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_module_imports_no_jax_and_no_reference(path):
    bad = [(line, mod) for line, mod in _imported_roots(path)
           if mod in FORBIDDEN]
    assert bad == [], f"{path.relative_to(ROOT)} imports {bad}"


def test_hygiene_check_catches_a_reference_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy\nfrom repro.core import tiling\n"
                 "import importlib\nimportlib.import_module('jax.numpy')\n"
                 "importlib.import_module(f'repro.configs.{arch}')\n")
    assert [m for _, m in _imported_roots(f) if m in FORBIDDEN] == [
        "repro", "jax", "repro"]


def test_registry_loads_the_ports_own_config_modules():
    """The port's registry imports ``repro_torch.configs.<arch>`` by name
    (the reference's imports ``repro.configs.<arch>``)."""
    import sys

    from repro_torch.configs import base, get_config
    registry = ROOT / "src" / "repro_torch" / "configs" / "registry.py"
    assert [m for _, m in _imported_roots(registry)].count("repro_torch") == 1
    cfg = get_config("qwen3-0-6b")
    assert isinstance(cfg, base.ModelConfig)
    assert "repro_torch.configs.qwen3_0_6b" in sys.modules


@pytest.mark.parametrize("package", ["api", "serve", "tuning"])
def test_public_packages_export_the_references_names(package):
    """``repro_torch.<package>`` exports exactly the names
    ``repro.<package>`` does, and each resolves."""
    import importlib
    ref = importlib.import_module(f"repro.{package}")
    port = importlib.import_module(f"repro_torch.{package}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    assert all(hasattr(port, name) for name in port.__all__)

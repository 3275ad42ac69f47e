"""Twins of ``test_docs.py`` for the port: what ``README.md``'s
"PyTorch/CUDA port" section names must exist.

The reference's suite matches ``\\brepro\\.``, which never matches
``repro_torch.``; this one checks the port's section against the port:

* every dotted ``repro_torch.*`` path resolves by import + getattr;
* every ``--flag`` shown next to one of the port's runnables
  (``python -m repro_torch.<module>``, ``chip_smoke.py``, ``tools/*.py``,
  ``examples/torch_*.py``)
  is registered by that runnable's argparse (its ``--help``; a script
  without argparse is never run, since some need a card);
* every ``BLASX_*`` variable the section names is read under
  ``src/repro_torch``;
* every ``cblas_*`` name is exported by ``repro_torch.api``, and every
  ``ctx.<method>`` / ``srv.<method>`` is an attribute of the port's
  ``BlasxContext`` / ``BlasxServer``.
"""
import contextlib
import functools
import importlib
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT = REPO_ROOT / "src" / "repro_torch"


def _port_section() -> str:
    text = (REPO_ROOT / "README.md").read_text(encoding="utf-8")
    start = text.index("## PyTorch/CUDA port")
    end = text.index("\n## ", start + 1)
    return text[start:end]


def test_port_docs_exist():
    section = _port_section()
    for name in ("PERF.md", "ROADMAP.md", "chip_smoke.py"):
        assert (REPO_ROOT / name).exists(), name
        assert name in section or name == "ROADMAP.md", name


# the port's runnables as they appear on doc command lines: a module
# run with -m, or a script
_RUNNABLES = {
    r"-m repro_torch\.analysis(?![\w.])": "repro_torch.analysis.cli",
    r"-m repro_torch\.launch\.dryrun(?![\w.])": "repro_torch.launch.dryrun",
    r"-m repro_torch\.launch\.serve(?![\w.])": "repro_torch.launch.serve",
    r"-m repro_torch\.launch\.train(?![\w.])": "repro_torch.launch.train",
    r"-m repro_torch\.serve(?![\w.])": "repro_torch.serve.__main__",
    r"chip_smoke\.py": REPO_ROOT / "chip_smoke.py",
    **{re.escape(f"tools/{p.name}"): p
       for p in sorted((REPO_ROOT / "tools").glob("*.py"))},
    **{re.escape(f"examples/{p.name}"): p
       for p in sorted((REPO_ROOT / "examples").glob("torch_*.py"))},
}


@functools.cache
def _argparse_flags(runnable) -> set:
    """The --flags a runnable's argparse registers, from its --help: a
    module's ``main(["--help"])`` in this process, a script's
    ``--help`` in a subprocess; a script without argparse takes none
    (and is never run: some need a card)."""
    if isinstance(runnable, str):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
            importlib.import_module(runnable).main(["--help"])
        out = buf.getvalue()
    elif "argparse" not in runnable.read_text(encoding="utf-8"):
        out = ""
    else:
        out = subprocess.run(
            [sys.executable, str(runnable), "--help"], check=True,
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(REPO_ROOT / "src"))).stdout
    return set(re.findall(r"--[A-Za-z][A-Za-z0-9-]*", out))


def test_cli_flags_in_docs_exist():
    flag_re = re.compile(r"(?<![\w-])--[a-z][a-z0-9-]*")
    joined = re.sub(r"\\\n\s*", " ", _port_section())
    checked, runnables = 0, set()
    for lineno, line in enumerate(joined.splitlines(), 1):
        found = [r for pat, r in _RUNNABLES.items() if re.search(pat, line)]
        if not found:
            continue
        runnables.update(found)
        for flag in flag_re.findall(line):
            assert any(flag in _argparse_flags(r) for r in found), (
                f"README:{lineno} shows {flag} for {found}, which "
                f"registers no such flag")
            checked += 1
    assert checked >= 15
    assert "repro_torch.launch.dryrun" in runnables


def _resolve(dotted):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ImportError(dotted)


def test_dotted_repro_torch_paths_resolve():
    pat = re.compile(r"\brepro_torch\.[a-z_][A-Za-z0-9_.]*")
    seen = set()
    for dotted in pat.findall(_port_section()):
        dotted = dotted.rstrip(".")
        if dotted in seen:
            continue
        seen.add(dotted)
        try:
            _resolve(dotted)
        except (ImportError, AttributeError) as e:
            pytest.fail(f"README references {dotted}, which does not "
                        f"resolve: {e}")
    assert len(seen) >= 10
    assert "repro_torch.launch.dryrun" in seen


def test_env_vars_in_docs_exist_in_code():
    source = "\n".join(p.read_text(encoding="utf-8")
                       for p in sorted(PORT.rglob("*.py")))
    seen = set(re.findall(r"BLASX_[A-Z_]{2,}(?![a-z])", _port_section()))
    for var in seen:
        assert var in source, f"README names {var}; the port never reads it"
    assert "BLASX_TORCH_TUNING_CACHE" in seen


def test_cblas_names_exported():
    api = importlib.import_module("repro_torch.api")
    names = set(re.findall(r"\bcblas_[a-z0-9]+\b", _port_section()))
    for name in names:
        assert hasattr(api, name), f"repro_torch.api does not export {name}"
    assert {"cblas_dgemm", "cblas_strsm"} <= names


def test_context_and_server_methods_exist():
    from repro_torch.api import BlasxContext
    from repro_torch.serve import BlasxServer

    section = _port_section()
    seen = 0
    for var, cls in (("ctx", BlasxContext), ("srv", BlasxServer)):
        for attr in set(re.findall(rf"\b{var}\.([A-Za-z_]\w*)", section)):
            assert hasattr(cls, attr), (
                f"README references {var}.{attr}; the port's "
                f"{cls.__name__} has no such attribute")
            seen += 1
    assert seen >= 4

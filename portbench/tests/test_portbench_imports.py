"""Nothing under portbench/ loads JAX or the JAX package, and the
reference loads nothing of the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "jpgenc_tpu"}


def _imports(path: Path) -> set:
    """Top-level names of every module a file imports (whole names: the
    port's `jpgenc_tpu_torch` is not `jpgenc_tpu`)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not _imports(path) & (FORBIDDEN | {"jpgenc_tpu_torch", "torch",
                                              "portbench"})


def test_whole_names_are_compared():
    import jpgenc_tpu_torch  # noqa: F401
    from portbench.harness import forbidden_modules
    assert forbidden_modules() == []


def test_a_loaded_jax_is_found(monkeypatch):
    from portbench.harness import forbidden_modules
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    """The modules a run imports, in a fresh interpreter."""
    code = ("import sys; sys.path.insert(0, 'portbench/..');"
            "import portbench.harness as h, portbench.control, "
            "portbench.tracing;"
            "h.port_modules(); print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"

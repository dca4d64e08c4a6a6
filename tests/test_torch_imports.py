"""The port stands alone: `import repro_torch` (and every module of it)
leaves `jax` and the reference package `repro` out of `sys.modules`, and
no file of the port, `chip_smoke.py` or the port's scripts and examples
(`scripts/torch_*.py`, `examples/torch_*.py`) imports either."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "repro")


def _forbidden(module: str) -> bool:
    """Exact module or a submodule of it: `repro_torch` is not `repro`."""
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def _port_files():
    return (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
            + sorted(ROOT.glob("scripts/torch_*.py"))
            + sorted(ROOT.glob("examples/torch_*.py")))


def test_forbidden_matches_exact_names():
    assert _forbidden("repro") and _forbidden("repro.core.noc")
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert not _forbidden("repro_torch") and not _forbidden("jaxlib_x")


def test_import_leaves_jax_and_repro_out():
    mods = sorted(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        .replace(".__init__", "") for p in PORT.rglob("*.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {[m.rstrip('.') for m in mods]!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'repro') or "
        "m.startswith(('jax.', 'repro.'))]\n"
        "print(repr(bad))\n")
    env_path = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env={"PYTHONPATH": env_path, "PATH": "/usr/bin:/bin",
                              "JAX_PLATFORMS": "cpu"},
                         timeout=120)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_file_imports_jax_or_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"

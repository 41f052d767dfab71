"""The PyTorch port stands alone: no module of maskedsst_tpu_torch, and not
chip_smoke.py nor the test helper it imports, imports jax, flax or the JAX
package maskedsst_tpu."""

import ast
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "maskedsst_tpu_torch"
FORBIDDEN = ("jax", "flax", "maskedsst_tpu", "optax", "msgpack")
SOURCES = sorted(p.relative_to(ROOT).as_posix() for p in PKG.rglob("*.py")) + [
    "chip_smoke.py", "tests/quiet_tracker.py"]


def _module_name(rel: str) -> str:
    name = rel[: -len(".py")].replace("/", ".")
    return name[: -len(".__init__")] if name.endswith(".__init__") else name


def test_every_module_imports_without_jax():
    mods = [_module_name(s) for s in SOURCES if s != "chip_smoke.py"] + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("rel", SOURCES)
def test_source_names_no_jax_import(rel):
    tree = ast.parse((ROOT / rel).read_text(), filename=rel)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{rel}:{node.lineno} imports {name}"


def test_chip_smoke_fails_without_a_card():
    """No CUDA device here: the smoke test exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    """Copied into a directory that holds nothing else of the repo, it fails."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout

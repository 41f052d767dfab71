"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port, maskedsst_tpu_torch, is allowed), and the
reference imports nothing of the port."""

import ast
import sys
from pathlib import Path

from hsi_bench import run

HERE = Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "maskedsst_tpu"}


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert len(files) > 20
    bad = {str(f.relative_to(HERE)): imported_tops(f) & BANNED for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert "maskedsst_tpu_torch" not in tops and not tops & BANNED, f


def test_the_run_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "maskedsst_tpu_torch.shadow", sys)
    monkeypatch.setitem(sys.modules, "maskedsst_tpu_torch_shadow", sys)
    assert "maskedsst_tpu" not in run.loaded_banned()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert "flax" in run.loaded_banned()

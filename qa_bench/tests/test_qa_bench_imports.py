"""The reference imports nothing of JAX, of the JAX package or of the port,
and the harness's look at ``sys.modules`` compares top-level names whole
(the port's name begins with the JAX package's). A run's own look is held
in ``test_qa_bench_runs.py``."""

import ast
import sys
from pathlib import Path

from qa_bench import harness

REFERENCE = Path(__file__).resolve().parents[1] / "reference"
BANNED = {"jax", "jaxlib", "flax", "bridgeqa_tpu", "bridgeqa_tpu_torch"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_reference_imports_neither_jax_nor_either_package():
    files = sorted(REFERENCE.glob("*.py"))
    assert len(files) >= 6
    for f in files:
        assert not imported_roots(f) & BANNED, f


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("bridgeqa_tpu_torch", "bridgeqa_tpu_torch.models", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys.modules["json"])
    assert harness.forbidden_modules() == [] or all(
        m.split(".")[0] in harness.FORBIDDEN for m in harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "bridgeqa_tpu.models", sys.modules["json"])
    assert "bridgeqa_tpu.models" in harness.forbidden_modules()

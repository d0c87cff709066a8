"""No file of the benchmark imports JAX or the JAX package, and nothing
of the reference imports the program under test.

Imports are compared by their top-level name, whole:
``digipathai_tpu_torch`` begins with ``digipathai_tpu`` and is allowed.
"""

import ast
from pathlib import Path

PB = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "optax", "digipathai_tpu"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & JAX, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((PB / "reference").rglob("*.py")):
        assert "digipathai_tpu_torch" not in top_level_imports(f), f


def test_the_whole_name_is_compared():
    assert "digipathai_tpu_torch".split(".")[0] not in JAX
    tmp = {"digipathai_tpu_torch.engine", "jax.numpy"}
    assert {m.split(".")[0] for m in tmp} & JAX == {"jax"}


def test_no_file_reads_the_old_records():
    for f in sorted(PB.rglob("*.py")):
        text = f.read_text()
        for name in ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE"):
            assert name not in text or f.name == Path(__file__).name, (f,
                                                                       name)

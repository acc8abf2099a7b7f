"""No module the harness runs imports JAX or the JAX package, judged by the
whole top-level name; the reference imports nothing of the port either."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "vamp_mvt_tpu"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _files(*parts):
    return [p for p in BENCH.joinpath(*parts).rglob("*.py") if "tests" not in p.parts]


def test_harness_imports_no_jax():
    files = _files()
    assert len(files) > 20
    for f in files:
        assert not (_imports(f) & FORBIDDEN), f


def test_reference_imports_nothing_of_the_program():
    for f in _files("reference"):
        tops = _imports(f)
        assert not (tops & (FORBIDDEN | {"vamp_mvt_tpu_torch"})), f
        assert tops <= {"__future__", "json", "math", "itertools", "pathlib", "time", "numpy",
                        "torch", "planbench"}, (f, tops)


def test_a_name_that_only_begins_like_the_jax_package_passes():
    assert "vamp_mvt_tpu_torch".split(".")[0] not in FORBIDDEN

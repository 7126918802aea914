"""The import check: the port passes, JAX and the JAX package fail, compared
by whole top-level names; and no file of the benchmark imports them."""
import ast
import sys
import types

import pytest

from harness import common


def test_the_port_passes():
    import unirec_tpu_torch  # noqa: F401
    assert "unirec_tpu_torch" in {n.split(".")[0] for n in sys.modules}
    assert "unirec_tpu" not in common.forbidden_loaded()


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib", "flax.linen",
                                  "unirec_tpu", "unirec_tpu.models"])
def test_forbidden_names_fail(name, monkeypatch):
    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert name.split(".")[0] in common.forbidden_loaded()


def test_no_benchmark_file_imports_them():
    for path in common.BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                tops = [node.module.split(".")[0]]
            else:
                continue
            assert not set(tops) & set(common.FORBIDDEN_MODULES), (path, tops)
            if path.parent.name == "reference":
                assert "unirec_tpu_torch" not in tops and "harness" not in tops, path

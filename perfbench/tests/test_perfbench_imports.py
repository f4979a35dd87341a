"""The import rule: nothing under perfbench/ imports JAX or the JAX package
(``ray_tpu``, compared as a whole top-level name, since the port's name
begins with it), and the reference imports nothing of the program."""

import ast
import pathlib

BASE = pathlib.Path(__file__).resolve().parents[1]


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_or_jax_package():
    files = sorted(BASE.rglob("*.py"))
    assert files
    for path in files:
        bad = _top_level_imports(path) & {"jax", "jaxlib", "flax", "ray_tpu"}
        assert not bad, f"{path} imports {bad}"


def test_reference_imports_nothing_of_the_program():
    files = sorted((BASE / "reference").rglob("*.py"))
    assert files
    for path in files:
        assert "ray_tpu_torch" not in _top_level_imports(path), path


def test_the_rule_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import ray_tpu_torch.ops\nfrom ray_tpu import x\n")
    assert _top_level_imports(p) == {"ray_tpu_torch", "ray_tpu"}

"""Nothing under ``bcastbench/`` imports JAX or the JAX package ``repro``
(top-level module names compared whole: ``repro_torch`` is not
``repro``), and the reference imports nothing of the program."""

import ast

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "bcastbench").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path) -> set:
    """The top-level names of every module ``path`` imports."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_and_no_reference_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("name", ["reference.py", "roofline.py",
                                  "traffic.py"])
def test_the_reference_imports_nothing_of_the_program(name):
    assert "repro_torch" not in imported(ROOT / "bcastbench" / name)


def test_the_check_sees_a_whole_name(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.api\nfrom repro.core import bbs\n")
    assert imported(f) == {"repro_torch", "repro"}

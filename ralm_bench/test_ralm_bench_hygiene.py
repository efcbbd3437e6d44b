"""Nothing of the benchmark imports JAX or the JAX package (``repro``),
and its reference imports nothing of the port either. Module names are
compared by their top-level name, whole: ``repro_torch`` is not
``repro``."""
import ast
import pathlib

import pytest

HERE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_or_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "repro_torch" not in names and not names & FORBIDDEN


def test_top_level_names_compared_whole():
    src = "import repro_torch.serve\nfrom repro_torch import x\n"
    tree = ast.parse(src)
    got = {a.name.split(".")[0] for n in ast.walk(tree)
           if isinstance(n, ast.Import) for a in n.names}
    assert got == {"repro_torch"} and not got & FORBIDDEN

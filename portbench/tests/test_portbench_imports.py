"""Nothing a chip run loads is JAX or the JAX package, compared by whole
top-level module names (``sadvio_tpu_torch`` is not ``sadvio_tpu``), and the
reference imports nothing of the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import HERE, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "sadvio_tpu"}


def _top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        assert not set(_top_level_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").rglob("*.py"):
        assert "sadvio_tpu_torch" not in set(_top_level_imports(path)), path


def test_a_process_that_loads_the_run_and_the_program_holds_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.run, portbench.program, portbench.check, portbench.trace;"
            "import sadvio_tpu_torch.pipeline.slam, sadvio_tpu_torch.pipeline.mono;"
            "from portbench.run import forbidden_modules;"
            "print(sorted({m.split('.')[0] for m in sys.modules}));"
            "sys.exit(1 if forbidden_modules() else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "sadvio_tpu_torch" in out.stdout


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "sadvio_tpu_torch_fake", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]

"""Nothing under graphbench/ imports JAX, the JAX package ``repro`` or the
old ``benchmarks/`` folder; top-level module names are compared whole, so
the port ``repro_torch`` is not ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from graphbench import harness

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks"}
SOURCES = sorted(p for p in (ROOT / "graphbench").rglob("*.py")
                 if "__pycache__" not in p.parts)


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[p.relative_to(ROOT).as_posix() for p in SOURCES])
def test_no_forbidden_import(path):
    found = set(top_level_imports(path)) & FORBIDDEN
    assert not found, f"{path} imports {found}"


def test_names_compared_whole():
    names = ["repro_torch", "repro_torch.stream", "reprox", "jaxtyping"]
    assert not {n.split(".")[0] for n in names} & FORBIDDEN
    assert "repro" in {n.split(".")[0] for n in ["repro.core"]}


def test_the_harness_process_holds_no_jax():
    """The harness and the program, imported alone, load no JAX module."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), str(ROOT / "src")]))
    code = ("import graphbench.harness as h, graphbench.judge, "
            "graphbench.devtrace, graphbench.gen; "
            "print(h.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_forbidden_modules_compares_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.stream",
                                      "torch", "jaxtyping"]) == []
    assert harness.forbidden_modules(["jaxlib.xla_client", "repro.core",
                                      "flax", "numpy"]) == ["flax", "jaxlib",
                                                            "repro"]

"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: ``raytpu_torch`` is the program, ``raytpu`` is
not), the reference imports nothing of the program, and nothing reads
the JAX-era ``bench.py`` or ``benchmarks/``."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import device, spec

PB = os.path.join(spec.ROOT, "portbench")


def _sources():
    for d, dirs, files in os.walk(PB):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


SOURCES = sorted(os.path.relpath(p, PB) for p in _sources())


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return tree, names


def _literals(tree):
    """String constants that are not docstrings."""
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


def test_top_level_names_compare_whole():
    assert "raytpu_torch".split(".")[0] not in device.BANNED
    assert "raytpu.engine".split(".")[0] in device.BANNED


@pytest.mark.parametrize("rel", SOURCES)
def test_no_banned_import(rel):
    tree, names = _imports(os.path.join(PB, rel))
    assert not names & set(device.BANNED), rel
    assert not names & {"bench", "benchmarks"}, rel
    for s in _literals(tree):
        assert "benchmarks/" not in s and "bench.py" not in s, (rel, s)
    if rel.startswith("reference"):
        assert "raytpu_torch" not in names, rel


def test_loaded_modules_of_a_run_hold_none(tmp_path):
    code = (
        "import sys\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "import portbench.harness.cell, portbench.harness.port\n"
        "import portbench.reference.tracer, portbench.scenes.atrium\n"
        "from portbench.harness import spec, device\n"
        "s = spec.Spec()\n"
        "for m in s.bench['per_layer']: s.reader(m['name'])\n"
        "print(device.banned_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, cwd=tmp_path)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"

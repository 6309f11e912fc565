"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port: top-level module names compared
whole (``repro_torch`` is not ``repro``)."""
import ast
import glob
import json
import os
import subprocess
import sys
from types import ModuleType

import harness

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def _sources(pattern="**/*.py"):
    return [p for p in glob.glob(os.path.join(HERE, pattern), recursive=True)
            if not os.path.basename(p).startswith("test_")]


def test_no_source_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not set(_imports(path)) & JAX, path


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference/*.py"):
        assert not set(_imports(path)) & (JAX | {"repro_torch"}), path


def _loaded(code):
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join(
        [HERE, os.path.join(REPO, "src")]))
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")],
        capture_output=True, text=True, env=env, timeout=300, cwd=HERE)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_module(tmp_path):
    got = _loaded(
        "import smokecell, harness, glob\n"
        f"root = smokecell.make_root({str(tmp_path)!r})\n"
        "harness.run('falcon-mamba.train.b8s2048', 1, 0.1, True,"
        " device='cpu', root=root)\n"
        "[harness.load_module(p) for p in glob.glob('metrics/*.py')"
        " + glob.glob('counts/*.py')]")
    assert "repro_torch" in got
    assert not got & JAX, got & JAX


def test_the_reference_loads_no_program_module():
    got = _loaded("from reference import model\nimport weights, compare")
    assert not got & (JAX | {"repro_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in list(sys.modules):
        if name.split(".")[0] in JAX:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "repro_torch_probe", ModuleType("x"))
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "repro.models", ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax.numpy", ModuleType("x"))
    assert harness.forbidden_loaded() == ["jax", "repro"]

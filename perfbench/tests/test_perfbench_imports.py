"""What the benchmark's modules import and read: nothing of JAX or of
the JAX package (by whole top-level name: `fashion_nerf_torch` is the
program, `fashion_nerf` is not), the reference nothing of the program,
and no file of the JAX package's benchmarks."""

import ast
import os
import re

from perfbench import ROOT

HERE = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "fashion_nerf"}
# the JAX package's benchmark files and results
JAX_BENCH = re.compile(r"(^|/)(bench/|bench\.py|BENCH_|MULTICHIP_)")


def sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_imports(path):
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_no_jax_anywhere():
    for path in sources():
        assert not top_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(HERE, "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            got = top_imports(os.path.join(ref, f))
            assert got <= {"__future__", "math", "contextlib", "numpy",
                           "torch"}, (f, got)


def test_reads_no_jax_benchmark_file():
    for path in sources():
        if path.endswith("test_perfbench_imports.py"):
            continue
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert not JAX_BENCH.search(node.value), (path, node.value)


def test_whole_name_rule():
    # the port's name begins with the JAX package's: only whole names count
    assert "fashion_nerf_torch".split(".")[0] not in FORBIDDEN
    assert "fashion_nerf.core".split(".")[0] in FORBIDDEN

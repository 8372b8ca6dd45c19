"""What the benchmark's modules import, by the top-level name compared
whole: nothing of JAX or of the JAX package anywhere under bench_h100/,
nothing of the program in the reference, and neither the program's bench
module, chip_smoke.py nor scripts/ in the harness."""

import ast
import os

import pytest

from bench_h100 import spec

FILES = sorted(os.path.join(d, f) for d, _, fs in os.walk(spec.HERE)
               for f in fs if f.endswith(".py"))


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES,
                         ids=[os.path.relpath(f, spec.HERE) for f in FILES])
def test_imports(path):
    names = list(imported(path))
    tops = {n.split(".")[0] for n in names}
    assert not tops & {"jax", "jaxlib", "flax", "hifiles_tpu"}
    assert not tops & {"chip_smoke", "scripts", "bench"}
    assert "hifiles_tpu_torch.bench" not in names
    if os.sep + "reference" + os.sep in path:
        assert "hifiles_tpu_torch" not in tops


def test_the_harness_and_the_program_load_no_jax():
    import subprocess
    import sys
    code = ("import bench_h100.run, bench_h100.program, bench_h100.control;"
            "from bench_h100 import run; print(run.jax_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"

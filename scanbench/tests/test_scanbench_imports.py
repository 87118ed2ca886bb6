"""What the benchmark loads: never JAX nor the JAX package (top-level names
compared whole, since the port's name begins with the JAX package's), and
in the reference nothing of the port; without a card a run fails."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
FORBIDDEN = {"jax", "jaxlib", "flax", "rescan_tpu"}
SOURCES = [f for f in glob.glob(os.path.join(ROOT, "scanbench", "**", "*.py"),
                                recursive=True)
           if os.sep + "tests" + os.sep not in f]


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    return names


def _fresh(code):
    env = {k: v for k, v in os.environ.items() if not k.startswith("JAX")}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & FORBIDDEN


def test_harness_and_port_load_no_jax():
    out = _fresh(
        "import sys, json; from scanbench import harness; "
        "from rescan_tpu_torch.pipeline import pose_proposal, "
        "segment_transfer, seg2rsdb; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(json.loads(out)) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = [p for p in SOURCES if os.sep + "reference" + os.sep in p] + [
        os.path.join(ROOT, "scanbench", f) for f in ("scenes.py",
                                                     "kernels.py")]
    for path in ref:
        assert not any(n.split(".")[0].startswith("rescan_tpu")
                       for n in _imports(path)), path
    out = _fresh(
        "import sys, json; from scanbench.reference import check; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not any(m.startswith("rescan_tpu") for m in json.loads(out))


def test_without_a_card_a_run_fails_and_prints_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    r = subprocess.run([sys.executable, "scanbench/run.py", "--workload",
                        "office.move2", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "{" not in r.stdout

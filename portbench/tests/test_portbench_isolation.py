"""What the benchmark may load and where it may run: no JAX and no JAX
package in any module of it or in a run's process, the reference free of
the program, no result without a card or without the program."""
import ast
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "vtkcloudpoint_tpu"}
OLD_BENCH = {"bench", "benchmarks", "tools", "chip_smoke"}
HERE = os.path.join(ROOT, "portbench")


def sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(HERE, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    """Top-level names of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax_or_the_old_bench():
    for path in sources():
        bad = imported(path) & (FORBIDDEN | OLD_BENCH)
        assert not bad, (path, bad)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("plainref"):
        assert "vtkcloudpoint_tpu_torch" not in imported(path), path


def test_every_public_function_of_the_reference_is_reached_from_chains():
    """The frozen copy keeps only what the jobs use: every public function
    and class of plainref is named, directly or through another that is,
    from chains.py (names compared, a coarse but safe call graph)."""
    defs, roots = {}, set()
    for path in sources("plainref"):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
                defs.setdefault(node.name, []).append((path, node))
                if path.endswith(os.path.join("plainref", "chains.py")):
                    roots.add(node.name)
            elif not isinstance(node, (ast.Import, ast.ImportFrom)):
                roots |= names(node)

    reached, todo = set(), set(roots)
    while todo:
        name = todo.pop()
        if name in reached:
            continue
        reached.add(name)
        for _, node in defs.get(name, []):
            todo |= names(node) - reached
    unreached = sorted(f"{os.path.relpath(p, HERE)}: {n}"
                       for n, found in defs.items() if n not in reached
                       and not n.startswith("_") for p, _ in found)
    assert not unreached, unreached


def names(node):
    """Every name and attribute named inside ``node``."""
    out = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


DRY = """
import sys, time
sys.path.insert(0, {root!r})
sys.path.insert(0, {tests!r})
from conftest import TINY, TINY_TRAFFIC
from portbench.lib import harness
bench = harness.bench_file({root!r})
for name in ("scan500k.stream", "slam100.loop", "scan500k.session"):
    cell, cfg, traffic, limits = harness.cell_spec(bench, name)
    cfg = dict(cfg, **TINY[cfg["name"]])
    traffic = dict(traffic, **TINY_TRAFFIC[traffic["job"]])
    res = harness.run_spec(bench, cell, cfg, traffic, limits, 5, 0.05,
                           False, "cpu", time.perf_counter())
    assert res["correct"], res
print(sorted({{m.split(".")[0] for m in sys.modules}} & {forbidden!r}))

# a reader, run after the window and the comparison, that loads a module
# named jax: the run is refused
sys.path.insert(0, {stub!r})
def reader(metric, root=None):
    def read(ctx):
        import jax  # noqa: F401
    return read
harness.reader = reader
try:
    harness.run_spec(bench, cell, cfg, traffic, limits, 5, 0.05, False,
                     "cpu", time.perf_counter())
    print("result given")
except SystemExit as exc:
    print("refused:", exc)
"""


def test_a_dry_run_loads_no_jax(tmp_path):
    (tmp_path / "jax.py").write_text("")
    code = DRY.format(root=ROOT, tests=os.path.dirname(__file__),
                      forbidden=FORBIDDEN, stub=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2] == "[]"
    assert lines[-1].startswith("refused:") and "jax" in lines[-1]


def cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "scan500k.stream",
         "--seed", "3", "--seconds", "1", "--trace", "0", *extra],
        capture_output=True, text=True, timeout=300, cwd=cwd)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_an_unknown_workload_is_refused():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "nope", "--seed",
         "1", "--seconds", "1"], capture_output=True, text=True, timeout=120,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""

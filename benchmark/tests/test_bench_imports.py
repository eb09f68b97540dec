"""What the benchmark runs never loads JAX or the JAX package (top-level
module names compared whole), its references load nothing of the program,
and a run without a card, or without the program beside the benchmark,
prints no result."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

from conftest import BENCH, ROOT
from harness import runner

STDLIB_OK = {"__future__", "typing", "dataclasses", "os", "sys", "json", "time", "re",
             "math", "gc", "glob", "shutil", "tempfile", "threading", "argparse",
             "importlib", "multiprocessing", "collections", "concurrent", "contextlib",
             "functools", "statistics"}


def _imports(path: str) -> set:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _sources():
    return [p for p in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in _sources():
        bad = _imports(path) & set(runner.BANNED)
        assert not bad, f"{path} imports {bad}"


def test_the_references_import_nothing_of_the_program():
    for path in glob.glob(os.path.join(BENCH, "reference", "*.py")):
        assert _imports(path) <= STDLIB_OK | {"numpy", "torch", "PIL"}, path


def test_a_cpu_run_of_every_tiny_cell_loads_no_banned_module(tiny_root):
    script = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{BENCH!r}, {ROOT!r}]
        import torch
        torch.set_num_threads(2)
        from harness import runner, spec
        if __name__ == "__main__":
            for name in ("tiny.extract", "tiny.bulk"):
                cell = spec.load_cell({tiny_root!r}, name)
                res = runner.run_cell(runner.Ctx(cell, 2 ** 31 + 5, 1.0, False, "cpu"),
                                      time.perf_counter())
                assert res["attempted"] > 0, res
            print("banned", runner.banned_modules())
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "banned []"


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                          "r101_ap_gem.extract_jpeg1024", "--seed", str(2 ** 31 + 9),
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "needs 1 CUDA card" in out.stderr


def test_the_benchmark_alone_prints_no_result(tiny_root):
    """A directory that holds only BENCHMARK.json and the benchmark: the
    program is missing, so the run fails before it prints a result."""
    assert sorted(os.listdir(tiny_root)) == ["BENCHMARK.json", "benchmark"]
    script = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{os.path.join(tiny_root, 'benchmark')!r}]
        from harness import runner, spec
        cell = spec.load_cell({tiny_root!r}, "tiny.extract")
        print(runner.run_cell(runner.Ctx(cell, 1, 1.0, False, "cpu"), time.perf_counter()))
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=tiny_root, env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "No module named 'dirjax_torch'" in out.stderr

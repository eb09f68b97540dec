"""Shared set-up of the benchmark's CPU tests: the benchmark's modules on
the path, one torch thread, and a tiny copy of the benchmark (a checkout
root with BENCHMARK.json and ``benchmark/``) whose cells run on the CPU in
seconds."""

import copy
import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for _p in (ROOT, BENCH):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

torch.set_num_threads(1)

# tiny cells: a ResNet-50 backbone at 64x48 / 48x64, a 70k-row index; the
# open loop (no cell of the benchmark has one yet) on the closed loop's cell
TINY = {"tiny.extract": ("extract_jpeg1024", "r101_ap_gem.extract_jpeg1024"),
        "tiny.single": ("search_bulk64_closed", "r101_ap_gem.search_bulk64_closed"),
        "tiny.bulk": ("search_bulk64_closed", "r101_ap_gem.search_bulk64_closed")}
OPEN_LOOP = dict(loop="open", rate_per_s=100.0, rows_per_request=1, late_p99_limit_ms=50.0)


def load(path):
    with open(path) as f:
        return json.load(f)


def make_tiny_root(root: str) -> str:
    """A checkout at ``root`` holding the benchmark and three tiny cells,
    each with its real cell's limits and metrics."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    cfg = load(os.path.join(BENCH, "configs", "r101_ap_gem.json"))
    cfg["model"].update(arch="resnet50_rmac", layers=[3, 4, 6, 3])
    cfg["index"].update(landmark_rows=300, distractor_rows=69000)
    cfg["server"]["max_batch"] = 64
    with open(os.path.join(root, "benchmark", "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    spec["configs"].append({"name": "tiny", "source": "https://example.org",
                            "file": "benchmark/configs/tiny.json", "reduced": [], "why": "tests"})
    for name, (mix_name, real) in TINY.items():
        mix = load(os.path.join(BENCH, "traffic", mix_name + ".json"))
        if mix["generator"] == "extract":
            mix.update(files=16, sizes=[[64, 48], [48, 64]], chunk_images=32,
                       sample_images=8, warm_batches=1)
        else:
            mix.update(query_pool=256, sample_requests=16, warm_requests=1, processes=1,
                       rows_per_request=min(16, mix["rows_per_request"]))
            if name == "tiny.single":
                mix.update(OPEN_LOOP)
                spec["end_to_end"].append({"name": "search_p95_ms", "unit": "ms",
                                           "better": "lower", "bound": 0.25,
                                           "source": "host_clock", "workloads": [name]})
        traffic = "tiny_" + ("open_loop" if name == "tiny.single" else mix_name)
        with open(os.path.join(root, "benchmark", "traffic", traffic + ".json"), "w") as f:
            json.dump(mix, f)
        spec["workloads"].append({"name": name, "config": "tiny", "traffic": traffic,
                                  "chips": 1, "why": "tests"})
        reported = spec["per_layer"] + ([] if name == "tiny.single" else spec["end_to_end"])
        for m in reported:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
        limits = os.path.join(BENCH, "limits", real + ".json")
        if os.path.exists(limits):
            shutil.copy(limits, os.path.join(root, "benchmark", "limits", name + ".json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(str(tmp_path_factory.mktemp("bench_root")))


@pytest.fixture
def spec():
    return copy.deepcopy(load(os.path.join(ROOT, "BENCHMARK.json")))

"""The harness: cells found by their files, BENCHMARK.json within the
contract, and the roofline, MFU and busy-union arithmetic on hand-worked
shapes and intervals."""

import json
import os
import re
import shutil

import pytest

from conftest import BENCH, ROOT, load
from harness import peaks, readings, runner, shapes, spec as hspec, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_of_the_repo_loads(spec):
    for w in spec["workloads"]:
        cell = hspec.load_cell(ROOT, w["name"])
        assert hspec.generator(cell).setup and cell.config["name"] == w["config"]
        assert set(cell.limits) >= {"desc_dist"} or set(cell.limits) >= {"rank_gap",
                                                                          "score_gap"}
        for m in cell.per_layer:
            assert callable(hspec.metric_reader(ROOT, m["name"]))


def test_benchmark_json_meets_the_contract(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1].startswith("benchmark/")
    assert 1 <= spec["run_seconds"] <= 51
    cells = 24   # the most any later PR may bring, at this run length
    assert (2 + 14 * cells) * (spec["run_seconds"] + 60) + cells * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["reduced"] == load(os.path.join(ROOT, c["file"]))["reduced"]
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    names = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in configs and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        reported = [m["name"] for m in spec["end_to_end"] if w["name"] in m.get("workloads",
                                                                                 [w["name"]])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(w["name"] in m["workloads"] for m in spec["per_layer"])
        names.add(w["name"])
    layers = {}
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        assert m["moves"] in e2e and set(m["workloads"]) <= names
        for w in m["workloads"]:   # each listed cell reports the metric it moves
            assert w in e2e[m["moves"]].get("workloads", [w])
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        layers.setdefault(m["layer"], m["layer"])
    assert len(json.dumps(spec)) <= 64 * 1024


def test_new_config_mix_metric_and_cell_are_found_from_files_alone(tiny_root, tmp_path):
    root = str(tmp_path / "checkout")
    shutil.copytree(tiny_root, root)
    cfg = load(os.path.join(root, "benchmark", "configs", "tiny.json"))
    cfg["name"] = "newcfg"
    with open(os.path.join(root, "benchmark", "configs", "newcfg.json"), "w") as f:
        json.dump(cfg, f)
    mix = load(os.path.join(root, "benchmark", "traffic", "tiny_extract_jpeg1024.json"))
    mix["chunk_images"] = 64
    with open(os.path.join(root, "benchmark", "traffic", "newmix.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(root, "benchmark", "metrics", "new.metric.py"), "w") as f:
        f.write("def read(reading):\n    return 42.0 if reading.trace is None else None\n")
    spec = load(os.path.join(root, "BENCHMARK.json"))
    spec["configs"].append({"name": "newcfg", "source": "https://example.org",
                            "file": "benchmark/configs/newcfg.json", "reduced": [],
                            "why": "test"})
    spec["workloads"].append({"name": "newcfg.newmix", "config": "newcfg",
                              "traffic": "newmix", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "new.metric", "unit": "%", "better": "higher",
                              "source": "device_trace", "layer": "device",
                              "moves": "extract_img_per_s", "workloads": ["newcfg.newmix"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    cell = hspec.load_cell(root, "newcfg.newmix")
    assert cell.config["name"] == "newcfg" and cell.mix["chunk_images"] == 64
    assert hspec.generator(cell).__name__ == "bench_generator_extract"
    assert [m["name"] for m in cell.per_layer] == ["new.metric"]
    read = hspec.metric_reader(root, "new.metric")
    assert read(runner.Reading(cell, None, {})) == 42.0
    with pytest.raises(KeyError):
        hspec.load_cell(root, "newcfg.absent")


def test_peaks_and_roofline_arithmetic():
    assert peaks.bound_s(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 989e12) == pytest.approx(1.0)
    assert peaks.bound_s(1e9, 1e12) == pytest.approx(1e12 / 989e12)       # operations bound
    assert peaks.bound_s(1e10, 1e12) == pytest.approx(1e10 / 3.35e12)     # bytes bound
    assert peaks.bound_s(0.0, 67e12, "fp32") == pytest.approx(1.0)
    assert peaks.roofline_pct(1.0, 2.0) == pytest.approx(50.0)
    assert peaks.roofline_pct(1.0, 0.0) is None
    assert peaks.mfu_pct(989e12, 2.0) == pytest.approx(50.0)
    assert peaks.mfu_pct(0.0, 2.0) is None


def test_conv_counts_on_a_hand_worked_shape():
    # 1 image, 4 -> 8 channels in 2 groups, 3x3, stride 1, pad 1, 5x6, fp32 out
    c = shapes.Conv(1, 4, 8, 3, 1, 1, 2, 5, 6, shapes.BF16, shapes.FP32)
    assert (c.ho, c.wo) == (5, 6)
    assert c.ops == 2 * 5 * 6 * 8 * 9 * 2
    assert c.nbytes == 5 * 6 * 4 * 2 + 8 * 9 * 2 * 2 + 2 * 4 * 8 + 5 * 6 * 8 * 4
    s = shapes.Conv(1, 3, 64, 7, 2, 3, 1, 768, 1024, shapes.FP32, shapes.BF16)
    assert (s.ho, s.wo) == (384, 512)


def test_backbone_counts_match_the_recorded_forwards():
    r101 = load(os.path.join(BENCH, "configs", "r101_ap_gem.json"))["model"]
    rx = load(os.path.join(BENCH, "configs", "resnext101_32x4d_gem.json"))["model"]
    convs = shapes.backbone_convs(r101, 8, 768, 1024)
    # stem + 33 bottlenecks x 3 + 4 downsamples, as chip_smoke.py records them
    assert len(convs) == 104 == len(shapes.backbone_convs(rx, 1, 64, 64))
    # PERF.md: 1.956 TFLOP a batch of 8 at 1024x768; per-conv bounds 3.928 ms
    assert sum(c.ops for c in convs) == pytest.approx(1.956e12, rel=2e-3)
    assert sum(c.bound_s for c in convs) == pytest.approx(3.928e-3, rel=5e-3)
    assert shapes.forward_flops(r101, 1, 768, 1024) == pytest.approx(244.5e9, rel=2e-3)
    # both orientations cost the same
    assert sum(c.bound_s for c in shapes.backbone_convs(r101, 8, 1024, 768)) == pytest.approx(
        sum(c.bound_s for c in convs))
    grouped = [c for c in shapes.backbone_convs(rx, 8, 768, 1024) if c.groups > 1]
    assert len(grouped) == 33 and grouped[0].cin == 128 and grouped[0].cin // 32 == 4
    assert shapes.feature_map(r101, 768, 1024) == (24, 32)


def test_head_and_search_bounds():
    r101 = load(os.path.join(BENCH, "configs", "r101_ap_gem.json"))["model"]
    pool, project = shapes.gem_head_launches(r101, 8, 768, 1024)
    assert pool == pytest.approx((8 * 24 * 32 * 2048 * 2 + 8 * 2048 * 4) / 3.35e12)
    assert project == pytest.approx((8 * 2048 * 4 * 2 + 2048 * 2048 * 4 + 2048 * 4) / 3.35e12)
    n = 4993 + 1001001
    assert shapes.finemax_bound_s(n, 2048, 256) == pytest.approx(
        (n * 2048 * 2 + 256 * 2048 * 2) / 3.35e12)
    assert shapes.finemax_bound_s(n, 2048, 256) * 1e3 == pytest.approx(1.2303, rel=1e-4)
    assert shapes.search_flops(n, 2048, 3) == 2 * 3 * n * 2048


def test_busy_union_and_idle_gaps():
    spans = [(0, 2), (1, 3), (5, 6)]
    assert trace.busy_union(spans) == 4
    assert trace.idle_gaps(spans, 0, 8) == [(3, 5), (6, 8)]
    assert trace.idle_gaps([(-1, 9)], 0, 8) == []
    assert trace.short_name("void (anonymous namespace)::wg::conv_wgmma_kernel<1>(Args)") == \
        "(anonymous namespace)::wg::conv_wgmma_kernel"


def _events():
    """A hand-made chrome trace: the anchor at 100 us; with the host's slice
    1000 us long, the slice is 100..1100 us."""
    return [
        {"ph": "X", "cat": "kernel", "name": "void at::cuda::(anonymous namespace)::spin_kernel"
         "(long)", "ts": 100, "dur": 1},
        {"ph": "X", "cat": "kernel", "name": "void conv_kernel<1>()", "ts": 50, "dur": 70},
        {"ph": "X", "cat": "kernel", "name": "void wg::conv_wgmma_kernel<2>()", "ts": 150,
         "dur": 200},
        {"ph": "X", "cat": "kernel", "name": "void gem_pool_kernel<float>()", "ts": 300,
         "dur": 100},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pageable -> Device)", "ts": 600,
         "dur": 100, "args": {"bytes": 4096}},
        {"ph": "X", "cat": "kernel", "name": "void late_kernel()", "ts": 1050, "dur": 100},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 500, "dur": 5},
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 0},
    ]


HOST = [(0.0004, 0.00055, "in a call"), (0.0003, 0.0006, "in an outer call")]


def test_reduce_trace_clips_to_the_slice_and_names_gaps():
    t = trace.reduce_trace(_events(), 0.0, 0.001, HOST, "between calls")
    assert t.window_s == pytest.approx(1000e-6)
    # [100, 120] (clipped), [150, 400], [600, 700], [1050, 1100] (clipped)
    assert t.busy_s == pytest.approx(420e-6)
    gaps = dict(t.idle_gaps)
    # the gap 400..600 has its middle (500) in both host spans: the inner names it
    assert gaps == {"in a call": pytest.approx(200e-6),
                    "between calls": pytest.approx((30 + 350) * 1e-6)}
    assert len(t.kernels(readings.CONV)) == 2 and not t.kernels("spin_kernel")
    assert t.seconds(t.memcpys("HtoD")) == pytest.approx(100e-6)
    assert t.device_ops()[0] == ("wg::conv_wgmma_kernel", pytest.approx(200e-6))


def test_without_an_anchor_the_slice_is_the_events_extent():
    events = [e for e in _events() if "spin_kernel" not in e["name"]]
    t = trace.reduce_trace(events, 5.0, 6.0)
    assert t.window_s == pytest.approx((1150 - 50) * 1e-6)


def test_readers_on_a_hand_made_slice():
    cell = hspec.load_cell(ROOT, "r101_ap_gem.extract_jpeg1024")
    t = trace.reduce_trace(_events(), 0.0, 0.001)
    r = runner.Reading(cell, t, {"extractor": [(0.0002, 0.0003, 8), (0.002, 0.003, 8)]})
    assert readings.idle_share(r) == pytest.approx(58.0)
    assert readings.h2d_ms_per_img(r) == pytest.approx(0.1 / 8)
    per_launch = sum(c.bound_s for c in shapes.backbone_convs(cell.config["model"], 8, 768,
                                                              1024)) / 104
    assert readings.conv_roofline(r) == pytest.approx(100 * 2 * per_launch / 220e-6)
    pool, _ = shapes.gem_head_launches(cell.config["model"], 8, 768, 1024)
    assert readings.gem_head_roofline(r) == pytest.approx(100 * pool / 100e-6)
    assert readings.extract_mfu(r) == pytest.approx(
        100 * 8 * 244.5e9 / 1000e-6 / 989e12, rel=2e-3)
    assert readings.rows_per_batch(r) is None
    empty = runner.Reading(cell, None, {})
    assert readings.conv_roofline(empty) is None and readings.idle_share(empty) is None


def test_device_time_readers_on_a_hand_made_slice():
    """The ResNeXt cell's readers: the rate over the window's span, the
    forward's operations over the slice's busy union, and the same roofline
    and upload readings as the rate's cell."""
    cell = hspec.load_cell(ROOT, "resnext101_32x4d_gem.extract_jpeg1024")
    assert [m["name"] for m in cell.end_to_end] == ["extract_device_ms_per_img", "setup_s"]
    t = trace.reduce_trace(_events(), 0.0, 0.001)
    r = runner.Reading(cell, t, {"extractor": [(0.0002, 0.0003, 8), (0.002, 0.003, 8)],
                                 "window": [(0.0, 2.0, 300)]})
    assert hspec.metric_reader(ROOT, "extract.img_per_s")(r) == pytest.approx(150.0)
    flops = sum(shapes.forward_flops(cell.config["model"], 1, h, w)
                for h, w in ((768, 1024), (1024, 768))) / 2
    assert hspec.metric_reader(ROOT, "extract.device.mfu")(r) == pytest.approx(
        100 * 8 * flops / 420e-6 / 989e12)
    for name in ("h2d_ms_per_img", "conv_roofline", "gem_head_roofline"):
        assert hspec.metric_reader(ROOT, "extract.device." + name)(r) == pytest.approx(
            hspec.metric_reader(ROOT, "extract." + name)(r))
    empty = runner.Reading(cell, None, {})
    assert readings.extract_img_per_s(empty) is None
    assert readings.extract_device_mfu(empty) is None


def test_search_readers_on_a_hand_made_slice():
    cell = hspec.load_cell(ROOT, "r101_ap_gem.search_bulk64_closed")
    events = _events() + [{"ph": "X", "cat": "kernel", "ts": 800, "dur": 250,
                           "name": "void tc_kernel<1, 64, FinemaxWork<64> >(FinemaxWork<64>)"}]
    t = trace.reduce_trace(events, 0.0, 0.001)
    r = runner.Reading(cell, t, {"search": [(0.0001, 0.0041, 128), (0.0002, 0.0022, 64),
                                            (20.0, 20.1, 1)]})
    # batches and host ms are read outside the traced slice, where the
    # profiler does not slow the host
    assert readings.rows_per_batch(r) == pytest.approx(1)
    assert readings.index_ms(r) == pytest.approx(100.0)
    n = 4993 + 1001001
    bound = (shapes.finemax_bound_s(n, 2048, 128) + shapes.finemax_bound_s(n, 2048, 64)) / 2
    assert readings.finemax_roofline(r) == pytest.approx(100 * bound / 250e-6)
    assert readings.search_mfu(r) == pytest.approx(100 * 2 * 192 * n * 2048 / 1e-3 / 989e12)


def test_banned_modules_compare_top_level_names_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "dirjax_torchlike", types.ModuleType("dirjax_torchlike"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("jaxtyping"))
    assert runner.banned_modules() == [m for m in runner.banned_modules()
                                       if m.split(".")[0] in runner.BANNED]
    assert "dirjax_torchlike" not in runner.banned_modules()
    assert "jaxtyping" not in runner.banned_modules()
    monkeypatch.setitem(sys.modules, "dirjax.ops", types.ModuleType("dirjax.ops"))
    assert "dirjax.ops" in runner.banned_modules()



def test_host_probe_note_reads_both_sides_of_the_window():
    from harness import hostload

    before = hostload.probe()
    assert before > 0
    note = hostload.note(before)
    assert note.startswith(f"host: probe ms before the window {before!r}, after ")

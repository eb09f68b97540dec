"""The decoded-batch extraction cells: ``generators/extract_decoded.py``, the
ViT's weights (``harness/vit_weights.py``), counts (``harness/vit_shapes.py``),
readers (``harness/vit_readings.py``) and plain reference
(``reference/vit_gem.py``, held to ``tests/plain_vit_gem.py``).

Two tiny cells, added from files alone to a copy of the benchmark, run on the
CPU in seconds: a ResNet-50 on 128 x 96 pixel batches and a ViT at DINOv2's
ViT-S/14 widths with 4 registers (registered by name in this module only)
on 280 x 210 ones, 300 patches, enough for GeM to average bf16's
rounding as it does at 4,015 patches on the card. The program passes its
real cell's limit there; the control and each planted fault do not. A CPU
run reports no device time, so the tiny cells report the rate."""

import json
import math
import os
import shutil
import sys
import time
from functools import partial

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, load
from harness import controls, runner, spec as hspec, trace, vit_readings, vit_shapes, vit_weights
from reference import vit_gem

REAL = {"r101_ap_gem.extract_decoded": "r101_ap_gem",
        "dinov2_vitl14_reg_gem.extract_decoded_p14": "dinov2_vitl14_reg_gem"}
TINY = {"tiny.r50_decoded": ("r101_ap_gem.extract_decoded", [[128, 96], [96, 128]]),
        "tiny.vit_decoded": ("dinov2_vitl14_reg_gem.extract_decoded_p14",
                             [[280, 210], [210, 280]])}
VITS = {"arch": "bench_vits14_reg_rmac", "embed_dim": 384, "depth": 12, "num_heads": 6,
        "mlp_dim": 1536, "fc_in": 384, "out_dim": 384}
SEED = 2 ** 31 + 13
DEVICE_MS = "extract_device_ms_per_img"


@pytest.fixture(scope="module", autouse=True)
def small_vit():
    """VITS's ViT under the GeM head, registered by its ``arch`` for this
    module's tests, since the generator builds the model by that name."""
    from dirjax_torch.models import ViTConfig, registry

    bb = ViTConfig("vits14_reg", embed_dim=VITS["embed_dim"], depth=VITS["depth"],
                   num_heads=VITS["num_heads"], mlp_dim=VITS["mlp_dim"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry._FACTORIES, VITS["arch"], partial(registry._vit_config, bb))
        yield


def _vit_model(**change) -> dict:
    model = load(os.path.join(BENCH, "configs", "dinov2_vitl14_reg_gem.json"))["model"]
    model.update(change)
    return model


@pytest.fixture(scope="module")
def decoded_root(tmp_path_factory):
    """A checkout holding the benchmark and the two tiny cells, each with its
    real cell's limits and metrics."""
    root = str(tmp_path_factory.mktemp("decoded_root"))
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    spec = load(os.path.join(ROOT, "BENCHMARK.json"))
    for name, (real, sizes) in TINY.items():
        cell = next(w for w in spec["workloads"] if w["name"] == real)
        cfg = load(os.path.join(ROOT, next(c["file"] for c in spec["configs"]
                                           if c["name"] == cell["config"])))
        if cfg["model"]["block"] == "vit":
            cfg["model"].update(VITS)
        else:
            cfg["model"].update(arch="resnet50_rmac", layers=[3, 4, 6, 3])
        cfg["inference"]["batch_size"] = 2
        cfg_name = name.replace(".", "_")
        with open(os.path.join(root, "benchmark", "configs", cfg_name + ".json"), "w") as f:
            json.dump(cfg, f)
        spec["configs"].append({"name": cfg_name, "source": "https://example.org",
                                "file": f"benchmark/configs/{cfg_name}.json", "reduced": [],
                                "why": "tests"})
        mix = load(os.path.join(BENCH, "traffic", cell["traffic"] + ".json"))
        mix.update(sizes=sizes, pool_batches=4, sample_images=6, warm_batches=1)
        with open(os.path.join(root, "benchmark", "traffic", cfg_name + ".json"), "w") as f:
            json.dump(mix, f)
        spec["workloads"].append({"name": name, "config": cfg_name, "traffic": cfg_name,
                                  "chips": 1, "why": "tests"})
        for m in spec["per_layer"] + spec["end_to_end"]:
            if real in m.get("workloads", []):
                m["workloads"].append(name)
        rate = next(m for m in spec["end_to_end"] if m["name"] == "extract_img_per_s")
        if name not in rate["workloads"]:
            rate["workloads"].append(name)
            device = next(m for m in spec["end_to_end"] if m["name"] == DEVICE_MS)
            device["workloads"].remove(name)
        shutil.copy(os.path.join(BENCH, "limits", real + ".json"),
                    os.path.join(root, "benchmark", "limits", name + ".json"))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def _run(root: str, name: str, hook=None, seed: int = SEED) -> dict:
    cell = hspec.load_cell(root, name)
    ctx = runner.Ctx(cell, seed, 1.0, False, "cpu", program_hook=hook)
    return runner.run_cell(ctx, time.perf_counter())


def test_the_new_cells_are_found_from_files_alone():
    for name, config in REAL.items():
        cell = hspec.load_cell(ROOT, name)
        assert cell.config["name"] == config and cell.chips == 1
        assert hspec.generator(cell).__name__ == "bench_generator_extract_decoded"
        assert set(cell.limits) == {"desc_dist"}
        for m in cell.per_layer:
            assert callable(hspec.metric_reader(ROOT, m["name"]))
    r101 = hspec.load_cell(ROOT, "r101_ap_gem.extract_decoded")
    assert [m["name"] for m in r101.end_to_end] == ["extract_img_per_s", "setup_s"]
    assert {m["name"] for m in r101.per_layer} == {
        "extract.idle_share", "extract.h2d_ms_per_img", "extract.conv_roofline",
        "extract.gem_head_roofline", "extract.mfu", "extract.decoded.host.forward_ms_per_batch"}
    vit = hspec.load_cell(ROOT, "dinov2_vitl14_reg_gem.extract_decoded_p14")
    assert [m["name"] for m in vit.end_to_end] == ["extract_device_ms_per_img", "setup_s"]
    assert {m["name"] for m in vit.per_layer} == {
        "extract.img_per_s", "extract.device.h2d_ms_per_img", "extract.vit.attention_roofline",
        "extract.vit.linear_roofline", "extract.vit.pointwise_roofline",
        "extract.vit.gem_head_roofline", "extract.vit.mfu", "extract.vit.host.blocks_ms_per_batch"}
    assert vit.config["reduced"] == [] and vit.mix["sizes"] == [[1022, 770], [770, 1022]]


@pytest.mark.parametrize("name", TINY)
def test_the_program_is_correct_and_leaves_its_spans(decoded_root, name):
    res = _run(decoded_root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("name", TINY)
def test_the_control_and_planted_faults_are_not_correct(decoded_root, name):
    for hook in (controls.control, controls.fault("half_batch"), controls.fault("altered")):
        res = _run(decoded_root, name, hook)
        assert not res["correct"], res["checks"]


def test_the_pool_comes_from_the_seed_and_the_window_spans_its_calls(decoded_root):
    sys.modules.pop("bench_generator_extract_decoded", None)
    cell = hspec.load_cell(decoded_root, "tiny.vit_decoded")
    gen = hspec.generator(cell)
    ctx = runner.Ctx(cell, SEED, 0.5, False, "cpu")
    a, b = gen._pool(ctx), gen._pool(ctx)
    assert len(a) == 4 and [p.shape for p in a] == [(2, 210, 280, 3), (2, 280, 210, 3)] * 2
    assert all(np.array_equal(x, y) for x, y in zip(a, b)) and a[0].dtype == np.uint8
    other = gen._pool(runner.Ctx(cell, SEED + 1, 0.5, False, "cpu"))
    assert not np.array_equal(a[0], other[0])
    st = gen.setup(ctx)
    win = gen.window(ctx, st)
    calls = win.spans["extractor"]
    assert calls and all(n == 2 for _, _, n in calls)
    (start, end, done), = win.spans["window"]
    assert done == win.attempted == 2 * len(calls) and start <= calls[0][0] <= end
    assert win.values["extract_img_per_s"] == pytest.approx(done / (end - start))
    assert [slot for slot, _ in st.returned] == [i % 4 for i in range(len(calls))]
    checks = gen.check(ctx, st, win)
    assert [c.name for c in checks] == ["desc_dist"] and checks[0].ok


def test_vit_weights_have_dinov2_keys_and_their_ranges():
    from dirjax_torch.models import create_model

    model = _vit_model(**VITS)
    sd = vit_weights.state_dict(model, 5, "cpu")
    port = create_model(VITS["arch"])
    assert set(sd) == set(port.state_dict())
    for k, v in port.state_dict().items():
        assert sd[k].shape == v.shape, k
    gammas = torch.cat([v for k, v in sd.items() if k.endswith("gamma")])
    assert 0.1 <= gammas.min() and gammas.max() <= 0.5
    gains = torch.cat([v for k, v in sd.items() if "norm" in k and k.endswith("weight")])
    assert 0.8 <= gains.min() and gains.max() <= 1.2
    qkv = sd["blocks.3.attn.qkv.weight"]
    assert qkv.std().item() == pytest.approx(2.0 / 384 ** 0.5, rel=0.02)
    assert sd["blocks.3.mlp.fc2.weight"].std().item() == pytest.approx(1536 ** -0.5, rel=0.02)
    assert sd["pos_embed"].std().item() == pytest.approx(0.5, rel=0.05)
    assert torch.equal(sd["mask_token"], torch.zeros(1, 384)) and sd["adpool.p"].item() == 3.0
    assert torch.equal(vit_weights.state_dict(model, 5, "cpu")["blocks.0.ls1.gamma"],
                       sd["blocks.0.ls1.gamma"])
    large = _vit_model()
    # ViT-L/14's backbone less its mask token, which is drawn apart
    assert sum(math.prod(s) for _, s, _ in vit_weights.layout(large)) == 304_372_736 - 1024


def test_vit_reference_is_the_tests_plain_forward():
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    try:
        import plain_vit_gem
    finally:
        sys.path.remove(os.path.join(ROOT, "tests"))
    model = _vit_model(**{**VITS, "depth": 2})
    sd = vit_weights.state_dict(model, 9, "cpu")
    pre = load(os.path.join(BENCH, "configs", "dinov2_vitl14_reg_gem.json"))["preprocess"]
    px = torch.randint(0, 256, (3, 45, 74, 3), generator=torch.Generator().manual_seed(2),
                       dtype=torch.uint8)
    got = vit_gem.Forward(model, pre, sd)(px)
    x = px.permute(0, 3, 1, 2).float() / 255.0
    x = (x - torch.tensor(pre["mean"])[:, None, None]) / torch.tensor(pre["std"])[:, None, None]
    want = plain_vit_gem.forward(sd, model, x)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    fp8 = vit_gem.Forward(model, pre, sd, "fp8")(px)
    assert (fp8 - want).norm(dim=1).max() > 0.02


def test_vit_counts_by_hand():
    model = _vit_model()
    assert vit_shapes.grid(model, 770, 1022) == (55, 73)
    assert vit_shapes.tokens(model, 770, 1022) == 4020
    n, d = 4020, 1024
    gemms = vit_shapes.gemms(model, 1, 770, 1022)
    assert len(gemms) == 97 and gemms[0].rows == 4015 and gemms[0].k == 588
    linear = sum(g.ops for g in gemms[1:])
    assert linear == 24 * 24 * n * d * d                      # 2.428 TFLOP
    assert vit_shapes.attention_ops(model, 1, 770, 1022) * 24 == 24 * 4 * n * n * d
    total = vit_shapes.forward_flops(model, 1, 770, 1022)
    assert total == pytest.approx(4.022e12, rel=5e-4)
    assert total == vit_shapes.forward_flops(model, 1, 1022, 770)
    # a batch of 8's attention launch is operations-bound: 4 N^2 D B / 989e12
    assert vit_shapes.attention_bound_s(model, 8, 770, 1022) == pytest.approx(
        4 * n * n * d * 8 / 989e12)
    pw = vit_shapes.pointwise_bounds(model, 8, 770, 1022)
    assert pw["layer_norm"] == pytest.approx(8 * n * d * 8 / 3.35e12)
    assert pw["gelu"] == pytest.approx(8 * n * 4096 * 4 / 3.35e12)
    assert pw["residual"] == pytest.approx(8 * n * d * 10 / 3.35e12)
    pool, project = vit_shapes.gem_head_launches(model, 8, 770, 1022)
    assert pool == pytest.approx((8 * 55 * 73 * 1024 * 4 + 8 * 1024 * 4) / 3.35e12)


def _events():
    """A hand-made slice of 1,000 us from the anchor at 100 us, one kernel of
    each kind the readers look for."""
    names = [("void cudnn_generated_fort_native_sdpa_sm90_knob_7_64x128x64_4x1x1_kernel0_0()",
              200, 400),
             ("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN", 400, 500),
             ("void cutlass::Kernel2<cutlass_80_tensorop_bf16_s16816gemm_bf16_256x128_64x3_tn_"
              "align2>(Params)", 500, 520),
             ("void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, "
              "float, false>()", 520, 540),
             ("void at::native::vectorized_elementwise_kernel<8, at::native::GeluCUDAKernelImpl"
              "(at::TensorIteratorBase&)>()", 540, 560),
             ("void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::"
              "native::addcmul_cuda_kernel()>()", 560, 600),
             ("void (anonymous namespace)::gem_pool_kernel<float, 4>()", 600, 610),
             ("void (anonymous namespace)::project_kernel<true>()", 610, 612)]
    ev = [{"ph": "X", "cat": "kernel", "name": "void at::cuda::(anonymous namespace)::"
           "spin_kernel(long)", "ts": 100, "dur": 1}]
    return ev + [{"ph": "X", "cat": "kernel", "name": n, "ts": a, "dur": b - a}
                 for n, a, b in names]


def test_vit_readers_on_a_hand_made_slice():
    cell = hspec.load_cell(ROOT, "dinov2_vitl14_reg_gem.extract_decoded_p14")
    model = cell.config["model"]
    t = trace.reduce_trace(_events(), 0.0, 0.001)
    r = runner.Reading(cell, t, {"extractor": [(0.0002, 0.0003, 8)]})
    att = vit_shapes.attention_bound_s(model, 8, 770, 1022)
    assert vit_readings.attention_roofline(r) == pytest.approx(100 * att / 200e-6)
    gemm = sum(g.bound_s for g in vit_shapes.gemms(model, 8, 770, 1022)) / 97
    assert vit_readings.linear_roofline(r) == pytest.approx(100 * 2 * gemm / 120e-6)
    pw = vit_shapes.pointwise_bounds(model, 8, 770, 1022)
    assert vit_readings.pointwise_roofline(r) == pytest.approx(
        100 * (pw["layer_norm"] + pw["gelu"] + pw["residual"]) / 80e-6)
    pool, project = vit_shapes.gem_head_launches(model, 8, 770, 1022)
    assert vit_readings.gem_head_roofline(r) == pytest.approx(100 * (pool + project) / 12e-6)
    assert vit_readings.device_mfu(r) == pytest.approx(
        100 * 8 * vit_shapes.forward_flops(model, 1, 770, 1022) / t.busy_s / 989e12)
    empty = runner.Reading(cell, None, {})
    for m in cell.per_layer:
        assert hspec.metric_reader(ROOT, m["name"])(empty) is None, m["name"]


def test_decoded_forward_reader_takes_the_forward_spans_of_the_slice():
    """``extract.decoded.host.forward_ms_per_batch``: the mean of the
    program's ``extract.forward`` spans begun in the traced slice, None with
    no trace or no span there."""
    from dirjax_torch.utils import timer

    cell = hspec.load_cell(ROOT, "r101_ap_gem.extract_decoded")
    read = hspec.metric_reader(ROOT, "extract.decoded.host.forward_ms_per_batch")
    t = trace.Trace(window_s=5.0, busy_s=1.0, events=[], host_start=100.0, host_stop=105.0)
    timer.clear()
    try:
        assert read(runner.Reading(cell, t, {})) is None
        for start, length in ((100.5, 0.004), (101.0, 0.002), (99.0, 1.0), (105.0, 1.0)):
            timer.record("extract.forward", start, start + length, 8)
        assert read(runner.Reading(cell, t, {})) == pytest.approx(3.0)
        assert read(runner.Reading(cell, None, {})) is None
    finally:
        timer.clear()

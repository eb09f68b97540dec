"""The plain references against the port's CPU fp32 paths at a small size.
The test imports both; the reference modules import nothing of the port."""

import os

import numpy as np
import pytest
import torch

from conftest import BENCH, load
from harness import images, rows, weights
from reference import resnet_gem, topk


def _model(name: str, arch: str, layers) -> dict:
    model = load(os.path.join(BENCH, "configs", name + ".json"))["model"]
    model.update(arch=arch, layers=layers)
    return model


def _port(model: dict, sd: dict):
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model

    net = create_model(model["arch"])
    net.load_state_dict(sd)
    return FeatureExtractor(net, "cpu", dtype=torch.float32)


@pytest.mark.parametrize("name,arch,layers", [
    ("r101_ap_gem", "resnet50_rmac", [3, 4, 6, 3]),
    ("r101_ap_gem", "resnet101_rmac", [3, 4, 23, 3]),
    ("resnext101_32x4d_gem", "resnext101_32x4d_rmac", [3, 4, 23, 3]),
])
def test_reference_forward_is_the_ports_fp32_forward(name, arch, layers, tmp_path):
    model = _model(name, arch, layers)
    preprocess = load(os.path.join(BENCH, "configs", name + ".json"))["preprocess"]
    sd = weights.state_dict(model, 2 ** 31 + 7, "cpu")
    mix = {"files": 4, "sizes": [[64, 48], [48, 64]], "jpeg_quality": 90,
           "content": {"octaves": [[32, 50.0], [4, 10.0]], "grain": 3.0}}
    files = images.write_jpegs(mix, 11, str(tmp_path), "cpu")
    paths = [f[0] for f in files]
    want = resnet_gem.descriptors(model, preprocess, sd, paths, "cpu")
    port = _port(model, sd)
    for path, w in zip(paths, want):
        got = port(resnet_gem.decode(path)[None]).numpy()[0]
        np.testing.assert_allclose(got, w, rtol=0, atol=2e-5)
    assert np.allclose(np.linalg.norm(want, axis=1), 1.0, atol=1e-6)


def test_reference_decodes_as_the_ports_loader(tmp_path):
    from dirjax_torch.data.loader import get_loader
    from dirjax_torch.datasets.generic import ImageList

    mix = {"files": 2, "sizes": [[40, 30], [30, 40]], "jpeg_quality": 90,
           "content": {"octaves": [[16, 40.0]], "grain": 2.0}}
    files = images.write_jpegs(mix, 3, str(tmp_path), "cpu")
    loader = get_loader(ImageList(imgs=[f[0] for f in files]), "", output=("img",),
                        totensor=True, device_normalize=True)
    for i, (path, w, h) in enumerate(files):
        px = resnet_gem.decode(path)
        assert px.shape == (h, w, 3)
        np.testing.assert_array_equal(loader[i]["img"], px)


def test_fp8_control_is_farther_than_bf16_rounding():
    model = _model("r101_ap_gem", "resnet50_rmac", [3, 4, 6, 3])
    preprocess = load(os.path.join(BENCH, "configs", "r101_ap_gem.json"))["preprocess"]
    sd = weights.state_dict(model, 5, "cpu")
    x = images.render(torch.Generator().manual_seed(1), 2, 64, 48,
                      {"octaves": [[32, 50.0], [4, 10.0]], "grain": 3.0}, "cpu")
    fp32 = resnet_gem.Forward(model, preprocess, sd)(x)
    fp8 = resnet_gem.Extractor({"model": model, "preprocess": preprocess}, sd, "cpu")(x.numpy())
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model

    net = create_model(model["arch"])
    net.load_state_dict(sd)
    bf16 = FeatureExtractor(net, "cpu", dtype=torch.bfloat16)(x.numpy())
    d_bf16 = (bf16 - fp32).norm(dim=1).max().item()
    d_fp8 = (fp8 - fp32).norm(dim=1).max().item()
    assert d_fp8 > 3 * d_bf16 > 0


def test_exact_topk_is_the_ports_fp32_search():
    from dirjax_torch.serving import RetrievalIndex

    index = {"dim": 64, "landmarks": 3, "landmark_rows": 500, "distractor_rows": rows.BLOCK,
             "landmark_spread": 1.0}
    db = rows.IndexRows(index, 2 ** 31 + 3, "cpu")
    full = db.all()
    assert full.shape == (db.n, 64)
    torch.testing.assert_close(db.rows(rows.BLOCK, db.n), full[rows.BLOCK:])
    q = torch.from_numpy(rows.queries(full, 24, 0.5, 0.5, 9))
    port = RetrievalIndex(full, dtype=torch.float32, device="cpu")
    vals, ids = port.search(q.numpy(), k=10)
    kth, exact = topk.exact(db.rows, db.n, q, torch.from_numpy(ids.astype(np.int64)), 10,
                            rows.BLOCK)
    np.testing.assert_allclose(exact.numpy(), vals, rtol=0, atol=1e-5)
    np.testing.assert_allclose(kth.numpy(), vals[:, -1], rtol=0, atol=1e-5)
    bad = torch.tensor([[db.n, 0]])
    assert torch.isnan(topk.exact(db.rows, db.n, q[:1], bad, 10, rows.BLOCK)[1][0, 0])


def test_int8_control_ranks_near_the_exact_top_k():
    index = {"dim": 64, "landmarks": 3, "landmark_rows": 500, "distractor_rows": 5000,
             "landmark_spread": 1.0}
    db = rows.IndexRows(index, 4, "cpu")
    q = torch.from_numpy(rows.queries(db.all(), 8, 1.0, 0.5, 2))
    ctl = topk.Int8Control(db.rows, db.n, db.dim, "cpu", rows.BLOCK)
    vals, ids = ctl.search(q.numpy(), k=10)
    kth, exact = topk.exact(db.rows, db.n, q, torch.from_numpy(ids.astype(np.int64)), 10,
                            rows.BLOCK)
    gap = np.abs(exact.numpy() - vals).max()
    assert 0 < gap < 0.05      # int8 rounding: close, not exact

"""DINOv2's ViT with registers under the GeM head (``dirjax_torch/models/vit.py``,
``models/rmac.py::ViTDescriptor``) against the plain fp32 forward of
``tests/plain_vit_gem.py``, on the CPU at small widths: the block structure,
heads 64 wide, 4 registers and 14-pixel patches of ViT-L/14, with an
embedding of 128, two heads and three blocks, on two non-square grids and
the table's own.

The weights are drawn so that every block counts: LayerScale gammas of
0.1-0.5 (not DINOv2's 1e-5 initialisation, under which every block would be
invisible and any attention fault would pass), the qkv projection twice the
unit scale so attention rows are peaked. The test asserts both.

The tests marked ``cuda`` need a card and skip without one; the file imports
no jax, so on a machine with the card run it without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_vit.py
"""

import math
import os

import numpy as np
import pytest
import torch

import plain_vit_gem as plain
from dirjax_torch.extraction import FeatureExtractor, extract_image_features
from dirjax_torch.models import (ViTConfig, ViTDescriptor, ViTDescriptorConfig, create_model,
                                 vit)
from dirjax_torch.utils import timer

torch.set_num_threads(1)

TINY = ViTConfig("tiny", embed_dim=128, depth=3, num_heads=2, mlp_dim=512, pos_grid=4)
# (H, W) of the inputs: 5 x 3 and 3 x 7 patches, both with a ragged edge
# to floor, and the table's own 4 x 4 grid
GRIDS = [(74, 45), (44, 101)]
TABLE = (56, 56)
SEED = 2 ** 31 + 21


def widths(cfg: ViTConfig) -> dict:
    return {"patch_size": cfg.patch_size, "num_heads": cfg.num_heads, "ln_eps": cfg.ln_eps,
            "depth": cfg.depth, "num_registers": cfg.num_registers}


def draw(model: torch.nn.Module, seed: int) -> dict:
    return plain.draw({k: v.shape for k, v in model.state_dict().items()}, seed)


@pytest.fixture
def tiny_arch(monkeypatch):
    """TINY under the GeM head, registered by name for one test, for the
    paths that build a model from its name (checkpoints, the CLI)."""
    from functools import partial

    from dirjax_torch.models import registry

    monkeypatch.setitem(registry._FACTORIES, "tiny_vit_rmac",
                        partial(registry._vit_config, TINY))
    return "tiny_vit_rmac"


@pytest.fixture(scope="module")
def tiny():
    model = ViTDescriptor(ViTDescriptorConfig(backbone=TINY, out_dim=128), "tiny").eval()
    sd = draw(model, SEED)
    model.load_state_dict(sd)
    return model, sd


def _images(h: int, w: int, n: int = 2, seed: int = 5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn((n, 3, h, w), generator=g)


def _dist(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.double() - b.double()).norm(dim=1).max().item()


@pytest.mark.parametrize("size", GRIDS + [TABLE])
def test_fp32_forward_is_the_plain_forward(tiny, size):
    """fp32 on the CPU: the same math summed in another order (the patch
    GEMM against the convolution, the fused attention against the whole
    score matrix, LayerScale's fused add), so 2e-5 of a unit descriptor."""
    model, sd = tiny
    x = _images(*size)
    with torch.inference_mode():
        got = model(x, dtype=torch.float32)
    want = plain.forward(sd, widths(TINY), x)
    assert got.shape == (2, 128) and got.dtype == torch.float32
    assert _dist(got, want) < 2e-5


@pytest.mark.parametrize("size", GRIDS)
def test_bf16_forward_is_near_the_plain_forward_and_fp8_is_not(tiny, size):
    """bf16 on the CPU against the fp32 plain forward: bf16 operands of
    every linear layer and of the attention (8 bits of mantissa) through
    three blocks, so 0.03 of a unit descriptor. The plain forward with
    every such operand rounded to fp8 e4m3 (4 bits) must land beyond it."""
    model, sd = tiny
    x = _images(*size)
    with torch.inference_mode():
        got = model(x, dtype=torch.bfloat16)
    want = plain.forward(sd, widths(TINY), x)
    fp8 = plain.forward(sd, widths(TINY), x, operand=plain.fp8)
    d_bf16, d_fp8 = _dist(got, want), _dist(fp8, want)
    assert 0 < d_bf16 < 0.03 < d_fp8, (d_bf16, d_fp8)


def test_every_block_counts_and_attention_rows_are_peaked(tiny):
    _, sd = tiny
    probe = []
    plain.forward(sd, widths(TINY), _images(*GRIDS[1]), probe=probe)
    assert len(probe) == TINY.depth
    for block in probe:
        assert block["added"] >= 0.1 * block["stream"], block
        attn = block["attn"]
        n = attn.shape[-1]
        entropy = -(attn * attn.clamp_min(1e-30).log()).sum(-1)
        # a uniform row has entropy log(n) and a largest weight 1/n
        assert entropy.mean().item() < 0.8 * math.log(n)
        assert attn.amax(-1).mean().item() > 4.0 / n


# DINOv2's state-dict keys (vision_transformer.py, block_chunks=0, as the hub
# builds its models), written out, then the head's
def _dinov2_keys(depth: int) -> set:
    keys = {"cls_token", "pos_embed", "register_tokens", "mask_token",
            "patch_embed.proj.weight", "patch_embed.proj.bias", "norm.weight", "norm.bias"}
    for i in range(depth):
        for sub in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            keys |= {f"blocks.{i}.{sub}.weight", f"blocks.{i}.{sub}.bias"}
        keys |= {f"blocks.{i}.ls1.gamma", f"blocks.{i}.ls2.gamma"}
    return keys


def test_dinov2_state_dict_loads_by_its_keys(tiny):
    model, sd = tiny
    assert set(model.state_dict()) == _dinov2_keys(TINY.depth) | {"adpool.p", "fc.weight",
                                                                  "fc.bias"}
    fresh = ViTDescriptor(ViTDescriptorConfig(backbone=TINY, out_dim=128), "tiny")
    fresh.load_state_dict(sd)        # strict
    assert torch.equal(fresh.blocks[2].ls2.gamma, sd["blocks.2.ls2.gamma"])
    with torch.device("meta"):
        big = create_model("dinov2_vitl14_reg_rmac")
    shapes = {k: tuple(v.shape) for k, v in big.state_dict().items()}
    assert set(shapes) == _dinov2_keys(24) | {"adpool.p", "fc.weight", "fc.bias"}
    assert shapes["pos_embed"] == (1, 1 + 37 * 37, 1024)
    assert shapes["register_tokens"] == (1, 4, 1024)
    assert shapes["patch_embed.proj.weight"] == (1024, 3, 14, 14)
    assert shapes["blocks.23.attn.qkv.weight"] == (3072, 1024)
    assert shapes["blocks.0.mlp.fc1.weight"] == (4096, 1024)
    assert shapes["fc.weight"] == (1024, 1024)
    backbone = sum(math.prod(s) for k, s in shapes.items() if k not in ("adpool.p", "fc.weight",
                                                                        "fc.bias"))
    # 24 blocks of 12,598,272, the patch embedding 603,136, the position
    # table 1,402,880, the class, register and mask tokens and the last norm
    assert backbone == 24 * 12_598_272 + 603_136 + 1_402_880 + 1024 + 4096 + 1024 + 2048


def test_inputs_are_floored_to_whole_patches(tiny):
    model, _ = tiny
    x = _images(70, 42)          # 5 x 3 whole patches
    wider = torch.randn(2, 3, 83, 55)
    wider[:, :, :70, :42] = x
    with torch.inference_mode():
        assert torch.equal(model(x), model(wider))
        assert model.patch_map(wider).shape == (2, 5, 3, 128)
    with pytest.raises(ValueError, match="no whole"):
        model(torch.zeros(1, 3, 13, 200))


def test_position_table_is_resampled_once_a_grid(tiny):
    model, sd = tiny
    fresh = ViTDescriptor(ViTDescriptorConfig(backbone=TINY, out_dim=128), "tiny").eval()
    fresh.load_state_dict(sd)
    before = vit.pos_embed_builds
    with torch.inference_mode():
        for size in GRIDS + GRIDS + [TABLE]:
            fresh(_images(*size, n=1))
    assert vit.pos_embed_builds - before == 3
    with torch.no_grad():
        fresh.pos_embed.mul_(2.0)           # a new table: every grid again
    with torch.inference_mode():
        fresh(_images(*GRIDS[0], n=1))
    assert vit.pos_embed_builds - before == 4


def test_position_cache_keeps_the_grids_used_last(tiny):
    """The cache holds POS_CACHE_GRIDS tables: a grid used since stays, the
    one used longest ago is resampled again."""
    model, sd = tiny
    fresh = ViTDescriptor(ViTDescriptorConfig(backbone=TINY, out_dim=128), "tiny").eval()
    fresh.load_state_dict(sd)
    sizes = [(14 * (2 + i), 28) for i in range(vit.POS_CACHE_GRIDS)]
    before = vit.pos_embed_builds
    with torch.inference_mode():
        for size in sizes + [sizes[0], (14 * 9, 28)]:   # the last evicts sizes[1]
            fresh(_images(*size, n=1))
        assert vit.pos_embed_builds - before == vit.POS_CACHE_GRIDS + 1
        fresh(_images(*sizes[0], n=1))
        assert vit.pos_embed_builds - before == vit.POS_CACHE_GRIDS + 1
        fresh(_images(*sizes[1], n=1))
        assert vit.pos_embed_builds - before == vit.POS_CACHE_GRIDS + 2
    assert len(fresh._pos_cache[1]) == vit.POS_CACHE_GRIDS


def test_spans_and_counters(tiny):
    model, _ = tiny
    timer.clear()
    calls = vit.attention_calls
    timer.enable()
    try:
        with torch.inference_mode():
            model(_images(*GRIDS[0], n=3))
    finally:
        timer.disable()
    assert vit.attention_calls - calls == TINY.depth
    embed, blocks = timer.spans("vit.embed"), timer.spans("vit.blocks")
    assert len(embed) == len(blocks) == 1 and embed[0][4] == blocks[0][4] == 3
    assert embed[0][3] <= blocks[0][2]
    timer.clear()


def test_refuses_masks_training_and_other_heads(tiny):
    model, _ = tiny
    x = _images(*GRIDS[0])
    with pytest.raises(ValueError, match="batching='group'"):
        model(x, mask=torch.ones(2, 74, 45, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="inference only"):
        model(x, train=True)
    with pytest.raises(ValueError, match="GeM -> FC -> L2"):
        create_model("dinov2_vitl14_reg_rmac", pooling="max")


def test_fit_and_the_sharded_paths_refuse_the_vit(tiny, monkeypatch):
    from dirjax_torch import train
    from dirjax_torch.parallel import ShardedExtractor

    model, _ = tiny
    cfg = train.TrainConfig(arch="dinov2_vitl14_reg_rmac")
    with pytest.raises(NotImplementedError, match="dinov2_vitl14_reg_rmac"):
        train.fit([], cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="tiny"):
        train.fit([], train.TrainConfig(), model=model, device="cpu")
    with pytest.raises(NotImplementedError, match="tiny"):
        train.make_sharded_train_step(model, cfg, None, None)
    with pytest.raises(NotImplementedError, match="tiny"):
        ShardedExtractor(model, None)


def test_checkpoint_round_trip_and_no_native_format(tiny_arch, tmp_path):
    from dirjax_torch.utils import checkpoints as ck

    small = create_model(tiny_arch)
    path = str(tmp_path / "vit.pt")
    ck.save_torch_checkpoint(path, ck.Checkpoint(model=small, preprocess=small.cfg.preprocess))
    back = ck.load_checkpoint(path)
    assert back.model.arch == tiny_arch and back.model.cfg == small.cfg
    for k, v in small.state_dict().items():
        assert torch.equal(back.model.state_dict()[k], v)
    with pytest.raises(ValueError, match="save_torch_checkpoint"):
        ck.save_native(str(tmp_path / "vit.npz"), back)


def _jpegs(tmp_path, sizes, seed=3):
    from PIL import Image

    rng = np.random.default_rng(seed)
    paths = []
    for i, (w, h) in enumerate(sizes):
        base = rng.integers(0, 255, (h // 7 + 1, w // 7 + 1, 3), dtype=np.uint8)
        px = np.kron(base, np.ones((7, 7, 1), np.uint8))[:h, :w]
        path = str(tmp_path / f"img{i}.jpg")
        Image.fromarray(px).save(path, quality=95)
        paths.append(path)
    return paths


def _plain_descriptors(sd, cfg: ViTConfig, paths, preprocess) -> torch.Tensor:
    from PIL import Image

    mean = torch.tensor(preprocess["mean"])[:, None, None]
    std = torch.tensor(preprocess["std"])[:, None, None]
    out = []
    for p in paths:
        with Image.open(p) as im:
            px = torch.from_numpy(np.asarray(im.convert("RGB")).copy())
        x = (px.permute(2, 0, 1).float() / 255.0 - mean) / std
        out.append(plain.forward(sd, widths(cfg), x[None])[0])
    return torch.stack(out)


def test_feature_extractor_and_extract_image_features(tiny_arch, tmp_path):
    """The small ViT, built by name, through the port's extraction path on
    JPEGs of two sizes, fp32 on the CPU, against the plain forward on the
    same decoded pixels (the loader's decode is PIL's): 2e-5, as the fp32
    test."""
    from dirjax_torch.datasets.generic import ImageList

    model = create_model(tiny_arch).eval()
    sd = draw(model, SEED + 1)
    model.load_state_dict(sd)
    paths = _jpegs(tmp_path, [(45, 74), (101, 44), (45, 74)])
    ex = FeatureExtractor(model, "cpu", dtype=torch.float32)
    got = extract_image_features(ImageList(imgs=paths), "", ex, batch_size=2, threads=2)
    want = _plain_descriptors(sd, model.vit_cfg, paths, ex.preprocess)
    assert got.shape == (3, 128)
    assert _dist(torch.from_numpy(got), want) < 2e-5
    with pytest.raises(ValueError, match="batching='group'"):
        extract_image_features(ImageList(imgs=paths), "", ex, batch_size=2, threads=2,
                               batching="bucket")


def test_extract_features_cli(tiny_arch, tmp_path):
    from dirjax_torch import extract_features
    from dirjax_torch.utils import checkpoints as ck

    model = create_model(tiny_arch)
    sd = draw(model, SEED + 2)
    model.load_state_dict(sd)
    ckpt = str(tmp_path / "tiny.pt")
    ck.save_torch_checkpoint(ckpt, ck.Checkpoint(model=model, preprocess=model.cfg.preprocess))
    paths = _jpegs(tmp_path, [(60, 45), (60, 45)], seed=4)
    listing = tmp_path / "list.txt"
    listing.write_text("\n".join(os.path.basename(p) for p in paths) + "\n")
    out = str(tmp_path / "feats.npy")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        extract_features.main(["--dataset", "ImageList('list.txt')", "--checkpoint", ckpt,
                               "--output", out, "--gpu", "-1", "--threads", "1"])
    finally:
        os.chdir(cwd)
    got = torch.from_numpy(np.load(out))
    want = _plain_descriptors(sd, model.vit_cfg, paths, model.cfg.preprocess)
    assert _dist(got, want) < 2e-5


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned attention backend and K1 run on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_published_widths_bf16_on_the_card(cuda):
    """ViT-L/14 with registers at its published widths, batch 2 at 1022 x
    770 (4,020 tokens), bf16 through FeatureExtractor, against the plain
    fp32 forward on the card: 24 blocks of bf16 operands, so 0.03 of a
    unit descriptor. The pinned backend ran every attention, and the
    profiler saw no kernel of the math backend (no softmax kernel); the
    fused residual update and norm ran 2 * 24 + 1 times, and no addcmul or
    LayerNorm kernel ran."""
    from torch.profiler import ProfilerActivity, profile

    model = create_model("dinov2_vitl14_reg_rmac").eval()
    sd = draw(model, SEED + 3)
    model.load_state_dict(sd)
    ex = FeatureExtractor(model, cuda, dtype=torch.bfloat16)
    px = np.random.default_rng(1).integers(0, 256, (2, 770, 1022, 3), dtype=np.uint8)
    calls, fused = vit.attention_calls, vit.residual_norm_calls
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = ex(px)
        torch.cuda.synchronize()
    assert vit.attention_calls - calls == 24
    assert vit.residual_norm_calls - fused == 49
    names = {e.key for e in prof.key_averages()}
    assert not [n for n in names if "softmax" in n.lower()], names
    assert not [n for n in names if "addcmul" in n or "layer_norm" in n], names
    x = torch.from_numpy(px).to(cuda).permute(0, 3, 1, 2).float() * ex._scale[:, None, None] \
        - ex._offset[:, None, None]
    want = plain.forward({k: v.to(cuda) for k, v in sd.items()}, widths(model.vit_cfg), x)
    assert _dist(got, want) < 0.03


@pytest.mark.cuda
def test_pinned_backend_raises_rather_than_falls_back(cuda):
    """A head 320 wide is beyond the pinned backend: the call raises, and no
    attention is counted."""
    q = torch.randn(1, 2, 64, 320, device=cuda, dtype=torch.bfloat16)
    calls = vit.attention_calls
    with pytest.raises(RuntimeError):
        vit.attention(q, q, q)
    assert vit.attention_calls == calls

"""FeatureExtractor's upload (``dirjax_torch.extraction``): for a model on a
CUDA device the loader builds each batch and mask in page-locked memory
(``pinned_empty``), and the extractor sends such an array by a non-blocking
copy; any other array, and every array on the CPU, takes the plain copy it
always did.

The CPU tests hold the CPU path to the plain forward, its span and the
halving of ``adaptive_call``, and the loader's batches built through an
allocator to its default ones. The tests marked ``cuda`` need a card and
skip without one; the file imports no jax, so on a machine with the card and
no JAX run it without tests/conftest.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_upload.py

On the card, three calls in a row upload three pinned batches while a sleep
kernel holds the stream, each batch allocated after the previous one was
released, so every copy is still pending when the next batch is written: a
block handed out again before its copy has read it would give the earlier
call the later batch's pixels. Their descriptors must equal, bit for bit,
those of a pageable upload of the same pixels.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from dirjax_torch import extraction
from dirjax_torch.data import get_loader, iterate_batches
from dirjax_torch.datasets.generic import ImageList
from dirjax_torch.extraction import FeatureExtractor, adaptive_call, extract_image_features
from dirjax_torch.models import create_model
from dirjax_torch.utils import timer

torch.set_num_threads(1)

CASES = ("plain", "mask", "flipped")


def _batches(rng, n: int, shape, case: str):
    """``n`` (images, mask) pairs of uint8 batches of ``shape``: contiguous,
    padded with a validity mask (the ``bucket`` batching path), or a flipped
    view (non-contiguous, as a flip of the loader's batch makes it)."""
    out = []
    for _ in range(n):
        images = rng.integers(0, 256, shape, dtype=np.uint8)
        mask = None
        if case == "mask":
            b, h, w, _ = shape
            mask = np.zeros((b, h, w), bool)
            for r in range(b):
                hr, wr = int(rng.integers(h // 2, h + 1)), int(rng.integers(w // 2, w + 1))
                mask[r, :hr, :wr] = True
            images[~mask] = 0
        elif case == "flipped":
            images = images[:, :, ::-1]
        out.append((images, mask))
    return out


@torch.inference_mode()
def _pageable_forward(ex: FeatureExtractor, images, mask):
    """The extractor's forward after a pageable ``torch.from_numpy(...).to()``
    upload of the same arrays: the normalize, permute and forward as
    ``FeatureExtractor.__call__`` runs them."""
    x = torch.from_numpy(np.ascontiguousarray(images)).to(ex.device)
    x = (x.float() * ex._scale - ex._offset).permute(0, 3, 1, 2)
    m = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask)).to(ex.device)
    return ex.model(x, mask=m, dtype=ex.dtype)


def _jpegs(tmp_path, sizes):
    rng = np.random.default_rng(5)
    paths = []
    for i, (w, h) in enumerate(sizes):
        path = str(tmp_path / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path, quality=90)
        paths.append(path)
    return ImageList(imgs=paths)


@pytest.fixture
def counters(monkeypatch):
    monkeypatch.setattr(extraction, "staged_uploads", 0)
    monkeypatch.setattr(extraction, "staged_bytes", 0)
    return extraction


@pytest.fixture
def cpu_extractor():
    torch.manual_seed(0)
    return FeatureExtractor(create_model("resnet18_rmac", out_dim=16), "cpu")


# --------------------------------------------------------------------------
# the CPU path
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_cpu_extractor_stages_nothing_and_gives_the_plain_forward(cpu_extractor, counters,
                                                                 case):
    rng = np.random.default_rng(1)
    for images, mask in _batches(rng, 2, (3, 40, 32, 3), case):
        got = cpu_extractor(images, mask)
        want = _pageable_forward(cpu_extractor, images, mask)
        assert got.shape == (3, 16) and torch.equal(got, want)
    assert counters.staged_uploads == 0 and counters.staged_bytes == 0
    assert extraction._batch_alloc(cpu_extractor) is None


def test_cpu_extractor_records_one_upload_span_a_call(cpu_extractor):
    rng = np.random.default_rng(2)
    timer.disable()
    timer.clear()
    timer.enable()
    try:
        for n in (1, 3, 2):
            cpu_extractor(rng.integers(0, 256, (n, 32, 40, 3), dtype=np.uint8))
    finally:
        timer.disable()
    uploads = timer.spans("extract.upload")
    timer.clear()
    assert [s[4] for s in uploads] == [1, 3, 2]
    assert all(s[2] <= s[3] for s in uploads)


@pytest.mark.parametrize("case", ("plain", "mask"))
def test_adaptive_call_split_on_the_cpu_returns_the_whole_batch_in_order(cpu_extractor,
                                                                         case):
    """An extractor that runs out of memory above two images: the batch of 5
    comes back whole, each row the one the unsplit batch gives."""
    (images, mask), = _batches(np.random.default_rng(3), 1, (5, 32, 40, 3), case)
    calls = []

    def small(images_, mask_=None):
        calls.append(len(images_))
        if len(images_) > 2:
            raise torch.cuda.OutOfMemoryError("too many images")
        return cpu_extractor(images_, mask_)

    got = adaptive_call(small, images, mask)
    want = cpu_extractor(images, mask).numpy()
    assert calls == [5, 2, 3, 1, 2]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("batching", ("group", "bucket", "single"))
def test_loader_builds_each_batch_in_the_given_allocators_arrays(tmp_path, batching):
    """Batches written into ``alloc``'s arrays (filled with garbage first)
    equal the default ones element for element, padding and mask included,
    and are those arrays."""
    ds = _jpegs(tmp_path, [(40, 32)] * 3 + [(32, 40)] * 2 + [(50, 20)])
    loader = get_loader(ds, output=("img",), totensor=True, device_normalize=True)
    given = []

    def alloc(shape, dtype):
        a = np.empty(shape, dtype)
        a.view(np.uint8)[...] = 0xA5
        given.append(a)
        return a

    kw = dict(batch_size=2, threads=2, batching=batching, bucket_multiple=16)
    want = list(iterate_batches(loader, range(len(ds)), **kw))
    got = list(iterate_batches(loader, range(len(ds)), alloc=alloc, **kw))
    assert len(got) == len(want) > 0
    built = {id(a) for a in given}
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.indices, w.indices)
        assert g.images.dtype == w.images.dtype == np.uint8
        np.testing.assert_array_equal(g.images, w.images)
        assert id(g.images) in built
        if batching == "bucket":
            assert id(g.mask) in built and g.mask.dtype == bool
            np.testing.assert_array_equal(g.mask, w.mask)
        else:
            assert g.mask is None and w.mask is None


# --------------------------------------------------------------------------
# the pinned path, on the card
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the pinned upload runs on a card only")
    return torch.device("cuda")


def _pinned(a):
    """``a``'s pixels in a fresh array of ``pinned_empty``, written as the
    loader writes a batch (a flip written in place, as extraction's flip)."""
    if a is None:
        return None
    p = extraction.pinned_empty(a.shape, a.dtype)
    p[...] = a
    return p


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_pinned_uploads_on_a_busy_stream_equal_pageable_ones_bit_for_bit(cuda, counters,
                                                                         case):
    torch.manual_seed(0)
    ex = FeatureExtractor(create_model("resnet18_rmac", out_dim=16), cuda,
                          dtype=torch.bfloat16)
    assert extraction._batch_alloc(ex) is extraction.pinned_empty
    rng = np.random.default_rng(4)
    warm, *batches = _batches(rng, 4, (8, 64, 96, 3), case)
    ex(_pinned(warm[0]), _pinned(warm[1]))   # builds the kernels, fills the host cache
    torch.cuda.synchronize()
    before_calls, before_bytes = counters.staged_uploads, counters.staged_bytes
    stream = torch.cuda.current_stream()
    torch.cuda._sleep(2_000_000_000)  # ~1 s: every copy below waits behind it
    got = []
    for images, mask in batches:      # each batch released before the next is made
        got.append(ex(_pinned(images), _pinned(mask)))
    assert not stream.query(), "the stream drained before the last call: sleep longer"
    torch.cuda.synchronize()
    want = [_pageable_forward(ex, images, mask) for images, mask in batches]
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), f"call {i}: descriptors differ from the pageable upload's"
    assert counters.staged_uploads - before_calls == 3
    assert counters.staged_bytes - before_bytes == sum(
        images.nbytes + (0 if mask is None else mask.nbytes) for images, mask in batches)


@pytest.mark.cuda
def test_pageable_arrays_and_views_of_pinned_ones_take_the_plain_copy(cuda, counters):
    torch.manual_seed(0)
    ex = FeatureExtractor(create_model("resnet18_rmac", out_dim=16), cuda,
                          dtype=torch.bfloat16)
    (images, _), = _batches(np.random.default_rng(6), 1, (4, 64, 96, 3), "plain")
    pinned = _pinned(images)
    for a in (images, images[:, :, ::-1], pinned[:2], pinned[:, :, ::-1]):
        assert torch.equal(ex(a), _pageable_forward(ex, a, None))
    assert counters.staged_uploads == 0 and counters.staged_bytes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("batching", ("group", "bucket"))
def test_extract_image_features_sends_every_batch_from_pinned_memory(cuda, counters, tmp_path,
                                                                      batching):
    ds = _jpegs(tmp_path, [(40, 32)] * 3 + [(32, 40)] * 2 + [(50, 20)])
    torch.manual_seed(0)
    ex = FeatureExtractor(create_model("resnet18_rmac", out_dim=16), cuda,
                          dtype=torch.bfloat16)
    kw = dict(batching=batching, batch_size=2, threads=2)
    got = extract_image_features(ds, "", ex, **kw)
    loader = get_loader(ds, preprocess=ex.preprocess, output=("img",), totensor=True,
                        device_normalize=True)
    want = np.zeros_like(got)
    batches = list(iterate_batches(loader, range(len(ds)), bucket_multiple=64, **kw))
    for b in batches:
        want[b.indices] = _pageable_forward(ex, b.images, b.mask).float().cpu().numpy()
    np.testing.assert_array_equal(got, want)
    assert counters.staged_uploads == len(batches)
    assert counters.staged_bytes == sum(
        b.images.nbytes + (0 if b.mask is None else b.mask.nbytes) for b in batches)

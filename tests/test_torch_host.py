"""The port's own copies of dirjax's jax-free host modules held against the
originals on the same seeded inputs (CPU): the mAP functions, the dataset
layer (Synthetic benchmark, registry), the loader's group and bucket
batches, and the native JPEG/PNG decode. The copies differ from dirjax's only
in their imports, so every comparison here is exact.
"""

import io

import numpy as np
import pytest

import dirjax.data as JD
import dirjax.datasets as JDS
from dirjax.data import native as jnative
from dirjax.utils import evaluation as jev
from dirjax_torch import data as TD
from dirjax_torch import datasets as TDS
from dirjax_torch.data import native as tnative
from dirjax_torch.utils import evaluation as tev


def test_evaluation_matches_dirjax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        scores = rng.normal(size=200)
        gt = rng.choice([-1, 0, 1], size=200, p=[0.8, 0.1, 0.1])
        labels = (gt > 0).astype(np.int32)
        assert tev.ap_from_gt_scores(gt, scores) == jev.ap_from_gt_scores(gt, scores)
        assert tev.average_precision_classic(labels, scores) == \
            jev.average_precision_classic(labels, scores)
        ranks = jev.positive_ranks_from_scores(gt, scores)
        np.testing.assert_array_equal(tev.positive_ranks_from_scores(gt, scores), ranks)
        assert tev.average_precision_revisited(ranks) == jev.average_precision_revisited(ranks)
        order = np.argsort(-scores)
        assert tev.average_precision_quantized(labels, order) == \
            jev.average_precision_quantized(labels, order)
    multi = rng.normal(size=(30, 10))
    target = rng.integers(0, 10, size=30)
    assert tev.accuracy_topk(multi, target, (1, 5)) == jev.accuracy_topk(multi, target, (1, 5))
    vals = [0.5, float("nan"), -1.0, 0.25]
    assert tev.mean_excluding_invalid(vals) == jev.mean_excluding_invalid(vals)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_host"))
    JDS.Synthetic(root, revisited=True)
    spec = f"Synthetic('{root}')"
    return TDS.create(spec), JDS.create(spec)


def test_datasets_list_the_same_benchmark(synth):
    tdb, jdb = synth
    assert type(tdb).__module__.startswith("dirjax_torch.datasets")
    assert len(tdb) == len(jdb) > 0
    assert [tdb.get_filename(i) for i in range(len(tdb))] == \
        [jdb.get_filename(i) for i in range(len(jdb))]
    tq, jq = tdb.get_query_db(), jdb.get_query_db()
    assert [tq.get_key(i) for i in range(len(tq))] == [jq.get_key(i) for i in range(len(jq))]
    scores = np.random.default_rng(1).normal(size=len(tdb))
    for qi in range(len(tq)):
        assert tdb.eval_query_AP(qi, scores) == jdb.eval_query_AP(qi, scores)
    assert sorted(TDS.available()) == sorted(JDS.available())


@pytest.mark.parametrize("batching", ["group", "bucket"])
def test_loader_yields_the_same_batches(synth, batching):
    (tdb, jdb) = synth
    batches = []
    for data, db in ((TD, tdb), (JD, jdb)):
        loader = data.get_loader(db, trf_chain="Scale(96)", output=("img",),
                                 totensor=True, device_normalize=True)
        batches.append(list(data.iterate_batches(loader, range(len(db)), batch_size=4,
                                                 threads=2, batching=batching,
                                                 bucket_multiple=32)))
    assert len(batches[0]) == len(batches[1]) > 1
    for t, j in zip(*batches):
        assert t.images.dtype == j.images.dtype == np.uint8
        np.testing.assert_array_equal(t.images, j.images)
        np.testing.assert_array_equal(t.indices, j.indices)
        assert (t.mask is None) == (j.mask is None)
        if t.mask is not None:
            np.testing.assert_array_equal(t.mask, j.mask)


def test_native_decode_matches_dirjax():
    from PIL import Image

    if not (tnative.available() and jnative.available()):
        pytest.skip("g++ or the JPEG/PNG headers are missing: the native "
                    "decoder did not build")
    assert "dirjax_torch" in tnative.lib_path() and "_build" in tnative.lib_path()
    rng = np.random.default_rng(2)
    arr = rng.integers(0, 256, size=(61, 83, 3), dtype=np.uint8)
    for fmt in ("JPEG", "PNG"):
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format=fmt)
        data = buf.getvalue()
        assert tnative.probe(data) == jnative.probe(data) == (83, 61)
        np.testing.assert_array_equal(tnative.decode(data), jnative.decode(data))
        np.testing.assert_array_equal(tnative.decode(data, size=(40, 29)),
                                      jnative.decode(data, size=(40, 29)))

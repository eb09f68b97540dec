"""The port's index classes with ``mesh=`` held against the same index on one
device, against dirjax, and across ``save``/``load``, on the CPU.

One world of 4 gloo ranks (``test_torch_dist_worker``) runs every mesh
index through search, AQE, int8 queries, remove, compact, add, save and
load; the parent process runs the same steps on the port's single-device
index (and dirjax's where it has the case) and compares. Meshes: (1, 4),
and (2, 2) for int8, so that the "data" replicas hold the same shards.
Tolerances: dense ids exact and values within 1e-5 (fp32 sums of another
length); PQ ADC values exact (the same table sums), int8-rerank values
within 1e-5; binary symmetric values exact, the asymmetric mesh rescore
within rtol 5e-3 of the exact single-device score (fp32 against its bf16
queries, dirjax's bound). At world 1 (in-process) each mesh index answers
exactly as the single-device one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from dirjax.parallel import make_mesh as jmake_mesh
from dirjax.serving import RetrievalIndex as JRetrievalIndex
from test_torch_dist_worker import run_world

from dirjax_torch import parallel as par
from dirjax_torch.ops.binary import BinaryCodec
from dirjax_torch.serving import BinaryIndex, PQIndex, RetrievalIndex

torch.set_num_threads(1)
WORLD = 4
K = 6
AQE = {"k": 4, "alpha": 3.0}


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _clustered(rng, n, d, centers=8, noise=0.3):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {"db": _unit(rng, 201, 32), "q": _unit(rng, 5, 32), "add": _unit(rng, 23, 32),
           "rm": np.array([0, 5, 190, 199]),
           "cl": _clustered(rng, 800, 64), "pq_db": _clustered(rng, 403, 32)}
    inp["cl_q"] = inp["cl"][:6] + 0.05 * rng.standard_normal((6, 64)).astype(np.float32)
    inp["pq_q"] = inp["pq_db"][:4]
    inp["bin_rm"] = np.array([3, 77, 640])
    inp["pq_rm"] = np.array([0, 9, 17, 150])
    inp["pq_ragged"] = rng.integers(0, 16, size=(597, 8)).astype(np.uint8)
    out = tmp_path_factory.mktemp("files")
    cases = {}
    for dtype, mesh in (("float32", [1, WORLD]), ("bfloat16", [1, WORLD]), ("int8", [2, 2])):
        cases[dtype] = ("index_dense", {"mesh": mesh, "db": "db", "q": "q", "dtype": dtype,
                                        "k": K, "remove": "rm", "add": "add",
                                        "path": str(out / f"{dtype}.npz")})
    for asym in (False, True):
        cases[f"binary_{asym}"] = ("index_binary", {
            "mesh": [1, WORLD], "db": "cl", "q": "cl_q", "k": 7, "asym": asym,
            "rerank_factor": 100, "remove": "bin_rm", "path": str(out / f"bin{asym}.npz")})
    for rerank in (False, True):
        cases[f"pq_{rerank}"] = ("index_pq", {
            "mesh": [1, WORLD], "db": "pq_db", "q": "pq_q", "k": 7, "rerank": rerank,
            "remove": "pq_rm", "path": str(out / f"pq{rerank}.npz"), "ragged": "pq_ragged"})
    names = list(cases)
    outs = run_world(str(tmp_path_factory.mktemp("world")), WORLD,
                     [list(cases[n]) for n in names], inp)
    return inp, dict(zip(names, outs)), out


def _same(got, tag, want, exact_vals=False):
    gv, gi = got[f"{tag}_vals"], got[f"{tag}_ids"]
    wv, wi = want
    np.testing.assert_array_equal(gi, wi, err_msg=tag)
    if exact_vals:
        np.testing.assert_array_equal(gv, wv, err_msg=tag)
    else:
        np.testing.assert_allclose(gv, wv, atol=1e-5, err_msg=tag)


def _exact_topk(q, db, k, keep=None):
    s = q @ db.T
    if keep is not None:
        s[:, ~keep] = -np.inf
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_retrieval_index_mesh_matches_single(world, dtype):
    """Search, AQE, int8 queries, remove (with AQE), compact, add, save and
    load of a mesh RetrievalIndex, step for step against one device."""
    inp, outs, files = world
    got = outs[dtype]
    db, q = inp["db"], inp["q"]
    idx = RetrievalIndex(db, dtype=getattr(torch, dtype), device="cpu",
                         keys=[f"k{i}" for i in range(len(db))])
    _same(got, "plain", idx.search(q, k=K))
    _same(got, "aqe", idx.search(q, k=K, aqe=AQE))
    if dtype == "int8":
        _same(got, "int8q", idx.search(q, k=K, int8_queries=True))
    idx.remove(indices=inp["rm"])
    _same(got, "removed", idx.search(q, k=K))
    _same(got, "removed_aqe", idx.search(q, k=K, aqe=AQE))
    np.testing.assert_array_equal(got["mapping"], idx.compact())
    _same(got, "compacted", idx.search(q, k=K))
    idx.add(inp["add"], keys=[f"a{i}" for i in range(len(inp["add"]))])
    _same(got, "added", idx.search(q, k=K))
    back = RetrievalIndex.load(str(files / f"{dtype}.npz"), device="cpu")
    assert back.dtype == (torch.int8 if dtype == "int8" else torch.float32)
    _same(got, "loaded", back.search(q, k=K))
    assert got["tomb_removed"].tolist() == [len(inp["rm"])]
    tomb = RetrievalIndex.load(str(files / f"{dtype}.npz.tomb.npz"), device="cpu")
    _same(got, "tomb", tomb.search(q, k=K))


def test_retrieval_index_mesh_against_dirjax(world):
    """dirjax's mesh cases (test_serving.py:59-75, test_serving_remove.py:85):
    ids of the exact top-k, AQE ids of dirjax's index, removed rows never
    returned; a file the mesh index saved loads in dirjax."""
    inp, outs, files = world
    got = outs["float32"]
    db, q = inp["db"], inp["q"]
    np.testing.assert_array_equal(got["plain_ids"], _exact_topk(q, db, K))
    jaqe = JRetrievalIndex(db).search(q, k=K, aqe=AQE)[1]
    np.testing.assert_array_equal(got["aqe_ids"], jaqe)
    keep = np.ones(len(db), bool)
    keep[inp["rm"]] = False
    np.testing.assert_array_equal(got["removed_ids"], _exact_topk(q, db, K, keep))
    back = JRetrievalIndex.load(str(files / "float32.npz"))
    np.testing.assert_array_equal(back.search(q, k=K)[1], got["loaded_ids"])


def test_int8_mesh_matches_dirjax_single_chip(world):
    """test_quantized.py:221: the int8 mesh index ranks as dirjax's int8
    index (the same quantized values), values within 2e-2."""
    inp, outs, _ = world
    import dirjax.serving as js

    jv, ji = js.RetrievalIndex(inp["db"], dtype=jnp.int8).search(inp["q"], k=K)
    np.testing.assert_array_equal(outs["int8"]["plain_ids"], ji)
    np.testing.assert_allclose(outs["int8"]["plain_vals"], jv, atol=2e-2)
    mesh = jmake_mesh(data=2, db=2, devices=jax.devices()[:4])
    jm = js.RetrievalIndex(inp["db"], dtype=jnp.int8, mesh=mesh)
    np.testing.assert_array_equal(outs["int8"]["aqe_ids"], jm.search(inp["q"], k=K, aqe=AQE)[1])


def _binary_single(inp, got, asym):
    codec = BinaryCodec(torch.from_numpy(got["codec_mean"]), torch.from_numpy(got["codec_proj"]))
    return BinaryIndex(inp["cl"], asym=asym, device="cpu", _codec=codec)


@pytest.mark.parametrize("asym", [False, True])
def test_binary_index_mesh(world, asym):
    """test_binary.py:334-406: symmetric values exactly the single device's;
    asymmetric at rerank_factor 100 (each rank rescores every row) within
    rtol 5e-3 of the exact single-device search; add, remove, compact and
    load keep every id in range and removed rows out."""
    inp, outs, _ = world
    got = outs[f"binary_{asym}"]
    single = _binary_single(inp, got, asym)
    q = inp["cl_q"]
    sv, si = single.search(q, k=7)
    if asym:
        np.testing.assert_allclose(got["plain_vals"], sv, rtol=5e-3)
    else:
        np.testing.assert_array_equal(got["plain_vals"], sv)
    single.remove(indices=inp["bin_rm"])
    rv = single.search(q, k=7)[0]
    np.testing.assert_allclose(got["removed_vals"], rv, rtol=5e-3 if asym else 0)
    assert not np.isin(got["removed_ids"], inp["bin_rm"]).any()
    np.testing.assert_array_equal(got["mapping"], single.compact())
    assert got["compacted_ids"].max() < 800 - len(inp["bin_rm"])
    np.testing.assert_array_equal(got["loaded_vals"], got["compacted_vals"])


@pytest.mark.parametrize("rerank", [False, True])
def test_pq_index_mesh_matches_single(world, rerank):
    """test_pq.py:369-391 and test_serving_remove.py:232: the mesh PQIndex
    (its codebooks given to the single-device index) answers as one device,
    AQE through rows gathered from their ranks included; ragged codes never
    return a row past the end."""
    inp, outs, _ = world
    got = outs[f"pq_{rerank}"]
    db, q = inp["pq_db"], inp["pq_q"]
    idx = PQIndex(db, rerank=rerank, device="cpu", _trained=(None, got["codebooks"]))
    exact = not rerank
    _same(got, "plain", idx.search(q, k=7), exact_vals=exact)
    _same(got, "aqe", idx.search(q, k=7, aqe=AQE))
    idx.remove(indices=inp["pq_rm"])
    _same(got, "removed", idx.search(q, k=7), exact_vals=exact)
    _same(got, "removed_aqe", idx.search(q, k=7, aqe=AQE))
    np.testing.assert_array_equal(got["mapping"], idx.compact())
    _same(got, "compacted", idx.search(q, k=7), exact_vals=exact)
    _same(got, "loaded", idx.search(q, k=7), exact_vals=exact)
    assert got["ragged_ids"].max() < 597 and got["ragged_ids"].min() >= 0


def test_pq_mesh_matches_dirjax(world):
    """dirjax's PQIndex with the same codebooks: the same ADC values."""
    from dirjax.serving import PQIndex as JPQIndex

    inp, outs, _ = world
    got = outs["pq_False"]
    jv, _ = JPQIndex(inp["pq_db"], _trained=(None, jnp.asarray(got["codebooks"]))).search(
        inp["pq_q"], k=7)
    np.testing.assert_allclose(got["plain_vals"], jv, atol=1e-5)


# --- world 1, in-process -----------------------------------------------------

@pytest.fixture
def mesh1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield par.make_mesh(1, 1, device_type="cpu")
    dist.destroy_process_group()


def test_world1_indexes_equal_single_device(mesh1, tmp_path):
    """At world 1 a mesh index answers exactly as the single-device index,
    through AQE, remove, add, save and load."""
    rng = np.random.default_rng(7)
    db, q = _unit(rng, 1500, 32), _unit(rng, 4, 32)
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        m, s = RetrievalIndex(db, dtype=dt, mesh=mesh1), RetrievalIndex(db, dtype=dt,
                                                                        device="cpu")
        for kw in ({}, {"aqe": AQE}):
            for a, b in zip(m.search(q, k=20, **kw), s.search(q, k=20, **kw)):
                np.testing.assert_array_equal(a, b)
        for ix in (m, s):
            ix.remove(indices=[1, 2, 3])
            ix.add(db[:9])
        np.testing.assert_array_equal(m.search(q, k=20)[1], s.search(q, k=20)[1])
        m.save(str(tmp_path / "m.npz"))
        back = RetrievalIndex.load(str(tmp_path / "m.npz"), mesh=mesh1)
        np.testing.assert_array_equal(back.search(q, k=20)[1], s.search(q, k=20)[1])
    for asym in (False, True):
        b = BinaryIndex(db, 32, itq_iters=2, asym=asym, device="cpu")
        mb = BinaryIndex(db, asym=asym, mesh=mesh1, _codec=b.codec)
        got, want = mb.search(q, k=9, rerank_factor=200)[0], b.search(q, k=9)[0]
        np.testing.assert_allclose(got, want, rtol=5e-3 if asym else 0)
    p = PQIndex(db, m=8, ksub=16, train_iters=3, rerank=True, device="cpu")
    mp = PQIndex(db, rerank=True, mesh=mesh1, _trained=(None, p.codebooks))
    for kw in ({}, {"aqe": AQE}):
        for a, c in zip(mp.search(q, k=9, **kw), p.search(q, k=9, **kw)):
            np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="single-chip"):
        from dirjax_torch.serving import IVFPQIndex

        IVFPQIndex(db, nlist=4, m=8, ksub=16, train_iters=2, device="cpu").save(
            str(tmp_path / "ivf.npz"))
        RetrievalIndex.load(str(tmp_path / "ivf.npz"), mesh=mesh1)


def test_tune_sweeps_rerank_factor_on_mesh(mesh1):
    """dirjax's test_binary.py:419: an asymmetric BinaryIndex on a mesh has
    a shortlist to tune, where one device's exact search has none."""
    from dirjax_torch.tuning import tune

    rng = np.random.default_rng(8)
    db = _clustered(rng, 600, 64)
    q = db[:5] + 0.05 * rng.standard_normal((5, 64)).astype(np.float32)
    single = BinaryIndex(db, itq_iters=5, sample=None, device="cpu")
    idx = BinaryIndex(db, mesh=mesh1, _codec=single.codec)
    res = tune(idx, q, k=5, target=0.6, descriptors=db)
    assert res.trials and "rerank_factor" in res.trials[0][0]
    assert res.met == (res.recall >= 0.6)
    assert [p for p, _ in tune(single, q, k=5, target=0.6, descriptors=db).trials] == [{}]

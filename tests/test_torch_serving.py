"""dirjax_torch's serving path held against dirjax's on the same numpy inputs
(CPU): RetrievalIndex in fp32, bf16 and int8 (search with and without
int8_queries and AQE, tombstones, add, compact, lookup), BinaryIndex (sym and
asym, tombstones, add, compact, lookup), the chunked and quantized query
expansion, index files across the two packages, the port's copy of the
batcher and socket server over its indexes, and the index CLI.

dirjax's CPU search ranks densely; the port takes its kernels' route with
their plain versions. Tolerances: scores within rtol 1e-5 / atol 1e-5 (fp32
sums of exact products in another order), indices and keys identical (the
inputs are random, so no two scores tie; where rows are built to tie
exactly, both rank the lower index first). Binary indexes: symmetric values
exactly equal, asymmetric within 1e-4; an index may differ only where its
score ties (Hamming scores are small integers) or lies within 1e-3 of the
k-th. Served answers equal the port's direct search exactly: the same code
ranks them.
"""

import json
import os
import subprocess
import sys
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dirjax.serving as JS
from dirjax.cli.index import main as jindex
from dirjax.ops import binary as JB
from dirjax.ops import qe as jqe
from dirjax.ops import topk_pallas as jtopk
from dirjax_torch import serving as TS
from dirjax_torch.cli.index import main as tindex
from dirjax_torch.ops import binary as TB
from dirjax_torch.ops import qe as tqe
from dirjax_torch.ops import topk as ttopk
from dirjax_torch.serve import Client, DynamicBatcher, IndexServer
from dirjax_torch.utils.checkpoints import binary_codec_from_jax

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
ASYM_ATOL, MARGIN = 1e-4, 1e-3
N, D = 3001, 64
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
          "int8": (jnp.int8, torch.int8)}
AQE = {"k": 5, "alpha": 3.0}


def _unit(rng, rows, d=D):
    x = rng.normal(size=(rows, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    return _unit(rng, N), _unit(rng, 6), [f"img{i:05d}" for i in range(N)]


def _same(got, want):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_allclose(gv, wv, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(gi, wi)
    assert gv.dtype == np.float32 and gi.dtype == np.int32


def _pair(data, mode):
    db, _, keys = data
    jdt, tdt = DTYPES[mode]
    return (JS.RetrievalIndex(db, keys=keys, dtype=jdt),
            TS.RetrievalIndex(db, keys=keys, dtype=tdt, device="cpu"))


SEARCHES = [("fp32", dict(k=10)), ("fp32", dict(k=40, aqe=AQE)),
            ("bf16", dict(k=10, aqe=AQE)), ("bf16", dict(k=40)),
            ("int8", dict(k=10)), ("int8", dict(k=40, aqe=AQE)),
            ("int8", dict(k=10, int8_queries=True)),
            ("int8", dict(k=40, int8_queries=True, aqe=AQE))]


@pytest.mark.parametrize("mode,opts", SEARCHES)
def test_search_matches_dirjax(data, mode, opts):
    jidx, tidx = _pair(data, mode)
    q = data[1]
    _same(tidx.search(q, **opts), jidx.search(q, **opts))
    _same(tidx.search(q[0], **opts), jidx.search(q[0], **opts))   # one query


@pytest.mark.parametrize("mode", DTYPES)
def test_remove_is_exact_and_matches_dirjax(data, mode):
    jidx, tidx = _pair(data, mode)
    q = data[1]
    _, hits = jidx.search(q, k=10)
    gone = np.unique(hits[:, :4])
    assert jidx.remove(indices=gone) == tidx.remove(indices=gone) == len(gone)
    for opts in (dict(k=10), dict(k=10, aqe=AQE)):
        got = tidx.search(q, **opts)
        _same(got, jidx.search(q, **opts))
        assert not np.isin(got[1], gone).any()
    # AQE ignores removed rows: as an index that never held them
    keep = np.setdiff1d(np.arange(N), gone)
    fresh = TS.RetrievalIndex(data[0][keep], dtype=DTYPES[mode][1], device="cpu")
    np.testing.assert_array_equal(keep[fresh.search(q, k=10, aqe=AQE)[1]],
                                  tidx.search(q, k=10, aqe=AQE)[1])


@pytest.mark.parametrize("mode", DTYPES)
def test_add_compact_lookup_match_dirjax(data, mode):
    jidx, tidx = _pair(data, mode)
    extra = _unit(np.random.default_rng(3), 40)
    new_keys = [f"new{i}" for i in range(40)]
    jidx.add(extra, keys=new_keys)
    tidx.add(extra, keys=new_keys)
    assert tidx.n == jidx.n == N + 40
    drop = data[2][5:50:3] + new_keys[::7]
    assert jidx.remove(keys=drop) == tidx.remove(keys=drop)
    q = np.concatenate([data[1], extra[:2]])
    _same(tidx.search(q, k=20), jidx.search(q, k=20))
    mapping = tidx.compact()
    np.testing.assert_array_equal(mapping, jidx.compact())
    assert tidx.n_removed == 0 and tidx.n == jidx.n
    got, want = tidx.search(q, k=20), jidx.search(q, k=20)
    _same(got, want)
    assert tidx.lookup(got[1]) == jidx.lookup(want[1])
    assert tidx.lookup([[-1, 0]]) == [[None, tidx.keys[0]]]


def test_search_errors(data):
    _, tidx = _pair(data, "bf16")
    with pytest.raises(ValueError, match="int8_queries"):
        tidx.search(data[1], k=5, int8_queries=True)
    with pytest.raises(ValueError, match="queries must be"):
        tidx.search(data[1][:, :10], k=5)
    tidx.remove(indices=[0])
    with pytest.raises(ValueError, match="exceeds"):
        tidx.search(data[1], k=N + 1)


@pytest.mark.parametrize("excluded", [False, True])
def test_expand_queries_chunked_matches(data, excluded):
    db, q, _ = data
    mask = np.zeros(N, bool)
    mask[np.random.default_rng(1).choice(N, 50, replace=False)] = True
    jkw = dict(exclude_mask=jnp.asarray(mask), exclude_pad=64) if excluded else {}
    tkw = dict(exclude_mask=torch.from_numpy(mask), exclude_pad=64) if excluded else {}
    for jdb, tdb in ((jnp.asarray(db), torch.from_numpy(db)),
                     (jnp.asarray(db, jnp.bfloat16), torch.from_numpy(db).bfloat16())):
        want = jqe.expand_queries_chunked(jnp.asarray(q), jdb, 3.0, 7, db_chunk=1000, **jkw)
        got = tqe.expand_queries_chunked(torch.from_numpy(q), tdb, 3.0, 7,
                                         db_chunk=1000, **tkw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_expand_database_chunked_matches(data):
    db = data[0][:600]
    want = jqe.expand_database_chunked(jnp.asarray(db), 3.0, 5, row_block=300, db_chunk=200)
    got = tqe.expand_database_chunked(torch.from_numpy(db), 3.0, 5, row_block=300,
                                      db_chunk=200)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.numpy(), tqe.expand_database(torch.from_numpy(db),
                                                                3.0, 5).numpy(),
                               rtol=RTOL, atol=ATOL)


def _grid_rows(rng, n, d=8):
    """Rows of multiples of 0.5 (one decimal, exact in binary): every dot
    product is exact in any summation order, and many distinct rows tie."""
    return (np.round(rng.normal(size=(n, d)) * 2) / 2).astype(np.float32)


@pytest.mark.parametrize("k,excluded", [(5, False), (20, False), (7, True)])
def test_expand_queries_chunked_ranks_ties_like_dirjax(k, excluded):
    # 1000-row chunks: rows tied at the k-th place fall in different chunks
    rng = np.random.default_rng(12)
    db, q = _grid_rows(rng, 3001), _grid_rows(rng, 9)
    mask = np.zeros(len(db), bool)
    mask[::41] = excluded
    jkw = dict(exclude_mask=jnp.asarray(mask), exclude_pad=80) if excluded else {}
    tkw = dict(exclude_mask=torch.from_numpy(mask), exclude_pad=80) if excluded else {}
    want = jqe.expand_queries_chunked(jnp.asarray(q), jnp.asarray(db), 3.0, k,
                                      db_chunk=1000, **jkw)
    got = tqe.expand_queries_chunked(torch.from_numpy(q), torch.from_numpy(db), 3.0, k,
                                     db_chunk=1000, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_expand_database_chunked_ranks_ties_like_dirjax():
    db = _grid_rows(np.random.default_rng(13), 600)
    want = jqe.expand_database_chunked(jnp.asarray(db), 3.0, 5, row_block=300, db_chunk=200)
    got = tqe.expand_database_chunked(torch.from_numpy(db), 3.0, 5, row_block=300,
                                      db_chunk=200)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode,k", [("fp32", 10), ("fp32", 40), ("bf16", 10)])
def test_search_with_ties_matches_dirjax(mode, k):
    rng = np.random.default_rng(14)
    db, q = _grid_rows(rng, 3001), _grid_rows(rng, 9)
    jdt, tdt = DTYPES[mode]
    jidx = JS.RetrievalIndex(db, dtype=jdt)
    tidx = TS.RetrievalIndex(db, dtype=tdt, device="cpu")
    for opts in (dict(k=k), dict(k=k, aqe=AQE)):
        _same(tidx.search(q, **opts), jidx.search(q, **opts))


@pytest.mark.parametrize("excluded", [False, True])
def test_expand_queries_quantized_matches(data, excluded):
    db, q, _ = data
    mask = np.zeros(N, bool)
    mask[::97] = True
    jdb, js = jtopk.quantize_db(jnp.asarray(db))
    tdb, ts = ttopk.quantize_db(torch.from_numpy(db))
    jkw = dict(exclude_mask=jnp.asarray(mask), exclude_pad=64) if excluded else {}
    tkw = dict(exclude_mask=torch.from_numpy(mask), exclude_pad=64) if excluded else {}
    want = jqe.expand_queries_quantized(jnp.asarray(q), jdb, js, 3.0, 9, **jkw)
    got = tqe.expand_queries_quantized(torch.from_numpy(q), tdb, ts, 3.0, 9, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("mode", DTYPES)
def test_index_files_cross_between_packages(data, mode, tmp_path):
    """An index saved by either package loads in the other (tombstones
    included) and answers the same."""
    jidx, tidx = _pair(data, mode)
    jidx.remove(keys=data[2][:30])
    tidx.remove(keys=data[2][:30])
    jidx.save(str(tmp_path / "j.npz"))
    tidx.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as jf, np.load(tmp_path / "t.npz") as tf:
        assert sorted(jf.files) == sorted(tf.files)
        for name in jf.files:
            np.testing.assert_array_equal(jf[name], tf[name])
    t_from_j = TS.RetrievalIndex.load(str(tmp_path / "j.npz"), device="cpu")
    j_from_t = JS.RetrievalIndex.load(str(tmp_path / "t.npz"))
    assert t_from_j.n_removed == 30 and t_from_j.dtype == (
        torch.int8 if mode == "int8" else torch.float32)
    q = data[1]
    _same(t_from_j.search(q, k=15, aqe=AQE), j_from_t.search(q, k=15, aqe=AQE))
    bf = TS.RetrievalIndex.load(str(tmp_path / "j.npz"), dtype=torch.bfloat16,
                                device="cpu")
    assert bf.dtype == torch.bfloat16 and bf.n_removed == 30


def test_load_refuses_compressed_archives(tmp_path):
    """A PQ or IVF archive goes to its own loader, which refuses one that
    lacks its codebooks."""
    for name, arrays in (("pq", {"pq_codes": np.zeros((4, 2), np.uint8)}),
                         ("ivf", {"ivf_codes": np.zeros((1, 64, 2), np.uint8),
                                  "ivf_meta": np.asarray([4, 8], np.int64)})):
        path = str(tmp_path / f"{name}.npz")
        np.savez(path, **arrays)
        with pytest.raises(KeyError, match="pq_codebooks"):
            TS.RetrievalIndex.load(path, device="cpu")


def test_batcher_and_server_over_port_index(data, tmp_path):
    """dirjax.server's DynamicBatcher (pipelined) and IndexServer + Client,
    unchanged, over the port's int8 index: concurrent answers equal direct
    search."""
    db, _, keys = data
    index = TS.RetrievalIndex(db, keys=keys, dtype=torch.int8, device="cpu")
    rng = np.random.default_rng(5)
    reqs = [(_unit(rng, int(rng.integers(1, 6))), k, opts)
            for k, opts in [(10, {}), (40, {}), (10, {"int8_queries": True}),
                            (10, {"aqe": AQE})] * 3]
    batcher = DynamicBatcher(index, max_batch=16, max_wait_ms=20.0, pipeline=3)
    try:
        futs = [batcher.submit(q, k=k, **opts) for q, k, opts in reqs]
        for (q, k, opts), fut in zip(reqs, futs):
            got = fut.result(timeout=120)
            want = index.search(q, k=k, **opts)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
    finally:
        batcher.close()
    assert batcher.stats["batches"] < len(reqs)        # requests coalesced

    server = IndexServer(index, str(tmp_path / "s.sock"), max_batch=16,
                         max_wait_ms=20.0, pipeline=3)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    answers = {}

    def client(c):
        with Client(server.address) as cl:
            futs = [cl.search_async(q, k=k, keys=True, **opts)
                    for q, k, opts in reqs[c::3]]
            answers[c] = [f.result(timeout=120) for f in futs]

    try:
        workers = [threading.Thread(target=client, args=(c,)) for c in range(3)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        with Client(server.address) as cl:
            cl.shutdown_server()
        thread.join(timeout=30)
    assert not thread.is_alive()
    for c, got in answers.items():
        for (q, k, opts), (vals, idxs, hit_keys) in zip(reqs[c::3], got):
            want = index.search(q, k=k, **opts)
            np.testing.assert_array_equal(vals, want[0])
            np.testing.assert_array_equal(idxs, want[1])
            assert hit_keys == index.lookup(want[1])
    assert len(answers) == 3


def test_serve_main_answers_clients(data, tmp_path):
    """``python -m dirjax_torch.serve`` over a dirjax-built index file:
    a dirjax Client gets the port's answers, then shuts the server down."""
    from dirjax.server import Client as JClient
    from dirjax_torch.serve import main as serve_main

    db, q, keys = data
    JS.RetrievalIndex(db, keys=keys, dtype=jnp.int8).save(str(tmp_path / "i.npz"))
    sock = str(tmp_path / "m.sock")
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("server", serve_main(
        ["--index", str(tmp_path / "i.npz"), "--socket", sock, "--gpu", "-1",
         "--max-wait-ms", "1", "--warmup-k", "10"])), daemon=True)
    thread.start()
    client = JClient(sock, connect_timeout=60)
    try:
        vals, idxs, hit_keys = client.search(q, k=10, keys=True)
        client.shutdown_server()
    finally:
        client.close()
    thread.join(timeout=60)
    assert not thread.is_alive() and result["server"].batcher.stats["requests"] == 1
    want = TS.RetrievalIndex.load(str(tmp_path / "i.npz"), device="cpu").search(q, k=10)
    np.testing.assert_array_equal(vals, want[0])
    np.testing.assert_array_equal(idxs, want[1])
    assert hit_keys == [[keys[j] for j in row] for row in want[1]]


def test_index_cli_matches_dirjax(data, tmp_path):
    """build/remove/query through both CLIs on the same .npy; the port's
    query also runs as ``python -m dirjax_torch.index``."""
    db, q, keys = data
    np.save(tmp_path / "db.npy", db)
    np.save(tmp_path / "q.npy", q)
    (tmp_path / "keys.txt").write_text("\n".join(keys) + "\n")
    cpu = ["--gpu", "-1"]
    for name, main in (("j", jindex), ("t", tindex)):
        main(["build", "--descs", str(tmp_path / "db.npy"), "--keys",
              str(tmp_path / "keys.txt"), "--int8", "--out",
              str(tmp_path / f"{name}.npz")] + cpu)
        main(["remove", "--index", str(tmp_path / f"{name}.npz"), "--indices",
              "3", "17", "400"] + cpu)
    query = ["query", "--descs", str(tmp_path / "q.npy"), "-k", "12", "--aqe", "5",
             "3", "--int8-queries"]
    jindex(query + ["--index", str(tmp_path / "j.npz"), "--out-json",
                    str(tmp_path / "j.json")] + cpu)
    out = subprocess.run(
        [sys.executable, "-m", "dirjax_torch.index", *query, "--index",
         str(tmp_path / "j.npz"), "--out-json", str(tmp_path / "t.json"), *cpu],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tindex(query + ["--index", str(tmp_path / "t.npz"), "--out-json",
                    str(tmp_path / "tt.json")] + cpu)
    want = json.loads((tmp_path / "j.json").read_text())
    for name in ("t.json", "tt.json"):
        got = json.loads((tmp_path / name).read_text())
        assert got["indices"] == want["indices"] and got["keys"] == want["keys"]
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("argv,item", [
    (["build", "--descs", "x.npy", "--out", "y.npz", "--pq", "8"], "M10"),
    (["build", "--descs", "x.npy", "--out", "y.npz", "--ivf", "16"], "M11"),
    (["tune", "--index", "y.npz", "--descs", "x.npy", "--db-descs", "x.npy"], "M11")])
def test_cli_names_roadmap_item_of_unported_kinds(argv, item, tmp_path):
    """The kinds the CLI once refused, naming their ROADMAP item (PQ: M10;
    IVF and tune: M11), are ported: each runs on the CPU."""
    x = _unit(np.random.default_rng(9), 600, 32)
    np.save(tmp_path / "x.npy", x)
    argv = [str(tmp_path / a) if a.endswith((".npy", ".npz")) else a for a in argv]
    if argv[0] == "tune":
        tindex(["build", "--descs", argv[4], "--ivf", "8", "--pq", "4", "--out", argv[2],
                "--gpu", "-1"])
    out = tindex(argv + ["--gpu", "-1"])
    if argv[0] == "tune":
        assert out.trials and 0.0 <= out.recall <= 1.0, item
    else:
        kind = TS.PQIndex if "--pq" in argv else TS.IVFPQIndex
        assert type(out) is kind and type(TS.RetrievalIndex.load(
            str(tmp_path / "y.npz"), device="cpu")) is kind, item


# --- BinaryIndex -----------------------------------------------------------

def _binary_pair(data, asym, keys=True):
    """dirjax's and the port's BinaryIndex over the same rows and the codec
    dirjax fitted."""
    db, _, names = data
    codec = JB.fit_itq(db, 64, iters=3)
    kw = dict(keys=names if keys else None, asym=asym)
    return (JS.BinaryIndex(db, _codec=codec, **kw),
            TS.BinaryIndex(db, _codec=binary_codec_from_jax(codec.mean, codec.proj),
                           device="cpu", **kw))


def _plain_binary_scores(tidx, q):
    qb, vq = TB.binarize_and_project(q, tidx.codec)
    qf = vq.bfloat16().float() if tidx.asym else TB.unpack_pm1(qb)
    return (qf @ TB.unpack_pm1(tidx._codes).T).numpy()


def _same_binary(got, want, tidx, q):
    """Values equal (sym) or within 1e-4 (asym); every returned row carries
    its plain score; the rows above the k-th score (asym: by a 1e-3 margin)
    are the same rows."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gv.dtype == np.float32 and gi.dtype == np.int32
    tol = ASYM_ATOL if tidx.asym else 0.0
    np.testing.assert_allclose(gv, wv, rtol=0, atol=tol)
    scores = _plain_binary_scores(tidx, q)
    np.testing.assert_allclose(np.take_along_axis(scores, np.maximum(gi, 0), 1)[gi >= 0],
                               gv[gi >= 0], rtol=0, atol=tol)
    margin = MARGIN if tidx.asym else 0.0
    for r in range(len(gv)):
        kth = wv[r, -1]
        assert set(gi[r][gv[r] > kth + margin]) == set(wi[r][wv[r] > kth + margin])


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_binary_search_matches_dirjax(data, asym):
    jidx, tidx = _binary_pair(data, asym)
    assert tidx.n_bits == 64 and tidx._codes.shape == (N, 8)
    q = data[1]
    for k in (1, 10, 100):
        _same_binary(tidx.search(q, k), jidx.search(q, k), tidx, q)
    _same_binary(tidx.search(q[0], 10), jidx.search(q[0], 10), tidx, q[:1])


@pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
def test_binary_remove_add_compact_lookup_match_dirjax(data, asym):
    jidx, tidx = _binary_pair(data, asym)
    q = data[1]
    _, hits = tidx.search(q, k=10)
    gone = np.unique(hits[:, :4])
    assert jidx.remove(indices=gone) == tidx.remove(indices=gone) == len(gone)
    got = tidx.search(q, k=10)
    _same_binary(got, jidx.search(q, k=10), tidx, q)
    assert not np.isin(got[1], gone).any()
    extra = _unit(np.random.default_rng(3), 40)
    new_keys = [f"new{i}" for i in range(40)]
    jidx.add(extra, keys=new_keys)
    tidx.add(extra, keys=new_keys)
    assert tidx.n == jidx.n == N + 40
    drop = data[2][5:50:3] + new_keys[::7]
    assert jidx.remove(keys=drop) == tidx.remove(keys=drop)
    q2 = np.concatenate([q, extra[:2]])
    mapping = tidx.compact()
    np.testing.assert_array_equal(mapping, jidx.compact())
    assert tidx.n_removed == 0 and tidx.n == jidx.n
    got, want = tidx.search(q2, k=20), jidx.search(q2, k=20)
    _same_binary(got, want, tidx, q2)
    assert tidx.lookup(got[1][:, :1]) == jidx.lookup(want[1][:, :1])
    with pytest.raises(ValueError, match="exceeds"):
        tidx.search(q, k=tidx.n + 1)


def test_binary_files_cross_between_packages(data, tmp_path):
    """A binary index saved by either package loads in the other (through
    RetrievalIndex.load's dispatch, tombstones included) and answers the
    same."""
    jidx, tidx = _binary_pair(data, asym=True)
    jidx.remove(keys=data[2][:30])
    tidx.remove(keys=data[2][:30])
    jidx.save(str(tmp_path / "j.npz"))
    tidx.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as jf, np.load(tmp_path / "t.npz") as tf:
        assert sorted(jf.files) == sorted(tf.files)
        for name in jf.files:
            np.testing.assert_array_equal(jf[name], tf[name])
        assert tf["binary_codes"].dtype == np.uint32
    t_from_j = TS.RetrievalIndex.load(str(tmp_path / "j.npz"), device="cpu")
    j_from_t = JS.RetrievalIndex.load(str(tmp_path / "t.npz"))
    assert isinstance(t_from_j, TS.BinaryIndex) and isinstance(j_from_t, JS.BinaryIndex)
    assert t_from_j.n_removed == 30 and t_from_j.asym
    q = data[1]
    _same_binary(t_from_j.search(q, k=15), j_from_t.search(q, k=15), t_from_j, q)


def test_indexes_default_to_the_card():
    import inspect

    for fn in (TS.RetrievalIndex.__init__, TS.RetrievalIndex.load,
               TS.BinaryIndex.__init__, TS.BinaryIndex.load, TS.PQIndex.__init__,
               TS.PQIndex.load, TS.PQIndex.from_codes, TS.IVFPQIndex.__init__,
               TS.IVFPQIndex.load):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_binary_index_cli_matches_dirjax(data, tmp_path):
    """``build --binary 64`` through each CLI; each file queried by both
    (``query --gpu -1``, the port's as ``python -m dirjax_torch.index``)
    gives the same JSON answer."""
    db, q, keys = data
    np.save(tmp_path / "db.npy", db)
    np.save(tmp_path / "q.npy", q)
    (tmp_path / "keys.txt").write_text("\n".join(keys) + "\n")
    cpu = ["--gpu", "-1"]
    for name, main in (("j", jindex), ("t", tindex)):
        main(["build", "--descs", str(tmp_path / "db.npy"), "--keys",
              str(tmp_path / "keys.txt"), "--binary", "64", "--out",
              str(tmp_path / f"{name}.npz")] + cpu)
        main(["remove", "--index", str(tmp_path / f"{name}.npz"), "--indices",
              "3", "17", "400"] + cpu)
    query = ["query", "--descs", str(tmp_path / "q.npy"), "-k", "12"]
    for name in ("j", "t"):
        index = str(tmp_path / f"{name}.npz")
        jindex(query + ["--index", index, "--out-json", str(tmp_path / "j.json")] + cpu)
        out = subprocess.run(
            [sys.executable, "-m", "dirjax_torch.index", *query, "--index", index,
             "--out-json", str(tmp_path / "t.json"), *cpu],
            capture_output=True, text=True, cwd=REPO, timeout=300)
        assert out.returncode == 0, out.stderr[-3000:]
        got, want = (json.loads((tmp_path / f).read_text()) for f in ("t.json", "j.json"))
        tidx = TS.RetrievalIndex.load(index, device="cpu")
        _same_binary((np.asarray(got["scores"], np.float32), np.asarray(got["indices"], np.int32)),
                     (np.asarray(want["scores"], np.float32), np.asarray(want["indices"], np.int32)),
                     tidx, q)
        assert got["keys"] == tidx.lookup(got["indices"])
    with pytest.raises(SystemExit, match="don't apply to binary"):
        tindex(query + ["--index", str(tmp_path / "t.npz"), "--aqe", "3", "2"] + cpu)
    with pytest.raises(SystemExit, match="conflicting storage flags"):
        tindex(["build", "--descs", str(tmp_path / "db.npy"), "--binary", "64",
                "--int8", "--out", str(tmp_path / "x.npz")] + cpu)


def test_serve_binary_index_to_both_clients(data, tmp_path):
    """``python -m dirjax_torch.serve`` over a binary index file: a dirjax
    Client and the port's Client get the port's direct answers."""
    from dirjax.server import Client as JClient
    from dirjax_torch.serve import main as serve_main

    db, q, keys = data
    _, tidx = _binary_pair(data, asym=True)
    tidx.save(str(tmp_path / "b.npz"))
    sock = str(tmp_path / "b.sock")
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("server", serve_main(
        ["--index", str(tmp_path / "b.npz"), "--socket", sock, "--gpu", "-1",
         "--max-wait-ms", "1"])), daemon=True)
    thread.start()
    answers = []
    try:
        for client_cls in (JClient, Client):
            with client_cls(sock, connect_timeout=60) as client:
                answers.append(client.search(q, k=10, keys=True))
                answers.append(client.search_async(q[:2], k=100).result(timeout=120))
    finally:
        with Client(sock) as client:
            client.shutdown_server()
    thread.join(timeout=60)
    assert not thread.is_alive()
    assert isinstance(result["server"].batcher.index, TS.BinaryIndex)
    want10, want100 = tidx.search(q, k=10), tidx.search(q[:2], k=100)
    for (vals, idxs, hit_keys), (v100, i100) in (answers[:2], answers[2:]):
        np.testing.assert_array_equal(vals, want10[0])
        np.testing.assert_array_equal(idxs, want10[1])
        assert hit_keys == tidx.lookup(want10[1])
        np.testing.assert_array_equal(v100, want100[0])
        np.testing.assert_array_equal(i100, want100[1])


@pytest.mark.parametrize("kind", ["pq", "ivf"])
def test_serve_compressed_index_to_both_clients(data, kind, tmp_path):
    """``python -m dirjax_torch.serve`` over a PQ or IVF index file: a dirjax
    Client and the port's Client get the port's direct answers, per-request
    options (AQE, nprobe) included."""
    from dirjax.server import Client as JClient
    from dirjax_torch.serve import main as serve_main

    db, q, keys = data
    if kind == "pq":
        index = TS.PQIndex(db, m=8, ksub=16, keys=keys, rerank=True, train_iters=4,
                           device="cpu")
        opts = {"aqe": AQE}
    else:
        index = TS.IVFPQIndex(db, nlist=8, m=8, ksub=16, keys=keys, nprobe=2,
                              train_iters=4, device="cpu")
        opts = {"nprobe": 5}
    index.save(str(tmp_path / "c.npz"))
    sock = str(tmp_path / "c.sock")
    result = {}
    thread = threading.Thread(target=lambda: result.setdefault("server", serve_main(
        ["--index", str(tmp_path / "c.npz"), "--socket", sock, "--gpu", "-1",
         "--max-wait-ms", "1"])), daemon=True)
    thread.start()
    answers = []
    try:
        for client_cls in (JClient, Client):
            with client_cls(sock, connect_timeout=60) as client:
                answers.append(client.search(q, k=10, keys=True))
                answers.append(client.search_async(q[:2], k=30, **opts).result(timeout=120))
    finally:
        with Client(sock) as client:
            client.shutdown_server()
    thread.join(timeout=60)
    assert not thread.is_alive()
    served = TS.RetrievalIndex.load(str(tmp_path / "c.npz"), device="cpu")
    assert type(result["server"].batcher.index) is type(index) is type(served)
    want10, want30 = served.search(q, k=10), served.search(q[:2], k=30, **opts)
    for (vals, idxs, hit_keys), (v30, i30) in (answers[:2], answers[2:]):
        np.testing.assert_array_equal(vals, want10[0])
        np.testing.assert_array_equal(idxs, want10[1])
        assert hit_keys == served.lookup(want10[1])
        np.testing.assert_array_equal(v30, want30[0])
        np.testing.assert_array_equal(i30, want30[1])


class TestUploadBf16:
    """The batcher's ``upload_bf16`` (counterparts of dirjax's
    ``tests/test_server.py`` and ``tests/test_round5_fixes.py`` upload
    tests): each batch reaches the index as a CPU torch.bfloat16 tensor,
    which the index casts as its tier needs. Tolerances as dirjax's: a bf16
    index answers exactly as with fp32 upload (values within rtol 1e-6,
    indices equal); PQ stays within its quantization noise (0.02); every
    tier answers as its direct search over the bf16-rounded queries,
    exactly."""

    @staticmethod
    def _unit_rows(seed, n, d=32):
        x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
        return x / np.linalg.norm(x, axis=1, keepdims=True)

    def test_upload_bf16_matches_f32_on_bf16_index(self):
        x = self._unit_rows(3, 128)
        index = TS.RetrievalIndex(x, dtype=torch.bfloat16, device="cpu")
        plain = DynamicBatcher(index, max_batch=8, max_wait_ms=0.0)
        bf16 = DynamicBatcher(index, max_batch=8, max_wait_ms=0.0, upload_bf16=True)
        try:
            bf16.warmup(k=5)
            q = x[:4] + 0.01 * np.random.default_rng(3).standard_normal((4, 32)).astype(np.float32)
            v1, i1 = plain.search(q, k=5)
            v2, i2 = bf16.search(q, k=5)
        finally:
            plain.close()
            bf16.close()
        np.testing.assert_array_equal(i1, i2)
        np.testing.assert_allclose(v1, v2, rtol=1e-6)

    def test_upload_bf16_pq_close_to_f32(self):
        x = self._unit_rows(4, 400)
        index = TS.PQIndex(x, m=4, ksub=16, train_iters=5, device="cpu")
        plain = DynamicBatcher(index, max_batch=8, max_wait_ms=0.0)
        bf16 = DynamicBatcher(index, max_batch=8, max_wait_ms=0.0, upload_bf16=True)
        try:
            v1, _ = plain.search(x[:4], k=5)
            v2, _ = bf16.search(x[:4], k=5)
        finally:
            plain.close()
            bf16.close()
        np.testing.assert_allclose(v1, v2, rtol=0.02, atol=0.02)

    @pytest.mark.parametrize("tier", ["fp32", "int8", "int8_queries", "binary", "pq", "ivf"])
    def test_each_tier_casts_the_bf16_queries(self, tier):
        """An fp32 index widens the bf16 values; int8 (with int8 queries
        too), binary, PQ and IVF quantize from them. So the served answer
        equals the direct search over the queries rounded to bf16, and
        dirjax's batcher, whose batches are ml_dtypes.bfloat16 arrays, gets
        the same answer from the port's index."""
        from dirjax.server import DynamicBatcher as JBatcher

        x = self._unit_rows(5, 300)
        opts = {"int8_queries": True} if tier == "int8_queries" else {}
        index = {"fp32": lambda: TS.RetrievalIndex(x, device="cpu"),
                 "int8": lambda: TS.RetrievalIndex(x, dtype=torch.int8, device="cpu"),
                 "int8_queries": lambda: TS.RetrievalIndex(x, dtype=torch.int8, device="cpu"),
                 "binary": lambda: TS.BinaryIndex(x, 32, itq_iters=3, device="cpu"),
                 "pq": lambda: TS.PQIndex(x, m=4, ksub=16, train_iters=3, device="cpu"),
                 "ivf": lambda: TS.IVFPQIndex(x, nlist=4, m=4, ksub=16, train_iters=3,
                                              nprobe=2, device="cpu")}[tier]()
        q = x[:5] + 0.05 * self._unit_rows(6, 5)
        rounded = torch.from_numpy(q).bfloat16().float().numpy()
        want = index.search(rounded, k=7, **opts)
        with pytest.warns(UserWarning, match="fp32 dense") if tier == "fp32" \
                else warnings.catch_warnings():
            ours = DynamicBatcher(index, max_batch=8, max_wait_ms=0.0, upload_bf16=True)
        theirs = JBatcher(index, max_batch=8, max_wait_ms=0.0, upload_bf16=True)
        try:
            got = [ours.search(q, k=7, **opts), theirs.search(q, k=7, **opts)]
        finally:
            ours.close()
            theirs.close()
        for vals, idxs in got:
            np.testing.assert_array_equal(vals, want[0])
            np.testing.assert_array_equal(idxs, want[1])

    def test_warns_on_fp32_dense_index(self):
        index = TS.RetrievalIndex(self._unit_rows(0, 64), device="cpu")
        assert index.dtype == torch.float32
        with pytest.warns(UserWarning, match="fp32 dense"):
            b = DynamicBatcher(index, upload_bf16=True)
        b.close()

    def test_silent_on_bf16_index(self):
        index = TS.RetrievalIndex(self._unit_rows(0, 32, 16), dtype=torch.bfloat16,
                                  device="cpu")
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            b = DynamicBatcher(index, upload_bf16=True)
        b.close()

    def test_serve_main_takes_upload_bf16(self, tmp_path):
        """``python -m dirjax_torch.serve --upload-bf16`` hands the flag to
        its batcher, and a client's answer equals the direct search."""
        from dirjax_torch.serve import build_parser, main as serve_main

        assert build_parser().parse_args(
            ["--index", "i.npz", "--socket", "s", "--upload-bf16"]).upload_bf16
        assert not build_parser().parse_args(["--index", "i.npz", "--socket", "s"]).upload_bf16
        x = self._unit_rows(7, 200)
        TS.RetrievalIndex(x, dtype=torch.int8, device="cpu").save(str(tmp_path / "b.npz"))
        sock = str(tmp_path / "b.sock")
        result = {}
        thread = threading.Thread(target=lambda: result.setdefault("server", serve_main(
            ["--index", str(tmp_path / "b.npz"), "--socket", sock, "--gpu", "-1",
             "--max-wait-ms", "1", "--upload-bf16", "--warmup-k", "5"])), daemon=True)
        thread.start()
        try:
            with Client(sock, connect_timeout=60) as client:
                vals, idxs = client.search(x[:3], k=5)
        finally:
            with Client(sock) as client:
                client.shutdown_server()
        thread.join(timeout=60)
        assert not thread.is_alive() and result["server"].batcher.upload_bf16
        served = TS.RetrievalIndex.load(str(tmp_path / "b.npz"), device="cpu")
        want = served.search(torch.from_numpy(x[:3]).bfloat16(), k=5)
        np.testing.assert_array_equal(vals, want[0])
        np.testing.assert_array_equal(idxs, want[1])

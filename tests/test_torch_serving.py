"""dirjax_torch's serving path held against dirjax's on the same numpy inputs
(CPU): RetrievalIndex in fp32, bf16 and int8 (search with and without
int8_queries and AQE, tombstones, add, compact, lookup), the chunked and
quantized query expansion, index files across the two packages,
dirjax.server's batcher and socket server over the port's index, and the
index CLI.

dirjax's CPU search ranks densely; the port takes its kernels' route with
their plain versions. Tolerances: scores within rtol 1e-5 / atol 1e-5 (fp32
sums of exact products in another order), indices and keys identical (the
inputs are random, so no two scores tie). Served answers equal the port's
direct search exactly: the same code ranks them.
"""

import json
import os
import subprocess
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dirjax.serving as JS
from dirjax.cli.index import main as jindex
from dirjax.ops import qe as jqe
from dirjax.ops import topk_pallas as jtopk
from dirjax_torch import serving as TS
from dirjax_torch.cli.index import main as tindex
from dirjax_torch.ops import qe as tqe
from dirjax_torch.ops import topk as ttopk
from dirjax_torch.serve import Client, DynamicBatcher, IndexServer

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
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
            TS.RetrievalIndex(db, keys=keys, dtype=tdt))


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
    fresh = TS.RetrievalIndex(data[0][keep], dtype=DTYPES[mode][1])
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
    t_from_j = TS.RetrievalIndex.load(str(tmp_path / "j.npz"))
    j_from_t = JS.RetrievalIndex.load(str(tmp_path / "t.npz"))
    assert t_from_j.n_removed == 30 and t_from_j.dtype == (
        torch.int8 if mode == "int8" else torch.float32)
    q = data[1]
    _same(t_from_j.search(q, k=15, aqe=AQE), j_from_t.search(q, k=15, aqe=AQE))
    bf = TS.RetrievalIndex.load(str(tmp_path / "j.npz"), dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16 and bf.n_removed == 30


def test_load_refuses_compressed_archives(tmp_path):
    path = str(tmp_path / "pq.npz")
    np.savez(path, pq_codes=np.zeros((4, 2), np.uint8))
    with pytest.raises(NotImplementedError, match="M9-M11"):
        TS.RetrievalIndex.load(path)


def test_batcher_and_server_over_port_index(data, tmp_path):
    """dirjax.server's DynamicBatcher (pipelined) and IndexServer + Client,
    unchanged, over the port's int8 index: concurrent answers equal direct
    search."""
    db, _, keys = data
    index = TS.RetrievalIndex(db, keys=keys, dtype=torch.int8)
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
    want = TS.RetrievalIndex.load(str(tmp_path / "i.npz")).search(q, k=10)
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
    (["build", "--descs", "x.npy", "--out", "y.npz", "--binary", "256"], "M9"),
    (["build", "--descs", "x.npy", "--out", "y.npz", "--ivf", "64"], "M11"),
    (["tune", "--index", "y.npz"], "M11")])
def test_cli_names_roadmap_item_of_unported_kinds(argv, item, tmp_path):
    np.save(tmp_path / "x.npy", np.zeros((4, 8), np.float32))
    argv = [str(tmp_path / a) if a.endswith((".npy", ".npz")) else a for a in argv]
    with pytest.raises(SystemExit, match=item):
        tindex(argv + (["--gpu", "-1"] if argv[0] == "build" else []))

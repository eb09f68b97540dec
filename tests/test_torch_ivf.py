"""dirjax_torch's inverted file (ops/ivf.py), IVFPQIndex and recall tuning
held against dirjax's on the same numpy inputs (CPU). dirjax's K6 runs as its
own tests run it (``ivf_topk(union=True)`` and ``pq_topk(use_pallas=True)``);
the port takes its kernels' route with their plain versions.

Trained state crosses between the packages: an inverted file through
``ivf_arrays_from_jax``, an index through its ``.npz`` file (the two draw
different random samples from the same seed). Tolerances: values within 1e-5
(fp32; the same table entries summed in another order) and 1e-4 (bf16
tables); the index sets equal wherever the k-th/(k+1)-th margin exceeds
1e-3; binning arrays and tuned knobs exactly equal.
"""

import json
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dirjax import serving as JS
from dirjax import tuning as JT
from dirjax.cli.index import main as jindex
from dirjax.ops import ivf as JI
from dirjax.ops import pq as JP
from dirjax_torch import serving as TS
from dirjax_torch import tuning as TT
from dirjax_torch.cli.index import main as tindex
from dirjax_torch.ops import ivf as TI
from dirjax_torch.ops import pq as TP
from dirjax_torch.utils.checkpoints import ivf_arrays_from_jax

torch.set_num_threads(1)

D, N, NQ, NLIST = 32, 3001, 6, 16
MARGIN = 1e-3
AQE = {"k": 5, "alpha": 3.0}
REPO = __file__.rsplit("/tests/", 1)[0]


def _clustered(rng, n, d=D, centers=24):
    """Unit rows around a few centres (cells with real structure)."""
    c = rng.normal(size=(centers, d))
    x = c[rng.integers(0, centers, n)] + 0.35 * rng.normal(size=(n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    """dirjax's inverted file over clustered rows, and its port."""
    rng = np.random.default_rng(0)
    x, q = _clustered(rng, N), _clustered(rng, NQ)
    jivf, jc, jcb = JI.build_ivf(x, NLIST, m=4, ksub=16, pq_iters=6, coarse_iters=6)
    return x, q, jivf, jc, jcb, ivf_arrays_from_jax(jivf), torch.from_numpy(np.asarray(jcb))


def _same_topk(got, want, scores, atol=1e-5):
    """Values within ``atol``; each returned row carries its plain score;
    the rows above the k-th score by MARGIN are the same rows."""
    (gv, gi), (wv, wi) = (tuple(np.asarray(a) for a in p) for p in (got, want))
    assert gv.shape == wv.shape and gv.dtype == np.float32
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    live = gi >= 0
    np.testing.assert_array_equal(live, wi >= 0)
    np.testing.assert_allclose(np.take_along_axis(scores, np.maximum(gi, 0), 1)[live],
                               gv[live], rtol=0, atol=atol)
    for r in range(len(gv)):
        kth = wv[r, live[r]][-1] if live[r].any() else np.inf
        assert set(gi[r][gv[r] > kth + MARGIN]) == set(wi[r][wv[r] > kth + MARGIN])


def _dense_scores(ivf, luts, q, n):
    """Dense ADC over reconstructions: ``q . centroid[cell(i)] + luts[codes[i]]``,
    the rows in original order."""
    assign, codes = TI.unbin_ivf(ivf, n)
    cv = ivf.centroids_v[torch.from_numpy(
        np.searchsorted(ivf.cell_of_v.numpy(), assign))]        # a virtual cell of each row
    bias = (torch.from_numpy(q).double() @ cv.double().T).float()
    return (bias + TP.adc_finemax_reference(luts, torch.from_numpy(codes), 1)).numpy()


# --- ops --------------------------------------------------------------------

def test_bin_unbin_identical_to_dirjax(built):
    x, _, jivf, jc, _, tivf, _ = built
    a, c = JI.unbin_ivf(jivf, N)
    ta, tc = TI.unbin_ivf(tivf, N)
    np.testing.assert_array_equal(ta, a)
    np.testing.assert_array_equal(tc, c)
    for slab, cap in ((64, None), (16, 3)):
        want = JI.bin_ivf(a, c, np.asarray(jc), slab=slab, cap=cap)
        got = TI.bin_ivf(a, c, np.asarray(jc), slab=slab, cap=cap)
        for name, w, g in zip(want._fields, want, got):
            assert g.dtype == torch.from_numpy(np.asarray(w)).dtype, name
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # a slab's tail padding repeats its first row's codes (slab_rows -1)
    pad = tivf.slab_rows < 0
    assert pad.any()
    assert torch.equal(tivf.codes[pad], tivf.codes[:, :1].expand_as(tivf.codes)[pad])
    np.testing.assert_array_equal(TI.ivf_assign(x[:700], torch.from_numpy(np.asarray(jc))),
                                  JI.ivf_assign(x[:700], jc))
    assert TI.ivf_assign(x[:0], torch.from_numpy(np.asarray(jc))).shape == (0,)


@pytest.mark.parametrize("dt", [None, "bf16"])
@pytest.mark.parametrize("nprobe", [2, 5, 10_000], ids=["p2", "p5", "full"])
@pytest.mark.parametrize("union", [False, True], ids=["per-query", "union"])
def test_ivf_topk_matches_dirjax(built, union, nprobe, dt):
    _, q, jivf, _, jcb, tivf, tcb = built
    jl, tl = JP.pq_lookup(q, jcb), TP.pq_lookup(q, tcb)
    for k in (10, 70):
        want = JI.ivf_topk(jl, q, jivf, k, nprobe=nprobe, union=union,
                           compute_dtype=jnp.bfloat16 if dt else None)
        got = TI.ivf_topk(tl, q, tivf, k, nprobe=nprobe, union=union,
                          compute_dtype=torch.bfloat16 if dt else None)
        assert got[1].dtype == torch.int64 and got[0].shape == (NQ, k)
        lut = tl.to(torch.bfloat16).float() if dt else tl
        _same_topk(got, want, _dense_scores(tivf, lut, q, N), 1e-4 if dt else 1e-5)


def test_full_probe_is_dense_adc_and_union_agrees(built):
    """nprobe >= nvlist: per-query and union results are the dense ADC top-k
    over reconstructions, exactly (the same fp32 adds)."""
    _, q, _, _, _, tivf, tcb = built
    tl = TP.pq_lookup(q, tcb)
    scores = torch.from_numpy(_dense_scores(tivf, tl, q, N))
    want = torch.sort(scores, dim=1, descending=True, stable=True)
    for union in (False, True):
        vals, idxs = TI.ivf_topk(tl, q, tivf, 25, nprobe=tivf.nvlist, union=union)
        assert torch.equal(vals, want.values[:, :25])
        assert torch.equal(torch.gather(scores, 1, idxs), vals)
    vals, idxs = TI.ivf_topk(tl, q, tivf, N + 5, nprobe=tivf.nvlist)
    assert (idxs[:, N:] == -1).all() and torch.isinf(vals[:, N:]).all()
    assert set(idxs[0, :N].tolist()) == set(range(N))


def test_train_and_build_ivf_serve():
    """The port's own build (torch-seeded samples): every row is binned once,
    and rows find themselves in their top-5 about as often as in dirjax's
    build of the same rows (different random draws)."""
    rng = np.random.default_rng(3)
    x = _clustered(rng, 1500)
    ivf, cents, cb = TI.build_ivf(x, 8, m=4, ksub=16, pq_iters=4, coarse_iters=4, sample=1000)
    assert cents.shape == (8, D) and cb.shape == (4, 16, D // 4)
    rows = ivf.slab_rows[ivf.slab_rows >= 0]
    assert torch.equal(torch.sort(rows).values, torch.arange(1500, dtype=torch.int32))
    _, idxs = TI.ivf_topk(TP.pq_lookup(x[:200], cb), x[:200], ivf, 5, nprobe=ivf.nvlist)
    jivf, _, jcb = JI.build_ivf(x, 8, m=4, ksub=16, pq_iters=4, coarse_iters=4, sample=1000)
    _, ji = JI.ivf_topk(JP.pq_lookup(x[:200], jcb), x[:200], jivf, 5, nprobe=jivf.nvlist)
    hit = lambda i: (np.asarray(i) == np.arange(200)[:, None]).any(1).mean()  # noqa: E731
    assert hit(idxs) >= hit(ji) - 0.1
    with pytest.raises(ValueError, match="nlist"):
        TI.train_ivf(x[:5], 8)


# --- IVFPQIndex -------------------------------------------------------------

@pytest.fixture(scope="module")
def index_file(built, tmp_path_factory):
    """A keyed dirjax IVFPQIndex with int8 rerank rows, saved once."""
    x = built[0]
    keys = [f"img{i:05d}" for i in range(N)]
    path = str(tmp_path_factory.mktemp("ivf") / "j.npz")
    JS.IVFPQIndex(x, nlist=NLIST, m=4, ksub=16, nprobe=3, keys=keys, rerank=True,
                  train_iters=6).save(path)
    return path, keys


def _pair(index_file):
    path = index_file[0]
    return JS.RetrievalIndex.load(path), TS.RetrievalIndex.load(path, device="cpu")


def _exact_scores(tidx, q):
    rows = tidx._rerank_db.float() * tidx._rerank_scales.reshape(-1, 1)
    return (torch.as_tensor(q) @ rows.T).numpy()


def _ivf_scores(tidx, q):
    return _dense_scores(tidx._ivf, TP.pq_lookup(q, tidx.codebooks), np.asarray(q), tidx.n)


def test_ivf_index_search_matches_dirjax(built, index_file):
    jidx, tidx = _pair(index_file)
    assert isinstance(tidx, TS.IVFPQIndex) and tidx.nprobe == 3 and tidx.nlist == NLIST
    q = built[1]
    for k, opts in ((10, {}), (40, {"nprobe": 6}), (10, {"rerank_factor": 2}),
                    (10, {"nprobe": 10_000})):
        got, want = tidx.search(q, k=k, **opts), jidx.search(q, k=k, **opts)
        assert got[1].dtype == np.int32
        _same_topk(got, want, _exact_scores(tidx, q))
    tidx._rerank_db = jidx._rerank_db = None        # ADC scores only
    _same_topk(tidx.search(q, k=10), jidx.search(q, k=10), _ivf_scores(tidx, q))


def test_ivf_index_aqe_remove_add_compact_match_dirjax(built, index_file):
    jidx, tidx = _pair(index_file)
    q, keys = built[1], index_file[1]

    def same(k, **opts):
        got, want = tidx.search(q2, k=k, **opts), jidx.search(q2, k=k, **opts)
        qq = tidx._queries(q2)
        if "aqe" in opts:
            qq = tidx._expand_queries(qq, AQE["k"], AQE["alpha"], opts.get("nprobe", 3))
        _same_topk(got, want, _exact_scores(tidx, qq))
        return got

    q2 = q
    same(10, aqe=AQE)
    _, hits = tidx.search(q, k=10)
    gone = np.unique(hits[:, :3])
    assert jidx.remove(indices=gone) == tidx.remove(indices=gone) == len(gone)
    got = same(10, aqe=AQE, nprobe=5)
    assert not np.isin(got[1], gone).any()
    extra = _clustered(np.random.default_rng(8), 50)
    new_keys = [f"new{i}" for i in range(50)]
    jidx.add(extra, keys=new_keys)
    tidx.add(extra, keys=new_keys)
    assert tidx.n == jidx.n == N + 50
    for a, b in zip(TI.unbin_ivf(tidx._ivf, tidx.n), JI.unbin_ivf(jidx._ivf, jidx.n)):
        np.testing.assert_array_equal(a, b)
    drop = keys[5:60:3] + new_keys[::7]
    assert jidx.remove(keys=drop) == tidx.remove(keys=drop)
    np.testing.assert_array_equal(tidx.compact(), jidx.compact())
    assert tidx.n_removed == 0 and tidx.n == jidx.n
    q2 = np.concatenate([q, extra[:2]])
    got = same(20, nprobe=4)
    assert tidx.lookup(got[1][:, :1]) == jidx.lookup(jidx.search(q2, k=20, nprobe=4)[1][:, :1])
    same(10, aqe=AQE)


def test_ivf_files_cross_between_packages(built, index_file, tmp_path):
    jidx, tidx = _pair(index_file)
    for idx in (jidx, tidx):
        idx.remove(keys=index_file[1][:30])
    jidx.save(str(tmp_path / "j.npz"))
    tidx.save(str(tmp_path / "t.npz"))
    with np.load(tmp_path / "j.npz") as jf, np.load(tmp_path / "t.npz") as tf:
        assert sorted(jf.files) == sorted(tf.files)
        for name in jf.files:
            assert jf[name].dtype == tf[name].dtype, name
            np.testing.assert_array_equal(jf[name], tf[name])
    j_from_t = JS.RetrievalIndex.load(str(tmp_path / "t.npz"))
    t_again = TS.RetrievalIndex.load(str(tmp_path / "t.npz"), device="cpu")
    assert isinstance(j_from_t, JS.IVFPQIndex) and t_again.n_removed == 30
    q = built[1]
    _same_topk(t_again.search(q, k=15, nprobe=5), j_from_t.search(q, k=15, nprobe=5),
               _exact_scores(t_again, q))


def test_port_builds_opq_ivf_index():
    rng = np.random.default_rng(4)
    x = _clustered(rng, 1200)
    idx = TS.IVFPQIndex(x, nlist=8, m=4, ksub=16, opq=True, train_iters=4, device="cpu")
    r = idx.rotation
    torch.testing.assert_close(r @ r.T, torch.eye(D), rtol=0, atol=1e-5)
    vals, hits = idx.search(x[:10], k=3, nprobe=idx._ivf.nvlist)
    qr = idx._rotate_queries(torch.from_numpy(x[:10])).numpy()
    scores = _dense_scores(idx._ivf, TP.pq_lookup(qr, idx.codebooks), qr, idx.n)
    np.testing.assert_array_equal(vals, -np.sort(-scores, axis=1)[:, :3])
    np.testing.assert_array_equal(np.take_along_axis(scores, hits, 1), vals)


# --- tuning -----------------------------------------------------------------

def test_tune_gives_dirjax_params(built, index_file):
    """The same index file tuned by both packages: the same knobs, recall
    and trials (IVF: nprobe x rerank_factor; PQ: rerank_factor)."""
    x, q = built[0], built[1]
    jidx, tidx = _pair(index_file)
    gt = JT.exact_ground_truth(q, x, 10)
    np.testing.assert_array_equal(TT.exact_ground_truth(q, x, 10), gt)
    for target in (0.5, 0.99):
        want = JT.tune(jidx, q, gt, k=10, target=target, rerank_factors=(1, 4))
        got = TT.tune(tidx, q, descriptors=x, k=10, target=target, rerank_factors=(1, 4))
        assert (got.params, got.met, got.recall) == (want.params, want.met, want.recall)
        assert got.trials == want.trials
    got.apply(tidx)
    assert tidx.nprobe == got.params["nprobe"]
    pq = TS.PQIndex(x, m=4, ksub=16, rerank=True, train_iters=4, device="cpu")
    res = TT.tune(pq, q, gt, k=10, target=0.999)
    assert [p for p, _ in res.trials][0] == {"rerank_factor": 1}
    binary = TS.BinaryIndex(x, 32, itq_iters=2, device="cpu")
    assert TT.tune(binary, q, gt, k=10, target=0.1).trials[0][0] == {}


def test_ivf_and_tune_cli_match_dirjax(built, index_file, tmp_path):
    """``build --ivf`` through the port's CLI answers as the in-process
    index; dirjax's file queried and tuned by both CLIs (the port's query as
    ``python -m dirjax_torch.index --gpu -1``) gives dirjax's answers."""
    x, q = built[0], built[1]
    np.save(tmp_path / "db.npy", x)
    np.save(tmp_path / "q.npy", q)
    cpu = ["--gpu", "-1"]
    jpath = index_file[0]
    query = ["query", "--descs", str(tmp_path / "q.npy"), "-k", "12", "--nprobe", "5"]
    out = subprocess.run(
        [sys.executable, "-m", "dirjax_torch.index", *query, "--index", jpath,
         "--out-json", str(tmp_path / "t.json"), *cpu],
        capture_output=True, text=True, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    jindex(query + ["--index", jpath, "--out-json", str(tmp_path / "j.json")] + cpu)
    got, want = (json.loads((tmp_path / f).read_text()) for f in ("t.json", "j.json"))
    tidx = TS.RetrievalIndex.load(jpath, device="cpu")
    _same_topk(*((np.asarray(a["scores"], np.float32), np.asarray(a["indices"]))
                 for a in (got, want)), _exact_scores(tidx, q))
    assert got["keys"] == tidx.lookup(got["indices"])

    tune = ["tune", "--descs", str(tmp_path / "q.npy"), "--db-descs", str(tmp_path / "db.npy"),
            "--target", "0.6"]
    for name, main in (("j", jindex), ("t", tindex)):
        path = str(tmp_path / f"{name}_tuned.npz")
        TS.RetrievalIndex.load(jpath, device="cpu").save(path)
        res = main(tune + ["--index", path, "--apply"] + cpu)
        assert res.met and TS.RetrievalIndex.load(path, device="cpu").nprobe == \
            res.params["nprobe"]
        if name == "j":
            want = res
    assert (res.params, res.recall) == (want.params, want.recall)

    tindex(["build", "--descs", str(tmp_path / "db.npy"), "--ivf", "8", "--pq", "4",
            "--nprobe", "2", "--out", str(tmp_path / "own.npz")] + cpu)
    own = tindex(query + ["--index", str(tmp_path / "own.npz"), "--aqe", "3", "3",
                          "--adc-bf16"] + cpu)
    idx = TS.RetrievalIndex.load(str(tmp_path / "own.npz"), device="cpu")
    assert isinstance(idx, TS.IVFPQIndex) and idx.nprobe == 2 and idx.m == 4
    idx.compute_dtype = torch.bfloat16
    vals, idxs = idx.search(q, k=12, nprobe=5, aqe={"k": 3, "alpha": 3.0})
    assert own["indices"] == idxs.tolist() and own["scores"] == vals.tolist()

"""dirjax_torch.parallel held against dirjax.parallel on the CPU: the mesh,
the four sharded ranking tiers with their scores and AQE, and sharded
extraction.

Multi-rank runs are one world of 4 gloo ranks (``test_torch_dist_worker``)
whose cases every test below reads; dirjax computes the same functions on
conftest's virtual devices (``make_mesh(1, 4, devices=jax.devices()[:4])``).
World-1 cases run in-process over a FileStore. Inputs are seeded numpy
arrays. Tolerances: dense fp32 and int8 ids exact, values within 1e-5; bf16
values within 1e-2 and top-k overlap >= 0.9; binary symmetric values exact
(integers; Hamming ties may order ids differently, so values are compared),
asymmetric rescores within rtol 1e-5; PQ values within 1e-5, ids through
their dense scores; IVF at full probe values 2e-4 (dirjax's own bound) and
ids exact; scores 1e-5; AQE rtol 1e-4 / atol 1e-5; extraction rtol 1e-4 /
atol 1e-5. At world 1 every tier equals the port's single-chip function bit
for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import dirjax.parallel as jpar
from dirjax.parallel import ranking as jrank
from test_torch_dist_worker import run_world

from dirjax_torch import parallel as par

torch.set_num_threads(1)
WORLD = 4


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _rand_codes(rng, n, w):
    return rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint64).astype(np.uint32)


def _clustered(rng, n, d, centers=8, noise=0.3):
    c = rng.standard_normal((centers, d)).astype(np.float32)
    x = c[rng.integers(0, centers, n)] + noise * rng.standard_normal((n, d))
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _ivf_arrays(n, nlist, seed, clustered):
    from dirjax.ops.ivf import build_ivf
    from dirjax.ops.pq import pq_lookup

    rng = np.random.default_rng(seed)
    x = _clustered(rng, n, 32, nlist, 0.15) if clustered else _unit(rng, n, 32)
    ivf, _, books = build_ivf(x, nlist, 4, 8, slab=16, coarse_iters=8, pq_iters=6,
                              seed=seed, sample=None)
    q = x[:6] if clustered else rng.standard_normal((5, 32)).astype(np.float32)
    arrays = {f: np.asarray(getattr(ivf, f)) for f in ivf._fields}
    arrays.update(luts=np.asarray(pq_lookup(q, books)), q=q)
    return x, ivf, arrays


@pytest.fixture(scope="module")
def jmesh():
    return jpar.make_mesh(data=1, db=WORLD, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def world(tmp_path_factory, jmesh):
    """Every multi-rank case of this file in one world of 4 ranks; returns
    (inputs, {case name: outputs})."""
    from dirjax_torch.datasets import Synthetic
    from dirjax_torch.models import create_model, init_weights

    rng = np.random.default_rng(0)
    inp = {"db101": rng.standard_normal((101, 64)).astype(np.float32),
           "q6": rng.standard_normal((6, 64)).astype(np.float32),
           "u101": _unit(rng, 101, 64), "uq6": _unit(rng, 6, 64),
           "db3": rng.standard_normal((3, 64)).astype(np.float32),
           "db10": rng.standard_normal((10, 64)).astype(np.float32),
           "db5": rng.standard_normal((5, 64)).astype(np.float32),
           "aqe_db": _unit(rng, 64, 32), "aqe_q": _unit(rng, 4, 32),
           "pq_codes": rng.integers(0, 16, size=(300, 8)).astype(np.uint8),
           "pq_luts": rng.standard_normal((5, 8, 16)).astype(np.float32),
           "bits": _rand_codes(rng, 999, 2), "bits_q": _rand_codes(rng, 5, 2)}
    inp["u101q"] = inp["u101"][:6]
    excl = np.zeros(64, bool)
    excl[[0, 5, 17]] = True
    inp["aqe_excl"] = excl
    cl = _clustered(rng, 800, 256)
    inp["cl_db"], inp["cl_q"] = cl, cl[:6] + 0.05 * rng.standard_normal((6, 256)).astype(
        np.float32)
    from dirjax.ops.binary import binarize, fit_itq, project_queries

    codec = fit_itq(cl, iters=3, sample=None)
    inp["cl_codes"] = np.asarray(binarize(cl, codec))
    inp["cl_qp"] = np.asarray(binarize(jnp.asarray(inp["cl_q"]), codec))
    inp["cl_vq"] = np.asarray(project_queries(inp["cl_q"], codec))
    for tag, (n, nlist, seed, clu) in {"ivf_full": (800, 8, 31, False),
                                       "ivf_part": (900, 8, 35, True)}.items():
        _, _, arrays = _ivf_arrays(n, nlist, seed, clu)
        inp.update({f"{tag}/{k}": v for k, v in arrays.items()})
    model = init_weights(create_model("resnet18_rmac", out_dim=64),
                         torch.Generator().manual_seed(0))
    inp.update({f"r18/{k}": v.numpy() for k, v in model.state_dict().items()})
    inp["imgs"] = rng.normal(size=(5, 64, 64, 3)).astype(np.float32)
    inp["imgs_u8"] = rng.integers(0, 255, size=(3, 64, 64, 3), dtype=np.uint8)
    root = str(tmp_path_factory.mktemp("synth"))
    Synthetic(root, revisited=True)          # made once, before the ranks read it

    mesh = [1, WORLD]
    cases = {
        "meshes": ("meshes", {}),
        "multihost": ("multihost", {"db": "u101", "q": "u101q", "k": 4}),
        "fp32": ("topk", {"mesh": mesh, "db": "db101", "q": "q6", "k": 7}),
        "fp32_n3": ("topk", {"mesh": mesh, "db": "db3", "q": "q6", "k": 2}),
        "fp32_n10_k8": ("topk", {"mesh": mesh, "db": "db10", "q": "q6", "k": 8}),
        "fp32_n5_k8": ("topk", {"mesh": mesh, "db": "db5", "q": "q6", "k": 8}),
        "bf16": ("topk", {"mesh": mesh, "db": "db101", "q": "q6", "k": 7, "mode": "bf16"}),
        "int8": ("topk", {"mesh": mesh, "db": "u101", "q": "uq6", "k": 7, "mode": "int8"}),
        "int8q": ("topk", {"mesh": mesh, "db": "u101", "q": "uq6", "k": 7, "mode": "int8q"}),
        "scores": ("scores", {"mesh": mesh, "db": "db101", "q": "q6"}),
        "aqe": ("aqe", {"mesh": mesh, "db": "aqe_db", "q": "aqe_q", "k": 5, "alpha": 3.0}),
        "aqe_int8": ("aqe", {"mesh": mesh, "db": "aqe_db", "q": "aqe_q", "k": 5,
                             "alpha": 3.0, "mode": "int8"}),
        "aqe_excl": ("aqe", {"mesh": mesh, "db": "aqe_db", "q": "aqe_q", "k": 5,
                             "alpha": 3.0, "exclude": "aqe_excl", "pad": 64}),
        "pq": ("pq", {"mesh": mesh, "codes": "pq_codes", "luts": "pq_luts", "k": 9}),
        "ivf_full": ("ivf", {"mesh": mesh, "prefix": "ivf_full", "k": 15, "nprobe": 64}),
        "ivf_part": ("ivf", {"mesh": mesh, "prefix": "ivf_part", "k": 10, "nprobe": 8}),
        "ham": ("hamming", {"mesh": mesh, "codes": "bits", "q": "bits_q", "k": 12}),
        "ham_vq100": ("hamming", {"mesh": mesh, "codes": "cl_codes", "q": "cl_qp", "k": 10,
                                  "vq": "cl_vq", "rerank_factor": 100}),
        "ham_vq4": ("hamming", {"mesh": mesh, "codes": "cl_codes", "q": "cl_qp", "k": 10,
                                "vq": "cl_vq", "rerank_factor": 4}),
        "extract": ("extract", {"mesh": [WORLD, 1], "model": "r18", "arch": "resnet18_rmac",
                                "out_dim": 64, "images": "imgs", "images_u8": "imgs_u8"}),
        "eval": ("eval_model", {"mesh": [WORLD, 1], "model": "r18", "arch": "resnet18_rmac",
                                "out_dim": 64, "root": root}),
    }
    names = list(cases)
    outs = run_world(str(tmp_path_factory.mktemp("world")), WORLD,
                     [list(cases[n]) for n in names], inp)
    return inp, dict(zip(names, outs))


# --- mesh -------------------------------------------------------------------

def test_meshes(world):
    out = world[1]["meshes"]
    assert out["default"].tolist() == [WORLD, 1]
    assert out["two_d"].tolist() == [2, 2]
    assert str(out["bad"]).startswith("AssertionError: 3x3 != 4")


def test_multihost_mesh_layout(world):
    """Two ranks a host: "db" rows hold one host's ranks in order, and the
    sharded top-k on that mesh equals the plain (2, 2) mesh's."""
    out = world[1]["multihost"]
    assert out["shape"].tolist() == [2, 2]
    assert out["mesh"].tolist() == [[0, 1], [2, 3]]
    np.testing.assert_array_equal(out["ids"], out["ids_2d"])
    np.testing.assert_array_equal(out["ids"][:, 0], np.arange(6))   # rows find themselves


class _Dev:
    def __init__(self, process_index, id):
        self.process_index, self.id = process_index, id


def test_multihost_layout_groups_hosts():
    """The pure layout logic (dirjax's ``multihost_layout``): ranks grouped
    by host and ordered by id, rows never straddling hosts."""
    devs = [_Dev(p, i) for i, p in [(5, 1), (0, 0), (4, 1), (1, 0), (3, 0), (2, 0),
                                    (7, 1), (6, 1)]]
    ours = par.multihost_layout(devs, 4)
    from dirjax.parallel.mesh import multihost_layout

    theirs = multihost_layout(devs, 4)
    assert [[d.id for d in r] for r in ours] == [[d.id for d in r] for r in theirs] \
        == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(AssertionError):
        par.multihost_layout(devs, 3)
    with pytest.raises(AssertionError):    # a row of 2 would straddle two hosts
        par.multihost_layout([_Dev(0, 0), _Dev(0, 1), _Dev(0, 2), _Dev(1, 3)], 2)


# --- dense tiers --------------------------------------------------------------

@pytest.mark.parametrize("name,db,k", [("fp32", "db101", 7), ("fp32_n3", "db3", 2),
                                       ("fp32_n10_k8", "db10", 8), ("fp32_n5_k8", "db5", 8)])
def test_sharded_topk_fp32(world, jmesh, name, db, k):
    """A ragged tail (101 rows on 4 ranks), n < world, k > a rank's rows
    and k > n (-inf / -1 columns): ids exact, values within 1e-5."""
    inp, outs = world
    sh, n = jpar.shard_database(inp[db], jmesh)
    v, i = jpar.sharded_topk(jnp.asarray(inp["q6"]), sh, k, jmesh, n)
    got = outs[name]
    assert got["ids"].shape == np.asarray(i).shape
    np.testing.assert_array_equal(got["ids"], np.asarray(i))
    np.testing.assert_allclose(got["vals"], np.asarray(v), atol=1e-5)


def test_sharded_topk_bf16(world, jmesh):
    inp, outs = world
    sh, n = jpar.shard_database(jnp.asarray(inp["db101"], jnp.bfloat16), jmesh)
    v, i = jpar.sharded_topk(jnp.asarray(inp["q6"], jnp.bfloat16), sh, 7, jmesh, n)
    got = outs["bf16"]
    np.testing.assert_allclose(got["vals"], np.asarray(v, np.float32), atol=1e-2)
    overlap = np.mean([len(set(a) & set(b)) / 7 for a, b in zip(got["ids"], np.asarray(i))])
    assert overlap >= 0.9


@pytest.mark.parametrize("mode", ["int8", "int8q"])
def test_sharded_topk_int8(world, jmesh, mode):
    """int8 rows with bf16 queries, and with quantized queries, whose scales
    multiply the values once."""
    inp, outs = world
    d8, s8, n = jpar.shard_database_quantized(inp["u101"], jmesh)
    v, i = jpar.sharded_topk(jnp.asarray(inp["uq6"]), d8, 7, jmesh, n, db_scales=s8,
                             quantize_queries=mode == "int8q")
    np.testing.assert_array_equal(outs[mode]["ids"], np.asarray(i))
    np.testing.assert_allclose(outs[mode]["vals"], np.asarray(v), atol=1e-5)


def test_sharded_scores(world, jmesh):
    inp, outs = world
    sh, n = jpar.shard_database(inp["db101"], jmesh)
    want = np.asarray(jpar.sharded_scores(jnp.asarray(inp["q6"]), sh, jmesh, n))
    np.testing.assert_allclose(outs["scores"]["scores"], want, atol=1e-5)
    np.testing.assert_allclose(want, inp["q6"] @ inp["db101"].T, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["aqe", "aqe_int8", "aqe_excl"])
def test_sharded_aqe(world, jmesh, name):
    """The neighbour rows come from their ranks (all_reduce of owned rows):
    fp32, int8 (dequantized by their rank) and with excluded rows."""
    inp, outs = world
    q = jnp.asarray(inp["aqe_q"])
    kw = {}
    if name == "aqe_excl":
        kw = {"exclude_mask": jnp.asarray(inp["aqe_excl"]), "exclude_pad": 64}
    if name == "aqe_int8":
        d8, s8, n = jpar.shard_database_quantized(inp["aqe_db"], jmesh)
        want = jpar.sharded_aqe(q, d8, jmesh, n, alpha=3.0, k=5, db_scales=s8)
    else:
        sh, n = jpar.shard_database(inp["aqe_db"], jmesh)
        want = jpar.sharded_aqe(q, sh, jmesh, n, alpha=3.0, k=5, **kw)
    np.testing.assert_allclose(outs[name]["expanded"], np.asarray(want), rtol=1e-4, atol=1e-5)


# --- compressed tiers -----------------------------------------------------------

def test_sharded_pq_topk(world, jmesh):
    inp, outs = world
    sh, n = jrank.shard_codes(inp["pq_codes"], jmesh)
    v, i = jrank.sharded_pq_topk(jnp.asarray(inp["pq_luts"]), sh, 9, jmesh, n)
    got = outs["pq"]
    np.testing.assert_allclose(got["vals"], np.asarray(v), atol=1e-5)
    dense = sum(inp["pq_luts"][:, j, inp["pq_codes"][:, j]] for j in range(8))
    np.testing.assert_allclose(np.take_along_axis(dense, got["ids"], axis=1), got["vals"],
                               atol=1e-5)


def _jax_ivf(inp, prefix):
    from dirjax.ops.ivf import IVFArrays

    return IVFArrays(**{f: jnp.asarray(inp[f"{prefix}/{f}"]) for f in IVFArrays._fields})


def test_sharded_ivf_full_probe(world, jmesh):
    """nprobe >= nvlist * ranks: every rank probes all its cells, so the
    candidates are the single-chip full probe's."""
    inp, outs = world
    from dirjax.ops.ivf import ivf_topk

    ivf = _jax_ivf(inp, "ivf_full")
    sh = jrank.shard_ivf(ivf, jmesh)
    v, i = jrank.sharded_ivf_topk(inp["ivf_full/luts"], inp["ivf_full/q"], sh, 15, jmesh,
                                  nprobe=64)
    v1, i1 = ivf_topk(inp["ivf_full/luts"], inp["ivf_full/q"], ivf, 15, nprobe=ivf.nvlist)
    got = outs["ivf_full"]
    np.testing.assert_allclose(got["vals"], np.asarray(v), atol=2e-4)
    np.testing.assert_array_equal(got["ids"], np.asarray(i))
    np.testing.assert_array_equal(got["ids"], np.asarray(i1))


def test_sharded_ivf_partition_and_partial_probe(world, jmesh):
    """dirjax's greedy grouping: the ranks' slabs cover every row once and
    each rank's table names only its own slabs; at nprobe 8 (2 a rank) the
    answer is dirjax's sharded one."""
    inp, outs = world
    got = outs["ivf_part"]
    rows = got["slab_rows"]
    assert sorted(rows[rows >= 0].tolist()) == list(range(900))
    for tab in got["vlist_tab"]:
        assert tab[tab >= 0].max(initial=-1) < int(got["local_slabs"][0])
    sh = jrank.shard_ivf(_jax_ivf(inp, "ivf_part"), jmesh)
    np.testing.assert_array_equal(np.sort(rows, axis=None),
                                  np.sort(np.asarray(sh.slab_rows), axis=None))
    v, i = jrank.sharded_ivf_topk(inp["ivf_part/luts"], inp["ivf_part/q"], sh, 10, jmesh,
                                  nprobe=8)
    np.testing.assert_allclose(got["vals"], np.asarray(v), atol=2e-4)
    np.testing.assert_array_equal(got["ids"], np.asarray(i))


def test_sharded_hamming_symmetric(world, jmesh):
    """999 rows pad to 4 x 128 a rank: values exact, each id's score its
    value."""
    inp, outs = world
    sh, n = jpar.shard_codes_binary(jnp.asarray(inp["bits"]), jmesh)
    v, _ = jpar.sharded_hamming_topk(jnp.asarray(inp["bits_q"]), sh, 12, jmesh, n)
    got = outs["ham"]
    np.testing.assert_array_equal(got["vals"], np.asarray(v))
    x = np.bitwise_xor(inp["bits_q"][:, None, :], inp["bits"][None])
    oracle = 64 - 2 * np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
    np.testing.assert_array_equal(np.take_along_axis(oracle, got["ids"], axis=1), got["vals"])
    assert got["ids"].max() < 999


@pytest.mark.parametrize("rf", [100, 4])
def test_sharded_hamming_asymmetric(world, jmesh, rf):
    """Each rank rescores its own symmetric shortlist of rf * k rows with the
    fp32 projected queries (dirjax's mesh semantics), rtol 1e-5; at rf 100
    the shortlist is every row, so the answer is the exact asymmetric one."""
    inp, outs = world
    sh, n = jpar.shard_codes_binary(jnp.asarray(inp["cl_codes"]), jmesh)
    v, i = jpar.sharded_hamming_topk(jnp.asarray(inp["cl_qp"]), sh, 10, jmesh, n,
                                     vq=jnp.asarray(inp["cl_vq"]), rerank_factor=rf)
    got = outs[f"ham_vq{rf}"]
    np.testing.assert_allclose(got["vals"], np.asarray(v), rtol=1e-5)
    from dirjax.ops.binary import unpack_pm1

    full = inp["cl_vq"] @ np.asarray(unpack_pm1(jnp.asarray(inp["cl_codes"]))).T
    np.testing.assert_allclose(np.take_along_axis(full, got["ids"], axis=1), got["vals"],
                               rtol=1e-5)
    if rf == 100:
        np.testing.assert_allclose(got["vals"], -np.sort(-full, axis=1)[:, :10], rtol=1e-5)


def test_asym_rescore_matches_dirjax():
    """The port's copy of dirjax's asym_rescore on a shortlist with empty
    (-1) slots: values within 1e-5, ids exact."""
    from dirjax.ops.binary import asym_rescore as jrescore

    from dirjax_torch.ops.binary import asym_rescore

    rng = np.random.default_rng(5)
    codes = _rand_codes(rng, 200, 4)
    vq = rng.standard_normal((6, 128)).astype(np.float32)
    idxs = rng.choice(200, size=(6, 20)).astype(np.int32)
    idxs[:, -3:] = -1
    idxs[2] = -1
    jv, ji = jrescore(jnp.asarray(vq), jnp.asarray(codes), jnp.asarray(idxs), 8)
    tv, ti = asym_rescore(vq, codes, idxs.astype(np.int64), 8)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


# --- extraction -------------------------------------------------------------------

def _jax_model(inp):
    from dirjax.models import create_model

    from dirjax_torch.models import create_model as tcreate
    from dirjax_torch.utils.checkpoints import jax_params_from_state_dict

    sd = {k[4:]: torch.from_numpy(v) for k, v in inp.items() if k.startswith("r18/")}
    cfg = tcreate("resnet18_rmac", out_dim=64).cfg
    return create_model("resnet18_rmac", out_dim=64), jax_params_from_state_dict(sd, cfg)


def test_sharded_extraction(world):
    """5 images pad to 8 on 4 ranks; float and uint8 input; against dirjax's
    single-device forward and its ShardedExtractor on the same weights."""
    inp, outs = world
    model, params = _jax_model(inp)
    got = outs["extract"]
    want = np.asarray(model.apply(params, jnp.asarray(inp["imgs"])))
    assert got["descs"].shape == (5, 64)
    np.testing.assert_allclose(got["descs"], want, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got["adaptive"], got["descs"])
    jex = jpar.ShardedExtractor(model, params, jpar.make_mesh(data=WORLD, db=1,
                                                              devices=jax.devices()[:WORLD]))
    np.testing.assert_allclose(got["u8"], np.asarray(jex(inp["imgs_u8"])), rtol=1e-4,
                               atol=1e-5)


def test_sharded_extractor_drops_into_eval(world):
    """eval_model runs on the ShardedExtractor unchanged, with the mAPs of
    the single-device extractor."""
    out = world[1]["eval"]
    np.testing.assert_allclose(out["sharded"], out["single"], atol=1e-4)


# --- world 1, in-process -------------------------------------------------------

@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1)
    yield par.make_mesh(1, 1, device_type="cpu")
    dist.destroy_process_group()


def test_world1_mesh_and_refusals(world1):
    assert (par.axis_size(world1, "data"), par.axis_size(world1, "db")) == (1, 1)
    with pytest.raises(AssertionError):
        par.make_mesh(2, 2, device_type="cpu")
    with pytest.raises(RuntimeError):      # no CUDA here, and no fallback
        par.make_mesh(1, 1, device_type="cuda")


def test_world1_tiers_equal_single_chip(world1):
    """At world 1 each tier is the single-chip search plus a trivial merge:
    equal bit for bit."""
    from dirjax_torch.ops.binary import (asym_rescore, binarize, binarize_and_project,
                                         fit_itq, hamming_topk_mxu)
    from dirjax_torch.ops.ivf import build_ivf, ivf_topk
    from dirjax_torch.ops.pq import encode_pq, pq_lookup, pq_topk, train_pq
    from dirjax_torch.ops.topk import quantize_db, rank_topk_fused

    mesh = world1
    rng = np.random.default_rng(3)
    db, q = torch.from_numpy(_unit(rng, 2500, 64)), torch.from_numpy(_unit(rng, 7, 64))

    def same(got, want):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])

    for dt, k in ((torch.float32, 10), (torch.bfloat16, 10), (torch.float32, 40)):
        sh, n = par.shard_database(db.to(dt), mesh)
        same(par.sharded_topk(q.to(dt), sh, k, mesh, n), rank_topk_fused(q.to(dt), db.to(dt), k))
    d8, s8, n = par.shard_database_quantized(db, mesh)
    w8, ws = quantize_db(db)
    for qq in (False, True):
        same(par.sharded_topk(q, d8, 30, mesh, n, db_scales=s8, quantize_queries=qq),
             rank_topk_fused(q, w8, 30, db_scales=ws, quantize_queries=qq))
    sh, n = par.shard_database(db, mesh)
    assert torch.equal(par.sharded_scores(q, sh, mesh, n), q @ db.T)

    books = train_pq(db, 8, 16, iters=3, seed=1)
    codes = encode_pq(db, books)
    luts = pq_lookup(q, books)
    csh, n = par.shard_codes(codes, mesh)
    same(par.sharded_pq_topk(luts, csh, 12, mesh, n), pq_topk(luts, codes, 12))

    codec = fit_itq(db, 64, iters=3, seed=1)
    bits = binarize(db, codec)
    qb, vq = binarize_and_project(q, codec)
    bsh, n = par.shard_codes_binary(bits, mesh)
    same(par.sharded_hamming_topk(qb, bsh, 9, mesh, n), hamming_topk_mxu(qb, bits, 9))
    short = hamming_topk_mxu(qb, bits, 36)[1]
    same(par.sharded_hamming_topk(qb, bsh, 9, mesh, n, vq=vq),
         asym_rescore(vq, bits, short, 9))

    ivf, _, rbooks = build_ivf(db, 8, 8, 16, pq_iters=3, seed=1)
    rl = pq_lookup(q, rbooks)
    same(par.sharded_ivf_topk(rl, q, par.shard_ivf(ivf, mesh), 11, mesh, nprobe=8),
         ivf_topk(rl, q, ivf, 11, nprobe=8))


def test_world1_aqe_and_extraction(world1):
    """sharded_aqe against expand_queries_chunked (its top-k through the
    same plain top-k here); ShardedExtractor against FeatureExtractor."""
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.models import create_model, init_weights
    from dirjax_torch.ops import expand_queries_chunked, expand_queries_quantized
    from dirjax_torch.ops.topk import quantize_db

    mesh = world1
    rng = np.random.default_rng(4)
    db, q = torch.from_numpy(_unit(rng, 300, 32)), torch.from_numpy(_unit(rng, 5, 32))
    sh, n = par.shard_database(db, mesh)
    torch.testing.assert_close(par.sharded_aqe(q, sh, mesh, n, k=6),
                               expand_queries_chunked(q, db, k=6), atol=1e-6, rtol=1e-5)
    d8, s8, n = par.shard_database_quantized(db, mesh)
    w8, ws = quantize_db(db)
    torch.testing.assert_close(par.sharded_aqe(q, d8, mesh, n, k=6, db_scales=s8),
                               expand_queries_quantized(q, w8, ws, k=6), atol=1e-6, rtol=1e-5)

    model = init_weights(create_model("resnet18_rmac", out_dim=16),
                         torch.Generator().manual_seed(2))
    x = rng.integers(0, 255, size=(3, 48, 40, 3), dtype=np.uint8)
    mask = np.ones((3, 48, 40), bool)
    mask[1, :, 32:] = False
    want = FeatureExtractor(model, "cpu")(x, mask)
    got = par.ShardedExtractor(model, mesh)(x, mask)
    assert torch.equal(got, want)

"""One rank of the port's multi-rank CPU tests, and the launcher that starts
a world of them (``run_world``). It holds no test functions, so pytest
collects nothing from it; it imports torch, numpy and the port only.

    python tests/test_torch_dist_worker.py WORKDIR RANK WORLD

Each rank initialises gloo over a ``FileStore`` in WORKDIR with one thread,
runs the cases listed in ``WORKDIR/cases.json`` (``[name, kwargs]`` pairs;
``mesh`` kwargs are ``[data, db]``) on the arrays of ``WORKDIR/inputs.npz``,
and writes ``WORKDIR/out_RANK.npz`` (``<case index>/<key>`` arrays). The
launcher checks that every rank returned the same arrays (the SPMD contract)
and hands back rank 0's.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from dirjax_torch import parallel as par  # noqa: E402

TIMEOUT = 120       # seconds a world may take before its test fails
CASES = {}
_MESHES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def _mesh(shape):
    """One DeviceMesh per shape in a world (each makes its own groups)."""
    key = tuple(shape)
    if key not in _MESHES:
        _MESHES[key] = par.make_mesh(key[0], key[1], device_type="cpu")
    return _MESHES[key]


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


# --------------------------------------------------------------------------
# mesh and ranking
# --------------------------------------------------------------------------

@case
def meshes(inp):
    """Shapes of the default and 2D meshes, and the bad factorization."""
    out = {"default": list(_mesh_shape(par.make_mesh(device_type="cpu"))),
           "two_d": list(_mesh_shape(par.make_mesh(2, 2, device_type="cpu")))}
    try:
        par.make_mesh(3, 3, device_type="cpu")
        out["bad"] = "no error"
    except AssertionError as e:
        out["bad"] = f"AssertionError: {e}"
    return out


def _mesh_shape(mesh):
    return par.axis_size(mesh, "data"), par.axis_size(mesh, "db")


@case
def multihost(inp, db, q, k):
    """make_multihost_mesh with two ranks a host: its layout, and sharded_topk
    on it against make_mesh(2, 2)."""
    os.environ["GROUP_RANK"] = str(dist.get_rank() // 2)
    m = par.make_multihost_mesh(db_per_host=2, device_type="cpu")
    sh, n = par.shard_database(inp[db], m)
    v, i = par.sharded_topk(inp[q], sh, k, m, n)
    m2 = _mesh((2, 2))
    sh2, _ = par.shard_database(inp[db], m2)
    v2, i2 = par.sharded_topk(inp[q], sh2, k, m2, n)
    return {"shape": list(_mesh_shape(m)), "mesh": m.mesh.numpy(), "ids": i, "ids_2d": i2}


@case
def topk(inp, mesh, db, q, k, mode="fp32"):
    """sharded_topk over fp32 / bf16 rows, or int8 with bf16 (int8) or int8
    (int8q) queries."""
    m = _mesh(mesh)
    if mode.startswith("int8"):
        d8, s8, n = par.shard_database_quantized(inp[db], m)
        v, i = par.sharded_topk(inp[q], d8, k, m, n, db_scales=s8,
                                quantize_queries=mode == "int8q")
    else:
        dtype = torch.bfloat16 if mode == "bf16" else torch.float32
        sh, n = par.shard_database(_t(inp[db], dtype), m)
        v, i = par.sharded_topk(_t(inp[q], dtype), sh, k, m, n)
    return {"vals": v, "ids": i}


@case
def scores(inp, mesh, db, q):
    m = _mesh(mesh)
    sh, n = par.shard_database(inp[db], m)
    return {"scores": par.sharded_scores(inp[q], sh, m, n)}


@case
def aqe(inp, mesh, db, q, k, alpha, mode="fp32", exclude=None, pad=0):
    m = _mesh(mesh)
    kw = {} if exclude is None else {"exclude_mask": _t(inp[exclude]), "exclude_pad": pad}
    if mode == "int8":
        d8, s8, n = par.shard_database_quantized(inp[db], m)
        out = par.sharded_aqe(inp[q], d8, m, n, alpha=alpha, k=k, db_scales=s8, **kw)
    else:
        sh, n = par.shard_database(inp[db], m)
        out = par.sharded_aqe(inp[q], sh, m, n, alpha=alpha, k=k, **kw)
    return {"expanded": out}


@case
def pq(inp, mesh, codes, luts, k):
    m = _mesh(mesh)
    sh, n = par.shard_codes(inp[codes], m)
    v, i = par.sharded_pq_topk(inp[luts], sh, k, m, n)
    return {"vals": v, "ids": i}


@case
def ivf(inp, mesh, prefix, k, nprobe):
    """sharded_ivf_topk over the inverted file of the ``prefix/*`` arrays
    (dirjax's fields), and every rank's slab rows (the partition)."""
    from dirjax_torch.ops.ivf import IVFArrays

    m = _mesh(mesh)
    fields = IVFArrays(*(_t(inp[f"{prefix}/{f}"]) for f in IVFArrays._fields))
    sh = par.shard_ivf(fields, m)
    v, i = par.sharded_ivf_topk(inp[f"{prefix}/luts"], inp[f"{prefix}/q"], sh, k, m,
                                nprobe=nprobe)
    return {"vals": v, "ids": i, "slab_rows": par.gather_shards(sh.slab_rows, m),
            "vlist_tab": par.gather_shards(sh.vlist_tab[None], m),
            "local_slabs": torch.tensor([sh.codes.shape[0]])}


@case
def hamming(inp, mesh, codes, q, k, vq=None, rerank_factor=4):
    m = _mesh(mesh)
    sh, n = par.shard_codes_binary(inp[codes], m)
    v, i = par.sharded_hamming_topk(inp[q], sh, k, m, n,
                                    vq=None if vq is None else inp[vq],
                                    rerank_factor=rerank_factor)
    return {"vals": v, "ids": i}


# --------------------------------------------------------------------------
# extraction
# --------------------------------------------------------------------------

def _model(inp, prefix, arch, out_dim):
    from dirjax_torch.models import create_model
    from dirjax_torch.utils.checkpoints import load_state

    model = create_model(arch, out_dim=out_dim)
    sd = {k[len(prefix) + 1:]: _t(v) for k, v in inp.items() if k.startswith(prefix + "/")}
    return load_state(model, sd)


@case
def extract(inp, mesh, model, arch, out_dim, images, images_u8):
    m = _mesh(mesh)
    ex = par.ShardedExtractor(_model(inp, model, arch, out_dim), m)
    out = {"descs": ex(inp[images]), "u8": ex(inp[images_u8]),
           "adaptive": _t(ex.call_adaptive(inp[images]))}
    return out


@case
def eval_model(inp, mesh, model, arch, out_dim, root):
    from dirjax_torch.datasets import Synthetic
    from dirjax_torch.extraction import FeatureExtractor
    from dirjax_torch.extraction import eval_model as run

    net = _model(inp, model, arch, out_dim)
    synth = Synthetic(root, revisited=True)
    sharded = run(synth, par.ShardedExtractor(net, _mesh(mesh)), "", threads=1)
    single = run(synth, FeatureExtractor(net, "cpu"), "", threads=1)
    keys = sorted(k for k in sharded if k.startswith("mAP"))
    return {"sharded": [sharded[k] for k in keys], "single": [single[k] for k in keys]}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------

def _answers(out, tag, res):
    out[f"{tag}_vals"], out[f"{tag}_ids"] = res


@case
def index_dense(inp, mesh, db, q, dtype, k, remove, add, path):
    """A RetrievalIndex on the mesh through search (plain, AQE, int8
    queries), remove, compact, add and save; the same steps run on one
    device in the parent."""
    from dirjax_torch.serving import RetrievalIndex

    m = _mesh(mesh)
    dt = getattr(torch, dtype)
    idx = RetrievalIndex(inp[db], dtype=dt, mesh=m, keys=[f"k{i}" for i in range(len(inp[db]))])
    out = {}
    _answers(out, "plain", idx.search(inp[q], k=k))
    _answers(out, "aqe", idx.search(inp[q], k=k, aqe={"k": 4, "alpha": 3.0}))
    if dt == torch.int8:
        _answers(out, "int8q", idx.search(inp[q], k=k, int8_queries=True))
    idx.remove(indices=inp[remove])
    _answers(out, "removed", idx.search(inp[q], k=k))
    _answers(out, "removed_aqe", idx.search(inp[q], k=k, aqe={"k": 4, "alpha": 3.0}))
    idx.save(path + ".tomb.npz")
    out["mapping"] = idx.compact()
    _answers(out, "compacted", idx.search(inp[q], k=k))
    idx.add(inp[add], keys=[f"a{i}" for i in range(len(inp[add]))])
    _answers(out, "added", idx.search(inp[q], k=k))
    idx.save(path)
    back = RetrievalIndex.load(path, mesh=m)
    _answers(out, "loaded", back.search(inp[q], k=k))
    tomb = RetrievalIndex.load(path + ".tomb.npz", mesh=m)
    out["tomb_removed"] = [tomb.n_removed]
    _answers(out, "tomb", tomb.search(inp[q], k=k))
    return out


@case
def index_binary(inp, mesh, db, q, k, asym, rerank_factor, remove, path):
    from dirjax_torch.serving import BinaryIndex

    m = _mesh(mesh)
    idx = BinaryIndex(inp[db][:500], itq_iters=3, sample=None, seed=1, asym=asym, mesh=m,
                      device="cpu")
    out = {"codec_mean": idx.codec.mean, "codec_proj": idx.codec.proj}
    idx.add(inp[db][500:])
    _answers(out, "plain", idx.search(inp[q], k=k, rerank_factor=rerank_factor))
    idx.remove(indices=inp[remove])
    _answers(out, "removed", idx.search(inp[q], k=k, rerank_factor=rerank_factor))
    out["mapping"] = idx.compact()
    _answers(out, "compacted", idx.search(inp[q], k=k, rerank_factor=rerank_factor))
    idx.save(path)
    back = BinaryIndex.load(path, mesh=m)
    _answers(out, "loaded", back.search(inp[q], k=k, rerank_factor=rerank_factor))
    return out


@case
def index_pq(inp, mesh, db, q, k, rerank, remove, path, ragged):
    from dirjax_torch.serving import PQIndex, RetrievalIndex

    m = _mesh(mesh)
    idx = PQIndex(inp[db], m=8, ksub=16, seed=2, sample=None, train_iters=6, rerank=rerank,
                  mesh=m, device="cpu")
    out = {"codebooks": idx.codebooks}
    _answers(out, "plain", idx.search(inp[q], k=k))
    _answers(out, "aqe", idx.search(inp[q], k=k, aqe={"k": 4, "alpha": 3.0}))
    idx.remove(indices=inp[remove])
    _answers(out, "removed", idx.search(inp[q], k=k))
    _answers(out, "removed_aqe", idx.search(inp[q], k=k, aqe={"k": 4, "alpha": 3.0}))
    out["mapping"] = idx.compact()
    _answers(out, "compacted", idx.search(inp[q], k=k))
    idx.save(path)
    back = RetrievalIndex.load(path, mesh=m)
    _answers(out, "loaded", back.search(inp[q], k=k))
    short = PQIndex.from_codes(idx.codebooks, inp[ragged], mesh=m, device="cpu")
    _answers(out, "ragged", short.search(inp[q], k=k))
    return out


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def _train_cfg(cfg):
    from dirjax_torch.train import TrainConfig

    return TrainConfig(**cfg)


def _state(model):
    return {f"sd/{k}": v for k, v in model.state_dict().items()}


@case
def train_step(inp, mesh, model, cfg, images, labels):
    """One sharded step (whole-batch or two-pass by ``cfg``); the whole
    state after it, and the loss."""
    from dirjax_torch import train as TT

    m = _mesh(mesh)
    c = _train_cfg(cfg)
    net = _model(inp, model, c.arch, c.out_dim).train()
    opt = TT.make_optimizer(c, net)
    TT.shard_fc(net, opt, m)
    step = TT.make_sharded_train_step(net, c, opt, m)
    loss = step(inp[images], inp[labels])
    TT.unshard_fc(net, opt, m)
    return {"loss": [float(loss)], **_state(net)}


@case
def per_rank_loss(inp, mesh, model, cfg, images, labels):
    """The loss a data-parallel wrapper would take (each rank's listwise
    loss over its own rows, averaged over "data") beside the global loss."""
    from dirjax_torch import train as TT

    m = _mesh(mesh)
    c = _train_cfg(cfg)
    net = _model(inp, model, c.arch, c.out_dim).train()
    obj = TT.make_batch_objective(c)
    n, r = par.axis_size(m, "data"), par.axis_rank(m, "data")
    x, y = TT._device_batch(net, inp[images], inp[labels])
    b = len(x) // n
    with torch.no_grad():
        local = obj(net(x[r * b:(r + 1) * b], train=True), y[r * b:(r + 1) * b]).reshape(1)
        dist.all_reduce(local, group=m.get_group("data"))
        whole = obj(net(x, train=True), y)
    return {"per_rank_mean": [float(local) / n], "global": [float(whole)]}


@case
def fit(inp, mesh, cfg, root, steps, out_dir=None, resume=None, ckpt_format="npz"):
    """``fit(mesh=...)`` on ImageListLabels(root/train.txt); the history and
    the final weights."""
    from dirjax_torch.datasets import ImageListLabels
    from dirjax_torch.train import fit as run

    c = _train_cfg(cfg)
    data = ImageListLabels(os.path.join(root, "train.txt"), root=root)
    model = _model(inp, "start", c.arch, c.out_dim) if "start/fc.bias" in inp else None
    try:
        model, hist = run(data, c, model=model, steps_per_epoch=steps, mesh=_mesh(mesh),
                          out_dir=out_dir, resume=resume, ckpt_format=ckpt_format)
    except AssertionError as e:
        return {"error": f"AssertionError: {e}"}
    return {"epochs": [h["epoch"] for h in hist], "losses": [h["loss"] for h in hist],
            **_state(model)}


@case
def dist_ckpt(inp, mesh, directory):
    """A DTensor sharded over "db" through TrainCheckpointer: each rank's
    restored shard, and the whole array restored into a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from dirjax_torch.utils.dist_ckpt import TrainCheckpointer

    m = _mesh(mesh)
    full = torch.arange(64.0).reshape(8, 8)
    c, w = par.axis_rank(m, "db"), 8 // par.axis_size(m, "db")
    place = [Replicate(), Shard(0)]
    w_dt = DTensor.from_local(full[c * w:(c + 1) * w].clone(), m, place, run_check=False)
    with TrainCheckpointer(directory) as ck:
        ck.save(0, {"w": w_dt, "b": torch.ones(3)}, {"step": torch.tensor(7)},
                extra={"epoch": 0})
        ck.wait()
        tmpl = DTensor.from_local(torch.zeros(w, 8), m, place, run_check=False)
        p, o, ex = ck.restore({"w": tmpl, "b": torch.zeros(3)}, {"step": torch.tensor(0)})
        whole, _, _ = ck.restore({"w": torch.zeros(8, 8), "b": torch.zeros(3)})
    local = p["w"].to_local()
    return {"local_ok": [bool(torch.equal(local, full[c * w:(c + 1) * w]))],
            "whole": whole["w"], "step": [int(o["step"])], "epoch": [ex["epoch"]],
            "steps": [ck.latest_step()]}


# --------------------------------------------------------------------------
# the rank and the launcher
# --------------------------------------------------------------------------

def _rank_main(work: str, rank: int, world: int) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{os.path.join(work, 'store')}",
                            rank=rank, world_size=world)
    with open(os.path.join(work, "cases.json")) as f:
        cases = json.load(f)
    with np.load(os.path.join(work, "inputs.npz")) as data:
        inp = {k: data[k] for k in data.files}
    out = {}
    try:
        for n, (name, kw) in enumerate(cases):
            for key, v in CASES[name](inp, **kw).items():
                v = v.detach().float().numpy() if torch.is_tensor(v) and v.is_floating_point() \
                    else (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                out[f"{n}/{key}"] = v
    finally:
        dist.destroy_process_group()
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)


def run_world(work: str, world: int, cases: list, inputs: dict) -> list:
    """Start ``world`` ranks on ``cases`` and return, per case, the dict of
    its outputs (rank 0's, after checking every rank returned the same)."""
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(work, "cases.json"), "w") as f:
        json.dump(cases, f)
    np.savez(os.path.join(work, "inputs.npz"), **inputs)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), work, str(r),
                               str(world)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env, cwd=work) for r in range(world)]
    deadline = time.monotonic() + TIMEOUT
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            logs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"a world of {world} ranks took over {TIMEOUT} s "
                             "(a collective hung)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise AssertionError("\n".join(f"rank {r} exited {procs[r].returncode}:\n"
                                       f"{logs[r][-3000:]}" for r in failed))
    outs = []
    for r in range(world):
        with np.load(os.path.join(work, f"out_{r}.npz")) as data:
            outs.append({k: data[k] for k in data.files})
    for r in range(1, world):
        assert outs[r].keys() == outs[0].keys()
        for k in outs[0]:
            np.testing.assert_array_equal(outs[r][k], outs[0][k],
                                          err_msg=f"rank {r} differs from rank 0 at {k}")
    per_case = [{} for _ in cases]
    for k, v in outs[0].items():
        n, key = k.split("/", 1)
        per_case[int(n)][key] = v
    return per_case


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))

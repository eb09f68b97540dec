"""Recall study for the compressed serving tiers (counterpart of the
repository's ``recall_study.py``, which it mirrors stage for stage).

The compressed tiers (int8 / PQ / OPQ / IVF-PQ / binary-ITQ) are graded on
descriptors with a realistic spectrum: a GeM descriptor head run over
generated structured images, PCA-whitened (whitenp=0.5) and L2-normalized,
the serving pipeline of the reference's ``test_dir.py``. No dataset is
needed: every image is generated on the device from a seed.

    python -m dirjax_torch.recall_study train      # fine-tune (trained spectrum)
    python -m dirjax_torch.recall_study extract    # scenes + query views -> descriptors
    python -m dirjax_torch.recall_study evaluate   # whiten, build and grade every tier

Every stage runs on ``cuda`` and raises if CUDA is absent; ``--cpu`` runs
it on the CPU. Stage 0 (``train``) fine-tunes a descriptor model with the
listwise AP loss (``dirjax_torch.train.make_train_step``) on a clustered
corpus generated on the device (each class one base scene, each example a
random jittered view of it) and saves a native checkpoint: a trained
backbone concentrates the descriptor variance, a random-init one leaves it
flat. Stage 1 (``extract``) generates ``--n-db`` scenes (gradient
background, gaussian blobs, an oriented sinusoid, pixel noise) and
``--n-q`` query views (crop-resize and brightness jitter of the first
scenes, so each query has one true near-duplicate among many distractors
of the same statistics), runs the bf16 descriptor forward and saves the raw
descriptors. Stage 2 (``evaluate``) whitens, reports the variance
spectrum, builds every serving tier, measures recall@k against the exact
dot-product ranking, and validates ``tuning.tune`` on held-out queries
(``--section`` nests the results, so one file carries the flat and the
trained study side by side).

The random factors of each scene and view are drawn from an explicit
``torch.Generator`` (:func:`draw_scene_factors`, :func:`draw_view_factors`)
and rendered from them (:func:`render_scenes`, :func:`render_query_views`),
so the same factors give the same images as dirjax's generator. Default
output names differ from dirjax's (``recall_torch.json``,
``recall_descs_torch.npz``, ``ckpt_spectrum_torch.npz``). ``--seed`` (every
stage) and ``--scene-shift`` (``extract``) vary what dirjax fixes; their
defaults are dirjax's values.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import time
from typing import NamedTuple

import numpy as np
import torch

DESC_FILE = "recall_descs_torch.npz"
OUT_FILE = "recall_torch.json"
CKPT_FILE = "ckpt_spectrum_torch.npz"
N_BLOBS = 8
CLASS_SEED = 777          # class c's base scene: a generator seeded (777, c)
TRAIN_DTYPE = torch.bfloat16     # the train stage's step, as dirjax's
EXTRACT_DTYPE = torch.bfloat16   # the extract stage's forward, as dirjax's


def _device(args) -> torch.device:
    """The stage's device: the CPU under ``--cpu``, else ``cuda``, which must
    exist."""
    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("the recall study runs on cuda, which is not available "
                           "(pass --cpu for the CPU)")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _fp32_products():
    """TF32 off inside (fp32 products, as the CLIs run them), then the
    caller's flags again."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _generator(device: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# --------------------------------------------------------------------------
# scene synthesis: random factors, then a render from them
# --------------------------------------------------------------------------

class SceneFactors(NamedTuple):
    """The eight independent draws of :func:`render_scenes` (dirjax's
    ``_scene_batch`` keys 0-7), shaped as dirjax draws them."""

    g: torch.Tensor       # (n, 1, 1, 3, 3) gradient: c0 + c1*y + c2*x per channel
    bc: torch.Tensor      # (n, N_BLOBS, 2) blob centres (y, x)
    bs: torch.Tensor      # (n, N_BLOBS, 1) blob sizes in [0.02, 0.15)
    bcol: torch.Tensor    # (n, N_BLOBS, 3) blob colours in [-0.8, 0.8)
    th: torch.Tensor      # (n, 1, 1, 1) texture orientation in [0, pi)
    fr: torch.Tensor      # (n, 1, 1, 1) texture frequency in [4, 40)
    ph: torch.Tensor      # (n, 1, 1, 1) texture phase in [0, 2 pi)
    noise: torch.Tensor   # (n, h, w, 3) standard normal pixel noise


class ViewFactors(NamedTuple):
    """The draws of :func:`render_query_views` (dirjax's ``_query_views``)."""

    scale: torch.Tensor   # (n,) crop side in [0.82, 0.96)
    oy: torch.Tensor      # (n,) crop origin, in [0, 1 - scale)
    ox: torch.Tensor      # (n,)
    bright: torch.Tensor  # (n, 1, 1, 1) brightness in [0.9, 1.1)


def _uniform(gen: torch.Generator, shape, lo: float = 0.0, hi: float = 1.0):
    return lo + (hi - lo) * torch.rand(shape, generator=gen, device=gen.device)


def draw_scene_factors(n: int, h: int, w: int, gen: torch.Generator) -> SceneFactors:
    """Draw ``n`` scenes' factors from ``gen``, on its device."""
    return SceneFactors(
        g=_uniform(gen, (n, 1, 1, 3, 3)),
        bc=_uniform(gen, (n, N_BLOBS, 2)),
        bs=_uniform(gen, (n, N_BLOBS, 1), 0.02, 0.15),
        bcol=_uniform(gen, (n, N_BLOBS, 3), -0.8, 0.8),
        th=_uniform(gen, (n, 1, 1, 1), 0.0, math.pi),
        fr=_uniform(gen, (n, 1, 1, 1), 4.0, 40.0),
        ph=_uniform(gen, (n, 1, 1, 1), 0.0, 2 * math.pi),
        noise=torch.randn((n, h, w, 3), generator=gen, device=gen.device))


def render_scenes(f: SceneFactors, h: int, w: int) -> torch.Tensor:
    """(n, h, w, 3) fp32 scenes in [0, 1] on the factors' device: a
    low-frequency colour gradient + 8 gaussian blobs + an oriented sinusoid +
    pixel noise."""
    dev = f.g.device
    yy = torch.linspace(0.0, 1.0, h, device=dev)[None, :, None, None]
    xx = torch.linspace(0.0, 1.0, w, device=dev)[None, None, :, None]
    img = f.g[..., 0] + f.g[..., 1] * yy + f.g[..., 2] * xx
    d2 = ((yy[..., 0][..., None] - f.bc[:, None, None, :, 0]) ** 2
          + (xx[..., 0][..., None] - f.bc[:, None, None, :, 1]) ** 2)
    blob = torch.exp(-d2 / (2 * f.bs[:, None, None, :, 0] ** 2))
    img = img + torch.einsum("nhwb,nbc->nhwc", blob, f.bcol)
    tex = 0.15 * torch.sin(f.fr * (torch.cos(f.th) * yy + torch.sin(f.th) * xx) + f.ph)
    img = img + tex
    img = img + 0.02 * f.noise
    return img.clamp(0.0, 1.0)


def draw_view_factors(n: int, gen: torch.Generator) -> ViewFactors:
    """Draw ``n`` query views' factors from ``gen``, on its device."""
    scale = _uniform(gen, (n,), 0.82, 0.96)
    oy = _uniform(gen, (n,)) * (1.0 - scale)
    ox = _uniform(gen, (n,)) * (1.0 - scale)
    return ViewFactors(scale=scale, oy=oy, ox=ox,
                       bright=_uniform(gen, (n, 1, 1, 1), 0.9, 1.1))


def render_query_views(imgs: torch.Tensor, f: ViewFactors) -> torch.Tensor:
    """Random crop-resize + brightness jitter of ``imgs`` (n, h, w, 3): each
    image's scaled window sampled bilinearly back to (h, w), then scaled in
    brightness and clipped to [0, 1]. No horizontal flip: a randomly
    initialised backbone has no flip invariance, and flipped queries would
    turn the source-retrieval check into a coin toss."""
    n, h, w, _ = imgs.shape
    dev = imgs.device
    yy = torch.linspace(0.0, 1.0, h, device=dev)
    xx = torch.linspace(0.0, 1.0, w, device=dev)
    ys = (f.oy[:, None] + yy[None, :] * f.scale[:, None]) * (h - 1)     # (n, h)
    xs = (f.ox[:, None] + xx[None, :] * f.scale[:, None]) * (w - 1)     # (n, w)
    y0 = ys.floor().long().clamp(0, h - 2)
    x0 = xs.floor().long().clamp(0, w - 2)
    wy = (ys - y0)[:, :, None, None]
    wx = (xs - x0)[:, None, :, None]
    b = torch.arange(n, device=dev)[:, None, None]
    Y, X = y0[:, :, None], x0[:, None, :]
    out = (imgs[b, Y, X] * (1 - wy) * (1 - wx) + imgs[b, Y, X + 1] * (1 - wy) * wx
           + imgs[b, Y + 1, X] * wy * (1 - wx) + imgs[b, Y + 1, X + 1] * wy * wx)
    return (out * f.bright).clamp(0.0, 1.0)


def db_scenes(i: int, batch: int, h: int, w: int, device, shift: int = 0) -> torch.Tensor:
    """Database batch ``i`` of the extract stage (generator seed 1000 + i,
    plus ``shift``)."""
    gen = _generator(torch.device(device), 1000 + i + shift)
    return render_scenes(draw_scene_factors(batch, h, w, gen), h, w)


def query_views(i: int, imgs: torch.Tensor, shift: int = 0) -> torch.Tensor:
    """Query views of database batch ``i`` (generator seed 5000 + i, plus
    ``shift``)."""
    gen = _generator(imgs.device, 5000 + i + shift)
    return render_query_views(imgs, draw_view_factors(len(imgs), gen))


def class_views(step: int, cls_ids, views: int, h: int, w: int, device) -> torch.Tensor:
    """A fine-tune batch: ``views`` independent jittered views (generator seed
    10000 + step) of each class's base scene, which is the same at every
    step (a generator seeded from (777, class))."""
    device = torch.device(device)
    scenes = torch.cat([render_scenes(draw_scene_factors(
        1, h, w, _generator(device, (CLASS_SEED << 32) | int(c))), h, w) for c in cls_ids])
    reps = scenes.repeat_interleave(views, dim=0)
    return render_query_views(reps, draw_view_factors(len(reps),
                                                      _generator(device, 10_000 + step)))


# --------------------------------------------------------------------------
# stage 0: fine-tune for a trained (concentrated) spectrum
# --------------------------------------------------------------------------

def study_optimizer(model: torch.nn.Module, lr: float) -> torch.optim.Optimizer:
    """dirjax's study optimizer: plain Adam (betas 0.9/0.999, eps 1e-8, no
    weight decay, no schedule) on every tensor of the model, BN scale, bias,
    running mean and running var included (``optax.adam`` over the whole
    parameter pytree). ``make_optimizer`` would freeze BN and decay, which
    trains another model."""
    from .train import _trained_parameters

    return torch.optim.Adam(_trained_parameters(model, freeze_bn=False), lr=lr,
                            betas=(0.9, 0.999), eps=1e-8)


def train(args):
    from .models import create_model, init_weights
    from .train import TrainConfig, make_train_step
    from .utils.checkpoints import Checkpoint, save_native

    if args.batch % args.views:
        raise ValueError("--views must divide --batch")
    device = _device(args)
    cpb = args.batch // args.views      # classes per batch
    h = w = args.size
    cfg = TrainConfig(arch=args.arch, loss="ap", batch_size=args.batch,
                      image_size=args.size, learning_rate=args.lr, seed=args.seed)
    t0 = time.time()
    model = init_weights(create_model(cfg.arch), torch.Generator().manual_seed(cfg.seed))
    model = model.to(device).train()
    step = make_train_step(model, cfg, study_optimizer(model, cfg.learning_rate),
                           dtype=TRAIN_DTYPE)

    losses = []
    for it in range(args.steps):
        cls_np = np.random.default_rng(it).integers(0, args.n_classes, size=cpb)
        imgs = class_views(it, cls_np, args.views, h, w, device)
        labels = torch.as_tensor(np.repeat(cls_np, args.views), device=device)
        losses.append(float(step(imgs, labels)))
        if it == 0:
            print(f"first step done ({time.time() - t0:.0f}s)", flush=True)
        if (it + 1) % 25 == 0:
            recent = sum(losses[-25:]) / len(losses[-25:])
            print(f"step {it + 1}/{args.steps} ap-loss {recent:.4f}", flush=True)
    ckpt = Checkpoint(model=model, preprocess=model.cfg.preprocess,
                      extra={"steps": args.steps,
                             "n_classes": args.n_classes,
                             "loss_first25": round(
                                 sum(losses[:25]) / min(25, len(losses)), 4),
                             "loss_last25": round(
                                 sum(losses[-25:]) / min(25, len(losses)), 4)})
    save_native(args.out, ckpt)
    print(f"saved {cfg.arch} fine-tune ({args.steps} steps, AP loss "
          f"{ckpt.extra['loss_first25']} -> {ckpt.extra['loss_last25']}) "
          f"-> {args.out}", flush=True)
    return {"losses": losses, "seconds": time.time() - t0, **ckpt.extra}


# --------------------------------------------------------------------------
# stage 1: image synthesis + descriptor extraction
# --------------------------------------------------------------------------

def extract(args):
    from .models import create_model, init_weights
    from .utils.checkpoints import load_native

    device = _device(args)
    h, w = args.size, args.size
    if args.checkpoint:   # stage-0 fine-tune (trained spectrum), either package's
        model = load_native(args.checkpoint).model
        print(f"extracting with {model.arch} from {args.checkpoint}", flush=True)
    else:                 # random init (the flat-spectrum worst case)
        model = init_weights(create_model(args.arch), torch.Generator().manual_seed(args.seed))
    model = model.to(device).eval()

    def describe(imgs):
        return model(imgs.permute(0, 3, 1, 2), dtype=EXTRACT_DTYPE)

    t0 = time.time()
    descs, q_descs, src_rows = [], [], []
    nb = args.n_db // args.batch
    nqb = args.n_q // args.batch
    with torch.inference_mode():
        for i in range(nb):
            imgs = db_scenes(i, args.batch, h, w, device, args.scene_shift)
            descs.append(describe(imgs))
            if i < nqb:   # queries are jittered views of the first batches
                q_descs.append(describe(query_views(i, imgs, args.scene_shift)))
                src_rows.extend(range(i * args.batch, (i + 1) * args.batch))
            if (i + 1) % 8 == 0:
                print(f"extracted {(i + 1) * args.batch}/{args.n_db}", flush=True)
        db = torch.cat(descs).float()
        qd = torch.cat(q_descs).float()
        # gate: all-NaN descriptors from a misbehaving device once graded
        # ties as recall 1.0 downstream, so fail here
        db_ok = bool(torch.isfinite(db).all())
        q_ok = bool(torch.isfinite(qd).all())
    if not (db_ok and q_ok):
        raise RuntimeError("extraction produced non-finite descriptors "
                           f"(db finite={db_ok}, q finite={q_ok}) — "
                           "re-run; do not evaluate this file")
    # raw descriptors: whitening runs in the evaluate stage, so a whitening
    # change never forces a re-extraction
    db, qd = db.cpu().numpy(), qd.cpu().numpy()
    seconds = time.time() - t0
    np.savez(args.out, db=db, q=qd, src=np.asarray(src_rows, np.int64))
    print(f"saved raw {db.shape} db / {qd.shape} q -> {args.out}", flush=True)
    return {"seconds": seconds, "n_images": nb * args.batch + len(qd)}


# --------------------------------------------------------------------------
# stage 2: tier-by-tier recall
# --------------------------------------------------------------------------

def study_whitening(raw_db: torch.Tensor):
    """The study's serving pipeline: PCA fitted on the database rows on their
    device, then whitenp=0.5 and L2. Random-init descriptors are
    rank-deficient; dead_floor zeroes the fp32 noise directions of such a
    fit, which var^-p would blow up. Returns ``(pca, whiten)``, with
    ``whiten(x, whitenv=None)``."""
    from .ops.whitening import apply_whitening, fit_pca_device

    pca = fit_pca_device(raw_db, device=raw_db.device)

    def whiten(x, whitenv=None):
        return apply_whitening(x, pca, whitenp=0.5, whitenv=whitenv, dead_floor=1e-7)

    return pca, whiten


class _HostExact:
    """``pca256_exact``'s search: the exact dot products ranked by a host
    argsort, as dirjax ranks them."""

    def __init__(self, db: np.ndarray):
        self.db = db

    def search(self, q: np.ndarray, k: int):
        scores = q @ self.db.T
        idxs = np.argsort(-scores, axis=1)[:, :k]
        return np.take_along_axis(scores, idxs, axis=1), idxs


def evaluate(args, graded: dict | None = None):
    """Whiten, build and grade every tier (``--tiers`` picks). ``graded``, if
    given, receives ``{tier: (index, queries, search knobs)}`` for every
    tier graded, so a caller can search the same indexes again."""
    from .serving import BinaryIndex, IVFPQIndex, PQIndex, RetrievalIndex
    from .tuning import exact_ground_truth, recall_at_k, tune

    device = _device(args)
    seed = args.seed
    data = np.load(args.descs)
    raw_db = torch.from_numpy(data["db"]).to(device)
    raw_q = torch.from_numpy(data["q"]).to(device)
    pca, whiten = study_whitening(raw_db)
    db_t, q_t = whiten(raw_db), whiten(raw_q)
    db, q = db_t.cpu().numpy(), q_t.cpu().numpy()
    if not (np.isfinite(db).all() and np.isfinite(q).all()):
        raise AssertionError("whitened descriptors must be finite")
    n, dim = db.shape
    print(f"{n} x {dim} db, {len(q)} queries", flush=True)
    ks = (1, 10, 100)
    gt = {k: exact_ground_truth(q, db, k) for k in ks}
    # how often is the query's true source image the exact top-1? (sanity
    # that the descriptor space is doing retrieval at all)
    src_top1 = float(np.mean(gt[1][:, 0] == data["src"][:len(q)]))
    # a jittered view should retrieve its source image most of the time;
    # anywhere near chance means the descriptors (or the gt) are garbage
    # and every tier would "pass" by reproducing meaningless ties
    if src_top1 < 0.5:
        raise RuntimeError(
            f"src_is_top1={src_top1:.4f} — the descriptor space is not "
            "doing retrieval (all-ties/NaN extraction?); refusing to "
            "grade compressed tiers against a meaningless ground truth")

    # the variance spectrum the tier guidance hinges on: how fast the
    # unwhitened descriptor variance concentrates
    evr = np.asarray(pca.variance, np.float64)
    share = np.cumsum(evr) / max(evr.sum(), 1e-30)
    spectrum = {f"top{kk}_variance_share": round(float(share[kk - 1]), 4)
                for kk in (16, 64, 256, 1024) if kk <= len(share)}
    spectrum["rank_for_99pct"] = int(np.searchsorted(share, 0.99) + 1)

    results = {"n_db": int(n), "dim": int(dim), "n_q": int(len(q)),
               "src_is_top1": round(src_top1, 4), "spectrum": spectrum,
               "tiers": {}}
    if args.tiers and os.path.exists(args.out):
        # incremental mode: keep previously graded tiers, re-grade matches
        with open(args.out) as f:
            prev = json.load(f)
        if args.section:
            prev = prev.get(args.section, {})
        if prev.get("n_db") == results["n_db"]:
            results["tiers"] = prev.get("tiers", {})
            for key in prev:
                if key.startswith("tuner"):
                    results[key] = prev[key]

    def grade(name, index, queries, note="", **knobs):
        if args.tiers and not re.search(args.tiers, name):
            return
        row = {}
        for k in ks:
            idxs = index.search(queries, k=k, **knobs)[1]
            row[f"recall@{k}"] = round(recall_at_k(idxs, gt[k]), 4)
        if note:
            row["note"] = note
        results["tiers"][name] = row
        if graded is not None:
            graded[name] = (index, queries, knobs)
        print(f"{name:34s} " + "  ".join(
            f"R@{k}={row[f'recall@{k}']:.3f}" for k in ks), flush=True)

    def wants(pattern: str) -> bool:
        """Should a (costly) tier group run at all under --tiers?"""
        return not args.tiers or bool(re.search(args.tiers, pattern))

    # --- int8 (and full-int8) --------------------------------------------
    if wants("int8"):
        i8 = RetrievalIndex(db_t, dtype=torch.int8, device=device)
        grade("int8", i8, q_t)
        grade("int8_w8q", i8, q_t, int8_queries=True,
              note="queries quantized too (fastest mode)")

    # --- PQ / OPQ ---------------------------------------------------------
    if wants("pq_m|opq"):
        for m, ksub, tag in ((32, 16, "pq_m32k16"), (16, 256, "pq_m16k256")):
            grade(tag, PQIndex(db_t, m=m, ksub=ksub, seed=seed, train_iters=10,
                               device=device), q_t)
        opq = PQIndex(db_t, m=32, ksub=16, opq=True, seed=seed, train_iters=10,
                      device=device)
        grade("opq_m32k16", opq, q_t)
        pqr = PQIndex(db_t, m=32, ksub=16, rerank=True, seed=seed, train_iters=10,
                      device=device)
        for rf in (2, 4, 8):
            grade(f"pq_m32k16_rerank{rf}", pqr, q_t, rerank_factor=rf,
                  note="int8 exact rescore of rf*k ADC candidates")

    # --- PCA-reduced tiers: quantize after dim reduction (the classic PQ
    # recipe; whitenv is the reference pipeline's own knob) ---------------
    if wants("pca256"):
        db256_t, q256_t = whiten(raw_db, 256), whiten(raw_q, 256)
        grade("pca256_exact", _HostExact(db256_t.cpu().numpy()), q256_t.cpu().numpy(),
              note="exact dot in the whitenv=256 space — the dim-"
                   "reduction cost alone, before any quantization")
        pq256 = PQIndex(db256_t, m=32, ksub=256, seed=seed, train_iters=10, device=device)
        grade("pca256_pq_m32k256", pq256, q256_t,
              note="same 32 B/row as pq_m32k16, spent on 256 dims")
        pq256r = PQIndex(db256_t, m=32, ksub=256, rerank=True, seed=seed,
                         train_iters=10, device=device)
        grade("pca256_pq_m32k256_rerank4", pq256r, q256_t, rerank_factor=4,
              note="int8(256-D) exact rescore of 4k ADC candidates")
        bi256 = BinaryIndex(db256_t, n_bits=256, asym=True, seed=seed,
                            itq_iters=30, device=device)
        grade("pca256_itq256_asym_rf4", bi256, q256_t, rerank_factor=4,
              note="32 B/row sign codes in the reduced space, exact asym")

    # --- IVF-PQ -----------------------------------------------------------
    nlist = max(16, int(np.sqrt(n)))
    if wants("ivf|tuner"):
        ivf = IVFPQIndex(db_t, nlist=nlist, m=32, ksub=16, seed=seed,
                         train_iters=10, device=device)
        for nprobe in (1, 4, 16, nlist):
            grade(f"ivf_nlist{nlist}_nprobe{nprobe}", ivf, q_t, nprobe=nprobe)

    # --- IVF with an 8-bit residual ADC -----------------------------------
    # the same cell geometry with ksub=256 (still 32 B/row) plus its
    # flat-scan equivalent, so the cost of probing and the cost of the ADC
    # stay separable
    if wants("pq_m32k256_full"):   # NB: also matches ..._rerank4 below
        grade("pq_m32k256_full", PQIndex(db_t, m=32, ksub=256, seed=seed, train_iters=10,
                                         device=device), q_t,
              note="flat-scan equivalent of ivf256's ADC budget")
    if wants("pq_m32k256_full_rerank4"):
        pqr256 = PQIndex(db_t, m=32, ksub=256, rerank=True, seed=seed,
                         train_iters=10, device=device)
        grade("pq_m32k256_full_rerank4", pqr256, q_t, rerank_factor=4,
              note="int8 exact rescore of 4k ADC candidates")
    if wants("ivf256"):
        ivf256 = IVFPQIndex(db_t, nlist=nlist, m=32, ksub=256, seed=seed,
                            train_iters=10, device=device)
        for nprobe in (4, 16):
            grade(f"ivf256_nlist{nlist}_nprobe{nprobe}", ivf256, q_t, nprobe=nprobe)

    # --- binary ITQ -------------------------------------------------------
    if wants("itq512|itq2048"):
        for bits in (512, 2048):
            nb = min(bits, (dim // 32) * 32)
            # 5 ITQ iterations for the 2048-bit rotation (a 2048^2 SVD each)
            # are near-converged, as dirjax runs them
            bi = BinaryIndex(db_t, n_bits=nb, asym=True, seed=seed,
                             itq_iters=30 if bits <= 512 else 5, device=device)
            grade(f"itq{bits}_hamming",
                  BinaryIndex(db_t, _codec=bi.codec, asym=False, device=device), q_t)
            grade(f"itq{bits}_asym_rf4", bi, q_t, rerank_factor=4,
                  note="exact asymmetric ranking (r5 fused search)")

    # --- tuner validation on held-out queries ----------------------------
    if wants("ivf|tuner"):
        half = len(q) // 2
        tuned = tune(ivf, q[:half], descriptors=db, k=10, target=args.target)
        held_idxs = ivf.search(q[half:], k=10, **tuned.params)[1]
        held_recall = recall_at_k(held_idxs, gt[10][half:])
        results["tuner"] = {
            "index": f"ivf_nlist{nlist}", "target": args.target,
            "params": tuned.params, "tune_recall": round(tuned.recall, 4),
            "met": tuned.met,
            "heldout_recall": round(float(held_recall), 4),
        }
        print(f"tune(target={args.target}) -> {tuned.params} "
              f"recall={tuned.recall:.3f} heldout={held_recall:.3f}",
              flush=True)

    # --- tuner validation #2: a tier that can meet the target -------------
    # graded against the exact oracle in its own (whitenv=256) space, the
    # tuner's contract: recall against exact search over the vectors the
    # index serves
    if wants("tuner_pca256"):
        db256_t, q256_t = whiten(raw_db, 256), whiten(raw_q, 256)
        db256, q256 = db256_t.cpu().numpy(), q256_t.cpu().numpy()
        pq256r = PQIndex(db256_t, m=32, ksub=256, rerank=True, seed=seed,
                         train_iters=10, device=device)
        half = len(q256) // 2
        tuned = tune(pq256r, q256[:half], descriptors=db256, k=10,
                     target=args.target)
        gt256 = exact_ground_truth(q256[half:], db256, k=10)
        held_idxs = pq256r.search(q256[half:], k=10, **tuned.params)[1]
        held_recall = recall_at_k(held_idxs, gt256)
        results["tuner_pca256"] = {
            "index": "pca256_pq_m32k256_rerank", "target": args.target,
            "params": tuned.params, "tune_recall": round(tuned.recall, 4),
            "met": tuned.met,
            "heldout_recall": round(float(held_recall), 4),
        }
        print(f"tune_pca256(target={args.target}) -> {tuned.params} "
              f"recall={tuned.recall:.3f} met={tuned.met} "
              f"heldout={held_recall:.3f}", flush=True)

    payload = results
    if args.section:
        payload = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                payload = json.load(f)
        payload[args.section] = results
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1)
    where = f"{args.out}[{args.section}]" if args.section else args.out
    print(f"wrote {where}", flush=True)
    return results


def main(argv=None, graded: dict | None = None):
    """Run one stage; TF32 is off inside it and as it was after. ``graded``
    is :func:`evaluate`'s."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pt = sub.add_parser("train")
    pt.add_argument("--arch", default="resnet101_rmac")
    pt.add_argument("--steps", type=int, default=400)
    pt.add_argument("--batch", type=int, default=16)
    pt.add_argument("--views", type=int, default=4,
                    help="jittered views per class per batch")
    pt.add_argument("--n-classes", type=int, default=256)
    pt.add_argument("--size", type=int, default=224)
    pt.add_argument("--lr", type=float, default=1e-4)
    pt.add_argument("--out", default=CKPT_FILE)
    pt.add_argument("--seed", type=int, default=0,
                    help="seed of the initial weights (dirjax fixes 0)")
    pt.set_defaults(fn=train)
    pe = sub.add_parser("extract")
    pe.add_argument("--n-db", type=int, default=16384)
    pe.add_argument("--n-q", type=int, default=256)
    pe.add_argument("--batch", type=int, default=32)
    pe.add_argument("--size", type=int, default=224)
    pe.add_argument("--arch", default="resnet101_rmac")
    pe.add_argument("--checkpoint", default="",
                    help="native checkpoint from the train stage "
                         "(trained-spectrum extraction)")
    pe.add_argument("--out", default=DESC_FILE)
    pe.add_argument("--seed", type=int, default=7,
                    help="seed of the random weights without --checkpoint (dirjax fixes 7)")
    pe.add_argument("--scene-shift", type=int, default=0,
                    help="added to every scene and view generator's seed (dirjax's: 0)")
    pe.set_defaults(fn=extract)
    pv = sub.add_parser("evaluate")
    pv.add_argument("--descs", default=DESC_FILE)
    pv.add_argument("--target", type=float, default=0.9)
    pv.add_argument("--out", default=OUT_FILE)
    pv.add_argument("--section", default="",
                    help="nest results under this key in --out (one file "
                         "carries the flat and trained studies)")
    pv.add_argument("--tiers", default="",
                    help="regex: grade only matching tier groups and "
                         "merge into an existing --out (incremental)")
    pv.add_argument("--seed", type=int, default=0,
                    help="seed of every quantizer's training (dirjax fixes 0)")
    pv.set_defaults(fn=evaluate)
    for sp in (pt, pe, pv):
        sp.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: cuda, which must exist)")
    args = p.parse_args(argv)
    with _fp32_products():
        if args.fn is evaluate:
            return evaluate(args, graded)
        return args.fn(args)


if __name__ == "__main__":
    main()

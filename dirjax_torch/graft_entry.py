"""Entry points (counterpart of the repository's ``__graft_entry__.py``,
which it mirrors): the flagship forward on one device, and a multi-rank dry
run of the sharded paths.

    python -m dirjax_torch.graft_entry dryrun N   # N gloo ranks on the CPU

:func:`entry` returns the ``resnet101_rmac`` bf16 descriptor forward and an
example input. :func:`dryrun_multichip` runs, over ``n`` gloo ranks on the
CPU (one process each, through :mod:`dirjax_torch.parallel`), the checks
dirjax runs on virtual CPU devices: one sharded train step (DP over
"data", TP over "db" on the FC), batch-sharded extraction, and the
database-sharded tiers (dense top-k and AQE, int8, PQ/ADC, IVF-ADC at full
probe, binary Hamming and its asymmetric rescore). dirjax's streaming
top-k mode has no counterpart in the port, so it is not checked.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

TIMEOUT = 600        # seconds the dry run's ranks may take together


def entry(device="cuda"):
    """(fn, example_args): ``fn(model, images)`` is the bf16 descriptor
    forward of a seeded ``resnet101_rmac`` (ResNet-101-GeM, the reference's
    headline checkpoint family) on ``device``, ``images`` (B, H, W, 3)."""
    from .models import create_model, init_weights

    model = init_weights(create_model("resnet101_rmac"), torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    @torch.inference_mode()
    def forward(model, images):
        return model(images.permute(0, 3, 1, 2), dtype=torch.bfloat16)

    example_args = (model, torch.zeros((1, 224, 224, 3), dtype=torch.float32,
                                       device=device))
    return forward, example_args


def _say(msg: str) -> None:
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(msg, flush=True)


def _dryrun_rank(n_devices: int) -> None:
    """One rank's share of :func:`dryrun_multichip` (the process group is up)."""
    from . import parallel as par
    from .models import create_model, init_weights
    from .ops.binary import binarize, fit_itq, hamming_topk, project_queries
    from .ops.ivf import build_ivf, ivf_topk
    from .ops.pq import encode_pq, pq_lookup, pq_scores, train_pq
    from .train import (TrainConfig, make_optimizer, make_sharded_train_step, shard_fc,
                        unshard_fc)

    db_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = par.make_mesh(data=n_devices // db_axis, db=db_axis, device_type="cpu")

    # resnet18_rmac: the sharding structure (DP batch + TP fc rows) does not
    # depend on the backbone's depth
    cfg = TrainConfig(arch="resnet18_rmac", out_dim=64, nq=10,
                      batch_size=max(2, n_devices), learning_rate=1e-3)
    model = init_weights(create_model(cfg.arch, out_dim=cfg.out_dim),
                         torch.Generator().manual_seed(0)).train()
    opt = make_optimizer(cfg, model)
    shard_fc(model, opt, mesh)
    step = make_sharded_train_step(model, cfg, opt, mesh)

    rng = np.random.default_rng(0)
    batch = max(2, n_devices)
    images = rng.normal(size=(batch, 32, 32, 3)).astype(np.float32)
    labels = np.arange(batch, dtype=np.int64) % max(2, batch // 2)
    loss_val = float(step(images, labels))
    assert np.isfinite(loss_val), f"dry-run loss not finite: {loss_val}"
    unshard_fc(model, opt, mesh)
    shape = {"data": par.axis_size(mesh, "data"), "db": par.axis_size(mesh, "db")}
    _say(f"dryrun_multichip({n_devices}): mesh={shape} train loss={loss_val:.4f}")

    # --- inference on the same mesh: DP extraction over "data" ------------
    extractor = par.ShardedExtractor(model.eval(), mesh)
    descs = extractor(rng.normal(size=(batch, 32, 32, 3)).astype(np.float32))
    assert tuple(descs.shape) == (batch, cfg.out_dim), descs.shape
    assert torch.isfinite(descs).all(), "sharded extraction produced non-finite"
    _say(f"dryrun_multichip({n_devices}): sharded extraction {tuple(descs.shape)}")

    # --- DB-sharded ranking over "db": top-k merge + AQE -------------------
    raw = rng.normal(size=(37, cfg.out_dim)).astype(np.float32)
    raw /= np.linalg.norm(raw, axis=1, keepdims=True)
    db_sharded, n_valid = par.shard_database(raw, mesh)
    q = descs[:4]
    nq = len(q)        # fewer than 4 where the batch is
    vals, idxs = par.sharded_topk(q, db_sharded, 5, mesh, n_valid)
    assert vals.shape == (nq, 5) and idxs.shape == (nq, 5)
    assert bool(((0 <= idxs) & (idxs < n_valid)).all()), "top-k index out of range"
    expanded = par.sharded_aqe(q, db_sharded, mesh, n_valid, k=3)
    assert torch.allclose(expanded.norm(dim=1), torch.ones(nq), atol=1e-4)
    _say(f"dryrun_multichip({n_devices}): sharded top-k {tuple(vals.shape)} + AQE ok")

    # --- int8-quantized sharded ranking (rows+scales over "db") -----------
    db8, scales8, n8 = par.shard_database_quantized(raw, mesh)
    v8, i8 = par.sharded_topk(q, db8, 5, mesh, n8, db_scales=scales8)
    i8 = i8.numpy()
    assert v8.shape == (nq, 5) and np.all((0 <= i8) & (i8 < n8))
    # quantization noise can swap near-ties, so compare by score: the int8
    # winner's true fp32 score must be within noise of the best
    s_fp32 = q.numpy() @ raw.T
    margin = s_fp32.max(axis=1) - s_fp32[np.arange(nq), i8[:, 0]]
    assert np.all(margin < 0.05), margin
    _say(f"dryrun_multichip({n_devices}): int8 sharded top-k ok")

    # --- product-quantized sharded ranking (codes over "db") --------------
    cb = train_pq(raw, m=4, ksub=8, iters=4, sample=None)
    codes = encode_pq(raw, cb)
    codes_sh, npq = par.shard_codes(codes, mesh)
    luts = pq_lookup(q, cb)
    vq, iq = par.sharded_pq_topk(luts, codes_sh, 5, mesh, npq)
    assert vq.shape == (nq, 5) and bool(((0 <= iq) & (iq < npq)).all())
    dense = pq_scores(luts, codes)
    picked = torch.take_along_dim(dense, iq, dim=1)
    assert torch.allclose(dense.sort(dim=1, descending=True).values[:, :5], picked,
                          atol=1e-5), "sharded ADC disagrees with dense"
    _say(f"dryrun_multichip({n_devices}): sharded PQ/ADC top-k ok")

    # --- cell-sharded inverted file (IVF-ADC over "db") -------------------
    ivf, _, icb = build_ivf(raw, nlist=4, m=4, ksub=8, slab=16, coarse_iters=4,
                            pq_iters=4, sample=None)
    iluts = pq_lookup(q, icb)
    vi1, ii1 = ivf_topk(iluts, q, ivf, 5, nprobe=ivf.nvlist)
    vi2, ii2 = par.sharded_ivf_topk(iluts, q, par.shard_ivf(ivf, mesh), 5, mesh,
                                    nprobe=ivf.nvlist * n_devices)
    assert torch.equal(ii1.to(torch.int64), ii2.to(torch.int64)), \
        "sharded IVF full probe disagrees with single-device"
    assert torch.allclose(vi1, vi2, atol=1e-4)
    _say(f"dryrun_multichip({n_devices}): sharded IVF-ADC top-k ok")

    # --- row-sharded binary-hash tier (Hamming + asym rescore over "db") --
    codec = fit_itq(raw, iters=2, sample=None)
    bcodes = binarize(raw, codec)
    bcodes_sh, nb = par.shard_codes_binary(bcodes, mesh)
    qp = binarize(q, codec)
    vb1, _ = hamming_topk(qp, bcodes, 5, n_valid=nb)
    vb2, ib2 = par.sharded_hamming_topk(qp, bcodes_sh, 5, mesh, nb)
    assert torch.equal(vb1, vb2), "sharded Hamming values disagree with single-device"
    assert bool(((0 <= ib2) & (ib2 < nb)).all())
    va, ia = par.sharded_hamming_topk(qp, bcodes_sh, 5, mesh, nb,
                                      vq=project_queries(q, codec), rerank_factor=100)
    assert torch.isfinite(va).all() and bool(((0 <= ia) & (ia < nb)).all())
    _say(f"dryrun_multichip({n_devices}): sharded binary-hash top-k ok")


def _rank_main(store: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world)
    try:
        _dryrun_rank(world)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> None:
    """Run the sharded checks over ``n_devices`` gloo ranks on the CPU (one
    subprocess a rank over a FileStore); print rank 0's lines, and raise if a
    rank fails or the ranks take over ``TIMEOUT`` seconds."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory(prefix="dirjax_torch_dryrun_") as work:
        store = os.path.join(work, "store")
        procs = [subprocess.Popen([sys.executable, "-m", "dirjax_torch.graft_entry", "_rank",
                                   store, str(r), str(n_devices)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True, env=env, cwd=work)
                 for r in range(n_devices)]
        try:
            logs = [p.communicate(timeout=TIMEOUT)[0] for p in procs]
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"dryrun_multichip({n_devices}): the ranks took over "
                               f"{TIMEOUT} s (a collective hung)") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    failed = [r for r, p in enumerate(procs) if p.returncode]
    if failed:
        raise RuntimeError("\n".join(f"rank {r} exited {procs[r].returncode}:\n"
                                     f"{logs[r][-3000:]}" for r in failed))
    print(logs[0], end="", flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["_rank"]:
        _rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
    elif sys.argv[1:2] == ["dryrun"] and len(sys.argv) == 3:
        dryrun_multichip(int(sys.argv[2]))
    else:
        print(__doc__)
        sys.exit(1)

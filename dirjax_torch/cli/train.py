"""Training CLI (counterpart of ``dirjax/cli/train.py``): fine-tunes a
descriptor model with the listwise AP loss (or batch-hard triplets) on a
labeled dataset, BN frozen by default, and writes dirjax's native
checkpoints, which ``python -m dirjax_torch.test_dir`` and
``python -m dirjax.test_dir`` both read. Same flags as dirjax's. ``--gpu -1``
trains on the CPU; any other value on ``cuda:N``, which must exist.

``--mesh DATA[,DB]`` runs the sharded step (``fit(mesh=...)``) over every
process of a ``torchrun`` world, whose size must equal DATA x DB; one
process per device: ``--gpu -1`` runs gloo on the CPU, any other value
NCCL on ``cuda:LOCAL_RANK``.
Without a ``torchrun`` environment ``--mesh 1`` (or ``1,1``) runs a world
of 1. ``--ckpt-format orbax`` writes sharded checkpoints with
``torch.distributed.checkpoint`` under OUT_DIR/orbax (dirjax's option name;
the format is torch's) and ``--resume`` takes that directory.

Examples:
    python -m dirjax_torch.train --dataset Landmarks_clean --arch resnet101_rmac \\
        --loss ap --epochs 10 --batch-size 64 --out-dir runs/r101-ap --gpu 0
    python -m torch.distributed.run --standalone --nproc-per-node 2 \\
        -m dirjax_torch.train --dataset "SyntheticLabels('/tmp/s')" \\
        --arch resnet18_rmac --out-dim 16 --batch-size 4 --epochs 1 \\
        --trfs "Scale(40), CenterCrop(32)" --out-dir /tmp/run --mesh 2 --gpu -1
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Fine-tune a descriptor model")
    parser.add_argument("--dataset", "-d", type=str, required=True,
                        help="labeled dataset spec, e.g. Landmarks_clean")
    parser.add_argument("--val-dataset", type=str, default=None,
                        help="labeled dataset for per-epoch val loss")
    parser.add_argument("--eval-dataset", type=str, default=None,
                        help="retrieval benchmark evaluated each epoch; its "
                             "mAP becomes the best-checkpoint monitor")
    parser.add_argument("--eval-trfs", type=str, default="",
                        help="transform chain for --eval-dataset extraction")
    parser.add_argument("--arch", type=str, default="resnet101_rmac")
    parser.add_argument("--out-dim", type=int, default=2048)
    parser.add_argument("--loss", type=str, default="ap",
                        choices=("ap", "tap", "taps", "triplet",
                                 "tripletlogexp"),
                        help="ap family = listwise; triplet family = "
                             "batch-hard mined (the reference's TL models)")
    parser.add_argument("--nq", type=int, default=25, help="AP quantizer bins")
    parser.add_argument("--margin", type=float, default=1.0,
                        help="triplet margin")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--lr-schedule", type=str, default="constant",
                        choices=("constant", "cosine", "step"))
    parser.add_argument("--lr-decay", type=float, default=0.1,
                        help="step-schedule decay factor")
    parser.add_argument("--lr-decay-steps", type=int, default=0,
                        help="step-schedule period in optimizer steps")
    parser.add_argument("--warmup-steps", type=int, default=0)
    parser.add_argument("--crops-per-image", type=int, default=1,
                        help="Siamese multi-crop: repeats of each sampled "
                             "image per batch, each a fresh random crop")
    parser.add_argument("--weight-decay", type=float, default=1e-6)
    parser.add_argument("--optimizer", type=str, default="adam",
                        choices=("adam", "sgd"))
    parser.add_argument("--epochs", type=int, default=10)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--microbatch", type=int, default=0,
                        help="two-pass backprop: recompute forwards in "
                             "microbatches of this size — exact listwise "
                             "gradients at O(microbatch) activation memory "
                             "(0 = whole-batch autodiff)")
    parser.add_argument("--steps-per-epoch", type=int, default=None)
    parser.add_argument("--trfs", type=str,
                        default="RandomScale(256,288), RandomCrop(224), RandomFlip()")
    parser.add_argument("--no-freeze-bn", action="store_true",
                        help="train BatchNorm scale/bias (and statistics) too")
    parser.add_argument("--checkpoint", type=str, default="",
                        help="initialize from a checkpoint (.pt or .npz)")
    parser.add_argument("--delete-fc", action="store_true",
                        help="drop the checkpoint's FC (new out_dim)")
    parser.add_argument("--resume", type=str, default="",
                        help="resume from a previous fit's checkpoint.npz "
                             "(or its --ckpt-format orbax directory)")
    parser.add_argument("--ckpt-format", type=str, default="npz",
                        choices=("npz", "orbax"),
                        help="npz: dirjax's native files, gathered to one "
                             "process; orbax: sharded async checkpoints "
                             "under OUT_DIR/orbax, written with "
                             "torch.distributed.checkpoint (dirjax's name "
                             "for the option; the format is torch's)")
    parser.add_argument("--out-dir", type=str, required=True)
    parser.add_argument("--threads", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--gpu", type=int, default=0, nargs="+",
                        help="CUDA device id; -1 selects the CPU")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 convolutions (fp32 parameters)")
    parser.add_argument("--mesh", type=str, default="",
                        help="train over a DATA[,DB] mesh of the torchrun "
                             "world: the batch data-parallel over DATA "
                             "ranks, the FC tensor-parallel over DB; e.g. "
                             "'4,2', or '8' (pure data parallel)")
    return parser


def main(argv=None):
    import torch

    from .common import setup_device

    args = build_parser().parse_args(argv)
    owns_group = mesh = None
    if args.mesh:
        import torch.distributed as dist

        from ..parallel.mesh import axis_size, make_mesh, mesh_device

        dims = [int(v) for v in args.mesh.split(",")]
        if len(dims) not in (1, 2):
            raise ValueError("--mesh takes 'data' or 'data,db'")
        gpu = (args.gpu if isinstance(args.gpu, (list, tuple)) else [args.gpu])[0]
        # as setup_device: fp32 convolutions and matmuls without TF32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        owns_group = not dist.is_initialized()
        mesh = make_mesh(dims[0], dims[1] if len(dims) == 2 else 1,
                         device_type="cpu" if gpu < 0 else "cuda")
        device = mesh_device(mesh)
        print(f"Mesh: data={axis_size(mesh, 'data')} x db={axis_size(mesh, 'db')} "
              f"on {device}")
    else:
        device = setup_device(args.gpu)
    try:
        return _run(args, device, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _run(args, device, mesh):
    import torch

    from .. import datasets
    from ..models import create_model, init_weights
    from ..train import TrainConfig, fit

    dataset = datasets.create(args.dataset)
    print("Train dataset:", dataset)
    val_dataset = datasets.create(args.val_dataset) if args.val_dataset else None

    cfg = TrainConfig(
        arch=args.arch, out_dim=args.out_dim, loss=args.loss, nq=args.nq,
        margin=args.margin,
        learning_rate=args.lr, lr_schedule=args.lr_schedule,
        lr_decay=args.lr_decay, lr_decay_steps=args.lr_decay_steps,
        warmup_steps=args.warmup_steps,
        crops_per_image=args.crops_per_image,
        weight_decay=args.weight_decay,
        optimizer=args.optimizer, freeze_bn=not args.no_freeze_bn,
        epochs=args.epochs, batch_size=args.batch_size,
        microbatch=args.microbatch, trfs=args.trfs,
        seed=args.seed, threads=args.threads)

    model = None
    if args.checkpoint:
        from ..utils.checkpoints import load_checkpoint, load_tolerant

        ckpt = load_checkpoint(args.checkpoint)
        model = init_weights(create_model(cfg.arch, out_dim=cfg.out_dim),
                             torch.Generator().manual_seed(cfg.seed))
        model = load_tolerant(model, ckpt.model.state_dict(), delete_fc=args.delete_fc)

    dtype = torch.bfloat16 if args.bf16 else torch.float32
    eval_dataset = (datasets.create(args.eval_dataset)
                    if args.eval_dataset else None)
    model, history = fit(
        dataset, cfg, val_dataset=val_dataset, model=model,
        out_dir=args.out_dir, dtype=dtype, resume=args.resume or None,
        steps_per_epoch=args.steps_per_epoch, progress=True,
        eval_dataset=eval_dataset, eval_trfs=args.eval_trfs, device=device,
        mesh=mesh, ckpt_format=args.ckpt_format)
    for h in history:
        line = f"epoch {h['epoch']}: loss {h['loss']:.4f}"
        if "val_loss" in h:
            line += f"  val_loss {h['val_loss']:.4f}"
        for k in ("mAP", "mAP-medium"):
            if k in h:
                line += f"  {k} {h[k]:.4f}"
        print(line)
    return history


if __name__ == "__main__":
    main()

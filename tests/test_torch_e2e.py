"""The port's test_dir main path held against dirjax's on the CPU, plus the
port's guarantees: it never imports jax, the kernel wrappers take their plain
versions only for CPU tensors and refuse other devices, and the kernel build
raises without nvcc."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import dirjax.datasets as D
from dirjax.models import create_model as jcreate
from dirjax.ops import fit_pca
from dirjax.utils.checkpoints import Checkpoint, save_native

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth_torch"))
    D.Synthetic(root, revisited=True)
    return root


@pytest.fixture(scope="module")
def ckpt_path(tmp_path_factory):
    model = jcreate("resnet18_rmac", out_dim=32)
    params = model.init(jax.random.PRNGKey(0))
    pca = fit_pca(np.random.default_rng(0).normal(size=(64, 32)))
    path = str(tmp_path_factory.mktemp("ckpt_torch") / "model.npz")
    save_native(path, Checkpoint(model=model, params=params,
                                 preprocess=model.preprocess,
                                 pca={"Landmarks_clean": pca}))
    return path


def _argv(synth_root, ckpt_path, *extra):
    return ["--dataset", f"Synthetic('{synth_root}')", "--checkpoint", ckpt_path,
            "--whiten", "Landmarks_clean", "--aqe", "10", "3", "--adba", "10", "3",
            "--gpu", "-1", "--threads", "2", *extra]


@pytest.mark.parametrize("extra", [("--batching", "group"),
                                   ("--batching", "bucket"),
                                   ("--tta", "flip", "--pooling", "gem")])
def test_test_dir_prints_the_same_map(synth_root, ckpt_path, extra):
    from dirjax.cli.test_dir import main as jmain
    from dirjax_torch.cli.test_dir import main as tmain

    argv = _argv(synth_root, ckpt_path, *extra)
    want, got = jmain(argv), tmain(argv)
    assert "mAP-medium" in got and set(got) == set(want)
    assert {k: f"{v:g}" for k, v in got.items()} == \
        {k: f"{v:g}" for k, v in want.items()}


def test_port_never_imports_jax(synth_root, ckpt_path, tmp_path):
    """With jax, dirjax and ml_dtypes made unimportable, the port's CLIs,
    indexes, a CPU train step, a bf16-upload batcher and the recall study's
    evaluate stage all run, and its tools import."""
    script = (
        "import sys\n"
        # any `import jax` or `import dirjax...` now raises
        "sys.modules['jax'] = None\n"
        "sys.modules['dirjax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "from dirjax_torch.test_dir import main\n"
        f"res = main({_argv(synth_root, ckpt_path)!r})\n"
        "assert 'mAP-medium' in res\n"
        "import dirjax_torch.kernels.build, dirjax_torch.kernels.concurrency\n"
        "import dirjax_torch.utils.checkpoints\n"
        "import numpy as np, torch\n"
        "import dirjax_torch.cli.index, dirjax_torch.index, dirjax_torch.serve\n"
        "from dirjax_torch.ops.topk import rank_topk_fused\n"
        "from dirjax_torch.serving import BinaryIndex, RetrievalIndex\n"
        "db = np.random.default_rng(0).normal(size=(600, 32)).astype(np.float32)\n"
        "idx = RetrievalIndex(db, dtype=torch.int8, device='cpu')\n"
        "assert idx.search(db[:3], k=20, aqe={'k': 3, 'alpha': 3.0})[1].shape == (3, 20)\n"
        "q, d = torch.from_numpy(db[:2]), torch.from_numpy(db)\n"
        "assert rank_topk_fused(q, d, 5)[1].shape == (2, 5)\n"
        "for asym in (True, False):\n"
        "    b = BinaryIndex(db, 32, itq_iters=3, asym=asym, device='cpu')\n"
        "    assert b.search(db[:3], k=7)[1].shape == (3, 7)\n"
        "from dirjax_torch.serving import IVFPQIndex, PQIndex\n"
        "import dirjax_torch.tuning\n"
        "p = PQIndex(db, m=8, ksub=16, rerank=True, train_iters=3, device='cpu')\n"
        "assert p.search(db[:3], k=9, aqe={'k': 3, 'alpha': 3.0})[1].shape == (3, 9)\n"
        "v = IVFPQIndex(db, nlist=4, m=8, ksub=16, train_iters=3, device='cpu')\n"
        "assert v.search(db[:3], k=9, nprobe=2)[1].shape == (3, 9)\n"
        "import dirjax_torch.extract_features, dirjax_torch.fit_whitening\n"
        "import dirjax_torch.extract_kapture\n"
        "from dirjax_torch.models import create_model, fold_batchnorm\n"
        "from dirjax_torch.ops import fit_pca_device\n"
        "for arch in ('resnet18_fpn_rmac', 'resnext101_32x4d_rmac'):\n"
        "    m = fold_batchnorm(create_model(arch, out_dim=16)).eval()\n"
        "    with torch.inference_mode():\n"
        "        assert m(torch.rand(1, 3, 64, 48)).shape == (1, 16)\n"
        "assert fit_pca_device(db, device='cpu').components.shape == (32, 32)\n"
        "import dirjax_torch.loss, dirjax_torch.cli.train\n"
        "import dirjax_torch.parallel, dirjax_torch.utils.dist_ckpt\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_dist_worker\n"
        "from dirjax_torch.train import TrainConfig, make_optimizer, make_train_step\n"
        "cfg = TrainConfig(arch='resnet18_rmac', out_dim=8, nq=5, batch_size=4)\n"
        "m = create_model(cfg.arch, out_dim=8)\n"
        "loss = make_train_step(m, cfg, make_optimizer(cfg, m))(\n"
        "    np.random.default_rng(0).normal(size=(4, 32, 32, 3)), [0, 0, 1, 1])\n"
        "assert np.isfinite(float(loss))\n"
        "from dirjax_torch.serve import DynamicBatcher\n"
        "bt = DynamicBatcher(RetrievalIndex(db, dtype=torch.bfloat16, device='cpu'),\n"
        "                    max_wait_ms=0.0, upload_bf16=True)\n"
        "assert bt.search(db[:3], k=4)[1][:, 0].tolist() == [0, 1, 2]\n"
        "bt.close()\n"
        "import dirjax_torch.graft_entry, dirjax_torch.validate_oracle\n"
        "import dirjax_torch.utils.misc, dirjax_torch.utils.timer\n"
        "import dirjax_torch.models.__main__, dirjax_torch.datasets.__main__\n"
        "import dirjax_torch.data.__main__\n"
        "from dirjax_torch import recall_study\n"
        f"rs = {str(tmp_path / 'rs')!r}\n"
        "np.savez(rs + '.npz', db=db, q=db[:8] + 0.01, src=np.arange(8))\n"
        "res = recall_study.main(['evaluate', '--cpu', '--descs', rs + '.npz',\n"
        "                         '--out', rs + '.json', '--tiers', 'int8'])\n"
        "assert res['tiers']['int8']['recall@1'] == 1.0\n"
        "print('NO_JAX_OK')\n")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "NO_JAX_OK" in out.stdout and " * mAP-medium = " in out.stdout


def test_port_imports_nothing_of_dirjax():
    """No module of dirjax_torch, nor chip_smoke.py, nor
    recall_spread_study.py, nor the multi-rank test worker imports the JAX
    package or any module of it (the port keeps its own copies)."""
    import ast
    import glob

    files = glob.glob(os.path.join(REPO, "dirjax_torch", "**", "*.py"), recursive=True)
    files.append(os.path.join(REPO, "chip_smoke.py"))
    files.append(os.path.join(REPO, "recall_spread_study.py"))
    files.append(os.path.join(REPO, "tests", "test_torch_dist_worker.py"))
    found = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [(os.path.relpath(path, REPO), n) for n in names
                      if n.split(".")[0] in ("dirjax", "jax")]
    assert len(files) > 40 and not found, found


def test_dispatcher_on_cpu_launches_nothing(synth_root, ckpt_path, tmp_path):
    from dirjax_torch.cli.test_dir import main as tmain
    from dirjax_torch.ops import gem_head

    gem_head.launches = 0
    tmain(_argv(synth_root, ckpt_path) + ["--whiten", "",
                                          "--profile", str(tmp_path / "prof")])
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    x = torch.rand(2, 3, 3, 8)
    gem_head.fused_gem_head(x, 3.0, torch.randn(8, 5), torch.zeros(5))
    assert gem_head.launches == 0


def test_dispatcher_refuses_other_devices():
    from dirjax_torch.ops import fused_gem_head

    x = torch.empty(2, 3, 3, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_gem_head(x, 3.0, torch.empty(8, 5, device="meta"),
                       torch.empty(5, device="meta"))


def test_topk_refuses_other_devices():
    from dirjax_torch.ops import topk

    q, db = torch.empty(2, 8, device="meta"), torch.empty(300, 8, device="meta")
    bids = torch.empty(2, 16, dtype=torch.int64, device="meta")
    for call in (lambda: topk.rank_topk_fused(q, db, 5),
                 lambda: topk.fused_topk(q, db, 5),
                 lambda: topk.finemax(q, db),
                 lambda: topk.gather_scores(q, db, bids)):
        with pytest.raises(ValueError, match="cuda or cpu"):
            call()


def test_gpu_flag_raises_without_cuda(monkeypatch):
    from dirjax_torch.cli.common import setup_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        setup_device([0])
    assert setup_device([-1]).type == "cpu"


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    import shutil

    from dirjax_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kbuild"))
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    build.load_library.cache_clear()
    with pytest.raises(build.BuildError, match="nvcc"):
        build.build()
    with pytest.raises(build.BuildError):
        build.load_library()
    assert not os.path.exists(tmp_path / "kbuild")  # nothing, not a stub


@pytest.mark.parametrize("edit", ["topk.cu", "wgmma.cuh"])
def test_build_hashes_sources_and_headers(monkeypatch, tmp_path, edit):
    """An edited source or header names another library, so a stale one is
    never reused; the shipped tree's name is stable."""
    import shutil

    from dirjax_torch.kernels import build

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC_DIR, csrc)
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    before = build.library_path()
    assert build.library_path() == before
    with open(csrc / edit, "a") as f:
        f.write("\n// edited\n")
    assert build.library_path() != before


def test_build_reports_compiler_errors(monkeypatch, tmp_path):
    from dirjax_torch.kernels import build

    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: bad source' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "kbuild"))
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    with pytest.raises(build.BuildError, match="bad source"):
        build.build()
    assert os.listdir(tmp_path / "kbuild") == []


def test_adaptive_call_halves_on_oom():
    from dirjax_torch.extraction import adaptive_call

    calls = []

    def call(images, mask):
        calls.append(len(images))
        if len(images) > 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return torch.from_numpy(images.reshape(len(images), -1).sum(1, keepdims=True))

    images = np.arange(7 * 4, dtype=np.float32).reshape(7, 2, 2)
    out = adaptive_call(call, images, np.ones((7, 2, 2), bool))
    np.testing.assert_array_equal(out[:, 0], images.reshape(7, -1).sum(1))
    assert calls == [7, 3, 1, 2, 4, 2, 2]
    with pytest.raises(torch.cuda.OutOfMemoryError):
        adaptive_call(lambda i, m: call(np.repeat(i, 3, axis=0), m), images[:1])

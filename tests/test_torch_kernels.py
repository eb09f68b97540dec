"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports no jax, so it also runs on a machine
with the card and no JAX; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances:
- K1 (GeM head): rtol 2e-4 / atol 2e-5, as tests/test_pallas_kernels.py
  holds the TPU kernel to its oracle: the kernel sums H*W cells and C
  products in another order than ATen, and the pow/log/exp chain of GeM
  amplifies last-bit differences by about p.
- K2-K4 (top-k): scores of unit vectors within atol 1e-5 (fp32 sums of at
  most 2048 exact products, in another order than cuBLAS); int8 x int8
  scores exactly equal (int32 accumulation on both sides). An index may
  differ only where the plain scores of both rows lie within 1e-5. K4's
  maxima over each fetched block equal K3's bit for bit.
- K5 (binary codes): symmetric maxima exactly equal (integers); asymmetric
  within atol 1e-5 (projected unit queries, fp32 sums of exact ±bf16 terms
  in another order); the rescore's block maxima equal K5's bit for bit;
  hamming_search_fused returns the values of the plain top-k.
"""

import numpy as np
import pytest
import torch

from dirjax_torch.ops import binary, gem_head, topk

torch.set_num_threads(1)

RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _head_inputs(rng, device, B, H, W, C, D):
    """x, W as the (C, D) view of an nn.Linear (D, C) weight, b, mask."""
    x = torch.from_numpy((rng.random((B, H, W, C)) + 0.05).astype(np.float32))
    weight = torch.from_numpy((rng.normal(size=(D, C)) * 0.02).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(D,)) * 0.01).astype(np.float32))
    mask = torch.zeros((B, H, W), dtype=torch.bool)
    mask[0, :max(1, H - 3), :max(1, W - 2)] = True
    mask[1:] = True
    return x.to(device), weight.to(device).T, b.to(device), mask.to(device)


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
class TestGemHeadKernel:
    """K1 (csrc/gem_head.cu) against gem_head_reference."""

    @pytest.mark.parametrize("shape", [(2, 9, 5, 128, 256), (3, 4, 7, 300, 200),
                                       (9, 32, 24, 2048, 2048)])
    @pytest.mark.parametrize("masked", [False, True])
    def test_matches_reference(self, rng, cuda, shape, masked):
        x, w, b, mask = _head_inputs(rng, cuda, *shape)
        m = mask if masked else None
        p = torch.tensor([2.5], device=cuda)
        before = gem_head.launches
        got = gem_head.fused_gem_head(x, p, w, b, mask=m)
        assert gem_head.launches == before + 1
        _close(got, gem_head.gem_head_reference(x, m, p, w, b))

    def test_bf16_input(self, rng, cuda):
        x, w, b, mask = _head_inputs(rng, cuda, 4, 8, 6, 256, 384)
        xb = x.to(torch.bfloat16)
        got = gem_head.fused_gem_head(xb, 3.0, w, b, mask=mask)
        _close(got, gem_head.gem_head_reference(xb.float(), mask, 3.0, w, b))

    def test_rejects_bad_layout(self, rng, cuda):
        x, w, b, _ = _head_inputs(rng, cuda, 2, 4, 4, 64, 64)
        with pytest.raises(ValueError, match="contiguous"):
            gem_head.fused_gem_head(x.permute(0, 3, 1, 2), 3.0, w, b)
        with pytest.raises(ValueError, match="fp32"):
            gem_head.fused_gem_head(x, 3.0, w.double(), b)
        with pytest.raises(ValueError, match="linear.weight.T"):
            gem_head.fused_gem_head(x, 3.0, w.contiguous(), b)


TOPK_ATOL = 1e-5


def _unit(rng, rows, d):
    x = rng.normal(size=(rows, d)).astype(np.float32)
    return torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True))


def _operands(rng, device, mode, nq, n, d):
    """(q, db, scales) in one of the kernels' operand modes."""
    q, db = _unit(rng, nq, d).to(device), _unit(rng, n, d).to(device)
    if mode == "fp32":
        return q, db, None
    if mode == "bf16":
        return q.bfloat16(), db.bfloat16(), None
    db8, scales = topk.quantize_db(db)
    if mode == "int8":
        return q.bfloat16(), db8, scales.reshape(-1)
    q8, _ = topk._quantize_block(q)
    return q8, db8, scales.reshape(-1)


def _close_scores(got, want, exact):
    if exact:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=TOPK_ATOL,
                                   equal_nan=True)


def _same_ranking(got_v, got_i, want_v, want_i, scores):
    """Values within the tolerance; a differing index only at a near-tie."""
    torch.testing.assert_close(got_v, want_v, rtol=0, atol=TOPK_ATOL)
    diff = got_i != want_i
    if diff.any():
        rows = torch.nonzero(diff)[:, 0]
        picked = scores[rows, got_i[diff]]
        assert (picked - want_v[diff]).abs().max() <= TOPK_ATOL


@pytest.mark.cuda
class TestTopkKernels:
    """K2-K4 (csrc/topk.cu) against their plain versions."""

    @pytest.mark.parametrize("mode,nq,n,d,k", [
        ("fp32", 1, 1000, 96, 5), ("bf16", 37, 4099, 128, 16),
        ("fp32", 20, 3000, 2048, 10), ("bf16", 256, 1537, 64, 1)])
    def test_fused_topk(self, rng, cuda, mode, nq, n, d, k):
        q, db, _ = _operands(rng, cuda, mode, nq, n, d)
        before = topk.launches["fused_topk"]
        vals, idxs = topk.fused_topk(q, db, k)
        assert topk.launches["fused_topk"] == before + 1
        want_v, want_i = topk.fused_topk_reference(q, db, k)
        assert vals.shape == want_v.shape == (nq, -(-n // 512) * k)
        _same_ranking(vals, idxs, want_v, want_i,
                      torch.nn.functional.pad(topk._scores(q, db), (0, 1)))
        assert torch.equal(idxs < 0, want_i < 0)

    @pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "int8x8"])
    @pytest.mark.parametrize("nq,n,d", [(1, 5003, 128), (37, 2048, 200),
                                        (130, 777, 2048)])
    def test_finemax_and_gather(self, rng, cuda, mode, nq, n, d):
        q, db, scales = _operands(rng, cuda, mode, nq, n, d)
        blocks = -(-n // 1024) * 128
        before = dict(topk.launches)
        fmax = topk.finemax(q, db, scales, blocks=blocks)
        exact = mode == "int8x8"
        _close_scores(fmax, topk.finemax_reference(q, db, scales, blocks), exact)
        assert torch.isinf(fmax[:, -(-n // 8):]).all()
        nb = n // 8
        bids = torch.from_numpy(rng.integers(0, nb, size=(nq, 32))).to(cuda)
        raw = topk.gather_scores(q, db, bids)
        want = topk.gather_scores_reference(q, db, bids)
        if scales is not None:   # compare scores, as the finish step scales them
            s = scales[(bids[:, :, None] * 8 + torch.arange(8, device=cuda))
                       .reshape(nq, -1)]
            raw, want = raw * s, want * s
        _close_scores(raw, want, exact)
        assert topk.launches["finemax"] == before["finemax"] + 1
        assert topk.launches["gather_scores"] == before["gather_scores"] + 1
        # containment needs K4's block maxima to be K3's, bit for bit
        block_max = raw.reshape(nq, -1, 8).amax(dim=2)
        assert torch.equal(block_max, torch.gather(fmax, 1, bids))

    def test_gather_marks_blocks_outside(self, rng, cuda):
        q, db, _ = _operands(rng, cuda, "bf16", 3, 100, 64)
        bids = torch.tensor([[0, 11, 12, 13, -1] + [0] * 11] * 3, device=cuda)
        raw = topk.gather_scores(q, db, bids).reshape(3, -1, 8)
        assert torch.isnan(raw[:, 2:5]).all() and not torch.isnan(raw[:, :2]).any()

    @pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "int8x8"])
    @pytest.mark.parametrize("k", [7, 100])
    def test_rank_topk_fused(self, rng, cuda, mode, k):
        nq, n, d = 9, 3003, 256
        q, db, scales = _operands(rng, cuda, mode, nq, n, d)
        qf = _unit(rng, nq, d).to(cuda)
        opts = {} if scales is None else {"db_scales": scales.reshape(1, -1),
                                          "quantize_queries": mode == "int8x8"}
        vals, idxs = topk.rank_topk_fused(qf, db, k, **opts)
        want_v, want_i = topk.rank_topk_fused(qf.cpu(), db.cpu(), k,
                                              **{key: getattr(v, "cpu", lambda: v)()
                                                 for key, v in opts.items()})
        if scales is None:
            plain = topk._scores(qf.to(db.dtype), db)
        elif mode == "int8":
            plain = topk._scores(qf.bfloat16(), db) * scales
        else:
            q8, qs = topk._quantize_block(qf)
            plain = topk._scores(q8, db) * scales * qs[:, None]
        _same_ranking(vals, idxs, want_v.to(cuda), want_i.to(cuda), plain)

    def test_rejects_bad_operands(self, rng, cuda):
        q, db, _ = _operands(rng, cuda, "bf16", 4, 256, 64)
        with pytest.raises(ValueError, match="no kernel"):
            topk.finemax(q.half(), db)
        with pytest.raises(ValueError, match="no kernel"):
            topk.fused_topk(q, db.to(torch.int8), 3)
        with pytest.raises(ValueError, match="contiguous"):
            topk.finemax(q, db.T.contiguous().T)
        with pytest.raises(ValueError, match="share D"):
            topk.fused_topk(q[:, :32].contiguous(), db, 3)
        with pytest.raises(ValueError, match="int64"):
            topk.gather_scores(q, db, torch.zeros((4, 16), dtype=torch.int32,
                                                  device=cuda))
        with pytest.raises(ValueError, match="scales"):
            topk.finemax(q, db, torch.ones(255, device=cuda))


def _codes_and_queries(rng, device, nq, n, d):
    """(n, d/8) uint8 codes and a unit-query codec over d = n_bits dims."""
    proj, _ = np.linalg.qr(rng.normal(size=(d, d)))
    codec = binary.BinaryCodec(torch.zeros(d, device=device),
                               torch.from_numpy(proj.astype(np.float32)).to(device))
    codes = binary.binarize(_unit(rng, n, d).to(device), codec)
    return codes, _unit(rng, nq, d).to(device), codec


@pytest.mark.cuda
class TestBinaryKernels:
    """K5 and the asymmetric rescore (csrc/binary.cu) against their plain
    versions."""

    @pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
    @pytest.mark.parametrize("nq,n,d", [(1, 5003, 32), (37, 2048, 64),
                                        (130, 777, 2048), (256, 3001, 256)])
    def test_finemax_and_rescore(self, rng, cuda, asym, nq, n, d):
        codes, qf, codec = _codes_and_queries(rng, cuda, nq, n, d)
        qb, vq = binary.binarize_and_project(qf, codec)
        q = vq.bfloat16().contiguous() if asym else qb
        blocks = -(-n // 1024) * 128
        before = dict(binary.launches)
        fmax = binary.bits_finemax(q, codes, blocks)
        assert binary.launches["bits_finemax"] == before["bits_finemax"] + 1
        want = binary.bits_finemax_reference(q, codes, blocks)
        if asym:
            torch.testing.assert_close(fmax, want, rtol=0, atol=TOPK_ATOL)
        else:
            assert torch.equal(fmax, want)
        assert torch.isinf(fmax[:, -(-n // 8):]).all()
        if asym:
            bids = torch.from_numpy(rng.integers(0, n // 8, size=(nq, 32))).to(cuda)
            raw = binary.bits_gather_scores(q, codes, bids)
            assert binary.launches["bits_gather_scores"] == before["bits_gather_scores"] + 1
            torch.testing.assert_close(raw, binary.bits_gather_scores_reference(q, codes, bids),
                                       rtol=0, atol=TOPK_ATOL)
            # containment needs the rescore's block maxima to be K5's, bit for bit
            assert torch.equal(raw.reshape(nq, -1, 8).amax(dim=2), torch.gather(fmax, 1, bids))

    @pytest.mark.parametrize("asym", [False, True], ids=["sym", "asym"])
    @pytest.mark.parametrize("k", [1, 10, 100])
    def test_search_returns_the_plain_top_k(self, rng, cuda, asym, k):
        nq, n, d = 9, 4099, 256
        codes, qf, codec = _codes_and_queries(rng, cuda, nq, n, d)
        vals, idxs = binary.hamming_search_fused(qf, codec, codes, k, asym=asym)
        qb, vq = binary.binarize_and_project(qf, codec)
        q = vq.bfloat16().float() if asym else binary.unpack_pm1(qb)
        scores = q @ binary.unpack_pm1(codes).T
        want, _ = torch.sort(scores, dim=1, descending=True)
        torch.testing.assert_close(vals, want[:, :k], rtol=0, atol=TOPK_ATOL)
        torch.testing.assert_close(torch.gather(scores, 1, idxs), vals, rtol=0, atol=TOPK_ATOL)

    def test_gather_marks_blocks_outside(self, rng, cuda):
        codes, qf, codec = _codes_and_queries(rng, cuda, 3, 100, 64)
        q = binary.project_queries(qf, codec).bfloat16().contiguous()
        bids = torch.tensor([[0, 11, 12, 13, -1] + [0] * 11] * 3, device=cuda)
        raw = binary.bits_gather_scores(q, codes, bids).reshape(3, -1, 8)
        assert torch.isnan(raw[:, 2:5]).all() and not torch.isnan(raw[:, :2]).any()

    def test_rejects_bad_operands(self, rng, cuda):
        codes, qf, codec = _codes_and_queries(rng, cuda, 4, 256, 64)
        qb = binary.binarize(qf, codec)
        with pytest.raises(ValueError, match="queries must be"):
            binary.bits_finemax(qf, codes)
        with pytest.raises(ValueError, match="multiple of 4"):
            binary.bits_finemax(qb[:, :6].contiguous(), codes[:, :6].contiguous())
        with pytest.raises(ValueError, match="asymmetric"):
            binary.bits_gather_scores(qb, codes, torch.zeros((4, 16), dtype=torch.int64,
                                                              device=cuda))

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (a CUDA kernel has no CPU mode) and
skips without one. The file imports no jax, so it also runs on a machine
with the card and no JAX; there, skip tests/conftest.py (which sets JAX up):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

Tolerances:
- K1 (GeM head): rtol 2e-4 / atol 2e-5, as tests/test_pallas_kernels.py
  holds the TPU kernel to its oracle: the kernel sums H*W cells and C
  products in another order than ATen, takes each power as exp2(p log2 v)
  on the special-function unit (2-ulp lg2/ex2), and the pow/log/exp chain
  of GeM amplifies last-bit differences by about p. Two calls on one card
  give equal bits (the split sums meet in a fixed order).
- K2-K4 (top-k): scores of unit vectors within atol 1e-5. Every mode runs
  on the tensor cores. bf16 and int8 x bf16 products are exact and their
  fp32 accumulation runs in another order than cuBLAS's; fp32 splits each
  operand into two bf16 parts and sums the four products hi.hi + hi.lo +
  lo.hi + lo.lo, which miss the fp32 product by the split's residuals alone
  (below 1e-6 at D = 2048, tests/test_torch_topk.py models it), held to the
  same 1e-5 on random queries and on self-match queries (database rows,
  where every product is >= 0). int8 x int8 scores exactly equal (int32
  accumulation on both sides). An index may differ only where the plain
  scores of both rows lie within 1e-5; where K2 returns equal values in a
  slab (duplicated rows), the lower row comes first. K4's maxima over each
  fetched block equal K3's bit for bit. The cases take every query width of
  the tensor-core kernels (8, 16, 32, 64, 128, 256; K2 up to 64) with full
  and partial query groups (nq 1, 9, 16, 24, 37, 100, 130, 257), each width
  at D = 2048 too, ragged row tiles and slabs, and D = 64, 96, 200, 201 and
  2048 (int8 rows of 200 or 201 bytes are not 16-byte aligned and still run
  on the kernel).
- K5 (binary codes, on the tensor cores): symmetric maxima exactly equal
  (int8 ±1 products summed in int32); asymmetric within atol 1e-5
  (projected unit queries: exact ±bf16 products, fp32 sums of each stage,
  128 or 512 d, added in another order than the plain matmul's); the
  rescore's block maxima equal K5's bit for bit. The cases take every query
  width of the tensor-core routine (nq 1, 8, 16, 24, 37, 64, 100, 128, 256:
  N = 8 ... 256, 128 for asymmetric) at n_bits 32, 64, 256 and 2048 on
  ragged row counts; hamming_search_fused returns the values of the plain
  top-k.
- K6 (ADC fine maxima) and its rescore: exactly equal to their plain
  versions, which add the same fp32 table values in the same order, at
  m 8, 32, 64, 128 x ksub 16, 256, fp32 and bf16 tables, blocks 1, 8, 64
  (a lane folds its own rows) and 96 (an IVF slab that does not divide 64:
  the fold goes through shared memory); the rescore's block maxima equal
  K6's bit for bit; the rescore also at blocks 1, 8, 64 and 100 with kf = 1
  and 300, m 8, 32, 64, NaN for ids outside the blocks; pq_topk and
  ivf_topk at full probe return the dense plain ADC top-k's values.
- The fused-epilogue convolution (csrc/conv.cu) against conv_reference, an
  fp32 convolution (TF32 off) of the same bf16 operands with the same fp32
  epilogue: no element further than SUM_ORDER_RTOL (2^-16) of the sum of its
  products' magnitudes (the fp32 sums over K run in another order), plus one
  bf16 ulp for a bf16 output, and at most 1e-3 of a bf16 output's elements
  not equal. Cases: every epilogue of the backbones and the FPN merge, the
  stem's 3 channels, 1x1/3x3/7x7 at strides 1 and 2, groups of 4, 8 and 32
  channels, ragged pixel tiles and channel counts of every tile width; a
  shape no path takes is refused before any launch.
"""

import numpy as np
import pytest
import torch

from dirjax_torch.kernels import concurrency
from dirjax_torch.ops import binary, conv, gem_head, ivf, pq, topk

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

    @pytest.mark.parametrize("shape", [(1, 1, 1, 100, 64), (9, 5, 7, 2047, 2000),
                                       (17, 3, 5, 128, 256), (2, 9, 5, 256, 128)],
                             ids=["hw1_c100", "b9_c2047_d2000", "b17", "hw45"])
    @pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("p", [1.0, 8.0])
    def test_edge_shapes(self, rng, cuda, shape, dt, p):
        """C off the vector width (100 in bf16, 2047), H*W = 1 and H*W that
        no split count divides, B = 1, 9, 17, D = 2000, a row whose mask is
        all False, p = 1 and 8; two calls give equal bits."""
        x, w, b, mask = _head_inputs(rng, cuda, *shape)
        if shape[0] > 2:
            mask[2] = False
        xin = x.to(dt)
        got = gem_head.fused_gem_head(xin, p, w, b, mask=mask)
        _close(got, gem_head.gem_head_reference(xin.float(), mask, p, w, b))
        assert torch.equal(got, gem_head.fused_gem_head(xin, p, w, b, mask=mask))
        _close(gem_head.fused_gem_head(xin, p, w, b),
               gem_head.gem_head_reference(xin.float(), None, p, w, b))

    def test_refuses_a_gradient(self, rng, cuda):
        """The kernel has no backward: with grad mode on, an operand that
        requires grad raises rather than drop its gradient; the same call
        launches under no_grad and inference_mode."""
        x, w, b, _ = _head_inputs(rng, cuda, 2, 4, 4, 64, 64)
        p = torch.tensor([3.0], device=cuda)
        for args in ((x.requires_grad_(True), p, w, b), (x.detach(), p.requires_grad_(True), w, b),
                     (x.detach(), 3.0, w.detach().requires_grad_(True), b)):
            with pytest.raises(RuntimeError, match="no backward"):
                gem_head.fused_gem_head(*args)
            before = gem_head.launches
            with torch.no_grad():
                got = gem_head.fused_gem_head(*args)
            with torch.inference_mode():
                again = gem_head.fused_gem_head(*args)
            assert gem_head.launches == before + 2 and torch.equal(got, again)

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

    @pytest.mark.parametrize("mode,nq,n,d,k,ties", [
        ("fp32", 1, 1000, 96, 5, False), ("bf16", 37, 4099, 128, 16, False),
        ("fp32", 20, 3000, 2048, 10, False), ("bf16", 256, 1537, 64, 1, False),
        ("bf16", 1, 2048, 2048, 10, True), ("bf16", 9, 3001, 200, 1, True),
        ("bf16", 130, 1029, 96, 16, True), ("bf16", 257, 5000, 2048, 10, False),
        ("bf16", 16, 700, 201, 16, True), ("bf16", 3, 700, 64, 600, True),
        ("fp32", 9, 1029, 200, 16, True), ("bf16", 16, 1537, 2048, 16, True),
        ("bf16", 24, 3001, 2048, 10, True), ("bf16", 100, 2100, 2048, 1, False)])
    def test_fused_topk(self, rng, cuda, mode, nq, n, d, k, ties):
        q, db, _ = _operands(rng, cuda, mode, nq, n, d)
        if ties:   # every 5th row from row 3 repeats the row 3 before it
            db[3::5] = db[0:n - 3:5][:len(db[3::5])]
        before = topk.launches["fused_topk"]
        vals, idxs = topk.fused_topk(q, db, k)
        assert topk.launches["fused_topk"] == before + 1
        want_v, want_i = topk.fused_topk_reference(q, db, k)
        assert vals.shape == want_v.shape == (nq, -(-n // 512) * k)
        _same_ranking(vals, idxs, want_v, want_i,
                      torch.nn.functional.pad(topk._scores(q, db), (0, 1)))
        assert torch.equal(idxs < 0, want_i < 0)
        # exact ties within a slab come back lower row first
        v, i = vals.reshape(nq, -1, k), idxs.reshape(nq, -1, k)
        tied = (v[:, :, 1:] == v[:, :, :-1]) & torch.isfinite(v[:, :, 1:])
        assert (i[:, :, 1:] > i[:, :, :-1])[tied].all()
        if ties:   # a repeated row comes after its twin, 3 rows before it
            dup = (i % 5 == 3) & (i >= 3) & ((i - 3) // 512 == i // 512)
            twin = i[:, :, None, :] == (i - 3)[:, :, :, None]
            earlier = torch.ones(k, k, dtype=torch.bool, device=cuda).tril(-1)
            assert (twin & earlier).any(-1)[dup].all()

    @pytest.mark.parametrize("mode", ["fp32", "bf16", "int8", "int8x8"])
    @pytest.mark.parametrize("nq,n,d", [(1, 5003, 128), (37, 2048, 200),
                                        (130, 777, 2048), (9, 4099, 96),
                                        (257, 3001, 64), (16, 1031, 200),
                                        (9, 1001, 201), (257, 2100, 2048),
                                        (16, 1537, 2048), (24, 3001, 2048),
                                        (100, 2100, 2048), (1, 1029, 2048),
                                        (37, 1031, 2048)])
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

    @pytest.mark.parametrize("nq,n", [(16, 3001), (100, 2100), (256, 4099)])
    def test_fp32_self_match(self, rng, cuda, nq, n):
        """fp32 queries equal to database rows (every product of a self-match
        is >= 0, so the split's errors could only add up): K2, K3 and K4
        against their plain versions, K4's block maxima K3's."""
        db = _unit(rng, n, 2048).to(cuda)
        q = db[torch.from_numpy(rng.choice(n, nq, replace=False)).to(cuda)]
        vals, idxs = topk.fused_topk(q, db, 10)
        want_v, want_i = topk.fused_topk_reference(q, db, 10)
        _same_ranking(vals, idxs, want_v, want_i,
                      torch.nn.functional.pad(topk._scores(q, db), (0, 1)))
        blocks = -(-n // 1024) * 128
        fmax = topk.finemax(q, db, None, blocks=blocks)
        _close_scores(fmax, topk.finemax_reference(q, db, None, blocks), False)
        bids, _ = topk._hier_select(fmax, 100, 1024, n)
        raw = topk.gather_scores(q, db, bids)
        _close_scores(raw, topk.gather_scores_reference(q, db, bids), False)
        assert torch.equal(raw.reshape(nq, -1, 8).amax(dim=2), torch.gather(fmax, 1, bids))

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
    @pytest.mark.parametrize("d", [32, 64, 256, 2048])
    @pytest.mark.parametrize("nq", [1, 8, 16, 24, 37, 64, 100, 128, 256])
    def test_finemax_and_rescore(self, rng, cuda, asym, nq, d):
        n = {32: 5003, 64: 2051, 256: 3001, 2048: 1029}[d]   # ragged tiles and blocks
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


def _adc_operands(rng, device, nq, n, m, ksub, dt):
    luts = torch.from_numpy(rng.normal(size=(nq, m, ksub)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, ksub, size=(n, m)).astype(np.uint8))
    return luts.to(device, dt).contiguous(), codes.to(device)


@pytest.mark.cuda
class TestADCKernels:
    """K6 and the ADC rescore (csrc/pq.cu) against their plain versions."""

    @pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("m", [8, 32, 64, 128])
    @pytest.mark.parametrize("ksub", [16, 256])
    @pytest.mark.parametrize("block", [1, 8, 64, 96])
    @pytest.mark.parametrize("nq,n", [(1, 5003), (37, 4096), (256, 3001)])
    def test_finemax_and_rescore(self, rng, cuda, dt, m, ksub, block, nq, n):
        luts, codes = _adc_operands(rng, cuda, nq, n, m, ksub, dt)
        before = dict(pq.launches)
        fmax = pq.adc_finemax(luts, codes, block)
        assert pq.launches["adc_finemax"] == before["adc_finemax"] + 1
        nb = -(-n // block)
        assert fmax.shape == (nq, nb)
        assert torch.equal(fmax, pq.adc_finemax_reference(luts, codes, block))
        bids = torch.from_numpy(rng.integers(0, nb, size=(nq, 24))).to(cuda)
        bids[:, 0] = nb - 1                    # the ragged last block
        raw = pq.adc_gather_scores(luts, codes, bids, block)
        assert pq.launches["adc_gather_scores"] == before["adc_gather_scores"] + 1
        assert torch.equal(raw, pq.adc_gather_scores_reference(luts, codes, bids, block))
        # containment needs the rescore's block maxima to be K6's, bit for bit
        assert torch.equal(raw.reshape(nq, -1, block).amax(dim=2), torch.gather(fmax, 1, bids))

    @pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("ksub", [16, 256])
    @pytest.mark.parametrize("m", [8, 32, 64])
    @pytest.mark.parametrize("kf", [1, 300])
    @pytest.mark.parametrize("block", [1, 8, 64, 100])
    def test_rescore_shapes(self, rng, cuda, block, kf, m, ksub, dt):
        """The rescore at every block its callers pass (an odd IVF slab of
        100 too), kf = 1 and 300, on ragged rows: exactly its plain version,
        NaN for ids outside [0, ceil(n / block)), and K6's block maxima bit
        for bit."""
        nq, n = 5, 5003
        luts, codes = _adc_operands(rng, cuda, nq, n, m, ksub, dt)
        nb = -(-n // block)
        bids = torch.from_numpy(rng.integers(0, nb, size=(nq, kf))).to(cuda)
        bids[0, 0] = nb - 1                    # the ragged last block
        if kf > 2:
            bids[1, 1], bids[2, 2] = -1, nb
        raw = pq.adc_gather_scores(luts, codes, bids, block)
        torch.testing.assert_close(raw, pq.adc_gather_scores_reference(luts, codes, bids, block),
                                   rtol=0, atol=0, equal_nan=True)
        valid = (bids >= 0) & (bids < nb)
        assert torch.equal(raw.reshape(nq, kf, block).isnan().all(2), ~valid)
        fmax = pq.adc_finemax(luts, codes, block)
        maxima = raw.reshape(nq, kf, block).amax(dim=2)
        assert torch.equal(maxima[valid], torch.gather(fmax, 1, bids.clamp(0, nb - 1))[valid])

    @pytest.mark.parametrize("block", [1, 64, 100, 300])
    def test_any_block(self, rng, cuda, block):
        luts, codes = _adc_operands(rng, cuda, 5, 1000, 16, 16, torch.float32)
        fmax = pq.adc_finemax(luts, codes, block)
        assert fmax.shape == (5, -(-1000 // block))
        assert torch.equal(fmax, pq.adc_finemax_reference(luts, codes, block))

    def test_more_query_groups_than_grid_rows(self, cuda):
        """70,001 queries at m = 64, ksub = 256: 2,188 query groups of 32
        (more than a grid has rows, 65,535, were they one a CTA) that the
        persistent CTAs walk, restaging the tables a group of subspaces at a
        time."""
        nq, n, m, ksub, block = 70_001, 300, 64, 256, 8
        g = torch.Generator(device=cuda).manual_seed(0)
        luts = torch.randn((nq, m, ksub), generator=g, device=cuda).bfloat16()
        codes = torch.randint(0, ksub, (n, m), generator=g, device=cuda).to(torch.uint8)
        fmax = pq.adc_finemax(luts, codes, block)
        assert torch.equal(fmax, pq.adc_finemax_reference(luts, codes, block))
        bids = torch.randint(0, -(-n // block), (nq, 4), generator=g, device=cuda)
        raw = pq.adc_gather_scores(luts, codes, bids, block)
        assert torch.equal(raw, pq.adc_gather_scores_reference(luts, codes, bids, block))
        assert torch.equal(raw.reshape(nq, -1, block).amax(dim=2), torch.gather(fmax, 1, bids))

    def test_gather_marks_blocks_outside(self, rng, cuda):
        luts, codes = _adc_operands(rng, cuda, 3, 100, 8, 16, torch.float32)
        raw = pq.adc_gather_scores(luts, codes, torch.tensor([[0, 1, -1, 2]] * 3, device=cuda),
                                   64).reshape(3, 4, 64)
        assert torch.isnan(raw[:, 2:]).all() and not torch.isnan(raw[:, :2]).any()
        assert torch.isinf(raw[:, 1, 36:]).all() and torch.isfinite(raw[:, 1, :36]).all()

    @pytest.mark.parametrize("dt", [None, torch.bfloat16], ids=["fp32", "bf16"])
    @pytest.mark.parametrize("m,ksub", [(32, 16), (16, 256)])
    @pytest.mark.parametrize("k", [1, 10, 100])
    def test_pq_topk_returns_the_plain_top_k(self, rng, cuda, dt, m, ksub, k):
        luts, codes = _adc_operands(rng, cuda, 9, 40_003, m, ksub, torch.float32)
        before = dict(pq.launches)
        vals, idxs = pq.pq_topk(luts, codes, k, compute_dtype=dt)
        assert pq.launches["adc_finemax"] == before["adc_finemax"] + 1
        assert pq.launches["adc_gather_scores"] == before["adc_gather_scores"] + 1
        scores = pq.adc_finemax_reference(pq._round_luts(luts, dt), codes, 1)
        want, _ = torch.sort(scores, dim=1, descending=True)
        torch.testing.assert_close(vals, want[:, :k], rtol=0, atol=1e-6)
        torch.testing.assert_close(torch.gather(scores, 1, idxs), vals, rtol=0, atol=1e-6)

    @pytest.mark.parametrize("union", [False, True], ids=["per-query", "union"])
    def test_ivf_full_probe_is_dense_adc(self, rng, cuda, union):
        x = _unit(rng, 20_000, 64).to(cuda)
        arrays, cents, books = ivf.build_ivf(x, 32, m=16, ksub=16, pq_iters=3, coarse_iters=3)
        q = _unit(rng, 7, 64).to(cuda)
        luts = pq.pq_lookup(q, books)
        before = dict(pq.launches)
        vals, idxs = ivf.ivf_topk(luts, q, arrays, 50, nprobe=arrays.nvlist, union=union)
        key = "adc_finemax" if union else "adc_gather_scores"
        assert pq.launches[key] > before[key]
        assign, codes = ivf.unbin_ivf(arrays, 20_000)
        bias = (q.double() @ cents.double().T).float()[:, torch.from_numpy(assign).long().to(cuda)]
        scores = bias + pq.adc_finemax_reference(luts, torch.from_numpy(codes).to(cuda), 1)
        want, _ = torch.sort(scores, dim=1, descending=True)
        torch.testing.assert_close(vals, want[:, :50], rtol=0, atol=1e-6)
        torch.testing.assert_close(torch.gather(scores, 1, idxs), vals, rtol=0, atol=1e-6)

    def test_rejects_bad_operands(self, rng, cuda):
        luts, codes = _adc_operands(rng, cuda, 4, 256, 8, 16, torch.float32)
        bids = torch.zeros((4, 2), dtype=torch.int64, device=cuda)
        with pytest.raises(ValueError, match="fp32 or bf16"):
            pq.adc_finemax(luts.half(), codes, 64)
        with pytest.raises(ValueError, match="uint8"):
            pq.adc_finemax(luts, codes.int(), 64)
        with pytest.raises(ValueError, match="uint8"):
            pq.adc_finemax(luts, codes[:, :4].contiguous(), 64)
        with pytest.raises(ValueError, match="contiguous"):
            pq.adc_finemax(luts.transpose(1, 2).contiguous().transpose(1, 2), codes, 64)
        with pytest.raises(ValueError, match="block must be positive"):
            pq.adc_finemax(luts, codes, 0)
        with pytest.raises(ValueError, match="bids"):
            pq.adc_gather_scores(luts, codes, bids.int(), 64)
        with pytest.raises(ValueError, match="block"):
            pq.adc_gather_scores(luts, codes, bids, 0)


# --- launches from several host threads --------------------------------------

@pytest.mark.cuda
class TestConcurrentLaunches:
    """Launches of one kernel from 8 host threads at once, 50 a thread,
    alternating two shapes whose dynamic shared memory differs
    (``dirjax_torch.kernels.concurrency``): K6 resident m 8 / 64 at ksub 16,
    57,472 / 172,160 bytes; K6 streamed ksub 256 / 100 at m 32, 172,288 /
    147,712; the rescore at m 64, ksub 256, kf 300, nq 1 / 256, 65,680 /
    66,016; K1's projection C 1024 / 2048, 32,768 / 65,536; the fused conv,
    wgmma 3x3 256-channel / grouped over spans, 201,808 / 185,440; K3, a
    constant of its instantiation, the control. No launch may fail, and each
    result is its plain version's (K6 and the rescore exactly, K1 within
    rtol 2e-4 / atol 2e-5, K3 within 1e-5; the conv bit for bit its own
    single-thread answer, which is within agreement()'s bounds of its plain
    version)."""

    @pytest.mark.parametrize("case", concurrency.CASES)
    def test_threads_with_other_shared_memory(self, cuda, case):
        concurrency.race(concurrency.alternation(case, cuda, seed=5), threads=8, per_thread=50)


# (B, cin, H, W, cout, k, stride, groups, scale, shift, residual, relu, out)
CONV_CASES = [
    (2, 3, 37, 29, 64, 7, 2, 1, True, True, None, "post", "bf16"),          # stem
    (2, 64, 17, 13, 64, 1, 1, 1, True, True, None, "post", "bf16"),         # conv1
    (2, 64, 17, 13, 64, 3, 1, 1, True, True, None, "post", "bf16"),         # conv2
    (2, 128, 17, 13, 128, 3, 2, 1, True, True, None, "post", "bf16"),       # conv2, stride 2
    (2, 64, 17, 13, 256, 1, 1, 1, True, True, "bf16", "post", "bf16"),      # conv3 + block input
    (2, 64, 17, 13, 256, 1, 1, 1, True, True, "fp32", "post", "bf16"),      # conv3 + downsample
    (2, 256, 17, 13, 512, 1, 2, 1, True, True, None, "none", "fp32"),       # downsample
    (2, 64, 17, 13, 64, 3, 1, 1, False, True, None, "post", "bf16"),        # folded
    (2, 512, 9, 7, 256, 1, 1, 1, False, False, "bf16", "pre", "fp32"),      # FPN conv1x5
    (2, 256, 9, 7, 256, 3, 1, 1, False, False, None, "post", "fp32"),       # FPN conv3c4
    (2, 128, 17, 13, 128, 3, 1, 32, True, True, None, "post", "bf16"),      # ResNeXt, 4 a group
    (2, 256, 17, 13, 256, 3, 2, 32, True, True, None, "post", "bf16"),      # 8 a group
    (2, 1024, 9, 7, 1024, 3, 1, 32, True, True, None, "post", "bf16"),      # 32 a group
]


# the wgmma path's shapes, at the layer classes of the ResNets and the FPN
WGMMA_CASES = [
    (2, 64, 17, 13, 64, 1, 1, 1, True, True, None, "post", "bf16"),         # 1x1, BN 64
    (2, 256, 17, 13, 128, 1, 1, 1, True, True, None, "post", "bf16"),       # 1x1 reduce, BN 128
    (2, 64, 17, 13, 256, 1, 1, 1, True, True, "bf16", "post", "bf16"),      # + block input
    (2, 64, 17, 13, 256, 1, 1, 1, True, True, "fp32", "post", "bf16"),      # + downsample
    (2, 256, 17, 13, 512, 1, 2, 1, True, True, None, "none", "fp32"),       # downsample, 1x1 s2
    (2, 128, 17, 13, 128, 3, 1, 1, True, True, None, "post", "bf16"),       # 3x3
    (2, 128, 17, 13, 128, 3, 2, 1, True, True, None, "post", "bf16"),       # 3x3 stride 2
    (2, 512, 14, 10, 512, 3, 1, 1, True, True, None, "post", "bf16"),       # K = 4608
    (2, 512, 9, 7, 2048, 1, 1, 1, True, True, "bf16", "post", "bf16"),      # cout 2048
    (2, 1024, 9, 7, 2048, 1, 2, 1, True, True, None, "none", "fp32"),       # into stage 4
    (2, 64, 17, 13, 64, 3, 1, 1, False, True, None, "post", "bf16"),        # folded: bias only
    (2, 2048, 9, 7, 1024, 1, 1, 1, False, False, "bf16", "pre", "fp32"),    # FPN conv1x5
    (2, 1024, 9, 7, 1024, 3, 1, 1, False, False, None, "post", "fp32"),     # FPN conv3c4
    (32, 512, 7, 7, 512, 3, 1, 1, True, True, None, "post", "bf16"),        # 1,568 pixels
    (32, 512, 7, 7, 2048, 1, 1, 1, True, True, "bf16", "post", "bf16"),     # the same, 1x1
    (3, 128, 11, 9, 192, 3, 2, 1, True, True, "fp32", "pre", "bf16"),       # three 64-wide tiles
]


# ResNeXt's grouped 3x3s on the wgmma path over 64-channel spans: g = 4, 8,
# 16, 32 at stride 1 and 2, each with a ragged last 128-pixel tile (M = 442
# at stride 1, 126 at stride 2)
GROUPED_CASES = [(2, 32 * g, 17, 13, 32 * g, 3, stride, 32, True, True, None, "post", "bf16")
                 for g in (4, 8, 16, 32) for stride in (1, 2)]

# shapes no path takes: channels not multiples of 64
NO_PATH_CASES = [
    (1, 40, 5, 3, 8, 3, 1, 1, True, True, None, "post", "fp32"),            # narrow, ragged
    (3, 96, 11, 9, 200, 3, 1, 1, True, True, "bf16", "post", "bf16"),       # two channel tiles
]


def _conv_inputs(rng, device, B, cin, H, W, cout, k, stride, groups, has_scale, has_shift, res):
    x = torch.from_numpy(rng.normal(size=(B, cin, H, W)).astype(np.float32)).to(device)
    x = x.bfloat16().contiguous(memory_format=torch.channels_last)
    w = torch.from_numpy(rng.normal(0, (k * k * cin / groups) ** -0.5,
                                    (cout, cin // groups, k, k)).astype(np.float32)).to(device)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32)).to(device) \
        if has_scale else None
    shift = torch.from_numpy(rng.normal(0, 0.1, cout).astype(np.float32)).to(device) \
        if has_shift else None
    ho, wo = conv.conv_output_hw(H, W, k, k, stride, k // 2)
    r = None
    if res is not None:
        r = torch.from_numpy(rng.normal(size=(B, cout, ho, wo)).astype(np.float32)).to(device)
        r = (r.bfloat16() if res == "bf16" else r).contiguous(memory_format=torch.channels_last)
    return x, w, scale, shift, r


@pytest.mark.cuda
class TestConvKernel:
    """The fused-epilogue convolution (csrc/conv.cu) against conv_reference."""

    @pytest.mark.parametrize("case", CONV_CASES)
    def test_matches_reference(self, rng, cuda, case):
        torch.backends.cudnn.allow_tf32 = False
        B, cin, H, W, cout, k, stride, groups, sc, sh, res, relu, out = case
        x, w, scale, shift, r = _conv_inputs(rng, cuda, B, cin, H, W, cout, k, stride, groups,
                                             sc, sh, res)
        out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
        args = (x, w, stride, k // 2, groups, scale, shift, r, relu, out_dtype)
        before = conv.launches
        with torch.no_grad():
            got = conv.fused_conv(*args)
            again = conv.fused_conv(*args)
        assert conv.launches == before + 2 and torch.equal(got, again)
        want = conv.conv_reference(*args)
        assert got.shape == want.shape and got.dtype == out_dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        agree = conv.agreement(got, want, conv.reference_magnitude(x, w, stride, k // 2,
                                                                   groups, scale))
        assert agree["over"] == 0.0, agree
        if out == "bf16":
            assert agree["apart"] <= 1e-3, agree

    @pytest.mark.parametrize("case", WGMMA_CASES)
    def test_wgmma_path_matches_reference(self, rng, cuda, case):
        """The wgmma path (every groups-1 shape with cin and cout multiples of
        64): 1x1 stride 1 (a 2-D TMA box) and 2, 3x3 stride 1 and 2 (TMA's
        im2col mode), tile widths 64, 128 and 256, cout 64 to 2048, K to
        4608, both residuals and ReLU placements, bias only, fp32 outputs,
        and the recall study's ragged 1,568-pixel tile, within
        agreement()'s bounds of the plain version."""
        self._check(rng, cuda, case, "wgmma")

    @pytest.mark.parametrize("case", GROUPED_CASES)
    def test_grouped_path_matches_reference(self, rng, cuda, case):
        """ResNeXt's grouped 3x3s (g = 4, 8, 16, 32, stride 1 and 2, ragged
        last tile) on wgmma over block-diagonal 64-channel spans, within
        agreement()'s bounds of the plain version, bit for bit on repeat."""
        self._check(rng, cuda, case, "wgmma 128x64 grouped")

    @pytest.mark.parametrize("given", ["fp32_channels_last", "bf16_channels_last",
                                       "fp32_nchw", "bf16_nchw"])
    @pytest.mark.parametrize("relu,res,out", [("post", None, "bf16"), ("pre", "fp32", "fp32")],
                             ids=["stem", "residual_fp32"])
    def test_stem_path_matches_reference(self, rng, cuda, given, relu, res, out):
        """The 7x7/2 stem at an odd 37x29 (ragged strips) from an fp32 or
        bf16 input, channels_last (read where it lies) or NCHW (one NHWC
        copy), within agreement()'s bounds of the plain version, bit for
        bit on repeat; also with an fp32 residual and an fp32 output."""
        case = (2, 3, 37, 29, 64, 7, 2, 1, True, True, res, relu, out)
        self._check(rng, cuda, case, "stem wgmma 128x64", given)

    @pytest.mark.parametrize("case,given", [
        ((1, 3, 9, 11, 64, 3, 1, 1, True, True, None, "post", "bf16"), "fp32_channels_last"),
        ((2, 1, 23, 40, 64, 5, 2, 1, True, True, None, "post", "bf16"), "bf16_channels_last"),
        ((2, 4, 17, 19, 64, 1, 1, 1, False, True, None, "none", "fp32"), "fp32_nchw"),
        ((1, 2, 70, 33, 64, 7, 1, 1, True, True, "bf16", "post", "bf16"), "fp32_channels_last"),
    ], ids=["3x3_narrow", "1ch_5x5", "4ch_1x1", "2ch_7x7_s1"])
    def test_stem_path_other_shapes(self, rng, cuda, case, given):
        """Every shape the stem path takes, not only the 7x7/2 stem: 1 to 4
        channels, 1x1 to 7x7, stride 1 and 2, an image narrower than a tile,
        a residual; within agreement()'s bounds, bit for bit on repeat."""
        self._check(rng, cuda, case, "stem wgmma 128x64", given)

    def test_kernel_path_is_conv_path(self, cuda):
        """The built library's rule names the path ops/conv.py packs the
        operands for, at every shape of these tests and the backbones'."""
        for B, cin, H, W, cout, k, stride, groups, *_ in (
                CONV_CASES + WGMMA_CASES + GROUPED_CASES + NO_PATH_CASES):
            assert conv.kernel_path(cin, cout, groups, k, k, stride) == \
                conv.conv_path(cin, cout, groups, k, k, stride)

    @pytest.mark.parametrize("case", NO_PATH_CASES)
    def test_refuses_a_shape_no_path_takes(self, rng, cuda, case):
        """Channels not multiples of 64: the library's rule names no path,
        fused_conv raises while it packs the operands, before any launch,
        and the library refuses the shape itself (cudaErrorInvalidValue)."""
        from dirjax_torch.kernels.build import load_library

        B, cin, H, W, cout, k, stride, groups, sc, sh, res, relu, out = case
        assert conv.kernel_path(cin, cout, groups, k, k, stride) is None
        x, w, scale, shift, r = _conv_inputs(rng, cuda, B, cin, H, W, cout, k, stride, groups,
                                             sc, sh, res)
        out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
        before = conv.launches
        with torch.no_grad(), pytest.raises(ValueError, match="no path"):
            conv.fused_conv(x, w, stride, k // 2, groups, scale, shift, r, relu, out_dtype)
        assert conv.launches == before
        ho, wo = conv.conv_output_hw(H, W, k, k, stride, k // 2)
        wp = w.bfloat16().permute(0, 2, 3, 1).contiguous()
        y = torch.empty((B, ho, wo, cout), dtype=out_dtype, device=cuda)
        err = load_library().dirjax_conv_fused(
            x.data_ptr(), 0, wp.data_ptr(), None, None, None, None, 0, 0, y.data_ptr(),
            out == "bf16", B, H, W, cin, cout, k, k, stride, k // 2, groups, ho, wo, None)
        torch.cuda.synchronize()
        assert err == 1   # cudaErrorInvalidValue

    def _check(self, rng, cuda, case, path, given="bf16_channels_last"):
        torch.backends.cudnn.allow_tf32 = False
        B, cin, H, W, cout, k, stride, groups, sc, sh, res, relu, out = case
        assert conv.kernel_path(cin, cout, groups, k, k, stride).startswith(path)
        x, w, scale, shift, r = _conv_inputs(rng, cuda, B, cin, H, W, cout, k, stride, groups,
                                             sc, sh, res)
        if given.startswith("fp32"):   # values that bf16 does not hold: the kernel rounds them
            x = torch.from_numpy(rng.normal(size=tuple(x.shape)).astype(np.float32)).to(cuda)
            x = x.contiguous(memory_format=torch.channels_last)
        if given.endswith("nchw"):
            x = x.contiguous()
        out_dtype = torch.bfloat16 if out == "bf16" else torch.float32
        args = (x, w, stride, k // 2, groups, scale, shift, r, relu, out_dtype)
        with torch.no_grad():
            got = conv.fused_conv(*args)
            packed = conv.pack_weights(w, groups, scale, shift)
            again = conv.fused_conv_packed(x, packed, stride, k // 2, r, relu, out_dtype)
            assert packed["wmap"] is not None
            assert torch.equal(got, again)
            assert torch.equal(got, conv.fused_conv_packed(x, packed, stride, k // 2, r, relu,
                                                           out_dtype))
        want = conv.conv_reference(*args)
        assert got.shape == want.shape and got.dtype == out_dtype
        assert got.is_contiguous(memory_format=torch.channels_last)
        agree = conv.agreement(got, want, conv.reference_magnitude(x, w, stride, k // 2,
                                                                   groups, scale))
        assert agree["over"] == 0.0, agree
        if out == "bf16":
            # the share one bf16 rounding apart from cuDNN's fp32 sums grows
            # with K: the K = 4608 cases read 1.1e-3-1.3e-3; K above 2304
            # is held to chip_smoke.py's bound
            assert agree["apart"] <= (1e-3 if cin // groups * k * k <= 2304 else 2e-3), agree

    def test_refuses_a_gradient(self, rng, cuda):
        x, w, scale, shift, _ = _conv_inputs(rng, cuda, 1, 64, 5, 5, 64, 3, 1, 1, True, True,
                                             None)
        for args in ((x.float().requires_grad_(True), w), (x, w.requires_grad_(True)),
                     (x, w.detach(), 1, 1, 1, scale.requires_grad_(True), shift)):
            with pytest.raises(RuntimeError, match="no backward"):
                conv.fused_conv(*args)
            with torch.no_grad():
                conv.fused_conv(*args)

    def test_rejects_what_it_does_not_take(self, rng, cuda):
        x, w, *_ = _conv_inputs(rng, cuda, 1, 64, 5, 5, 64, 3, 1, 1, False, False, None)
        with torch.no_grad():
            with pytest.raises(ValueError, match="multiple of 4"):
                conv.fused_conv(x, w[:, :6].contiguous(), groups=4)    # 6 channels a group
            with pytest.raises(ValueError, match="multiple of 4"):
                conv.fused_conv(x, torch.cat([w, w[:2]]), padding=1)   # 66 outputs
            with pytest.raises(ValueError, match="16-byte"):            # a view 4 bytes in
                conv.fused_conv(x, w, padding=1, scale=torch.ones(65, device=cuda)[1:])
            with pytest.raises(ValueError, match="residual"):
                conv.fused_conv(x, w, padding=1, residual=x[:, :, :4])


"""Serving: device-resident retrieval indexes (counterpart of
``dirjax/serving.py``'s ``RetrievalIndex`` and ``BinaryIndex``).

* :class:`RetrievalIndex` keeps the descriptors on one device (``device``,
  the card unless the caller passes ``"cpu"``) in
  fp32, bf16, or int8 with per-row scales (:func:`.ops.topk.quantize_db`):
  bf16 halves the bytes of fp32, int8 halves them again at ~8-bit ranking
  noise; every mode accumulates in fp32 (int8 x int8 in exact int32).
* ``search`` ranks through :func:`.ops.topk.rank_topk_fused` (kernels K2-K4
  on the card), optionally after alpha query expansion against the index
  (chunked, or through the int8 kernels for an int8 index), and returns
  host numpy arrays: fp32 scores and int32 indices, as dirjax's does.
  ``int8_queries`` (int8 indexes) quantizes the queries too.
* ``remove`` tombstones rows on the host; searches stay exact by
  over-fetching, and expansion never uses a removed row. ``compact`` drops
  them and returns the old -> new index map.
* :class:`BinaryIndex` keeps ITQ sign codes, ``n_bits / 8`` bytes per row
  (256 B at 2048 bits, 8x the int8 corpus per card), and ranks exactly by
  the asymmetric or the symmetric score (:mod:`.ops.binary`, kernel K5).
* :class:`PQIndex` keeps ``m`` uint8 codebook ids per row (32 B at m = 32)
  and ranks by ADC (:mod:`.ops.pq`, kernel K6 and its rescore), optionally
  after an OPQ rotation and before an exact int8 rescore of the shortlist.
* :class:`IVFPQIndex` adds an inverted file (:mod:`.ops.ivf`): each query
  scores only its ``nprobe`` nearest cells' residual codes.
* ``save``/``load`` use dirjax's ``.npz`` layout, so an index file written
  by either package loads in the other; :meth:`RetrievalIndex.load` opens a
  binary, PQ or IVF file as its class, as dirjax's does.

Not ported: ``mesh=`` (ROADMAP M13), dirjax's query-count buckets, which
exist only because XLA compiles per shape (nothing here does), and its
packed single pull of values and indices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.binary import (BinaryCodec, _to_bytes, binarize, fit_itq,
                         hamming_search_fused)
from .ops.ivf import IVFArrays, bin_ivf, build_ivf, ivf_assign, ivf_topk, unbin_ivf
from .ops.pq import (encode_pq, pq_lookup, pq_topk, reconstruct_pq, train_opq,
                     train_pq)
from .ops.qe import (_drop_excluded, _weights, expand_queries_chunked,
                     expand_queries_quantized)
from .ops.topk import _topk, quantize_db, rank_topk_fused

__all__ = ["RetrievalIndex", "BinaryIndex", "PQIndex", "IVFPQIndex"]

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _as_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array through ``torch.from_numpy``. A bfloat16
    array (dirjax's batcher makes ``ml_dtypes.bfloat16``) becomes a
    ``torch.bfloat16`` tensor of the same bits, without importing
    ``ml_dtypes``: bf16 queries pass through, and each index casts them as
    its tier needs (``dirjax/serving.py:632-634``)."""
    if torch.is_tensor(x):
        return x
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(x).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(x)


class _Tombstones:
    """Deletion shared by the index classes.

    ``remove()`` marks rows in a host boolean mask. Searches stay exact by
    fetching ``k + pad`` candidates (``pad`` = the tombstone count rounded
    up to 64) and dropping removed hits on the host, where the (nq, k+pad)
    candidates are headed anyway. Query expansion filters its neighbours
    against a device copy of the mask, made once per mutation. The mask
    persists through ``save``/``load`` as packed bits; only
    :meth:`compact` reclaims the rows, and it renumbers them."""

    _removed = None            # np.bool_ (n,), None until the first remove()
    _n_removed = 0
    _removed_dev = None        # lazy device copy for the expansion filter

    @property
    def n_removed(self) -> int:
        return self._n_removed

    def lookup(self, indices) -> list:
        """Map result indices to keys; ``-1`` (an empty slot) maps to None."""
        if self.keys is None:
            raise ValueError("index was built without keys")
        return [[None if j < 0 else self.keys[j] for j in row]
                for row in np.asarray(indices)]

    def remove(self, keys: Optional[Sequence[str]] = None, indices=None) -> int:
        """Tombstone rows by key or by row index; returns how many rows were
        newly removed. O(n) per call: batch removals."""
        if (keys is None) == (indices is None):
            raise ValueError("pass exactly one of keys= / indices=")
        if keys is not None:
            if self.keys is None:
                raise ValueError("index carries no keys; use indices=")
            pos = {k: i for i, k in enumerate(self.keys)}
            missing = [k for k in keys if k not in pos]
            if missing:
                raise KeyError(f"keys not in index: {missing[:5]}")
            indices = [pos[k] for k in keys]
        idx = np.unique(np.asarray(indices, np.int64).reshape(-1))
        if idx.size == 0:
            return 0
        if idx[0] < 0 or idx[-1] >= self.n:
            raise IndexError(f"row index out of range [0, {self.n})")
        if self._removed is None:
            self._removed = np.zeros(self.n, bool)
        newly = int(np.count_nonzero(~self._removed[idx]))
        self._removed[idx] = True
        self._n_removed += newly
        self._removed_dev = None
        return newly

    def _set_rows(self, descriptors, keys, device) -> torch.Tensor:
        """Validate (N, D) descriptors and their keys; set ``n``, ``dim``,
        ``keys`` and ``device``. Returns the descriptors as a tensor."""
        descs = _as_tensor(descriptors)
        if descs.dim() != 2:
            raise ValueError(f"descriptors must be (N, D), got {tuple(descs.shape)}")
        self.n, self.dim = descs.shape
        self.keys = list(keys) if keys is not None else None
        if self.keys is not None and len(self.keys) != self.n:
            raise ValueError(f"{len(self.keys)} keys for {self.n} descriptors")
        self.device = torch.device(device)
        return descs

    def _new_rows(self, descriptors, keys) -> torch.Tensor:
        """Validate rows (and keys) for ``add``; returns them as a tensor."""
        new = _as_tensor(descriptors)
        if new.dim() != 2 or new.shape[1] != self.dim:
            raise ValueError(f"descriptors must be (N, {self.dim}), got "
                             f"{tuple(new.shape)}")
        if self.keys is not None and (keys is None or len(keys) != len(new)):
            raise ValueError("index carries keys: add() needs one key per new row")
        return new

    def _append_keys(self, keys, n_new: int) -> None:
        """Bookkeeping after ``add`` appended ``n_new`` rows."""
        if self.keys is not None:
            self.keys.extend(keys)
        self._tomb_extend(n_new)
        self.n += n_new

    def _tomb_pad(self) -> int:
        return ((self.n_removed + 63) // 64) * 64

    def _tomb_aqe_kwargs(self) -> dict:
        """``exclude_mask``/``exclude_pad`` for the expansion ops; empty
        when nothing is removed."""
        if not self.n_removed:
            return {}
        if self._removed_dev is None:
            self._removed_dev = torch.from_numpy(self._removed).to(self.device)
        return {"exclude_mask": self._removed_dev,
                "exclude_pad": self._tomb_pad()}

    def _tomb_filter(self, vals, idxs, k: int):
        """Removed (and empty) hits to -inf, re-select k, on the host."""
        vals = np.array(vals, np.float32, copy=True)
        idxs = np.asarray(idxs)
        bad = (idxs < 0) | self._removed[np.maximum(idxs, 0)]
        vals[bad] = -np.inf
        sel = np.argsort(-vals, axis=1, kind="stable")[:, :min(k, vals.shape[1])]
        v2 = np.take_along_axis(vals, sel, axis=1)
        i2 = np.take_along_axis(idxs, sel, axis=1)
        return v2, np.where(v2 > -np.inf, i2, -1)

    def _tomb_extend(self, n_new: int) -> None:
        if self._removed is not None:
            self._removed = np.concatenate([self._removed, np.zeros(n_new, bool)])
            self._removed_dev = None

    def _tomb_save(self, arrays: dict) -> None:
        if self.n_removed:
            arrays["removed_mask"] = np.packbits(self._removed)

    def _tomb_restore(self, mask) -> None:
        self._removed = mask
        self._removed_dev = None
        self._n_removed = 0 if mask is None else int(mask.sum())

    @staticmethod
    def _tomb_unpack(data, n: int):
        if "removed_mask" not in data:
            return None
        return np.unpackbits(data["removed_mask"], count=n).astype(bool)

    def compact(self) -> np.ndarray:
        """Drop tombstoned rows and renumber. Returns the (n_old,) int64 map
        old index -> new index (-1 for removed rows)."""
        if self.n_removed == 0:
            return np.arange(self.n, dtype=np.int64)
        keep_idx = np.where(~self._removed)[0]
        mapping = np.full(self.n, -1, np.int64)
        mapping[keep_idx] = np.arange(keep_idx.size)
        self._compact_rows(keep_idx)
        if self.keys is not None:
            self.keys = [self.keys[i] for i in keep_idx]
        self.n = int(keep_idx.size)
        self._tomb_restore(None)
        return mapping


class RetrievalIndex(_Tombstones):
    """Dot-product top-k search over a descriptor database on ``device``.

    ``dtype`` is ``torch.float32``, ``torch.bfloat16`` or ``torch.int8``
    (per-row quantized, :func:`.ops.topk.quantize_db`)."""

    def __init__(self, descriptors, keys: Optional[Sequence[str]] = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
        descs = self._set_rows(descriptors, keys, device)
        self.dtype = dtype
        self._scales = None
        if dtype == torch.int8:
            self._db, self._scales = quantize_db(descs.to(self.device))
        else:
            self._db = descs.to(self.device, dtype).contiguous()

    # --- search ---------------------------------------------------------
    def search(self, queries, k: int = 10, *, aqe: Optional[dict] = None,
               int8_queries: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (fp32 scores, int32 indices) per query row, as numpy.
        ``aqe={'k':, 'alpha':}`` expands the queries against the index first
        (``test_dir.py:24-44`` semantics); ``int8_queries=True`` (int8
        indexes) quantizes the possibly expanded queries per row, so the
        contraction is int8 x int8."""
        if int8_queries and self._scales is None:
            raise ValueError("int8_queries requires an int8 index "
                             "(RetrievalIndex(dtype=torch.int8))")
        q = _as_tensor(queries)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {tuple(q.shape)}")
        if not self.n_removed:
            return self._search(q, k, aqe, bool(int8_queries))
        if k > self.n:   # the same contract as the clean path
            raise ValueError(f"k={k} exceeds the {self.n} database rows")
        vals, idxs = self._search(q, min(k + self._tomb_pad(), self.n), aqe,
                                  bool(int8_queries))
        return self._tomb_filter(vals, idxs, k)

    def _search(self, q, k: int, aqe: Optional[dict], int8_queries: bool):
        if self._scales is not None:
            q = q.to(self.device, torch.float32)
            if aqe:
                q = expand_queries_quantized(q, self._db, self._scales,
                                             alpha=aqe["alpha"], k=aqe["k"],
                                             **self._tomb_aqe_kwargs())
            vals, idxs = rank_topk_fused(q, self._db, k, db_scales=self._scales,
                                         quantize_queries=int8_queries)
        else:
            q = q.to(self.device, self.dtype)
            if aqe:
                q = expand_queries_chunked(q, self._db, alpha=aqe["alpha"],
                                           k=aqe["k"], **self._tomb_aqe_kwargs()
                                           ).to(self.dtype)
            vals, idxs = rank_topk_fused(q, self._db, k)
        return vals.cpu().numpy(), idxs.to(torch.int32).cpu().numpy()

    # --- mutation -------------------------------------------------------
    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Append rows (and keys, for a keyed index). An int8 index quantizes
        the new rows with their own scales; existing rows are untouched."""
        new = self._new_rows(descriptors, keys)
        if self._scales is not None:
            q8, s8 = quantize_db(new.to(self.device))
            self._db = torch.cat([self._db, q8])
            self._scales = torch.cat([self._scales, s8], dim=1)
        else:
            self._db = torch.cat([self._db, new.to(self.device, self.dtype)])
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        keep = torch.from_numpy(keep_idx).to(self.device)
        self._db = self._db[keep]
        if self._scales is not None:
            self._scales = self._scales[:, keep].contiguous()

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """int8 indexes persist quantized (rows and (1, n) scales), others as
        fp32 rows; tombstones as packed bits. dirjax's layout."""
        arrays = {}
        self._tomb_save(arrays)
        if self._scales is not None:
            arrays["descriptors_i8"] = self._db.cpu().numpy()
            arrays["scales"] = self._scales.cpu().numpy()
        else:
            arrays["descriptors"] = self._db.float().cpu().numpy()
        if self.keys is not None:
            arrays["keys"] = np.asarray(self.keys)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path: str, dtype: Optional[torch.dtype] = None,
             device="cuda"):
        """``dtype=None`` keeps the stored representation: an int8 archive
        loads as int8 without requantizing, an fp32 one as fp32. A binary,
        PQ or IVF archive loads as a :class:`BinaryIndex`, :class:`PQIndex`
        or :class:`IVFPQIndex`."""
        with np.load(path, allow_pickle=False) as data:
            if "ivf_codes" in data.files:
                return IVFPQIndex.load(path, device=device)
            if "pq_codes" in data.files:
                return PQIndex.load(path, device=device)
            if "binary_codes" in data.files:
                return BinaryIndex.load(path, device=device)
            keys = [str(k) for k in data["keys"]] if "keys" in data else None
            quantized = "descriptors_i8" in data
            rows = data["descriptors_i8" if quantized else "descriptors"]
            scales = data["scales"] if quantized else None
            removed = cls._tomb_unpack(data, len(rows))
        if quantized and dtype in (None, torch.int8):
            idx = cls.__new__(cls)
            idx.n, idx.dim = rows.shape
            idx.keys = keys
            idx.device = torch.device(device)
            idx.dtype = torch.int8
            idx._db = torch.from_numpy(rows).to(idx.device)
            idx._scales = torch.from_numpy(scales).to(idx.device)
        else:
            if quantized:   # a float index from an int8 archive: dequantize
                rows = rows.astype(np.float32) * scales.T
            idx = cls(rows, keys=keys, device=device,
                      dtype=torch.float32 if dtype is None else dtype)
        idx._tomb_restore(removed)
        return idx


class BinaryIndex(_Tombstones):
    """ITQ binary-hash index on ``device`` (the card unless the caller passes
    ``"cpu"``): ``n_bits / 8`` bytes per row.

    The codec is learned from the indexed corpus (:func:`.ops.binary.fit_itq`:
    PCA and an iterative orthogonal rotation; ``itq_iters=0`` gives plain PCA
    sign hashing), or given as ``_codec``. ``asym=True`` (the default) ranks
    by the exact asymmetric score, the continuous projected query against
    the ±1 codes; ``asym=False`` by the symmetric ``n_bits - 2*hamming``
    (exact integers, so ties are common: tie-broken indices rank the lower
    candidate first). Codes are stored unpadded in the byte layout."""

    def __init__(self, descriptors, n_bits: Optional[int] = None,
                 keys: Optional[Sequence[str]] = None, *, itq_iters: int = 30,
                 asym: bool = True, seed: int = 0, sample: Optional[int] = 131072,
                 device="cuda", _codec: Optional[BinaryCodec] = None):
        descs = self._set_rows(descriptors, keys, device).to(device, torch.float32)
        self.asym = bool(asym)
        if _codec is None:
            _codec = fit_itq(descs, n_bits, iters=itq_iters, seed=seed, sample=sample)
        self.codec = BinaryCodec(*(t.to(self.device, torch.float32) for t in _codec))
        self._codes = binarize(descs, self.codec)

    n_bits = property(lambda self: self.codec.n_bits)

    # --- search ---------------------------------------------------------
    def search(self, queries, k: int = 10, *, rerank_factor: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (fp32 scores, int32 indices) per query row, as numpy. Every
        search is exact under its score; ``rerank_factor`` sizes dirjax's
        mesh shortlist and is ignored, as on dirjax's single chip."""
        q = _as_tensor(queries)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {tuple(q.shape)}")
        if k > self.n:
            raise ValueError(f"k={k} exceeds the {self.n} database rows")
        pad = self._tomb_pad() if self.n_removed else 0
        vals, idxs = hamming_search_fused(q.to(self.device, torch.float32),
                                          self.codec, self._codes,
                                          min(k + pad, self.n), asym=self.asym)
        vals, idxs = vals.cpu().numpy(), idxs.to(torch.int32).cpu().numpy()
        if pad:
            vals, idxs = self._tomb_filter(vals, idxs, k)
        return vals, idxs

    # --- mutation -------------------------------------------------------
    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Encode new rows with the existing codec and append them."""
        new = self._new_rows(descriptors, keys)
        self._codes = torch.cat([self._codes, binarize(new, self.codec)])
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        self._codes = self._codes[torch.from_numpy(keep_idx).to(self.device)]

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """One npz in dirjax's layout: uint32 code words, the codec, the
        score mode, keys and tombstones."""
        arrays = {
            "binary_codes": self._codes.cpu().numpy().view("<u4"),
            "binary_mean": self.codec.mean.cpu().numpy(),
            "binary_proj": self.codec.proj.cpu().numpy(),
            "binary_asym": np.asarray(int(self.asym)),
        }
        self._tomb_save(arrays)
        if self.keys is not None:
            arrays["keys"] = np.asarray(self.keys)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    @classmethod
    def load(cls, path: str, device="cuda") -> "BinaryIndex":
        with np.load(path, allow_pickle=False) as data:
            codes = data["binary_codes"]
            mean, proj = data["binary_mean"], data["binary_proj"]
            asym = bool(int(data["binary_asym"]))
            keys = [str(k) for k in data["keys"]] if "keys" in data else None
            removed = cls._tomb_unpack(data, len(codes))
        idx = cls.__new__(cls)
        idx.n, idx.dim = len(codes), int(mean.shape[0])
        idx.keys = keys
        idx.asym = asym
        idx.device = torch.device(device)
        idx.codec = BinaryCodec(torch.from_numpy(mean).to(idx.device, torch.float32),
                                torch.from_numpy(proj).to(idx.device, torch.float32))
        idx._codes = _to_bytes(codes).to(idx.device)
        idx._tomb_restore(removed)
        return idx


def _int8_rescore(q, rdb, rscales, idxs, k: int):
    """Exact int8 rescore of a candidate shortlist (dirjax's
    ``_int8_rescore``): gather each query's candidate rows, dequantize, dot
    with the UNROTATED query (int8 rows live in the descriptor space);
    candidates of -1 score -inf. Returns the top ``min(k, width)``."""
    safe = idxs.clamp_min(0)
    rows = rdb[safe].float() * rscales.reshape(-1)[safe][:, :, None]
    scores = torch.bmm(rows, q[:, :, None])[:, :, 0]
    scores = torch.where(idxs >= 0, scores, float("-inf"))
    vals, pos = _topk(scores, min(k, scores.shape[1]))
    return vals, torch.gather(idxs, 1, pos)


class _ADCIndex(_Tombstones):
    """What :class:`PQIndex` and :class:`IVFPQIndex` share: query intake,
    the OPQ rotation, the int8 rescore, tombstones, expansion and the common
    ``.npz`` arrays."""

    compute_dtype = None       # None (fp32) or torch.bfloat16: the ADC tables' type
    rotation = None            # (D, D) OPQ rotation, or None
    _rerank_db = _rerank_scales = None

    m = property(lambda self: int(self.codebooks.shape[0]))
    ksub = property(lambda self: int(self.codebooks.shape[1]))

    def _queries(self, queries) -> torch.Tensor:
        q = _as_tensor(queries)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {tuple(q.shape)}")
        return q.to(self.device, torch.float32)

    def _rotate_queries(self, q: torch.Tensor) -> torch.Tensor:
        """``q @ R`` accumulated in fp64 and rounded once: a query's tables
        do not depend on the batch it rides in."""
        if self.rotation is None:
            return q
        return (q.double() @ self.rotation.double()).float()

    def _rotate_rows(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.rotation is None else x @ self.rotation

    def _set_rerank(self, descs, rerank: bool) -> None:
        self._rerank_db = self._rerank_scales = None
        if rerank:
            self._rerank_db, self._rerank_scales = quantize_db(descs)

    def _finish(self, q, vals, idxs, k: int, pad: int):
        """Optional int8 rescore, host pull, tombstone filter."""
        if self._rerank_db is not None:
            vals, idxs = _int8_rescore(q, self._rerank_db, self._rerank_scales, idxs, k + pad)
        vals, idxs = vals.cpu().numpy(), idxs.to(torch.int32).cpu().numpy()
        if pad:
            vals, idxs = self._tomb_filter(vals, idxs, k)
        return vals, idxs

    def _base_k(self, k: int, rerank_factor: int) -> int:
        """Candidates the ADC stage returns: ``rerank_factor * k`` for the
        int8 rescore, plus the tombstone pad."""
        base = max(k * rerank_factor, k) if self._rerank_db is not None else k
        return base + (self._tomb_pad() if self.n_removed else 0)

    def _neighbours(self, vals, idxs, k: int):
        """Drop tombstoned neighbours of an over-fetched expansion top-k."""
        if not self.n_removed:
            return vals, idxs
        return _drop_excluded(vals, idxs, self._tomb_aqe_kwargs()["exclude_mask"], k)

    def _expanded(self, q, vals, idxs, nb, k: int, alpha: float) -> torch.Tensor:
        """AQE against reconstructed neighbours ``nb`` (nq, k, D), which live
        in the rotated space."""
        if self.rotation is not None:
            nb = nb @ self.rotation.T
        w = torch.where(idxs >= 0, _weights(vals, alpha), 0.0)
        expanded = (q + torch.einsum("nk,nkd->nd", w, nb)) / (k + 1.0)
        return expanded / torch.linalg.vector_norm(expanded, dim=1, keepdim=True).clamp_min(1e-12)

    def _grow_rerank(self, new: torch.Tensor) -> None:
        if self._rerank_db is not None:
            r8, s8 = quantize_db(new)
            self._rerank_db = torch.cat([self._rerank_db, r8])
            self._rerank_scales = torch.cat([self._rerank_scales, s8], dim=1)

    def _compact_rerank(self, keep: torch.Tensor) -> None:
        if self._rerank_db is not None:
            self._rerank_db = self._rerank_db[keep]
            self._rerank_scales = self._rerank_scales[:, keep].contiguous()

    def _save_common(self, arrays: dict, path: str) -> None:
        arrays["pq_codebooks"] = self.codebooks.cpu().numpy()
        self._tomb_save(arrays)
        if self.rotation is not None:
            arrays["pq_rotation"] = self.rotation.cpu().numpy()
        if self._rerank_db is not None:
            arrays["descriptors_i8"] = self._rerank_db.cpu().numpy()
            arrays["scales"] = self._rerank_scales.cpu().numpy()
        if self.keys is not None:
            arrays["keys"] = np.asarray(self.keys)
        with open(path, "wb") as f:
            np.savez(f, **arrays)

    def _load_common(self, data, n: int, device) -> None:
        self.device = torch.device(device)
        self.n = n
        self.keys = [str(k) for k in data["keys"]] if "keys" in data else None
        self.codebooks = torch.from_numpy(data["pq_codebooks"]).to(self.device, torch.float32)
        self.dim = self.codebooks.shape[0] * self.codebooks.shape[2]
        self.rotation = (torch.from_numpy(data["pq_rotation"]).to(self.device, torch.float32)
                         if "pq_rotation" in data else None)
        self._rerank_db = self._rerank_scales = None
        if "descriptors_i8" in data:
            self._rerank_db = torch.from_numpy(data["descriptors_i8"]).to(self.device)
            self._rerank_scales = torch.from_numpy(data["scales"]).to(self.device)
        self._tomb_restore(self._tomb_unpack(data, n))


class PQIndex(_ADCIndex):
    """Product-quantized index on ``device`` (the card unless the caller
    passes ``"cpu"``): ``m`` uint8 codebook ids per row, ranked by ADC
    (:func:`.ops.pq.pq_topk`: K6 and its rescore).

    ``opq=True`` learns an OPQ rotation first; ``rerank=True`` also keeps
    int8 rows (and per-row scales) and rescores the top ``rerank_factor * k``
    ADC candidates exactly against the unrotated query.
    ``compute_dtype=torch.bfloat16`` rounds the ADC tables to bf16.
    ``_trained=(rotation, codebooks)`` skips training (a rotation may be
    None). Codes are stored unpadded; K6 masks rows >= n itself."""

    def __init__(self, descriptors, m: int = 32, ksub: int = 16,
                 keys: Optional[Sequence[str]] = None, *, opq: bool = False,
                 rerank: bool = False, train_iters: int = 25, seed: int = 0,
                 sample: Optional[int] = 262144, compute_dtype=None, device="cuda",
                 _trained=None):
        descs = self._set_rows(descriptors, keys, device).to(device, torch.float32)
        self.compute_dtype = compute_dtype
        if _trained is not None:
            rotation, codebooks = _trained
            self.rotation = None if rotation is None else \
                _as_tensor(rotation).to(self.device, torch.float32)
            self.codebooks = _as_tensor(codebooks).to(self.device, torch.float32)
        elif opq:
            self.rotation, self.codebooks = train_opq(
                descs, m, ksub, iters=train_iters, seed=seed,
                sample=None if sample is None else min(sample, 131072))
        else:
            self.codebooks = train_pq(descs, m, ksub, iters=train_iters, seed=seed,
                                      sample=sample)
        self._codes = self._encode(descs)
        self._set_rerank(descs, rerank)

    @classmethod
    def from_codes(cls, codebooks, codes, *, keys: Optional[Sequence[str]] = None,
                   rotation=None, compute_dtype=None, device="cuda") -> "PQIndex":
        """An index of pre-encoded rows: ``codebooks`` (m, ksub, D/m) from
        :func:`.ops.pq.train_pq` and ``codes`` (n, m) uint8 from
        :func:`.ops.pq.encode_pq`. No training; no int8 rescore (it needs
        the original rows)."""
        self = cls.__new__(cls)
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.codebooks = _as_tensor(codebooks).to(self.device, torch.float32)
        self.rotation = None if rotation is None else \
            _as_tensor(rotation).to(self.device, torch.float32)
        codes = _as_tensor(codes)
        m, _, dsub = self.codebooks.shape
        if codes.dim() != 2 or codes.shape[1] != m or codes.dtype != torch.uint8:
            raise ValueError(f"codes must be (n, {m}) uint8, got {tuple(codes.shape)} "
                             f"{codes.dtype}")
        self.n, self.dim = int(codes.shape[0]), int(m * dsub)
        self.keys = list(keys) if keys is not None else None
        if self.keys is not None and len(self.keys) != self.n:
            raise ValueError(f"{len(self.keys)} keys for {self.n} codes")
        self._codes = codes.to(self.device).contiguous()
        self._rerank_db = self._rerank_scales = None
        return self

    def _encode(self, rows: torch.Tensor) -> torch.Tensor:
        return encode_pq(self._rotate_rows(rows), self.codebooks)

    # --- search ---------------------------------------------------------
    def search(self, queries, k: int = 10, *, rerank_factor: int = 4,
               aqe: Optional[dict] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (fp32 scores, int32 indices) per query row by ADC, as numpy.
        A rerank index rescores the top ``rerank_factor * k`` ADC candidates
        exactly. ``aqe={'k':, 'alpha':}`` expands the queries against the
        reconstructions of their ADC neighbours first."""
        q = self._queries(queries)
        if aqe:
            q = self._expand_queries(q, k=aqe["k"], alpha=aqe["alpha"])
        pad = self._tomb_pad() if self.n_removed else 0
        vals, idxs = self._adc_topk(q, min(self._base_k(k, rerank_factor), self.n))
        return self._finish(q, vals, idxs, k, pad)

    def _adc_topk(self, q, k: int):
        luts = pq_lookup(self._rotate_queries(q), self.codebooks)
        return pq_topk(luts, self._codes, k, compute_dtype=self.compute_dtype)

    def _expand_queries(self, q, k: int, alpha: float) -> torch.Tensor:
        """AQE against the neighbours' centroid reconstructions, so it runs at
        pure-compressed capacity; tombstoned rows never steer it."""
        k = min(int(k), self.n)
        pad = self._tomb_pad() if self.n_removed else 0
        vals, idxs = self._neighbours(*self._adc_topk(q, min(k + pad, self.n)), k)
        nb = reconstruct_pq(self._codes[idxs.clamp_min(0).reshape(-1)], self.codebooks)
        return self._expanded(q, vals, idxs, nb.reshape(*idxs.shape, self.dim), k, alpha)

    # --- mutation -------------------------------------------------------
    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Encode new rows with the existing codebooks (and rotation) and
        append them."""
        new = self._new_rows(descriptors, keys).to(self.device, torch.float32)
        self._codes = torch.cat([self._codes, self._encode(new)])
        self._grow_rerank(new)
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        keep = torch.from_numpy(keep_idx).to(self.device)
        self._codes = self._codes[keep]
        self._compact_rerank(keep)

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """One npz in dirjax's layout: codes, codebooks, and the rotation,
        int8 rerank rows, keys and tombstones where present."""
        self._save_common({"pq_codes": self._codes.cpu().numpy()}, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "PQIndex":
        idx = cls.__new__(cls)
        with np.load(path, allow_pickle=False) as data:
            codes = data["pq_codes"]
            idx._load_common(data, len(codes), device)
        if codes.shape[1] != idx.m:
            raise ValueError(f"{path}: codes of {codes.shape[1]} subspaces for "
                             f"{idx.m} codebooks")
        idx._codes = torch.from_numpy(codes).to(idx.device)
        return idx


class IVFPQIndex(_ADCIndex):
    """Inverted-file PQ index on ``device`` (the card unless the caller
    passes ``"cpu"``): each query scores only its ``nprobe`` nearest cells'
    residual PQ codes (:func:`.ops.ivf.ivf_topk`); ``nprobe >= nvlist``
    degrades to exact ADC over reconstructions.

    Options as :class:`PQIndex`: ``opq`` learns a rotation (the codebooks
    are then trained on the coarse residuals in the rotated space),
    ``rerank`` keeps int8 rows for an exact shortlist rescore,
    ``compute_dtype=torch.bfloat16`` rounds the ADC tables."""

    _coding = None        # lazy unbin_ivf cache, see _row_coding()

    def __init__(self, descriptors, nlist: int, m: int = 32, ksub: int = 16, *,
                 nprobe: int = 8, keys: Optional[Sequence[str]] = None,
                 opq: bool = False, rerank: bool = False, slab: int = 64,
                 cap: Optional[int] = None, train_iters: int = 25, seed: int = 0,
                 sample: Optional[int] = 262144, compute_dtype=None, device="cuda"):
        descs = self._set_rows(descriptors, keys, device).to(device, torch.float32)
        self.compute_dtype = compute_dtype
        self.nprobe = nprobe
        if opq:
            # OPQ supplies only the rotation: the codebooks are trained on
            # the coarse residuals in the rotated space, which ADC quantizes
            self.rotation, _ = train_opq(
                descs, m, ksub, iters=max(4, train_iters // 2), seed=seed,
                sample=None if sample is None else min(sample, 131072))
        self._ivf, self._centroids, self.codebooks = build_ivf(
            self._rotate_rows(descs), nlist, m, ksub, slab=slab, cap=cap,
            pq_iters=train_iters, seed=seed, sample=sample)
        self._set_rerank(descs, rerank)

    nlist = property(lambda self: int(self._centroids.shape[0]))

    # --- search ---------------------------------------------------------
    def search(self, queries, k: int = 10, *, nprobe: Optional[int] = None,
               rerank_factor: int = 4, aqe: Optional[dict] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (fp32 scores, int32 indices) over the probed cells, as
        numpy; ``nprobe`` overrides the index default for this call. Scores
        are ``q . centroid + q . residual reconstruction``. ``aqe`` expands
        the queries against IVF reconstructions of their neighbours, probing
        the same cells."""
        q = self._queries(queries)
        nprobe = int(nprobe or self.nprobe)
        if aqe:
            q = self._expand_queries(q, k=aqe["k"], alpha=aqe["alpha"], nprobe=nprobe)
        pad = self._tomb_pad() if self.n_removed else 0
        vals, idxs = self._ivf_topk(q, min(self._base_k(k, rerank_factor), self.n), nprobe)
        return self._finish(q, vals, idxs, k, pad)

    def _ivf_topk(self, q, k: int, nprobe: int):
        qr = self._rotate_queries(q)
        return ivf_topk(pq_lookup(qr, self.codebooks), qr, self._ivf, k, nprobe=nprobe,
                        compute_dtype=self.compute_dtype)

    def _row_coding(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-row (cell, residual codes) in row order, the inverse of the
        binning, cached on the host until the inverted file is rebuilt."""
        if self._coding is None:
            self._coding = unbin_ivf(self._ivf, self.n)
        return self._coding

    def _expand_queries(self, q, k: int, alpha: float, nprobe: int) -> torch.Tensor:
        """AQE against IVF reconstructions, ``centroid[cell] + decode(codes)``
        in the rotated space: what the search ranks by. Tombstoned rows
        never steer it."""
        k = min(int(k), self.n)
        pad = self._tomb_pad() if self.n_removed else 0
        vals, idxs = self._neighbours(*self._ivf_topk(q, min(k + pad, self.n), nprobe), k)
        assign, codes = self._row_coding()
        safe = idxs.clamp_min(0).reshape(-1).cpu().numpy()
        nb = reconstruct_pq(torch.from_numpy(codes[safe]), self.codebooks) \
            + self._centroids[torch.from_numpy(assign[safe]).to(self.device).long()]
        return self._expanded(q, vals, idxs, nb.reshape(*idxs.shape, self.dim), k, alpha)

    # --- mutation -------------------------------------------------------
    def _rebin(self, assign: np.ndarray, codes: np.ndarray) -> None:
        self._ivf = bin_ivf(assign, codes, self._centroids.cpu().numpy(), slab=self._ivf.slab,
                            cap=self._ivf.vlist_tab.shape[1]).to(self.device)
        self._coding = None

    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Assign and encode the new rows against the existing centroids and
        codebooks, then re-bin on the host (old rows are not re-scanned)."""
        new = self._new_rows(descriptors, keys).to(self.device, torch.float32)
        new_r = self._rotate_rows(new)
        a_new = ivf_assign(new_r, self._centroids)
        c_new = encode_pq(new_r - self._centroids[torch.from_numpy(a_new).to(self.device).long()],
                          self.codebooks).cpu().numpy()
        a_old, c_old = unbin_ivf(self._ivf, self.n)
        self._rebin(np.concatenate([a_old, a_new]), np.concatenate([c_old, c_new]))
        self._grow_rerank(new)
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        a_old, c_old = unbin_ivf(self._ivf, self.n)
        self._rebin(a_old[keep_idx], c_old[keep_idx])
        self._compact_rerank(torch.from_numpy(keep_idx).to(self.device))

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """One npz in dirjax's layout (the ``ivf_*`` arrays, codebooks, and
        the rotation, int8 rerank rows, keys and tombstones where present)."""
        ivf = self._ivf
        self._save_common({
            "ivf_codes": ivf.codes.cpu().numpy(),
            "ivf_slab_rows": ivf.slab_rows.cpu().numpy(),
            "ivf_vlist_tab": ivf.vlist_tab.cpu().numpy(),
            "ivf_cell_of_v": ivf.cell_of_v.cpu().numpy(),
            "ivf_centroids": self._centroids.cpu().numpy(),
            "ivf_meta": np.asarray([self.n, self.nprobe], np.int64),
        }, path)

    @classmethod
    def load(cls, path: str, device="cuda") -> "IVFPQIndex":
        idx = cls.__new__(cls)
        with np.load(path, allow_pickle=False) as data:
            n, idx.nprobe = (int(v) for v in data["ivf_meta"])
            idx._load_common(data, n, device)
            centroids = data["ivf_centroids"]
            idx._ivf = IVFArrays.from_numpy(centroids, data["ivf_vlist_tab"],
                                            data["ivf_codes"], data["ivf_slab_rows"],
                                            data["ivf_cell_of_v"]).to(idx.device)
        idx._centroids = torch.from_numpy(np.asarray(centroids, np.float32)).to(idx.device)
        return idx

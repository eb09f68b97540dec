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
* ``save``/``load`` use dirjax's ``.npz`` layout, so an index file written
  by either package loads in the other; :meth:`RetrievalIndex.load` opens a
  binary file as a :class:`BinaryIndex`, as dirjax's does.

Not ported: ``mesh=`` (ROADMAP M13), the PQ and IVF indexes (M10-M11), and
dirjax's query-count buckets, which exist only because XLA compiles per
shape; nothing here does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .ops.binary import (BinaryCodec, _to_bytes, binarize, fit_itq,
                         hamming_search_fused)
from .ops.qe import expand_queries_chunked, expand_queries_quantized
from .ops.topk import quantize_db, rank_topk_fused

__all__ = ["RetrievalIndex", "BinaryIndex"]

_DTYPES = (torch.float32, torch.bfloat16, torch.int8)


def _as_tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


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
        descs = _as_tensor(descriptors)
        if descs.dim() != 2:
            raise ValueError(f"descriptors must be (N, D), got {tuple(descs.shape)}")
        self.n, self.dim = descs.shape
        self.keys = list(keys) if keys is not None else None
        if self.keys is not None and len(self.keys) != self.n:
            raise ValueError(f"{len(self.keys)} keys for {self.n} descriptors")
        self.device = torch.device(device)
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
        loads as int8 without requantizing, an fp32 one as fp32. A binary
        archive loads as a :class:`BinaryIndex`."""
        with np.load(path, allow_pickle=False) as data:
            if {"ivf_codes", "pq_codes"} & set(data.files):
                raise NotImplementedError(
                    f"{path} holds a PQ or IVF index, which dirjax_torch "
                    "does not port yet (ROADMAP M10-M11)")
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
        descs = _as_tensor(descriptors)
        if descs.dim() != 2:
            raise ValueError(f"descriptors must be (N, D), got {tuple(descs.shape)}")
        self.n, self.dim = descs.shape
        self.keys = list(keys) if keys is not None else None
        if self.keys is not None and len(self.keys) != self.n:
            raise ValueError(f"{len(self.keys)} keys for {self.n} descriptors")
        self.device = torch.device(device)
        self.asym = bool(asym)
        descs = descs.to(self.device, torch.float32)
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

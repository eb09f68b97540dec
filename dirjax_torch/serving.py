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
* ``mesh=`` (a :mod:`dirjax_torch.parallel` mesh) row-shards the database
  of :class:`RetrievalIndex`, :class:`BinaryIndex` and :class:`PQIndex`
  over the mesh's "db" axis, on each rank's device (``cuda:LOCAL_RANK``, or
  the CPU for a ``"cpu"`` mesh), and searches through the sharded tiers of
  :mod:`dirjax_torch.parallel.ranking`. Every rank makes the same calls
  and gets the same answers. ``add``, ``compact`` and ``save`` gather the
  shards (one pass over the database; ``add`` and ``compact`` re-shard);
  rank 0 writes the file. A binary mesh search rescores a symmetric shortlist of
  ``rerank_factor * k`` rows a rank, as dirjax's mesh path does, where the
  single-chip search is exact. :class:`IVFPQIndex` stays single-chip, as
  dirjax's does: IVF on a mesh goes through
  :func:`~dirjax_torch.parallel.ranking.shard_ivf`.

Not ported: dirjax's query-count buckets, which exist only because XLA
compiles per shape (nothing here does), and its packed single pull of
values and indices.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .ops.binary import (BinaryCodec, _to_bytes, binarize, binarize_and_project, fit_itq,
                         hamming_search_fused)
from .ops.ivf import IVFArrays, bin_ivf, build_ivf, ivf_assign, ivf_topk, unbin_ivf
from .ops.pq import (encode_pq, pq_lookup, pq_topk, reconstruct_pq, train_opq,
                     train_pq)
from .ops.qe import (_drop_excluded, _weights, expand_queries_chunked,
                     expand_queries_quantized)
from .ops.topk import _topk, quantize_db, rank_topk_fused
from .parallel import ranking as shr
from .parallel.mesh import mesh_device
from .utils import timer

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
    mesh = None                # a DeviceMesh: the rows are sharded over "db"

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

    def _set_rows(self, descriptors, keys, device, mesh=None) -> torch.Tensor:
        """Validate (N, D) descriptors and their keys; set ``n``, ``dim``,
        ``keys``, ``mesh`` and ``device`` (the rank's, on a mesh). Returns the
        descriptors as a tensor."""
        descs = _as_tensor(descriptors)
        if descs.dim() != 2:
            raise ValueError(f"descriptors must be (N, D), got {tuple(descs.shape)}")
        self.n, self.dim = descs.shape
        self.keys = list(keys) if keys is not None else None
        if self.keys is not None and len(self.keys) != self.n:
            raise ValueError(f"{len(self.keys)} keys for {self.n} descriptors")
        self._set_mesh(mesh, device)
        return descs

    def _set_mesh(self, mesh, device) -> None:
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh_device(mesh)

    def _writes(self) -> bool:
        """Whether this process writes the index file: always off a mesh,
        rank 0 on one."""
        return self.mesh is None or dist.get_rank() == 0

    def _written(self) -> None:
        """On a mesh, wait until rank 0 has written the file: a rank's
        ``save`` returns when the file exists."""
        if self.mesh is not None:
            dist.barrier()

    def _gathered(self, local: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The first ``n`` rows (columns for ``dim=1``) of the "db" shards."""
        full = shr.gather_shards(local, self.mesh, "db", dim=dim)
        return full[:self.n] if dim == 0 else full[:, :self.n]

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
    (per-row quantized, :func:`.ops.topk.quantize_db`). ``mesh=``: rows
    (and int8 scales) sharded over the mesh's "db" axis."""

    def __init__(self, descriptors, keys: Optional[Sequence[str]] = None,
                 dtype: torch.dtype = torch.float32, device="cuda", mesh=None):
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype}")
        descs = self._set_rows(descriptors, keys, device, mesh)
        self.dtype = dtype
        self._scales = None
        if dtype == torch.int8:
            self._set_int8(*quantize_db(descs.to(self.device)))
        elif mesh is None:
            self._db = descs.to(self.device, dtype).contiguous()
        else:
            self._set_float(descs)

    def _set_float(self, rows: torch.Tensor) -> None:
        """Place full float rows: this rank's slice on a mesh."""
        if self.mesh is None:
            self._db = rows.to(self.device, self.dtype).contiguous()
            return
        local, self._n_valid = shr.shard_database(rows, self.mesh)
        self._db = local.to(self.dtype)

    def _set_int8(self, rows: torch.Tensor, scales: torch.Tensor) -> None:
        """Place full int8 rows and their (1, n) scales, as they are: this
        rank's slices on a mesh (pad rows carry scale 0)."""
        if self.mesh is None:
            self._db, self._scales = rows.to(self.device), scales.to(self.device)
            return
        self._db, self._n_valid = shr.shard_database(rows, self.mesh)
        self._scales = shr.shard_database(scales.reshape(-1, 1), self.mesh)[0].reshape(1, -1)

    def _full(self):
        """(rows, scales or None) of the whole index on this device."""
        if self.mesh is None:
            return self._db, self._scales
        scales = None if self._scales is None else self._gathered(self._scales, dim=1)
        return self._gathered(self._db), scales

    # --- search ---------------------------------------------------------
    def search(self, queries, k: int = 10, *, aqe: Optional[dict] = None,
               int8_queries: bool = False) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (fp32 scores, int32 indices) per query row, as numpy.
        ``aqe={'k':, 'alpha':}`` expands the queries against the index first
        (``test_dir.py:24-44`` semantics); ``int8_queries=True`` (int8
        indexes) quantizes the possibly expanded queries per row, so the
        contraction is int8 x int8. Its host time up to the results' pull
        is the span ``index.launch``, the pull ``index.pull``."""
        launch = timer.begin()
        if int8_queries and self._scales is None:
            raise ValueError("int8_queries requires an int8 index "
                             "(RetrievalIndex(dtype=torch.int8))")
        q = _as_tensor(queries)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {tuple(q.shape)}")
        if not self.n_removed:
            return self._search(q, k, aqe, bool(int8_queries), launch)
        if k > self.n:   # the same contract as the clean path
            raise ValueError(f"k={k} exceeds the {self.n} database rows")
        vals, idxs = self._search(q, min(k + self._tomb_pad(), self.n), aqe,
                                  bool(int8_queries), launch)
        return self._tomb_filter(vals, idxs, k)

    def _search(self, q, k: int, aqe: Optional[dict], int8_queries: bool,
                launch: Optional[tuple] = None):
        if self.mesh is not None:
            vals, idxs = self._search_mesh(q, k, aqe, int8_queries)
        elif self._scales is not None:
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
        timer.end(launch, "index.launch", len(q))
        with timer.span("index.pull", len(q)):
            return vals.cpu().numpy(), idxs.to(torch.int32).cpu().numpy()

    def _search_mesh(self, q, k: int, aqe: Optional[dict], int8_queries: bool):
        """AQE against the shards, then the sharded top-k, left on the device
        (the single-device contract: ``k`` at most ``n``). A float index takes
        the query at its own dtype into the expansion, as its single-device
        search does (dirjax's mesh path expands the fp32 query of a bf16
        index)."""
        if k > self.n:
            raise ValueError(f"k={k} exceeds the {self.n} database rows")
        q = q.to(self.device, torch.float32 if self._scales is not None else self.dtype)
        if aqe:
            q = shr.sharded_aqe(q, self._db, self.mesh, self._n_valid, alpha=aqe["alpha"],
                                k=aqe["k"], db_scales=self._scales,
                                **self._tomb_aqe_kwargs())
            if self._scales is None:
                q = q.to(self.dtype)
        return shr.sharded_topk(q, self._db, k, self.mesh, self._n_valid,
                                db_scales=self._scales,
                                quantize_queries=self._scales is not None and int8_queries)

    # --- mutation -------------------------------------------------------
    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Append rows (and keys, for a keyed index). An int8 index quantizes
        the new rows with their own scales; existing rows are untouched. A
        mesh index gathers its shards and re-shards."""
        new = self._new_rows(descriptors, keys)
        rows, scales = self._full()
        if self._scales is not None:
            q8, s8 = quantize_db(new.to(self.device))
            self._set_int8(torch.cat([rows, q8]), torch.cat([scales, s8], dim=1))
        else:
            self._set_float(torch.cat([rows, new.to(self.device, self.dtype)]))
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        keep = torch.from_numpy(keep_idx).to(self.device)
        rows, scales = self._full()
        if self._scales is not None:
            self._set_int8(rows[keep], scales[:, keep].contiguous())
        else:
            self._set_float(rows[keep])

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """int8 indexes persist quantized (rows and (1, n) scales), others as
        fp32 rows; tombstones as packed bits. dirjax's layout. A mesh index
        gathers its shards on every rank; rank 0 writes."""
        rows, scales = self._full()
        if self._writes():
            arrays = {}
            self._tomb_save(arrays)
            if scales is not None:
                arrays["descriptors_i8"] = rows.cpu().numpy()
                arrays["scales"] = scales.cpu().numpy()
            else:
                arrays["descriptors"] = rows.float().cpu().numpy()
            if self.keys is not None:
                arrays["keys"] = np.asarray(self.keys)
            with open(path, "wb") as f:
                np.savez(f, **arrays)
        self._written()

    @classmethod
    def load(cls, path: str, dtype: Optional[torch.dtype] = None,
             device="cuda", mesh=None):
        """``dtype=None`` keeps the stored representation: an int8 archive
        loads as int8 without requantizing, an fp32 one as fp32. A binary,
        PQ or IVF archive loads as a :class:`BinaryIndex`, :class:`PQIndex`
        or :class:`IVFPQIndex`. ``mesh=`` shards what it loads (an IVF file
        is refused: that index is single-chip)."""
        with np.load(path, allow_pickle=False) as data:
            if "ivf_codes" in data.files:
                if mesh is not None:
                    raise ValueError(f"{path} is an IVF-PQ index, which is single-chip; "
                                     "shard its inverted file with parallel.shard_ivf")
                return IVFPQIndex.load(path, device=device)
            if "pq_codes" in data.files:
                return PQIndex.load(path, device=device, mesh=mesh)
            if "binary_codes" in data.files:
                return BinaryIndex.load(path, device=device, mesh=mesh)
            keys = [str(k) for k in data["keys"]] if "keys" in data else None
            quantized = "descriptors_i8" in data
            rows = data["descriptors_i8" if quantized else "descriptors"]
            scales = data["scales"] if quantized else None
            removed = cls._tomb_unpack(data, len(rows))
        if quantized and dtype in (None, torch.int8):
            idx = cls.__new__(cls)
            idx.n, idx.dim = rows.shape
            idx.keys = keys
            idx._set_mesh(mesh, device)
            idx.dtype = torch.int8
            idx._set_int8(torch.from_numpy(rows), torch.from_numpy(scales))
        else:
            if quantized:   # a float index from an int8 archive: dequantize
                rows = rows.astype(np.float32) * scales.T
            idx = cls(rows, keys=keys, device=device, mesh=mesh,
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
    candidate first). Codes are stored unpadded in the byte layout; on a
    mesh (``mesh=``) each rank keeps its slice, padded as
    :func:`~dirjax_torch.parallel.ranking.shard_codes_binary` pads it."""

    def __init__(self, descriptors, n_bits: Optional[int] = None,
                 keys: Optional[Sequence[str]] = None, *, itq_iters: int = 30,
                 asym: bool = True, seed: int = 0, sample: Optional[int] = 131072,
                 device="cuda", mesh=None, _codec: Optional[BinaryCodec] = None):
        descs = self._set_rows(descriptors, keys, device, mesh).to(self.device, torch.float32)
        self.asym = bool(asym)
        if _codec is None:
            _codec = fit_itq(descs, n_bits, iters=itq_iters, seed=seed, sample=sample)
        self.codec = BinaryCodec(*(t.to(self.device, torch.float32) for t in _codec))
        self._set_codes(binarize(descs, self.codec))

    n_bits = property(lambda self: self.codec.n_bits)

    def _set_codes(self, codes: torch.Tensor) -> None:
        """Place the full byte codes: this rank's slice on a mesh."""
        self._codes = codes if self.mesh is None else \
            shr.shard_codes_binary(codes, self.mesh)[0]

    def _all_codes(self) -> torch.Tensor:
        return self._codes if self.mesh is None else self._gathered(self._codes)

    # --- search ---------------------------------------------------------
    def search(self, queries, k: int = 10, *, rerank_factor: int = 4
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (fp32 scores, int32 indices) per query row, as numpy. A
        single-device search is exact under its score and ignores
        ``rerank_factor``, as dirjax's single chip does; on a mesh, an
        asymmetric index rescores each rank's symmetric shortlist of
        ``rerank_factor * k`` rows (dirjax's mesh path)."""
        q = _as_tensor(queries)
        if q.dim() == 1:
            q = q[None, :]
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(f"queries must be (nq, {self.dim}), got {tuple(q.shape)}")
        if k > self.n:
            raise ValueError(f"k={k} exceeds the {self.n} database rows")
        pad = self._tomb_pad() if self.n_removed else 0
        q = q.to(self.device, torch.float32)
        if self.mesh is None:
            vals, idxs = hamming_search_fused(q, self.codec, self._codes,
                                              min(k + pad, self.n), asym=self.asym)
        else:
            qb, vq = binarize_and_project(q, self.codec)
            vals, idxs = shr.sharded_hamming_topk(
                qb, self._codes, min(k + pad, self.n), self.mesh, self.n,
                vq=vq if self.asym else None, rerank_factor=rerank_factor)
        vals, idxs = vals.cpu().numpy(), idxs.to(torch.int32).cpu().numpy()
        if pad:
            vals, idxs = self._tomb_filter(vals, idxs, k)
        return vals, idxs

    # --- mutation -------------------------------------------------------
    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Encode new rows with the existing codec and append them."""
        new = self._new_rows(descriptors, keys)
        self._set_codes(torch.cat([self._all_codes(), binarize(new, self.codec)]))
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        self._set_codes(self._all_codes()[torch.from_numpy(keep_idx).to(self.device)])

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """One npz in dirjax's layout: uint32 code words, the codec, the
        score mode, keys and tombstones (rank 0 writes a mesh index)."""
        codes = self._all_codes()
        if self._writes():
            arrays = {
                "binary_codes": codes.cpu().numpy().view("<u4"),
                "binary_mean": self.codec.mean.cpu().numpy(),
                "binary_proj": self.codec.proj.cpu().numpy(),
                "binary_asym": np.asarray(int(self.asym)),
            }
            self._tomb_save(arrays)
            if self.keys is not None:
                arrays["keys"] = np.asarray(self.keys)
            with open(path, "wb") as f:
                np.savez(f, **arrays)
        self._written()

    @classmethod
    def load(cls, path: str, device="cuda", mesh=None) -> "BinaryIndex":
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
        idx._set_mesh(mesh, device)
        idx.codec = BinaryCodec(torch.from_numpy(mean).to(idx.device, torch.float32),
                                torch.from_numpy(proj).to(idx.device, torch.float32))
        idx._set_codes(_to_bytes(codes).to(idx.device))
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

    def _load_common(self, data, n: int, device, mesh=None) -> None:
        self._set_mesh(mesh, device)
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
    None). Codes are stored unpadded; K6 masks rows >= n itself. ``mesh=``:
    codes sharded over the mesh's "db" axis; the int8 rerank rows, the
    codebooks and the rotation are whole on every rank."""

    def __init__(self, descriptors, m: int = 32, ksub: int = 16,
                 keys: Optional[Sequence[str]] = None, *, opq: bool = False,
                 rerank: bool = False, train_iters: int = 25, seed: int = 0,
                 sample: Optional[int] = 262144, compute_dtype=None, device="cuda",
                 mesh=None, _trained=None):
        descs = self._set_rows(descriptors, keys, device, mesh).to(self.device, torch.float32)
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
        self._set_codes(self._encode(descs))
        self._set_rerank(descs, rerank)

    def _set_codes(self, codes: torch.Tensor) -> None:
        """Place the full codes: this rank's slice on a mesh."""
        if self.mesh is None:
            self._codes = codes.to(self.device).contiguous()
        else:
            self._codes, self._n_valid = shr.shard_codes(codes, self.mesh)

    def _all_codes(self) -> torch.Tensor:
        return self._codes if self.mesh is None else self._gathered(self._codes)

    @classmethod
    def from_codes(cls, codebooks, codes, *, keys: Optional[Sequence[str]] = None,
                   rotation=None, compute_dtype=None, device="cuda",
                   mesh=None) -> "PQIndex":
        """An index of pre-encoded rows: ``codebooks`` (m, ksub, D/m) from
        :func:`.ops.pq.train_pq` and ``codes`` (n, m) uint8 from
        :func:`.ops.pq.encode_pq`. No training; no int8 rescore (it needs
        the original rows)."""
        self = cls.__new__(cls)
        self._set_mesh(mesh, device)
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
        self._set_codes(codes)
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
        if self.mesh is not None:
            return shr.sharded_pq_topk(luts, self._codes, k, self.mesh, self._n_valid,
                                       compute_dtype=self.compute_dtype)
        return pq_topk(luts, self._codes, k, compute_dtype=self.compute_dtype)

    def _expand_queries(self, q, k: int, alpha: float) -> torch.Tensor:
        """AQE against the neighbours' centroid reconstructions, so it runs at
        pure-compressed capacity; tombstoned rows never steer it."""
        k = min(int(k), self.n)
        pad = self._tomb_pad() if self.n_removed else 0
        vals, idxs = self._neighbours(*self._adc_topk(q, min(k + pad, self.n)), k)
        if self.mesh is None:
            codes = self._codes[idxs.clamp_min(0).reshape(-1)]
        else:   # each rank fills the neighbours it holds
            codes = shr.gather_rows(self._codes, idxs.clamp_min(0), self.mesh, self.n,
                                    transform=lambda rows, _: rows.int())
            codes = codes.to(torch.uint8).reshape(-1, self.m)
        nb = reconstruct_pq(codes, self.codebooks)
        return self._expanded(q, vals, idxs, nb.reshape(*idxs.shape, self.dim), k, alpha)

    # --- mutation -------------------------------------------------------
    def add(self, descriptors, keys: Optional[Sequence[str]] = None) -> None:
        """Encode new rows with the existing codebooks (and rotation) and
        append them."""
        new = self._new_rows(descriptors, keys).to(self.device, torch.float32)
        self._set_codes(torch.cat([self._all_codes(), self._encode(new)]))
        self._grow_rerank(new)
        self._append_keys(keys, len(new))

    def _compact_rows(self, keep_idx: np.ndarray) -> None:
        keep = torch.from_numpy(keep_idx).to(self.device)
        self._set_codes(self._all_codes()[keep])
        self._compact_rerank(keep)

    # --- persistence ----------------------------------------------------
    def save(self, path: str) -> None:
        """One npz in dirjax's layout: codes, codebooks, and the rotation,
        int8 rerank rows, keys and tombstones where present (rank 0 writes
        a mesh index)."""
        codes = self._all_codes()
        if self._writes():
            self._save_common({"pq_codes": codes.cpu().numpy()}, path)
        self._written()

    @classmethod
    def load(cls, path: str, device="cuda", mesh=None) -> "PQIndex":
        idx = cls.__new__(cls)
        with np.load(path, allow_pickle=False) as data:
            codes = data["pq_codes"]
            idx._load_common(data, len(codes), device, mesh)
        if codes.shape[1] != idx.m:
            raise ValueError(f"{path}: codes of {codes.shape[1]} subspaces for "
                             f"{idx.m} codebooks")
        idx._set_codes(torch.from_numpy(codes))
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

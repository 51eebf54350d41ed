"""Sorted-set kernels: the device replacement of the reference's sharded
C++ hashmaps (vaex-core/src/hash_primitives.hpp: ordered_set / counter /
index_hash; hash.hpp sharded hash_common).

Design: hash tables with per-shard locks do not map onto XLA's static-shape,
lock-free SPMD model.  Instead every "set" is a *sorted* unique-key array plus
separate NaN/null slots; probes are binary searches (``searchsorted``) which
vectorize perfectly on the VPU and cost O(log U) per row with zero
synchronization.  Ordinals are positions in the sorted order — which makes the
``sort=True`` contract of the reference (ascending keys, NaN group last, null
last; SURVEY §2.4) the *natural* order here, while the reference's unsorted
insertion order is explicitly not a stable contract (tests compare sets).

Host side builds/merges sets chunk-by-chunk with numpy; device side probes
them inside the traced pass via :func:`device_map_ordinal` / :func:`device_isin`.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .. import array_types
from ..utils import fingerprint


class RowLimitException(Exception):
    """Raised when a set exceeds its row limit (reference: cpu.py:197-200)."""


def _unique_and_counts(data, keep_counts):
    """Fast host unique: bincount for narrow-range ints (the groupby pass-1
    hot path — ~5x np.unique), arrow's hash-based unique for wide ranges and
    floats, np.unique as the general fallback."""
    n = len(data)
    if n == 0:
        return data[:0], (np.empty(0, np.int64) if keep_counts else None)
    if data.dtype.kind in "iu" and n > 4096:
        from .. import hostkern
        lo, hi = hostkern.minmax(data.astype(np.int64, copy=False))
        span = int(hi) - int(lo) + 1
        if 0 < span <= max(4 * n, 1 << 22):
            counts = np.bincount((data.astype(np.int64, copy=False) - lo), minlength=span)
            present = counts > 0
            uniq = (np.flatnonzero(present) + lo).astype(data.dtype)
            return uniq, (counts[present].astype(np.int64) if keep_counts else None)
    if data.dtype.kind in "iuf" and n > 65536:
        try:
            import pyarrow as pa
            import pyarrow.compute as pc
            if keep_counts:
                vc = pc.value_counts(pa.array(data))
                uniq = np.asarray(vc.field("values"))
                cnt = np.asarray(vc.field("counts")).astype(np.int64)
                order = np.argsort(uniq, kind="stable")
                return uniq[order], cnt[order]
            uniq = np.sort(np.asarray(pc.unique(pa.array(data))))  # arrow buffers are read-only
            return uniq, None
        except ImportError:
            pass
    if data.dtype.kind in "OUS" and n > 4096:
        # strings: arrow's hash kernels beat np.unique's per-row Python
        # comparisons by ~30x (reference: hash_string.cpp bulk inserts)
        try:
            import pyarrow as pa
            import pyarrow.compute as pc
        except ImportError:  # pragma: no cover
            pa = None
        if pa is not None:
            try:
                arr = pa.array(data, type=pa.large_utf8())
                if keep_counts:
                    vc = pc.value_counts(arr)
                    uniq = np.asarray(vc.field("values").to_pylist(), dtype=object)
                    cnt = np.asarray(vc.field("counts")).astype(np.int64)
                    order = np.argsort(uniq, kind="stable")
                    return uniq[order], cnt[order]
                uniq = np.asarray(pc.unique(arr).to_pylist(), dtype=object)
                return np.sort(uniq), None
            except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError, ValueError, TypeError):
                # non-UTF8 bytes / object arrays holding non-strings:
                # dictionary-encode through arrow's generic type inference
                # (bytes -> binary, ints -> int64) before giving up on the
                # hash path (reference hash_object.cpp)
                try:
                    arr = pa.array(data.tolist(), from_pandas=True)
                    if keep_counts:
                        vc = pc.value_counts(arr)
                        uniq = np.asarray(vc.field("values").to_pylist(), dtype=object)
                        cnt = np.asarray(vc.field("counts")).astype(np.int64)
                        order = np.argsort(uniq, kind="stable")
                        return uniq[order], cnt[order]
                    uniq = np.asarray(pc.unique(arr).to_pylist(), dtype=object)
                    return np.sort(uniq), None
                except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError,
                        pa.lib.ArrowNotImplementedError, ValueError, TypeError):
                    pass
    if keep_counts:
        return np.unique(data, return_counts=True)
    return np.unique(data), None


def _is_float(dtype):
    return np.dtype(dtype).kind == "f"


def _split_special(data, mask):
    """Split chunk into (clean values, nan_count, null_count)."""
    null_count = 0
    if mask is not None:
        null_count = int(mask.sum())
        data = data[~mask]
    nan_count = 0
    if _is_float(data.dtype):
        nanmask = np.isnan(data)
        nan_count = int(nanmask.sum())
        if nan_count:
            data = data[~nanmask]
    return data, nan_count, null_count


def _as_string_arrow(values):
    """The values as a combined arrow string array, or None when they are
    not arrow-string-backed (keeps string chunks on their native arrow
    buffers instead of exploding them into Python objects)."""
    try:
        import pyarrow as pa
    except ImportError:  # pragma: no cover
        return None
    if isinstance(values, pa.ChunkedArray):
        values = values.combine_chunks()
    if not isinstance(values, pa.Array):
        return None
    t = values.type
    if pa.types.is_dictionary(t):
        values = values.dictionary_decode()
        t = values.type
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        return values
    return None


def _as_dict_string_arrow(values):
    """The values as an arrow DictionaryArray of strings, or None.

    Dictionary columns carry U unique strings + int codes; set builds and
    ordinal probes then cost O(U) string work + O(N) integer work per chunk
    instead of re-hashing N strings (the reference re-hashes every row,
    hash_string.cpp; this is the O(U) shortcut its dictionary types never
    got)."""
    try:
        import pyarrow as pa
    except ImportError:  # pragma: no cover
        return None
    if isinstance(values, pa.ChunkedArray):
        if values.num_chunks == 1:
            values = values.chunk(0)
        else:
            return None  # chunks may carry different dictionaries
    if not isinstance(values, pa.Array) or not pa.types.is_dictionary(values.type):
        return None
    vt = values.type.value_type
    if pa.types.is_string(vt) or pa.types.is_large_string(vt):
        return values
    return None


def _dict_cache_key(dictionary):
    """Identity key for a dictionary's backing buffers: chunks of one
    column share the same dictionary object/buffers, so per-dictionary
    work (sorting, probing) runs once per pass, not once per chunk."""
    bufs = dictionary.buffers()
    addr = tuple(b.address for b in bufs if b is not None)
    return (addr, len(dictionary), dictionary.offset)


def _sorted_dictionary(dictionary, _cache={}):
    """(sorted unique key array [object], group map [U] int64) for an arrow
    string dictionary: group[i] = position of dictionary value i in the
    sorted-unique key order (dictionaries may in principle repeat values)."""
    key = _dict_cache_key(dictionary)
    hit = _cache.get(key)
    if hit is not None:
        return hit
    uniq = np.asarray(dictionary.to_pylist(), dtype=object)
    order = np.argsort(uniq, kind="stable")
    su = uniq[order]
    if len(su):
        is_new = np.empty(len(su), bool)
        is_new[0] = True
        is_new[1:] = su[1:] != su[:-1]
        skeys = su[is_new]
        group_sorted = np.cumsum(is_new) - 1
        group = np.empty(len(su), np.int64)
        group[order] = group_sorted
    else:
        skeys = su
        group = np.empty(0, np.int64)
    if len(_cache) > 16:
        _cache.clear()
    _cache[key] = (skeys, group)
    return skeys, group


class SortedSet:
    """ordered_set + counter in one (reference: hash_primitives.hpp:329-621).

    ``keys`` is always sorted ascending and excludes NaN/null, which get the
    trailing ordinals: [0, n_keys) = keys, then NaN (if any), then null (if
    any).  With ``keep_counts=True`` it doubles as the reference's ``counter``.
    """

    def __init__(self, dtype, keep_counts=False, limit=None):
        self.dtype = np.dtype(dtype) if not isinstance(dtype, str) or dtype != "string" else dtype
        self.is_string = dtype == "string" or (isinstance(self.dtype, np.dtype) and self.dtype.kind in "OUS")
        self._keys = np.empty(0, dtype=object if self.is_string else self.dtype)
        self._n_keys_device = None  # device-built sets defer the D2H copy
        self.keep_counts = keep_counts
        self.counts = np.empty(0, dtype=np.int64) if keep_counts else None
        self.nan_count = 0
        self.null_count = 0
        self.limit = limit
        self._fingerprint = None
        self._device_keys = None  # HBM copy set by device-side builds

    # -- construction -------------------------------------------------------
    def update(self, values, return_inverse=False):
        """Merge one chunk of host values into the set."""
        darr = _as_dict_string_arrow(values)
        if darr is not None:
            self._update_from_dict(darr)
            return
        arrow = _as_string_arrow(values)
        if arrow is not None:
            # stay in arrow: hash kernels on the native buffers, no
            # to_pylist() round-trip of the whole chunk (only the chunk's
            # UNIQUE keys materialize as Python strings)
            import pyarrow.compute as pc
            self.null_count += arrow.null_count
            if arrow.null_count:
                arrow = arrow.drop_null()
            if self.keep_counts:
                vc = pc.value_counts(arrow)
                uniq = np.asarray(vc.field("values").to_pylist(), dtype=object)
                cnt = np.asarray(vc.field("counts")).astype(np.int64)
                order = np.argsort(uniq, kind="stable")
                uniq, cnt = uniq[order], cnt[order]
            else:
                uniq = np.sort(np.asarray(pc.unique(arrow).to_pylist(), dtype=object))
                cnt = None
            self._merge_sorted_chunk(uniq, cnt)
            return
        data, mask = array_types.data_and_mask(values)
        data, nan_count, null_count = _split_special(data, mask)
        self.nan_count += nan_count
        self.null_count += null_count
        uniq, cnt = _unique_and_counts(data, self.keep_counts)
        self._merge_sorted_chunk(uniq, cnt)

    def _update_from_dict(self, darr):
        """O(U) + O(N)-int chunk merge for dictionary-encoded strings: the
        N-sized work is a bincount over the int codes; only the (cached,
        per-pass) dictionary sort touches strings."""
        skeys, group = _sorted_dictionary(darr.dictionary)
        n_null = darr.null_count
        self.null_count += n_null
        indices = darr.indices
        if n_null:
            indices = indices.fill_null(0)
        codes = np.asarray(indices)  # native int width: no 8-byte blowup
        U = len(darr.dictionary)
        if n_null:
            valid = ~np.asarray(darr.is_null())
            cnt_dict = np.bincount(codes[valid], minlength=U)
        else:
            cnt_dict = np.bincount(codes, minlength=U)
        cnt_sorted = np.zeros(len(skeys), np.int64)
        np.add.at(cnt_sorted, group, cnt_dict)
        present = cnt_sorted > 0
        self._merge_sorted_chunk(skeys[present],
                                 cnt_sorted[present] if self.keep_counts else None)

    def _merge_sorted_chunk(self, uniq, cnt):
        if len(self.keys) == 0:
            self.keys = uniq
            if self.keep_counts:
                self.counts = cnt.astype(np.int64)
        else:
            merged = np.concatenate([self.keys, uniq])
            if self.keep_counts:
                merged_counts = np.concatenate([self.counts, cnt])
                order = np.argsort(merged, kind="stable")
                merged = merged[order]
                merged_counts = merged_counts[order]
                is_new = np.empty(len(merged), dtype=bool)
                is_new[0] = True
                is_new[1:] = merged[1:] != merged[:-1]
                group = np.cumsum(is_new) - 1
                self.keys = merged[is_new]
                self.counts = np.zeros(len(self.keys), dtype=np.int64)
                np.add.at(self.counts, group, merged_counts)
            else:
                self.keys = np.unique(merged)
        if self.limit is not None and self.count > self.limit:
            raise RowLimitException(
                f"set grew to {self.count} unique values, which exceeds the limit of {self.limit}")
        self._fingerprint = None
        self._device_keys = None
        self._dict_probe = None

    def merge(self, other: "SortedSet"):
        self.nan_count += other.nan_count
        self.null_count += other.null_count
        if len(other.keys):
            if self.keep_counts:
                merged = np.concatenate([self.keys, other.keys])
                merged_counts = np.concatenate([self.counts, other.counts])
                order = np.argsort(merged, kind="stable")
                merged, merged_counts = merged[order], merged_counts[order]
                is_new = np.empty(len(merged), dtype=bool)
                is_new[0] = True
                is_new[1:] = merged[1:] != merged[:-1]
                group = np.cumsum(is_new) - 1
                self.keys = merged[is_new]
                self.counts = np.zeros(len(self.keys), dtype=np.int64)
                np.add.at(self.counts, group, merged_counts)
            else:
                self.keys = np.unique(np.concatenate([self.keys, other.keys]))
        self._fingerprint = None
        self._device_keys = None
        self._dict_probe = None

    # -- introspection ------------------------------------------------------
    @property
    def has_nan(self):
        return self.nan_count > 0

    @property
    def has_null(self):
        return self.null_count > 0

    @property
    def keys(self):
        # device-built sets keep keys on device; the host copy (a D2H of
        # the whole key array) happens on first access
        if self._keys is None and self._device_keys is not None:
            self._keys = np.asarray(self._device_keys)
        return self._keys

    @keys.setter
    def keys(self, value):
        self._keys = value
        self._n_keys_device = None

    @property
    def n_keys(self):
        if self._keys is None and self._n_keys_device is not None:
            return self._n_keys_device
        return len(self.keys)

    @property
    def count(self):
        """Total number of distinct values including NaN/null slots."""
        return self.n_keys + int(self.has_nan) + int(self.has_null)

    @property
    def nan_ordinal(self):
        return self.n_keys if self.has_nan else -1

    @property
    def null_ordinal(self):
        return self.n_keys + int(self.has_nan) if self.has_null else -1

    def key_array(self, masked=True):
        """All keys in ordinal order; NaN/null slots included.

        Returns a masked array when a null slot exists (mirrors the
        reference's Grouper.bin_values, groupby.py:124-158).
        """
        if self.is_string:
            keys = list(self.keys)
            if self.has_nan:
                keys.append(float("nan"))
            values = np.asarray(keys + ([None] if self.has_null else []), dtype=object)
            if self.has_null and masked:
                mask = np.zeros(len(values), bool)
                mask[-1] = True
                return np.ma.MaskedArray(values, mask)
            return values
        n = self.count
        out = np.zeros(n, dtype=self.dtype if not self.has_nan or _is_float(self.dtype) else self.dtype)
        out[:self.n_keys] = self.keys
        if self.has_nan:
            out[self.nan_ordinal] = np.nan
        if self.has_null:
            mask = np.zeros(n, bool)
            mask[self.null_ordinal] = True
            if masked:
                return np.ma.MaskedArray(out, mask)
        return out

    def fingerprint(self):
        if self._fingerprint is None:
            self._fingerprint = fingerprint("sorted-set", self.keys if self.keys.dtype != object
                                            else tuple(self.keys), self.nan_count, self.null_count)
        return self._fingerprint

    # -- host probes --------------------------------------------------------
    def _dict_ordinals(self, dictionary):
        """Ordinal (or -1) of each dictionary value — probed once per
        (dictionary, set) pair and reused for every chunk's O(N) int take."""
        key = _dict_cache_key(dictionary)
        cached = getattr(self, "_dict_probe", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        uniq = np.asarray(dictionary.to_pylist(), dtype=object)
        # shrink on the U-sized array: the N-sized gather then reads/writes
        # the final narrow dtype directly (an int64 intermediate at 1e8 rows
        # measured 18 s of pure astype on the 2-vCPU host)
        ords = _shrink_codes(_string_index_in(uniq, self.keys), self.count)
        self._dict_probe = (key, ords)
        return ords

    def map_ordinal(self, values):
        """values -> ordinal codes (host). Unknown keys get -1."""
        darr = _as_dict_string_arrow(values)
        if darr is not None:
            ords = self._dict_ordinals(darr.dictionary)
            indices = darr.indices
            n_null = darr.null_count
            if n_null:
                indices = indices.fill_null(0)
            if len(ords):
                codes = ords[np.asarray(indices)]  # native-int gather
            else:
                codes = np.full(len(darr), -1, _shrink_codes(
                    np.empty(0, np.int64), self.count).dtype)
            if n_null:
                codes[np.asarray(darr.is_null())] = self.null_ordinal
            return codes
        arrow = _as_string_arrow(values)
        if arrow is not None:
            codes = _string_index_in(arrow, self.keys)
            if arrow.null_count:
                codes = np.where(np.asarray(arrow.is_null()), self.null_ordinal, codes)
            return _shrink_codes(codes, self.count)
        data, mask = array_types.data_and_mask(values)
        if self.is_string:
            codes = _string_index_in(data, self.keys)
        else:
            idx = np.searchsorted(self.keys, data)
            idx = np.clip(idx, 0, max(self.n_keys - 1, 0))
            found = (self.keys[idx] == data) if self.n_keys else np.zeros(len(data), bool)
            codes = np.where(found, idx, -1).astype(np.int64)
            if _is_float(data.dtype):
                codes = np.where(np.isnan(data), self.nan_ordinal, codes)
        if mask is not None:
            codes = np.where(mask, self.null_ordinal, codes)
        return _shrink_codes(codes, self.count)

    def isin(self, values):
        darr = _as_dict_string_arrow(values)
        if darr is not None:
            ords = self._dict_ordinals(darr.dictionary)
            indices = darr.indices
            n_null = darr.null_count
            if n_null:
                indices = indices.fill_null(0)
            member = ords >= 0
            out = (member[np.asarray(indices)] if len(ords)
                   else np.zeros(len(darr), bool))
            if n_null:
                out[np.asarray(darr.is_null())] = self.has_null
            return out
        arrow = _as_string_arrow(values)
        if arrow is not None:
            out = _string_index_in(arrow, self.keys) >= 0
            if arrow.null_count:
                out = np.where(np.asarray(arrow.is_null()), self.has_null, out)
            return out
        data, mask = array_types.data_and_mask(values)
        if self.is_string:
            out = _string_index_in(data, self.keys) >= 0
        else:
            if self.n_keys:
                idx = np.clip(np.searchsorted(self.keys, data), 0, self.n_keys - 1)
                out = self.keys[idx] == data
            else:
                out = np.zeros(len(data), bool)
            if _is_float(data.dtype) and self.has_nan:
                out |= np.isnan(data)
        if mask is not None:
            out = np.where(mask, self.has_null, out)
        return out


def _string_index_in(data, keys):
    """Vectorized probe for string/object values: position of each value in
    ``keys`` (-1 when absent).  Replaces the per-row Python dict loop with
    pyarrow's hash kernel — the same engine the reference leans on for
    string compute (functions.py:28 _arrow_string_kernel_dispatch); its own
    probe is C++ (hash_string.cpp map_ordinal, hash_object.cpp for
    arbitrary PyObjects).  Non-string objects dictionary-encode through
    arrow's type inference (bytes -> binary, ints -> int64, ...) so they
    ride the same C++ hash path; only truly mixed/unorderable objects fall
    back to per-object dict hashing (C-level dict ops, no Python loop per
    comparison beyond the lookup itself)."""
    n = len(data)
    if n == 0 or len(keys) == 0:
        return np.full(n, -1, np.int64)
    try:
        import pyarrow as pa
        import pyarrow.compute as pc
    except ImportError:  # pragma: no cover
        pa = pc = None
    if pa is not None:
        keys_np = np.asarray(keys, dtype=object)
        for typ in (pa.large_utf8(), None):
            try:
                if isinstance(data, pa.Array):
                    arr = data
                elif typ is not None:
                    arr = pa.array(data, type=typ)
                else:
                    # generic inference: bytes/ints/floats/nested lists all
                    # dictionary-encode through arrow's own hash kernels
                    arr = pa.array(data.tolist() if isinstance(data, np.ndarray)
                                   else data, from_pandas=True)
                kset = pa.array(keys_np.tolist(), type=arr.type)
                idx = pc.index_in(arr, value_set=kset)
                return np.asarray(idx.fill_null(-1)).astype(np.int64)
            except (pa.lib.ArrowInvalid, pa.lib.ArrowTypeError,
                    pa.lib.ArrowNotImplementedError, ValueError, TypeError):
                continue
    # unorderable / mixed python objects: per-object dict hashing.  Arrow
    # arrays convert to python values first (pa scalars never hash-equal
    # the python key objects — iterating them directly would silently map
    # every row to -1)
    if pa is not None and isinstance(data, (pa.Array, pa.ChunkedArray)):
        data = data.to_pylist()
    lut = {k: i for i, k in enumerate(keys)}
    return np.asarray([lut.get(v, -1) for v in data], dtype=np.int64)


def _shrink_codes(codes, count):
    """Shrink ordinal dtype by set size (reference: hash_primitives.hpp:546-554)."""
    for dt in (np.int8, np.int16, np.int32):
        if count < np.iinfo(dt).max:
            return codes.astype(dt)
    return codes


# ---------------------------------------------------------------------------
# host-facing wrappers used by the expression functions


def host_map_ordinal(oset, values):
    if isinstance(oset, DeviceSetHandle):
        oset = oset.host_set
    return oset.map_ordinal(values)


def host_isin(oset, values):
    if isinstance(oset, DeviceSetHandle):
        oset = oset.host_set
    return oset.isin(values)


# ---------------------------------------------------------------------------
# device probes: run inside the traced pass.  The sorted key array enters the
# trace as a runtime input (never a baked-in constant), so two groupbys with
# equal set sizes share one compiled executable.


class DeviceSetHandle:
    """Trace-time view of a SortedSet: traced key array + static metadata."""

    def __init__(self, keys, n_keys, has_nan, has_null, host_set=None):
        self.keys = keys            # traced jnp array, sorted, len == n_keys (static)
        self.n_keys = n_keys
        self.has_nan = has_nan
        self.has_null = has_null
        self.host_set = host_set

    @property
    def nan_ordinal(self):
        return self.n_keys if self.has_nan else -1

    @property
    def null_ordinal(self):
        return self.n_keys + int(self.has_nan) if self.has_null else -1

    @property
    def count(self):
        return self.n_keys + int(self.has_nan) + int(self.has_null)


_SORT_PROBE_MIN_KEYS = 4096


def _sort_merge_ordinals(keys, data, n_keys):
    """Large-set probe without searchsorted: sort (value, key-first flag)
    over keys + data together; within each equal-value run a cummax
    propagates the run's key ordinal forward; a second single-key sort
    restores row order: two sorts + two scans in place of a per-row binary
    search.  Returns int32 ordinals (-1 unmatched)."""
    import jax
    N = data.shape[0]
    U = n_keys
    vals = jnp.concatenate([keys.astype(data.dtype), data])
    # secondary sort key: keys (flag 0) precede equal data values (flag 1);
    # low bits carry the ordinal (keys) / row id (data)
    tag = jnp.concatenate([
        jax.lax.broadcasted_iota(jnp.int32, (U, 1), 0).squeeze(-1),
        (jax.lax.broadcasted_iota(jnp.int32, (N, 1), 0).squeeze(-1)
         | jnp.int32(1 << 30))])
    sv, st = jax.lax.sort((vals, tag), num_keys=2)
    is_key = st < (1 << 30)
    total = U + N
    # equal-value runs: run id = prefix count of value changes
    change = jnp.concatenate([jnp.zeros(1, jnp.int32),
                              (sv[1:] != sv[:-1]).astype(jnp.int32)])
    run_id = jnp.cumsum(change)
    # the run's key ordinal propagates forward (keys sort first in a run);
    # pack (run_id, ordinal) so one cummax carries both
    packed = jnp.where(is_key,
                       run_id.astype(jnp.int64) << 31 | st.astype(jnp.int64),
                       jnp.int64(-1))
    carried = jax.lax.cummax(packed)
    ord_here = jnp.where(
        (carried >= 0) & ((carried >> 31) == run_id.astype(jnp.int64)),
        (carried & ((1 << 31) - 1)).astype(jnp.int32), jnp.int32(-1))
    # restore row order: single-key sort of (rowid, ordinal) for data rows
    rowkey = jnp.where(is_key, jnp.int32(N), st & jnp.int32((1 << 30) - 1))
    _, out = jax.lax.sort((rowkey, ord_here), num_keys=1)
    return out[:N]


def _device_probe(keys, data, n_keys):
    """sorted keys x data -> int32 ordinals (-1 unmatched); sort-merge for
    large sets, binary search for small ones."""
    if (n_keys > _SORT_PROBE_MIN_KEYS
            and jnp.issubdtype(data.dtype, jnp.integer)
            and data.shape[0] < (1 << 30)):  # row ids pack into 30 bits
        return _sort_merge_ordinals(keys, data, n_keys)
    idx = jnp.searchsorted(keys, data).astype(jnp.int32)
    idx = jnp.clip(idx, 0, n_keys - 1)
    found = keys[idx] == data
    return jnp.where(found, idx, jnp.int32(-1))


def device_map_ordinal(handle: DeviceSetHandle, x):
    """NA values -> int32 ordinals on device."""
    data = x.data
    if handle.n_keys:
        codes = _device_probe(handle.keys, data, handle.n_keys)
    else:
        codes = jnp.full(data.shape, -1, jnp.int32)
    if jnp.issubdtype(data.dtype, jnp.floating) and handle.has_nan:
        codes = jnp.where(jnp.isnan(data), jnp.int32(handle.nan_ordinal), codes)
    if x.mask is not None:
        codes = jnp.where(x.mask, jnp.int32(handle.null_ordinal), codes)
    return codes


def device_isin(handle: DeviceSetHandle, x):
    data = x.data
    if handle.n_keys:
        out = _device_probe(handle.keys, data, handle.n_keys) >= 0
    else:
        out = jnp.zeros(data.shape, bool)
    if jnp.issubdtype(data.dtype, jnp.floating):
        out = jnp.where(jnp.isnan(data), bool(handle.has_nan), out)
    if x.mask is not None:
        out = jnp.where(x.mask, bool(handle.has_null), out)
    return out


# ---------------------------------------------------------------------------
# SortedIndex: the join index (reference: hash_primitives.hpp:624-900
# index_hash).  keys sorted with their original row numbers; first match via
# searchsorted, duplicate matches via the [left, right) range per key.


class SortedIndex:
    def __init__(self, keys, mask=None, offset=0):
        data = np.asarray(keys)
        self.is_string = data.dtype.kind in "OUS"
        valid = np.ones(len(data), bool)
        if mask is not None:
            valid &= ~mask
        self.null_rows = np.flatnonzero(~valid) + offset
        vdata = data[valid]
        vrows = np.flatnonzero(valid) + offset
        if self.is_string:
            order = np.argsort(vdata.astype(str), kind="stable") if len(vdata) else np.empty(0, np.int64)
        else:
            order = np.argsort(vdata, kind="stable")
        self.sorted_keys = vdata[order]
        self.sorted_rows = vrows[order].astype(np.int64)
        self.has_duplicates = bool(len(self.sorted_keys) and
                                   (self.sorted_keys[1:] == self.sorted_keys[:-1]).any())
        # NaN keys never match anything (float != semantics)
        if not self.is_string and len(self.sorted_keys) and self.sorted_keys.dtype.kind == "f":
            n_nan = int(np.isnan(self.sorted_keys).sum())
            if n_nan:  # nans sort last
                self.sorted_keys = self.sorted_keys[:-n_nan]
                self.sorted_rows = self.sorted_rows[:-n_nan]
        # dense integer keys: O(1) probes via a value->row lookup table
        # (binary search is cache-miss bound: ~150ns/probe measured)
        self._lut = None
        self._lut_lo = 0
        n_keys = len(self.sorted_keys)
        if (not self.is_string and n_keys and self.sorted_keys.dtype.kind in "iu"):
            lo = int(self.sorted_keys[0])
            hi = int(self.sorted_keys[-1])
            span = hi - lo + 1
            if 0 < span <= max(4 * n_keys, 1 << 22):
                lut = np.full(span, -1, np.int64)
                # reversed fill => first occurrence wins for duplicate keys
                lut[(self.sorted_keys.astype(np.int64) - lo)[::-1]] = self.sorted_rows[::-1]
                self._lut = lut
                self._lut_lo = lo

    def map_index(self, values, mask=None):
        """First-match right-row per left value, -1 when unmatched."""
        data = np.asarray(values)
        n = len(self.sorted_keys)
        if n == 0:
            return np.full(len(data), -1, np.int64)
        if self._lut is not None and data.dtype.kind in "iu":
            rel = data.astype(np.int64) - self._lut_lo
            inb = (rel >= 0) & (rel < len(self._lut))
            out = np.full(len(data), -1, np.int64)
            out[inb] = self._lut[rel[inb]]
            if mask is not None:
                out[mask] = -1
            return out
        if not self.is_string and data.dtype == self.sorted_keys.dtype:
            from .. import hostkern
            native = hostkern.map_index(self.sorted_keys, self.sorted_rows, data)
            if native is not None:
                if mask is not None:
                    native = np.where(mask, -1, native)
                return native
        if self.is_string:
            skeys = self.sorted_keys.astype(str)
            idx = np.searchsorted(skeys, data.astype(str), side="left")
        else:
            idx = np.searchsorted(self.sorted_keys, data, side="left")
        idx = np.clip(idx, 0, n - 1)
        found = self.sorted_keys[idx] == data
        if not self.is_string and data.dtype.kind == "f":
            found &= ~np.isnan(data)
        out = np.where(found, self.sorted_rows[idx], -1)
        if mask is not None:
            out = np.where(mask, -1, out)
        return out

    def map_index_duplicates(self, values, left_offset=0, mask=None):
        """Extra matches beyond the first.

        Returns (left_indices, right_rows): for every left row whose key has k
        matches, k-1 extra pairs (reference: hash_primitives.hpp:756-848).
        """
        data = np.asarray(values)
        n = len(self.sorted_keys)
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        if self.is_string:
            skeys = self.sorted_keys.astype(str)
            sdata = data.astype(str)
            lo = np.searchsorted(skeys, sdata, side="left")
            hi = np.searchsorted(skeys, sdata, side="right")
        else:
            lo = np.searchsorted(self.sorted_keys, data, side="left")
            hi = np.searchsorted(self.sorted_keys, data, side="right")
        counts = hi - lo
        if mask is not None:
            counts = np.where(mask, 0, counts)
        extra = np.maximum(counts - 1, 0)
        total = int(extra.sum())
        if total == 0:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        left_idx = np.repeat(np.arange(len(data), dtype=np.int64), extra) + left_offset
        right_rows = np.empty(total, np.int64)
        pos = 0
        rows_with_dups = np.flatnonzero(extra)
        for i in rows_with_dups:
            k = extra[i]
            right_rows[pos:pos + k] = self.sorted_rows[lo[i] + 1:hi[i]]
            pos += k
        return left_idx, right_rows

"""Hash join — here a sort-merge-probe join.

Re-design of the reference's ``vaex/join.py`` (292 LoC).  Same plan shape:

* build an index on the right key (reference: per-thread C++ ``index_hash``
  maps merged, dataframe.py:482-539; here a :class:`SortedIndex` — sorted
  (key, row) pairs, the vector-friendly index),
* fill a ``lookup`` row-index array over the left rows via binary-search
  probes (reference join.py:186-207 map_index),
* duplicates on the right require ``allow_duplication`` and append duplicated
  left rows at the end (join.py:208-213),
* the result is lazy: ``left.dataset.merged(right.dataset.take(lookup,
  masked))`` — the right table is never materialized (join.py:277-291).

Row order contract: left order preserved; unmatched left rows get masked
values; ``how`` in {'left', 'right', 'inner'} with right = swapped left.
"""

from __future__ import annotations

import numpy as np

from . import array_types
from .array_types import required_dtype_for_max


def join(left, right, on=None, left_on=None, right_on=None, lprefix="", rprefix="",
         lsuffix="", rsuffix="", how="left", allow_duplication=False, inplace=False,
         mesh=None):
    if how == "right":
        return join(right, left, on=on, left_on=right_on, right_on=left_on,
                    lprefix=rprefix, rprefix=lprefix, lsuffix=rsuffix, rsuffix=lsuffix,
                    how="left", allow_duplication=allow_duplication, mesh=mesh)
    if how not in ("left", "inner"):
        raise ValueError(f"how={how!r} not supported (left/right/inner)")
    left_on = str(left_on or on)
    right_on = str(right_on or on)
    if left_on == "None" or right_on == "None":
        raise ValueError("specify on= or left_on=/right_on=")

    left = left.extract() if left.filtered else left.trim()
    right = right.extract() if right.filtered else right.trim()

    lookup = None
    if mesh is not None and mesh.size > 1:
        # distributed path: hash-partitioned build+probe over the mesh
        # (unique right keys; duplicate semantics fall back to the local index)
        lookup = _mesh_lookup(left, right, left_on, right_on, mesh,
                              allow_duplication)

    if lookup is None:
        # PASS over right: build the sorted index
        index = right._index(right_on)

        # PASS over left: probe
        left_values = left.evaluate(left_on, array_type="numpy")
        ldata, lmask = array_types.data_and_mask(left_values)
        lookup = index.map_index(ldata, mask=lmask)

        extra_left_rows = None
        if index.has_duplicates:
            if not allow_duplication:
                raise ValueError("joining with duplicate keys on the right requires "
                                 "allow_duplication=True")
            extra_left, extra_right = index.map_index_duplicates(ldata, mask=lmask)
            if len(extra_left):
                extra_left_rows = extra_left
                lookup = np.concatenate([lookup, extra_right])
    else:
        extra_left_rows = None

    if extra_left_rows is not None:
        left_ds = left.dataset.concat(left.dataset.take(extra_left_rows))
        left = left._rebind_dataset(left_ds)

    unmatched = lookup < 0
    masked_any = bool(unmatched.any())
    if how == "inner" and masked_any:
        keep = np.flatnonzero(~unmatched)
        left = left.take(keep)
        lookup = lookup[keep]
        masked_any = False

    lookup_dtype = required_dtype_for_max(max(int(lookup.max(initial=0)), 1))
    if masked_any:
        lookup_arr = np.ma.MaskedArray(np.where(unmatched, 0, lookup).astype(lookup_dtype), unmatched)
    else:
        lookup_arr = lookup.astype(lookup_dtype)

    # column-name collision mangling — only clashing names are renamed
    # (reference join.py:223-253)
    left_names = left.get_column_names(hidden=True)
    right_names = right.get_column_names(hidden=True)
    renaming = {}
    for name in right_names:
        if name not in left_names:
            continue
        if name == right_on and name == left_on:
            continue  # shared join key collapses to one column
        if not (lprefix or lsuffix or rprefix or rsuffix):
            raise NameError(f"column {name!r} exists in both; use l/r prefix/suffix")
        new_name = rprefix + name + rsuffix
        if new_name != name:
            renaming[name] = new_name

    right_df = right
    right_physical = [n for n in right_names if n not in right_df.virtual_columns]
    skip = set()
    if right_on == left_on and right_on in right_names and left_on in left_names:
        # the shared join key collapses to the left column (reference join.py)
        skip.add(right_on)

    right_ds = right.dataset.project(*[n for n in right_physical if n not in skip])
    if renaming:
        right_ds = right_ds.renamed({k: v for k, v in renaming.items() if k in right_ds})
    right_taken = right_ds.take(lookup_arr, masked=masked_any)

    result = left._rebind_dataset(left.dataset.merged(right_taken))
    # bring over right virtual columns (renamed)
    from . import expresso
    for name in right_names:
        if name in right_df.virtual_columns and name not in skip:
            expr = right_df.virtual_columns[name]
            expr = expresso.translate(expr, lambda n: renaming.get(n))
            result.virtual_columns[renaming.get(name, name)] = expr
    result.column_names = (left.column_names +
                           [renaming.get(n, n) for n in right_names if n not in skip
                            and not (renaming.get(n, n) in left.column_names)])
    for k, v in right_df.variables.items():
        result.variables.setdefault(k, v)
    return result


def _mesh_lookup(left, right, left_on, right_on, mesh, allow_duplication):
    """Distributed lookup via parallel.join; None -> caller uses the local
    index (string keys, masked keys, or duplicate rights needing the
    duplication semantics)."""
    try:
        from .datatype import DataType
        if not DataType(left.data_type(left_on)).numpy.kind in "iuf":
            return None
        if not DataType(right.data_type(right_on)).numpy.kind in "iuf":
            return None
    except Exception:
        return None
    left_values = left.evaluate(left_on, array_type="numpy")
    right_values = right.evaluate(right_on, array_type="numpy")
    if isinstance(left_values, np.ma.MaskedArray) or isinstance(right_values, np.ma.MaskedArray):
        return None
    from .parallel.join import shuffle_join_lookup
    lookup, overflow, dups = shuffle_join_lookup(mesh, left_values, right_values)
    if overflow:
        lookup, overflow, dups = shuffle_join_lookup(mesh, left_values, right_values,
                                                     slack=16)
        if overflow:
            return None  # extreme skew: local path
    if dups:
        if not allow_duplication:
            raise ValueError("joining with duplicate keys on the right requires "
                             "allow_duplication=True")
        return None  # duplication semantics ride the local index path
    return np.asarray(lookup)

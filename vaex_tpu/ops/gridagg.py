"""Grid aggregation primitives: scatter values into a flat grid per tile.

Replaces ``vaex-core/src/superagg.cpp`` (AggCount/AggSum/AggMin/AggMax/
AggFirst/AggSumMoment) and the legacy ``vaexfast.cpp statisticNd``.  Where the
C++ walks rows in 1024-element blocks per thread, here each aggregator is a
single vectorized scatter over the whole device tile, compiled into the pass's
XLA program:

* rows that must not contribute (padding, filter, selection, null/NaN value)
  get their index set to ``G`` (one past the grid) and are dropped by the
  scatter's ``mode='drop'`` — no sentinel pollution of min/max;
* small grids batch every additive aggregator of a pass into one
  :func:`small_g_sums` call; large grids ride the sort strategies below.

NaN semantics match the reference (superagg.cpp:168-191, 367-388): NaN and
null values are skipped by every aggregator.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _drop_invalid(idx, valid, G):
    return jnp.where(valid, idx, jnp.int32(G))


def value_valid(x, valid):
    """AND the row-valid mask with the value's own null/NaN validity."""
    if x.mask is not None:
        valid = valid & ~x.mask
    if jnp.issubdtype(x.data.dtype, jnp.floating):
        valid = valid & ~jnp.isnan(x.data)
    return valid


def grid_count(grid, idx, valid):
    """grid[G] int64 += 1 per valid row (AggCount, superagg.cpp:156)."""
    G = grid.shape[0]
    i = _drop_invalid(idx, valid, G)
    return grid.at[i].add(jnp.ones(idx.shape, grid.dtype), mode="drop")


def grid_sum(grid, idx, x, valid):
    """grid[G] (upcast dtype) += value (AggSum, superagg.cpp:350)."""
    G = grid.shape[0]
    valid = value_valid(x, valid)
    i = _drop_invalid(idx, valid, G)
    vals = jnp.where(valid, x.data, jnp.zeros((), x.data.dtype)).astype(grid.dtype)
    return grid.at[i].add(vals, mode="drop")


def grid_sum_moment(grid, idx, x, valid, moment):
    """grid[G] += value**moment (AggSumMoment, superagg.cpp:392) — for var/std."""
    G = grid.shape[0]
    valid = value_valid(x, valid)
    i = _drop_invalid(idx, valid, G)
    v = x.data.astype(grid.dtype)
    vals = jnp.where(valid, v ** moment, jnp.zeros((), grid.dtype))
    return grid.at[i].add(vals, mode="drop")


def grid_min(grid, idx, x, valid):
    """(AggMin, superagg.cpp:242) — empty cells keep the dtype-max fill."""
    G = grid.shape[0]
    valid = value_valid(x, valid)
    i = _drop_invalid(idx, valid, G)
    return grid.at[i].min(x.data.astype(grid.dtype), mode="drop")


def grid_max(grid, idx, x, valid):
    G = grid.shape[0]
    valid = value_valid(x, valid)
    i = _drop_invalid(idx, valid, G)
    return grid.at[i].max(x.data.astype(grid.dtype), mode="drop")


def grid_first(value_grid, order_grid, idx, x, order, valid, row_offset, row_ids):
    """Value at the minimal order expression (AggFirst, superagg.cpp:437-511).

    Two scatters: (1) scatter-min a lexicographic (order, global-row) key so
    ties resolve to the earliest row, (2) keep the value whose key won.
    ``order_grid`` is float64 and encodes the order; ``row_ids`` breaks ties.
    """
    G = value_grid.shape[0]
    valid = value_valid(x, valid)
    ovalid = valid
    if order.mask is not None:
        ovalid = ovalid & ~order.mask
    if jnp.issubdtype(order.data.dtype, jnp.floating):
        ovalid = ovalid & ~jnp.isnan(order.data)
    i = _drop_invalid(idx, ovalid, G)
    okeys = order.data.astype(order_grid.dtype)
    new_order_grid = order_grid.at[i].min(okeys, mode="drop")
    # rows whose order equals the winning order write their value; among ties
    # the scatter picks one row deterministically via min on row id.
    winner = okeys == new_order_grid[jnp.clip(i, 0, G - 1)]
    i2 = _drop_invalid(idx, ovalid & winner, G)
    new_value_grid = value_grid.at[i2].set(x.data.astype(value_grid.dtype), mode="drop")
    return new_value_grid, new_order_grid


# ---------------------------------------------------------------------------
# Small-grid additive strategy: every additive aggregator of a pass (count ->
# validity, sum -> masked values, moments -> masked powers) is summed in one
# call, so one pass over the rows feeds them all — like the reference's
# Grid::bin C++ block loop (agg.hpp:106-136).  Integer columns accumulate in
# int64 (exact, wrapping mod 2^64 like the reference's C++ accumulators),
# float columns in float64.
#
# A scatter-add into ONE [G, A] grid makes every row of a small grid update
# one of G addresses, and the atomics on those addresses serialize.  Rows
# scatter instead into P private grids by row residue, so neighbouring rows
# never share an address, and the copies are reduced after.  The copies cost
# a zero-fill and a reduce of P*G cells per column and tile, so P shrinks as
# G grows against the tile (:func:`scatter_copies`).

MAX_SCATTER_COPIES = 256
COPY_CELLS_PER_ROW = 1 / 8  # P*G cells kept within this share of a tile's rows
FUSED_BLOCK = 8192


def _pad_rows(a, n_pad):
    if n_pad == 0:
        return a
    pad_width = [(0, n_pad)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad_width)


def scatter_copies(n_rows, G):
    """Private grid copies for a tile of n_rows binned into G cells: the
    largest power of two P <= MAX_SCATTER_COPIES with P*G within
    COPY_CELLS_PER_ROW of the rows (1 when even one copy exceeds it)."""
    limit = int(n_rows * COPY_CELLS_PER_ROW) // max(G, 1)
    if limit < 2:
        return 1
    return min(MAX_SCATTER_COPIES, 1 << (limit.bit_length() - 1))


def small_g_sums(idx, int_cols, float_cols, G):
    """Per-bin sums keyed by idx [N] int32 in [0, G).

    int_cols [N, Ai] int64 and float_cols [N, Af] float64 (Ai or Af may be
    0) -> (int64 [G, Ai], float64 [G, Af]).  Rows that must not contribute
    carry zeros in every column."""
    P = scatter_copies(idx.shape[0], G)
    return (_private_segment_sum(idx, int_cols, G, P),
            _private_segment_sum(idx, float_cols, G, P))


def _private_segment_sum(idx, cols, G, P):
    import jax
    if cols.shape[1] == 0:
        return jnp.zeros((G, 0), cols.dtype)
    if P == 1:
        return jax.ops.segment_sum(cols, idx, num_segments=G)
    rows = jax.lax.broadcasted_iota(jnp.int32, idx.shape, 0)
    grids = jax.ops.segment_sum(cols, idx + G * (rows & (P - 1)), num_segments=P * G)
    return grids.reshape(P, G, cols.shape[1]).sum(axis=0)


def fused_extreme(idx, cols, G, mode, block=FUSED_BLOCK):
    """Per-bin min (or max) of cols [N, Am] keyed by idx [N] (idx == G drops).

    Returns [G, Am] in the cols dtype; empty cells keep the identity fill
    (dtype max/min, the reference's empty-bin convention superagg.cpp:199-250).
    """
    import jax
    N, Am = cols.shape
    block = min(block, max(256, 1 << (N - 1).bit_length()))
    nb = -(-N // block)
    n_pad = nb * block - N
    fill = min_identity(cols.dtype) if mode == "min" else max_identity(cols.dtype)
    idx_p = _pad_rows(idx, n_pad) if n_pad else idx
    if n_pad:
        idx_p = idx_p.at[N:].set(G)
    cols_p = _pad_rows(cols, n_pad)
    if n_pad:
        cols_p = cols_p.at[N:].set(jnp.asarray(fill, cols.dtype))
    idx_b = idx_p.reshape(nb, block)
    cols_b = cols_p.reshape(nb, block, Am)
    bins = jax.lax.broadcasted_iota(jnp.int32, (1, G), 1)
    reduce = jnp.min if mode == "min" else jnp.max
    combine = jnp.minimum if mode == "min" else jnp.maximum

    def body(carry, inp):
        ib, cb = inp
        onehot = ib[:, None] == bins  # block x G bool
        masked = jnp.where(onehot[:, :, None], cb[:, None, :], jnp.asarray(fill, cols.dtype))
        return combine(carry, reduce(masked, axis=0)), None

    init = jnp.full((G, Am), fill, cols.dtype)
    out, _ = jax.lax.scan(body, init, (idx_b, cols_b))
    return out


# ---------------------------------------------------------------------------
# Sort-based strategy for high-cardinality grids.  The device replacement
# for large hash tables: sort the bin indices once (rows with idx == G sort
# to the end and fall out), then every additive aggregate is a cumsum + two
# searchsorted gathers and min/max are sorted-segment reductions.
# O(N log N), no scatter.


def sort_rows(idx, G):
    """Shared per-tile sort: returns (order, sorted_idx)."""
    order = jnp.argsort(idx)
    return order, idx[order]


def sort_carry(idx, cols):
    """Sort rows by bin index, carrying cols [N, A] through the sort network.

    ``lax.sort`` with extra operands moves the values inside the sorting
    network itself instead of argsort + random-access gathers.  Returns
    (sorted_idx, sorted_cols [N, A]).
    """
    import jax
    A = cols.shape[1]
    operands = (idx,) + tuple(cols[:, a] for a in range(A))
    out = jax.lax.sort(operands, num_keys=1, is_stable=False)
    return out[0], jnp.stack(out[1:], axis=1)


def sorted_additive(sorted_idx, sorted_cols, G, precise=()):
    """sorted_cols [N, A] float64 (rows ordered by bin) -> [G, A] float64.

    Segment sums via cumsum differences: for ~1 magnitude values and N=1e7
    the cancellation error is ~eps * N / segment_size ~ 1e-11 relative.
    Columns in ``precise`` are summed per-segment with scatter-adds instead
    (error ~ eps * segment sum): variance moments cancel against mean^2 and
    would turn the std of a constant cell into sqrt(residue).
    """
    import jax
    N = sorted_idx.shape[0]
    csum = jnp.cumsum(sorted_cols, axis=0)
    bins = jnp.arange(G, dtype=sorted_idx.dtype)
    starts = jnp.searchsorted(sorted_idx, bins, side="left")
    ends = jnp.searchsorted(sorted_idx, bins, side="right")
    upper = csum[jnp.clip(ends - 1, 0, N - 1)]
    lower = jnp.where((starts > 0)[:, None], csum[jnp.clip(starts - 1, 0, N - 1)], 0.0)
    sums = jnp.where((ends > starts)[:, None], upper - lower, 0.0)
    if precise:
        seg = jnp.minimum(sorted_idx, G).astype(jnp.int32)
        pcols = jnp.stack([sorted_cols[:, a] for a in precise], axis=1)
        psums = jax.ops.segment_sum(pcols, seg, num_segments=G + 1,
                                    indices_are_sorted=True)[:G]
        sums = sums.at[:, jnp.asarray(list(precise))].set(psums)
    return sums


def sorted_extreme(sorted_idx, sorted_cols, G, mode):
    """Sorted-segment min/max via a segmented associative scan.

    Kept as the multi-column form (shared sort); prefer
    :func:`extreme_lex` when each column can afford its own sort — the
    lex sort is one fused pass with no scan.
    """
    import jax
    N = sorted_idx.shape[0]
    combine_val = jnp.minimum if mode == "min" else jnp.maximum
    fill = min_identity(sorted_cols.dtype) if mode == "min" else max_identity(sorted_cols.dtype)

    def combine(a, b):
        a_idx, a_val = a
        b_idx, b_val = b
        same = (b_idx == a_idx)[:, None]
        return b_idx, jnp.where(same, combine_val(a_val, b_val), b_val)

    _, scanned = jax.lax.associative_scan(combine, (sorted_idx, sorted_cols), axis=0)
    bins = jnp.arange(G, dtype=sorted_idx.dtype)
    ends = jnp.searchsorted(sorted_idx, bins, side="right")
    starts = jnp.searchsorted(sorted_idx, bins, side="left")
    vals = scanned[jnp.clip(ends - 1, 0, N - 1)]
    return jnp.where((ends > starts)[:, None], vals, jnp.asarray(fill, sorted_cols.dtype))


def _compact_starts(sorted_cell, G, want_starts):
    """Row index of each observed segment's first (or last) row, in cell
    order, via ONE i32 compaction sort instead of a G-probe searchsorted
    or an N-sized scatter: the flagged rows sort to the front already
    ordered by cell (rows are cell-sorted).  Returns int32 rows, entries
    >= N for absent cells."""
    import jax
    N = sorted_cell.shape[0]
    if want_starts:
        flag = jnp.concatenate([jnp.ones(1, bool),
                                sorted_cell[1:] != sorted_cell[:-1]])
    else:
        flag = jnp.concatenate([sorted_cell[1:] != sorted_cell[:-1],
                                jnp.ones(1, bool)])
    rows = jnp.arange(N, dtype=jnp.int32)
    packed = jnp.where(flag, rows, jnp.int32(N))
    return jax.lax.sort(packed)[:G]


def _sortable32(col):
    """Order-preserving map of a <=32-bit column into uint32-as-int64 low
    bits, plus the inverse map — or (None, None) when the dtype needs more
    than 32 bits (f64/i64/datetimes ride the 2-key lex variant)."""
    dt = np.dtype(col.dtype)
    if dt == np.float32:
        def fwd(v):
            import jax
            u = jax.lax.bitcast_convert_type(v, jnp.uint32)
            flip = jnp.where(u >> 31 != 0, jnp.uint32(0xFFFFFFFF),
                             jnp.uint32(0x80000000))
            return (u ^ flip).astype(jnp.int64)

        def inv(bits):
            import jax
            u = bits.astype(jnp.uint32)
            flip = jnp.where(u >> 31 != 0, jnp.uint32(0x80000000),
                             jnp.uint32(0xFFFFFFFF))
            return jax.lax.bitcast_convert_type(u ^ flip, jnp.float32)
        return fwd, inv
    if dt.kind == "i" and dt.itemsize <= 4:
        def fwd(v):
            return v.astype(jnp.int64) + (1 << 31)

        def inv(bits):
            return (bits - (1 << 31)).astype(dt)
        return fwd, inv
    if dt.kind in "ub" and dt.itemsize <= 4:
        def fwd(v):
            return v.astype(jnp.int64)

        def inv(bits):
            return bits.astype(dt)
        return fwd, inv
    return None, None


def extreme_packed(idx, col, G, mode):
    """Per-bin min/max via ONE packed single-key i64 sort.

    The cell index rides the high 32 bits, the order-mapped value the low
    32 (inverted for max so the winner is always the run's FIRST row); a
    compaction sort extracts run starts and a G-sized scatter builds the
    grid.  Extremes carry no exactness caveat here: the order map is a
    bijection.  Only for values that fit an order-preserving 32-bit map;
    callers fall back to :func:`extreme_lex2`."""
    import jax
    fwd, inv = _sortable32(col)
    assert fwd is not None
    N = idx.shape[0]
    fill = min_identity(col.dtype) if mode == "min" else max_identity(col.dtype)
    bits = fwd(col)
    if mode == "max":
        bits = 0xFFFFFFFF - bits
    key = (idx.astype(jnp.int64) << 32) | bits
    skey = jax.lax.sort(key)
    cell32 = (skey >> 32).astype(jnp.int32)
    starts = _compact_starts(cell32, G, want_starts=True)
    svals = skey[jnp.clip(starts, 0, N - 1)]
    cells = (svals >> 32).astype(jnp.int32)
    bits_out = svals & 0xFFFFFFFF
    if mode == "max":
        bits_out = 0xFFFFFFFF - bits_out
    vals = inv(bits_out)
    cells = jnp.where(starts < N, cells, jnp.int32(G))  # absent cells drop
    grid = jnp.full((G,), jnp.asarray(fill, col.dtype))
    return grid.at[cells].set(vals, mode="drop")


def extreme_lex2(idx, col, G, mode):
    """Per-bin min/max for wide values (f64/i64/datetimes): a 2-key lex
    sort carries the full value, compaction-sort boundary extraction
    instead of the G-probe searchsorted of :func:`extreme_lex`."""
    import jax
    N = idx.shape[0]
    fill = min_identity(col.dtype) if mode == "min" else max_identity(col.dtype)
    sorted_idx, sorted_col = jax.lax.sort((idx, col), num_keys=2,
                                          is_stable=False)
    pos = _compact_starts(sorted_idx, G, want_starts=(mode == "min"))
    vals = sorted_col[jnp.clip(pos, 0, N - 1)]
    cells = jnp.where(pos < N, sorted_idx[jnp.clip(pos, 0, N - 1)],
                      jnp.asarray(G, sorted_idx.dtype))
    cells = jnp.where(cells >= G, jnp.asarray(G, cells.dtype), cells)
    grid = jnp.full((G,), jnp.asarray(fill, col.dtype))
    return grid.at[cells.astype(jnp.int32)].set(vals, mode="drop")


def extreme_fast(idx, col, G, mode):
    """Route one extreme column to the packed single-key sort when the
    value order-maps into 32 bits, else the 2-key lex sort."""
    fwd, _ = _sortable32(col)
    if fwd is not None:
        return extreme_packed(idx, col, G, mode)
    return extreme_lex2(idx, col, G, mode)


def extreme_lex(idx, col, G, mode):
    """Per-bin min/max of ONE column via a single lexicographic sort.

    ``lax.sort((idx, col), num_keys=2)`` orders rows by (bin, value); the
    segment minimum then sits at each segment's first row and the maximum at
    its last — recovering them is a G-sized boundary gather, with no
    associative scan and no row-sized gathers.  Invalid rows must already
    carry the identity fill (callers use ``extreme_column``): +inf sorts to
    the segment end and never shadows a real minimum, -inf to the start.
    Rows with idx >= G sort past every real bin and fall off.
    """
    import jax
    N = idx.shape[0]
    fill = min_identity(col.dtype) if mode == "min" else max_identity(col.dtype)
    sorted_idx, sorted_col = jax.lax.sort((idx, col), num_keys=2, is_stable=False)
    bins = jnp.arange(G, dtype=idx.dtype)
    starts = jnp.searchsorted(sorted_idx, bins, side="left")
    ends = jnp.searchsorted(sorted_idx, bins, side="right")
    pos = starts if mode == "min" else ends - 1
    vals = sorted_col[jnp.clip(pos, 0, N - 1)]
    return jnp.where(ends > starts, vals, jnp.asarray(fill, col.dtype))


def interp_order_stats(sval, starts, nv, pct):
    """Exact percentile per segment of a (key, value)-sorted column.

    sval [N]: values sorted within each segment (NaNs mapped to +inf by the
    caller); starts [M] i32: each segment's first row; nv [M] f64: VALID
    (non-NaN) count per segment — ranks never reach the mapped inf tail.
    Linear interpolation between the bracketing order statistics
    (numpy/pandas semantics); equal brackets short-circuit so all-inf
    segments return inf, not inf + 0*(inf-inf) = NaN.  Shared by
    OpPercentileExact and the fused one-sort groupby (single + mesh)."""
    import jax.numpy as jnp
    N = sval.shape[0]
    p = jnp.clip(pct / 100.0 * (nv - 1), 0.0, jnp.maximum(nv - 1, 0.0))
    lo = jnp.floor(p)
    v_lo = sval[jnp.clip(starts + lo.astype(jnp.int32), 0, N - 1)]
    v_hi = sval[jnp.clip(starts + jnp.ceil(p).astype(jnp.int32), 0, N - 1)]
    value = jnp.where(v_lo == v_hi, v_lo, v_lo + (p - lo) * (v_hi - v_lo))
    return jnp.where(nv > 0, value, jnp.nan)


def min_identity(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return np.inf
    return np.iinfo(dtype).max


def max_identity(dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return -np.inf
    return np.iinfo(dtype).min


# ---------------------------------------------------------------------------
# Dense-rank sort strategy: set-based groupers guarantee that the grid's data
# bins are exactly the ranks of the observed key values, so ONE carried sort
# of the RAW key replaces both the ordinal probe (searchsorted of N keys in
# the set) and the per-bin boundary searchsorted of the generic sort path —
# boundaries come from neighbor-compare flags.  Invalid rows (padding, filter, selection) must
# arrive with key == dtype-max and identity values: they sort past every real
# segment and can never corrupt one.


def segment_ends(sorted_key, n_bins):
    """Row index of each of the first ``n_bins`` segment ends.

    Scatter formulation: each end-flagged row writes its row index at its
    segment rank (an i32 scatter instead of nonzero's sort-like
    compaction)."""
    import jax
    N = sorted_key.shape[0]
    end_flag = jnp.concatenate([sorted_key[1:] != sorted_key[:-1],
                                jnp.ones(1, bool)])
    # rank of each end among the ends = exclusive cumsum of flags
    rank = jnp.cumsum(end_flag.astype(jnp.int32)) - 1
    idx = jnp.where(end_flag, rank, jnp.int32(n_bins))
    rows = jnp.arange(N, dtype=jnp.int32)
    ends = jnp.full(n_bins, N - 1, jnp.int32).at[idx].set(rows, mode="drop")
    return ends


def prefix_at(scols, ends, block=1024):
    """Inclusive prefix sums of ``scols`` [N, A] sampled at row indices
    ``ends`` — via a TWO-LEVEL blocked cumsum instead of a full-length
    associative scan: the within-block cumsum is one short-axis scan and the
    block-total cumsum is tiny, so the compiled program stays small at
    N=1e7 and beyond."""
    import jax
    N, A = scols.shape
    nb = -(-N // block)
    pad = nb * block - N
    if pad:
        scols = jnp.concatenate([scols, jnp.zeros((pad, A), scols.dtype)])
    blocked = scols.reshape(nb, block, A)
    within = jnp.cumsum(blocked, axis=1)                     # [nb, block, A]
    totals = within[:, -1, :]                                # [nb, A]
    block_prefix = jnp.cumsum(totals, axis=0) - totals       # exclusive [nb, A]
    b = ends // block
    r = ends - b * block
    return block_prefix[b] + within[b, r]                    # [len(ends), A]


def dense_rank_additive(key, cols, n_bins, precise=()):
    """key [N] int (invalid rows = dtype max), cols [N, A] f64 (invalid rows
    = 0) -> ([n_bins, A] segment sums in key-rank order, ends [n_bins]).

    Segment compaction rides ONE stable sort on the end-flag carrying the
    per-channel inclusive cumsums (adjacent diffs of the compacted end rows
    are the segment sums) instead of a scatter + blocked-prefix + gather.
    Exactness matches the generic sort path: f64
    cumsum differences (exact for the <= 2^46 integer limb columns;
    ~eps*N/segment cancellation for floats).  Columns listed in ``precise``
    are summed per-segment via scatter-add instead (error ~ eps * segment
    sum, not eps * running total) — variance moments cancel against mean^2
    otherwise, turning the std of a constant group into sqrt(residue)."""
    import jax
    N, A = cols.shape
    out = jax.lax.sort((key,) + tuple(cols[:, a] for a in range(A)), num_keys=1)
    skey = out[0]
    scols = jnp.stack(out[1:], axis=1)                       # [N, A]
    end_flag = jnp.concatenate([skey[1:] != skey[:-1], jnp.ones(1, bool)])
    rows = jnp.arange(N, dtype=jnp.int32)
    csum = jnp.cumsum(scols, axis=0)
    comp = jax.lax.sort((1 - end_flag.astype(jnp.int32), rows)
                        + tuple(csum[:, a] for a in range(A)),
                        num_keys=1, is_stable=True)
    ends = comp[1][:n_bins]
    ce = jnp.stack(comp[2:], axis=1)[:n_bins]                # [n_bins, A]
    sums = jnp.diff(ce, axis=0, prepend=jnp.zeros((1, A), ce.dtype))
    if precise:
        seg = jnp.cumsum(jnp.concatenate(
            [jnp.zeros(1, jnp.int32),
             (skey[1:] != skey[:-1]).astype(jnp.int32)]))
        seg = jnp.minimum(seg, n_bins)  # invalid-key tail lands in a trash bin
        pcols = jnp.stack([scols[:, a] for a in precise], axis=1)
        psums = jax.ops.segment_sum(pcols, seg, num_segments=n_bins + 1,
                                    indices_are_sorted=True)[:n_bins]
        sums = sums.at[:, jnp.asarray(list(precise))].set(psums)
    return sums, ends


def dense_rank_extreme(key, col, n_bins, mode, ends=None):
    """Per-segment min/max via one (key, value) lex sort + boundary gather.

    Invalid rows must carry the identity fill (+inf for min / -inf for max):
    they sort to the harmless side of their segment."""
    import jax
    skey, scol = jax.lax.sort((key, col), num_keys=2)
    if ends is None:
        ends = segment_ends(skey, n_bins)
    if mode == "min":
        starts = jnp.concatenate([jnp.zeros(1, ends.dtype), ends[:-1] + 1])
        return scol[starts], ends
    return scol[ends], ends

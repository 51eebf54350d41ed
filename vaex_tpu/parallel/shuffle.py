"""Distributed shuffle aggregation: all-to-all over the mesh.

The north-star distributed design (SURVEY §2.3, BASELINE): tables are row-
sharded over the device mesh; for HIGH-cardinality groupby the replicated
grid + psum merge becomes wasteful (every device holds all G cells), so rows
are exchanged with an ``all_to_all`` across devices such that each device owns a
contiguous range of key ordinals, aggregates only its G/D sub-grid locally
(sort + segment reduce), and the result comes back sharded — no device ever
materializes the full grid.

Capacity contract: ``all_to_all`` needs equal splits, so each device packs
its rows into D buckets of ``cap`` rows; with hash-balanced ordinals
cap = slack * N_local / D suffices, and overflow is detected and reported
(rows dropped count returned) so callers can retry with more slack — the
skew-aware repartition of the reference plan (SURVEY §7.7).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


def shuffle_additive_grids(mesh, codes, cols, G, slack=4):
    """codes [N] int32 (rows with code >= G are dropped), cols [N, A] f64,
    rows sharded over the mesh's first axis -> ([G, A] f64, dropped_rows).

    Each device ends up owning ordinal range [d*gper, (d+1)*gper).
    """
    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    N = codes.shape[0]
    n_local = -(-N // D)
    gper = -(-G // D)
    cap = max(64, (slack * n_local) // D)

    def local(codes_l, cols_l):
        A = cols_l.shape[1]
        nl = codes_l.shape[0]
        owner = jnp.clip(codes_l // gper, 0, D - 1)
        valid = codes_l < G
        owner = jnp.where(valid, owner, D)  # D = trash bucket (not sent)

        # pack rows into [D, cap] send buffers: position within bucket via
        # a stable sort by owner + rank-within-owner (codes/cols carried
        # through the sort network — no row-sized gathers)
        sort_ops = (owner, codes_l.astype(jnp.int32)) + tuple(cols_l[:, a] for a in range(A))
        sorted_out = jax.lax.sort(sort_ops, num_keys=1, is_stable=True)
        sorted_owner = sorted_out[0]
        sorted_codes = sorted_out[1]
        sorted_cols = jnp.stack(sorted_out[2:], axis=1)
        # rank within each owner bucket
        idx = jax.lax.broadcasted_iota(jnp.int32, (nl, 1), 0).squeeze(-1)
        start_of_owner = jnp.searchsorted(sorted_owner, jnp.arange(D + 1, dtype=sorted_owner.dtype))
        rank = idx - start_of_owner[jnp.clip(sorted_owner, 0, D)]
        overflow = jnp.sum((rank >= cap) & (sorted_owner < D))

        send_codes = jnp.full((D, cap), G, jnp.int32)
        send_cols = jnp.zeros((D, cap, A), cols_l.dtype)
        dest = jnp.where((sorted_owner < D) & (rank < cap),
                         jnp.clip(sorted_owner, 0, D - 1) * cap + rank,
                         D * cap)
        send_codes = send_codes.reshape(-1).at[dest].set(sorted_codes.astype(jnp.int32),
                                                         mode="drop").reshape(D, cap)
        send_cols = send_cols.reshape(D * cap, A).at[dest].set(sorted_cols,
                                                               mode="drop").reshape(D, cap, A)

        # the exchange: all-to-all over the mesh axis
        recv_codes = jax.lax.all_to_all(send_codes, axis, 0, 0, tiled=False)
        recv_cols = jax.lax.all_to_all(send_cols, axis, 0, 0, tiled=False)
        my = jax.lax.axis_index(axis)
        local_codes = recv_codes.reshape(-1) - my * gper  # [D*cap]
        local_cols = recv_cols.reshape(-1, A)
        # rows outside my range (padding G-markers) fall out
        local_codes = jnp.where((local_codes >= 0) & (local_codes < gper),
                                local_codes, gper).astype(jnp.int32)
        from ..ops import gridagg
        sidx, scols = gridagg.sort_carry(local_codes, local_cols)
        grid = gridagg.sorted_additive(sidx, scols, gper)  # [gper, A]
        return grid, jax.lax.psum(overflow, axis)

    fn = jax.shard_map(local, mesh=mesh, in_specs=(P(axis), P(axis)),
                       out_specs=(P(axis), P()), check_vma=False)
    grids, dropped = jax.jit(fn)(codes, cols)
    return grids[:G], dropped


def shuffle_segment_grids(mesh, codes, add_cols, ext_cols, nu_cols, G, slack=4,
                          precise_add=()):
    """Widened shuffle: additive sums + min/max extremes + nunique counts in
    ONE all-to-all exchange (the reference routes every
    groupby shape through the same partitioned hashmaps,
    hash_primitives.hpp:96-281 — here every agg kind rides one exchange).

    codes [N] int32 (code >= G dropped), rows sharded over the mesh axis.
    add_cols [N, Aa] f64 -> per-group sums.
    ext_cols: list of (values [N] f64/int, mode 'min'|'max') -> per-group
      extremes (identity fill for empty groups, reference convention).
    nu_cols: list of (bits [N] int64, aux [N] int32) -> per-group distinct
      (bits) counts over rows with aux == 0 (callers set aux=1 for NaN rows
      and aux=2 for null rows and count their presence via additive
      channels — no reserved bit patterns needed for full-range ints).

    precise_add: indices of additive channels reduced via per-segment
      scatter-add (error ~ eps * segment sum) instead of cumsum differences
      (error ~ eps * running total) — variance moments cancel catastrophically
      otherwise (std of a singleton group must be 0, not sqrt(residue)).

    Returns (sums [G, Aa] f64, ext list of [G], nu list of [G] i64, dropped).
    """
    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    N = codes.shape[0]
    n_local = -(-N // D)
    gper = -(-G // D)
    cap = max(64, (slack * n_local) // D)
    Aa = add_cols.shape[1]
    from ..ops import gridagg

    def local(codes_l, add_l, *rest):
        ext_l = rest[:len(ext_cols)]
        nu_flat = rest[len(ext_cols):]
        nu_l = [(nu_flat[2 * i], nu_flat[2 * i + 1]) for i in range(len(nu_cols))]
        nl = codes_l.shape[0]
        owner = jnp.clip(codes_l // gper, 0, D - 1)
        valid = codes_l < G
        owner = jnp.where(valid, owner, D)  # D = trash bucket (not sent)

        # one stable sort by owner carries every channel into bucket order
        carry = ([add_l[:, a] for a in range(Aa)] + [e for e in ext_l]
                 + [x for pair in nu_l for x in pair])
        sorted_out = jax.lax.sort((owner, codes_l.astype(jnp.int32)) + tuple(carry),
                                  num_keys=1, is_stable=True)
        sorted_owner, sorted_codes = sorted_out[0], sorted_out[1]
        sorted_carry = sorted_out[2:]
        idx = jax.lax.broadcasted_iota(jnp.int32, (nl, 1), 0).squeeze(-1)
        start_of_owner = jnp.searchsorted(sorted_owner,
                                          jnp.arange(D + 1, dtype=sorted_owner.dtype))
        rank = idx - start_of_owner[jnp.clip(sorted_owner, 0, D)]
        overflow = jnp.sum((rank >= cap) & (sorted_owner < D))

        dest = jnp.where((sorted_owner < D) & (rank < cap),
                         jnp.clip(sorted_owner, 0, D - 1) * cap + rank,
                         D * cap)

        def pack(vals, fill):
            buf = jnp.full((D * cap,), fill, vals.dtype)
            return buf.at[dest].set(vals, mode="drop").reshape(D, cap)

        send_codes = pack(sorted_codes.astype(jnp.int32), jnp.int32(G))
        send_carry = []
        for c, col in enumerate(sorted_carry):
            if c >= Aa and c < Aa + len(ext_cols):
                mode = ext_cols[c - Aa][1]
                fill = (gridagg.min_identity(col.dtype) if mode == "min"
                        else gridagg.max_identity(col.dtype))
            else:
                fill = jnp.zeros((), col.dtype)
            send_carry.append(pack(col, fill))

        recv_codes = jax.lax.all_to_all(send_codes, axis, 0, 0, tiled=False)
        recv_carry = [jax.lax.all_to_all(b, axis, 0, 0, tiled=False)
                      for b in send_carry]
        my = jax.lax.axis_index(axis)
        local_codes = recv_codes.reshape(-1) - my * gper  # [D*cap]
        local_codes = jnp.where((local_codes >= 0) & (local_codes < gper),
                                local_codes, gper).astype(jnp.int32)
        flat_carry = [b.reshape(-1) for b in recv_carry]

        # one carried sort by local code orders every channel for the
        # segment reduces below
        out = jax.lax.sort((local_codes,) + tuple(flat_carry), num_keys=1,
                           is_stable=False)
        scode = out[0]
        s_add = jnp.stack(out[1:1 + Aa], axis=1) if Aa else None
        s_ext = out[1 + Aa:1 + Aa + len(ext_cols)]
        s_nu = out[1 + Aa + len(ext_cols):]

        sums = (gridagg.sorted_additive(scode, s_add, gper) if Aa
                else jnp.zeros((gper, 0), jnp.float64))
        if Aa and precise_add:
            pcols = jnp.stack([s_add[:, a] for a in precise_add], axis=1)
            psums = jax.ops.segment_sum(pcols, scode, num_segments=gper + 1,
                                        indices_are_sorted=True)[:gper]
            sums = sums.at[:, jnp.asarray(list(precise_add))].set(psums)
        exts = [gridagg.sorted_extreme(scode, col[:, None], gper, mode)[:, 0]
                for col, (_, mode) in zip(s_ext, ext_cols)]
        nus = []
        for i in range(len(nu_cols)):
            bits, aux = s_nu[2 * i], s_nu[2 * i + 1]
            # re-sort by (code, aux, bits): the first occurrence of each
            # distinct valid (aux==0) value within a segment marks a unique
            # member; NaN/null rows (aux 1/2) never count here — their
            # presence rides additive channels on the caller side
            c2, a2, v2 = jax.lax.sort((scode, aux, bits), num_keys=3,
                                      is_stable=False)
            first = jnp.concatenate([jnp.ones(1, bool),
                                     (c2[1:] != c2[:-1]) | (a2[1:] != a2[:-1])
                                     | (v2[1:] != v2[:-1])])
            first = first & (a2 == 0)
            cnt = gridagg.sorted_additive(c2, first.astype(jnp.float64)[:, None],
                                          gper)[:, 0]
            nus.append(cnt.astype(jnp.int64))
        return (sums, *exts, *nus, jax.lax.psum(overflow, axis))

    in_specs = (P(axis),) * (2 + len(ext_cols) + 2 * len(nu_cols))
    out_specs = (P(axis),) * (1 + len(ext_cols) + len(nu_cols)) + (P(),)
    fn = jax.shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                       check_vma=False)
    args = ([codes, add_cols] + [v for v, _ in ext_cols]
            + [x for pair in nu_cols for x in pair])
    out = jax.jit(fn)(*args)
    sums = out[0][:G]
    exts = [g[:G] for g in out[1:1 + len(ext_cols)]]
    nus = [g[:G] for g in out[1 + len(ext_cols):-1]]
    return sums, exts, nus, out[-1]


def shuffle_groupby(df, key_ordinal_expression, value_columns, G, mesh, slack=4,
                    max_retries=3):
    """High-level: evaluate ordinals + value columns, shuffle-aggregate.

    Returns {column: [G] numpy} of sums (count rides as a ones column).
    Skewed key distributions that overflow the per-bucket capacity retry
    with doubled slack (same policy as shuffle_join, parallel/join.py)."""
    from .mesh import shard_rows
    codes = np.asarray(df.evaluate(key_ordinal_expression, array_type="numpy"),
                       dtype=np.int32)
    cols = [np.ones(codes.shape[0], np.float64)]
    names = ["count"]
    for name in value_columns:
        cols.append(np.asarray(df.evaluate(str(name), array_type="numpy"), dtype=np.float64))
        names.append(str(name))
    # padding rows carry code G: dropped in the exchange
    codes = shard_rows(mesh, codes, G)
    stacked = shard_rows(mesh, np.stack(cols, axis=1))
    for attempt in range(max_retries + 1):
        grids, dropped = shuffle_additive_grids(mesh, codes, stacked, G, slack=slack)
        if not int(dropped):
            out = np.asarray(grids)
            return {name: out[:, i] for i, name in enumerate(names)}
        slack *= 2  # skew: double per-bucket capacity and re-shuffle
    raise RuntimeError(f"shuffle overflow after {max_retries} slack doublings: "
                       f"{int(dropped)} rows still dropped (pathological key skew)")

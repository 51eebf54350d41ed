"""Distributed hash join over the device mesh.

The reference's join is a single-node hashmap build + probe
(join.py:124-291, hash_primitives.hpp index_hash).  The device
distributed form (SURVEY §2.3.2/5): both sides are *hash-partitioned* across
the mesh with ``all_to_all`` so each device owns one key range,
builds a local sorted index of its right-side partition, probes its
left-side partition, and routes the matches back to the left rows' home
devices — no device ever holds the whole build side.

Public entry: :func:`shuffle_join_lookup` -> a global ``lookup`` row-index
array (first right match per left row, -1 unmatched), the same artifact the
single-node join materializes (join.py:177-207), so the lazy
``take + merged`` result construction is shared.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P


def _mix64(k):
    """murmur-style finalizer (reference hash.hpp:25-30 _hash64): balances
    partitioning for keys with structure in the low bits."""
    k = k.astype(jnp.uint64)
    k = k ^ (k >> jnp.uint64(33))
    k = k * jnp.uint64(0xFF51AFD7ED558CCD)
    k = k ^ (k >> jnp.uint64(33))
    k = k * jnp.uint64(0xC4CEB9FE1A85EC53)
    k = k ^ (k >> jnp.uint64(33))
    return k


def _key_bits(keys):
    """Order-irrelevant 64-bit view for hashing (floats bitcast)."""
    if jnp.issubdtype(keys.dtype, jnp.floating):
        bits = jax.lax.bitcast_convert_type(keys.astype(jnp.float64), jnp.uint64)
        return bits
    return keys.astype(jnp.int64)


def _pack(owner, cols, D, cap, fill_values):
    """Pack rows into [D, cap] per-owner send buffers.

    owner: [n] int32 in [0, D] (D = drop). cols: list of [n] arrays.
    Returns (send buffers list [D, cap], dest [n] flat position or D*cap for
    dropped/overflow, overflow count)."""
    n = owner.shape[0]
    sort_ops = (owner, jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1))
    sorted_owner, sorted_src = jax.lax.sort(sort_ops, num_keys=1, is_stable=True)
    pos = jax.lax.broadcasted_iota(jnp.int32, (n, 1), 0).squeeze(-1)
    start_of_owner = jnp.searchsorted(sorted_owner, jnp.arange(D + 1, dtype=sorted_owner.dtype))
    rank = pos - start_of_owner[jnp.clip(sorted_owner, 0, D)]
    overflow = jnp.sum((rank >= cap) & (sorted_owner < D))
    slot = jnp.where((sorted_owner < D) & (rank < cap),
                     jnp.clip(sorted_owner, 0, D - 1) * cap + rank,
                     D * cap)
    # dest[src_row] = flat slot (scatter the sorted slots back to row order)
    dest = jnp.full((n,), D * cap, jnp.int32)
    dest = dest.at[sorted_src].set(slot.astype(jnp.int32))
    sends = []
    for col, fv in zip(cols, fill_values):
        buf = jnp.full((D * cap,), fv, col.dtype)
        buf = buf.at[dest].set(col, mode="drop")
        sends.append(buf.reshape(D, cap))
    return sends, dest, overflow


def shuffle_join_lookup(mesh, left_keys, right_keys, slack=4):
    """First-match right row index per left row, hash-partitioned over the
    mesh.  left_keys [Nl], right_keys [Nr] (numeric; NaN never matches).
    Returns (lookup [Nl] int64 global right rows or -1, overflow count)."""
    from .mesh import shard_rows
    axis = mesh.axis_names[0]
    D = mesh.shape[axis]
    Nl, Nr = left_keys.shape[0], right_keys.shape[0]
    lk = shard_rows(mesh, left_keys)
    rk = shard_rows(mesh, right_keys)
    nl, nr = lk.shape[0] // D, rk.shape[0] // D  # rows per shard
    capL = max(64, (slack * nl) // D)
    capR = max(64, (slack * nr) // D)

    def local(lk_l, rk_l):
        # global row numbers of this shard; rows past N are padding
        d = jax.lax.axis_index(axis).astype(jnp.int64)
        lrow_l = d * nl + jnp.arange(nl, dtype=jnp.int64)
        rrow_l = d * nr + jnp.arange(nr, dtype=jnp.int64)
        lval_l, rval_l = lrow_l < Nl, rrow_l < Nr
        if jnp.issubdtype(lk_l.dtype, jnp.floating):
            lval_l = lval_l & ~jnp.isnan(lk_l)
            rval_l = rval_l & ~jnp.isnan(rk_l)
        # ---- partition the right side and build the local sorted index
        r_owner = jnp.where(rval_l, (_mix64(_key_bits(rk_l)) % jnp.uint64(D)).astype(jnp.int32),
                            jnp.int32(D))
        # empty right slots carry row = +huge so genuine rows sharing the
        # fill key still sort first and match
        huge = jnp.int64(1) << jnp.int64(62)
        (r_keys_s, r_rows_s), _, r_over = _pack(
            r_owner, [rk_l, rrow_l], D, capR,
            [_fill_max(rk_l.dtype), huge])
        rk_part = jax.lax.all_to_all(r_keys_s, axis, 0, 0).reshape(-1)
        rrow_part = jax.lax.all_to_all(r_rows_s, axis, 0, 0).reshape(-1)
        # sort (key, row): lowest right row first within a key (the
        # reference's first-inserted-wins, hash_primitives.hpp:679)
        sk, sr = jax.lax.sort((rk_part, rrow_part), num_keys=2, is_stable=False)
        # duplicate right keys land on one device (hash partitioning), so a
        # local adjacent-equal scan detects them globally
        real = sr < huge
        dups = jnp.sum((sk[1:] == sk[:-1]) & real[1:] & real[:-1])

        # ---- partition the left side and probe
        l_owner = jnp.where(lval_l, (_mix64(_key_bits(lk_l)) % jnp.uint64(D)).astype(jnp.int32),
                            jnp.int32(D))
        (l_keys_s,), l_dest, l_over = _pack(
            l_owner, [lk_l], D, capL, [_fill_max(lk_l.dtype)])
        lk_part = jax.lax.all_to_all(l_keys_s, axis, 0, 0).reshape(-1)
        n_idx = sk.shape[0]
        pos = jnp.clip(jnp.searchsorted(sk, lk_part), 0, n_idx - 1)
        hit = (sk[pos] == lk_part) & (sr[pos] < huge)
        match = jnp.where(hit, sr[pos], jnp.int64(-1))  # [D * capL]
        # ---- route matches back to the left rows' home devices
        back = jax.lax.all_to_all(match.reshape(D, capL), axis, 0, 0).reshape(-1)
        flat = jnp.concatenate([back, jnp.full((1,), -1, jnp.int64)])
        out = flat[jnp.clip(l_dest, 0, D * capL)]
        out = jnp.where(lval_l, out, jnp.int64(-1))
        return out, jax.lax.psum(l_over + r_over, axis), jax.lax.psum(dups, axis)

    fn = jax.shard_map(local, mesh=mesh,
                       in_specs=(P(axis), P(axis)),
                       out_specs=(P(axis), P(), P()), check_vma=False)
    lookup, overflow, dups = jax.jit(fn)(lk, rk)
    return lookup[:Nl], int(overflow), int(dups)


def _fill_max(dtype):
    d = np.dtype(dtype)
    if d.kind == "f":
        return np.inf
    return np.iinfo(d).max


def shuffle_join(left_df, right_df, left_on, right_on, mesh, slack=4, max_retries=3):
    """(lookup array, has_duplicates) via the mesh, with skew retries (more
    slack) on overflow — the skew-aware repartition of the plan (SURVEY §7.7)."""
    lk = np.asarray(left_df.evaluate(str(left_on), array_type="numpy"))
    rk = np.asarray(right_df.evaluate(str(right_on), array_type="numpy"))
    for attempt in range(max_retries):
        lookup, overflow, dups = shuffle_join_lookup(mesh, lk, rk,
                                                     slack=slack * (2 ** attempt))
        if overflow == 0:
            return np.asarray(lookup), dups > 0
    raise RuntimeError(f"shuffle join overflow after {max_retries} retries "
                       f"(extreme key skew); use the single-node join")

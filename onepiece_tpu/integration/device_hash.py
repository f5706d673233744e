"""Device-resident voxel-block hash table (allocation without host syncs).

The reference allocates TSDF blocks through a host-side
`unordered_map<CubeID, VoxelCube>` (ref: src/Integration/CubeHandler.h:22,
CubeHandler.cpp:147-196 `PrepareCubes`). Round 1 kept that split — device
computes touched keys, host uniquifies and assigns pool slots — but every
frame then pays one blocking device->host key transfer, which caps the
whole pipeline no matter how fast the kernels are.

This module moves the hash table itself onto the device: open addressing
with linear probing over a power-of-2 table of packed 30-bit block keys.
Insertion of a frame's (unique) touched keys is a fixed number of probe
rounds; claim conflicts between different keys hashing to the same cell are
resolved with a scatter-min (deterministic winner) + re-gather. The SLAM
loop then never reads anything back from the device: allocation, frustum
masking, and integration all happen inside one jitted per-frame program,
and the host recovers {coord -> slot} once at the end for meshing.

Keys pack (coord + 512) into 10 bits per axis (world extent ±512 blocks =
±51 m at the default 0.1 m block edge) — same packing as
`ops.tsdf.touched_block_keys`. EMPTY cells hold INVALID_KEY (2^30), which
is larger than any packed key, so scatter-min claims are total-ordered.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.tsdf import INVALID_KEY


class BlockHashTable(NamedTuple):
    """Device state of the block allocator (a pytree; donate across frames)."""

    table_keys: jax.Array  # (S,) int32, INVALID_KEY = empty
    table_slots: jax.Array  # (S,) int32, pool slot for the key at this cell
    block_coords: jax.Array  # (B, 3) int32 coords by pool slot
    num_active: jax.Array  # () int32
    overflow: jax.Array  # () int32 — keys dropped (table/probe exhaustion)


def make_table(table_size: int, capacity: int) -> BlockHashTable:
    assert table_size & (table_size - 1) == 0, "table_size must be a power of 2"
    return BlockHashTable(
        table_keys=jnp.full((table_size,), INVALID_KEY, jnp.int32),
        table_slots=jnp.zeros((table_size,), jnp.int32),
        block_coords=jnp.zeros((capacity, 3), jnp.int32),
        num_active=jnp.int32(0),
        overflow=jnp.int32(0),
    )


def _hash_keys(keys: jax.Array, mask: int) -> jax.Array:
    """Fibonacci-ish multiplicative hash of packed keys onto the table."""
    h = keys.astype(jnp.uint32) * jnp.uint32(2654435761)
    h = h ^ (h >> 15)
    return (h & jnp.uint32(mask)).astype(jnp.int32)


def unpack_keys(keys: jax.Array) -> jax.Array:
    """Packed 30-bit keys -> (N, 3) int32 block coords (device version)."""
    x = (keys >> 20) & 1023
    y = (keys >> 10) & 1023
    z = keys & 1023
    return jnp.stack([x, y, z], axis=-1) - 512


def insert(
    table: BlockHashTable,
    keys: jax.Array,
    max_probes: int = 16,
    claim_rounds: int = 6,
) -> tuple[BlockHashTable, jax.Array]:
    """Insert unique packed keys; allocate pool slots for unseen ones.

    keys: (K,) int32, unique, INVALID_KEY-padded. Returns (new_table,
    slots (K,) int32) where slots[i] is the pool slot of keys[i]
    (-1 for padding / dropped keys). Pool-capacity overflow drops keys and
    counts them in `table.overflow` (callers can grow + retry offline).

    Two phases, so that the steady state issues no scatter rounds at all:

      1. LOOKUP, fully vectorised: gather the table at all `max_probes`
         probe positions of every key at once (one (K, P) gather), take each
         key's first hit. In steady state almost every touched block already
         exists, so this one cheap phase resolves ~everything.
      2. CLAIM, `claim_rounds` scatter rounds for the unresolved (new) keys.
         Each round re-gathers the key's whole probe window (one (K, P)
         gather — cheap) and targets its first CURRENTLY-empty cell, so a
         key never wastes a round walking cells other keys just filled;
         scatter-min resolves same-cell races deterministically and losers
         re-target next round. Keys still unresolved after the rounds
         (requires `claim_rounds` consecutive same-cell losses) are dropped
         and counted in `overflow`; they retry on later frames.
    """
    tk, ts, bc, na, ov = table
    size = tk.shape[0]
    cap = bc.shape[0]
    k = keys.shape[0]
    valid = keys != INVALID_KEY
    base = _hash_keys(keys, size - 1)

    # --- phase 1: vectorised multi-probe lookup ---------------------------
    probe_ids = jnp.arange(max_probes, dtype=jnp.int32)
    pos_all = (base[:, None] + probe_ids[None, :]) & (size - 1)  # (K, P)
    cur_all = tk[pos_all]  # one gather
    hit = cur_all == keys[:, None]
    any_hit = jnp.any(hit, axis=1)
    hit_j = jnp.argmax(hit, axis=1)
    hit_pos = jnp.take_along_axis(pos_all, hit_j[:, None], axis=1)[:, 0]
    slots = jnp.where(valid & any_hit, ts[hit_pos], -1)
    pending = valid & ~any_hit

    # --- phase 2: claim rounds for new keys -------------------------------
    def round_body(_, state):
        tk, ts, bc, na, pending, slots = state
        cur_all = tk[pos_all]  # re-gather the window: cells fill as we go
        empty_now = cur_all == INVALID_KEY
        has_empty = jnp.any(empty_now, axis=1)
        j = jnp.argmax(empty_now, axis=1)
        pos = jnp.take_along_axis(pos_all, j[:, None], axis=1)[:, 0]
        attempt = pending & has_empty
        claim_pos = jnp.where(attempt, pos, size)  # size = drop
        tk = tk.at[claim_pos].min(keys, mode="drop")
        claimed = attempt & (tk[pos] == keys)
        rank = jnp.cumsum(claimed.astype(jnp.int32)) - 1
        new_slot = na + rank
        fits = claimed & (new_slot < cap)
        # a claim that no longer fits the pool keeps its table cell (another
        # key may probe past it) but records slot -1; counted as overflow
        slot_write = jnp.where(fits, new_slot, -1)
        ts = ts.at[jnp.where(claimed, pos, size)].set(slot_write, mode="drop")
        bc = bc.at[jnp.where(fits, new_slot, cap)].set(
            unpack_keys(keys), mode="drop"
        )
        na = na + jnp.sum(fits.astype(jnp.int32))
        slots = jnp.where(claimed, ts[pos], slots)
        pending = pending & ~claimed
        return tk, ts, bc, na, pending, slots

    # steady state resolves everything in the lookup phase; skip the claim
    # scatters entirely then (the cond keeps ~4 scatters per round out of
    # every steady-state frame)
    tk, ts, bc, na, pending, slots = jax.lax.cond(
        jnp.any(pending),
        lambda args: jax.lax.fori_loop(0, claim_rounds, round_body, args),
        lambda args: args,
        (tk, ts, bc, na, pending, slots),
    )
    dropped = jnp.sum((valid & (slots < 0)).astype(jnp.int32))
    return BlockHashTable(tk, ts, bc, na, ov + dropped), slots


def insert_at(
    table: BlockHashTable,
    keys: jax.Array,
    slots: jax.Array,
    max_probes: int = 16,
    claim_rounds: int = 12,
) -> BlockHashTable:
    """Insert unique keys with EXPLICIT pool slots (rebuild after migration).

    Unlike `insert`, slots are caller-assigned (e.g. `dest_device *
    cap_local + local_index` after an all_to_all re-shard), so they need
    not be contiguous. keys are unique or INVALID_KEY; slots[i] is keys[i]'s
    slot (ignored for invalid keys). block_coords rows are written at the
    given slots; num_active counts the valid keys.
    """
    tk, ts, bc, _, ov = table
    size = tk.shape[0]
    cap = bc.shape[0]
    valid = keys != INVALID_KEY
    base = _hash_keys(keys, size - 1)
    probe_ids = jnp.arange(max_probes, dtype=jnp.int32)
    pos_all = (base[:, None] + probe_ids[None, :]) & (size - 1)

    def round_body(_, state):
        tk, ts, pending = state
        cur_all = tk[pos_all]
        empty_now = cur_all == INVALID_KEY
        has_empty = jnp.any(empty_now, axis=1)
        j = jnp.argmax(empty_now, axis=1)
        pos = jnp.take_along_axis(pos_all, j[:, None], axis=1)[:, 0]
        attempt = pending & has_empty
        claim_pos = jnp.where(attempt, pos, size)
        tk = tk.at[claim_pos].min(keys, mode="drop")
        claimed = attempt & (tk[pos] == keys)
        ts = ts.at[jnp.where(claimed, pos, size)].set(slots, mode="drop")
        pending = pending & ~claimed
        return tk, ts, pending

    tk, ts, pending = jax.lax.fori_loop(
        0, claim_rounds, round_body, (tk, ts, valid)
    )
    # only keys that actually won a table cell are reachable: count and
    # write coords for those alone, so num_active/occupancy always agrees
    # with what lookup() can find (dropped keys go to overflow instead)
    claimed_ok = valid & ~pending
    bc = bc.at[jnp.where(claimed_ok, slots, cap)].set(
        unpack_keys(keys), mode="drop"
    )
    na = jnp.sum(claimed_ok.astype(jnp.int32))
    dropped = jnp.sum(pending.astype(jnp.int32))
    return BlockHashTable(tk, ts, bc, na, ov + dropped)


@functools.partial(jax.jit, static_argnames=())
def lookup(table: BlockHashTable, keys: jax.Array, max_probes: int = 16) -> jax.Array:
    """Pool slots for packed keys, -1 if absent. (K,) int32 -> (K,) int32."""
    tk, ts, _, _, _ = table
    size = tk.shape[0]
    pos = _hash_keys(keys, size - 1)
    valid = keys != INVALID_KEY

    def body(_, state):
        pos, pending, slots = state
        cur = tk[pos]
        hit = pending & (cur == keys)
        slots = jnp.where(hit, ts[pos], slots)
        pending = pending & ~hit & (cur != INVALID_KEY)
        return (pos + 1) & (size - 1), pending, slots

    _, _, slots = jax.lax.fori_loop(
        0, max_probes, body, (pos, valid, jnp.full(keys.shape, -1, jnp.int32))
    )
    return slots

"""Counter-free, lane-parallel PCG random number generator.

Array replacement for the reference's per-thread cuRAND state
(reference: implementation/src/Rng.h:14-57 and the hash-based seeding in
implementation/src/Utilities.cuh:157-178).  Each ray/lane carries a tiny
(state, inc) uint32 pair; draws are pure functions threading the state, so
the whole wavefront advances its RNGs in lockstep with a handful
of integer ops per draw — far cheaper than threefry key splitting inside the
tracking loop, and deterministic/shard-invariant because streams are seeded
purely from (seed, path_id).

Generator: PCG-RXS-M-XS-32 with per-lane odd stream increments.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

# NOTE: no module-level jnp array creation — it would initialize the JAX
# backend at import time, before the CLI can select a platform (and a
# GPU process reserves most of the card's memory on first use).
_U32 = jnp.uint32
_MULT = 747796405  # python int: weakly-typed, stays uint32 in arithmetic


class RngState(NamedTuple):
    """Per-lane RNG state; both fields share the lane batch shape."""

    state: jnp.ndarray  # uint32
    inc: jnp.ndarray  # uint32, always odd (stream selector)


def hash32(x: jnp.ndarray) -> jnp.ndarray:
    """Low-bias 32-bit integer hash (triple32-style avalanche)."""
    x = jnp.asarray(x).astype(jnp.uint32)
    x = x ^ (x >> 16)
    x = x * _U32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * _U32(0x846CA68B)
    x = x ^ (x >> 16)
    return x


def make_rng(seed, path_id) -> RngState:
    """Create independent per-lane streams from (seed, path_id).

    Functional analog of the reference's ``makeSeededRng``
    (reference: implementation/src/Utilities.cuh:173-178): the stream depends
    only on logical path identity, never on which shard/lane executes it.
    """
    seed = jnp.asarray(seed).astype(jnp.uint32)
    pid = jnp.asarray(path_id).astype(jnp.uint32)
    state = hash32(pid ^ (seed * _U32(0x9E3779B9)))
    inc = (hash32(pid + _U32(0x632BE5AB)) << 1) | _U32(1)
    return RngState(state=state, inc=inc)


def _advance(rng: RngState) -> Tuple[jnp.ndarray, RngState]:
    """One PCG step; returns 32 output bits and the new state."""
    new_state = rng.state * _MULT + rng.inc
    s = new_state
    word = ((s >> ((s >> 28) + _U32(4))) ^ s) * _U32(277803737)
    out = (word >> 22) ^ word
    return out, RngState(state=new_state, inc=rng.inc)


def next_uint32(rng: RngState, active=None) -> Tuple[jnp.ndarray, RngState]:
    """Draw 32 random bits per lane.

    If ``active`` is given, inactive lanes do not consume a draw (their state
    is left untouched) so per-lane draw sequences match a sequential
    execution regardless of batching.
    """
    out, new_rng = _advance(rng)
    if active is not None:
        new_rng = RngState(
            state=jnp.where(active, new_rng.state, rng.state), inc=rng.inc
        )
    return out, new_rng


def next_float(rng: RngState, active=None) -> Tuple[jnp.ndarray, RngState]:
    """Uniform float32 in [0, 1) with 24 bits of mantissa entropy."""
    bits, rng = next_uint32(rng, active)
    u = (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))
    return u, rng


def next_float2(rng: RngState, active=None):
    """Two sequential uniforms (matches Rng::getFloat2 draw order)."""
    u1, rng = next_float(rng, active)
    u2, rng = next_float(rng, active)
    return u1, u2, rng

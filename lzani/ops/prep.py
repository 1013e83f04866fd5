"""Vectorized buffer / k-mer / index preparation for the device engine.

Builds, entirely with array ops (no per-symbol host loops):
  * the composite reference buffer  fwd | N^mrd | N^mrd | rc | N^mrd
    (reference: parser.cpp:16-24)
  * k-mer streams: value of the k-mer starting at each position, -1 when the
    window touches an N code (parser.cpp:53-103)
  * the seed bucket table (counting sort; parser.cpp:106-143)

The anchor hash table insertion is order-dependent (linear probing,
parser.cpp:146-189): ``build_anchor_table`` does it as a sequential device
loop, one iteration per reference position. The engine builds the table on
the host instead (``native_engine.anchor_table``, the oracle's own code,
about a thousand times faster on an H100 host; PERF.md); this loop is kept
as the plain reference that build is tested against.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

SYM_N_REF = 4
SYM_N_SEQ = 5


def pow2_floor(x: int) -> int:
    while x & (x - 1):
        x &= x - 1
    return x


def pow2_ceil(x: int) -> int:
    b = 1
    while b < x:
        b *= 2
    return b


def ref_buffer_np(codes: np.ndarray, mrd: int, pad_to: int | None = None) -> np.ndarray:
    """Host-side composite reference buffer (cheap O(L); numpy)."""
    fwd = np.where(codes == SYM_N_SEQ, SYM_N_REF, codes).astype(np.uint8)
    rc = fwd[::-1].copy()
    acgt = rc < SYM_N_REF
    rc[acgt] = 3 - rc[acgt]
    gap = np.full(2 * mrd, SYM_N_REF, np.uint8)
    tail = np.full(mrd, SYM_N_REF, np.uint8)
    buf = np.concatenate([fwd, gap, rc, tail])
    if pad_to is not None:
        assert pad_to >= len(buf)
        buf = np.concatenate([buf, np.full(pad_to - len(buf), SYM_N_REF, np.uint8)])
    return buf


def query_buffer_np(codes: np.ndarray, mrd: int, pad_to: int | None = None) -> np.ndarray:
    """Host-side query buffer: codes + mrd query-Ns (parser.cpp:37-50)."""
    q = np.where(codes == SYM_N_REF, SYM_N_SEQ, codes).astype(np.uint8)
    buf = np.concatenate([q, np.full(mrd, SYM_N_SEQ, np.uint8)])
    if pad_to is not None:
        assert pad_to >= len(buf)
        buf = np.concatenate([buf, np.full(pad_to - len(buf), SYM_N_SEQ, np.uint8)])
    return buf


@partial(jax.jit, static_argnums=(1,))
def kmer_stream(buf: jax.Array, k: int) -> jax.Array:
    """int64[L] k-mer values; -1 where the window contains any N code.

    Padding symbols are N codes, so windows beyond the true length are
    invalid automatically.
    """
    L = buf.shape[0]
    b = buf.astype(jnp.int64)
    val = jnp.zeros(L, jnp.int64)
    ok = jnp.ones(L, jnp.bool_)
    for j in range(k):
        shifted = jnp.roll(b, -j)  # position p sees buf[p+j]
        val = (val << 2) | shifted
        ok &= shifted < SYM_N_REF
    # windows running off the end wrap via roll -> mark invalid
    idx = jnp.arange(L)
    ok &= idx <= L - k
    return jnp.where(ok, val, jnp.int64(-1))


@partial(jax.jit, static_argnums=(1,))
def build_anchor_table(anchors: jax.Array, table_size: int, n_true: jax.Array):
    """Linear-probe hash table of anchor k-mer positions.

    table_size is the static allocation (for the padding bucket); the live
    region is ``2 * pow2_floor(int(n_true / 0.1))`` entries, controlled by the
    traced mask. Insertion walks positions ascending, exactly like the
    reference, so probe-order tie-breaks agree bit-for-bit.
    """
    x = (n_true.astype(jnp.float64) / 0.1).astype(jnp.uint32)

    def clear_bit(v):
        return v & (v - 1)

    x = jax.lax.while_loop(lambda v: (v & (v - 1)) > 0, clear_bit, x)
    mask = (2 * x - 1).astype(jnp.uint64)

    tab = jnp.full(table_size, -1, jnp.int32)

    def insert(p, tab):
        km = anchors[p]

        def do(tab):
            h0 = mix64(km.astype(jnp.uint64)) & mask

            def probe(h):
                return (h + 1) & mask

            h = jax.lax.while_loop(lambda h: tab[h.astype(jnp.int32)] != -1,
                                   probe, h0)
            return tab.at[h.astype(jnp.int32)].set(p.astype(jnp.int32))

        return jax.lax.cond(km >= 0, do, lambda t: t, tab)

    tab = jax.lax.fori_loop(0, anchors.shape[0], insert, tab)
    return tab, mask


def mix64(x: jax.Array) -> jax.Array:
    """MurmurHash3 finalizer (parser.h:98-107)."""
    x = x.astype(jnp.uint64)
    x ^= x >> 33
    x *= jnp.uint64(0xFF51AFD7ED558CCD)
    x ^= x >> 33
    x *= jnp.uint64(0xC4CEB9FE1A85EC53)
    x ^= x >> 33
    return x


@partial(jax.jit, static_argnums=(1,))
def build_seed_buckets(seeds: jax.Array, msl: int):
    """Counting-sort seed table: positions grouped by seed value, ascending
    within each bucket (parser.cpp:106-143). Fully parallel."""
    L = seeds.shape[0]
    nb = 1 << (2 * msl)
    valid = seeds >= 0
    clipped = jnp.where(valid, seeds, 0).astype(jnp.int32)
    counts = jnp.zeros(nb, jnp.int32).at[clipped].add(valid.astype(jnp.int32))
    lo = jnp.concatenate([jnp.zeros(1, jnp.int32),
                          jnp.cumsum(counts, dtype=jnp.int32)[:-1]])
    # sort key groups by seed then position; invalids go last
    key = jnp.where(valid, seeds * jnp.int64(L + 1) + jnp.arange(L),
                    jnp.int64(2**62))
    order = jnp.argsort(key)
    bucket_pos = order.astype(jnp.int32)  # positions sorted by (seed, pos)
    return bucket_pos, lo, counts

"""Multi-device execution: pair-level data parallelism over a jax Mesh.

The reference parallelizes all2all with a dynamic thread pool over reference
rows (P1, reference src/lz_matcher.cpp:184-270). The device analog
shards the *query batch* axis of each reference's pair block across a device
mesh: the packed reference index is replicated (cheap — one genome), queries
are split over the ``pairs`` axis, and each device parses its slice with the
same vmapped automaton used single-chip. Per-pair triples are gathered back;
a ``psum``-style global reduction of the triples rides the same jit so XLA
lowers it onto the devices' collectives.

Determinism is preserved architecturally: per-pair results are independent
of device placement, and output order is an index sort on the host
(the reference's ordered priority queue, P4, becomes a no-op here).
"""

from __future__ import annotations

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops import prep
from ..ops.engine_jax import RefIndexJax, bucket_len
from ..ops.parse import ParseCfg, batch_parser

AXIS = "pairs"


def make_mesh(devices=None) -> Mesh:
    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, (AXIS,))


@lru_cache(maxsize=64)
def _sharded_parse_batch(mesh: Mesh, cfg: ParseCfg, Lr: int, Lq: int,
                         table_size: int):
    """jit-compiled pair-block step: sharded queries, replicated index.

    Returns (stats i32[B,3] sharded over pairs, totals i32[3] replicated).
    The totals reduction crosses shards, forcing an all-reduce —
    this is the full multi-chip "step" the driver dry-runs.
    """
    parse = batch_parser(cfg, Lr, Lq, table_size)

    repl = NamedSharding(mesh, P())
    shard_b = NamedSharding(mesh, P(AXIS))

    def step(refbuf, ref_true, tab, tmask, bucket_pos, bucket_lo, bucket_cnt,
             qbufs, q_trues, q_seeds, q_anchors, q_valid):
        stats = parse(refbuf, ref_true, tab, tmask, bucket_pos, bucket_lo,
                      bucket_cnt, qbufs, q_trues, q_seeds, q_anchors)
        stats = stats * q_valid[:, None]          # mask padding lanes
        totals = jnp.sum(stats, axis=0)           # cross-shard all-reduce
        return stats, totals

    return jax.jit(
        step,
        in_shardings=(repl,) * 7 + (shard_b,) * 5,
        out_shardings=(shard_b, repl),
    )


class ShardedRefIndex:
    """Device-replicated index for one reference + sharded query parsing."""

    def __init__(self, codes: np.ndarray, params, mesh: Mesh):
        self.mesh = mesh
        idx = RefIndexJax(codes, params)
        self.cfg, self.Lr, self.table_size = idx.cfg, idx.Lr, idx.table_size
        repl = NamedSharding(mesh, P())
        (self.refbuf, self.ref_true, self.tab, self.tmask, self.bucket_pos,
         self.bucket_lo, self.bucket_cnt) = (
            jax.device_put(a, repl)
            for a in (idx.refbuf, idx.ref_true, idx.tab, idx.tmask,
                      idx.bucket_pos, idx.bucket_lo, idx.bucket_cnt))

    def parse_batch(self, qcodes: list[np.ndarray], params) -> np.ndarray:
        """Parse queries against this reference, sharded over the mesh.

        Returns int32[len(qcodes), 3] triples (padding lanes stripped).
        """
        mesh = self.mesh
        nd = mesh.devices.size
        mrd = params.max_dist_in_ref
        true_lens = [len(q) + mrd for q in qcodes]
        Lq = bucket_len(max(true_lens))
        B = -(-len(qcodes) // nd) * nd  # round batch up to mesh multiple

        qb = np.stack(
            [prep.query_buffer_np(q, mrd, pad_to=Lq) for q in qcodes]
            + [np.full(Lq, prep.SYM_N_SEQ, np.uint8)] * (B - len(qcodes)))
        qt = np.asarray(true_lens + [mrd] * (B - len(qcodes)), np.int32)
        valid = np.asarray([1] * len(qcodes) + [0] * (B - len(qcodes)),
                           np.int32)

        shard_b = NamedSharding(mesh, P(AXIS))
        qbufs = jax.device_put(jnp.asarray(qb), shard_b)
        q_trues = jax.device_put(jnp.asarray(qt), shard_b)
        q_valid = jax.device_put(jnp.asarray(valid), shard_b)

        seeds = jax.jit(jax.vmap(lambda b: prep.kmer_stream(b, self.cfg.msl)),
                        in_shardings=shard_b, out_shardings=shard_b)(qbufs)
        anchors = jax.jit(
            jax.vmap(lambda b: prep.kmer_stream(b, self.cfg.mal)),
            in_shardings=shard_b, out_shardings=shard_b)(qbufs)

        run = _sharded_parse_batch(mesh, self.cfg, self.Lr, Lq,
                                   self.table_size)
        stats, _ = run(self.refbuf, self.ref_true, self.tab, self.tmask,
                       self.bucket_pos, self.bucket_lo, self.bucket_cnt,
                       qbufs, q_trues, seeds, anchors, q_valid)
        return np.asarray(stats)[:len(qcodes)]


def all2all_sharded(codes: list[np.ndarray], params, mesh: Mesh | None = None,
                    filter_csr=None, batch_size: int = 1024) -> np.ndarray:
    """Mesh-parallel all-vs-all; output layout matches native_engine.all2all."""
    if mesh is None:
        mesh = make_mesh()
    n = len(codes)
    if filter_csr is None:
        out = np.zeros((n, max(n - 1, 0), 3), dtype=np.int32)
    else:
        indptr, ids = filter_csr
        out = np.zeros((len(ids), 3), dtype=np.int32)

    for r in range(n):
        if filter_csr is None:
            q_ids = [q for q in range(n) if q != r]
        else:
            q_ids = [int(q) for q in ids[indptr[r]:indptr[r + 1]]]
        if not q_ids:
            continue
        idx = ShardedRefIndex(codes[r], params, mesh)
        order = sorted(range(len(q_ids)), key=lambda k: len(codes[q_ids[k]]))
        for s in range(0, len(order), batch_size):
            sel = order[s:s + batch_size]
            stats = idx.parse_batch([codes[q_ids[k]] for k in sel], params)
            for row, k in enumerate(sel):
                q = q_ids[k]
                if filter_csr is None:
                    out[r, q - 1 if q > r else q] = stats[row]
                else:
                    out[int(indptr[r]) + k] = stats[row]
    return out

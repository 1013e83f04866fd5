"""Multi-host execution skeleton: reference-row partitioning over
``jax.distributed`` processes.

The reference is single-host (SURVEY.md §2.4: std::thread only); scale
beyond one host comes from this build's own design (SURVEY.md §7 L4):

  * every process loads the same FASTA set (the reservoir is replicated —
    genome collections are small next to device memory),
  * reference rows are partitioned deterministically across processes
    with a stride layout (rows are longest-first after reorder, so
    striding balances the per-row cost skew the reference handles with
    its dynamic row counter, lz_matcher.cpp:200),
  * each process runs the selected engine over its rows on its own card
    (no cross-process traffic in the hot loop),
  * the per-pair triples are merged by a deterministic all-gather (order
    is a function of row ids, never of timing — the property that
    replaces the reference's ordered priority queue, P4).

Single-process callers get the same partition/merge code path with
``n_hosts=1``; ``tests/test_distributed.py`` dry-runs a simulated 2-host
partition on the CPU mesh and checks the merge against the oracle.
"""

from __future__ import annotations

import numpy as np


def local_gpu_count() -> int:
    """GPUs this process may use, counted without starting JAX:
    CUDA_VISIBLE_DEVICES when set, else the cards the NVIDIA driver lists
    (its /proc entries, or nvidia-smi where /proc has none)."""
    import os
    import subprocess

    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    if vis is not None:
        return len([d for d in vis.split(",") if d.strip()])
    try:
        return len(os.listdir("/proc/driver/nvidia/gpus"))
    except OSError:
        pass
    try:
        r = subprocess.run(["nvidia-smi", "-L"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return 0
    return sum(1 for ln in r.stdout.splitlines() if ln.startswith("GPU "))


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Initialize the jax.distributed runtime when a multi-process launch
    is configured; returns (process_id, num_processes).

    Each process is pinned to ONE card before JAX starts its backend (a
    JAX process reserves most of the memory of every card it sees, so two
    processes that both see a card cannot share it): process i takes local
    card i mod (cards visible). This assumes the processes of one host
    have consecutive ids, one per card, or one process per host.

    Harmless under a single process: returns (0, 1) without touching the
    runtime unless coordination parameters (or the standard JAX env
    variables) are present.
    """
    import os

    import jax

    have_env = bool(coordinator_address
                    or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if not have_env:
        return 0, 1
    # this jax build does not read the standard launch env itself
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    n_gpu = local_gpu_count()
    local_ids = ([process_id % n_gpu]
                 if n_gpu and process_id is not None else None)
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id,
                               local_device_ids=local_ids)
    return jax.process_index(), jax.process_count()


def partition_refs(n_refs: int, n_hosts: int, host_id: int) -> np.ndarray:
    """Deterministic stride partition of reference rows (host h owns rows
    r with r % n_hosts == h). Rows are longest-first (P7 reorder), so the
    stride balances cost skew across hosts."""
    return np.arange(host_id, n_refs, n_hosts, dtype=np.int64)


def local_filter_csr(rows: np.ndarray, n: int, filter_csr=None):
    """CSR restriction of the pair set to this host's reference rows.

    Dense mode (filter_csr=None): rows x (all other ids).
    Filter mode: the owned slices of the global CSR.
    Returns (indptr, ids, global_slots) where global_slots maps each local
    entry to its slot in the full result layout (dense: r*(n-1)+adj(q);
    filter: the global entry index) — the merge step scatters through it.
    """
    indptr = np.zeros(n + 1, np.int64)
    ids_parts = []
    slot_parts = []
    owned = np.zeros(n, bool)
    owned[rows] = True
    if filter_csr is None:
        for r in range(n):
            if owned[r]:
                q = np.concatenate([np.arange(0, r), np.arange(r + 1, n)])
                ids_parts.append(q.astype(np.int32))
                slot_parts.append(r * (n - 1)
                                  + np.where(q > r, q - 1, q).astype(np.int64))
            indptr[r + 1] = indptr[r] + (n - 1 if owned[r] else 0)
    else:
        g_indptr, g_ids = filter_csr
        for r in range(n):
            if owned[r]:
                lo, hi = int(g_indptr[r]), int(g_indptr[r + 1])
                ids_parts.append(np.asarray(g_ids[lo:hi], np.int32))
                slot_parts.append(np.arange(lo, hi, dtype=np.int64))
            indptr[r + 1] = indptr[r] + (
                int(g_indptr[r + 1] - g_indptr[r]) if owned[r] else 0)
    ids = (np.concatenate(ids_parts) if ids_parts
           else np.zeros(0, np.int32))
    slots = (np.concatenate(slot_parts) if slot_parts
             else np.zeros(0, np.int64))
    return indptr, ids, slots


def merge_host_triples(total_slots: int,
                       per_host: list[tuple[np.ndarray, np.ndarray]]
                       ) -> np.ndarray:
    """Deterministic merge: scatter each host's (slots, triples) into the
    global flat (total_slots, 3) result. Slots are disjoint by
    construction, so the merge is order-independent."""
    out = np.zeros((total_slots, 3), np.int32)
    for slots, triples in per_host:
        out[slots] = triples.reshape(-1, 3)
    return out


def split_slots_i32(slots: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 slot indices -> two int32 halves (lo 31 bits, hi bits).
    The distributed transport runs with x64 disabled, so int64 arrays
    would silently truncate; dense slots exceed 2^31 from ~46k genomes."""
    s = np.asarray(slots, np.int64)
    return (s & 0x7FFFFFFF).astype(np.int32), (s >> 31).astype(np.int32)


def join_slots_i32(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    return ((np.asarray(hi).astype(np.int64) << 31)
            | np.asarray(lo).astype(np.int64))


def gather_merge(slots: np.ndarray, triples: np.ndarray,
                 total_slots: int, region_blob: bytes = b"",
                 chunk: int | None = None
                 ) -> tuple[np.ndarray | None, bytes]:
    """Gather every host's (slots, triples[, region bytes]) over the
    jax.distributed transport (NCCL between cards, Gloo on CPU) to the OUTPUT
    rank (process 0), which scatter-merges them into the full flat
    (total_slots, 3) result (slots are disjoint by construction, so the
    merge is order-independent). Non-output ranks return (None, b"") —
    they never materialize the table, so their peak RSS stays flat in
    total_slots (the streaming-store contract; a full-table allgather was
    the multi-host memory high-water mark before).

    The transport only has symmetric allgather, so the gather runs in
    bounded CHUNK-slot rounds: every rank's transient is
    O(n_hosts * chunk), independent of total_slots. Region records are
    self-delimiting and order-independent (lz_matcher.cpp:115-138 applies
    per record), so the blobs concatenate in host order.

    Single-process callers skip the collectives entirely."""
    import os

    import jax

    slots = np.asarray(slots, np.int64)
    triples = np.asarray(triples, np.int32).reshape(-1, 3)
    if jax.process_count() == 1:
        out = merge_host_triples(total_slots, [(slots, triples)])
        return out, region_blob
    from jax.experimental import multihost_utils as mhu

    if chunk is None:
        chunk = int(os.environ.get("LZANI_MERGE_CHUNK", 1 << 22))
    chunk = max(int(chunk), 1)
    rank = jax.process_index()
    nh = jax.process_count()

    # collectives need uniform shapes: exchange lengths, pad each round
    # to the chunk. NB every array goes through jnp with x64 disabled, so
    # int64 would silently truncate — slots ship as two int32 halves
    # (dense slots exceed 2^31 from ~46k genomes).
    lens = np.asarray(mhu.process_allgather(
        np.array([len(slots), len(region_blob)], np.int32)))
    mx = int(lens[:, 0].max())
    mb = int(lens[:, 1].max())
    out = (np.zeros((total_slots, 3), np.int32) if rank == 0 else None)
    for k0 in range(0, max(mx, 1), chunk):
        c = min(chunk, max(mx, 1) - k0)
        sl_p = np.zeros(c, np.int64)
        tr_p = np.zeros((c, 3), np.int32)
        take = max(0, min(len(slots) - k0, c))
        if take:
            sl_p[:take] = slots[k0:k0 + take]
            tr_p[:take] = triples[k0:k0 + take]
        lo, hi = split_slots_i32(sl_p)
        all_lo = np.asarray(mhu.process_allgather(lo))
        all_hi = np.asarray(mhu.process_allgather(hi))
        all_tr = np.asarray(mhu.process_allgather(tr_p))
        if rank == 0:
            for h in range(nh):
                hn = max(0, min(int(lens[h, 0]) - k0, c))
                if hn:
                    sl_h = join_slots_i32(all_lo[h, :hn], all_hi[h, :hn])
                    out[sl_h] = all_tr[h, :hn]
        del all_lo, all_hi, all_tr

    blob_parts: list[list[bytes]] = [[] for _ in range(nh)]
    for k0 in range(0, mb, chunk):
        c = min(chunk, mb - k0)
        rb_p = np.zeros(c, np.uint8)
        take = max(0, min(len(region_blob) - k0, c))
        if take:
            rb_p[:take] = np.frombuffer(
                region_blob[k0:k0 + take], np.uint8)
        all_rb = np.asarray(mhu.process_allgather(rb_p))
        if rank == 0:
            for h in range(nh):
                hn = max(0, min(int(lens[h, 1]) - k0, c))
                if hn:
                    blob_parts[h].append(all_rb[h, :hn].tobytes())
        del all_rb
    blob = b"".join(b"".join(p) for p in blob_parts)
    return out, blob


def all2all_multihost(codes, params, filter_csr=None, device=None,
                      process_id=None, num_processes=None):
    """Run this process's share of the all2all on the device engine and
    return (slots, triples) plus the global slot count. In a real
    multi-process launch every process calls this and process 0 merges via
    gather_merge; single-process callers merge locally."""
    from ..ops.engine_jax import all2all_jax

    n = len(codes)
    if process_id is None or num_processes is None:
        process_id, num_processes = init_distributed()
    rows = partition_refs(n, num_processes, process_id)
    indptr, ids, slots = local_filter_csr(rows, n, filter_csr)
    triples = all2all_jax(codes, params, filter_csr=(indptr, ids),
                          device=device)
    total = (n * (n - 1) if filter_csr is None
             else int(np.asarray(filter_csr[0])[-1]))
    return slots, triples, total

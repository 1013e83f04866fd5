"""Seeded synthetic genome sets (tests, the chip smoke, benchmarks).

Codes are the engine's symbols (0-3 = ACGT, 4 = N). Nothing is downloaded:
every set is a pure function of its seed.
"""

from __future__ import annotations

import numpy as np

SYMBOLS = np.frombuffer(b"ACGTN", np.uint8)


def mutate(rng: np.random.Generator, seq: np.ndarray, sub: float = 0.0,
           indel: float = 0.0) -> np.ndarray:
    """Point substitutions at rate sub, and deletions and single-symbol
    insertions at rate indel each."""
    r = rng.random(len(seq))
    out = seq.copy()
    m = r < sub
    out[m] = (out[m] + rng.integers(1, 4, int(m.sum()))) % 4
    dele = (r >= sub) & (r < sub + indel)
    ins = (r >= sub + indel) & (r < sub + 2 * indel)
    reps = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(out, reps)
    # the second copy of an inserted symbol becomes a random one
    pos = np.cumsum(reps)[ins] - 1
    out[pos] = rng.integers(0, 4, len(pos))
    return out.astype(np.uint8)


def revcomp(seq: np.ndarray) -> np.ndarray:
    out = seq[::-1].copy()
    acgt = out < 4
    out[acgt] = 3 - out[acgt]
    return out


def viral_set(seed: int, n: int, lengths=(20_000, 200_000),
              n_ancestors: int = 4, divergence=(0.003, 0.15)):
    """n genomes from a few ancestors of the given length range; each
    genome is its ancestor with substitutions at a rate drawn from
    divergence, a tenth as many indels, and for some an inverted segment or
    a run of N. Returns (names, codes)."""
    rng = np.random.default_rng(seed)
    lo, hi = lengths
    anc = [rng.integers(0, 4, int(rng.integers(lo, hi + 1))).astype(np.uint8)
           for _ in range(n_ancestors)]
    names, codes = [], []
    for k in range(n):
        a = anc[k % n_ancestors]
        d = float(rng.uniform(*divergence))
        c = mutate(rng, a, sub=d, indel=d / 10)
        if k % 5 == 3:  # an inverted segment
            s = int(rng.integers(0, len(c) // 2))
            e = s + len(c) // 8
            c[s:e] = revcomp(c[s:e])
        if k % 7 == 5:  # a run of N
            s = int(rng.integers(0, len(c) - 200))
            c[s:s + 150] = 4
        names.append(f"g{k:03d}_a{k % n_ancestors}")
        codes.append(c)
    return names, codes


def write_fasta(path: str, names, codes) -> None:
    with open(path, "wb") as fh:
        for nm, c in zip(names, codes):
            fh.write(b">" + nm.encode() + b"\n")
            fh.write(SYMBOLS[np.minimum(c, 4)].tobytes())
            fh.write(b"\n")


def _kmer_set(codes: np.ndarray, k: int) -> np.ndarray:
    c = codes.astype(np.int64)
    if len(c) < k:
        return np.zeros(0, np.int64)
    val = np.zeros(len(c) - k + 1, np.int64)
    ok = np.ones(len(c) - k + 1, bool)
    for j in range(k):
        w = c[j:len(c) - k + 1 + j]
        val = (val << 2) | (w & 3)
        ok &= w < 4
    return np.unique(val[ok])


def write_kmerdb_filter(path: str, names, codes, k: int = 12) -> None:
    """A kmer-db style similarity file (the layout io/kmerdb_filter.py
    reads): per genome, the 1-based ids of the others with the shared
    fraction of distinct k-mers over the smaller set (kmer-db's "min")."""
    sets = [_kmer_set(c, k) for c in codes]
    lines = [f"kmer-length: {k} fraction: 1 ," + ",".join(names) + "\n"]
    for a, nm in enumerate(names):
        row = [nm]
        for b in range(len(names)):
            if b == a:
                continue
            shared = len(np.intersect1d(sets[a], sets[b],
                                        assume_unique=True))
            den = min(len(sets[a]), len(sets[b])) or 1
            if shared:
                row.append(f"{b + 1}:{shared / den:.6f}")
        lines.append(",".join(row) + "\n")
    with open(path, "w") as fh:
        fh.writelines(lines)

"""Multi-host CLI wiring (matcher._do_matching): two real jax.distributed
processes run the SAME CLI invocation, each computes its stride share of
the reference rows, triples + alignment region records are all-gathered,
and process 0's outputs must be byte-identical to a single-process run.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNNER = """
import sys
import jax
jax.config.update("jax_platforms", "cpu")
from lzani.cli import main
raise SystemExit(main(sys.argv[1:]))
"""


def _write_fasta(path, codes):
    sym = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as fh:
        for k, c in enumerate(codes):
            fh.write(b">s%04d\n" % k)
            fh.write(sym[np.minimum(c, 4)].tobytes())
            fh.write(b"\n")


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    rng = np.random.RandomState(5)
    base = rng.randint(0, 4, 900).astype(np.uint8)
    codes = []
    for i in range(7):
        c = base.copy()
        m = rng.rand(len(c)) < 0.02 * (i + 1)
        c[m] = (c[m] + rng.randint(1, 4, m.sum())) % 4
        codes.append(c[: 900 - 40 * i])
    codes.append(rng.randint(0, 4, 500).astype(np.uint8))
    path = tmp_path_factory.mktemp("mh") / "set.fna"
    _write_fasta(str(path), codes)
    return str(path)


def _cli(args, env=None, wait=True):
    e = dict(os.environ)
    if env:
        e.update(env)
    p = subprocess.Popen([sys.executable, "-c", RUNNER] + args,
                         cwd=REPO, env=e, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    if not wait:
        return p
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-2000:]
    return p


def test_two_process_cli_matches_single(fasta, tmp_path):
    single = str(tmp_path / "single.tsv")
    single_aln = str(tmp_path / "single.aln.tsv")
    _cli(["all2all", "--in-fasta", fasta, "--out", single,
          "--out-alignment", single_aln, "-t", "2", "-V", "0",
          "--backend", "native"])

    import socket
    with socket.socket() as s:  # a free port (fixed ports collide
        s.bind(("127.0.0.1", 0))  # across concurrent/back-to-back runs)
        port = s.getsockname()[1]
    outs = [str(tmp_path / f"mh{i}.tsv") for i in range(2)]
    alns = [str(tmp_path / f"mh{i}.aln.tsv") for i in range(2)]
    procs = []
    for pid in range(2):
        env = {"JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)}
        procs.append(_cli(["all2all", "--in-fasta", fasta,
                           "--out", outs[pid],
                           "--out-alignment", alns[pid],
                           "-t", "2", "-V", "1",
                           "--backend", "native"], env=env, wait=False))
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=600)
        errs.append(err)
        assert p.returncode == 0, err[-2000:]
    assert "multi-host: process" in errs[0] + errs[1]

    # rank 0 wrote byte-identical tsv + ids; rank 1 wrote nothing
    with open(single, "rb") as a, open(outs[0], "rb") as b:
        assert a.read() == b.read()
    pa = single.replace(".tsv", ".ids.tsv")
    pb = outs[0].replace(".tsv", ".ids.tsv")
    with open(pa, "rb") as a, open(pb, "rb") as b:
        assert a.read() == b.read()
    # aln rows are schedule-order dependent (reference parity: the
    # golden harness compares them as a set too); multi-host concats
    # region records in host order
    with open(single_aln) as a, open(alns[0]) as b:
        la, lb = a.readlines(), b.readlines()
    assert la[0] == lb[0] and sorted(la[1:]) == sorted(lb[1:])
    assert not os.path.exists(outs[1])
    assert not os.path.exists(alns[1])

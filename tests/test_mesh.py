"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax

from lzani.params import Params
from lzani.parallel.mesh import ShardedRefIndex, all2all_sharded, make_mesh
from lzani.core import native_engine
from lzani.ops.engine_jax import all2all_jax


def _toy_set(n=5, L=300, seed=7):
    rng = np.random.RandomState(seed)
    base = rng.randint(0, 4, L).astype(np.uint8)
    out = []
    for i in range(n):
        s = base.copy()
        s[:: (i + 3)] = (s[:: (i + 3)] + 1) % 4
        out.append(s[: L - 13 * i])
    return out


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(jax.devices()[:8])


def test_sharded_matches_oracle(mesh):
    p = Params()
    codes = _toy_set()
    idx = ShardedRefIndex(codes[0], p, mesh)
    stats = idx.parse_batch(codes[1:], p)
    for row, q in enumerate(codes[1:]):
        nat, _ = native_engine.parse_pair(codes[0], q, p)
        assert tuple(int(x) for x in stats[row]) == nat


def test_sharded_all2all_matches_single_device(mesh):
    p = Params()
    codes = _toy_set(4)
    sharded = all2all_sharded(codes, p, mesh)
    single = all2all_jax(codes, p)
    assert np.array_equal(sharded, np.asarray(single))


def test_padding_lanes_are_masked(mesh):
    """Batch size not divisible by mesh size exercises padding lanes."""
    p = Params()
    codes = _toy_set(3)
    idx = ShardedRefIndex(codes[0], p, mesh)
    stats = idx.parse_batch(codes[1:3], p)  # 2 queries over 8 devices
    assert stats.shape == (2, 3)
    nat, _ = native_engine.parse_pair(codes[0], codes[1], p)
    assert tuple(int(x) for x in stats[0]) == nat

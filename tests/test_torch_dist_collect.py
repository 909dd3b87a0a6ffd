"""`collect_state` (`tpusph_torch/dist/sharded.py`) against the order by
pid on the host that it replaced (`numpy_order`), bit for bit, on
hand-built one-rank blocks: shuffled pids, dead rows with stale pids,
live rows with pid -1, a pid on no row, N off a multiple of 128. The
arrays it returns are fresh on every call, writable, C-contiguous
float32 (N, 3). The last test repeats the comparison on the card at the
size of one rank of the 262,144-particle slab cell; it skips without a
CUDA device. The multi-rank collect is held by the gloo rank tests
(`tests/torch_dist_ranks.py`)."""

import numpy as np
import pytest
import torch

from tpusph_torch.dist.comm import SlabComm
from tpusph_torch.dist.sharded import DistState, collect_state


def numpy_order(dist: DistState, num_particles: int) -> dict:
    """The collect's order by pid as numpy on the host: every field of the
    block copied over, NaN arrays, the live rows scattered by pid."""
    pos, vel, valid, pid = (t.cpu().numpy() for t in dist)
    out_p = np.full((num_particles, 3), np.nan, np.float32)
    out_v = np.full((num_particles, 3), np.nan, np.float32)
    live = valid & (pid >= 0)
    out_p[pid[live]] = pos[live]
    out_v[pid[live]] = vel[live]
    return {"position": out_p, "velocity": out_v}


def make_block(n: int, rows: int, seed: int, *, stale: int = 0, orphans: int = 0,
               missing: int = 0) -> DistState:
    """A block of `rows` rows holding the pids 0 … n-1 but `missing` of
    them, each on one live row at a shuffled place; `stale` dead rows that
    carry pids of live rows, `orphans` live rows with pid -1, and the
    other rows dead with pid -1. Values are random, with -0.0 and a
    subnormal among them."""
    rng = np.random.default_rng(seed)
    pos = rng.normal(size=(rows, 3)).astype(np.float32)
    vel = rng.normal(size=(rows, 3)).astype(np.float32)
    pos[0, 0], vel[1, 2] = -0.0, np.float32(1e-40)
    pids = rng.permutation(n)[: n - missing].astype(np.int32)
    at = rng.permutation(rows)
    live, extra = at[: len(pids)], at[len(pids):]
    valid = np.zeros(rows, bool)
    pid = np.full(rows, -1, np.int32)
    valid[live], pid[live] = True, pids
    pid[extra[:stale]] = rng.choice(pids, stale)
    valid[extra[stale: stale + orphans]] = True
    return DistState(*(torch.from_numpy(a) for a in (pos, vel, valid, pid)))


CASES = {
    "shuffled": dict(n=4096, rows=8192),
    "stale_dead_rows": dict(n=4096, rows=8192, stale=1500),
    "pid_minus_one": dict(n=4096, rows=8192, orphans=700),
    "missing_pid": dict(n=4096, rows=8192, missing=3),
    "ragged": dict(n=1000, rows=1111, stale=50, orphans=20, missing=1),
    "full_block": dict(n=4096, rows=4096),
}


def assert_same_bits(got: dict, want: dict) -> None:
    for key in ("position", "velocity"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        np.testing.assert_array_equal(got[key].view(np.uint32), want[key].view(np.uint32),
                                      err_msg=key)


@pytest.mark.parametrize("case", list(CASES))
def test_collect_equals_the_numpy_order(case):
    spec = dict(CASES[case])
    n, rows = spec.pop("n"), spec.pop("rows")
    block = make_block(n, rows, seed=list(CASES).index(case), **spec)
    got = collect_state(block, n, SlabComm("cpu"))
    want = numpy_order(block, n)
    assert_same_bits(got, want)
    missing = np.isnan(want["position"]).any(axis=1)
    assert missing.sum() == spec.get("missing", 0)
    assert np.isnan(got["velocity"][missing]).all()


def test_collect_returns_fresh_writable_arrays():
    n = 1000
    block = make_block(n, 1111, seed=5, stale=30, missing=2)
    comm = SlabComm("cpu")
    first, second = collect_state(block, n, comm), collect_state(block, n, comm)
    for got in (first, second):
        for key in ("position", "velocity"):
            a = got[key]
            assert a.dtype == np.float32 and a.shape == (n, 3)
            assert a.flags.c_contiguous and a.flags.writeable
    kept = {k: v.copy() for k, v in second.items()}
    for key in ("position", "velocity"):
        assert not np.shares_memory(first[key], second[key])
        first[key][:] = 7.0
    assert_same_bits(second, kept)
    assert not np.shares_memory(first["position"], first["velocity"])


@pytest.mark.gpu
def test_collect_on_the_card_equals_the_numpy_order():
    """One rank of the slab cell: 262,144 shuffled pids on 524,288 rows,
    half of them dead (some with stale pids), on the card; the same block
    moved to the CPU gives the reference. Two calls share no memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    n = 262144
    host_block = make_block(n, 2 * n, seed=11, stale=4096, orphans=64, missing=5)
    block = DistState(*(t.to(dev) for t in host_block))
    comm = SlabComm(dev)
    first = collect_state(block, n, comm)
    assert_same_bits(first, numpy_order(host_block, n))
    second = collect_state(block, n, comm)
    kept = {k: v.copy() for k, v in second.items()}
    first["position"][:] = 7.0
    assert_same_bits(second, kept)
    for key in ("position", "velocity"):
        a = second[key]
        assert a.dtype == np.float32 and a.shape == (n, 3)
        assert a.flags.c_contiguous and a.flags.writeable

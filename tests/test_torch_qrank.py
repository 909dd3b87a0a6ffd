"""The rank function (tpusph_torch.kernels.qrank) against the JAX package's
rank paths: `_rank_left`, the histogram `starts_table`, and the Pallas
rank kernel run in interpret mode, plus numpy's searchsorted. Ranks are
integers and must be equal exactly. `block_spans`, the plain-torch model of
the CUDA kernel's narrowing (a block of consecutive queries searches only
the keys between the ranks of its smallest and largest query, in shared
memory when that span fits its stage), is held to the plain ranks: every
rank lies in its block's span, and a search limited to the span gives it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.neighbors.cell_list import starts_table
from tpusph.pallas.fused import _rank_left
from tpusph.pallas.qrank import rank_queries_pallas
from tpusph_torch.kernels import qrank
from tpusph_torch.kernels.qrank import block_spans, rank_queries, rank_queries_plain

torch.set_num_threads(2)

NC = jdefault(512).num_cells


def _sorted_keys(n, seed, n_valid=None, cells=None):
    """Sorted int32 keys: valid keys drawn from `cells` distinct cells (so
    many cells are empty and many keys repeat), then sentinel padding."""
    rng = np.random.default_rng(seed)
    n_valid = n if n_valid is None else n_valid
    pool = rng.choice(NC, size=cells or n_valid, replace=False)
    keys = np.full(n, NC, np.int32)
    keys[:n_valid] = np.sort(rng.choice(pool, size=n_valid))
    return keys


def _queries(keys, seed):
    """Edge queries (0, nc, nc+1, beyond nc+1, negative), every present key
    and its neighbours, duplicates, and random cells (mostly empty)."""
    rng = np.random.default_rng(seed)
    edge = np.array([0, NC, NC + 1, NC + 2, NC + 1000, -1, 1, NC - 1], np.int32)
    present = np.unique(keys[keys < NC])
    near = np.concatenate([present - 1, present, present + 1])
    rand = rng.integers(0, NC + 2, 300)
    q = np.concatenate([edge, near, rand, near[:50], edge]).astype(np.int32)
    return rng.permutation(q)


CASES = [(256, 0, None, 40), (512, 1, 300, None), (1024, 2, 1000, 64), (4096, 3, 3000, None)]
IDS = [f"n{c[0]}" for c in CASES]


@pytest.mark.parametrize("n,seed,n_valid,cells", CASES, ids=IDS)
def test_rank_equals_searchsorted_and_rank_left(n, seed, n_valid, cells):
    keys = _sorted_keys(n, seed, n_valid, cells)
    q = _queries(keys, seed)
    got, ovf = rank_queries(torch.from_numpy(keys), torch.from_numpy(q), NC)
    assert ovf == 0 and got.dtype == torch.int32
    expect = np.where(q > NC, n, np.searchsorted(keys, q, side="left"))
    np.testing.assert_array_equal(got.numpy(), expect)
    inside = (q >= 0) & (q <= NC + 1)  # _rank_left's domain
    ref = _rank_left(jnp.asarray(keys), jnp.asarray(q[inside]))
    np.testing.assert_array_equal(got.numpy()[inside], np.asarray(ref))


@pytest.mark.parametrize("n,seed,n_valid,cells", CASES, ids=IDS)
def test_starts_table_equal(n, seed, n_valid, cells):
    """The whole table, as build_cell_list asks for it."""
    keys = _sorted_keys(n, seed, n_valid, cells)
    q = np.arange(NC + 2, dtype=np.int32)
    got, _ = rank_queries(torch.from_numpy(keys), torch.from_numpy(q), NC)
    ref = starts_table(jnp.asarray(keys), jdefault(n))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n,seed", [(512, 5), (1024, 6)])
def test_rank_equals_pallas_interpret(n, seed):
    keys = _sorted_keys(n, seed, n - 100, 80)
    q = _queries(keys, seed)
    q = q[q >= 0]
    ref, ovf = rank_queries_pallas(
        jnp.asarray(keys), jnp.asarray(q), jdefault(n, pallas_qrank_kcap=1024),
        interpret=True)
    assert int(ovf) == 0
    got = rank_queries_plain(torch.from_numpy(keys), torch.from_numpy(q), NC)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_rank_rejects_bad_inputs():
    keys = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(TypeError):
        rank_queries(keys, torch.zeros(4, dtype=torch.int64), NC)
    with pytest.raises(ValueError):
        rank_queries(keys, torch.zeros((2, 2), dtype=torch.int32), NC)
    with pytest.raises(ValueError):
        rank_queries(keys, torch.zeros(8, dtype=torch.int32)[::2], NC)


# ------------------------------------------------- the kernel's narrowing


def _span_keys(kind, n, seed):
    """Sorted keys with sentinel padding: a block of fluid in a corner of
    the grid (runs of occupied cells between empty ones, as at grid init),
    uniformly random cells, or nearly every particle in one cell."""
    rng = np.random.default_rng(seed)
    n_valid = n - n // 8
    if kind == "grid":
        c = jdefault(512).num_cells_per_dim
        side = int(round(n_valid ** (1 / 3))) + 1
        x, y, z = np.meshgrid(*[np.arange(side)] * 3, indexing="ij")
        cells = (x + c * y + c * c * z).ravel() % NC
        valid = np.sort(rng.permutation(cells)[:n_valid])
    elif kind == "random":
        valid = np.sort(rng.integers(0, NC, n_valid))
    else:  # dense
        valid = np.sort(np.where(rng.random(n_valid) < 0.9, NC // 3, rng.integers(0, NC, n_valid)))
    keys = np.full(n, NC, np.int32)
    keys[:n_valid] = valid
    return keys


def _span_queries(kind, seed):
    rng = np.random.default_rng(seed)
    cells = np.arange(NC + 2, dtype=np.int32)
    if kind == "cells":  # the step's queries; not a multiple of the block
        return cells
    if kind == "unsorted":
        return rng.permutation(cells)
    if kind == "above":  # in order, with repeats, and a tail above num_cells
        q = np.sort(rng.integers(0, NC + 2, 3000)).astype(np.int32)
        return np.concatenate([q, np.array([NC + 1, NC + 2, NC + 7, 2**30], np.int32)])
    return cells[: 5 * 64 + 17]  # ragged: the last block holds 17 queries


@pytest.mark.parametrize("qkind", ["cells", "unsorted", "above", "ragged"])
@pytest.mark.parametrize("kkind", ["grid", "random", "dense"])
def test_block_spans_hold_every_rank(kkind, qkind):
    block, stage = 64, 96
    keys = torch.from_numpy(_span_keys(kkind, 2048, 11))
    q = torch.from_numpy(_span_queries(qkind, 12))
    lo, hi, staged = block_spans(keys, q, block, stage)
    blocks = -(-q.numel() // block)
    assert lo.shape == hi.shape == staged.shape == (blocks,)
    assert lo.dtype == hi.dtype == torch.int32 and staged.dtype == torch.bool
    assert bool((lo <= hi).all())
    assert torch.equal(staged, (hi - lo) <= stage)
    plain = rank_queries_plain(keys, q, NC)
    limited = torch.empty_like(plain)
    for b in range(blocks):
        sl = slice(b * block, (b + 1) * block)
        assert bool(((plain[sl] >= lo[b]) & (plain[sl] <= hi[b])).all()), b
        span = keys[int(lo[b]): int(hi[b])]
        limited[sl] = lo[b] + torch.searchsorted(span, q[sl], side="left", out_int32=True)
    assert torch.equal(limited, plain)
    if qkind == "unsorted":  # a permutation's block spans nearly all keys
        assert float(staged.float().mean()) < 0.01
    if qkind == "cells":
        # the dense cell's block is wide; so is the last block, whose span
        # runs from the last cells over the sentinel padding to n
        assert bool(staged[:-1].all()) == (kkind != "dense")
        assert not bool(staged[-1])


@pytest.mark.parametrize("nq", [0, 1, 64, 65])
def test_block_spans_without_keys(nq):
    """n = 0: every span is empty and staged; Q = 0 gives no block."""
    keys = torch.zeros(0, dtype=torch.int32)
    q = torch.arange(nq, dtype=torch.int32)
    lo, hi, staged = block_spans(keys, q, 64, 48)
    assert lo.numel() == -(-nq // 64)
    assert bool((lo == 0).all()) and bool((hi == 0).all()) and bool(staged.all())
    assert torch.equal(rank_queries_plain(keys, q, NC), torch.zeros(nq, dtype=torch.int32))


def test_block_spans_defaults_are_the_kernel_shape():
    """The defaults are the CUDA kernel's constants, read from its source."""
    import re
    from tpusph_torch.utils.cuda_build import CSRC

    src = (CSRC / "qrank.cu").read_text()
    threads = int(re.search(r"kRankBlock = (\d+);", src).group(1))
    per_thread = int(re.search(r"kRankPerThread = (\d+);", src).group(1))
    assert qrank.BLOCK_QUERIES == threads * per_thread
    assert qrank.STAGE == int(re.search(r"kRankStage = (\d+);", src).group(1))
    keys = torch.from_numpy(_span_keys("grid", 4096, 3))
    q = torch.arange(NC + 2, dtype=torch.int32)
    lo, hi, staged = block_spans(keys, q)
    assert lo.numel() == -(-(NC + 2) // qrank.BLOCK_QUERIES) and bool(staged.all())


"""The rank function (tpusph_torch.kernels.qrank) against the JAX package's
rank paths: `_rank_left`, the histogram `starts_table`, and the Pallas
rank kernel run in interpret mode, plus numpy's searchsorted. Ranks are
integers and must be equal exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.neighbors.cell_list import starts_table
from tpusph.pallas.fused import _rank_left
from tpusph.pallas.qrank import rank_queries_pallas
from tpusph_torch.kernels.qrank import rank_queries, rank_queries_plain

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

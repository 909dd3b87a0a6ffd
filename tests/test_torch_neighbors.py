"""tpusph_torch.neighbors against tpusph.neighbors: cell keys, the sort
permutation, the starts table, the valid mask and the out-of-grid count
must be equal exactly (they are integers), padding rows and particles
outside the grid included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.neighbors import cell_list as jcl
from tpusph.neighbors import grid as jgrid
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.neighbors import cell_list as tcl
from tpusph_torch.neighbors import grid as tgrid

torch.set_num_threads(2)


def _case(kind, n):
    """(position, valid) numpy arrays with padding rows: grid or random
    init from the JAX package, or random positions with some outside the
    grid (negative, and past the box)."""
    cfg = jdefault(n, chunk_size=512)
    if kind == "oob":
        rng = np.random.default_rng(n)
        npad = cfg.padded_num_particles
        pos = np.zeros((npad, 3), np.float32)
        pos[:n] = rng.uniform(-0.3, 10.3, (n, 3))
        valid = np.arange(npad) < n
        pos[n:] = rng.uniform(-1, 11, (npad - n, 3))  # padding may lie anywhere
        return pos, valid
    st = jinit_state(cfg, random_init=(kind == "random"), seed=n)
    return np.array(st.position), np.array(st.valid)


CASES = [("grid", 700), ("random", 700), ("oob", 700), ("grid", 4096), ("oob", 4000)]
IDS = [f"{k}{n}" for k, n in CASES]


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_compute_keys_equal(kind, n):
    pos, valid = _case(kind, n)
    ref = jgrid.compute_keys(jnp.asarray(pos), jnp.asarray(valid), jdefault(n))
    got = tgrid.compute_keys(torch.from_numpy(pos), torch.from_numpy(valid), tdefault(n))
    assert got.key.dtype == torch.int32
    np.testing.assert_array_equal(got.key.numpy(), np.asarray(ref.key))
    np.testing.assert_array_equal(got.cell.numpy(), np.asarray(ref.cell))
    assert int(got.oob_count) == int(ref.oob_count)
    if kind == "oob":
        assert int(got.oob_count) > 0


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_compute_keys_fields_equal(kind, n):
    pos, valid = _case(kind, n)
    rows = [np.ascontiguousarray(pos[:, a]) for a in range(3)]
    rk, ro = jgrid.compute_keys_fields(*map(jnp.asarray, rows), jnp.asarray(valid), jdefault(n))
    gk, go = tgrid.compute_keys_fields(
        *map(torch.from_numpy, rows), torch.from_numpy(valid), tdefault(n))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(rk))
    assert int(go) == int(ro)


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_build_cell_list_equal(kind, n):
    pos, valid = _case(kind, n)
    ref = jcl.build_cell_list(jnp.asarray(pos), jnp.asarray(valid), jdefault(n))
    got = tcl.build_cell_list(torch.from_numpy(pos), torch.from_numpy(valid), tdefault(n))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(ref.perm))
    np.testing.assert_array_equal(got.key_sorted.numpy(), np.asarray(ref.key_sorted))
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(ref.starts))
    np.testing.assert_array_equal(got.valid_sorted.numpy(), np.asarray(ref.valid_sorted))
    assert int(got.oob_count) == int(ref.oob_count)
    assert got.starts_overflow == 0
    cfg = tdefault(n)
    assert got.starts.shape == (cfg.num_cells + 2,)
    assert int(got.starts[-1]) == pos.shape[0]  # starts[nc + 1] == n
    assert int(got.starts[cfg.num_cells]) == int(valid.sum())


@pytest.mark.parametrize("kind,n", CASES, ids=IDS)
def test_flatten_rowmajor_equal(kind, n):
    """`flatten_rowmajor` of the clamped cells is tpusph's, and the key of
    every valid row."""
    pos, valid = _case(kind, n)
    cfg = tdefault(n, chunk_size=512)
    jk = jgrid.compute_keys(jnp.asarray(pos), jnp.asarray(valid), jdefault(n, chunk_size=512))
    tk = tgrid.compute_keys(torch.from_numpy(pos), torch.from_numpy(valid), cfg)
    got = tgrid.flatten_rowmajor(tk.cell, cfg)
    want = jgrid.flatten_rowmajor(jk.cell, jdefault(n, chunk_size=512))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy()[valid], tk.key.numpy()[valid])

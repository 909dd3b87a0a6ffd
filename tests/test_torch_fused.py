"""The plain density and force passes of tpusph_torch.kernels.fused (the
versions CPU tensors take) against the JAX package's XLA tile passes
`_density_pass_sorted` / `_force_pass_sorted`, on the same sorted inputs.
Bars are those of tests/test_pallas.py: density rtol 1e-5, force rtol
1e-4 with atol 1e-4 (sums are taken in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.engine.step import _density_pass_sorted, _force_pass_sorted
from tpusph.neighbors.cell_list import build_cell_list
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.kernels import fused
from tpusph_torch.physics.kernels import pressure_from_density

torch.set_num_threads(2)


def _dense_arrays(n, cfg, seed):
    """A compressed blob with random velocities: ~47 particles per cell,
    so the pressure term is live (ρ > ρ₀) for part of the particles."""
    rng = np.random.default_rng(seed)
    npad = cfg.padded_num_particles
    pos = np.zeros((npad, 3), np.float32)
    vel = np.zeros((npad, 3), np.float32)
    pos[:n] = rng.uniform(4.0, 4.35, (n, 3))
    vel[:n] = rng.normal(0, 0.5, (n, 3))
    return pos, vel, np.arange(npad) < n


def _case(kind):
    n = {"grid": 4096, "random": 2048, "dense": 2000}[kind]
    jcfg = jdefault(n, chunk_size=2048, tile_cand_capacity=4096)
    if kind == "dense":
        pos, vel, valid = _dense_arrays(n, jcfg, 0)
    else:
        st = jinit_state(jcfg, random_init=(kind == "random"), seed=9)
        pos, valid = np.array(st.position), np.array(st.valid)
        vel = np.random.default_rng(1).normal(0, 0.3, pos.shape).astype(np.float32)
    cl = build_cell_list(jnp.asarray(pos), jnp.asarray(valid), jcfg)
    perm = np.asarray(cl.perm)
    return dict(
        jcfg=jcfg, tcfg=tdefault(n, chunk_size=512),
        sp=pos[perm], sv=vel[perm], key=np.array(cl.key_sorted),
        valid=np.array(cl.valid_sorted), starts=np.array(cl.starts),
    )


@pytest.fixture(scope="module", params=["grid", "random", "dense"])
def case(request):
    return _case(request.param)


def _rows(a):
    return [torch.from_numpy(np.ascontiguousarray(a[:, i])) for i in range(3)]


def _jax_density(c):
    rho, p, ovf = _density_pass_sorted(
        jnp.asarray(c["sp"]), jnp.asarray(c["key"]), jnp.asarray(c["valid"]),
        jnp.asarray(c["starts"]), c["jcfg"])
    assert int(ovf) == 0
    return np.asarray(rho), np.asarray(p)


def test_density_matches_tile_pass(case):
    ref_rho, ref_p = _jax_density(case)
    key, starts = torch.from_numpy(case["key"]), torch.from_numpy(case["starts"])
    valid = torch.from_numpy(case["valid"])
    raw = fused.density(*_rows(case["sp"]), key, starts, case["tcfg"])
    assert torch.all(raw[~valid] == 0)
    rho, p = pressure_from_density(raw, case["tcfg"])
    rho = torch.where(valid, rho, 1.0)
    p = torch.where(valid, p, 0.0)
    np.testing.assert_allclose(rho.numpy(), ref_rho, rtol=1e-5)
    # p = k(ρ − ρ₀) inherits ρ's absolute error, not its relative one
    np.testing.assert_allclose(p.numpy(), ref_p, rtol=1e-5, atol=1e-5 * ref_rho.max())


def test_force_matches_tile_pass(case):
    rho, p = _jax_density(case)
    rho, p = rho.copy(), p.copy()
    if case["tcfg"].num_particles == 2000:
        assert p.max() > 0  # the dense case exercises the pressure term
    ref = _force_pass_sorted(
        jnp.asarray(case["sp"]), jnp.asarray(case["sv"]), jnp.asarray(rho),
        jnp.asarray(p), jnp.asarray(case["key"]), jnp.asarray(case["valid"]),
        jnp.asarray(case["starts"]), case["jcfg"])
    got = fused.force(
        *_rows(case["sp"]), *_rows(case["sv"]), torch.from_numpy(rho),
        torch.from_numpy(p), torch.from_numpy(case["key"]),
        torch.from_numpy(case["starts"]), case["tcfg"])
    assert got.shape == (3, case["key"].shape[0])
    assert torch.all(got[:, ~torch.from_numpy(case["valid"])] == 0)
    np.testing.assert_allclose(got.numpy().T, np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_windows_are_the_key_mask_hit_set(case):
    """Each target's 9 row ranges hold exactly the valid rows whose key
    differs from the target's by off−1, off or off+1 for one of the 9
    column offsets: the pairs the tile pass's key mask accepts."""
    cfg = case["tcfg"]
    key = case["key"].astype(np.int64)
    begin, count = fused.windows(torch.from_numpy(case["key"]),
                                 torch.from_numpy(case["starts"]), cfg)
    begin, count = begin.numpy(), count.numpy()
    offs = np.array(fused.column_offsets(cfg))
    accepted = np.concatenate([offs - 1, offs, offs + 1])
    rng = np.random.default_rng(0)
    for i in rng.choice(np.flatnonzero(case["valid"]), 64, replace=False):
        rows = np.concatenate([np.arange(b, b + c) for b, c in zip(begin[i], count[i])])
        assert len(rows) == len(set(rows))  # the 9 ranges are disjoint
        hit = np.flatnonzero(case["valid"] & np.isin(key - key[i], accepted))
        np.testing.assert_array_equal(np.sort(rows), hit)


def test_wrappers_reject_bad_inputs(case):
    cfg = case["tcfg"]
    x, y, z = _rows(case["sp"])
    key, starts = torch.from_numpy(case["key"]), torch.from_numpy(case["starts"])
    with pytest.raises(ValueError):
        fused.density(x, y, z[:-1], key, starts, cfg)
    with pytest.raises(ValueError):
        fused.density(x, y, z, key, starts[:-1], cfg)
    with pytest.raises(TypeError):
        fused.density(x.double(), y, z, key, starts, cfg)

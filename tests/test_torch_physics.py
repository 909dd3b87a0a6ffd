"""tpusph_torch.physics against tpusph.physics on the same numpy inputs,
at the guard edges (r = 0, r = h, r around EPS_F) and on random pairs.
Tolerance rtol 1e-6: both sides compute in float32 with the same
operation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.physics import integrate as jint
from tpusph.physics import kernels as jk
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.physics import integrate as tint
from tpusph_torch.physics import kernels as tk

torch.set_num_threads(2)

RTOL, ATOL = 1e-6, 0.0
JCFG, TCFG = jdefault(512), tdefault(512)
H = np.float32(0.1)
EPS = np.float32(1e-4)


def _edge_distances():
    """Distances at and around every guard edge, plus random ones."""
    f = np.float32
    edges = [f(0), EPS, np.nextafter(EPS, f(0)), np.nextafter(EPS, f(1)),
             f(0.5) * EPS, f(2) * EPS, H, np.nextafter(H, f(0)),
             np.nextafter(H, f(1)), f(0.5) * H, f(1.5) * H]
    rng = np.random.default_rng(0)
    return np.concatenate([np.array(edges, f), rng.uniform(0, 0.12, 200).astype(f)])


def _disp():
    """Displacements with the edge distances along random unit directions."""
    r = _edge_distances()
    rng = np.random.default_rng(1)
    u = rng.normal(size=(r.size, 3)).astype(np.float32)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    disp = (u * r[:, None]).astype(np.float32)
    disp[0] = 0.0
    disp[1] = [EPS, 0, 0]
    disp[6] = [0, H, 0]
    return disp


def _cmp(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def test_poly6():
    r2 = (_edge_distances() ** 2).astype(np.float32)
    r2 = np.concatenate([r2, np.array([JCFG.h2], np.float32)])
    _cmp(tk.poly6(torch.from_numpy(r2), TCFG), jk.poly6(jnp.asarray(r2), JCFG))


def test_spiky_grad():
    d = _disp()
    _cmp(tk.spiky_grad(torch.from_numpy(d), TCFG), jk.spiky_grad(jnp.asarray(d), JCFG))


def test_viscosity_lap():
    r = _edge_distances()
    _cmp(tk.viscosity_lap(torch.from_numpy(r), TCFG), jk.viscosity_lap(jnp.asarray(r), JCFG))


def test_pair_density():
    d = _disp()
    _cmp(tk.pair_density(torch.from_numpy(d), TCFG), jk.pair_density(jnp.asarray(d), JCFG))


def test_pressure_from_density():
    rho = np.array([0, 1e-5, 1e-4, 1, 999.9, 1000, 1000.1, 1500], np.float32)
    got = tk.pressure_from_density(torch.from_numpy(rho), TCFG)
    ref = jk.pressure_from_density(jnp.asarray(rho), JCFG)
    for g, r in zip(got, ref):
        _cmp(g, r)


def test_pair_force():
    d = _disp()
    rng = np.random.default_rng(2)
    n = d.shape[0]
    dv = rng.normal(size=(n, 3)).astype(np.float32)
    p_i = rng.uniform(0, 500, n).astype(np.float32)
    p_j = rng.uniform(0, 500, n).astype(np.float32)
    rho_j = rng.uniform(500, 1500, n).astype(np.float32)
    args = (d, dv, p_i, p_j, rho_j)
    got = tk.pair_force(*map(torch.from_numpy, args), TCFG)
    ref = jk.pair_force(*map(jnp.asarray, args), JCFG)
    _cmp(got, ref)
    assert np.all(got[0].numpy() == 0)  # r = 0: no force (the self pair)
    assert np.all(got[1].numpy() != 0)  # r = EPS_F exactly is live


def _motion(seed):
    rng = np.random.default_rng(seed)
    n = 512
    pos = rng.uniform(-0.5, 10.5, (n, 3)).astype(np.float32)  # some outside
    vel = rng.normal(0, 1, (n, 3)).astype(np.float32)
    vel[:8] = rng.uniform(-2e-4, 2e-4, (8, 3))  # around the deadband
    force = rng.normal(0, 50, (n, 3)).astype(np.float32)
    rho = rng.uniform(100, 1500, n).astype(np.float32)
    return pos, vel, force, rho


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_integrate(seed):
    args = _motion(seed)
    got = tint.integrate(*map(torch.from_numpy, args), TCFG)
    ref = jint.integrate(*map(jnp.asarray, args), JCFG)
    for g, r in zip(got, ref):
        _cmp(g, r)


@pytest.mark.parametrize("seed", [0, 1])
def test_integrate_fields(seed):
    pos, vel, force, rho = _motion(seed)
    rows = [*pos.T, *vel.T, *force.T, rho]
    got = tint.integrate_fields(*(torch.from_numpy(np.ascontiguousarray(a)) for a in rows), TCFG)
    ref = jint.integrate_fields(*map(jnp.asarray, rows), JCFG)
    for g, r in zip(got, ref):
        _cmp(g, r)

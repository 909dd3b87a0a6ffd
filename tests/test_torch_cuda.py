"""The CUDA kernels of tpusph_torch against their plain PyTorch versions,
on the card. Every test here needs a CUDA device and `nvcc`, and skips
without them. On a GPU machine, from the repository root:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

(`--noconftest`: the suite's conftest imports jax, which this file does
not need.) Bars: ranks exact; density rtol 1e-5; force rtol 1e-4 with
atol 1e-4, and on the dense blob an atol at the float32 floor of its sums
(see the test). The kernels sum in another order than the plain versions,
and nvcc contracts a*b+c into FMA."""

import numpy as np
import pytest
import torch

from tpusph_torch.core.config import default_config
from tpusph_torch.core.init import init_state
from tpusph_torch.engine.step import build_phase, make_step
from tpusph_torch.kernels import fused, qrank
from tpusph_torch.physics.kernels import pressure_from_density

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _sorted_inputs(kind, dev):
    """Sorted rows, keys and starts of a grid state after 5 steps, or of
    a dense blob with random velocities (pressure live)."""
    n = 4096
    cfg = default_config(n, chunk_size=1024)
    st = init_state(cfg, device=dev)
    if kind == "blob":
        rng = np.random.default_rng(0)
        st.position[:n] = torch.from_numpy(rng.uniform(4.0, 4.35, (n, 3)).astype(np.float32)).to(dev)
        st.velocity[:n] = torch.from_numpy(rng.normal(0, 0.5, (n, 3)).astype(np.float32)).to(dev)
    else:
        step = make_step(cfg, "kernels", dev)
        for _ in range(5):
            st, _ = step(st)
    cl = build_phase(st, cfg)
    xyz = st.position[cl.perm].T.contiguous()
    vxyz = st.velocity[cl.perm].T.contiguous()
    return cfg, cl, xyz, vxyz


@pytest.mark.parametrize("kind", ["grid", "blob"])
def test_rank_kernel_equals_plain(dev, kind):
    cfg, cl, _, _ = _sorted_inputs(kind, dev)
    nc = cfg.num_cells
    q = torch.cat([torch.arange(nc + 2, dtype=torch.int32, device=dev),
                   torch.tensor([nc + 5, 2**30, 0, nc], dtype=torch.int32, device=dev)])
    before = qrank.rank_queries.launches
    got, ovf = qrank.rank_queries(cl.key_sorted, q, nc)
    torch.cuda.synchronize()
    assert qrank.rank_queries.launches == before + 1 and ovf == 0
    torch.testing.assert_close(got, qrank.rank_queries_plain(cl.key_sorted, q, nc), rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["grid", "blob"])
def test_density_and_force_kernels_equal_plain(dev, kind):
    cfg, cl, xyz, vxyz = _sorted_inputs(kind, dev)
    key, starts = cl.key_sorted, cl.starts
    raw = fused.density(*xyz, key, starts, cfg)
    torch.testing.assert_close(raw, fused.density_plain(*xyz, key, starts, cfg), rtol=1e-5, atol=0)
    assert torch.all(raw[~cl.valid_sorted] == 0)
    rho, p = pressure_from_density(raw, cfg)
    rho = torch.where(cl.valid_sorted, rho, 1.0)
    p = torch.where(cl.valid_sorted, p, 0.0)
    if kind == "blob":
        assert float(p.max()) > 0  # the pressure term is exercised
    f = fused.force(*xyz, *vxyz, rho, p, key, starts, cfg)
    ref = fused.force_plain(*xyz, *vxyz, rho, p, key, starts, cfg)
    atol = 1e-4
    if kind == "blob":
        # Forces reach ~1.5e4 as sums of ~2,600 cancelling candidate terms,
        # and the two versions add them in other orders: float32 rounding
        # alone then differs by about sqrt(K)·eps·max|f|, far above 1e-4.
        _, count = fused.windows(key, starts, cfg)
        k = float(count.sum(dim=1).max())
        atol = k**0.5 * torch.finfo(torch.float32).eps * float(ref.abs().max())
    torch.testing.assert_close(f, ref, rtol=1e-4, atol=atol)
    assert torch.all(f[:, ~cl.valid_sorted] == 0)


def test_kernels_repeat_bit_for_bit(dev):
    """No atomics: two launches on the same inputs give the same bits."""
    cfg, cl, xyz, vxyz = _sorted_inputs("blob", dev)
    a = fused.density(*xyz, cl.key_sorted, cl.starts, cfg)
    b = fused.density(*xyz, cl.key_sorted, cl.starts, cfg)
    assert torch.equal(a, b)
    rho, p = pressure_from_density(a, cfg)
    fa = fused.force(*xyz, *vxyz, rho, p, cl.key_sorted, cl.starts, cfg)
    fb = fused.force(*xyz, *vxyz, rho, p, cl.key_sorted, cl.starts, cfg)
    assert torch.equal(fa, fb)


def test_wrappers_reject_mixed_devices(dev):
    cfg, cl, xyz, _ = _sorted_inputs("grid", dev)
    with pytest.raises(ValueError):
        fused.density(xyz[0].cpu(), xyz[1], xyz[2], cl.key_sorted, cl.starts, cfg)
    with pytest.raises(ValueError):
        qrank.rank_queries(cl.key_sorted, cl.starts.cpu(), cfg.num_cells)

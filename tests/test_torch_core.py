"""tpusph_torch.core against tpusph.core: config constants, grid init,
padding, numpy state transfer and checkpoints, on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from tpusph.core import config as jcfg
from tpusph.core import init as jinit
from tpusph.core import io as jio
from tpusph.core import state as jstate
from tpusph_torch.core import config as tcfg
from tpusph_torch.core import init as tinit
from tpusph_torch.core import io as tio
from tpusph_torch.core import state as tstate

torch.set_num_threads(2)

SIZES = [256, 1000, 4096, 262_144]


def _jax_arrays(state):
    return {f: np.asarray(getattr(state, f)) for f in state._fields}


@pytest.mark.parametrize("n", SIZES)
def test_derived_constants_equal(n):
    j, t = jcfg.default_config(n), tcfg.default_config(n)
    for name in ("h2", "v_kernel_coeff", "d_kernel_coeff", "num_cells",
                 "padded_num_particles"):
        assert getattr(t, name) == getattr(j, name), name
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


@pytest.mark.parametrize("h", [0.1, 0.05, 0.2])
def test_constants_equal_at_other_radii(h):
    j = jcfg.default_config(512, h=h, num_cells_per_dim=int(round(10 / h)))
    t = tcfg.default_config(512, h=h, num_cells_per_dim=int(round(10 / h)))
    assert (t.h2, t.v_kernel_coeff, t.d_kernel_coeff) == (
        j.h2, j.v_kernel_coeff, j.d_kernel_coeff)


@pytest.mark.parametrize(
    "bad", [dict(num_particles=0), dict(h=-1.0), dict(dt=0.0), dict(chunk_size=0),
            dict(window_capacity=0)],
    ids=lambda d: next(iter(d)),
)
def test_validate_rejects_what_jax_rejects(bad):
    kw = {"num_particles": 512, **bad}
    with pytest.raises(ValueError):
        jcfg.default_config(**kw)
    with pytest.raises(ValueError):
        tcfg.default_config(**kw)


def test_config_from_jax_dict_drops_pallas_keys():
    j = jcfg.tuned_config(262_144)
    t = tcfg.config_from_dict(dataclasses.asdict(j))
    assert t == tcfg.tuned_config(262_144, chunk_size=j.chunk_size)
    with pytest.raises(TypeError):
        tcfg.config_from_dict({"num_particles": 8, "no_such_field": 1})


@pytest.mark.parametrize("n", [256, 1000, 4096])
def test_grid_init_bit_equal(n):
    cfg_j, cfg_t = jcfg.default_config(n), tcfg.default_config(n)
    assert tinit.lattice_capacity(cfg_t) == jinit.lattice_capacity(cfg_j)
    ref = _jax_arrays(jinit.init_state(cfg_j))
    got = tstate.state_to_numpy(tinit.init_state(cfg_t, device="cpu"))
    for f in tstate.FIELDS:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_grid_init_rejects_over_capacity():
    cfg = tcfg.default_config(tinit.lattice_capacity(tcfg.default_config(1)) + 1)
    with pytest.raises(ValueError):
        tinit.grid_positions(cfg)


def test_random_init_seeded_and_in_box():
    cfg = tcfg.default_config(1000)
    a = tinit.init_state(cfg, random_init=True, seed=3, device="cpu")
    b = tinit.init_state(cfg, random_init=True, seed=3, device="cpu")
    c = tinit.init_state(cfg, random_init=True, seed=4, device="cpu")
    assert torch.equal(a.position, b.position)
    assert not torch.equal(a.position, c.position)
    live = a.position[a.valid]
    assert live.shape == (1000, 3)
    assert float(live.min()) >= 1.0 and float(live.max()) <= cfg.box_dim - 1.0


@pytest.mark.parametrize("target", [300, 512, 1024])
def test_pad_state_matches(target):
    rng = np.random.default_rng(target)
    pos = rng.uniform(1, 9, (300, 3)).astype(np.float32)
    import jax.numpy as jnp

    ref = _jax_arrays(jstate.pad_state(jstate.make_state(jnp.asarray(pos)), target))
    got = tstate.state_to_numpy(
        tstate.pad_state(tstate.make_state(torch.from_numpy(pos)), target))
    for f in tstate.FIELDS:
        assert got[f].dtype == ref[f].dtype, f
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


def test_pad_state_rejects_shrink():
    st = tstate.make_state(torch.zeros((8, 3)))
    with pytest.raises(ValueError):
        tstate.pad_state(st, 4)


def test_state_numpy_round_trip_from_jax():
    cfg = jcfg.default_config(1000)
    arrays = _jax_arrays(jinit.init_state(cfg, random_init=True, seed=5))
    st = tstate.state_from_numpy(arrays, "cpu")
    back = tstate.state_to_numpy(st)
    for f in tstate.FIELDS:
        np.testing.assert_array_equal(back[f], arrays[f], err_msg=f)
    st.position[0, 0] = -1.0  # the port's tensors are its own copies
    assert arrays["position"][0, 0] != -1.0


def test_jax_checkpoint_loads_in_port(tmp_path):
    cfg = jcfg.tuned_config(1000)
    st = jinit.init_state(cfg, random_init=True, seed=11)
    path = str(tmp_path / "ck.npz")
    jio.save_state(path, st, cfg)
    got, got_cfg = tio.load_state(path, device="cpu")
    assert got_cfg == tcfg.config_from_dict(dataclasses.asdict(cfg))
    ref = _jax_arrays(st)
    for f, a in tstate.state_to_numpy(got).items():
        np.testing.assert_array_equal(a, ref[f], err_msg=f)


def test_entry_points_default_to_the_card():
    """A caller who names no device gets the card; the CPU is asked for."""
    import inspect

    from tpusph_torch.engine.step import make_step

    for fn in (make_step, tinit.init_state, tio.load_state):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn.__name__


def test_port_checkpoint_loads_in_jax(tmp_path):
    cfg = tcfg.default_config(512)
    st = tinit.init_state(cfg, random_init=True, seed=2, device="cpu")
    path = str(tmp_path / "ck.npz")
    tio.save_state(path, st, cfg)
    jst, jc = jio.load_state(path)
    assert jc.num_particles == 512 and jc.h2 == cfg.h2
    for f, a in tstate.state_to_numpy(st).items():
        np.testing.assert_array_equal(np.asarray(getattr(jst, f)), a, err_msg=f)

"""`tpusph_torch/bench/diagnostics.py` against `tpusph/bench/diagnostics.py`
on one state after a few steps: counts exact, floats at rtol 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest

from tpusph.bench.diagnostics import compute_diagnostics as jcompute
from tpusph.bench.diagnostics import format_diagnostics as jformat
from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.core.state import FluidState as JState
from tpusph.engine.step import make_step as jmake_step
from tpusph_torch.bench.diagnostics import Diagnostics, compute_diagnostics, format_diagnostics
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.state import FIELDS, state_from_numpy

COUNTS = ("num_valid", "occupied_cells", "max_cell_occupancy")
FLOATS = ("kinetic_energy", "momentum", "max_speed", "mean_density", "max_density")


@pytest.fixture(scope="module", params=[(256, True), (1000, False)], ids=["rand256", "grid1000"])
def pair(request):
    """(tpusph's diagnostics, the port's) of one state: 3 steps of tpusph's
    cell_list step, carried across as numpy. 1,000 particles pad to 1,024
    slots, so the invalid rows are there to be left out."""
    n, random_init = request.param
    jcfg = jdefault(n)
    st = jinit_state(jcfg, random_init=random_init, seed=5)
    step = jmake_step(jcfg, "cell_list")
    for _ in range(3):
        st, _ = step(st)
    arrays = {f: np.array(getattr(st, f)) for f in FIELDS}
    jd = jcompute(JState(**{f: jnp.asarray(v) for f, v in arrays.items()}), jcfg)
    return jd, compute_diagnostics(state_from_numpy(arrays, "cpu"), tdefault(n)), n


@pytest.mark.parametrize("field", COUNTS + FLOATS)
def test_diagnostics_match_tpusph(pair, field):
    jd, td, n = pair
    got, want = getattr(td, field), np.asarray(getattr(jd, field))
    if field in COUNTS:
        assert isinstance(got, int) and got == int(want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        assert isinstance(got, tuple if field == "momentum" else float)


def test_diagnostics_are_plain_numbers(pair):
    jd, td, n = pair
    assert isinstance(td, Diagnostics) and td.num_valid == n
    assert td.kinetic_energy > 0  # gravity accelerated the fluid
    assert td.occupied_cells > 0 and td.max_cell_occupancy >= 1
    line = format_diagnostics(td)
    assert line.startswith(f"N={n} KE=") and "occ_max=" in line
    assert line.split()[0] == jformat(jd).split()[0]

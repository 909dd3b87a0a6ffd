"""The port's driver entry points (`tpusph_torch/graft_entry.py`) against
`__graft_entry__.py` on the CPU: `entry()`'s step against tpusph's on the
same state, and the dry run of the sharded engines over gloo ranks, which
must fail when a rank's counter is not clean."""

import inspect
import os
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

from tpusph_torch import graft_entry
from tpusph_torch.dist.comm import spawn_ranks
from tpusph_torch.dist.sharded import DistAux

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
import __graft_entry__  # noqa: E402
from torch_dist_ranks import dryrun_tight_halo, one_thread  # noqa: E402,F401


def test_entry_matches_tpusph():
    jfn, (jstate,) = __graft_entry__.entry()
    tfn, (tstate,) = graft_entry.entry(device="cpu")
    for f in ("position", "velocity", "valid"):
        np.testing.assert_array_equal(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)))
    want = jax.jit(jfn)(jstate)
    got = tfn(tstate)
    for f in ("position", "velocity", "density"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert inspect.signature(graft_entry.entry).parameters["device"].default == "cuda"


def test_dryrun_multichip_four_ranks(capfd):
    graft_entry.dryrun_multichip(4)
    out = capfd.readouterr().out
    for leg in ("leg 1", "leg 2 (brick grid (4, 1, 1)", "leg 3"):
        assert f"dryrun {leg}" in out, out


def test_a_rank_with_a_dirty_counter_fails_the_dry_run():
    with tempfile.TemporaryDirectory() as tmp:
        with pytest.raises(Exception, match="tight step 0: halo_overflow"):
            spawn_ranks(dryrun_tight_halo, 2, "file://" + os.path.join(tmp, "store"), "cpu")


@pytest.mark.parametrize("counter", ["num_particles", *graft_entry.COUNTERS])
def testassert_aux_clean_names_the_counter(counter):
    clean = {f: 0 for f in DistAux._fields}
    clean["num_particles"] = 100
    graft_entry.assert_aux_clean(DistAux(**{k: torch.tensor(v) for k, v in clean.items()}),
                                  100, "leg", 3)
    dirty = dict(clean, **{counter: 99 if counter == "num_particles" else 2})
    said = "conservation broken" if counter == "num_particles" else f"{counter} = 2"
    with pytest.raises(RuntimeError, match=f"leg step 3: .*{said}"):
        graft_entry.assert_aux_clean(DistAux(**{k: torch.tensor(v) for k, v in dirty.items()}),
                                      100, "leg", 3)

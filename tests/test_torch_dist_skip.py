"""The migration-free sort skip of the z-slab engine
(`tpusph_torch/dist/sharded.py`, module docstring §6): a rank without
slab-crossers takes the rows the category sort would give without
sorting, from `_skip_order` in an eager step (a host read) and from
`_graphed_order` in a graphed one (`graphs.device_if`: the rotation every
step, the sort only where a row crosses, a conditional node on a card;
both computed and selected on the CPU, the same on every torch). The
step under test is the graphed one, its body run under the capture guard
here. Held here bit for bit against
TPUSPH_DIST_FORCE_MIGSORT=1 (every row of every field, every counter,
after every step) on one rank and on gloo ranks, and against tpusph's
`make_sharded_run`, whose `lax.cond` takes the same skip. Everything runs
on the CPU; the rank functions are in `tests/torch_dist_ranks.py`.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)

from tpusph_torch.dist import mesh3d, sharded  # noqa: E402
from tpusph_torch.dist.comm import BrickComm, SlabComm, spawn_ranks  # noqa: E402
from tpusph_torch.dist.sharded import DistConfig, distribute_state, make_sharded_step  # noqa: E402

DEADLINE_S = 150.0
STEPS = 10


@pytest.fixture(scope="module")
def cases():
    return ranks.make_cases()


def _category_sort(live, mig_dn, mig_up, m_cap):
    """`_final_hop`'s category sort order, for the same rows."""
    kept = live & ~mig_dn & ~mig_up
    cat = torch.where(mig_dn, 0, torch.where(mig_up, 2, torch.where(kept, 1, 3)))
    return torch.sort(torch.cat([cat, cat.new_full((m_cap,), 3)]).to(torch.uint8),
                      stable=True).indices


@pytest.mark.parametrize("n_lo,n_kept", [(0, 0), (0, 40), (7, 0), (7, 40), (19, 101), (120, 8)])
def test_skip_order_is_the_category_sort(n_lo, n_kept):
    """The rotation `_skip_order` gives is the stable category sort's order
    for a layout whose live rows are one block behind n_lo rows, as the
    splice lays them out; with a crosser it gives None (the sort runs)."""
    n, m_cap = 128, 16
    live = torch.zeros(n, dtype=torch.bool)
    live[n_lo:n_lo + n_kept] = True
    none = torch.zeros_like(live)
    order = sharded._skip_order(live, none, none, n + m_cap)
    torch.testing.assert_close(order, _category_sort(live, none, none, m_cap), rtol=0, atol=0)
    if n_kept:
        crosser = none.clone()
        crosser[n_lo] = True
        assert sharded._skip_order(live, crosser, none, n + m_cap) is None
        assert sharded._skip_order(live, none, crosser, n + m_cap) is None


@pytest.mark.parametrize("name", ["grid", "drift"])
def test_one_rank_skip_equals_the_sort(cases, name, monkeypatch):
    """One rank through the whole machinery (TPUSPH_DIST_FULL_MACHINERY=1):
    no particle can cross a face, so every step skips; the rows and the
    counters are the always-sort run's, bit for bit, after every step."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    cfg = ranks.dense_cfg() if name == "grid" else ranks.sparse_cfg()
    comm = SlabComm("cpu")
    dcfg = DistConfig(1, cfg.padded_num_particles, 256, 128)
    start = distribute_state(ranks._as_state(cases[name]), cfg, dcfg, comm)
    step = make_sharded_step(cfg, dcfg, comm)
    runs = {}
    for forced in ("1", "0"):
        monkeypatch.setenv("TPUSPH_DIST_FORCE_MIGSORT", forced)
        sharded.migration_sorts = sharded.migration_skips = 0
        runs[forced] = ranks._trajectory(step, start, STEPS)
        counts = (sharded.migration_sorts, sharded.migration_skips)
        assert counts == ((STEPS, 0) if forced == "1" else (0, STEPS)), (forced, counts)
    for (a, aux_a), (b, aux_b) in zip(runs["1"], runs["0"]):
        assert aux_a == aux_b
        for x, y, field in zip(a, b, sharded.DistState._fields):
            assert torch.equal(x, y), field


@pytest.mark.parametrize("size", [2, 4])
def test_ranks_skip_equals_the_sort(cases, size, tmp_path):
    """gloo ranks, grid init (no crossers: every rank skips every step) and
    the drifting random state (crossers: both branches taken): the skip and
    TPUSPH_DIST_FORCE_MIGSORT=1 agree bit for bit on every row and counter
    after every step (`torch_dist_ranks.skip_checks`)."""
    spawn_ranks(ranks.skip_checks, size, f"file://{tmp_path}/store", "cpu", (cases, STEPS),
                DEADLINE_S)


def test_skip_matches_tpusph_make_sharded_run(tmp_path, eight_devices):
    """A migrating trajectory (512 particles of tpusph's seed-13 random
    init with the ±3 z drift) on two virtual devices through tpusph's
    `make_sharded_run`, skip live, and on two gloo ranks through the
    port's, skip live: the nine counters equal and positions and
    velocities by pid within 1e-5 after 10 steps; the port took both
    branches."""
    import jax
    from jax.sharding import Mesh

    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit
    from tpusph.dist import sharded as jsharded

    cfg = jdefault(512, chunk_size=512)
    mesh = Mesh(np.array(eight_devices[:2]), ("z",))
    caps = dict(n_devices=2, dev_capacity=512, halo_capacity=256, migration_capacity=128)
    jdcfg = jsharded.DistConfig(**caps)
    st = jinit(cfg, random_init=True, seed=13)
    drift = ranks.drifting({"velocity": np.asarray(st.velocity)})["velocity"]
    start = jsharded.distribute_state(st._replace(velocity=drift), cfg, jdcfg, mesh)
    end, aux = jsharded.make_sharded_run(cfg, jdcfg, mesh, STEPS)(start)
    payload = {
        "dcfg": caps, "steps": STEPS, "aux": [int(a) for a in aux],
        "start": {k: np.asarray(jax.device_get(v)) for k, v in start._asdict().items()},
        **jsharded.collect_state(end, cfg.num_particles),
    }
    assert payload["aux"][-1] > 0  # some particle crossed a face
    spawn_ranks(ranks.jax_skip_checks, 2, f"file://{tmp_path}/store", "cpu", (payload,),
                DEADLINE_S)


def test_no_skip_where_it_does_not_apply(cases, monkeypatch):
    """The skip is never decided (no read of the card, no device branch)
    with TPUSPH_DIST_FORCE_MIGSORT=1, on a layout that is merged rather
    than spliced (dev_capacity < 2·halo_capacity), or in the brick engine,
    which shares `_final_hop` and has no skip in tpusph either: the graphed
    and the eager step sort."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")

    def refuse(*args):
        raise AssertionError("the skip was decided")

    monkeypatch.setattr(sharded, "_skip_order", refuse)
    monkeypatch.setattr(sharded, "device_if", refuse)
    cfg = ranks.dense_cfg()
    comm = SlabComm("cpu")
    for env, dcfg in (("1", DistConfig(1, cfg.padded_num_particles, 256, 128)),
                      ("0", DistConfig(1, 1024, 768, 128))):
        monkeypatch.setenv("TPUSPH_DIST_FORCE_MIGSORT", env)
        sharded.migration_sorts = sharded.migration_skips = 0
        state = distribute_state(ranks._as_state(cases["grid"]), cfg, dcfg, comm)
        step = make_sharded_step(cfg, dcfg, comm)
        for fn in (step, step.eager):
            _, aux = fn(state)
            ranks._clean(aux, cfg.num_particles)
        assert (sharded.migration_sorts, sharded.migration_skips) == (2, 0)
    monkeypatch.setenv("TPUSPH_DIST_FORCE_MIGSORT", "0")
    brick = BrickComm("cpu", None, (1, 1, 1))
    mcfg = mesh3d.Mesh3DConfig((1, 1, 1), 1024, (1024,) * 3, (128,) * 3)
    state = mesh3d.distribute_state_3d(ranks._as_state(cases["grid"]), cfg, mcfg, brick)
    state, aux = mesh3d.make_mesh3d_step(cfg, mcfg, brick)(state)
    assert int(aux.num_particles) == cfg.num_particles
    del brick

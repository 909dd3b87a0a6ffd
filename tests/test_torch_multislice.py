"""The multi-slice topology of the port (`tpusph_torch/dist/multislice.py`):
slice-major order of the z-slab line, boundary accounting, the bytes a
boundary carries against the step's real exchanges, and the z-slab step
over a slice-major line of four gloo ranks (tests/test_multislice.py's
cases, over ranks instead of devices).
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)
import torch_mesh3d_ranks as bricks  # noqa: E402

from tpusph_torch.dist import comm as comm_mod  # noqa: E402
from tpusph_torch.dist.comm import SlabComm, spawn_ranks  # noqa: E402
from tpusph_torch.dist.multislice import (  # noqa: E402
    SliceTopology,
    halo_bytes_per_boundary,
    make_multislice_mesh,
)
from tpusph_torch.dist.sharded import DistConfig, distribute_state, make_sharded_step  # noqa: E402


def test_synthetic_slicing_groups_contiguously(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    topo = make_multislice_mesh(8, n_slices=2)
    assert topo.slice_of == (0, 0, 0, 0, 1, 1, 1, 1)
    assert topo.order == tuple(range(8))
    assert topo.n_slices == 2
    assert topo.dcn_boundary_pairs() == [(3, 4)]
    assert make_multislice_mesh(8).n_slices == 1  # one node, one slice


def test_slice_major_ordering_from_an_explicit_list():
    """Ranks whose slices interleave are regrouped slice-major, the group's
    order kept within each slice: the order that puts exactly n_slices − 1
    links of the line across slices."""
    slices = [i % 2 for i in range(8)]
    topo = make_multislice_mesh(8, slices=slices)
    assert topo.slice_of == (0, 0, 0, 0, 1, 1, 1, 1)
    assert topo.order == (0, 2, 4, 6, 1, 3, 5, 7)  # stable within slices
    assert topo.dcn_boundary_pairs() == [(3, 4)]
    # n_slices is ignored where the ranks report distinct slices
    assert make_multislice_mesh(8, slices=slices, n_slices=4).n_slices == 2


def test_slices_are_torchrun_nodes(monkeypatch):
    """Under torchrun a slice is a node: rank // LOCAL_WORLD_SIZE."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    topo = make_multislice_mesh(8)
    assert topo.slice_of == (0, 0, 0, 0, 1, 1, 1, 1) and topo.dcn_boundary_pairs() == [(3, 4)]
    assert make_multislice_mesh(8, n_slices=4).n_slices == 2  # the nodes win
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert make_multislice_mesh(8, n_slices=4).slice_of == (0, 0, 1, 1, 2, 2, 3, 3)


def test_uneven_synthetic_slicing_rejected(monkeypatch):
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="do not split"):
        make_multislice_mesh(8, n_slices=3)
    with pytest.raises(ValueError, match="slices given"):
        make_multislice_mesh(8, slices=[0, 1])
    with pytest.raises(ValueError, match="no order"):
        SlabComm("cpu", order=(1,))


@pytest.mark.parametrize("n_slices", [1, 2, 4])
def test_dcn_boundary_count_scales(n_slices):
    per = 8 // n_slices
    topo = SliceTopology(order=tuple(range(8)), slice_of=tuple(i // per for i in range(8)))
    assert len(topo.dcn_boundary_pairs()) == n_slices - 1


def test_boundary_payload_bound():
    """At capacities that are multiples of 8 the packed messages are
    tpusph's 25 bytes a halo row and 29 a migration row."""
    assert halo_bytes_per_boundary(256, 128) == 256 * 25 + 128 * 29


@pytest.mark.parametrize("halo,migration", [(256, 128), (264, 136)])
def test_boundary_payload_matches_the_step_exchanges(halo, migration, monkeypatch):
    """Anti-drift: the bytes `halo_bytes_per_boundary` gives equal what a
    z-slab step really hands its exchanges in each direction, recorded
    from a step through the whole machinery on one rank."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    cfg = ranks.sparse_cfg()
    comm = SlabComm("cpu")
    sent = {"up": 0, "dn": 0}
    exchange = comm_mod._Group._exchange

    def record(self, up, dn, below, above):
        sent["up"] += comm_mod._packed_size(list(up))
        sent["dn"] += comm_mod._packed_size(list(dn))
        return exchange(self, up, dn, below, above)

    monkeypatch.setattr(comm_mod._Group, "_exchange", record)
    dcfg = DistConfig(1, cfg.padded_num_particles, halo, migration)
    whole = ranks._as_state(ranks._as_numpy(ranks.init_state(cfg, True, 13, "cpu")))
    make_sharded_step(cfg, dcfg, comm)(distribute_state(whole, cfg, dcfg, comm))
    want = halo_bytes_per_boundary(halo, migration)
    assert sent == {"up": want, "dn": want}


def test_sharded_step_over_a_slice_major_line(tmp_path):
    """Four gloo ranks whose slices interleave: the line is (0, 2, 1, 3),
    and the z-slab step over it matches the single process over 20 steps
    of ±3 z drift (`torch_mesh3d_ranks.slice_major_checks`), and
    DistSimulator's line comes from the topology (synthetic n_slices)."""
    cfg = ranks.sparse_cfg()
    rand = ranks._as_numpy(ranks.init_state(cfg, random_init=True, seed=13, device="cpu"))
    drift = ranks.drifting(rand)
    cases = {"drift": drift, "drift20": ranks.single_process(cfg, drift, 20)}
    spawn_ranks(bricks.slice_major_checks, 4, f"file://{tmp_path}/store", "cpu", (cases,), 150.0)


def test_one_rank_line_is_the_identity():
    comm = SlabComm("cpu", order=(0,))
    assert (comm.rank, comm.size, comm._peers()) == (0, 1, (None, None))
    got = comm.exchange([torch.ones(2)], [])
    assert not got[0][0].any()

"""The device branch of a graphed body (`engine/graphs.py::device_if`,
`kernels/graph_cond.py`, `csrc/graph_cond.cu`), tpusph's `lax.cond`.

On a card the branch is a conditional node behind the kernel `set_if`; on
the CPU, where these tests run, `device_if` computes the branch and its
alternative and selects by the predicate, under the capture guard, as a
graphed body runs here. Held here: the plain versions bit for bit against
the branch the predicate picks; the one-rank z-slab production run through
the whole machinery, whose graphed body takes the skip by `device_if`,
bit for bit against its eager run (the host-read skip) and against
TPUSPH_DIST_FORCE_MIGSORT=1 (the sort), and against tpusph's
`make_sharded_run` on JAX's CPU at the reference's bars, with the branch
counts; and the sources: no `torch.cond` left, the library's entry points
declared. Small N, one thread. The card's side is in
`tests/test_torch_cuda.py` and `chip_smoke.py` phase 16.
"""

import os
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)

from tpusph_torch.core.init import init_state  # noqa: E402
from tpusph_torch.core.state import dist_state_from_numpy  # noqa: E402
from tpusph_torch.dist import sharded  # noqa: E402
from tpusph_torch.dist.comm import SlabComm  # noqa: E402
from tpusph_torch.dist.sharded import DistConfig, DistState, collect_state  # noqa: E402
from tpusph_torch.engine import graphs  # noqa: E402
from tpusph_torch.engine.graphs import GraphedLoop, device_if, no_host_reads  # noqa: E402
from tpusph_torch.kernels import graph_cond  # noqa: E402
from tpusph_torch.utils import cuda_build  # noqa: E402

CPU = torch.device("cpu")
RUN_STEPS = 20
PORT = os.path.join(os.path.dirname(__file__), os.pardir, "tpusph_torch")


def _branch(x):
    return x.flip(0) * 3 + 1


@pytest.mark.parametrize("pred", [True, False, 0, 1, 7, -3])
def test_device_if_plain_is_the_branch_pred_picks(pred):
    """`device_if` on the CPU: bit for bit the branch's output where the
    predicate is above 0 (a bool: true), else the alternative, from a bool
    or an int predicate; under the capture guard it reads nothing on the
    host, and it counts no launch of `set_if`."""
    x = torch.arange(10, dtype=torch.int64) * 5
    out = torch.full((10,), -1, dtype=torch.int64)
    want = _branch(x) if pred > 0 else out
    launches = graph_cond.set_if.launches
    with no_host_reads(CPU):
        got = device_if(torch.tensor(pred), _branch, (x,), out)
    assert got.dtype == want.dtype and torch.equal(got, want)
    looped = GraphedLoop(lambda t: [device_if(t[0], _branch, (t[1],), t[2])], CPU)
    assert torch.equal(looped([torch.tensor(pred), x, out])[0], want)
    assert graph_cond.set_if.launches == launches


@pytest.mark.parametrize("value", [-2, 0, 1, 5, 2**31 - 1])
def test_set_if_plain_is_the_condition(value):
    """`set_if` on a CPU tensor takes its plain version: the condition
    pred > 0 as a 0-d bool, what the kernel sets on a card."""
    got = graph_cond.set_if(torch.tensor(value, dtype=torch.int32))
    assert got.dtype == torch.bool and got.shape == () and bool(got) == (value > 0)
    assert torch.equal(got, graph_cond.set_if_plain(torch.tensor(value, dtype=torch.int32)))


@pytest.mark.parametrize("bad", [torch.tensor(1), torch.tensor([1], dtype=torch.int32),
                                 torch.tensor(1.0)])
def test_set_if_takes_an_int32_scalar(bad):
    """The predicate `set_if` reads on the card is one int32; anything else
    raises, on the CPU too."""
    with pytest.raises((TypeError, ValueError)):
        graph_cond.set_if(bad)


def _jax_run(arrays, caps, steps):
    """tpusph's `make_sharded_run` on one virtual CPU device: (start
    arrays, end arrays, the nine counters)."""
    import jax
    from jax.sharding import Mesh

    from tpusph.core.config import default_config as jdefault
    from tpusph.core.init import init_state as jinit
    from tpusph.dist import sharded as jsharded

    cfg = jdefault(512, chunk_size=512)
    st = jinit(cfg)._replace(**{k: jax.numpy.asarray(v) for k, v in arrays.items()})
    mesh = Mesh(np.array(jax.devices("cpu")[:1]), ("z",))
    jcfg = jsharded.DistConfig(**caps)
    start = jsharded.distribute_state(st, cfg, jcfg, mesh)
    end, aux = jsharded.make_sharded_run(cfg, jcfg, mesh, steps)(start)
    as_numpy = lambda d: {k: np.asarray(jax.device_get(v)) for k, v in d._asdict().items()}
    return as_numpy(start), as_numpy(end), [int(a) for a in aux]


@pytest.mark.parametrize("name", ["grid", "drift"])
def test_one_rank_run_takes_the_device_branch(name, monkeypatch):
    """One z-slab rank through the whole machinery (TPUSPH_DIST_FULL_MACHINERY=1),
    `make_sharded_run(20)` from 512 particles of the grid init (and with
    the ±3 z drift): the graphed run (its body under the capture guard, the
    skip by `device_if`) equals its eager run (the host-read skip) and the
    graphed and eager runs with TPUSPH_DIST_FORCE_MIGSORT=1 (the sort) bit
    for bit, rows and counters; branch counts (sorts, skips) (0, 20) each
    with the skip and (20, 0) each with the sort; and tpusph's run on JAX's
    CPU, whose `lax.cond` takes the skip: the nine counters equal,
    positions and velocities by pid at the reference's bars."""
    monkeypatch.setenv("TPUSPH_DIST_FULL_MACHINERY", "1")
    monkeypatch.delenv("TPUSPH_DIST_FORCE_MIGSORT", raising=False)
    cfg = ranks.sparse_cfg()
    arrays = ranks._as_numpy(init_state(cfg, device="cpu"))
    if name == "drift":
        arrays = ranks.drifting(arrays)
    caps = dict(n_devices=1, dev_capacity=512, halo_capacity=256, migration_capacity=128)
    start_np, end_np, aux_want = _jax_run(arrays, caps, RUN_STEPS)
    dcfg, comm = DistConfig(**caps), SlabComm("cpu")
    start = dist_state_from_numpy(start_np, 0, dcfg, "cpu")
    run = sharded.make_sharded_run(cfg, dcfg, comm, RUN_STEPS)
    ends, counts = {}, {}
    for forced in ("0", "1"):
        monkeypatch.setenv("TPUSPH_DIST_FORCE_MIGSORT", forced)
        for mode, fn in (("graphed", run), ("eager", run.eager)):
            before = sharded.migration_counts()
            ends[forced, mode] = fn(start)
            counts[forced, mode] = tuple(b - a for a, b in zip(before, sharded.migration_counts()))
    want_state, want_aux = ends["0", "graphed"]
    for key, (state, aux) in ends.items():
        assert [int(a) for a in aux] == [int(a) for a in want_aux], key
        for x, y, field in zip(state, want_state, DistState._fields):
            assert torch.equal(x, y), (key, field)
    assert counts == {("0", "graphed"): (0, RUN_STEPS), ("0", "eager"): (0, RUN_STEPS),
                      ("1", "graphed"): (RUN_STEPS, 0), ("1", "eager"): (RUN_STEPS, 0)}
    assert [int(a) for a in want_aux] == aux_want
    ours = collect_state(want_state, cfg.num_particles, comm)
    theirs = collect_state(dist_state_from_numpy(end_np, 0, dcfg, "cpu"), cfg.num_particles,
                           comm)
    ranks._close(ours, theirs)
    del comm


def test_the_branch_is_the_port_own():
    """No `torch.cond` and no test for torch's conditional-node module are
    left in the graphs or the slab engine; the branch goes through
    `device_if`, `set_if` counts with the step kernels, the library
    declares the entry point of `csrc/graph_cond.cu`, and the node counts
    name libcuda's conditional type (13, `CU_GRAPH_NODE_TYPE_CONDITIONAL`)."""
    for rel in ("engine/graphs.py", "dist/sharded.py"):
        with open(os.path.join(PORT, rel)) as f:
            src = f.read()
        assert "torch.cond" not in src and "cudagraph_conditional_nodes" not in src, rel
        assert "CONDITIONAL_NODES" not in src, rel
    assert sharded.device_if is graphs.device_if
    assert graph_cond.set_if in graphs.COUNTED
    assert cuda_build.SIGNATURES["tpusph_graph_if"] == [cuda_build.P] * 3
    src = (cuda_build.CSRC / "graph_cond.cu").read_text()
    assert "__global__ void set_if(cudaGraphConditionalHandle" in src
    assert "cudaGraphSetConditional(handle, *pred > 0" in src
    assert re.search(r"extern \"C\" int tpusph_graph_if\(cudaStream_t stream", src)
    assert graph_cond.CU_NODE_TYPES[13] == "conditional"
    assert set(graph_cond.CU_NODE_TYPES.values()) < set(graph_cond.NODE_TYPES)

"""DistSimulator of the port (`tpusph_torch/dist/simulator.py`) and the
command line's `--mesh`: tests/test_dist_simulator.py's cases on one rank
in this process and on four gloo ranks (a z-slab line and a (1, 2, 2)
brick grid), two ranks against tpusph's DistSimulator, and `--mesh` as one
rank and under torchrun. Everything runs on the CPU.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_ranks as ranks  # noqa: E402
from torch_dist_ranks import one_thread  # noqa: E402,F401  (autouse)
import torch_mesh3d_ranks as bricks  # noqa: E402

from tpusph_torch import cli  # noqa: E402
from tpusph_torch.core.io import load_state  # noqa: E402
from tpusph_torch.dist.comm import SlabComm, spawn_ranks  # noqa: E402
from tpusph_torch.dist.simulator import (  # noqa: E402
    DistSimulator,
    default_dist_config,
    default_mesh3d_config,
)
from tpusph_torch.engine.simulator import Simulator  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 150.0


@pytest.fixture(scope="module")
def cases():
    cfg = ranks.sparse_cfg()
    sim = Simulator(cfg, backend="cell_list", random_init=True, seed=21, device="cpu")
    sim.setup()
    for _ in range(5):
        sim.simulate()
    return {"sim5": sim.get_position().copy()}


@pytest.mark.parametrize("brick", [None, (1, 1, 1)], ids=["z", "brick"])
def test_one_rank_simulator(cases, brick):
    """tests/test_dist_simulator.py's cases on a group of one rank in this
    process (`torch_mesh3d_ranks.simulator_checks`): the single card, the
    timed phases, run against simulate, right_size, capacity growth."""
    bricks.simulator_checks(SlabComm("cpu"), cases, brick)


@pytest.mark.parametrize("brick", [(1, 2, 2)], ids=["z_and_1x2x2"])
def test_four_rank_simulator(cases, brick, tmp_path):
    """The same cases on four gloo ranks, one spawn: a z-slab line and a
    (1, 2, 2) brick grid, plus capacity growth, a checkpoint moved from
    the line to the grid, and rebalance."""
    spawn_ranks(bricks.simulator_checks, 4, f"file://{tmp_path}/store", "cpu", (cases, brick),
                DEADLINE_S)


def test_two_ranks_match_tpusph_dist_simulator(tmp_path, eight_devices):
    """Two gloo ranks against tpusph's DistSimulator on two virtual devices,
    both set up from tpusph's seed-21 random state: the balanced planes of
    setup equal, and the positions by pid after each of 5 simulate() steps
    within 1e-5 (tpusph runs its tile passes, the port its kernels' plain
    versions)."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.dist.simulator import DistSimulator as JDistSimulator

    cfg = jdefault(512, chunk_size=512)
    jsim = JDistSimulator(cfg, devices=eight_devices[:2], random_init=True, seed=21)
    jsim.setup()
    start = {k: np.asarray(v) for k, v in jsim.to_host_state()._asdict().items()}
    payload = {"start": start, "planes": jsim.dcfg.slab_planes, "positions": []}
    for _ in range(5):
        jsim.simulate()
        payload["positions"].append(np.asarray(jsim.get_position()))
    spawn_ranks(bricks.jax_simulator_checks, 2, f"file://{tmp_path}/store", "cpu", (payload,),
                DEADLINE_S)


def test_default_configs_are_tpusph_heuristics():
    """The capacity heuristics give tpusph's capacities (its DistConfig
    also names its mesh axis, which a line of ranks does without)."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.dist import simulator as jsimulator

    def same(got, want):
        fields = dataclasses.asdict(got)
        assert fields == {k: getattr(want, k) for k in fields}

    for n in (512, 4096, 262_144, 1_048_576):
        cfg, jcfg = ranks.default_config(n), jdefault(n)
        for d in (1, 2, 4, 8):
            same(default_dist_config(cfg, d), jsimulator.default_dist_config(jcfg, d))
        for shape in ((1, 1, 1), (2, 2, 2), (1, 2, 4)):
            same(default_mesh3d_config(cfg, shape), jsimulator.default_mesh3d_config(jcfg, shape))


def test_simulator_refuses_a_mesh_that_is_not_the_group():
    """A mesh shape whose product is not the group's size raises (tpusph
    takes the first devices of more); with no nvcc the card is refused."""
    cfg = ranks.sparse_cfg()
    with pytest.raises(ValueError, match="needs 8 ranks"):
        DistSimulator(cfg, mesh_shape=(2, 2, 2), device="cpu")
    with pytest.raises(ValueError, match="default_mesh3d_config"):
        DistSimulator(cfg, dcfg=default_dist_config(cfg, 1), mesh_shape=(1, 1, 1), device="cpu")
    sim = DistSimulator(cfg, device="cpu")
    assert sim.device.type == "cpu" and sim.topology.order == (0,)
    if not torch.cuda.is_available():
        for mesh in (None, (1, 1, 1)):
            with pytest.raises(RuntimeError, match="nvcc"):
                DistSimulator(cfg, mesh_shape=mesh)


def test_free_mode_draws_a_dist_simulator(tmp_path, capsys):
    """`-m free --frames 3 --mesh 1x1x1`: no chunk, no asynchronous fetch,
    each frame collected synchronously; the frames are those of the
    single-card engine."""
    out = tmp_path / "frames"
    rc = cli.main(["-n", "512", "--device", "cpu", "-m", "free", "--frames", "3",
                   "--mesh", "1x1x1", "--viz-chunk", "2", "--out", str(out)])
    assert rc == 0, capsys.readouterr().err
    single = tmp_path / "single"
    assert cli.main(["-n", "512", "--device", "cpu", "-m", "free", "--frames", "3",
                     "--out", str(single)]) == 0
    names = sorted(os.listdir(out))
    assert names == sorted(os.listdir(single)) and len(names) == 3
    for name in names:
        assert (out / name).read_bytes() == (single / name).read_bytes()


def test_interactive_window_takes_a_dist_simulator():
    """The window's tick is the sequential simulate, fetch, render for a
    simulator without `dispatch_chunk` (tpusph/viz/render.py:378)."""
    import matplotlib

    matplotlib.use("Agg")
    from tpusph_torch.viz import render

    sim = DistSimulator(ranks.sparse_cfg(), random_init=True, seed=3, device="cpu")
    sim.setup()
    fig, tick, pending = render._build_interactive(sim)
    before = sim.get_position().copy()
    pending["click"] = (400, 300)
    for k in range(3):
        tick(k)
    assert sim.last_aux.num_particles == 512
    assert not np.array_equal(before, sim.get_position())
    import matplotlib.pyplot as plt

    plt.close(fig)


@pytest.mark.parametrize("mesh", ["z", "1x1x1"])
def test_cli_mesh_time_mode(mesh, capsys):
    rc = cli.main(["-n", "4096", "--device", "cpu", "-m", "time", "--steps", "3",
                   "--mesh", mesh])
    out = capsys.readouterr().out
    assert rc == 0
    for row in ("Grid construction", "SPH update", "Data transfer"):
        assert out.count(row) == 1


@pytest.mark.parametrize("args", [
    ["--mesh", "2x2"], ["--mesh", "2xax2"], ["--mesh", "2x2x2"], ["--mesh", "0x1x1"],
    ["--mesh", "z", "--backend", "allpairs"],
], ids=["two_extents", "not_an_int", "not_the_group", "zero", "allpairs"])
def test_cli_refuses_a_bad_mesh(args, capsys):
    assert cli.main(["-n", "4096", "--device", "cpu", "--steps", "1", *args]) == 1
    assert "Program Options" in capsys.readouterr().out


def test_cli_mesh_save_then_load(tmp_path, capsys):
    """`--mesh z --save` writes the collected state in the format of the
    single-card engine, and `--load` without `--mesh` resumes it."""
    ckpt = str(tmp_path / "mesh.npz")
    assert cli.main(["-n", "4096", "--device", "cpu", "-m", "time", "--steps", "2",
                     "--mesh", "z", "--save", ckpt]) == 0
    state, cfg = load_state(ckpt, "cpu")
    v = state.valid.numpy()
    assert v.sum() == cfg.num_particles == 4096
    pos = state.position.numpy()[v]
    assert np.isfinite(pos).all() and pos.min() >= cfg.h - 1e-6
    assert pos.max() <= cfg.box_dim - cfg.h + 1e-6
    assert cli.main(["--load", ckpt, "--device", "cpu", "-m", "time", "--steps", "1"]) == 0
    assert "Grid construction" in capsys.readouterr().out


def test_cli_mesh_under_torchrun(tmp_path):
    """`torchrun --standalone --nproc_per_node 2 -m tpusph_torch --mesh z`
    on the CPU: both ranks join torchrun's group, rank 0 alone prints the
    Times table and writes the checkpoint."""
    ckpt = tmp_path / "run.npz"
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "tpusph_torch", "-n", "4096", "--device", "cpu", "-m", "time", "--steps", "3",
         "--mesh", "z", "--save", str(ckpt)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240,
    )
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("Grid construction") == 1, r.stdout
    state, cfg = load_state(str(ckpt), "cpu")
    assert int(state.valid.sum()) == cfg.num_particles == 4096

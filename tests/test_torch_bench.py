"""bench_torch.py, the port's headline bench, on the CPU: `state_from_fields`
against tpusph's, the gates passing and biting, the timed loop against
tpusph's `step_cell_list` chain, the script's line, its refusal to run
without a card it was not told to do without, and its sharded mode on one
rank and on two under torchrun (gloo). Bars: the bench's, positions atol
1e-4 and density rtol 1e-4."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph.engine import step as jstep
from tpusph_torch.core.config import default_config as tdefault
from tpusph_torch.core.init import init_state
from tpusph_torch.core.state import FIELDS, state_from_numpy
from tpusph_torch.engine import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

torch.set_num_threads(2)

N = 512


def _env(**kw):
    """The environment of a bench subprocess: the CPU, N = 512, 3 steps."""
    env = dict(os.environ, TPUSPH_BENCH_DEVICE="cpu", TPUSPH_BENCH_N=str(N),
               TPUSPH_BENCH_STEPS="3", OMP_NUM_THREADS="2", GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for k in ("TPUSPH_BENCH_DIST", "TPUSPH_BENCH_VERIFY", "TPUSPH_BENCH_BACKEND",
              "TPUSPH_DIST_FULL_MACHINERY"):
        env.pop(k, None)
    env.update(kw)
    return env


@pytest.fixture
def bench_env(monkeypatch):
    """The same environment for bench_torch run in this process."""
    for k, v in _env().items():
        if k.startswith(("TPUSPH_", "GLOO_")):
            monkeypatch.setenv(k, v)
    for k in ("TPUSPH_BENCH_DIST", "TPUSPH_BENCH_VERIFY", "TPUSPH_BENCH_BACKEND",
              "TPUSPH_DIST_FULL_MACHINERY", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def _last_line(out: str) -> dict:
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("given", [False, True], ids=["defaults", "density_pressure"])
def test_state_from_fields_matches_tpusph(given):
    rng = np.random.default_rng(3)
    n = 300
    rows = [rng.standard_normal(n).astype(np.float32) for _ in range(6)] + [rng.random(n) < 0.8]
    extra = {}
    if given:
        extra = {"density": rng.random(n).astype(np.float32) + 900,
                 "pressure": rng.random(n).astype(np.float32)}
    want = jstep.state_from_fields(jstep.FieldsState(*map(jnp.asarray, rows)),
                                   **{k: jnp.asarray(v) for k, v in extra.items()})
    got = tstep.state_from_fields(tstep.FieldsState(*map(torch.from_numpy, rows)),
                                  **{k: torch.from_numpy(v) for k, v in extra.items()})
    for f in FIELDS:
        w = np.asarray(getattr(want, f))
        g = getattr(got, f).numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def test_backend_names():
    """bench.py's name for its timed backend and tpusph's aliases."""
    for name in ("kernels", "pallas_sorted", "auto", "pallas"):
        assert bench_torch.bench_backend(name) == "kernels"
    assert bench_torch.bench_backend("cell_list") == "cell_list"
    assert bench_torch.bench_backend("allpairs") == "allpairs"
    with pytest.raises(ValueError, match="cell_list"):
        bench_torch.bench_backend("pallas_fields")


@pytest.mark.parametrize("backend", ["kernels", "cell_list", "allpairs"])
def test_verify_parity_passes(backend):
    assert bench_torch.verify_parity(backend, verify_steps=3, n=N, device="cpu") == "pass"


def test_verify_headline_passes():
    cfg = tdefault(N)
    assert bench_torch.verify_headline(cfg, init_state(cfg, device="cpu"), "kernels",
                                       "cpu") == "pass"


@pytest.mark.parametrize("gate", ["parity", "headline"])
def test_the_gates_bite(gate, monkeypatch, capsys):
    """A density 0.1 % off fails each gate, and the gate says why."""
    real = tstep.density
    monkeypatch.setattr(tstep, "density", lambda *a: real(*a) * 1.001)
    if gate == "parity":
        got = bench_torch.verify_parity("kernels", verify_steps=3, n=N, device="cpu")
    else:
        cfg = tdefault(N)
        got = bench_torch.verify_headline(cfg, init_state(cfg, device="cpu"), "kernels", "cpu")
    assert got == "fail"
    assert "FAIL" in capsys.readouterr().err


@pytest.mark.parametrize("random_init", [False, True], ids=["grid", "random"])
def test_timed_loop_matches_tpusph_cell_list(random_init):
    """3 steps of the timed loop (the fields chain) from tpusph's initial
    state against 3 of tpusph's `step_cell_list` steps, as multisets; the
    density at the final positions, each by its own step."""
    jcfg = jdefault(N, chunk_size=N)
    st = jinit_state(jcfg, random_init=random_init, seed=7)
    arrays = {f: np.array(getattr(st, f)) for f in FIELDS}
    jrun = jax.jit(lambda s: jstep.step_cell_list(s, jcfg))
    for _ in range(3):
        st, aux = jrun(st)
        assert int(aux.window_overflow) == 0
    jnext, _ = jrun(st)
    v = np.asarray(st.valid)
    want = bench_torch._canon(np.asarray(st.position)[v], np.asarray(jnext.density)[v])

    cfg = tdefault(N, chunk_size=N)
    final, ovf = bench_torch.run_steps(state_from_numpy(arrays, "cpu"), cfg, 3, "kernels", "cpu")
    (pos, rho), ovf2 = bench_torch.records(final, cfg, "kernels")
    assert ovf == ovf2 == 0 and len(pos) == v.sum()
    got = bench_torch._canon(pos, rho)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4, atol=0)


def test_bench_script_line():
    """`python3 bench_torch.py` on the CPU at N = 512, 3 steps, the gates
    on (verify_parity at its own N = 4096)."""
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=_env(),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    line = _last_line(r.stdout)
    assert set(line) == {"metric", "value", "unit", "parity", "device"}
    assert line["metric"] == f"torch_sph_timesteps_per_sec_n{N}"
    assert line["parity"] == "pass" and line["device"] == "cpu" and line["unit"] == "timesteps/s"
    assert line["value"] > 0


def test_bench_without_a_card_exits_2():
    """No card and no TPUSPH_BENCH_DEVICE=cpu: exit 2, no line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    env = _env()
    env.pop("TPUSPH_BENCH_DEVICE")
    r = subprocess.run([sys.executable, "bench_torch.py"], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and r.stdout == ""
    assert "TPUSPH_BENCH_DEVICE=cpu" in r.stderr


def test_bench_cell_list_backend_in_process(bench_env, capsys):
    bench_env.setenv("TPUSPH_BENCH_BACKEND", "cell_list")
    bench_env.setenv("TPUSPH_BENCH_VERIFY", "0")
    bench_torch.main()
    line = _last_line(capsys.readouterr().out)
    assert line["metric"] == f"torch_sph_timesteps_per_sec_n{N}"
    assert line["parity"] == "skipped" and line["value"] > 0


@pytest.mark.parametrize("full,migsort", [("0", "0"), ("1", "0"), ("1", "1")],
                         ids=["elided", "full_machinery", "full_machinery_migsort"])
def test_dist_bench_one_rank(full, migsort, bench_env, tmp_path, capsys):
    """One rank of the sharded bench: its line, and its artifact named by
    what ran: `_FULL` the whole machinery with the migration-free sort
    skip live, `_FULL_MIGSORT` with TPUSPH_DIST_FORCE_MIGSORT=1."""
    bench_env.setenv("TPUSPH_BENCH_DIST", "1")
    bench_env.setenv("TPUSPH_DIST_FULL_MACHINERY", full)
    bench_env.setenv("TPUSPH_DIST_FORCE_MIGSORT", migsort)
    bench_env.setenv("TPUSPH_BENCH_ARTIFACT_DIR", str(tmp_path))
    bench_torch.main()
    line = _last_line(capsys.readouterr().out)
    assert line["metric"] == f"torch_sph_dist_timesteps_per_sec_n{N}_r1"
    assert line["parity"] == "pass" and line["device"] == "cpu" and line["value"] > 0
    suffix = {("0", "0"): "", ("1", "0"): "_FULL", ("1", "1"): "_FULL_MIGSORT"}[full, migsort]
    name = f"TORCH_DIST_BENCH{suffix}_n{N}.json"
    assert os.listdir(tmp_path) == [name]
    art = json.loads((tmp_path / name).read_text())
    assert {k: art[k] for k in line} == line
    assert art["full_machinery"] is (full == "1") and art["right_sized"] is True
    assert art["force_migsort"] is (migsort == "1") and art["device_busy"] is None
    assert art["ranks"] == 1 and art["steps"] == 3 and art["backend"] == "kernels"
    assert art["dev_capacity"] >= N and art["slack"] is None


@pytest.mark.parametrize("asked,world", [("2", None), ("1", "2")])
def test_dist_bench_refuses_another_rank_count(asked, world, bench_env, capsys):
    bench_env.setenv("TPUSPH_BENCH_DIST", asked)
    if world is not None:
        bench_env.setenv("WORLD_SIZE", world)
    with pytest.raises(SystemExit) as e:
        bench_torch.main()
    assert e.value.code == 2
    assert "torchrun --nproc_per_node" in capsys.readouterr().err


def test_dist_bench_two_ranks_under_torchrun(tmp_path):
    env = _env(TPUSPH_BENCH_DIST="2", TPUSPH_BENCH_ARTIFACT_DIR=str(tmp_path),
               TPUSPH_BENCH_DIST_SLACK="2.0")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           "2", "bench_torch.py"]
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    assert r.stdout.count("torch_sph_dist") == 1, r.stdout  # rank 0 alone prints
    line = _last_line(r.stdout)
    assert line["metric"] == f"torch_sph_dist_timesteps_per_sec_n{N}_r2"
    assert line["parity"] == "pass"
    art = json.loads((tmp_path / f"TORCH_DIST_BENCH_n{N}.json").read_text())
    assert art["ranks"] == 2 and art["slack"] == 2.0 and art["right_sized"] is False
    for k in ("dev_capacity", "halo_capacity", "migration_capacity"):
        assert art[k] > 0, k
    # a rank count that is not torchrun's: every rank exits 2
    env["TPUSPH_BENCH_DIST"] = "3"
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "asks for 3 ranks" in r.stderr

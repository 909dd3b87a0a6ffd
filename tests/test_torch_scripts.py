"""The port's measurement scripts on the CPU, where they time nothing:
`build_bench`'s three starts tables are one table, `fields_profile`'s
stages composed are the fields step bit for bit, `freemode_bench` runs
every mode and restores the environment, and `dist_scale_check` holds
its counters on four gloo ranks. Their `main` times the card and refuses
to run without one."""

import os
import sys

import numpy as np
import pytest
import torch

from tpusph.core.config import default_config as jdefault
from tpusph.core.init import init_state as jinit_state
from tpusph_torch.core.config import default_config
from tpusph_torch.core.state import FIELDS, state_from_numpy
from tpusph_torch.engine.step import fields_from_state, make_fields_chain, step_kernels_fields
from tpusph_torch.neighbors.cell_list import starts_table
from tpusph_torch.scripts import build_bench, dist_scale_check, fields_profile, freemode_bench

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_ranks import one_thread  # noqa: E402,F401

N = 4096


def _fields(random_init: bool, steps: int = 0):
    """tpusph's initial state at N, carried over, after `steps` fields steps."""
    st = jinit_state(jdefault(N), random_init=random_init, seed=11)
    fs = fields_from_state(state_from_numpy({f: np.array(getattr(st, f)) for f in FIELDS}, "cpu"))
    if steps:
        fs, _ = make_fields_chain(default_config(N), steps, "cpu")(fs)
    return fs


@pytest.mark.parametrize("random_init", [False, True], ids=["grid", "random"])
def test_build_bench_starts_tables_agree(random_init):
    cfg = default_config(N)
    fs = _fields(random_init)
    key, _ = build_bench.compute_keys_fields(fs.x, fs.y, fs.z, fs.valid, cfg)
    key_sorted = torch.sort(key, stable=True).values
    tables = build_bench.starts_tables(cfg, key, key_sorted)
    assert set(tables) == {"hist+cumsum", "rank", "searchsorted"}
    want = starts_table(key, cfg)
    for name, table in tables.items():
        assert table.dtype == torch.int32 and torch.equal(table, want), name
    alts = build_bench.alternatives(cfg, fs, key, key_sorted)
    assert list(alts) == ["sort", "hist", "hist_s", "cumsum", "rank", "ssorted"]
    assert torch.equal(alts["ssorted"](), want) and torch.equal(alts["rank"]()[0], want)
    ks, rows = alts["sort"]()
    assert torch.equal(ks, key_sorted) and torch.equal(rows[0], fs.x[torch.sort(key, stable=True)[1]])


@pytest.mark.parametrize("random_init,steps", [(False, 0), (False, 5), (True, 0)],
                         ids=["grid0", "grid5", "random0"])
def test_fields_profile_stages_compose_to_the_step(random_init, steps):
    cfg = default_config(N)
    fs = _fields(random_init, steps)
    fns = fields_profile.stages(cfg)
    assert tuple(fns) == fields_profile.STAGES
    sf = fns["build"](fs)
    raw = fns["density"](sf)
    rho, p = fns["press"](raw, sf.valid_sorted)
    fxyz = fns["force"](sf, rho, p)
    out = fns["integ"](sf, fxyz, rho)
    (want, w_rho, w_p, w_f), _ = step_kernels_fields(fs, cfg)
    for a, b in zip((*out, rho, p, *fxyz), (*want, w_rho, w_p, *w_f)):
        assert torch.equal(a, b)
    args = fields_profile.stage_inputs(fs, cfg)
    assert set(args) == set(fields_profile.STAGES)
    assert torch.equal(fns["integ"](*args["integ"]).x, want.x)


@pytest.mark.parametrize("mode", [m[0] for m in freemode_bench.MODES])
def test_freemode_bench_modes_run(mode, monkeypatch):
    monkeypatch.setenv("TPUSPH_VIZ_PACK", "0")
    monkeypatch.delenv("TPUSPH_VIZ_SYNC", raising=False)
    name, sync, chunk, pack = next(m for m in freemode_bench.MODES if m[0] == mode)
    assert freemode_bench.run(512, 16, sync, chunk, pack, device="cpu") > 0
    assert os.environ["TPUSPH_VIZ_PACK"] == "0" and "TPUSPH_VIZ_SYNC" not in os.environ


@pytest.mark.parametrize("sync", [True, False], ids=["sync", "pipe"])
def test_freemode_bench_interactive_ticks(sync):
    pytest.importorskip("matplotlib")
    assert freemode_bench.run_interactive(512, 3, sync, device="cpu") > 0


@pytest.mark.parametrize("script", [build_bench, fields_profile, freemode_bench])
def test_scripts_need_a_card(script):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        script.main(["512"])


def test_dist_scale_check_four_ranks(capfd):
    dist_scale_check.main(["8192", "2", "4"])
    out = capfd.readouterr().out
    assert "step 1:" in out and "OK: 2 steps at N=8192 on 4 ranks" in out

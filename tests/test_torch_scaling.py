"""The port's slab census and scaling model
(`tpusph_torch/scripts/slab_census.py`, `scaling_model.py`) against
tpusph's (`scripts/slab_census.py`, `scripts/scaling_model.py`): the
census is physics, so the port's function equals tpusph's on the same
snapshots and its trajectory reproduces tpusph's `scaling/census_n8192.json`;
the model, fed tpusph's v5e inputs, gives tpusph's tables row for row, and
on the port's own artifacts (`TORCH_DIST_BENCH*.json`, `scaling_torch/`)
its fit holds its measured points and its bytes are the exchange's.
Everything runs on the CPU.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from tpusph_torch.core.config import tuned_config
from tpusph_torch.core.init import grid_positions
from tpusph_torch.dist import sharded
from tpusph_torch.dist.multislice import halo_bytes_per_boundary
from tpusph_torch.scripts import scaling_model, slab_census

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCALING = os.path.join(ROOT, "scaling")
CENSUS_STEPS = 20  # steps of the CPU census held against census_n8192.json


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_census():
    """tpusph's census script, loaded as `tests/test_scaling_model.py`
    loads the model. At import it parses sys.argv and points jax's
    compilation cache at a directory of its own: sys.argv is the script's
    name alone and those two updates are not made, so nothing is written."""
    import jax

    mp = pytest.MonkeyPatch()
    update = jax.config.update
    skip = {"jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs"}
    mp.setattr(jax.config, "update", lambda k, v: None if k in skip else update(k, v))
    mp.setattr(sys, "argv", ["slab_census.py"])
    try:
        yield _load_script("slab_census")
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def jax_model():
    return _load_script("scaling_model")


def _snapshot(kind: str, n: int):
    """(z, vz) of n live rows: the grid lattice, uniform random rows, or
    rows crowded at the slab cuts and their bands with large vz, so that
    rows cross in the next step."""
    rng = np.random.default_rng(n)
    if kind == "grid":
        z = grid_positions(tuned_config(n))[:, 2]
    elif kind == "random":
        z = rng.uniform(1.0, 9.0, n).astype(np.float32)
    else:
        cuts = np.array([2.5, 5.0, 7.5, 1.25, 3.75, 6.25, 8.75], np.float32)
        z = (rng.choice(cuts, n) + rng.normal(0, 0.15, n)).astype(np.float32)
        z = np.clip(z, 0.0, np.float32(9.999))
    vz = rng.normal(0, 3.0, n).astype(np.float32)
    return z, vz


@pytest.mark.parametrize("kind,n", [("grid", 8192), ("random", 5000), ("cuts", 20000)])
def test_census_equals_tpusph(jax_census, kind, n):
    """`census()` and the balanced planes on seeded snapshots: equal to
    tpusph's, the "bal" sub-census included."""
    from tpusph.core.config import default_config as jdefault
    from tpusph.dist.sharded import balanced_slab_planes as jplanes

    z, vz = _snapshot(kind, n)
    cfg, jcfg = tuned_config(n), jdefault(n)
    planes = {d: sharded.balanced_slab_planes(z, cfg, d) for d in slab_census.DS}
    assert planes == {d: jplanes(z, jcfg, d) for d in slab_census.DS}
    got = slab_census.census(z, vz, cfg, planes)
    assert got == jax_census.census(z, vz, jcfg, planes)
    assert slab_census.census(z, vz, cfg) == jax_census.census(z, vz, jcfg)
    if kind == "cuts":
        assert all(got[str(d)]["max_migration"] > 0 for d in slab_census.DS)


def test_census_script_reproduces_tpusph_n8192(tmp_path, monkeypatch):
    """The script at 8,192 grid init on the CPU (`step_cell_list`), 20
    steps in chunks of 10, written under TPUSPH_BENCH_ARTIFACT_DIR:
    tpusph's balanced planes, its step-0 row exactly, and its rows at
    steps 10 and 20 within `slab_census.compare`'s bars (imbalance within
    0.002, the halo send within 1 %, the migration equal)."""
    torch.set_num_threads(2)
    monkeypatch.setenv("TPUSPH_BENCH_ARTIFACT_DIR", str(tmp_path))
    out = slab_census.main(["8192", str(CENSUS_STEPS), "10", "--device", "cpu"])
    assert os.listdir(tmp_path) == ["census_n8192.json"]
    assert json.loads((tmp_path / "census_n8192.json").read_text()) == out
    want = scaling_model.load_json(os.path.join(SCALING, "census_n8192.json"))
    assert out["backend"] == "cell_list" and out["device"] == "cpu" and out["init"] == "grid"
    assert out["bal_planes"] == want["bal_planes"] and out["band_2h"] == want["band_2h"]
    assert out["rows"][0] == want["rows"][0]
    want["rows"] = [r for r in want["rows"] if r["step"] <= CENSUS_STEPS]
    assert slab_census.compare(out, want) == []


@pytest.mark.parametrize("kind", ["FULL", "FULL_SKIP"])
def test_model_fits_tpusph_taxes(jax_model, kind):
    """The port's `machinery_tax_fit` on tpusph's artifacts and tier
    table is tpusph's: the same points and exponent, the same law."""
    got, pts, p = scaling_model.machinery_tax_fit(
        lambda n: os.path.join(SCALING, f"DIST_{kind}_n{n}.json"), jax_model.TIER_MS)
    want, wpts, wp = jax_model.machinery_tax_fit(kind)
    assert pts == wpts and p == wp
    for n in (50_000, 262_144, 2_000_000):
        assert got(n) == want(n)


@pytest.mark.parametrize("variant", ["bal", "eq"])
def test_model_projects_tpusph_tables(jax_model, variant):
    """Fed tpusph's inputs (its census and tier table, 45e9 B/s, 1e-6 s, 4
    collectives, its capacity rule and its 25 / 29 bytes a row), the
    port's `project` gives tpusph's rows, row for row, at every tier
    with a census."""
    from tpusph.dist.multislice import halo_bytes_per_boundary as jbytes

    tf, _, _ = jax_model.machinery_tax_fit("FULL")
    ts, _, _ = jax_model.machinery_tax_fit("FULL_SKIP")
    tiers = [n for n in sorted(jax_model.TIER_MS)
             if os.path.exists(os.path.join(SCALING, f"census_n{n}.json"))]
    assert len(tiers) >= 4
    for n in tiers:
        want = jax_model.project(n, tf, ts, variant)
        got = scaling_model.project(
            n, tf, ts, variant, tier_ms=jax_model.TIER_MS, census_dir=SCALING,
            link_bytes_per_s=45e9, link_latency_s=1e-6, collectives=4,
            capacity=lambda rows: max(256, int(rows * jax_model.RIGHT_SIZE_MARGIN)),
            wire_bytes=jbytes)
        assert {k: got[k] for k in ("n", "census_init", "partition")} == {
            k: want[k] for k in ("n", "census_init", "partition")}
        rename = lambda r: {("ici_us" if k == "link_us" else k): v for k, v in r.items()}
        assert [rename(r) for r in got["rows"]] == want["rows"]


def _port_taxes():
    tier = scaling_model.tier_ms_from_artifacts()
    fits = {kind: scaling_model.machinery_tax_fit(
        lambda n, s=suffix: scaling_model.bench_artifact(n, s), tier)
        for kind, suffix in (("migsort", "_FULL_MIGSORT"), ("skip", "_FULL"))}
    return tier, fits


@pytest.mark.parametrize("kind", ["migsort", "skip"])
def test_port_tax_fit_holds_its_points(kind):
    """On the card's artifacts each tax law passes through its two
    measured points, both positive, and is monotone in the occupancy.
    No bound on the exponent, not even its sign: the eager machinery's
    tax is mostly the host's launches, nearly flat in N, and the two
    points are single timed runs of a host-bound loop."""
    _, fits = _port_taxes()
    tax, pts, p = fits[kind]
    assert [n for n, _ in pts] == list(scaling_model.TIERS)
    for n, t in pts:
        assert t > 0 and tax(n) == pytest.approx(t, rel=1e-12)
    occ = [tax(n) for n in (50_000, 500_000, 2_000_000)]
    assert all(t > 0 for t in occ)
    assert occ == sorted(occ, reverse=p < 0)


def test_port_projection_is_the_committed_one(tmp_path):
    """The model on the repo's artifacts and census reproduces the
    committed `scaling_torch/PROJECTION.json`; every row's wire bytes are
    the port's exchange at the row's capacities, and the capacities are
    multiples of 256 (`DistSimulator.right_size`)."""
    out = scaling_model.main([], out_dir=str(tmp_path))
    committed = scaling_model.load_json(os.path.join(scaling_model.SCALING, "PROJECTION.json"))
    assert out == committed
    assert out["tables"] and len(out["tables"]) == len(out["tables_equal_width"])
    for tbl in out["tables"] + out["tables_equal_width"]:
        assert [r["d"] for r in tbl["rows"]] == [1, 2, 4, 8]
        for r in tbl["rows"][1:]:
            assert r["wire_bytes"] == halo_bytes_per_boundary(r["halo_cap"], r["mig_cap"])
            assert r["halo_cap"] % 256 == 0 and r["mig_cap"] % 256 == 0
    assert "assumed" in out["link_assumption"]["what"]

"""The rate probes' plain PyTorch versions (tpusph_torch.kernels.probes,
CPU tensors) against the TPU kernels of scripts/vpu_microbench.py and
scripts/loop_probe.py, run with `pl.pallas_call(..., interpret=True)` at
small sizes: 64 rounds, pt 8, the loop probe at bl 256.

Bars: f32 FMA and f32 density mix rtol 1e-5 (rounding of long chains of
separately rounded ops in another order; 2e-6 seen); bf16 FMA exact
(bf16(1.0000001) = 1, and 1e-9 is below half an ulp); bf16 density mix
bit-equal (every op rounds to bf16 in both); loop probe V0–V5 rtol 1e-5.
The loop probe's own inputs, uniform(1, 9), put no pair within h and make
every output 0, so the inputs here are uniform(1, 1.05), where every
output is non-zero; the density mix gets key columns in {0, 1, 2}, so that
the key compare rejects some pairs.

The CUDA density mix takes several rounds at once and adds their terms in
round order. What lets it do that is held here on the plain version: the
sum over a + b rounds is the sum over a rounds continued by b ordered adds
of one round's term (bf16 bit-equal, f32 too: the same adds in the same
order).

The CUDA loop probe walks one 32-lane slice of the columns at a time, reads
its candidates from a table staged for that slice, and takes several rounds
at once before a loop of single rounds. `probes.loop_probe_walk` is that
walk in plain PyTorch and equals `loop_probe_plain` bit for bit (the same
ops on the same values in the same order; the CPU fuses no multiply and
add); the constants it shares with `csrc/probes.cu` are read from the
source."""

import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tpusph_torch.kernels import probes

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = 64
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def scripts():
    """The two TPU scripts, loaded by path. Loading them points JAX's
    compilation cache elsewhere; both settings are put back at once."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    mods = {}
    try:
        for name in ("vpu_microbench", "loop_probe"):
            spec = importlib.util.spec_from_file_location(
                f"_tpu_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return mods


def _to_torch(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


@pytest.mark.parametrize("streams", probes.FMA_STREAMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_fma_probe_matches_tpu_kernel(scripts, dtype, streams):
    tdt, jdt = DTYPES[dtype]
    x = np.random.default_rng(streams).uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    k = pl.pallas_call(
        scripts["vpu_microbench"].make_fma_kernel(jdt, ROUNDS, streams),
        out_shape=jax.ShapeDtypeStruct(xj.shape, jdt), interpret=True)
    ref = np.asarray(jnp.asarray(k(xj), jnp.float32))
    got = probes.fma_probe(_to_torch(np.asarray(xj.astype(jnp.float32)), tdt), streams, ROUNDS)
    assert got.dtype == tdt and got.shape == (8, 128)
    rtol = 1e-5 if dtype == "float32" else 0
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=rtol, atol=0)


def _fused_fma_chains(x: np.ndarray, streams: int, rounds: int) -> np.ndarray:
    """The f32 FMA probe with every a·c1 + c2 fused: exact in float64
    (a·c1 has 48 bits), then rounded once to float32."""
    c1, c2 = np.float64(np.float32(1.0000001)), np.float64(np.float32(1e-9))
    accs = np.stack([x + np.float32(k) for k in range(streams)]).astype(np.float64)
    for _ in range(rounds):
        accs = (accs * c1 + c2).astype(np.float32).astype(np.float64)
    accs = accs.astype(np.float32)
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


@pytest.mark.parametrize("tie_free", [True, False], ids=["tie-free", "uniform"])
def test_fma_tie_free_input_makes_fused_and_split_agree(tie_free):
    """On fma_tie_free_input a fused and a split multiply-add give the same
    bits over 2,000 rounds; on plain uniform inputs they do not."""
    rounds, streams = 2000, 8
    if tie_free:
        x = probes.fma_tie_free_input((8, 128), 3, rounds)
    else:
        x = torch.from_numpy(np.random.default_rng(3).uniform(0.5, 2.0, (8, 128)).astype(np.float32))
    fused = _fused_fma_chains(x.numpy(), streams, rounds)
    assert np.array_equal(probes.fma_probe_plain(x, streams, rounds).numpy(), fused) == tie_free


@pytest.mark.parametrize("streams", probes.FMA_STREAMS)
def test_fma_probe_runs_every_round_of_tpu_kernel(scripts, streams):
    """f32 at 2,000 rounds on tie-free inputs: bit-equal to the TPU kernel,
    and one round fewer is not (at 64 rounds rtol 1e-5 cannot tell)."""
    rounds = 2000
    x = probes.fma_tie_free_input((8, 128), streams, rounds)
    k = pl.pallas_call(
        scripts["vpu_microbench"].make_fma_kernel(jnp.float32, rounds, streams),
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)
    ref = np.asarray(k(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(probes.fma_probe(x, streams, rounds).numpy(), ref)
    assert not np.array_equal(probes.fma_probe(x, streams, rounds - 1).numpy(), ref)


def _mix_inputs(pt, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1.0, 1.05, (max(pt, 8), 4))
    c = rng.uniform(1.0, 1.05, (8, 128))
    t[:, 3] = rng.integers(0, 3, t.shape[0])
    c[3] = rng.integers(0, 3, 128)
    return t.astype(np.float32), c.astype(np.float32)


@pytest.mark.parametrize("pt", [8, 16])
@pytest.mark.parametrize("dtype", DTYPES)
def test_density_mix_matches_tpu_kernel(scripts, dtype, pt):
    tdt, jdt = DTYPES[dtype]
    t, c = _mix_inputs(pt, pt)
    tj, cj = jnp.asarray(t, jdt), jnp.asarray(c, jdt)
    k = pl.pallas_call(
        scripts["vpu_microbench"].make_density_mix_kernel(jdt, pt, ROUNDS),
        out_shape=jax.ShapeDtypeStruct((pt, 128), jnp.float32), interpret=True)
    ref = np.asarray(k(tj, cj))
    got = probes.density_mix(
        _to_torch(np.asarray(tj.astype(jnp.float32)), tdt),
        _to_torch(np.asarray(cj.astype(jnp.float32)), tdt), pt, ROUNDS)
    assert got.dtype == torch.float32 and got.shape == (pt, 128)
    assert (ref == 0).any() and (ref != 0).any()  # the masks cut some lanes
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("a,b", [(1, 0), (1, 7), (8, 3), (16, 8), (64, 3)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_density_mix_continues_in_round_order(dtype, a, b):
    tdt, _ = DTYPES[dtype]
    pt = 8
    t, c = _mix_inputs(pt, a + b)
    t, c = _to_torch(t, tdt), _to_torch(c, tdt)
    term = probes.density_mix_plain(t, c, pt, 1).to(tdt)  # 0 + term = term
    assert (term == 0).any() and (term != 0).any()
    cont = probes.density_mix_plain(t, c, pt, a).to(tdt)  # exact: acc is in tdt
    for _ in range(b):
        cont = cont + term
    whole = probes.density_mix_plain(t, c, pt, a + b)
    assert torch.equal(whole, cont.to(torch.float32))
    if b:  # one round fewer shows in the sum
        assert not torch.equal(whole, probes.density_mix_plain(t, c, pt, a + b - 1))


def _loop_inputs(pt, bl, cap, rounds, seed):
    rng = np.random.default_rng(seed)
    t = rng.uniform(1.0, 1.05, (max(pt, 8), 4)).astype(np.float32)
    cand = rng.uniform(1.0, 1.05, (8, cap)).astype(np.float32)
    desc = np.zeros((rounds + 8,), np.int16)
    desc[:rounds] = rng.integers(0, (cap - bl) // 128, rounds)
    desc[rounds] = rounds
    return desc, t, cand


@pytest.mark.parametrize("variant", list(probes.VARIANTS))
def test_loop_probe_matches_tpu_kernel(scripts, variant):
    pt, bl, cap = 8, 256, 1024
    desc, t, cand = _loop_inputs(pt, bl, cap, ROUNDS, 0)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(1,),
        in_specs=[
            pl.BlockSpec(t.shape, lambda i, *_: (0, 0)),
            pl.BlockSpec(cand.shape, lambda i, *_: (0, 0)),
        ],
        out_specs=pl.BlockSpec((pt, bl), lambda i, *_: (0, 0)),
    )
    k = pl.pallas_call(
        scripts["loop_probe"].make_kernel(variant, pt, bl, ROUNDS),
        out_shape=jax.ShapeDtypeStruct((pt, bl), jnp.float32),
        grid_spec=grid_spec, interpret=True)
    ref = np.asarray(k(jnp.asarray(desc), jnp.asarray(t), jnp.asarray(cand)))
    got = probes.loop_probe(variant, torch.from_numpy(desc), torch.from_numpy(t),
                            torch.from_numpy(cand), pt, bl)
    assert got.dtype == torch.float32 and got.shape == (pt, bl)
    assert (ref != 0).all()
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=0)


def test_loop_probe_dynamic_trip_reads_the_table():
    """V2 runs desc[rounds] blocks, not rounds: halving that entry halves
    every sum of the static-load variant exactly."""
    pt, bl = 8, 256
    desc, t, cand = _loop_inputs(pt, bl, 512, 8, 1)
    args = (torch.from_numpy(t), torch.from_numpy(cand), pt, bl)
    full = probes.loop_probe("V2", torch.from_numpy(desc), *args)
    desc[8] = 4
    half = probes.loop_probe("V2", torch.from_numpy(desc), *args)
    np.testing.assert_allclose(half.numpy() * 2, full.numpy(), rtol=1e-6)


def _loop_tensors(pt, bl, cap, rounds, trip, seed):
    desc, t, cand = _loop_inputs(pt, bl, cap, rounds, seed)
    desc[:rounds] = np.random.default_rng(seed + 1).integers(0, (cap - bl) // 128 + 1, rounds)
    desc[rounds] = trip
    return torch.from_numpy(desc), torch.from_numpy(t), torch.from_numpy(cand)


@pytest.mark.parametrize("rounds,trip", [(1, 1), (64, 41), (64, 64), (67, 67)])
@pytest.mark.parametrize("variant", list(probes.VARIANTS))
def test_loop_probe_walk_equals_plain(variant, rounds, trip):
    """The kernel's walk (slices of 32 lanes, the staged table or cand
    itself, rounds taken several at once and added in round order, then one
    by one) gives the plain version's bits: 1 round runs the single-round
    loop alone, 64 the other alone, 41 of 64 and 67 both; desc reaches the
    last block offset that fits."""
    pt, bl, cap = 5, 64, 512
    desc, t, cand = _loop_tensors(pt, bl, cap, rounds, trip, rounds)
    want = probes.loop_probe_plain(variant, desc, t, cand, pt, bl)
    # V4 takes its blocks two by two: none of 1, 40 of 41
    assert (want != 0).all() or (variant == "V4" and trip == 1 and (want == 0).all())
    assert probes.loop_stage_blocks(variant, cand, bl) == (4 if probes.VARIANTS[variant][1] else 1)
    assert torch.equal(probes.loop_probe_walk(variant, desc, t, cand, pt, bl), want)
    # a cand 4 bytes off a 16-byte boundary is not staged: the walk reads cand itself
    off = torch.empty(8 * cap + 1)[1:].view(8, cap).copy_(cand)
    assert probes.loop_stage_blocks(variant, off, bl) == 0
    assert torch.equal(probes.loop_probe_walk(variant, desc, t, off, pt, bl), want)


@pytest.mark.parametrize("targets", [2, 4])
def test_loop_probe_walk_with_several_targets_a_thread(monkeypatch, targets):
    """Targets that share a thread share its loads, and each keeps its own
    sum: the same bits for any group size, a last group short of it too."""
    monkeypatch.setattr(probes, "LOOP_TARGETS", targets)
    pt, bl, cap = 5, 64, 512
    desc, t, cand = _loop_tensors(pt, bl, cap, 67, 67, 3)
    for variant in ("V3", "V4", "V5"):
        assert torch.equal(probes.loop_probe_walk(variant, desc, t, cand, pt, bl),
                           probes.loop_probe_plain(variant, desc, t, cand, pt, bl))


def test_loop_probe_walk_takes_columns_off_a_slice():
    """bl = 40 is no multiple of 32: nothing is staged and the last slice
    is 8 lanes wide."""
    pt, bl, cap = 3, 40, 512
    desc, t, cand = _loop_tensors(pt, bl, cap, 20, 20, 4)
    assert probes.loop_stage_blocks("V3", cand, bl) == 0
    assert torch.equal(probes.loop_probe_walk("V3", desc, t, cand, pt, bl),
                       probes.loop_probe_plain("V3", desc, t, cand, pt, bl))


def test_loop_stage_blocks():
    """What the kernel stages: every block offset that fits (cap − bl) / 128
    + 1 for the desc-driven loads, offset 0 alone for the static ones, and
    nothing where the copies would split 16 bytes or outgrow a block's
    shared memory."""
    cand = torch.zeros(8, 16384)
    assert probes.loop_stage_blocks("V3", cand, 256) == 127
    assert 3 * 127 * 128 <= 48 * 1024  # no more than a kernel may take unasked
    assert [probes.loop_stage_blocks(v, cand, 256) for v in probes.VARIANTS] == [
        1, 127, 1, 127, 127, 127]
    assert probes.loop_stage_blocks("V3", torch.zeros(8, 512), 256) == 3
    assert probes.loop_stage_blocks("V3", torch.zeros(8, 256), 256) == 1
    assert probes.loop_stage_blocks("V3", cand, 40) == 0  # columns off a slice
    assert probes.loop_stage_blocks("V3", torch.zeros(8, 510), 256) == 0  # rows off 16 bytes
    off = torch.zeros(8 * 512 + 1)[1:].view(8, 512)
    assert off.data_ptr() % 16 == 4 and probes.loop_stage_blocks("V3", off, 256) == 0
    wide = torch.zeros(8, 131072)
    assert probes.loop_stage_blocks("V3", wide, 256) == 0  # 393 KB of table
    assert probes.loop_stage_blocks("V0", wide, 256) == 1
    widest = (probes.LOOP_STAGE_MAX // 384 - 1) * 128 + 256
    assert probes.loop_stage_blocks("V3", torch.zeros(8, widest), 256) == probes.LOOP_STAGE_MAX // 384
    assert probes.loop_stage_blocks("V3", torch.zeros(8, widest + 128), 256) == 0


def test_loop_probe_constants_mirror_the_source():
    """probes.LOOP_* and the static trip counts are those of the CUDA
    sources."""
    csrc = os.path.join(REPO, "tpusph_torch", "csrc")
    with open(os.path.join(csrc, "probes.cu")) as f:
        src = f.read()
    names = {"kLoopUnroll": probes.LOOP_UNROLL, "kLoopWarps": probes.LOOP_WARPS, "kLoopTargets": probes.LOOP_TARGETS,
             "kLoopStageMax": probes.LOOP_STAGE_MAX}
    for name, value in names.items():
        found = re.findall(rf"constexpr int {name} = (\d+);", src)
        assert found == [str(value)], name
    assert probes.LOOP_UNROLL % 8 == 0
    assert probes.LOOP_STAGE_MAX == 227 * 1024  # what a block may take on the H100

    def cases(text, fn):
        body = text[text.index(f"cudaError_t {fn}("):]
        body = body[:body.index("default:")]
        return tuple(int(n) for n in re.findall(r"case (\d+):", body))

    assert cases(src, "launch_static_trip") == probes.STATIC_ROUNDS


@pytest.mark.parametrize(
    "call",
    [
        lambda: probes.fma_probe(torch.ones(8, 128, dtype=torch.float64), 1, 4),
        lambda: probes.fma_probe(torch.ones(8, 128), 3, 4),
        lambda: probes.density_mix(torch.ones(4, 4), torch.ones(8, 128), 8, 4),
        lambda: probes.density_mix(torch.ones(8, 4), torch.ones(8, 128, dtype=torch.bfloat16), 8, 4),
        lambda: probes.loop_probe("V9", torch.zeros(12, dtype=torch.int16),
                                  torch.ones(8, 4), torch.ones(8, 256), 8, 256),
        lambda: probes.loop_probe("V0", torch.zeros(12, dtype=torch.int32),
                                  torch.ones(8, 4), torch.ones(8, 256), 8, 256),
        lambda: probes.loop_probe("V0", torch.zeros(12, dtype=torch.int16),
                                  torch.ones(8, 4), torch.ones(8, 128), 8, 256),
    ],
    ids=["fma-dtype", "fma-streams", "mix-rows", "mix-mixed-dtypes", "loop-variant",
         "loop-desc-dtype", "loop-narrow-cand"],
)
def test_probe_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()

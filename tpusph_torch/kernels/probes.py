"""Rate probes: the FMA chain, the density inner loop's op mix and the
loop-overhead variants V0–V5, timed by the slope over the round count.

Counterparts of the TPU microbenchmark kernels `make_fma_kernel` and
`make_density_mix_kernel` (`scripts/vpu_microbench.py`) and `make_kernel`
(`scripts/loop_probe.py`). The CUDA kernels are in
`tpusph_torch/csrc/probes.cu`; `fma_probe_plain`, `density_mix_plain` and
`loop_probe_plain` are the same functions in plain PyTorch, Python loops
over the rounds of the same tensor ops in the same dtype. The wrappers
take the plain version for CPU tensors and launch the kernel for CUDA
tensors. `loop_probe_walk` is the loop probe's kernel in plain PyTorch:
its staged tables, its rounds in flight and its targets a thread.
"""

from __future__ import annotations

import torch

from tpusph_torch.kernels.launch import check_tensor, on_cpu, stream_of

DTYPES = (torch.float32, torch.bfloat16)
FMA_STREAMS = (1, 4, 8)
LANES = 128  # the density mix's candidate block width

# variant → (dynamic trip, dynamic load, unroll, force mix), loop_probe.py:55-58
VARIANTS = {
    "V0": (False, False, 1, False),
    "V1": (False, True, 1, False),
    "V2": (True, False, 1, False),
    "V3": (True, True, 1, False),
    "V4": (True, True, 2, False),
    "V5": (True, True, 1, True),
}
# V0 and V1 take their trip count at compile time; these are the counts the
# kernel library instantiates: short checks (one round, a multiple of the
# rounds in flight and one that is none) and loop_probe.py's R and 4R.
STATIC_ROUNDS = (1, 64, 67, 4096, 16384)
# The loop probe's shape, csrc/probes.cu's constants of the same names.
LOOP_UNROLL = 32  # kLoopUnroll: rounds in flight a thread
LOOP_WARPS = 2  # kLoopWarps: warps a block, all on one 32-lane slice
LOOP_TARGETS = 1  # kLoopTargets: targets a thread
LOOP_STAGE_MAX = 232448  # kLoopStageMax: bytes of shared memory a block may stage


def _check_dtype(name, t: torch.Tensor) -> None:
    if t.dtype not in DTYPES:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32 or bfloat16")


# ---------------------------------------------------------------- FMA probe


def fma_probe_plain(x: torch.Tensor, streams: int, rounds: int) -> torch.Tensor:
    """`streams` chains a ← a·c1 + c2 (c1 = 1.0000001, c2 = 1e-9 in x's
    dtype) from a = x + k, over `rounds`; their sum in order of k."""
    c1 = torch.tensor(1.0000001, dtype=x.dtype, device=x.device)
    c2 = torch.tensor(1e-9, dtype=x.dtype, device=x.device)
    accs = [x + torch.tensor(k, dtype=x.dtype, device=x.device) for k in range(streams)]
    for _ in range(rounds):
        accs = [a * c1 + c2 for a in accs]
    out = accs[0]
    for a in accs[1:]:
        out = out + a
    return out


def fma_probe(x: torch.Tensor, streams: int, rounds: int) -> torch.Tensor:
    """The FMA probe on a 2-D block `x` (f32 or bf16; see `fma_probe_plain`).
    Launches `tpusph_fma_probe` for CUDA tensors: one guaranteed FMA per
    chain and round (bf16: packed, two elements per thread)."""
    dev = x.device
    _check_dtype("x", x)
    check_tensor("x", x, x.dtype, dev, tuple(x.shape))
    if streams not in FMA_STREAMS:
        raise ValueError(f"streams must be one of {FMA_STREAMS}, got {streams}")
    if on_cpu(dev):
        return fma_probe_plain(x, streams, rounds)
    if x.dtype == torch.bfloat16 and x.numel() % 2:
        raise ValueError("the bf16 FMA probe needs an even element count")
    from tpusph_torch.utils import cuda_build

    lib = cuda_build.library()
    out = torch.empty_like(x)
    with torch.cuda.device(dev):
        err = lib.tpusph_fma_probe(
            x.data_ptr(), x.numel(), streams, rounds, int(x.dtype == torch.bfloat16),
            out.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "fma_probe")
    fma_probe.launches += 1
    return out


fma_probe.launches = 0


def fma_tie_free_input(shape, seed: int, rounds: int) -> torch.Tensor:
    """f32 x in [0.5, 2) on which the FMA probe gives the same bits with a
    fused multiply-add as with a rounded multiply then a rounded add, for
    every stream count and up to `rounds` rounds.

    For a chain value a with ulp u, a·c1 = a + (a/2^e)·u exactly (c1 =
    1 + 2^-23 in f32, 2^e ≤ a < 2^(e+1)), so a round adds 1 or 2 ulps, and
    c2 = 1e-9 (under 0.017 u for a ≥ 0.5) can change that only when the
    fraction of a/2^e lies just below one half. Each round moves the
    fraction up by at most 2^-22; x is redrawn until no chain x + k starts
    within that window widened by the drift over `rounds`. On these inputs
    the kernel must
    equal `fma_probe_plain` exactly, and a kernel that runs one round fewer
    or more does not (each round adds an ulp to every chain)."""
    gen = torch.Generator().manual_seed(seed)
    margin = 0.017 + rounds * 2.0**-22
    x = torch.empty(shape).uniform_(0.5, 2.0, generator=gen)
    while True:
        bad = torch.zeros(shape, dtype=torch.bool)
        for k in range(max(FMA_STREAMS)):
            m, _ = torch.frexp(x + k)  # a = m·2^e', m in [0.5, 1)
            frac = 2 * m - 1
            bad |= (frac >= 0.5 - margin) & (frac <= 0.5)
        if not bad.any():
            return x
        x[bad] = torch.empty(int(bad.sum())).uniform_(0.5, 2.0, generator=gen)


# ------------------------------------------------------ density-mix probe


def density_mix_plain(t: torch.Tensor, c: torch.Tensor, pt: int, rounds: int) -> torch.Tensor:
    """Σ over rounds of live · max(h² − r², 0)³ on the (pt, 128) block of
    pair-lanes between target rows t[:pt] = (x, y, z, key) and candidate
    columns c[0:4] = (x, y, z, key), h² = 0.01. Arithmetic in t's dtype;
    the key compare |ck − tk| ≤ 1 and the lane mask lane < 100 + i·0 in
    f32. Returns f32 (pt, 128)."""
    dtype, dev = t.dtype, t.device
    tx, ty, tz = t[:pt, 0:1], t[:pt, 1:2], t[:pt, 2:3]
    tk = t[:pt, 3:4].to(torch.float32)
    h2 = torch.tensor(0.01, dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    lane = torch.arange(LANES, dtype=torch.float32, device=dev)[None, :]
    acc = torch.zeros((pt, LANES), dtype=dtype, device=dev)
    for i in range(rounds):
        cx, cy, cz = c[0][None, :], c[1][None, :], c[2][None, :]
        ck = c[3][None, :].to(torch.float32)
        dx = tx - cx
        dy = ty - cy
        dz = tz - cz
        r2 = dx * dx + dy * dy + dz * dz
        keyhit = (ck - tk).abs() <= 1.0
        live = keyhit & (lane < 100.0 + i * 0.0)
        w = torch.maximum(h2 - r2, zero)
        w = w * w * w
        acc = acc + torch.where(live, w, zero)
    return acc.to(torch.float32)


def density_mix(t: torch.Tensor, c: torch.Tensor, pt: int, rounds: int) -> torch.Tensor:
    """The density-mix probe (see `density_mix_plain`); t (≥ pt, 4) and
    c (8, 128), both f32 or both bf16. Launches `tpusph_density_mix` for
    CUDA tensors: one thread per pair-lane, several rounds in flight, their
    terms added in round order."""
    dev = t.device
    _check_dtype("t", t)
    if t.dim() != 2 or t.shape[0] < pt or t.shape[1] != 4:
        raise ValueError(f"t must be (>= {pt}, 4), got {tuple(t.shape)}")
    check_tensor("t", t, t.dtype, dev, tuple(t.shape))
    check_tensor("c", c, t.dtype, dev, (8, LANES))
    if on_cpu(dev):
        return density_mix_plain(t, c, pt, rounds)
    from tpusph_torch.utils import cuda_build

    out = torch.empty((pt, LANES), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().tpusph_density_mix(
            t.data_ptr(), c.data_ptr(), pt, rounds, int(t.dtype == torch.bfloat16),
            out.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "tpusph_density_mix")
    density_mix.launches += 1
    return out


density_mix.launches = 0


# ------------------------------------------------------ loop-overhead probe


def loop_probe_plain(variant: str, desc: torch.Tensor, t: torch.Tensor,
                     cand: torch.Tensor, pt: int, bl: int) -> torch.Tensor:
    """Variant V0–V5 of the loop probe: over candidate blocks b = 0 .. n−1,
    with n = rounds (static trip) or desc[rounds] (dynamic trip) and
    rounds = len(desc) − 8, load cand[0:3, off_b : off_b + bl] with
    off_b = 0 (static) or desc[b]·128 (dynamic), and accumulate
    max(h² − r², 0)³ over the (pt, bl) pair-lanes; V4 takes two blocks per
    iteration; V5 accumulates the force op mix into three sums and adds
    them. f32 (pt, bl)."""
    dyn_trip, dyn_load, unroll, force_mix = VARIANTS[variant]
    dev = t.device
    rounds = desc.shape[0] - 8
    tx, ty, tz = t[:pt, 0:1], t[:pt, 1:2], t[:pt, 2:3]
    h2 = torch.tensor(0.01, dtype=torch.float32, device=dev)
    h = torch.tensor(0.1, dtype=torch.float32, device=dev)
    eps = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    lanes = torch.arange(bl, device=dev)

    def load(b):
        if dyn_load:
            c3 = cand[0:3, desc[b].long() * 128 + lanes]
        else:
            c3 = cand[0:3, 0:bl]
        return c3[0][None, :], c3[1][None, :], c3[2][None, :]

    def one(b, acc):
        cx, cy, cz = load(b)
        dx = tx - cx
        dy = ty - cy
        dz = tz - cz
        r2 = dx * dx + dy * dy + dz * dz
        if not force_mix:
            w = torch.maximum(h2 - r2, zero)
            return acc + w * w * w
        fx, fy, fz = acc
        inv_r = torch.rsqrt(r2)
        r = r2 * inv_r
        live = r >= eps
        hr = torch.maximum(h - r, zero)
        s_p = torch.where(live, hr * hr * inv_r, zero)
        fx = fx + s_p * dx
        fy = fy + s_p * dy
        fz = fz + s_p * dz
        s_v = torch.where(live, hr, zero)
        fx = fx + s_v * cx
        fy = fy + s_v * cy
        fz = fz + s_v * cz
        return fx, fy, fz

    z = torch.zeros((pt, bl), dtype=torch.float32, device=dev)
    acc = (z, z, z) if force_mix else z
    n = int(desc[rounds]) if dyn_trip else rounds
    for i in range(n // unroll):
        if unroll == 1:
            acc = one(i, acc)
        else:
            acc = one(2 * i + 1, one(2 * i, acc))
    return acc[0] + acc[1] + acc[2] if force_mix else acc


def loop_stage_blocks(variant: str, cand: torch.Tensor, bl: int) -> int:
    """D, the block offsets 0 .. D−1 of cand's rows 0–2 that a block of the
    loop probe's kernel copies into shared memory (3·D·128 bytes: the 32
    lanes of its slice at each offset), or 0 where it reads device memory
    instead: bl no multiple of 32, cand off 16 bytes or its width no
    multiple of 4, or a table above LOOP_STAGE_MAX. A static-load variant
    needs offset 0 alone."""
    cap = cand.shape[1]
    if bl % 32 or cap % 4 or cand.data_ptr() % 16 or bl > cap:
        return 0
    d = (cap - bl) // LANES + 1 if VARIANTS[variant][1] else 1
    return d if 3 * d * 128 <= LOOP_STAGE_MAX else 0


def loop_probe_walk(variant: str, desc: torch.Tensor, t: torch.Tensor, cand: torch.Tensor,
                    pt: int, bl: int) -> torch.Tensor:
    """`loop_probe_plain` computed the way the kernel in `csrc/probes.cu`
    walks: one 32-lane slice of the columns at a time, its candidates read
    from the slice's staged table (`loop_stage_blocks` offsets of 32 floats
    a row) or from cand; groups of LOOP_TARGETS targets; LOOP_UNROLL rounds
    loaded and their terms computed before they are added in round order, then the rounds left one by one (V4: two by two).
    Equal to `loop_probe_plain` bit for bit on the CPU, where no multiply
    and add fuse."""
    dyn_trip, dyn_load, pair, force_mix = VARIANTS[variant]
    dev = t.device
    rounds = desc.shape[0] - 8
    unroll = LOOP_UNROLL
    h2 = torch.tensor(0.01, dtype=torch.float32, device=dev)
    h = torch.tensor(0.1, dtype=torch.float32, device=dev)
    eps = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    trip = int(desc[rounds]) if dyn_trip else rounds
    n = trip - trip % pair
    offsets = desc.long().tolist()
    stage_d = loop_stage_blocks(variant, cand, bl)
    cap = cand.shape[1]
    out = torch.empty((pt, bl), dtype=torch.float32, device=dev)

    for lo in range(0, bl, 32):
        width = min(32, bl - lo)
        lane = torch.arange(width, device=dev)
        if stage_d:
            # the block's table: row r, offset d, lane j at (r·D + d)·32 + j
            pieces = torch.arange(stage_d, device=dev)[:, None] * LANES + lo + lane[None, :]
            table = cand[0:3][:, pieces].reshape(-1)
            src, row, step = table, stage_d * 32, 32
            first = lane
        else:
            src, row, step = cand.reshape(-1), cap, LANES
            first = lo + lane

        def load(b):
            off = offsets[b] * step if dyn_load else 0
            return tuple(src[r * row + off + first][None, :] for r in range(3))

        for p0 in range(0, pt, LOOP_TARGETS):
            rows = slice(p0, min(p0 + LOOP_TARGETS, pt))
            tx, ty, tz = t[rows, 0:1], t[rows, 1:2], t[rows, 2:3]

            def term(c):
                dx, dy, dz = tx - c[0], ty - c[1], tz - c[2]
                r2 = dx * dx + dy * dy + dz * dz
                if not force_mix:
                    w = torch.maximum(h2 - r2, zero)
                    return (w * w * w,)
                inv_r = torch.rsqrt(r2)
                r = r2 * inv_r
                live = r >= eps
                hr = torch.maximum(h - r, zero)
                s_p = torch.where(live, hr * hr * inv_r, zero)
                s_v = torch.where(live, hr, zero)
                return s_p * dx, s_p * dy, s_p * dz, s_v * c[0], s_v * c[1], s_v * c[2]

            def add(acc, m):
                if not force_mix:
                    return (acc[0] + m[0],)
                return (acc[0] + m[0] + m[3], acc[1] + m[1] + m[4], acc[2] + m[2] + m[5])

            z = torch.zeros((rows.stop - rows.start, width), dtype=torch.float32, device=dev)
            acc = (z, z, z) if force_mix else (z,)
            b = 0
            while b + unroll <= n:
                terms = [term(load(b + u)) for u in range(unroll)]  # computed ahead
                for m in terms:  # added in round order
                    acc = add(acc, m)
                b += unroll
            while b < n:
                for j in range(pair):
                    acc = add(acc, term(load(b + j)))
                b += pair
            out[rows, lo:lo + width] = acc[0] + acc[1] + acc[2] if force_mix else acc[0]
    return out


def loop_probe(variant: str, desc: torch.Tensor, t: torch.Tensor,
               cand: torch.Tensor, pt: int, bl: int) -> torch.Tensor:
    """Variant V0–V5 of the loop probe (see `loop_probe_plain`): desc int16
    (rounds + 8), t f32 (≥ pt, 4), cand f32 (8, CAP) with every
    desc[b]·128 + bl ≤ CAP. Launches `tpusph_loop_probe` for CUDA tensors:
    a warp for each 32-lane slice and group of LOOP_TARGETS targets
    (LOOP_WARPS warps of one slice a block), LOOP_UNROLL rounds in flight a
    thread with their
    terms added in round order, the desc table read 8 entries a load, and
    the slice's candidates staged in shared memory where
    `loop_stage_blocks` says they fit, else read from device memory. V0 and
    V1 need rounds in STATIC_ROUNDS there."""
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {tuple(VARIANTS)}, got {variant!r}")
    dev = t.device
    check_tensor("desc", desc, torch.int16, dev)
    if t.dim() != 2 or t.shape[0] < pt or t.shape[1] != 4:
        raise ValueError(f"t must be (>= {pt}, 4), got {tuple(t.shape)}")
    check_tensor("t", t, torch.float32, dev, tuple(t.shape))
    if cand.dim() != 2 or cand.shape[0] != 8 or cand.shape[1] < bl:
        raise ValueError(f"cand must be (8, >= {bl}), got {tuple(cand.shape)}")
    check_tensor("cand", cand, torch.float32, dev, tuple(cand.shape))
    rounds = desc.shape[0] - 8
    if rounds < 0:
        raise ValueError("desc needs rounds + 8 entries")
    if on_cpu(dev):
        return loop_probe_plain(variant, desc, t, cand, pt, bl)
    if not VARIANTS[variant][0] and rounds not in STATIC_ROUNDS:
        raise ValueError(
            f"{variant} has a compile-time trip count: rounds must be one of "
            f"{STATIC_ROUNDS}, got {rounds}"
        )
    from tpusph_torch.utils import cuda_build

    stage_d = loop_stage_blocks(variant, cand, bl)
    out = torch.empty((pt, bl), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().tpusph_loop_probe(
            desc.data_ptr(), t.data_ptr(), cand.data_ptr(), cand.shape[1], pt, bl,
            rounds, int(variant[1]), stage_d, out.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "tpusph_loop_probe")
    loop_probe.launches += 1
    loop_probe.staged += stage_d > 0
    return out


loop_probe.launches = 0
loop_probe.staged = 0  # launches that staged their candidates in shared memory

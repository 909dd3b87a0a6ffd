"""`fused.chunk_walk`, the plain model of the tiled density kernel's sweep
(csrc/sph.cu), on the CPU: the chunks each block of T
targets stages cover every target's 9 windows once, in ascending rows and
in the column order of `column_offsets`, every chunk starts at a needed
row, and every stage fits the ring (at most S slots, rows aligned to 4
at both ends, in at most PIECES chunks). Inputs are the grid, random and dense-blob
cases of tests/test_torch_fused.py, made with the port's own init, plus a
grid at n = 1000 rows (no multiple of any T) and a blob with sentinel
rows."""

import numpy as np
import pytest
import torch

from tpusph_torch.core.config import default_config
from tpusph_torch.core.init import init_state
from tpusph_torch.engine.step import build_phase
from tpusph_torch.kernels import fused

torch.set_num_threads(2)


def _case(kind):
    """(cfg, key_sorted, starts) of one sorted state."""
    if kind == "grid":
        cfg = default_config(4096)
    elif kind == "grid_ragged":
        cfg = default_config(1000, chunk_size=1000)  # 1000 rows, no padding
    elif kind == "random":
        cfg = default_config(2048)
    else:  # dense: test_torch_fused.py's blob, 2000 particles in 2048 rows
        cfg = default_config(2000)
    st = init_state(cfg, random_init=(kind == "random"), seed=9, device="cpu")
    if kind == "dense":
        rng = np.random.default_rng(0)
        st.position[:2000] = torch.from_numpy(rng.uniform(4.0, 4.35, (2000, 3)).astype(np.float32))
    cl = build_phase(st, cfg)
    return cfg, cl.key_sorted, cl.starts


@pytest.fixture(scope="module", params=["grid", "grid_ragged", "random", "dense"])
def case(request):
    return request.param, *_case(request.param)


def _check_walk(cfg, key, starts, tile, chunk):
    n = key.shape[0]
    begin, count = fused.windows(key, starts, cfg)
    begin, end = begin.numpy(), (begin + count).numpy()
    walk = fused.chunk_walk(key, starts, cfg, tile, chunk).numpy()
    assert walk.shape[1] == 5
    assert (walk[:, 4] > walk[:, 3]).all()
    for blk in range(-(-n // tile)):
        rows = slice(blk * tile, min(n, (blk + 1) * tile))
        b, e = begin[rows], end[rows]
        mine = walk[walk[:, 0] == blk]
        # stages count up from 0; each fits the ring: <= chunk rows, <= PIECES chunks
        stages = mine[:, 1]
        assert (np.diff(stages) >= 0).all()
        assert (np.unique(stages) == np.arange(len(np.unique(stages)))).all()
        for s in np.unique(stages):
            piece = mine[stages == s]
            assert fused.staged_slots(piece[:, 3], piece[:, 4]).sum() <= chunk
            assert len(piece) <= fused.PIECES
        # columns in order, each column's chunks ascending and disjoint
        assert (np.diff(mine[:, 2]) >= 0).all()
        for col in range(9):
            cc = mine[mine[:, 2] == col]
            assert (cc[1:, 3] >= cc[:-1, 4]).all()
            has = e[:, col] > b[:, col]
            for start in cc[:, 3]:
                # a chunk starts at a row some target of the block needs
                assert (has & (b[:, col] <= start) & (start < e[:, col])).any()
            assert len(cc) > 0 or not has.any()
        # every target: its rows across the block's chunks, in staging order,
        # are its 9 windows in column order, each row once
        for t in range(b.shape[0]):
            got = np.concatenate([
                np.arange(max(b[t, col], start), min(e[t, col], stop))
                for _, _, col, start, stop in mine
            ] + [np.zeros(0, np.int64)])
            want = np.concatenate([np.arange(b[t, col], e[t, col]) for col in range(9)])
            np.testing.assert_array_equal(got, want, err_msg=f"block {blk} target {t}")
    return walk


@pytest.mark.parametrize("tile,chunk", [(64, 256), (128, 512), (256, 1024), (128, 40), (64, 4)])
def test_walk_covers_each_window_once_in_order(case, tile, chunk):
    kind, cfg, key, starts = case
    _check_walk(cfg, key, starts, tile, chunk)


def test_walk_crosses_rows_planes_and_sentinels():
    """Tiles of the grid that straddle an x-row and a z-plane, and the
    blob's tiles with sentinel rows, walk correctly."""
    cfg, key, starts = _case("grid")
    c = cfg.num_cells_per_dim
    k = key.numpy().reshape(-1, 128)
    assert (k[:, 0] // (c * c) != k[:, -1] // (c * c)).any()  # a tile crosses a z-plane
    assert (k[:, 0] // c != k[:, -1] // c).any()  # and an x-row
    _check_walk(cfg, key, starts, 128, 256)
    cfg, key, starts = _case("dense")
    assert (key.numpy() >= cfg.num_cells).sum() == 48  # sentinel rows
    _check_walk(cfg, key, starts, 128, 128)


def test_walk_skips_rows_no_target_needs():
    """Sparse random particles: the rows between one target's windows and
    the next target's are not staged where they reach past a chunk."""
    cfg, key, starts = _case("random")
    walk = _check_walk(cfg, key, starts, 128, 8)
    slots = fused.staged_slots(walk[:, 3], walk[:, 4])
    begin, count = fused.windows(key, starts, cfg)
    span = 0  # rows from each (block, column)'s first begin to its last end
    for blk in range(key.shape[0] // 128):
        b = begin[blk * 128:(blk + 1) * 128]
        e = b + count[blk * 128:(blk + 1) * 128]
        has = e > b
        for col in range(9):
            if has[:, col].any():
                span += int(e[has[:, col], col].max() - b[has[:, col], col].min())
    assert int(slots.sum()) < span


def test_dense_windows_take_several_chunks():
    """The blob's windows exceed a stage, so a column takes several chunks
    over several stages; on the sparse grid one stage holds chunks of
    several columns."""
    cfg, key, starts = _case("dense")
    _, count = fused.windows(key, starts, cfg)
    assert int(count.max()) > 128
    walk = fused.chunk_walk(key, starts, cfg, 128, 128).numpy()
    per_column = np.unique(walk[:, [0, 2]], axis=0, return_counts=True)[1]
    assert per_column.max() > 2
    cfg, key, starts = _case("grid")
    walk = fused.chunk_walk(key, starts, cfg, 128, 1024).numpy()
    per_stage = np.unique(walk[:, :2], axis=0, return_counts=True)[1]
    assert per_stage.max() > 2


def test_sparse_blocks_stage_nothing():
    """A block whose live targets average fewer than `stage_min` candidates
    reads device memory and stages nothing; the others walk as before."""
    cfg, key, starts = _case("grid")
    _, count = fused.windows(key, starts, cfg)
    per_block = count.sum(dim=1).view(-1, 128).sum(dim=1)
    lives = (key < cfg.num_cells).view(-1, 128).sum(dim=1)
    stage_min = int((per_block / lives).median())
    dense = (per_block >= lives * stage_min).numpy()
    assert dense.any() and not dense.all()
    every = fused.chunk_walk(key, starts, cfg, 128, 512).numpy()
    some = fused.chunk_walk(key, starts, cfg, 128, 512, stage_min).numpy()
    assert set(some[:, 0]) == set(np.flatnonzero(dense))
    np.testing.assert_array_equal(some, every[dense[every[:, 0]]])


def test_walk_of_sentinel_rows_is_empty():
    cfg = default_config(256)
    key = torch.full((256,), cfg.num_cells, dtype=torch.int32)
    starts = torch.zeros(cfg.num_cells + 2, dtype=torch.int32)
    assert fused.chunk_walk(key, starts, cfg, 128, 512).shape == (0, 5)


def test_kernel_shape_stages_the_blob_and_not_the_grid():
    """At the density kernel's own shape and threshold the dense blob's
    blocks stage and the grid's read device memory: the GPU tests reach
    both of the kernel's paths through these inputs."""
    walk = {}
    for kind in ("dense", "grid", "grid_ragged"):
        cfg, key, starts = _case(kind)
        walk[kind] = fused.chunk_walk(key, starts, cfg,
                                      stage_min=fused.DENSITY_STAGE_MIN).numpy()
    assert len(np.unique(walk["dense"][:, 0])) == -(-2048 // fused.DENSITY_TILE)
    assert walk["grid"].shape == walk["grid_ragged"].shape == (0, 5)
    cfg, key, starts = _case("dense")
    np.testing.assert_array_equal(walk["dense"], fused.chunk_walk(key, starts, cfg).numpy())

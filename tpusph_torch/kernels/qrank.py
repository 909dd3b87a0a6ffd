"""Rank of queries among sorted keys: ranks[i] = #{j : key_sorted[j] <
queries[i]}, which is starts[queries[i]].

Counterpart of `tpusph/pallas/qrank.py` (`rank_queries_pallas`). The CUDA
kernel is `tpusph_torch/csrc/qrank.cu`; `rank_queries_plain` is the same
function in plain PyTorch. `rank_queries` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors. `block_spans` is the
kernel's narrowing in plain PyTorch: the span of keys each block of
queries searches, and whether it fits the block's stage.

The narrowing pays on sorted queries only. On unsorted queries a block's
span is most of the array, nothing is staged, and the kernel is slower
than one thread a query searching the whole array, the first design:
0.0807-0.0811 against 0.0593-0.0598 ms at 262,144 keys and 1,000,002
queries (NVIDIA H100 80GB HBM3, 700 W). The step and
the sharded step only ever pass sorted queries (`cell_list.cell_queries`,
every cell in order), so nothing on their paths meets that case.
"""

from __future__ import annotations

import torch

from tpusph_torch.kernels.launch import check_tensor, on_cpu, plain_version, stream_of

# The kernel's shape, the constants of qrank.cu: a block owns BLOCK_QUERIES
# consecutive queries (kRankQueries) and stages a span of at most STAGE keys
# (kRankStage) in shared memory.
BLOCK_QUERIES = 1024
STAGE = 4096


def rank_queries_plain(
    key_sorted: torch.Tensor, queries: torch.Tensor, num_cells: int
) -> torch.Tensor:
    """Left rank by `searchsorted`; queries above `num_cells` answer n."""
    ranks = torch.searchsorted(key_sorted, queries, side="left", out_int32=True)
    return torch.where(queries > num_cells, key_sorted.shape[0], ranks).to(torch.int32)


def block_spans(
    key_sorted: torch.Tensor, queries: torch.Tensor,
    block_queries: int = BLOCK_QUERIES, stage: int = STAGE,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(lo int32[B], hi int32[B], staged bool[B]) for the B blocks of
    `block_queries` consecutive queries (the last one may be short): lo and
    hi are the ranks of the block's smallest and largest query, so every
    rank of the block lies in [lo, hi] (the rank is monotone in the query;
    a query above `num_cells` ranks n among keys that are all at most
    `num_cells`), and `staged` says that the span hi - lo fits `stage` keys,
    where the kernel searches a copy in shared memory and not device
    memory."""
    nq = queries.shape[0]
    blocks = -(-nq // block_queries)
    pad = blocks * block_queries - nq
    info = torch.iinfo(torch.int32)
    qmin = torch.nn.functional.pad(queries, (0, pad), value=info.max)
    qmax = torch.nn.functional.pad(queries, (0, pad), value=info.min)
    qmin = qmin.view(blocks, block_queries).amin(dim=1)
    qmax = qmax.view(blocks, block_queries).amax(dim=1)
    lo = torch.searchsorted(key_sorted, qmin, side="left", out_int32=True)
    hi = torch.searchsorted(key_sorted, qmax, side="left", out_int32=True)
    return lo, hi, (hi - lo) <= stage


def rank_queries(
    key_sorted: torch.Tensor, queries: torch.Tensor, num_cells: int
) -> tuple[torch.Tensor, int]:
    """(ranks int32[Q], overflow). `key_sorted` is int32[n], sorted
    ascending; `queries` int32[Q], any values in any order. The plain
    version for CPU tensors; `tpusph_qrank` for CUDA tensors. The overflow
    is always 0: unlike the TPU kernel's key window, a span that does not
    fit the kernel's stage is searched in device memory."""
    dev = key_sorted.device
    check_tensor("key_sorted", key_sorted, torch.int32, dev)
    check_tensor("queries", queries, torch.int32, dev)
    if on_cpu(dev):
        with plain_version():
            return rank_queries_plain(key_sorted, queries, num_cells), 0
    from tpusph_torch.utils import cuda_build

    lib = cuda_build.library()
    ranks = torch.empty_like(queries)
    with torch.cuda.device(dev):
        err = lib.tpusph_qrank(
            key_sorted.data_ptr(), key_sorted.shape[0], queries.data_ptr(),
            queries.shape[0], num_cells, ranks.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "tpusph_qrank")
    rank_queries.launches += 1
    return ranks, 0


rank_queries.launches = 0

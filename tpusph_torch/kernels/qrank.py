"""Rank of queries among sorted keys: ranks[i] = #{j : key_sorted[j] <
queries[i]}, which is starts[queries[i]].

Counterpart of `tpusph/pallas/qrank.py` (`rank_queries_pallas`). The CUDA
kernel is `tpusph_torch/csrc/qrank.cu`; `rank_queries_plain` is the same
function in plain PyTorch. `rank_queries` takes the plain version for CPU
tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import torch

from tpusph_torch.kernels.launch import check_tensor, on_cpu, stream_of


def rank_queries_plain(
    key_sorted: torch.Tensor, queries: torch.Tensor, num_cells: int
) -> torch.Tensor:
    """Left rank by `searchsorted`; queries above `num_cells` answer n."""
    ranks = torch.searchsorted(key_sorted, queries, side="left", out_int32=True)
    return torch.where(queries > num_cells, key_sorted.shape[0], ranks).to(torch.int32)


def rank_queries(
    key_sorted: torch.Tensor, queries: torch.Tensor, num_cells: int
) -> tuple[torch.Tensor, int]:
    """(ranks int32[Q], overflow). `key_sorted` is int32[n], sorted
    ascending; `queries` int32[Q]. The overflow is always 0: unlike the TPU
    kernel's key window, the binary search has no capacity."""
    dev = key_sorted.device
    check_tensor("key_sorted", key_sorted, torch.int32, dev)
    check_tensor("queries", queries, torch.int32, dev)
    if on_cpu(dev):
        return rank_queries_plain(key_sorted, queries, num_cells), 0
    from tpusph_torch.utils import cuda_build

    lib = cuda_build.library()
    ranks = torch.empty_like(queries)
    with torch.cuda.device(dev):
        err = lib.tpusph_qrank(
            key_sorted.data_ptr(), key_sorted.shape[0], queries.data_ptr(),
            queries.shape[0], num_cells, ranks.data_ptr(), stream_of(dev),
        )
    cuda_build.check(err, "qrank")
    rank_queries.launches += 1
    return ranks, 0


rank_queries.launches = 0

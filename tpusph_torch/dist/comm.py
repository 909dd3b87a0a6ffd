"""The neighbour exchange and the counter reduction of the z-slab engine
over `torch.distributed`.

The JAX package runs one per-device function under `shard_map` and talks to
the adjacent slabs with `lax.ppermute`, `lax.psum` and `lax.pmax` along a
1-D mesh. Here every rank is a process that holds its own slab, and
`SlabComm` is what those collectives become: `exchange` / `shift` move
tensors to rank + 1 and rank − 1, `reduce` sums and maxes the step's
counters, `gather` brings every rank's block to every rank.

Which transport carries them comes from the process group, not from a
setting. An `nccl` group takes CUDA tensors as they are. A `gloo` group
takes CPU tensors only, so CUDA tensors are staged through host memory:
one copy to the host before the send and one back after the receive,
each a wait on the card. That is what lets several ranks share one card.

One exchange is one message a direction: the tensors of a direction are
packed into a single byte buffer (bool masks travel as bytes; gloo has no
bool send) and unpacked by the receiver, which knows the shapes because
its own send in the other direction has the same ones. All sends and
receives of an exchange are posted together in one
`batch_isend_irecv`, so no chain of blocking sends can deadlock.

`init_slab_comm` joins a rank to its group with a finite timeout;
`spawn_ranks` starts one process a rank and joins them under a deadline,
killing what is left, so a rank that dies fails its peers instead of
leaving them waiting.
"""

from __future__ import annotations

import datetime
import time

import torch

_ALIGN = 8  # bytes; every packed segment starts on a multiple of it


def _pack(tensors) -> torch.Tensor:
    """The tensors' bytes in one uint8 buffer, each segment padded to
    _ALIGN so that it can be viewed as its dtype again."""
    parts = []
    for t in tensors:
        b = t.contiguous().view(torch.uint8).reshape(-1)
        pad = -b.numel() % _ALIGN
        parts.append(b if not pad else torch.cat([b, b.new_zeros(pad)]))
    return torch.cat(parts)


def _unpack(buf: torch.Tensor, like) -> list:
    """The inverse of `_pack` for tensors shaped and typed as `like`."""
    out, pos = [], 0
    for t in like:
        nbytes = t.numel() * t.element_size()
        out.append(buf[pos : pos + nbytes].view(t.dtype).reshape(t.shape))
        pos += nbytes + (-nbytes % _ALIGN)
    return out


def _packed_size(like) -> int:
    sizes = (t.numel() * t.element_size() for t in like)
    return sum(n + (-n % _ALIGN) for n in sizes)


class SlabComm:
    """This rank's place on the 1-D line of z-slabs and its links to the
    two adjacent ranks. Without a group it is the line of one rank: it
    receives zeros and reduces nothing, and never touches
    `torch.distributed`. `device` is where this rank's slab lives (default:
    the current CUDA device)."""

    def __init__(self, device="cuda", group=None):
        self.device = torch.device(device)
        self.group = group
        self.rank, self.size, self.staged = 0, 1, False
        if group is not None:
            import torch.distributed as dist

            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            self.staged = dist.get_backend(group) == "gloo"  # gloo moves host memory only

    # ------------------------------------------------------------ transport
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.staged else t

    def _back(self, t: torch.Tensor, device) -> torch.Tensor:
        return t.to(device) if self.staged else t

    def exchange(self, up, dn):
        """Send the tensors `up` to rank + 1 and `dn` to rank − 1, both at
        once. Returns (from_below, from_above): what rank − 1 sent up and
        what rank + 1 sent down, shaped as `up` and `dn`. A rank at the
        end of the line receives zeros from the side where there is no
        rank, what `ppermute` delivers to a device with no source."""
        up, dn = list(up), list(dn)
        got = {-1: [torch.zeros_like(t) for t in up], 1: [torch.zeros_like(t) for t in dn]}
        if self.size == 1:
            return got[-1], got[1]
        import torch.distributed as dist

        ops, recvs = [], []
        for side, sent, like in ((1, up, dn), (-1, dn, up)):
            peer = self.rank + side
            if not 0 <= peer < self.size:
                continue
            peer = dist.get_global_rank(self.group, peer)
            if sent:
                ops.append(dist.P2POp(dist.isend, self._out(_pack(sent)), peer, self.group))
            if like:
                buf = torch.empty(
                    _packed_size(like), dtype=torch.uint8,
                    device="cpu" if self.staged else like[0].device,
                )
                ops.append(dist.P2POp(dist.irecv, buf, peer, self.group))
                recvs.append((side, buf, like))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for side, buf, like in recvs:
            got[side] = _unpack(self._back(buf, like[0].device), like)
        return got[-1], got[1]

    def shift(self, tensors, up: bool = True) -> list:
        """Send each tensor to rank + 1 and return what rank − 1 sent
        (`up=False`: the other way). Zeros at the end of the line."""
        if up:
            return self.exchange(tensors, [])[0]
        return self.exchange([], tensors)[1]

    def reduce(self, sums, maxes):
        """(int32[len(sums)] summed over the ranks, int32[len(maxes)] maxed
        over the ranks) of 0-d tensors or ints: two `all_reduce`s of one
        stacked tensor each. The results stay where the reduction ran: on
        the host for a staged group, else on this rank's device. An int is
        filled in on the device (a copy from the host would wait on the
        card)."""
        import torch.distributed as dist

        out = []
        for values, op in ((sums, "SUM"), (maxes, "MAX")):
            t = torch.stack([
                v.to(torch.int32) if torch.is_tensor(v)
                else torch.full((), v, dtype=torch.int32, device=self.device)
                for v in values
            ])
            if self.size > 1:
                t = self._out(t)
                dist.all_reduce(t, op=getattr(dist.ReduceOp, op), group=self.group)
            out.append(t)
        return tuple(out)

    def gather(self, tensors) -> list[list]:
        """Every rank's `tensors` on every rank: a list, by rank, of lists
        shaped as `tensors` (which must have the same shapes on all ranks).
        One `all_gather` of one packed buffer."""
        tensors = list(tensors)
        if self.size == 1:
            return [tensors]
        import torch.distributed as dist

        mine = self._out(_pack(tensors))
        bufs = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(bufs, mine, group=self.group)
        dev = tensors[0].device
        return [_unpack(self._back(b, dev), tensors) for b in bufs]


GROUP_TIMEOUT_S = 60.0  # a collective whose peer is gone gives up after this


def init_slab_comm(rank: int, size: int, init_method: str, device="cuda") -> SlabComm:
    """Join rank `rank` of `size` to a process group at `init_method`
    (`file://...` or `tcp://host:port`) and return its `SlabComm`. The
    backend is nccl when every rank has a card of its own and gloo
    otherwise (CPU ranks, or several ranks on one card); collectives give
    up after GROUP_TIMEOUT_S."""
    import torch.distributed as dist

    device = torch.device(device)
    own_card = device.type == "cuda" and torch.cuda.device_count() >= size
    dist.init_process_group(
        "nccl" if own_card else "gloo", init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    return SlabComm(device, dist.group.WORLD)


def _rank_main(rank: int, fn, size: int, init_method: str, device, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    comm = init_slab_comm(rank, size, init_method, device)
    try:
        fn(comm, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, size: int, init_method: str, device="cuda", args=(), deadline_s=120.0):
    """Run `fn(comm, *args)` on `size` freshly started processes, one a
    rank, each on one thread, and wait for them. `fn` must be importable
    (a module-level function). A rank that raises makes this raise; ranks
    still running `deadline_s` after the start are killed and a
    TimeoutError is raised."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(
        _rank_main, args=(fn, size, init_method, str(device), tuple(args)),
        nprocs=size, join=False,
    )
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=min(5.0, max(0.1, end - time.monotonic()))):
            if time.monotonic() > end:
                raise TimeoutError(f"{size} ranks did not finish within {deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()

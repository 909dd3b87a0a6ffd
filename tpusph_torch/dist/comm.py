"""The neighbour exchanges and the counter reductions of the sharded
engines over `torch.distributed`.

The JAX package runs one per-device function under `shard_map` and talks to
the adjacent devices with `lax.ppermute`, `lax.psum` and `lax.pmax` along
the axes of a mesh. Here every rank is a process that holds its own block,
and a communicator is what those collectives become: `SlabComm` for the
1-D line of z-slabs (`dist/sharded.py`), `BrickComm` for the (z, y, x)
grid of bricks (`dist/mesh3d.py`), whose `axis(ax)` is the line through
this rank along one axis. On a line, `exchange` / `shift` move tensors to
the next and the previous position; `reduce` sums and maxes the step's
counters over every rank, `gather` brings every rank's block to every
rank.

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

`init_slab_comm` / `init_brick_comm` join a rank to its group with a
finite timeout; `join_torchrun` does it for a process that `torchrun`
started; `spawn_ranks` starts one process a rank and joins them under a
deadline, killing what is left, so a rank that dies fails its peers
instead of leaving them waiting.
"""

from __future__ import annotations

import datetime
import math
import os
import time

import torch

from tpusph_torch.engine.graphs import cross

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


def int32s(values, device) -> torch.Tensor:
    """int32[len(values)] of 0-d tensors and ints, an int filled in on
    `device` (a copy from the host would wait on the card)."""
    return torch.stack([v.to(torch.int32) if torch.is_tensor(v)
                        else torch.full((), v, dtype=torch.int32, device=device)
                        for v in values])


def _packed_size(like) -> int:
    sizes = (t.numel() * t.element_size() for t in like)
    return sum(n + (-n % _ALIGN) for n in sizes)


class _Group:
    """The transport and the collectives of a process group, what every
    communicator here shares. `rank` and `size` are the group's; without a
    group it is a group of one rank that never touches `torch.distributed`.
    `device` is where this rank's block lives (default: the current CUDA
    device)."""

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

    def _exchange(self, up, dn, below, above):
        """Send the tensors `up` to group rank `above` and `dn` to group
        rank `below`, both at once (None: there is no rank on that side).
        Returns (from_below, from_above), shaped as `up` and `dn`; zeros
        from a side where there is no rank, what `ppermute` delivers to a
        device with no source."""
        up, dn = list(up), list(dn)
        got = {-1: [torch.zeros_like(t) for t in up], 1: [torch.zeros_like(t) for t in dn]}
        if below is None and above is None:
            return got[-1], got[1]
        import torch.distributed as dist

        ops, recvs = [], []
        for side, peer, sent, like in ((1, above, up, dn), (-1, below, dn, up)):
            if peer is None:
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

    def reduce(self, sums, maxes):
        """(int32[len(sums)] summed over the ranks, int32[len(maxes)] maxed
        over the ranks) of 0-d tensors or ints: two `all_reduce`s of one
        stacked tensor each. The results stay where the reduction ran: on
        the host for a staged group, else on this rank's device (inside a
        segmented body: static tensors on the device, `graphs.cross`). An
        int is filled in on the device (a copy from the host would wait on
        the card)."""
        stacked = [int32s(values, self.device) for values in (sums, maxes)]
        if self.size == 1:
            return tuple(stacked)
        # looked up at each call, so that a transport recorded by a graph
        # runs what the instance holds then
        return tuple(cross("reduce", lambda s, m: self._all_reduce(s, m), stacked, stacked))

    def _all_reduce(self, sums: torch.Tensor, maxes: torch.Tensor):
        import torch.distributed as dist

        out = []
        for t, op in ((sums, dist.ReduceOp.SUM), (maxes, dist.ReduceOp.MAX)):
            t = self._out(t)
            dist.all_reduce(t, op=op, group=self.group)
            out.append(t)
        return out

    def gather(self, tensors) -> list[list]:
        """Every rank's `tensors` on every rank: a list, by group rank, of
        lists shaped as `tensors` (which must have the same shapes on all
        ranks). One `all_gather` of one packed buffer."""
        tensors = list(tensors)
        if self.size == 1:
            return [tensors]
        return cross("gather", lambda t: self._gather(t), [tensors], [tensors] * self.size)

    def _gather(self, tensors: list) -> list[list]:
        import torch.distributed as dist

        mine = self._out(_pack(tensors))
        bufs = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(bufs, mine, group=self.group)
        dev = tensors[0].device
        return [_unpack(self._back(b, dev), tensors) for b in bufs]


class _Line:
    """A line of ranks: `rank` is this rank's position on it, `size` its
    length, `_group_rank(pos)` the group rank at a position and
    `_transport()` the `_Group` that carries the messages. The exchange
    with the two adjacent positions is the one of `_Group._exchange`.

    No communicator refers to itself: a process group that outlives its
    destruction in an uncollected cycle aborts the process when the
    collector reaches it at exit."""

    def _peers(self):
        at = lambda pos: self._group_rank(pos) if 0 <= pos < self.size else None
        return at(self.rank - 1), at(self.rank + 1)

    def exchange(self, up, dn):
        """Send the tensors `up` to the next position on the line and `dn`
        to the previous one, both at once. Returns (from_below,
        from_above): what the previous position sent up and what the next
        sent down, shaped as `up` and `dn`. An end of the line receives
        zeros from the side where there is no rank, what `ppermute`
        delivers to a device with no source. Where this rank has a peer on
        either side it is a transport (`graphs.cross`: a boundary between
        two segments of a graphed body); with none it only makes zeros."""
        below, above = self._peers()
        up, dn = list(up), list(dn)
        if below is None and above is None:
            return self._transport()._exchange(up, dn, below, above)
        return cross("exchange",
                     lambda u, d: self._transport()._exchange(u, d, below, above),
                     [up, dn], [up, dn])

    def shift(self, tensors, up: bool = True) -> list:
        """Send each tensor to the next position and return what the
        previous one sent (`up=False`: the other way). Zeros at the end of
        the line."""
        if up:
            return self.exchange(tensors, [])[0]
        return self.exchange([], tensors)[1]


class SlabComm(_Group, _Line):
    """This rank's place on the 1-D line of z-slabs and its links to the
    two adjacent ranks. `order` is the line: position → group rank (default
    the group's own order; `dist/multislice.py` makes it slice-major), and
    `rank` is this rank's position on it, the index of its slab. Without a
    group it is the line of one rank: it receives zeros and reduces
    nothing, and never touches `torch.distributed`."""

    def __init__(self, device="cuda", group=None, order=None):
        super().__init__(device, group)
        self.order = tuple(range(self.size)) if order is None else tuple(order)
        if sorted(self.order) != list(range(self.size)):
            raise ValueError(f"order {self.order} is no order of {self.size} ranks")
        self.rank = self.order.index(self.rank)

    def _transport(self) -> _Group:
        return self

    def _group_rank(self, pos: int) -> int:
        return self.order[pos]


class BrickComm(_Group):
    """This rank's place on a (mz, my, mx) grid of bricks. Group ranks run
    (z, y, x)-major over the grid, the order of tpusph's `make_mesh`
    (`tpusph/dist/mesh3d.py:727-729`) and of `brick_owner`'s flat index;
    `coords` = (iz, iy, ix) is this rank's. `axis(ax)` is the line of
    ranks through this one along axis ax (0 = z, 1 = y, 2 = x), whose
    `exchange` / `shift` post to the ranks ±1 along it; `reduce` and
    `gather` run over every rank. Without a group the grid is (1, 1, 1)."""

    def __init__(self, device="cuda", group=None, shape=(1, 1, 1)):
        super().__init__(device, group)
        self.shape = tuple(int(m) for m in shape)
        if len(self.shape) != 3 or min(self.shape) < 1 or math.prod(self.shape) != self.size:
            raise ValueError(f"a brick grid {shape} for a group of {self.size} ranks")
        mz, my, mx = self.shape
        self.coords = (self.rank // (my * mx), self.rank // mx % my, self.rank % mx)

    def axis(self, ax: int) -> "BrickAxis":
        return BrickAxis(self, ax)


class BrickAxis(_Line):
    """The line of a brick grid through this rank along one axis: `rank`
    is this rank's coordinate on the axis, `size` the axis's extent. An
    axis of extent 1 has no peers: its exchange returns zeros and sends
    nothing, what `ppermute` with an empty permutation gives."""

    def __init__(self, brick: BrickComm, ax: int):
        self._brick, self._ax = brick, ax
        self.device = brick.device
        self.rank, self.size = brick.coords[ax], brick.shape[ax]

    def _transport(self) -> BrickComm:
        return self._brick

    def _group_rank(self, pos: int) -> int:
        coords = list(self._brick.coords)
        coords[self._ax] = pos
        mz, my, mx = self._brick.shape
        return (coords[0] * my + coords[1]) * mx + coords[2]


GROUP_TIMEOUT_S = 60.0  # a collective whose peer is gone gives up after this


def _join(rank: int, size: int, init_method: str, device: torch.device):
    """Join rank `rank` of `size` to the default process group at
    `init_method` (`file://...`, `tcp://host:port` or `env://`). The backend
    is nccl when every rank has a card of its own and gloo otherwise (CPU
    ranks, or several ranks on one card); collectives give up after
    GROUP_TIMEOUT_S."""
    import torch.distributed as dist

    own_card = device.type == "cuda" and torch.cuda.device_count() >= size
    dist.init_process_group(
        "nccl" if own_card else "gloo", init_method=init_method, rank=rank, world_size=size,
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )
    return dist.group.WORLD


def init_slab_comm(rank: int, size: int, init_method: str, device="cuda", order=None) -> SlabComm:
    """Join the group (`_join`) and return this rank's `SlabComm` on the
    line `order` (default: the group's order)."""
    device = torch.device(device)
    return SlabComm(device, _join(rank, size, init_method, device), order)


def init_brick_comm(rank: int, size: int, init_method: str, shape, device="cuda") -> BrickComm:
    """Join the group (`_join`) and return this rank's `BrickComm` on the
    grid `shape` = (mz, my, mx), whose product must be `size`."""
    device = torch.device(device)
    return BrickComm(device, _join(rank, size, init_method, device), shape)


def join_torchrun(device="cuda") -> SlabComm | None:
    """The CLI's launcher. Under `torchrun` (RANK, WORLD_SIZE and
    LOCAL_RANK set) join its group with `init_method="env://"` on the card
    `cuda:LOCAL_RANK mod device_count`, or on the CPU for a `cpu` device,
    and return the rank's `SlabComm`. Otherwise None: one rank, no group."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")):
        return None
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", int(env["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return init_slab_comm(int(env["RANK"]), int(env["WORLD_SIZE"]), "env://", device)


def _rank_main(rank: int, fn, size: int, init_method: str, device, args, shape):
    import torch.distributed as dist

    torch.set_num_threads(1)
    if shape is None:
        comm = init_slab_comm(rank, size, init_method, device)
    else:
        comm = init_brick_comm(rank, size, init_method, shape, device)
    # A rank whose fn raises exits without tearing the group down: its peers
    # learn of it only once this process is gone, so the spawn reports this
    # rank's error, not a peer's lost link.
    fn(comm, *args)
    dist.destroy_process_group()


def spawn_ranks(fn, size: int, init_method: str, device="cuda", args=(), deadline_s=120.0,
                shape=None):
    """Run `fn(comm, *args)` on `size` freshly started processes, one a
    rank, each on one thread, and wait for them. `comm` is a `SlabComm`,
    or with `shape` = (mz, my, mx) a `BrickComm` on that grid. `fn` must
    be importable (a module-level function). A rank that raises makes this
    raise; ranks still running `deadline_s` after the start are killed and
    a TimeoutError is raised."""
    import torch.multiprocessing as mp

    ctx = mp.spawn(
        _rank_main, args=(fn, size, init_method, str(device), tuple(args), shape),
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

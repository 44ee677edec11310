"""Multi-process execution: JAX's multi-controller SPMD as
``torch.distributed``.

Port of `pmg_dolfinx_tpu.parallel.multihost`. The JAX package runs one
process per host and the SAME ``shard_map`` program over a global device
mesh. The port runs one process (rank) per block of shards: each rank
holds a contiguous box of the ``(sx, sy, sz)`` shard grid, stacked on its
own device exactly as the single-process layout stacks all of them, and
runs the same program. Only the communication object differs:
`RankGrid`, beside `grid2d.StackedGrid`, with the same methods, crosses
ranks where a collective leaves the block.

Launch (one command per rank, the same program)::

    # rank 0                                   # rank 1
    python driver.py --init tcp://h0:1234 --world 2 --rank 0
    python driver.py --init tcp://h0:1234 --world 2 --rank 1

with ``initialize(init_method, world_size, rank, backend, device=...)``
called before any solver is built. A solver built with ``devices=None``
while a process group is up spans every rank (`rank_layout`).

Backends. ``gloo`` runs on CPU tensors as they are. On CUDA tensors
gloo's point-to-point paths take raw host pointers, so `RankGrid` stages
every collective buffer through pinned host memory (synchronise, copy
out, communicate, copy back); the data, the kernels and every pointwise
pass stay on the device. ``nccl`` passes device tensors straight through;
NCCL refuses two ranks on one GPU, so that route needs one GPU per rank.
"""

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from .grid2d import AXES, StackedGrid, _norm_shards

_STATE = dict(device=None)
_GROUPS = {}


def initialize(init_method=None, world_size=None, rank=None,
               backend="gloo", *, device, timeout_s=300.0):
    """Bring up the process group (call before building any solver).

    ``init_method`` (e.g. ``tcp://localhost:29500``), ``world_size`` and
    ``rank`` go to ``torch.distributed.init_process_group`` (all None: read
    from the environment, ``env://``). ``backend`` is the caller's
    (``gloo`` or ``nccl``), ``device`` the device this rank's tensors live
    on; a CUDA device is made current and must exist. Returns the device.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"initialize: device {dev} asked for, but no "
                               "CUDA device is available")
        torch.cuda.set_device(dev)
    kw = dict(backend=backend, timeout=timedelta(seconds=float(timeout_s)))
    if init_method is not None:
        kw.update(init_method=init_method, world_size=int(world_size),
                  rank=int(rank))
    dist.init_process_group(**kw)
    _STATE.update(device=dev)
    return dev


def is_up():
    """True when a process group is initialised."""
    return dist.is_available() and dist.is_initialized()


def process_index():
    """This process's rank (0 when no process group is up)."""
    return dist.get_rank() if is_up() else 0


def process_count():
    """The number of ranks (1 when no process group is up)."""
    return dist.get_world_size() if is_up() else 1


def rank_device():
    """The device `initialize` recorded for this rank (None before)."""
    return _STATE["device"]


def shutdown():
    """Tear down the process group and the cached row groups."""
    if is_up():
        dist.destroy_process_group()
    _GROUPS.clear()
    _STATE.update(device=None)


# -- layouts -------------------------------------------------------------


def _box_of_run(shards, per):
    """The block shape of a row-major run of ``per`` shards, or None when
    such a run is not a box."""
    block, rem = [1, 1, 1], per
    for a in (2, 1, 0):
        if rem >= shards[a]:
            if rem % shards[a]:
                return None
            block[a], rem = shards[a], rem // shards[a]
        else:
            if shards[a] % rem:
                return None
            block[a], rem = rem, 1
    return tuple(block) if rem == 1 else None


def rank_layout(shards, devices=None, world_size=None):
    """The rank of every shard, ``(sx, sy, sz)`` int array, and the block
    shape every rank holds.

    ``devices=None`` spans all ``world_size`` ranks with contiguous equal
    blocks in row-major shard order (JAX's
    ``np.array(devices).reshape(shards)`` over the processes' devices):
    (2, 2, 2) on 2 ranks gives each a (1, 2, 2) block, on 4 ranks a (1, 1,
    2) one. An explicit ``devices`` is one rank per shard, in row-major
    shard order. Raises ValueError when the world size does not divide
    the shard count, a rank's shards are not a box, the boxes differ in
    shape or a rank is missing or out of range."""
    shards = _norm_shards(shards)
    n = int(np.prod(shards))
    world = int(process_count() if world_size is None else world_size)
    if devices is None:
        if n % world:
            raise ValueError(f"{n} shards {shards} do not split over "
                             f"{world} ranks")
        block = _box_of_run(shards, n // world)
        if block is None:
            raise ValueError(
                f"a row-major run of {n // world} shards of {shards} is "
                "not a box; pick a shard grid whose trailing axes the "
                "per-rank count fills")
        return np.arange(n).reshape(shards) // (n // world), block
    ranks = np.asarray([int(d) for d in devices], dtype=np.int64)
    if ranks.size != n:
        raise ValueError(f"devices= names {ranks.size} ranks for {n} shards "
                         f"{shards}; give one rank per shard")
    if ranks.min() < 0 or ranks.max() >= world or (
            len(np.unique(ranks)) != world):
        raise ValueError(f"devices= must name every rank 0..{world - 1} "
                         f"(world size {world}), got {sorted(set(ranks))}")
    ranks = ranks.reshape(shards)
    block = None
    for r in range(world):
        idx = np.argwhere(ranks == r)
        lo, hi = idx.min(axis=0), idx.max(axis=0) + 1
        shape = tuple(int(v) for v in hi - lo)
        if int(np.prod(shape)) != len(idx) or np.any(lo % shape):
            raise ValueError(f"rank {r}'s shards are not a sub-box of the "
                             f"shard grid {shards}")
        if block is None:
            block = shape
        elif shape != block:
            raise ValueError(f"rank blocks differ in shape ({block} and "
                             f"{shape}); every rank holds the same block")
    return ranks, block


def _ranks_of(devices):
    """``devices`` as a list of ranks (ints); ValueError otherwise."""
    out = []
    for d in devices:
        if isinstance(d, (bool, str)) or not float(d).is_integer():
            raise ValueError(f"devices= names the rank of each shard (ints, "
                             f"one per shard, in shard order); got {d!r}")
        out.append(int(d))
    return out


def layout_grid(shards, devices=None, *, device):
    """The communication object of a sharded solver: `StackedGrid` (every
    shard on this process) when no process group is up or it has one rank
    (``devices`` then must name rank 0 only), else this rank's `RankGrid`
    over the ranks ``devices`` names (`rank_layout`)."""
    shards = _norm_shards(shards)
    if devices is not None:
        devices = _ranks_of(devices)
    if process_count() == 1:
        if devices is not None and any(devices):
            raise ValueError("devices= names ranks other than 0, but no "
                             "process group of more than one rank is up")
        if devices is not None and len(devices) != int(np.prod(shards)):
            raise ValueError(f"devices= names {len(devices)} ranks for "
                             f"{int(np.prod(shards))} shards; give one "
                             "rank per shard")
        return StackedGrid(shards)
    ranks, block = rank_layout(shards, devices)
    return RankGrid(shards, ranks, block, device=device)


def _row_group(ranks):
    """The process group of ``ranks`` (sorted), created once: every rank
    calls this for every row in the same order."""
    key = tuple(sorted(int(r) for r in ranks))
    if key not in _GROUPS:
        _GROUPS[key] = (None if len(key) == process_count()
                        else dist.new_group(list(key)))
    return _GROUPS[key]


class RankGrid(StackedGrid):
    """`StackedGrid`'s collectives for one rank's block of the shard grid.

    ``shards`` is the global grid, ``block`` the leading shape of this
    rank's tensors and ``origin`` the block's first shard. Within the
    block every method is the stacked one; across ranks:
    `ppermute_planes` sends the block's boundary planes to the neighbour
    rank on that axis (``batch_isend_irecv``, zeros at the chain ends),
    `dot` and `psum` add the local sums with one ``all_reduce``,
    `all_gather` gathers the blocks and stitches the global lattice,
    `local_slices` cuts this rank's blocks only and `all_to_all` is one
    ``all_to_all_single`` over the ranks of the row along that axis (the
    row groups made once, here).

    ``staged`` (gloo on CUDA tensors) copies every collective buffer
    through pinned host memory; ``stats`` counts the collective calls and
    the staged bytes.
    """

    def __init__(self, shards, ranks, block, *, device):
        self.shards = _norm_shards(shards)
        self.block = tuple(int(b) for b in block)
        self.rank = dist.get_rank()
        self.ranks = np.asarray(ranks)
        here = np.argwhere(self.ranks == self.rank)
        self.origin = tuple(int(v) for v in here.min(axis=0))
        self.rank_shape = tuple(s // b for s, b in zip(self.shards,
                                                       self.block))
        self.coords = tuple(o // b for o, b in zip(self.origin, self.block))
        # the rank of every block, (Rx, Ry, Rz)
        self.rank_grid = self.ranks[::self.block[0], ::self.block[1],
                                    ::self.block[2]]
        self.device = torch.device(device)
        self.staged = (dist.get_backend() == "gloo"
                       and self.device.type == "cuda")
        self.stats = dict(calls=0, staged_bytes=0)
        self._rows = {}
        for a in range(3):
            if self.rank_shape[a] == 1:
                continue
            rg = np.moveaxis(self.rank_grid, a, -1)
            for row in rg.reshape(-1, rg.shape[-1]):
                group = _row_group(row)
                if self.rank in row:
                    # group rank g (sorted ranks) -> its coordinate on a
                    order = np.argsort(row, kind="stable")
                    self._rows[a] = (group, torch.as_tensor(order))

    # -- staging ---------------------------------------------------------

    def _send_buf(self, t):
        t = t.contiguous()
        if not self.staged:
            return t
        torch.cuda.synchronize(self.device)
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self.stats["staged_bytes"] += h.numel() * h.element_size()
        return h

    def _recv_buf(self, like, shape=None):
        shape = tuple(like.shape) if shape is None else tuple(shape)
        if not self.staged:
            return torch.empty(shape, dtype=like.dtype, device=like.device)
        return torch.empty(shape, dtype=like.dtype, pin_memory=True)

    def _back(self, h):
        if not self.staged:
            return h
        self.stats["staged_bytes"] += h.numel() * h.element_size()
        return h.to(self.device)

    def _rank_at(self, coords):
        return int(self.rank_grid[tuple(coords)])

    # -- placement ---------------------------------------------------------

    def build_device(self, device):
        """The host: a rank builds the whole stack there (every rank
        alike) and uploads only its block (`place`)."""
        return torch.device("cpu")

    def place(self, tree, spec, device):
        """This rank's block of host-built whole-stack arrays on
        ``device`` (`put_tree` under ``spec``)."""
        return put_tree(tree, spec, self, device=device)

    def put_local(self, lat, local_shape, *, device, dtype):
        """A global lattice -> this rank's `local_slices`, cut where
        ``lat`` lives (the host for a host value) before the upload."""
        return self.local_slices(torch.as_tensor(lat), local_shape).to(
            device=device, dtype=dtype)

    # -- collectives -------------------------------------------------------

    def ppermute_planes(self, first, last, axis):
        """Non-wrapping ``ppermute`` along grid axis ``axis``: within the
        block as `StackedGrid`, the block's end planes to and from the
        neighbour ranks."""
        from_left, from_right = super().ppermute_planes(first, last, axis)
        R, c = self.rank_shape[axis], self.coords[axis]
        if R == 1:
            return from_left, from_right
        b = self.block[axis]
        end = lambda t, i: t.narrow(axis, i, 1)
        ops, recvs = [], []
        for step, nb_plane, mine, into in ((-1, 0, first, from_left),
                                           (1, b - 1, last, from_right)):
            if not 0 <= c + step < R:
                continue
            nb = list(self.coords)
            nb[axis] = c + step
            peer = self._rank_at(nb)
            buf = self._recv_buf(end(into, nb_plane))
            # tag by the direction of travel: planes moving left carry 1
            ops.append(dist.P2POp(dist.isend, self._send_buf(
                end(mine, nb_plane)), peer, tag=int(step < 0)))
            ops.append(dist.P2POp(dist.irecv, buf, peer, tag=int(step > 0)))
            recvs.append((buf, end(into, nb_plane)))
        self.stats["calls"] += 1
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        for buf, dst in recvs:
            dst.copy_(self._back(buf))
        return from_left, from_right

    def _all_reduce(self, t):
        h = self._send_buf(t)
        self.stats["calls"] += 1
        dist.all_reduce(h, op=dist.ReduceOp.SUM)
        return self._back(h)

    def dot(self, u, v, weights):
        """The ownership-weighted local dot of the block plus one
        ``all_reduce``: a 0-d tensor, the same on every rank."""
        return self._all_reduce(super().dot(u, v, weights))

    def psum(self, buf):
        """The block's sum over its shard axes plus one ``all_reduce``."""
        return self._all_reduce(super().psum(buf))

    def gather_blocks(self, st):
        """Every rank's block of a stacked tensor (leading dims the block)
        assembled into the whole stack ``(sx, sy, sz, ...)`` on every
        rank (one list ``all_gather``)."""
        h = self._send_buf(st)
        parts = [torch.empty_like(h) for _ in range(self.ranks.max() + 1)]
        self.stats["calls"] += 1
        dist.all_gather(parts, h)
        full = st.new_empty(self.shards + tuple(st.shape[3:]))
        for r, p in enumerate(parts):
            lo = np.argwhere(self.ranks == r).min(axis=0)
            full[tuple(slice(int(o), int(o) + b)
                       for o, b in zip(lo, self.block))] = self._back(p)
        return full

    def all_gather(self, st):
        """The global lattice on every rank: the blocks gathered, then
        stitched as `StackedGrid.all_gather` (duplicated planes once)."""
        return StackedGrid(self.shards).all_gather(self.gather_blocks(st))

    def all_to_all(self, st, axis, split_axis, concat_axis):
        """`StackedGrid.all_to_all` across ranks: this rank's shards cut
        their ``split_axis`` into ``S`` chunks; chunk ``j`` goes to global
        shard ``j`` of the row through one ``all_to_all_single`` over the
        ranks of the row, and each local shard concatenates what it gets
        along ``concat_axis`` in global sender order."""
        R = self.rank_shape[axis]
        if R == 1:
            return super().all_to_all(st, axis, split_axis, concat_axis)
        if split_axis == concat_axis:
            raise ValueError("all_to_all: split_axis and concat_axis must "
                             "differ")
        S, b = self.shards[axis], self.block[axis]
        x = st.movedim(axis, 0)                  # (b, o1, o2, n0, n1, n2)
        L = x.shape[3 + split_axis]
        if L % S:
            raise ValueError(f"all_to_all: local axis {split_axis} of length "
                             f"{L} does not split into {S} chunks")
        x = x.unflatten(3 + split_axis, (S, L // S))
        send = x.movedim(3 + split_axis, 0)      # (S=j, b=s, o1, o2, ...)
        group, order = self._rows[axis]
        # pieces in group-rank order: piece g for the rank at coord order[g]
        send = send.unflatten(0, (R, b)).index_select(
            0, order.to(send.device))
        h = self._send_buf(send)
        recv = self._recv_buf(h)
        self.stats["calls"] += 1
        dist.all_to_all_single(recv, h, group=group)
        recv = self._back(recv)
        # recv[g]: (b_j, b_s, ...) from the rank at coord order[g]
        inv = torch.argsort(order).to(recv.device)
        y = recv.index_select(0, inv)            # (R, b_j, b_s, o1, o2, ...)
        y = y.movedim(0, 1).flatten(1, 2)        # (b_j, S=s, o1, o2, ...)
        y = y.movedim(1, 3 + concat_axis).flatten(3 + concat_axis,
                                                  4 + concat_axis)
        return y.movedim(0, axis).contiguous()


# -- global values -----------------------------------------------------------


def take_block(a, spec, grid):
    """This rank's part of a whole-stack array ``a`` (numpy or a tensor):
    ``spec`` names, per leading dim, the grid axis it is stacked over
    (JAX's PartitionSpec; ``None`` or a missing entry: replicated). A dim
    stacked over axis ``x`` splits into ``sx`` equal chunks and keeps the
    block's; ``AXES`` on the stacked layout keeps the leading
    ``(bx, by, bz)`` box."""
    if not spec:
        return a
    for d, name in enumerate(spec):
        if name is None:
            continue
        ax = AXES.index(name)
        S, o, b = grid.shards[ax], grid.origin[ax], grid.block[ax]
        if S == b:
            continue
        n = a.shape[d] // S
        if n * S != a.shape[d]:
            raise ValueError(f"dim {d} of length {a.shape[d]} does not "
                             f"split into {S} shards along {name}")
        idx = (slice(None),) * d + (slice(o * n, (o + b) * n),)
        a = a[idx]
    return a


def put_global(arr, layout, spec=AXES, *, device=None):
    """A whole-stack host value as this rank's tensor on ``device`` (by
    default the device `initialize` recorded for this rank, else CUDA).

    Every rank passes the same full host value (the set-up arrays are
    deterministic functions of the mesh, so each rank computes them
    alike): the rank slices its block on the host (`take_block` under
    ``spec``) and uploads only that. ``layout`` is a `StackedGrid` (the
    whole value) or a `RankGrid`."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach()
    blk = take_block(arr, spec, layout)
    if (isinstance(arr, torch.Tensor) and arr.device.type != "cpu"
            and blk.shape != arr.shape):
        raise ValueError("put_global cuts a host value; this device tensor "
                         "was uploaded whole before its block was cut")
    if not isinstance(blk, torch.Tensor):
        blk = torch.as_tensor(np.ascontiguousarray(blk))
    if device is None:
        device = rank_device() or "cuda"
    return blk.to(device=device).contiguous()


def put_tree(data, spec, layout, *, device):
    """`put_global` over a nested dict / list of set-up arrays: each
    tensor or numpy leaf under its ``spec`` leaf (missing: replicated);
    other leaves (ints, floats, None) pass through."""
    if isinstance(data, dict):
        spec = spec if isinstance(spec, dict) else {}
        return {k: put_tree(v, spec.get(k, ()), layout, device=device)
                for k, v in data.items()}
    if isinstance(data, (list, tuple)):
        specs = spec if isinstance(spec, (list, tuple)) and spec and all(
            isinstance(s, dict) for s in spec) else [()] * len(data)
        return type(data)(put_tree(v, s, layout, device=device)
                          for v, s in zip(data, specs))
    if isinstance(data, (torch.Tensor, np.ndarray)):
        return put_global(data, layout, spec, device=device)
    return data


def fetch_global(t, layout):
    """The whole stack of a rank-blocked tensor (leading dims the block)
    as a host numpy array on EVERY rank (through one ``all_gather``);
    on a `StackedGrid` the tensor itself."""
    if isinstance(layout, RankGrid):
        t = layout.gather_blocks(t)
    return t.detach().cpu().numpy()

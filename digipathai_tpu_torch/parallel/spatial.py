"""Row-sharded activations: one supertile computed by several devices.

JAX's spatially sharded tile step (``digipathai_tpu/engine/tile_infer.py::
build_tile_step_sp``) shards the padded tile's first spatial axis over an
``sp`` mesh, and GSPMD inserts every convolution's halo exchange and the
all-reduce of DeepLab's global pool.  PyTorch has no such partitioner: this
module is that layer, written out.

- ``RowShards``: an NHWC activation as D blocks of rows, block i on device
  i, with each block's first global row and the global height.
- ``partition(height, d)``: the rows strip i holds of a tensor of that
  height, ``[i * H // D, (i + 1) * H // D)``.  The padded tile (level 0,
  whose height D divides) splits evenly, as JAX's ``P("sp", None, None)``;
  deeper levels give strips thinner than a halo, and empty strips where the
  height is below D.  Every op's output takes this partition, so two
  tensors of one height always line up row for row.
- ``gather_rows(shards, lo, hi, device)``: global rows [lo, hi) on
  ``device``, copied from whichever blocks own them, and how many of those
  rows lie above and below the image.  Each op pads only there, as the
  unsharded op does; interior strip edges always take real rows.
- The spatial ops the models run (``conv2d``, ``max_pool2d``,
  ``avg_pool2d``, ``same_pad``, ``upsample2x``, ``repeat_interleave``,
  ``subsample``, ``resize_bilinear_align_corners``, ``global_mean``,
  ``all_max``, ``valid_rows``, and the kernels ``fused_conv3x3`` and
  ``fused_up_stage`` on gathered blocks).  Each works out, from a strip's
  output rows in global coordinates, the input rows it reads, gathers them
  and runs the unsharded op's own code on them.  Pointwise and channel ops
  (BatchNorm, relu, adds, channel concats, 1x1 convs, softmax) need no
  exchange and run on each strip unchanged.
- ``halo(x, rows)`` and ``local()``: a strip extended by a deep halo once,
  then several ops on it with no exchange (DenseNet's dense blocks: one
  exchange per block instead of one per layer).
- ``StripThreads(d).run(fn, modules, shards)`` (or ``run_lockstep`` for
  one run): ``fn(modules[i], strip i)`` for every strip at once, one
  thread per strip, so each strip runs its own model replica (on its own
  device) through the model's unchanged code.  The threads take turns (a
  baton passed in strip order), so launches are issued in a fixed order
  and only one thread runs Python at a time.  At each spatial op every
  strip posts its block, the baton goes round once, and each strip then
  gathers what it needs from the posted blocks.

Every op takes a tensor: inside a lockstep run the calling thread's
strip, whose output rows it computes; outside one a whole tensor, on
which it runs exactly the code the models ran before.

A run may also be a grid (``StripThreads.run_grid``, the mesh train step
of ``training/train.py``): each thread's ``Place`` names the threads whose
blocks are its row strips (``strips``, the ``sp`` axis), those that hold
the other channel slices of the sharded parameters (``channels``, ``mp``,
``parallel/channels.py``) and those whose batch statistics add up with its
own (``batch``: every batch shard and strip).  Every thread posts at every
exchange; each op reads the posts of its own group.  ``batch_sum`` (the
BatchNorm statistics and the loss sums) and ``rand`` (DeepLab's dropout
mask, drawn once for the whole batch) are the grid's own exchanges.

With gradients on, every exchange is differentiable: a block another
strip reads reaches it through ``torch.cat`` and ``Tensor.to``, so one
``backward()`` from the loss sends each strip's gradient back to the strip
that owns the rows it borrowed, whatever thread built that part of the
graph.

Blocks on different CUDA devices are copied on a side stream of the source
device that waits only for the block's own producer (an event recorded when
it was posted): PyTorch's cross-device ``copy_`` on the current streams
would make each card wait for the other's queue, and the cards would take
turns.  With gradients on, blocks cross devices with ``Tensor.to``, on the
current streams, so that autograd orders the backward's copies itself.
"""

from __future__ import annotations

import queue
import threading
from contextlib import contextmanager, nullcontext
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..ops import conv_fused, resize, stage_fused


class RowShards(NamedTuple):
    """An NHWC (or NHW) tensor as blocks of rows: ``blocks[i]`` (N, h_i,
    W, C) holds global rows ``[starts[i], starts[i] + h_i)`` of ``height``;
    the blocks are in row order and cover the rows without gaps.
    ``ready[i]``, when set, is a CUDA event after which block i is
    written."""
    blocks: tuple
    starts: tuple
    height: int
    ready: tuple = None

    @property
    def shape(self):
        n, _, *rest = self.blocks[0].shape
        return (n, self.height, *rest)


def partition(height: int, d: int) -> List[Tuple[int, int]]:
    """The global rows [lo, hi) of each of ``d`` strips of ``height``."""
    return [(i * height // d, (i + 1) * height // d) for i in range(d)]


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


# ----------------------------------------------------------- lockstep runs

_local = threading.local()


class Place(NamedTuple):
    """Where a thread's block lies in a run: the run's thread indices
    (ranks) of its row strips in row order (``strips``, itself among them),
    of the threads holding the channel slices of the sharded parameters in
    slice order (``channels``), and of the threads whose batch statistics
    add up with its own (``batch``); ``shard``: (its batch shard, the
    number of shards) of the global batch."""
    rank: int
    strips: tuple
    channels: tuple
    batch: tuple
    shard: tuple = (0, 1)


class _Aborted(Exception):
    """Another strip failed: this one stops too."""


class _Lockstep:
    """D threads that take turns: thread i runs while it holds the baton;
    ``exchange`` posts a value, hands the baton on and returns every
    strip's post once the baton comes back (each thread has then posted
    the same exchange).  Thread i waits on a lock of its own, held until
    the thread before it releases it (a plain lock: a
    ``threading.Semaphore`` costs a Python-level condition per hand-on).
    ``cross``: the strips lie on more than one device, so posted blocks
    carry ready events."""

    def __init__(self, d: int, cross: bool):
        self.d = d
        self.cross = cross
        self.batons = [threading.Lock() for _ in range(d)]
        for lock in self.batons:
            lock.acquire()
        self.finished = [False] * d
        self.count = [0] * d
        self.rounds = {}  # exchange index -> [posts, reads left]
        self.error = None

    def _next(self, rank):
        for k in range(1, self.d):
            j = (rank + k) % self.d
            if not self.finished[j]:
                return j
        return rank

    def _wait(self, rank):
        self.batons[rank].acquire()
        if self.error is not None:
            raise _Aborted()

    def _release(self, rank):
        try:
            self.batons[rank].release()
        except RuntimeError:  # already free: only after a failure
            pass

    def _hand_on(self, rank):
        nxt = self._next(rank)
        if nxt != rank:
            self._release(nxt)
        return nxt

    def exchange(self, rank, value):
        k = self.count[rank]
        self.count[rank] += 1
        entry = self.rounds.setdefault(k, [[None] * self.d, self.d])
        entry[0][rank] = value
        if self._hand_on(rank) != rank:
            self._wait(rank)
        posts = entry[0]
        if any(p is None for p in posts):
            raise RuntimeError(f"lockstep: strip {posts.index(None)} did "
                               f"not reach exchange {k}: the strips ran "
                               f"different code paths")
        entry[1] -= 1
        if not entry[1]:
            del self.rounds[k]
        return posts

    def fail(self, exc):
        if self.error is None:
            self.error = exc
        for rank in range(self.d):
            self._release(rank)

    def finish(self, rank):
        self.finished[rank] = True
        self._hand_on(rank)


def _ctx():
    """(the run's ``_Lockstep``, this thread's ``Place``), or None outside
    a lockstep run."""
    return getattr(_local, "ctx", None)


def sharded() -> bool:
    """Whether this thread runs a strip of a lockstep run (its tensors are
    row strips)."""
    return _ctx() is not None


class StripThreads:
    """D threads that live across runs, thread i running strip i of each
    (``run``).  They must outlive one forward: PyTorch keeps cuDNN's
    execution plans per thread, so a fresh thread per forward plans every
    conv again (about 0.7 ms of host time per conv on an H100 host).
    ``close`` (or leaving a ``with`` block) ends them; one run at a
    time."""

    def __init__(self, d: int):
        self.d = d
        self._jobs = [queue.SimpleQueue() for _ in range(d)]
        self._done = queue.SimpleQueue()
        self._lock = threading.Lock()
        self._threads = [threading.Thread(target=self._serve, args=(i,),
                                          daemon=True, name=f"dpai-sp-{i}")
                         for i in range(d)]
        for t in self._threads:
            t.start()

    def _serve(self, rank):
        while True:
            job = self._jobs[rank].get()
            if job is None:
                return
            job(rank)
            self._done.put(rank)

    def run(self, fn: Callable, modules: Sequence,
            shards: RowShards) -> RowShards:
        """``fn(modules[i], block i)`` for every strip of ``shards``, in
        lockstep, each on its block's device (CUDA's current device there)
        and under the caller's grad and inference modes.  Each call returns
        its strip of an NHWC-like tensor (rows on axis 1); the result is
        their ``RowShards``.  A failure in one strip stops every strip and
        is raised here."""
        every = tuple(range(len(shards.blocks)))
        return _assemble(self.run_grid(
            fn, modules, shards.blocks, [b.device for b in shards.blocks],
            [Place(r, every, (r,), every) for r in every]))

    def run_grid(self, fn: Callable, modules: Sequence, args: Sequence,
                 devices: Sequence, places: Sequence[Place]) -> list:
        """``fn(modules[i], args[i])`` for every thread i at once, in
        lockstep, on ``devices[i]`` at ``places[i]``, under the caller's
        grad and inference modes -> the calls' results in order.  A failure
        in one thread stops every thread and is raised here."""
        d = len(args)
        if not (len(modules) == len(devices) == len(places) == d == self.d):
            raise ValueError(f"StripThreads.run: {len(modules)} modules and "
                             f"{d} blocks for {self.d} threads")
        devices = [torch.device(dev) for dev in devices]
        step = _Lockstep(d, len(set(devices)) > 1)
        out = [None] * d
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()

        def work(rank):
            try:
                step._wait(rank)
                _local.ctx = (step, places[rank])
                dev = devices[rank]
                guard = (torch.cuda.device(dev) if dev.type == "cuda"
                         else nullcontext())
                with torch.inference_mode(inference), \
                        torch.set_grad_enabled(grad), guard:
                    out[rank] = fn(modules[rank], args[rank])
            except _Aborted:
                pass
            except BaseException as e:  # noqa: B902 - the caller re-raises
                step.fail(e)
            finally:
                _local.ctx = None
                step.finish(rank)

        with self._lock:
            for jobs in self._jobs:
                jobs.put(work)
            step._release(0)
            for _ in range(d):
                self._done.get()
        if step.error is not None:
            raise step.error
        return out

    def close(self):
        for jobs in self._jobs:
            jobs.put(None)
        for t in self._threads:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def run_lockstep(fn: Callable, modules: Sequence,
                 shards: RowShards) -> RowShards:
    """``StripThreads.run`` on threads of its own, ended after the run."""
    with StripThreads(len(shards.blocks)) as threads:
        return threads.run(fn, modules, shards)


def _record(t: torch.Tensor):
    """An event after the work that writes ``t`` (a CUDA tensor that
    another device reads)."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def _assemble(blocks, ready=None) -> RowShards:
    starts, at = [], 0
    for b in blocks:
        starts.append(at)
        at += b.shape[1]
    return RowShards(tuple(blocks), tuple(starts), at,
                     None if ready is None else tuple(ready))


def _exchange(values, axis: Optional[str] = "strips"):
    """In a lockstep run: ``values`` (a tuple) as every thread of this
    thread's group along ``axis`` posted them (a ``Place`` field; None:
    every thread of the run), each tensor with its ready event, and this
    thread's index in the group."""
    step, place = _ctx()
    posts = step.exchange(place.rank, tuple(
        (v, _record(v)) if step.cross and isinstance(v, torch.Tensor)
        else (v, None) for v in values))
    if axis is None:
        return posts, place.rank
    group = getattr(place, axis)
    return [posts[r] for r in group], group.index(place.rank)


def _strip_shards(posts, j) -> RowShards:
    return _assemble([p[j][0] for p in posts], [p[j][1] for p in posts])


# ------------------------------------------------------------- gathering

def _side_stream(device):
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def _copy(dst: torch.Tensor, src: torch.Tensor, ready=None):
    """``dst.copy_(src)``; across CUDA devices on a side stream of the
    source device that waits for ``ready`` only."""
    if src.device == dst.device or not (src.is_cuda and dst.is_cuda):
        dst.copy_(src)
        return
    side = _side_stream(src.device)
    with torch.cuda.stream(side):
        if ready is not None:
            side.wait_event(ready)
        else:
            side.wait_stream(torch.cuda.default_stream(src.device))
        dst.copy_(src, non_blocking=True)
    src.record_stream(side)


def gather_rows(shards: RowShards, lo: int, hi: int, device, fill=None):
    """Global rows [lo, hi) of ``shards`` on ``device``:
    ``(block, above, below)`` where ``above`` and ``below`` count the rows
    that lie outside the image.  With ``fill=None`` the block holds the
    in-image rows only; otherwise all hi - lo rows, those outside the image
    set to ``fill``.  A range inside one block on ``device`` comes back as
    a view of it."""
    device = torch.device(device)
    h = shards.height
    above = max(0, min(hi, 0) - lo)
    below = max(0, hi - max(lo, h))
    rlo, rhi = max(lo, 0), min(hi, h)
    pieces = []
    for i, (b, s) in enumerate(zip(shards.blocks, shards.starts)):
        a, e = max(rlo, s), min(rhi, s + b.shape[1])
        if a < e:
            ev = shards.ready[i] if shards.ready else None
            pieces.append((b[:, a - s:e - s], ev))
    pad = fill is not None and (above or below)
    if not pad and pieces and all(p.device == device for p, _ in pieces):
        # one launch (or none) where every piece is on ``device``
        if len(pieces) == 1:
            return pieces[0][0], above, below
        return torch.cat([p for p, _ in pieces], dim=1), above, below
    real = max(0, rhi - rlo)
    rows = hi - lo if fill is not None else real
    shape = list(shards.blocks[0].shape)
    if torch.is_grad_enabled() and any(p.requires_grad for p, _ in pieces):
        # differentiable: the backward returns each piece's gradient to its
        # owner
        parts = [p.to(device) for p, _ in pieces]
        if fill is not None:
            top = min(above, rows)
            sides = []
            for n in (top, rows - top - real):
                shape[1] = n
                sides.append(parts[0].new_full(shape, fill))
            parts = [sides[0], *parts, sides[1]]
        return torch.cat(parts, dim=1), above, below
    shape[1] = rows
    out = torch.empty(shape, dtype=shards.blocks[0].dtype, device=device)
    at = 0
    if fill is not None:
        top = min(above, rows)
        if top:
            out[:, :top].fill_(fill)
        if below:
            out[:, rows - below:].fill_(fill)
        at = top
    for p, ev in pieces:
        _copy(out[:, at:at + p.shape[1]], p, ev)
        at += p.shape[1]
    return out, above, below


def shard_rows(x: torch.Tensor, devices) -> RowShards:
    """``x`` (N, H, W, C) split into ``partition(H, len(devices))``, strip
    i contiguous on ``devices[i]``."""
    devices = [torch.device(d) for d in devices]
    ev = _record(x) if any(d != x.device for d in devices) else None
    blocks = []
    for (a, b), dev in zip(partition(x.shape[1], len(devices)), devices):
        rows = x[:, a:b]
        if dev == x.device:
            blocks.append(rows.contiguous())
        else:
            out = torch.empty(rows.shape, dtype=x.dtype, device=dev)
            _copy(out, rows, ev)
            blocks.append(out)
    return _assemble(blocks)


def unshard(shards: RowShards, device) -> torch.Tensor:
    """The whole tensor on ``device``."""
    return gather_rows(shards, 0, shards.height, device)[0]


@contextmanager
def local():
    """Inside it this thread's spatial ops run as on a whole tensor, with
    no exchange (on a strip that ``halo`` extended)."""
    ctx = _ctx()
    _local.ctx = None
    try:
        yield
    finally:
        _local.ctx = ctx


def halo(x, rows: int):
    """``(extended, keep)``: inside a lockstep run, this thread's strip with
    up to ``rows`` more rows on each side (clamped to the image, taken from
    whichever strips own them) and ``keep(t)``, the strip's own rows of a
    tensor of the extended strip's height.  Ops run under ``local()`` on
    the extended strip spoil at most their radius at its interior edges
    per op, so ``rows`` must cover the radii of the ops in between: one
    exchange then serves them all.  Outside a lockstep run: ``(x,
    identity)``."""
    if not sharded():
        return x, lambda t: t
    posts, rank = _exchange((x,))
    shards = _strip_shards(posts, 0)
    a = shards.starts[rank]
    b = a + x.shape[1]
    lo = max(0, a - rows)
    ext, _, _ = gather_rows(shards, lo, min(shards.height, b + rows),
                            x.device)
    return ext, lambda t: t[:, a - lo:b - lo]


def shape(x) -> tuple:
    """The global shape of ``x`` (one exchange inside a lockstep run)."""
    if not sharded():
        return tuple(x.shape)
    posts, _ = _exchange((x.shape[1],))
    return (x.shape[0], sum(p[0][0] for p in posts), *x.shape[2:])


def _rowwise(x, out_height: Callable[[int], int], strip, inputs=None):
    """Run a spatial op on this thread's strip of a lockstep run.
    ``strip(shards, a, b, device)`` computes output rows [a, b) of the op,
    whose output height is ``out_height(H)`` for an input of height H;
    ``shards`` holds the ``RowShards`` of ``inputs`` (default ``(x,)``)
    as every strip posted them."""
    posts, rank = _exchange((x,) if inputs is None else inputs)
    shards = [_strip_shards(posts, j) for j in range(len(posts[0]))]
    a, b = partition(out_height(shards[0].height), len(posts))[rank]
    return strip(shards, a, b, x.device)


def _empty(ref: torch.Tensor, w: int, c: int, device):
    return torch.empty((ref.shape[0], 0, w, c), dtype=ref.dtype,
                       device=device)


def _nchw(x):
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1).contiguous()


# -------------------------------------------------------------- the ops

def conv2d(x, w: torch.Tensor, stride: int = 1, padding=0, dilation: int = 1,
           groups: int = 1):
    """``F.conv2d`` on NHWC ``x`` with an OIHW ``w``; zero padding
    ``padding`` (an int or (rows, columns)).  Sharded, each strip takes
    its input rows with zeros where they lie outside the image and runs
    the conv without row padding."""
    def plain(t, w, padding):
        return _nhwc(F.conv2d(_nchw(t), w, stride=stride, padding=padding,
                              dilation=dilation, groups=groups))

    if not sharded():
        return plain(x, w, padding)
    ph, pw = _pair(padding)
    kh, kw = w.shape[2], w.shape[3]

    def wo(width):
        return (width + 2 * pw - dilation * (kw - 1) - 1) // stride + 1

    if kh == 1 and stride == 1 and ph == 0:
        # row-local: each strip alone
        if x.shape[1] == 0:
            return _empty(x, wo(x.shape[2]), w.shape[0], x.device)
        return plain(x, w, padding)
    keff = dilation * (kh - 1) + 1

    def strip(shards, a, b, dev):
        s = shards[0]
        if a == b:
            return _empty(s.blocks[0], wo(s.shape[2]), w.shape[0], dev)
        lo = stride * a - ph
        blk, _, _ = gather_rows(s, lo, stride * (b - 1) - ph + keff, dev,
                                fill=0.0)
        return plain(blk, w, (0, pw))

    return _rowwise(x, lambda h: (h + 2 * ph - keff) // stride + 1, strip)


def _pool(x, plain, k: int, stride: int, p: int):
    """A pool with implicit padding ``p``: each strip runs ``plain`` (the
    unsharded pool, padding p on both axes) on its in-image rows, starting
    at a multiple of the stride, and keeps its own output rows.  The
    padding that lands at an interior strip edge only reaches rows it
    drops."""
    if not sharded():
        return plain(x)

    def strip(shards, a, b, dev):
        s = shards[0]
        if a == b:
            wo = (s.shape[2] + 2 * p - k) // stride + 1
            return _empty(s.blocks[0], wo, s.shape[3], dev)
        lo = max(0, stride * (a - -(-p // stride)))
        blk, _, _ = gather_rows(s, lo, stride * (b - 1) - p + k, dev)
        j = a - lo // stride
        return plain(blk)[:, j:j + b - a]

    return _rowwise(x, lambda h: (h + 2 * p - k) // stride + 1, strip)


def max_pool2d(x, k: int, stride: Optional[int] = None, padding: int = 0):
    """``F.max_pool2d`` on NHWC ``x`` (-inf padding)."""
    return _pool(x, lambda t: _nhwc(F.max_pool2d(
        _nchw(t), k, stride=stride, padding=padding)), k,
        k if stride is None else stride, padding)


def avg_pool2d(x, k: int, stride: Optional[int] = None, padding: int = 0,
               count_include_pad: bool = True):
    """``F.avg_pool2d`` on NHWC ``x``; with ``count_include_pad=False``
    the padded cells count in no mean, sharded or not.  With gradients on,
    that case pools a contiguous NCHW copy: on a channels-last input,
    CUDA's backward of it gives wrong input gradients (torch 2.11, cu128;
    ``chip_smoke.py`` phase 4e holds the card's train step to the
    CPU's)."""
    def nchw(t):
        t = _nchw(t)
        if count_include_pad or not padding or not torch.is_grad_enabled():
            return t
        return t.contiguous()

    return _pool(x, lambda t: _nhwc(F.avg_pool2d(
        nchw(t), k, stride=stride, padding=padding,
        count_include_pad=count_include_pad)), k,
        k if stride is None else stride, padding)


def same_pad_amounts(n: int, k: int, stride: int) -> Tuple[int, int]:
    """flax/TF "SAME" padding of a side of ``n`` at ``stride``: total
    ``max((ceil(n / s) - 1) * s + k - n, 0)``, the smaller half before."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def same_pad(x, kh: int, kw: int, stride: int):
    """Pad NHWC ``x`` with zeros as flax/TF "SAME" does at ``stride``.  At
    stride 2 on an even side that is (0, 1), where ``F.conv2d(padding=1)``
    would pad (1, 1) and shift the grid.  Sharded, the row padding depends
    on the global height: the first strip takes the rows above, the last
    those below (the next op's strips gather across them)."""
    if not sharded():
        pads = []
        for n, k in ((x.shape[2], kw), (x.shape[1], kh)):  # last dim first
            pads += list(same_pad_amounts(n, k, stride))
        return F.pad(x, (0, 0, *pads))
    posts, rank = _exchange((x.shape[1],))
    top, bottom = same_pad_amounts(sum(p[0][0] for p in posts), kh, stride)
    return F.pad(x, (0, 0, *same_pad_amounts(x.shape[2], kw, stride),
                     top if rank == 0 else 0,
                     bottom if rank == len(posts) - 1 else 0))


def _nearest(x, k: int, plain):
    """A nearest upsample by ``k`` on both axes: output row r reads input
    row r // k."""
    if not sharded():
        return plain(x)

    def strip(shards, a, b, dev):
        s = shards[0]
        if a == b:
            return _empty(s.blocks[0], k * s.shape[2], s.shape[3], dev)
        lo = a // k
        blk, _, _ = gather_rows(s, lo, (b - 1) // k + 1, dev)
        return plain(blk)[:, a - k * lo:b - k * lo]

    return _rowwise(x, lambda h: k * h, strip)


def upsample2x(x):
    """Nearest-neighbour 2x upsampling of NHWC ``x``
    (``ops/stage_fused.py::upsample2x``)."""
    return _nearest(x, 2, stage_fused.upsample2x)


def repeat_interleave(x, k: int):
    """Each pixel of NHWC ``x`` repeated k times along rows and columns."""
    return _nearest(x, k, lambda t: t.repeat_interleave(
        k, dim=1).repeat_interleave(k, dim=2))


def subsample(x, stride: int):
    """``x[:, ::stride, ::stride]``: global rows 0, s, 2s, ..."""
    if stride == 1 or not sharded():
        return x[:, ::stride, ::stride] if stride > 1 else x
    return valid_rows(x, 1, stride, lambda t: t[:, ::stride, ::stride])


def valid_rows(x, k: int, stride: int, fn, cout: Optional[int] = None,
               kw: Optional[int] = None):
    """An op that reads rows ``[s * r, s * r + k)`` for output row r (a
    VALID k x kw window at stride s, as ``models/quant.py::int8_conv`` on a
    padded input).  ``fn`` is the unsharded op; sharded, each strip runs it
    on its rows from a multiple of the stride on.  ``cout`` (default the
    input's channels) and ``kw`` (default k) shape an empty strip."""
    def empty(ref, width, dev):
        wo = (width - (k if kw is None else kw)) // stride + 1
        return _empty(ref, wo, cout or ref.shape[3], dev)

    if not sharded() or (k == 1 and stride == 1):
        if sharded() and x.shape[1] == 0:
            return empty(x, x.shape[2], x.device)
        return fn(x)

    def strip(shards, a, b, dev):
        s = shards[0]
        if a == b:
            return empty(s.blocks[0], s.shape[2], dev)
        blk, _, _ = gather_rows(s, stride * a, stride * (b - 1) + k, dev)
        return fn(blk)

    return _rowwise(x, lambda h: (h - k) // stride + 1, strip)


def resize_bilinear_align_corners(x, out_hw, replicated: bool = False):
    """``ops/resize.py::resize_bilinear_align_corners`` of NHWC ``x``.
    Sharded, each strip interpolates its output rows from the source rows
    that ``_axis_tables`` maps them to.  ``replicated``: ``x`` is the same
    whole tensor on every strip, and only the output is sharded."""
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if not sharded():
        return resize.resize_bilinear_align_corners(x, out_hw)

    def rows(src: RowShards, a, b, dev):
        ref = src.blocks[0]
        if a == b:
            return ref.new_empty((ref.shape[0], 0, ow, *ref.shape[3:]),
                                 device=dev)
        n_in = src.height
        lo, hi = resize.source_rows(n_in, oh, a, b)
        blk, _, _ = gather_rows(src, lo, hi, dev)
        rest = [1] * (blk.dim() - 3)
        i0, i1, w1 = resize._axis_tables(n_in, oh, dev)
        xf = resize.lerp(resize.wide(blk), i0[a:b] - lo, i1[a:b] - lo,
                         w1[a:b].reshape(1, -1, 1, *rest), 1)
        j0, j1, v1 = resize._axis_tables(blk.shape[2], ow, dev)
        return resize.lerp(xf, j0, j1, v1.reshape(1, 1, -1, *rest), 2).to(
            blk.dtype)

    if replicated:  # each strip computes its rows from its whole copy
        place = _ctx()[1]
        a, b = partition(oh, len(place.strips))[
            place.strips.index(place.rank)]
        return rows(_assemble([x]), a, b, x.device)
    return _rowwise(x, lambda h: oh, lambda s, a, b, dev: rows(s[0], a, b,
                                                                 dev))


def global_mean(y):
    """The mean of NHWC ``y`` over rows and columns in f32 (or y's dtype
    where it is wider), (N, 1, 1, C) in y's dtype.  Sharded: each strip's
    sum, the sums added in strip order on every strip's device and divided
    by the global count; the result is the same whole tensor on every
    strip."""
    wide = y.to(torch.promote_types(y.dtype, torch.float32))
    if not sharded():
        return wide.mean(dim=(1, 2), keepdim=True).to(y.dtype)
    posts, _ = _exchange((wide.sum(dim=(1, 2), keepdim=True), y.shape[1]))
    total = None
    for (s, ev), _ in posts:
        s = _on(s, ev, y.device)
        total = s if total is None else total + s
    count = sum(p[1][0] for p in posts) * y.shape[2]
    return (total / count).to(y.dtype)


def all_max(t: torch.Tensor) -> torch.Tensor:
    """A 0-d tensor's maximum over the strips, on this strip's device (the
    tensor itself outside a lockstep run)."""
    if not sharded():
        return t
    posts, _ = _exchange((t,))
    out = None
    for (v, ev), in posts:
        v = _on(v, ev, t.device)
        out = v if out is None else torch.maximum(out, v)
    return out


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this thread's ``batch`` group (every batch shard
    and strip that holds the same channel slice), in group order, on this
    thread's device: the BatchNorm statistics' and the loss's sums.
    Differentiable.  Outside a lockstep run: ``t``."""
    if not sharded():
        return t
    posts, _ = _exchange((t,), "batch")
    out = None
    for (v, ev), in posts:
        v = _on(v, ev, t.device)
        out = v if out is None else out + v
    return out


def rand(y: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """``torch.rand`` of ``y``'s shape from ``generator`` (on its device).
    Inside a lockstep run ``y`` is this thread's block of a tensor whose
    batch is split over ``Place.shard`` and whose rows over the strips: the
    whole tensor's numbers are drawn once, by the run's first thread, as
    the unsharded forward draws them, and each thread takes its block."""
    if not sharded():
        return torch.rand(y.shape, generator=generator,
                          device=generator.device).to(y.device)
    place = _ctx()[1]
    height = shape(y)[1]
    i, k = place.shard
    n = y.shape[0]
    whole = (torch.rand((n * k, height, *y.shape[2:]), generator=generator,
                        device=generator.device)
             if place.rank == 0 else None)
    posts, _ = _exchange((whole,), None)
    (whole, ev), = posts[0]
    a, b = partition(height, len(place.strips))[
        place.strips.index(place.rank)]
    return _on(whole[i * n:(i + 1) * n, a:b], ev, y.device)


def _on(t: torch.Tensor, ready, device) -> torch.Tensor:
    """A small posted tensor on ``device``."""
    if t.device == device:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return t.to(device)
    out = torch.empty_like(t.contiguous(), device=device)
    _copy(out, t, ready)
    return out


# ------------------------------------------------- the kernels, on blocks

def fused_conv3x3(x, k, *args, **kw):
    """``ops/conv_fused.py::fused_conv3x3``.  Sharded, each strip runs the
    kernel on its rows and one real row on each interior side (the kernel's
    pre-activation reaches those rows, which are in the image) and keeps
    its own rows; at the image's edges the kernel's zero halo is the SAME
    padding."""
    if not sharded():
        return conv_fused.fused_conv3x3(x, k, *args, **kw)
    f = k.f if isinstance(k, conv_fused.ConvOperands) else k.shape[-1]

    def strip(shards, a, b, dev):
        s = shards[0]
        if a == b:
            return _empty(s.blocks[0], s.shape[2], f, dev)
        lo, hi = max(0, a - 1), min(s.height, b + 1)
        blk, _, _ = gather_rows(s, lo, hi, dev)
        out = conv_fused.fused_conv3x3(blk.contiguous(), k, *args, **kw)
        return out[:, a - lo:b - lo]

    return _rowwise(x, lambda h: h, strip)


def fused_up_stage(y, ka, biasa, mula, adda, kb, biasb, mulb, addb,
                   skip=None, *, relu=True):
    """``ops/stage_fused.py::fused_up_stage``.  Sharded, output rows
    [a, b) come from y rows [a // 2 - 1, (b + 3) // 2) (clamped to the
    image) and the matching rows of ``skip``: the upsampled block starts at
    an even row, so convA's folded parity taps are those of the whole
    image, and the two rows at each interior edge that the block's zero
    halo spoils (convA's, then convB's) lie outside [a, b)."""
    if not sharded():
        return stage_fused.fused_up_stage(y, ka, biasa, mula, adda, kb,
                                          biasb, mulb, addb, skip, relu=relu)
    f = ka.f if isinstance(ka, conv_fused.ConvOperands) else ka.shape[-1]

    def strip(shards, a, b, dev):
        s = shards[0]
        if a == b:
            return _empty(s.blocks[0], 2 * s.shape[2], f, dev)
        lo, hi = max(0, a // 2 - 1), min(s.height, (b + 3) // 2)
        yb, _, _ = gather_rows(s, lo, hi, dev)
        sk = None
        if skip is not None:
            sk, _, _ = gather_rows(shards[1], 2 * lo, 2 * hi, dev)
        out = stage_fused.fused_up_stage(
            yb.contiguous(), ka, biasa, mula, adda, kb, biasb, mulb, addb,
            sk, relu=relu)
        return out[:, a - 2 * lo:b - 2 * lo]

    inputs = (y,) if skip is None else (y, skip)
    return _rowwise(y, lambda h: 2 * h, strip, inputs)

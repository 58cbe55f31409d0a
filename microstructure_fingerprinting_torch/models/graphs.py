"""One CUDA graph a chunk step.

The JAX package compiles each chunk step into one program (``jax.jit``
of ``_twopass_step3``, ``fit_step`` and the rest) and XLA caches the
program by the shapes of its arguments. This module is the port's
counterpart: ``run(step, *args, **statics)`` runs ``step`` as one
captured ``torch.cuda.CUDAGraph``, replayed for every chunk of the same
key, so a chunk's few thousand small torch ops and its kernel launches
reach the card in one launch of the graph.

Key: the step, the device, the shape, strides and dtype of each tensor
argument, every other positional argument itself (``None``, a rotation
closure: held by the cache, so what it reads on the device stays
alive), and the static keyword arguments (R, K, csf_on, ear_on, M).

Route: a step replays a graph when its tensors lie on a CUDA device, no
``utils.profiling.StageTimer`` is active (its events cannot be recorded
inside a replay) and no ``eager()`` block is open; otherwise it runs
eagerly, as it always does on the CPU. A ``torch.profiler`` leaves the
route as it is. Spans (``utils.profiling.stage``): "capture" (a key's
eager first chunk, warm-up and capture) and "replay" (a chunk's input
copies, replay and output clones).

On a key's first chunk the step runs eagerly: that chunk's results and
launches are real. Then the kernel library is built, the step is run
once on a side stream to warm up, and it is captured into the graph,
every graph of a device drawing on one memory pool. Every later chunk
copies each tensor argument into the graph's own input tensors (the
tables and fixed columns too: a graph never reads a freed tensor or an
earlier model's), replays, and clones the outputs out at once on the
same stream (another graph's replay may reuse the pool's memory that
holds them). A capture or a replay that fails raises: nothing hands a
chunk over to eager execution.

``ops/kernels.LAUNCHES`` counts what the card runs: the launches of the
warm-up and of the capture are not counted, those of the capture are
kept as the graph's launches a replay, and each replay adds them.
"""

import contextlib
import time

import torch
from torch.utils import _pytree as pytree

from ..ops import kernels
from ..utils import profiling

_EAGER = []


class _Card:
    """What a capture and a replay ask of the card, in one place (the
    tests hand in a stand-in that runs on the CPU)."""

    device_type = "cuda"

    def __init__(self):
        self.streams = {}

    def graph(self):
        return torch.cuda.CUDAGraph()

    def pool(self):
        return torch.cuda.graph_pool_handle()

    def device(self, dev):
        return torch.cuda.device(dev)

    def warm_up(self, fn, dev):
        """fn() on a side stream, as the ``torch.cuda.graph``
        documentation asks before a capture; builds the kernel library
        first, so that no build or load happens inside a capture."""
        kernels.library()
        main = torch.cuda.current_stream(dev)
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)

    def capturing(self, graph, pool, dev):
        """The capture context, on a capture stream of ``dev``'s own (the
        default one lies on the card current at its first use)."""
        stream = self.streams.get(dev)
        if stream is None:
            stream = self.streams[dev] = torch.cuda.Stream(dev)
        return torch.cuda.graph(graph, pool=pool, stream=stream)


_CARD = _Card()


class _Entry:
    """One captured step: its graph, input and output tensors, and its
    launches a replay."""

    def __init__(self, step, args, statics, dev, pool):
        self.name = step.__name__
        self.statics = dict(statics)
        self.replays = 0
        with _CARD.device(dev):
            self.inputs = [a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args]
            with kernels.recorded():
                _CARD.warm_up(lambda: step(*self.inputs, **statics), dev)
            self.graph = _CARD.graph()
            t0 = time.perf_counter()
            with kernels.recorded() as self.launches, \
                    _CARD.capturing(self.graph, pool, dev):
                self.outputs = step(*self.inputs, **statics)
            self.capture_s = time.perf_counter() - t0

    def replay(self, args, dev):
        with profiling.stage("replay"), _CARD.device(dev):
            for mine, a in zip(self.inputs, args):
                if isinstance(mine, torch.Tensor):
                    mine.copy_(a)
            self.graph.replay()
            kernels.add_counts(self.launches)
            self.replays += 1
            return pytree.tree_map(
                lambda t: t.clone() if isinstance(t, torch.Tensor) else t,
                self.outputs)


_ENTRIES = {}
_POOLS = {}


def _key(step, args, statics, dev):
    parts = tuple((tuple(a.shape), a.stride(), a.dtype)
                  if isinstance(a, torch.Tensor) else a for a in args)
    return step, dev, parts, tuple(sorted(statics.items()))


def graphed(dev):
    """Whether a step on ``dev`` runs as a graph now."""
    return (dev.type == _CARD.device_type and not _EAGER
            and not profiling.active())


def run(step, *args, **statics):
    """``step(*args, **statics)``, as a replay of its graph where
    ``graphed`` says so (captured on the key's first chunk, which runs
    eagerly), else eagerly."""
    dev = kernels.operand_device(args)
    if not graphed(dev):
        return step(*args, **statics)
    key = _key(step, args, statics, dev)
    entry = _ENTRIES.get(key)
    if entry is None:
        with profiling.stage("capture"):
            out = step(*args, **statics)
            pool = _POOLS.get(dev)
            if pool is None:
                pool = _POOLS[dev] = _CARD.pool()
            _ENTRIES[key] = _Entry(step, args, statics, dev, pool)
        return out
    return entry.replay(args, dev)


@contextlib.contextmanager
def eager():
    """Steps on the card run eagerly inside this block (the comparison
    of the two routes, and tests)."""
    _EAGER.append(True)
    try:
        yield
    finally:
        _EAGER.pop()


def stats():
    """One record a cached graph: the step's name, its device and static
    arguments, the seconds of its capture, its replays and its launches
    a replay."""
    return [dict(step=e.name, device=str(key[1]), statics=e.statics,
                 capture_s=e.capture_s, replays=e.replays,
                 launches={k: v for k, v in e.launches.items() if v})
            for key, e in _ENTRIES.items()]


def clear():
    """Drop every cached graph and memory pool; the pools' memory goes
    back to PyTorch's allocator (``torch.cuda.empty_cache()`` then
    returns it to the card)."""
    _ENTRIES.clear()
    _POOLS.clear()

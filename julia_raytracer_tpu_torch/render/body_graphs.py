"""CUDA-graph replay of the wavefront loop's bounce bodies.

`trace_wavefront`'s while loop issues a bounce body as some 800 eager
ops from Python. At 1,048,576 lanes the host takes longer to issue them
than the card takes to run them. At one lane width, though, a body is a
fixed program:
  - every shape is a function of the width;
  - the loop test that reads the device sits outside the body;
  - the random numbers come from the lanes' PCG streams, not the host;
  - an Intersector that is `graph_safe` (ops/traversal.py) issues no
    host read and decides no allocation on the host (the dense kernel's
    ctypes launch goes onto PyTorch's current stream).
So it can be captured once into a CUDA graph and replayed. `bounce_step`
stays the one definition of a bounce: the eager path and the capture both
run it.

`BodyGraphs` is the cache of one caller: the Renderer that owns the
scene and the intersector. `for_trace` binds it to one trace. It returns
None, so the trace runs eager bodies, unless all of these hold:
  - the state lies on the capture's device (the card);
  - the loop is the while loop, not the fixed-trip one;
  - no TorchDispatchMode is active, so `Renderer.sample_kernel_cost`
    and `utils/roofline.count_cost` still see every op;
  - the trace's Intersector is `graph_safe`.

Graphs are keyed by the lane width within what a body reads by address:
the scene's tensors, its config, the options and the Intersector. A
trace that reads other ones drops every graph. A width's first body runs
eagerly, which also serves as the graph's warm-up. Its second is
captured and replayed, and every later body at that width is a replay.
A capture that raises leaves its width eager.

Each graph reads the static state `state` and ends by writing the new
state back into the same buffers. So consecutive bodies at one width
need no host work besides the replay. A state arriving from elsewhere
(the primary hit, a compaction's output) is copied in once. A state that
must outlive a later replay at its width is `keep`-ed: it is copied
before that graph writes its buffers again. `release` copies the trace's
outputs out of the buffers.

The program's counters that a body ticks from Python (utils/timing.py
`counters()`, every one registered) tick once, at the capture. The
change they made there is added again at every later replay, so they
read what eager bodies would.

The device_spans a body opens (the work-item intersector's `precull`
and `inst_walk`) are captured under utils/timing.py `capturing`: their
clock stamps and tensor counts go to an int64 record of the graph, the
stamps on the same %globaltimer clock as an eager span's, and they add
nothing at the capture. After each replay, the one right after the
capture included, the record is copied out of the graph (one small
copy) and filed under the open `body` span, one row entry per span with
`n`, its integer counts and, read when the units are, `device_ns` and
its tensor counts. A graph whose body opens no device_span keeps no
record and adds no launch at replay.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from julia_raytracer_tpu_torch.utils import timing


def _buffer(x) -> int:
    return x.untyped_storage().data_ptr()


def _tensors(x):
    """The tensors of `x`, a tensor or a (named) tuple of them, nested."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for item in x:
            yield from _tensors(item)


class CudaCapture:
    """Captures a body into a torch.cuda.CUDAGraph. Every graph of one
    BodyGraphs shares one memory pool: its replays run one after another
    on one stream, and each graph's outputs are written back into buffers
    outside the pool, so no graph's pool memory outlives its replay."""

    device_type = "cuda"

    def __init__(self):
        self.pool = None

    def __call__(self, run, buffers):
        """Capture `run()`, which writes `buffers`, on their device and
        a side stream; returns the replay."""
        with torch.cuda.device(buffers[0].device):
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            torch.cuda.synchronize()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                graph.capture_begin(pool=self.pool,
                                    capture_error_mode="thread_local")
                try:
                    run()
                finally:
                    graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
        return graph.replay

    def reset(self):
        """Take a fresh pool for later captures (after one that
        failed)."""
        self.pool = None


class Kept:
    """A state that must outlive later bodies: `state`, re-pointed at a
    copy before a graph whose buffers it holds writes them again."""

    __slots__ = ("state", "__weakref__")

    def __init__(self, state):
        self.state = state


class _Graph:
    __slots__ = ("state", "buffers", "replay", "deltas", "held", "step",
                 "spans")

    def __init__(self, state, step):
        self.state = state  # the static state, in the graph's buffers
        self.buffers = {_buffer(x) for x in state}
        self.step = step  # the captured closure holds what it reads
        self.replay = None
        self.deltas = []  # (holder, attribute, change a replay adds)
        self.held = []  # weak references to Kept states in the buffers
        self.spans = None  # timing.CapturedSpans, where the body has any

    def run(self):
        """Replay, and file the replay's device_spans."""
        self.replay()
        if self.spans is not None:
            self.spans.file(self.spans.record[:self.spans.used].clone())


class BodyGraphs:
    """The bounce bodies' CUDA graphs of one caller, by lane width
    (module docstring). `capture` (default CudaCapture) captures a body
    on its `device_type`; the tests drive the bookkeeping on the CPU with
    a stand-in. `captures` and `replays` count what it did."""

    def __init__(self, capture=None):
        self.capture = capture or CudaCapture()  # called, and reset()
        self.graphs: dict[int, _Graph] = {}
        self.seen: set[int] = set()
        self.failed: set[int] = set()
        self.base = None
        self.pins = ()
        self.captures = 0
        self.replays = 0

    def for_trace(self, device, fixed: bool, dscene, config, options,
                  intersector):
        """This cache bound to one trace's scene, config, options and
        Intersector, or None where bodies must run eagerly (module
        docstring)."""
        if (device.type != self.capture.device_type or fixed
                or _get_current_dispatch_mode() is not None
                or not intersector.graph_safe):
            return None
        base = (tuple(map(id, _tensors(dscene))), id(config), options,
                id(intersector))
        if base != self.base:
            self.clear()
            self.base = base
            # the ids in the key stay unique while their objects live
            self.pins = (dscene, config, intersector)
        return self

    def clear(self):
        """Drop every graph and sighting."""
        self.graphs.clear()
        self.seen.clear()
        self.failed.clear()
        self.base, self.pins = None, ()

    def run(self, step, s):
        """One body `step(s)`: (the new state, whether a graph ran it)."""
        width = s.alive.shape[0]
        g = self.graphs.get(width)
        if g is None:
            if width not in self.seen or width in self.failed:
                self.seen.add(width)
                return step(s), False
            g = self._capture(step, s, width)
            if g is None:
                return step(s), False
            g.run()
            self.replays += 1
            return g.state, True
        self._enter(g, s)
        g.run()
        for holder, name, delta in g.deltas:
            setattr(holder, name, getattr(holder, name) + delta)
        self.replays += 1
        return g.state, True

    def _capture(self, step, s, width):
        state = type(s)(*(x.clone(memory_format=torch.contiguous_format)
                          for x in s))
        g = _Graph(state, step)
        spans = timing.CapturedSpans(s.alive.device)

        def run():
            with timing.capturing(spans):
                out = step(state)
            # an output in a buffer it does not own is copied first, so
            # no write-back reads a buffer already written
            out = [o if o is d or _buffer(o) not in g.buffers else o.clone()
                   for o, d in zip(out, state)]
            for o, d in zip(out, state):
                if o is not d:
                    d.copy_(o)

        before = timing.counters()
        try:
            g.replay = self.capture(run, list(state))
        except RuntimeError:
            # an op the capture refuses (a host read, a copy from host
            # memory): this width stays eager
            for holder, name, v in before:
                setattr(holder, name, v)
            self.failed.add(width)
            self.capture.reset()
            return None
        g.deltas = [(holder, name, b - a) for (holder, name, a), (*_, b)
                    in zip(before, timing.counters()) if b != a]
        # the graph's stamps write the record for as long as it lives
        g.spans = spans if spans.used else None
        self.graphs[width] = g
        self.captures += 1
        return g

    def _enter(self, g, s):
        """Copy the held states out of g's buffers, then `s` in."""
        for ref in g.held:
            k = ref()
            if k is not None:
                k.state = type(k.state)(*(
                    x.clone() if _buffer(x) in g.buffers else x
                    for x in k.state))
        g.held.clear()
        if s is g.state:
            return
        # sources in g's buffers (other than their own) are copied first
        src = [x if x is d or _buffer(x) not in g.buffers else x.clone()
               for x, d in zip(s, g.state)]
        for x, d in zip(src, g.state):
            if x is not d:
                d.copy_(x)

    def keep(self, s) -> Kept:
        """`s` held safe from later replays (Kept.state)."""
        k = Kept(s)
        ptrs = {_buffer(x) for x in s}
        for g in self.graphs.values():
            if ptrs & g.buffers:
                g.held.append(weakref.ref(k))
        return k

    def release(self, xs) -> tuple:
        """The tensors `xs`, each in a graph's buffers copied out."""
        bufs = set().union(*(g.buffers for g in self.graphs.values()))
        return tuple(x.clone() if _buffer(x) in bufs else x for x in xs)

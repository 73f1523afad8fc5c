"""Wall-clock formatting for the CLI's progress/ETC lines, the fence
every timing site uses (port of julia_raytracer_tpu/utils/timing.py),
and the program's spans and counts.

Spans
-----
`with span(name, **counts):` times a block on `time.perf_counter_ns`
and keys it by its path, the names of the open spans it sits in joined
by "/" (e.g. `frame/chunk/wavefront/body/intersect`). A path's row adds
up the spans' number (`n`), their total ns (`ns`), their self ns
(`self_ns`: the duration less what child spans on the same thread
cover) and every integer count passed to them (`live=`, `width=`, ...;
a count is never named `n`, `ns` or `self_ns`). Each thread keeps its
own stack of open spans; a span that opens on a thread with an empty
stack while a unit is open (autograd's backward thread on the card)
takes the unit thread's innermost open span as its parent, so the
checkpoint's recomputed bodies land under `train_step/backward`.

`with device_span(name, device, **counts) as sp:` is a span that also
counts `device_ns`, the device time of the work issued inside it, and
takes counts that are tensors on the device (`sp.add(...)`); both are
read back when `units()` is read, so the span adds no host sync where it
opens. Its ends are clock stamps in the device's stream order
(ops/span_stamp.py: on the card one one-thread launch at each end reading
%globaltimer, the second turning the first's stamp into the ns between
them; on the CPU the block's own ns), into an int64 slot of the span's
own.

A device_span in a body that a CUDA graph captures
(render/body_graphs.py, inside `with capturing(spans):`, `spans` a
CapturedSpans) stamps into a slot of the graph's own int64 record, and
its end copies its tensor counts into the record beside the stamp. It
adds nothing to its row at the capture; CapturedSpans notes its path
below the span open at the capture (the body), its integer counts and
its slots. After each replay, the graph's owner files a copy of the
record (`file`): a row per noted span under the span then open, with
`n` 1, its integer counts, and its `device_ns` and tensor counts
deferred as views of the copy. So replayed bodies count as eager ones
do, on one clock, with no host sync in the loop.

Units: a span named in UNITS that opens while no unit is open (the
renderer's `frame`, the train step's `train_step`) starts a table of
its own; `units()` holds the last MAX_UNITS closed units, each with its
start (perf_counter ns), its wall ns, its table and whether a
torch.profiler session was active when it opened. The set-up spans
(SETUP: the kernel libraries' `lib_build` and `lib_load`) add to one
process table, `setup()`, wherever they open, and still count as
children for the self time of the span around them. A span outside
both is timed and counted nowhere.

Recording (`with recording() as records:`), for a caller that owns its
profiler session: every span also appends a record (id, parent id,
thread, name, path, start and end ns on the profiler's clock, which is
`time.time_ns`, not `perf_counter_ns`) and enters
`torch.profiler.record_function(name)`, so a Chrome trace shows it.
Off by default: in a profiler session that another caller owns a
span's range would reach the device trace as a user-annotation event
that reads as device work. `idle_by_span` puts the gaps between device
work down to the recorded spans.

Counters: `counter(holder, name)` registers `holder.<name>` at 0, an int
the program ticks from Python (a kernel wrapper's `launches`), where its
module defines it. `counters()` reads all of them; render/body_graphs.py
adds back at each replay what a captured body ticked.
"""

from __future__ import annotations

import bisect
import collections
import itertools
import threading
import time
from contextlib import contextmanager

import torch

UNITS = ("frame", "train_step")
SETUP = ("lib_build", "lib_load")
MAX_UNITS = 64
OUTSIDE = "(outside spans)"

_now = time.perf_counter_ns


def fence(x):
    """Wait until the work that produces `x` has run: for every CUDA
    tensor in `x` (a tensor, or a tuple or list of them, nested), a
    `torch.cuda.synchronize` of its device; CPU tensors and other values
    need none. Returns x unchanged."""
    devices = set()

    def visit(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, (tuple, list)):
            for item in v:
                visit(item)

    visit(x)
    for device in devices:
        torch.cuda.synchronize(device)
    return x


def format_seconds(seconds: float) -> str:
    """h:mm:ss.mmm, matching the reference CLI output format."""
    if seconds != seconds or seconds < 0:  # NaN / negative guard
        seconds = 0.0
    total_ms = int(round(seconds * 1000))
    ms = total_ms % 1000
    total_s = total_ms // 1000
    s = total_s % 60
    m = (total_s // 60) % 60
    h = total_s // 3600
    return f"{h}:{m:02d}:{s:02d}.{ms:03d}"


# ---- counters ---------------------------------------------------------------

_COUNTERS: list[tuple[object, str]] = []


def counter(holder, name: str) -> None:
    """Register the counter `holder.<name>` at 0 (module docstring)."""
    setattr(holder, name, 0)
    _COUNTERS.append((holder, name))


def counters() -> list[tuple[object, str, int]]:
    """(holder, name, value) of every registered counter."""
    return [(holder, name, getattr(holder, name)) for holder, name in _COUNTERS]


# ---- spans ------------------------------------------------------------------


class _Unit:
    __slots__ = ("name", "start_ns", "stack", "table", "sides", "profiled")

    def __init__(self, name, stack):
        self.name = name
        self.stack = stack  # the unit thread's stack of open spans
        self.table = {}
        # the tables of spans opened on other threads, one a root span, so
        # that each table has one writer; merged when the unit closes
        self.sides = []
        self.profiled = bool(torch.autograd.profiler._is_profiler_enabled)
        self.start_ns = 0


class _State:
    """The process's registry: each thread's stack, the open unit, the
    closed units, the set-up table and the recording."""

    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()  # the closed units and set-up table
        self.unit = None
        self.units = collections.deque(maxlen=MAX_UNITS)
        self.setup = {}
        self.records = None  # a list while recording
        self.offset_ns = 0  # time_ns - perf_counter_ns, while recording
        self.ids = itertools.count()


_state = _State()


def _add(table, key, n, dur, self_ns, counts, deferred=()):
    row = table.get(key)
    if row is None:
        row = table[key] = [0, 0, 0, {}, []]
    row[0] += n
    row[1] += dur
    row[2] += self_ns
    if counts:
        c = row[3]
        for k, v in counts.items():
            c[k] = c.get(k, 0) + v
    row[4].extend(deferred)


def _resolve(rows) -> None:
    """Add the rows' deferred counts (device_span's tensors) to their
    counts, read back in one batch a device. Runs where units are read,
    never inside a frame."""
    by_device = collections.defaultdict(list)
    for r in rows:
        for k, v in r[4]:
            by_device[v.device].append((r, k, v))
        r[4] = []
    for items in by_device.values():
        values = torch.stack([v.reshape(()).to(torch.int64)
                              for _, _, v in items]).tolist()
        for (r, k, _), val in zip(items, values):
            r[3][k] = r[3].get(k, 0) + val


def _rows(table) -> dict:
    pending = [r for r in table.values() if r[4]]
    if pending:
        _resolve(pending)
    return {k: {"n": r[0], "ns": r[1], "self_ns": r[2], **r[3]}
            for k, r in table.items()}


class span:
    """Time the block as one span of `name`, adding `counts` (integers)
    to its path's row (module docstring)."""

    __slots__ = ("name", "counts", "path", "table", "stack", "parent",
                 "child_ns", "t0", "slow", "unit", "record", "rf")

    def __init__(self, name: str, **counts: int):
        self.name = name
        self.counts = counts

    def __enter__(self):
        st = _state
        try:
            stack = st.local.stack
        except AttributeError:
            stack = st.local.stack = []
        if stack and st.records is None and self.name not in SETUP:
            # the common case: a child on the same thread, not recorded
            parent = self.parent = stack[-1]
            self.path = parent.path + "/" + self.name
            self.table = parent.table
            self.slow = False
            self.child_ns = 0
            self.stack = stack
            stack.append(self)
            self.t0 = _now()
            return self
        return self._enter(st, stack)

    def _enter(self, st, stack):
        name = self.name
        parent = self.parent = stack[-1] if stack else None
        self.slow = True
        self.unit = self.record = self.rf = None
        unit = st.unit
        if parent is None and unit is not None:
            try:  # another thread's span inside the open unit
                parent = unit.stack[-1]
            except IndexError:  # the unit closed meanwhile
                parent = None
        if name in SETUP:  # added to st.setup in _exit; no child counted
            self.path, self.table = name, None
        elif self.parent is not None:
            self.path = parent.path + "/" + name
            self.table = parent.table
        elif parent is not None:
            self.path = parent.path + "/" + name
            self.table = {}
            unit.sides.append(self.table)
        elif name in UNITS and unit is None:
            unit = self.unit = st.unit = _Unit(name, stack)
            self.path, self.table = name, unit.table
        else:
            self.path, self.table = name, None
        self.child_ns = 0
        self.stack = stack
        stack.append(self)
        if st.records is not None:
            self.record = {
                "id": next(st.ids),
                "parent": None if parent is None or parent.rf is None
                else parent.record["id"],
                "thread": threading.get_ident(), "name": name,
                "path": self.path, "start_ns": 0, "end_ns": 0}
            st.records.append(self.record)
            self.rf = torch.profiler.record_function(name)
            self.rf.__enter__()
        self.t0 = _now()
        if self.unit is not None:
            self.unit.start_ns = self.t0
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _now()
        dur = t1 - self.t0
        self.stack.pop()
        parent = self.parent
        if parent is not None:
            parent.child_ns += dur
        table = self.table
        if table is not None:  # _add, inlined: this runs every span
            row = table.get(self.path)
            if row is None:
                row = table[self.path] = [0, 0, 0, {}, []]
            row[0] += 1
            row[1] += dur
            row[2] += dur - self.child_ns
            if self.counts:
                c = row[3]
                for k, v in self.counts.items():
                    c[k] = c.get(k, 0) + v
        if self.slow:
            self._exit(t1, dur, exc_type, exc, tb)
        return False

    def _exit(self, t1, dur, exc_type, exc, tb):
        st = _state
        if self.rf is not None:
            self.rf.__exit__(exc_type, exc, tb)
            self.record["start_ns"] = self.t0 + st.offset_ns
            self.record["end_ns"] = t1 + st.offset_ns
        if self.name in SETUP:
            with st.lock:
                _add(st.setup, self.path, 1, dur, dur - self.child_ns,
                     self.counts)
        unit = self.unit
        if unit is not None:
            st.unit = None
            for side in unit.sides:
                for key, row in side.items():
                    _add(unit.table, key, *row)
            with st.lock:
                st.units.append({"name": unit.name, "start_ns": unit.start_ns,
                                 "wall_ns": dur, "profiled": unit.profiled,
                                 "table": unit.table})


class CapturedSpans:
    """The device_spans of one captured body (module docstring): `record`,
    int64 [SLOTS] on the body's device, which the captured stamps write;
    `spans`, what `file` adds at each replay: (path below the span open
    at the capture, integer counts, the record's slot of device_ns,
    {count: slot}); `used`, the slots taken. A capture that needs more
    than SLOTS slots raises RuntimeError."""

    SLOTS = 256

    def __init__(self, device):
        self.record = torch.zeros(self.SLOTS, dtype=torch.int64,
                                  device=device)
        self.spans = []
        self.base = ""  # the path of the span open at the capture
        self.used = 0

    def take(self, k: int) -> int:
        """The first of k more slots of the record."""
        if self.used + k > self.SLOTS:
            raise RuntimeError(f"a captured body's device_spans take more "
                               f"than {self.SLOTS} record slots")
        self.used += k
        return self.used - k

    def close(self, sp, slot: int, tensors: dict) -> None:
        """Stamp the end of `sp`, whose clock is the record's `slot`, copy
        its tensor counts into the record, and note the span."""
        from julia_raytracer_tpu_torch.ops import span_stamp

        first = self.take(len(tensors))
        span_stamp.stamp(
            sp.clock, True,
            [v.reshape(()).to(torch.int64) for v in tensors.values()],
            self.record[first:first + len(tensors)])
        path = sp.path[len(self.base) + 1:] if self.base else sp.path
        self.spans.append((path, dict(sp.counts), slot,
                           {k: first + i for i, k in enumerate(tensors)}))

    def file(self, record) -> None:
        """Add the noted spans, read from `record` (a copy of the record
        after a replay), under the innermost open span on this thread."""
        stack = getattr(_state.local, "stack", None)
        if not stack or stack[-1].table is None:
            return
        top = stack[-1]
        for path, ints, slot, slots in self.spans:
            deferred = [("device_ns", record[slot])]
            deferred += [(k, record[i]) for k, i in slots.items()]
            _add(top.table, top.path + "/" + path, 1, 0, 0, ints, deferred)


@contextmanager
def capturing(spans: CapturedSpans):
    """Record this thread's device_spans into `spans` inside the block, a
    body that a CUDA graph captures (module docstring)."""
    local = _state.local
    stack = getattr(local, "stack", None)
    spans.base = stack[-1].path if stack else ""
    local.capture = spans
    try:
        yield spans
    finally:
        local.capture = None


class device_span(span):
    """A span that also times the device work issued inside it, as the
    count `device_ns`: the ns between clock stamps at its ends in the
    order of the device's stream (ops/span_stamp.py; while the device is
    the bottleneck, the device time of that work; on the CPU, whose ops
    run as they are issued, the block's own ns). Counts may be integers
    or tensors on the device (`add` them inside the block); the clock and
    the tensors are read when `units()` is, never inside the block, so
    the span adds no host sync. Inside `capturing`, the clock and the
    counts go to the capture's record instead (CapturedSpans)."""

    __slots__ = ("device", "clock", "capture", "slot")

    def __init__(self, name: str, device, **counts):
        super().__init__(name, **counts)
        self.device = torch.device(device)

    def add(self, **counts) -> None:
        """Set counts (integers or tensors) of the span, as the keywords
        of the constructor do."""
        self.counts.update(counts)

    def __enter__(self):
        from julia_raytracer_tpu_torch.ops import span_stamp

        cap = self.capture = getattr(_state.local, "capture", None)
        if cap is None:
            self.clock = torch.empty((), dtype=torch.int64,
                                     device=self.device)
        else:
            # before the span opens: a full record leaves no span open
            self.slot = cap.take(1)
            self.clock = cap.record[self.slot]
        super().__enter__()
        span_stamp.stamp(self.clock, False)
        return self

    def __exit__(self, exc_type, exc, tb):
        from julia_raytracer_tpu_torch.ops import span_stamp

        tensors = {k: v for k, v in self.counts.items()
                   if isinstance(v, torch.Tensor)}
        for k in tensors:
            del self.counts[k]
        if self.capture is not None:
            try:
                self.capture.close(self, self.slot, tensors)
            finally:
                self.table = None  # each replay files the span
                super().__exit__(exc_type, exc, tb)
            return False
        span_stamp.stamp(self.clock, True)
        super().__exit__(exc_type, exc, tb)
        if self.table is not None:
            self.table[self.path][4].extend(
                [*tensors.items(), ("device_ns", self.clock)])
        return False


def units() -> list[dict]:
    """The last MAX_UNITS closed units, oldest first: dicts of "name",
    "start_ns" (perf_counter ns), "wall_ns", "profiled" and "table"
    ({path: row})."""
    with _state.lock:
        return [dict(u, table=_rows(u["table"])) for u in _state.units]


def setup() -> dict:
    """The set-up spans' process table, {name: row}."""
    with _state.lock:
        return _rows(_state.setup)


def reset() -> None:
    """Forget the closed units and the set-up table."""
    with _state.lock:
        _state.units.clear()
        _state.setup.clear()


@contextmanager
def recording():
    """Record every span that opens inside the block, yielding the list
    the records are appended to (module docstring). Only for a caller
    that owns the profiler session the block runs in, or none; entered
    before that session starts, it warms `record_function` up outside it
    (the first call in a process takes about a millisecond, which would
    part the first record from the profiler's event)."""
    st = _state
    if st.records is not None:
        raise RuntimeError("span recording is already on")
    if not torch.autograd.profiler._is_profiler_enabled:
        with torch.profiler.record_function("recording"):
            pass
    records = []
    st.offset_ns = time.time_ns() - _now()
    st.records = records
    try:
        yield records
    finally:
        st.records = None


def device_intervals(prof) -> list[tuple[int, int, bool]]:
    """(start ns, end ns, is a user annotation) of each device event of a
    finished torch.profiler session, on the profiler's clock (the
    records' clock)."""
    t0 = prof.profiler.kineto_results.trace_start_ns()
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            s = t0 + int(e.time_range.start * 1000)
            out.append((s, t0 + int(e.time_range.end * 1000),
                        bool(getattr(e, "is_user_annotation", False))))
    return out


def idle_by_span(device_intervals, records, window=None) -> dict:
    """Seconds the device sat idle, by span path: the union of the device
    intervals ((start, end) or (start, end, is a user annotation), ns on
    the records' clock; user annotations left out) against `window`
    (start, end; default the records' extent), each gap put down to the
    innermost recorded span open at its middle (the one opened last), or
    to OUTSIDE."""
    busy = []
    for iv in sorted(iv for iv in device_intervals
                     if not (len(iv) > 2 and iv[2])):
        s, e = iv[0], iv[1]
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    recs = sorted((r["start_ns"], r["end_ns"], r["path"]) for r in records)
    if window is None:
        if not recs:
            return {}
        window = (recs[0][0], max(r[1] for r in recs))
    lo, hi = window
    gaps, at = [], lo
    for s, e in busy:
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    out = collections.defaultdict(float)
    starts = [r[0] for r in recs]
    active, taken = [], 0  # records opened by the gap's middle, by start
    for g0, g1 in gaps:
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        k = bisect.bisect_right(starts, mid)
        active.extend(recs[taken:k])
        taken = max(taken, k)
        # middles only grow: a record that ended before this one is done
        while active and active[-1][1] < mid:
            active.pop()
        out[active[-1][2] if active else OUTSIDE] += (g1 - g0) / 1e9
    return dict(out)

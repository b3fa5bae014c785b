"""Structured event tracer — the observability plane's span/instant store.

The port's copy of the JAX package's ``repro.obs.trace``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_sim_golden.py``).

Spans and instants accumulate in bounded ring buffers while the tracer is
enabled; the lifecycle engine emits

* **job-state spans** — one span per contiguous state segment of a job
  (``queued`` / ``running`` / ``backoff``), so a job's timeline reads
  queued → running → … → done/failed;
* **scheduler-pass spans** — one per scheduler invocation, tagged by the
  triggering event kind (arrive/finish/churn/fail/oom/scale/migrate/
  reschedule/restart) and carrying the *already measured* wall seconds of
  the pass (the engine times the pass either way — the tracer never adds
  its own clock inside the ``charge_overhead`` window, so virtual
  timestamps are bit-identical with tracing on or off);
* **instants** — point events: ``oom``, ``crash``, ``node_fail``,
  ``node_leave``, ``node_join``, ``replica_fail``, ``scale``, ``migrate``,
  ``failed`` (a normal finish emits no instant — the closing span already
  carries the time).

Storage layout — the hot-path contract
--------------------------------------
The engine's scale cells emit tens of thousands of records per run, so
the per-record cost *is* the overhead gate (``benchmarks/obs_overhead``).
Records therefore live in **per-kind flat scalar rings**: one plain list
per record kind, a fixed number of slots per record, appended value by
value.  ``list.append`` of already-existing scalars creates no container
object, so a million trace events add exactly zero to the cyclic GC's
allocation counter (per-event tuples were measured to drag extra
gen-1/gen-2 collections over the engine's large object graph), and the
per-kind split lets the hottest records be *narrow*:

* ``adm``  (4 slots: job_id, arrival, start, pass_wall) — one record per
  admission; it implies the closing ``queued`` span (arrival → start),
  the opening of the ``running`` segment, and — when ``pass_wall`` is not
  None (a fused single-job fast-admit pass, one-to-one with the
  admission) — the scheduler-pass span too;
* ``fin``  (2 slots: job_id, t) — closes the job's open segment;
* ``mark`` (3 slots: job_id, t, state) — an explicit state transition
  (``backoff`` after an OOM, re-``queued`` on preemption/restart,
  terminal ``failed``/``done``), closing whatever segment was open; an
  ``oom:``-prefixed state fuses the OOM instant with its transition
  (one record for the engine's whole OOM path);
* ``sched`` (4 slots: kind, t, wall_s, n_decisions) — one scheduler pass;
* ``inst``  (3 slots: name, t, arg) — a point event.

No dict is touched and no counter bumps on the hot path — open-segment
state is *implicit* (an ``adm`` opens ``running``, the next ``fin`` /
``mark`` / ``adm`` for the same job closes it) and reconstructed only in
the cold ``events`` property, which merges the per-job record streams by
time and synthesizes the span list.  Eviction stays *reported*: each ring
trims its oldest half when it reaches twice ``capacity`` records
(amortized O(1) per emit) and the evicted count accumulates in
``dropped`` — never silent.

Everything here is pure accumulation: no decision in the engine ever
reads tracer state (the ROADMAP's telemetry-is-free invariant), enabling
or disabling the tracer changes no placement, timestamp, or ordering
(golden-tested), and memory is bounded by the ring capacities.

Event tuples (materialized views, oldest-run first):

* ``("span", job_id, state, t0, t1)``     closed job-state segment
* ``("sched", kind, t, wall_s, n_dec)``   one scheduler pass
* ``("inst", name, t, arg)``              instant (arg: job/node id, …)

Timestamps are virtual-clock seconds on the sim path (event ordinals on
the live path); ``obs.export`` converts to Chrome-trace microseconds.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, Iterator, List, Tuple

#: default ring capacity (records per ring) for trace events
DEFAULT_TRACE_CAPACITY = 65536

#: default cap for the engine's raw ``oom_log`` / ``failure_log`` — high
#: enough that every committed benchmark keeps its full log (the largest,
#: the failure-storm cells, log a few thousand events), but a streamed
#: 1M-job pathological run can no longer grow without bound
DEFAULT_LOG_CAPACITY = 65536

#: job states that end a timeline (the segment closes, nothing reopens)
_TERMINAL = ("done", "failed")


class RingLog:
    """Bounded append-only log: a deque with an explicit, *reported* drop
    counter — eviction is never silent.  List-like enough (len / iter /
    index / ==) to substitute for the engine's former plain-list logs."""

    __slots__ = ("_buf", "dropped")

    def __init__(self, capacity: int = DEFAULT_LOG_CAPACITY):
        self._buf: deque = deque(maxlen=int(capacity))
        self.dropped = 0

    @property
    def capacity(self) -> int:
        return self._buf.maxlen

    def append(self, item) -> None:
        buf = self._buf
        if len(buf) == buf.maxlen:
            self.dropped += 1               # oldest entry is evicted
        buf.append(item)

    def clear(self) -> None:
        self._buf.clear()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._buf)

    def __bool__(self) -> bool:
        return bool(self._buf)

    def __iter__(self) -> Iterator:
        return iter(self._buf)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return list(self._buf)[i]
        return self._buf[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, RingLog):
            return list(self._buf) == list(other._buf)
        if isinstance(other, (list, tuple)):
            return list(self._buf) == list(other)
        return NotImplemented

    def __repr__(self) -> str:
        return (f"RingLog(len={len(self._buf)}, cap={self._buf.maxlen},"
                f" dropped={self.dropped})")


#: slots per record, per ring (the inline emit sites in ``lifecycle``
#: hard-code these widths — change both together)
_W_ADM, _W_FIN, _W_MARK, _W_SCHED, _W_INST = 4, 2, 3, 4, 3

#: tie-break priorities when merging a job's record streams at one
#: timestamp: a transition mark closes before a new admission opens,
#: and a finish closes last
_P_MARK, _P_ADM, _P_FIN = 0, 1, 2


class Tracer:
    """The process-wide span/instant collector (module singleton
    ``TRACER``).  Disabled by default; every emitter is expected to check
    ``TRACER.enabled`` *before* calling (the hot-path contract — a
    disabled tracer costs the engine one attribute read per hook).

    Hot engine hooks inline the emit protocol (append the ring's slots,
    trim past its threshold); cold paths use the emitter methods below,
    which write the same rings.  See the module docstring for the layout.
    """

    def __init__(self, capacity: int = DEFAULT_TRACE_CAPACITY):
        self.enabled = False
        #: bumps on every ``enable()`` — the same freshness discipline as
        #: ``calibration.cache_token()`` (round-trip tested even though no
        #: decision path consumes tracer state)
        self.version = 0
        self._capacity = int(capacity)
        self._reset_buffers()

    def _reset_buffers(self) -> None:
        cap = self._capacity
        #: the flat rings — public: lifecycle's inline emit sites append
        #: to them directly
        self.adm: list = []
        self.fin: list = []
        self.mark: list = []
        self.sched: list = []
        self.inst: list = []
        #: per-ring trim thresholds in *slots* (2x capacity records)
        self.adm_trim = 2 * _W_ADM * cap
        self.fin_trim = 2 * _W_FIN * cap
        self.mark_trim = 2 * _W_MARK * cap
        self.sched_trim = 2 * _W_SCHED * cap
        self.inst_trim = 2 * _W_INST * cap
        #: records evicted across all rings + frozen runs (exact; only
        #: ``trim()`` and the frozen-run cap ever touch it — the hot path
        #: bumps nothing)
        self._dropped = 0
        #: event tuples of completed runs (``new_run()`` freezes the live
        #: rings so job ids restarting at zero can't chain onto the
        #: previous run's timelines), plus the raw-record count they
        #: came from
        self._closed: List[tuple] = []
        self._closed_rec = 0

    @property
    def capacity(self) -> int:
        return self._capacity

    @property
    def dropped(self) -> int:
        """Records evicted by ring trims (exact, never silent)."""
        return self._dropped

    @property
    def n(self) -> int:
        """Records ever emitted: evicted + currently held."""
        return (self._dropped + self._closed_rec
                + len(self.adm) // _W_ADM + len(self.fin) // _W_FIN
                + len(self.mark) // _W_MARK + len(self.sched) // _W_SCHED
                + len(self.inst) // _W_INST)

    def trim(self) -> None:
        """Drop the oldest records of any ring past its threshold
        (record-aligned: emits append whole records before re-checking).
        Called from the inline emit sites; trims *all* rings so one
        threshold check per emit suffices."""
        cap = self._capacity
        for buf, w in ((self.adm, _W_ADM), (self.fin, _W_FIN),
                       (self.mark, _W_MARK), (self.sched, _W_SCHED),
                       (self.inst, _W_INST)):
            excess = len(buf) // w - cap
            if excess > 0:
                self._dropped += excess
                del buf[:excess * w]

    # ------------------------------------------------------------ control
    def enable(self, capacity: int = None) -> None:
        """Start collecting (clears any previous run's events)."""
        if capacity is not None:
            self._capacity = int(capacity)
        self._reset_buffers()
        self.enabled = True
        self.version += 1

    def disable(self) -> None:
        """Stop collecting.  Events are kept so a run can be exported
        after disabling; ``clear()`` or the next ``enable()`` drops them."""
        self.enabled = False

    def clear(self) -> None:
        self._reset_buffers()

    def new_run(self) -> None:
        """A new engine is starting: job ids restart from zero, so the
        live rings freeze into materialized events (still-open segments
        of the old run are dropped — their jobs will never close) and the
        rings restart empty.  Frozen events stay exported until
        ``clear()``/``enable()``, capped at ``capacity``."""
        frozen = self._materialize()
        rec = (len(self.adm) // _W_ADM + len(self.fin) // _W_FIN
               + len(self.mark) // _W_MARK + len(self.sched) // _W_SCHED
               + len(self.inst) // _W_INST)
        self._closed.extend(frozen)
        self._closed_rec += rec
        if len(self._closed) > self._capacity:
            self._closed = self._closed[-self._capacity:]
        del self.adm[:], self.fin[:], self.mark[:], self.sched[:]
        del self.inst[:]

    def cache_token(self) -> tuple:
        """Freshness token, ``calibration``-style: ``("off",)`` when
        disabled (bit-identical to the tracer never having existed) —
        tracer state feeds no decision, so nothing joins this into a plan
        cache; it exists for the round-trip test discipline."""
        return ("on", self.version) if self.enabled else ("off",)

    # ----------------------------------------------------------- emitters
    def job_state(self, job_id: int, state: str, now: float) -> None:
        """A job entered ``state`` at ``now`` — closes whatever segment
        was open and (non-terminal states) opens the next one.  Cold-path
        form; hot engine sites append the rings inline."""
        if state == "running":              # live-path admission
            self.admitted(job_id, now, now)
            return
        b = self.mark
        b.append(job_id); b.append(now); b.append(state)
        if len(b) > self.mark_trim:
            self.trim()

    def admitted(self, job_id: int, arrival: float, start: float,
                 pass_wall: float = None) -> None:
        """The job began running at ``start``: implies the closing
        ``queued`` span (``arrival`` → ``start``) on first admission, or
        closes the open ``backoff``/``queued`` segment on a requeue.
        ``pass_wall`` (fused fast-admit) also implies the scheduler-pass
        span — see the module docstring."""
        b = self.adm
        b.append(job_id); b.append(arrival); b.append(start)
        b.append(pass_wall)
        if len(b) > self.adm_trim:
            self.trim()

    def finished(self, job_id: int, now: float) -> None:
        """The job's open segment closed at ``now`` (normal finish — the
        span end is the "done" marker, no instant is emitted)."""
        b = self.fin
        b.append(job_id); b.append(now)
        if len(b) > self.fin_trim:
            self.trim()

    def sched_pass(self, kind: str, now: float, wall_s: float,
                   n_decisions: int) -> None:
        """One scheduler pass at virtual time ``now``, triggered by event
        ``kind``, measured at ``wall_s`` wall seconds (reuses the engine's
        own measurement — no second clock)."""
        b = self.sched
        b.append(kind); b.append(now); b.append(wall_s)
        b.append(n_decisions)
        if len(b) > self.sched_trim:
            self.trim()

    def instant(self, name: str, now: float, arg=None) -> None:
        b = self.inst
        b.append(name); b.append(now); b.append(arg)
        if len(b) > self.inst_trim:
            self.trim()

    # ------------------------------------------------------------ queries
    def _materialize(self) -> List[tuple]:
        """Synthesize event tuples from the live rings (cold path): merge
        each job's ``adm``/``mark``/``fin`` records by time and walk the
        implied state machine into spans.  A record whose opener was
        trimmed simply starts the timeline later — degradation under
        eviction is partial history, never an error."""
        out: List[tuple] = []
        b = self.sched
        for i in range(0, len(b), _W_SCHED):
            out.append(("sched", b[i], b[i + 1], b[i + 2], b[i + 3]))
        b = self.inst
        for i in range(0, len(b), _W_INST):
            out.append(("inst", b[i], b[i + 1], b[i + 2]))
        per: Dict[int, list] = {}
        b = self.adm
        for i in range(0, len(b), _W_ADM):
            per.setdefault(b[i], []).append((b[i + 2], _P_ADM, b[i + 1]))
            wall = b[i + 3]
            if wall is not None:            # fused fast-admit pass (its
                out.append(                # ts is the admission's start)
                    ("sched", "arrive", b[i + 2], wall, 1))
        b = self.mark
        for i in range(0, len(b), _W_MARK):
            per.setdefault(b[i], []).append((b[i + 1], _P_MARK, b[i + 2]))
        b = self.fin
        for i in range(0, len(b), _W_FIN):
            per.setdefault(b[i], []).append((b[i + 1], _P_FIN, None))
        for jid, recs in per.items():
            recs.sort(key=lambda r: (r[0], r[1]))
            state = t0 = None
            for t, pri, payload in recs:
                if pri == _P_ADM:
                    if state is not None:       # requeue/backoff closes
                        out.append(("span", jid, state, t0, t))
                    elif payload <= t:          # first admission: the
                        out.append(            # implicit queued segment
                            ("span", jid, "queued", payload, t))
                    state, t0 = "running", t
                elif pri == _P_MARK:
                    if payload.startswith("oom:"):
                        # fused OOM record: the instant + the transition
                        out.append(("inst", "oom", t, jid))
                        payload = payload[4:]
                    if state is not None:
                        out.append(("span", jid, state, t0, t))
                    if payload in _TERMINAL:
                        state = None
                        if payload == "failed":
                            out.append(("inst", "failed", t, jid))
                    else:
                        state, t0 = payload, t
                else:                           # _P_FIN
                    if state is not None:
                        out.append(("span", jid, state, t0, t))
                    state = None
        return out

    @property
    def events(self) -> List[tuple]:
        """All held records as event tuples — ``("span", job_id, state,
        t0, t1)``, ``("sched", kind, t, wall_s, n_dec)``, ``("inst",
        name, t, arg)`` — frozen runs first, then the live run.  A
        materialized cold-path view for export/tests; the rings stay
        scalar."""
        return list(self._closed) + self._materialize()

    def spans(self) -> List[tuple]:
        return [e for e in self.events if e[0] == "span"]

    def sched_spans(self) -> List[tuple]:
        return [e for e in self.events if e[0] == "sched"]

    def instants(self) -> List[tuple]:
        return [e for e in self.events if e[0] == "inst"]

    @property
    def open_segments(self) -> int:
        """Jobs of the live run whose last segment never closed —
        bounded by live jobs (derived, like everything else here)."""
        last: Dict[int, Tuple[float, int, object]] = {}
        b = self.adm
        for i in range(0, len(b), _W_ADM):
            jid, t = b[i], b[i + 2]
            cur = last.get(jid)
            if cur is None or (t, _P_ADM) >= cur[:2]:
                last[jid] = (t, _P_ADM, None)
        b = self.mark
        for i in range(0, len(b), _W_MARK):
            jid, t = b[i], b[i + 1]
            cur = last.get(jid)
            if cur is None or (t, _P_MARK) >= cur[:2]:
                last[jid] = (t, _P_MARK, b[i + 2])
        b = self.fin
        for i in range(0, len(b), _W_FIN):
            jid, t = b[i], b[i + 1]
            cur = last.get(jid)
            if cur is None or (t, _P_FIN) >= cur[:2]:
                last[jid] = (t, _P_FIN, None)
        n = 0
        for t, pri, payload in last.values():
            if pri == _P_ADM:
                n += 1
            elif pri == _P_MARK:
                if payload.startswith("oom:"):
                    payload = payload[4:]
                if payload not in _TERMINAL:
                    n += 1
        return n


#: the process-wide tracer (import-site singleton, ``calibration`` idiom)
TRACER = Tracer()

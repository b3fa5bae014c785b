"""HAS — Heterogeneity-Aware Scheduler (paper §IV-B, Algorithm 1).

The port's copy of the JAX package's ``repro.core.has``, line for line with
its imports pointed at ``repro_torch``: the same inputs give the same
decisions bit for bit (``tests/test_torch_marp_has.py``, ``tests/test_torch_submit.py``).

Faithful implementation of Algorithm 1 with two paper typos corrected
(documented in DESIGN.md): line 15 ``n.gpusize > fitSz`` -> ``>=`` (the
paper's own Job(4,35)/Node(4,40) example requires it) and line 19
``N.idleGPUs > reqNum`` -> ``>=`` (best-fit means an exact match is ideal).

Stage 1 — optimal-plan retrieval: walk MARP's ranked plan list, take the
first plan the cluster can currently satisfy.
Stage 2 — heterogeneous placement: best-fit bin packing; prefer the single
node with the fewest idle devices that fits; else greedily consume the
largest-remainder node and repeat.

Scaling: both stages run against a ``ClusterPool`` — a transactional
free-pool that keeps, per (device_type, mem) class, an idle-device counter
and a sorted node list maintained incrementally by ``apply``/``release``.
Plan retrieval is then an O(#mem-classes) counter lookup per candidate plan
(instead of an O(nodes) scan), and placement touches only the handful of
sorted entries it selects.  Decisions are bit-identical to the original
per-node scans (golden-equivalence tested): within a class, nodes order by
(idle desc, insertion order asc), exactly the seed's stable sorts.

Fractional-GPU packing: with ``enable_slicing()`` the pool also
tracks per-device free *bytes*.  Placements may then be ``Grant`` objects —
byte-sized reservations on specific devices — instead of whole-device
``(node_id, k)`` pairs.  An exclusive grant claims whole devices through the
ordinary idle counters but records its byte budget, exposing the remainder
(``mem - nbytes``) as harvestable slack; a slice grant (``exclusive=False``)
carves bytes out of an open device's slack, or opens an idle device.  Slack
is indexed per class in ``_Bucket.slack_entries`` (sorted by free bytes:
best fit is one bisect) and summarized per device type in a power-of-two
free-bytes histogram whose fit test is a *necessary* condition — the
admission shards' O(1)-ish eligibility bound, mirroring ``idle_by_type``.
Whole-device mode never consults any of it: with slicing off (the default)
every code path is byte-identical to the pre-slicing pool.
"""
from __future__ import annotations

import heapq
import os
from bisect import bisect_left, insort
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

from repro_torch.core.marp import ResourcePlan

#: ``REPRO_DEBUG_POOL=1`` cross-checks the incremental slice accounting
#: (per-class slack index, per-type free-bytes histogram, byte counters)
#: against a full node scan after every grant mutation — the pool analog
#: of the admission queue's ``REPRO_DEBUG_QUEUE`` idiom.
DEBUG_POOL = os.environ.get("REPRO_DEBUG_POOL", "") not in ("", "0")

#: bins of the per-type free-bytes histogram: bin i counts open devices
#: whose free bytes have ``bit_length() == i`` (i.e. free in [2^(i-1),
#: 2^i - 1]).  64 bins cover any conceivable device memory.
_HIST_BINS = 64


@dataclass
class Node:
    """Node(n, s) of the paper: n idle devices of per-device memory s."""
    node_id: str
    device_type: str
    mem: int                      # bytes per device
    total: int                    # devices on the node
    idle: int                     # currently idle devices

    def take(self, k: int) -> None:
        """Claim ``k`` idle devices; drives ``idle`` toward 0, never below."""
        assert 0 < k <= self.idle, (self.node_id, self.idle, k)
        self.idle -= k

    def free(self, k: int) -> None:
        """Return ``k`` devices; never exceeds ``total``."""
        assert 0 < k and self.idle + k <= self.total, \
            (self.node_id, self.idle, k, self.total)
        self.idle += k


class Grant:
    """A byte-sized device reservation (fractional-GPU packing).

    ``k`` whole devices on ``node_id`` with a per-device byte budget of
    ``nbytes``.  ``exclusive=True`` is how colocation-mode train jobs hold
    devices: the devices leave the idle pool (exact whole-device counters)
    but the budget is recorded so ``mem - nbytes`` becomes harvestable
    slack.  ``exclusive=False`` is a slice: a single-device byte
    reservation that rides an already-open device's slack, or opens an
    idle one.  ``devs`` holds the pool-assigned open-device ids — empty
    until ``ClusterPool.apply`` binds them (placement queries never
    mutate, so ids are assigned at commit time).

    Iterating a grant yields the legacy ``(node_id, k)`` pair — with k=0
    for slices — so every ``for nid, k in placements`` consumer (refcount
    registry, Young-Daly hazard, rate model, victim collection) works
    unchanged: a slice contributes no whole devices.
    """
    __slots__ = ("node_id", "k", "nbytes", "exclusive", "devs")

    def __init__(self, node_id: str, k: int, nbytes: int,
                 exclusive: bool = True,
                 devs: Tuple[int, ...] = ()):
        assert k > 0 and nbytes > 0, (node_id, k, nbytes)
        assert exclusive or k == 1, "slices are single-device"
        self.node_id = node_id
        self.k = k
        self.nbytes = nbytes
        self.exclusive = exclusive
        self.devs = devs

    def __iter__(self):
        yield self.node_id
        yield self.k if self.exclusive else 0

    def __repr__(self) -> str:
        kind = "excl" if self.exclusive else "slice"
        return (f"Grant({self.node_id!r}, k={self.k}, "
                f"nbytes={self.nbytes}, {kind}, devs={self.devs})")


#: one element of a placements sequence: legacy whole-device pair or grant
Placement = Union[Tuple[str, int], Grant]


@dataclass(frozen=True)
class Allocation:
    plan: ResourcePlan
    #: ``(node_id, n_devices)`` pairs, or ``Grant`` objects when the pool
    #: is in slicing mode and the decision carries byte budgets
    placements: Tuple[Placement, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.placements)


class _Bucket:
    """All nodes of one (device_type, mem) class.

    ``entries`` holds ``(-idle, pos, node_id)`` for nodes with idle > 0,
    kept sorted — ascending order is (idle desc, insertion-pos asc), the
    exact traversal order of the seed's stable ``sort(key=-idle)``.

    Slicing mode additionally indexes open devices (busy devices with a
    tracked byte budget): ``slack_entries`` holds ``(free_bytes, pos, dev,
    node_id)`` for open devices with free > 0, sorted ascending — best fit
    for a B-byte slice is the first entry at ``bisect_left((B,))``.
    ``slack_sum`` totals the class's free bytes.  Both stay empty (and are
    never read) with slicing off.
    """
    __slots__ = ("mem", "idle_sum", "entries", "slack_sum", "slack_entries")

    def __init__(self, mem: int):
        self.mem = mem
        self.idle_sum = 0
        self.entries: List[Tuple[int, int, str]] = []
        self.slack_sum = 0
        self.slack_entries: List[Tuple[int, int, int, str]] = []


class ClusterPool:
    """Transactional, incrementally-indexed cluster free-pool.

    All idle-count mutations must go through ``take``/``free`` (or the
    placement-level ``apply``/``release``) so the per-class index stays in
    sync with the ``Node`` objects it wraps.  Queries (``select_plan``,
    ``find_placements``) never mutate; a scheduler stages a decision by
    computing placements first and applying them after — there is nothing
    to roll back on the not-admitted path.
    """

    def __init__(self, nodes: Iterable[Node], *, reset: bool = False):
        self.nodes: Dict[str, Node] = {}
        self._pos: Dict[str, int] = {}
        self._next_pos = 0                  # monotonic: survives removals
        self._buckets: Dict[Tuple[str, int], _Bucket] = {}
        self._by_type: Dict[str, List[_Bucket]] = {}   # mem-ascending
        self.total_idle = 0
        #: fleet size in devices (busy + idle) — maintained on add/remove
        #: so the observability plane can report utilization % without an
        #: O(nodes) scan; no scheduling decision reads it
        self.total_devices = 0
        #: idle devices per device type — the admission shards' O(1)
        #: eligibility counters (ignores per-class memory: an upper bound
        #: on any plan's satisfiable count, exact for single-mem-class
        #: types, which is every catalog type today)
        self.idle_by_type: Dict[str, int] = {}
        #: idle *bytes* per device type — ``idle_by_type`` generalized to
        #: the byte axis: idle devices contribute their full memory, open
        #: devices their remaining slack.  Maintained on every mutation so
        #: slice-aware eligibility bounds read it O(1); never consulted by
        #: whole-device decisions.
        self.idle_bytes_by_type: Dict[str, int] = {}
        #: True once ``enable_slicing()`` ran — placements may then be
        #: ``Grant`` objects and the slack index/histogram are live
        self.slicing = False
        #: total harvestable slack bytes across all open devices (O(1)
        #: read for the arrival gate's slice-aware short-circuit)
        self.total_slack = 0
        #: per-type power-of-two free-bytes histogram over open devices
        #: (``_HIST_BINS`` bins; bin = free.bit_length()) — the shards'
        #: necessary-condition fit test for slices
        self._slack_hist: Dict[str, List[int]] = {}
        #: node_id -> {dev_id: [used_bytes, tenants]} for open devices
        self._open: Dict[str, Dict[int, List[int]]] = {}
        #: node_id -> next fresh open-device id (monotonic, never reused)
        self._next_dev: Dict[str, int] = {}
        for n in nodes:
            if reset:
                n.idle = n.total
            self._add(n)

    def enable_slicing(self) -> None:
        """Switch on memory-slice accounting.  Idempotent; whole-device
        state is untouched (idle counters keep driving exact whole-device
        decisions), so flipping this on changes no existing behavior until
        a ``Grant`` placement is actually applied."""
        self.slicing = True

    # ------------------------------------------------------------- build --
    def _add(self, n: Node) -> None:
        assert n.node_id not in self.nodes, n.node_id
        pos = self._next_pos
        self._next_pos += 1
        self.nodes[n.node_id] = n
        self._pos[n.node_id] = pos
        key = (n.device_type, n.mem)
        bucket = self._buckets.get(key)
        if bucket is None:
            bucket = self._buckets[key] = _Bucket(n.mem)
            blist = self._by_type.setdefault(n.device_type, [])
            blist.append(bucket)
            blist.sort(key=lambda b: b.mem)
        bucket.idle_sum += n.idle
        if n.idle > 0:
            insort(bucket.entries, (-n.idle, pos, n.node_id))
        self.total_idle += n.idle
        self.total_devices += n.total
        self.idle_by_type[n.device_type] = \
            self.idle_by_type.get(n.device_type, 0) + n.idle
        self.idle_bytes_by_type[n.device_type] = \
            self.idle_bytes_by_type.get(n.device_type, 0) + n.idle * n.mem

    # --------------------------------------------------------- mutations --
    def _reindex(self, bucket: _Bucket, n: Node, pos: int, old_idle: int) -> None:
        if old_idle > 0:
            i = bisect_left(bucket.entries, (-old_idle, pos))
            assert i < len(bucket.entries) and bucket.entries[i][1] == pos
            bucket.entries.pop(i)
        if n.idle > 0:
            insort(bucket.entries, (-n.idle, pos, n.node_id))

    def take(self, node_id: str, k: int) -> None:
        n = self.nodes[node_id]
        old = n.idle
        n.take(k)
        bucket = self._buckets[(n.device_type, n.mem)]
        bucket.idle_sum -= k
        self.total_idle -= k
        self.idle_by_type[n.device_type] -= k
        self.idle_bytes_by_type[n.device_type] -= k * n.mem
        self._reindex(bucket, n, self._pos[node_id], old)

    def free(self, node_id: str, k: int) -> None:
        n = self.nodes[node_id]
        old = n.idle
        n.free(k)
        bucket = self._buckets[(n.device_type, n.mem)]
        bucket.idle_sum += k
        self.total_idle += k
        self.idle_by_type[n.device_type] += k
        self.idle_bytes_by_type[n.device_type] += k * n.mem
        self._reindex(bucket, n, self._pos[node_id], old)

    def apply(self, placements: Sequence[Placement]) -> None:
        for p in placements:
            if isinstance(p, Grant):
                self._take_grant(p)
            else:
                self.take(p[0], p[1])

    def release(self, placements: Sequence[Placement]) -> None:
        for p in placements:
            if isinstance(p, Grant):
                self._free_grant(p)
            else:
                self.free(p[0], p[1])

    # ------------------------------------------------- slice (grant) ops --
    def _slack_index(self, n: Node, pos: int, dev: int, free: int) -> None:
        """Index an open device's free bytes (histogram + class entries)."""
        hist = self._slack_hist.get(n.device_type)
        if hist is None:
            hist = self._slack_hist[n.device_type] = [0] * _HIST_BINS
        if free > 0:
            bucket = self._buckets[(n.device_type, n.mem)]
            insort(bucket.slack_entries, (free, pos, dev, n.node_id))
            bucket.slack_sum += free
            hist[free.bit_length()] += 1
            self.total_slack += free
            self.idle_bytes_by_type[n.device_type] += free

    def _slack_unindex(self, n: Node, pos: int, dev: int, free: int) -> None:
        if free > 0:
            bucket = self._buckets[(n.device_type, n.mem)]
            i = bisect_left(bucket.slack_entries, (free, pos, dev))
            assert (i < len(bucket.slack_entries)
                    and bucket.slack_entries[i][1] == pos
                    and bucket.slack_entries[i][2] == dev)
            bucket.slack_entries.pop(i)
            bucket.slack_sum -= free
            self._slack_hist[n.device_type][free.bit_length()] -= 1
            self.total_slack -= free
            self.idle_bytes_by_type[n.device_type] -= free

    def _open_dev(self, n: Node, dev: int, nbytes: int) -> None:
        """An idle device leaves the whole-device pool (caller already did
        ``take``) and opens with one byte-budgeted tenant."""
        assert 0 < nbytes <= n.mem, (n.node_id, nbytes, n.mem)
        self._open.setdefault(n.node_id, {})[dev] = [nbytes, 1]
        self._slack_index(n, self._pos[n.node_id], dev, n.mem - nbytes)

    def _take_grant(self, g: Grant) -> None:
        assert self.slicing, "apply Grant on a pool without enable_slicing()"
        n = self.nodes[g.node_id]
        open_map = self._open.setdefault(g.node_id, {})
        if not g.devs:
            # commit-time device-id binding (queries never mutate)
            nxt = self._next_dev.get(g.node_id, 0)
            self._next_dev[g.node_id] = nxt + g.k
            g.devs = tuple(range(nxt, nxt + g.k))
        if g.exclusive:
            self.take(g.node_id, g.k)           # exact whole-device path
            for dev in g.devs:
                self._open_dev(n, dev, g.nbytes)
        else:
            (dev,) = g.devs
            rec = open_map.get(dev)
            if rec is None:                      # idle-device fallback
                self.take(g.node_id, 1)
                self._open_dev(n, dev, g.nbytes)
            else:                                # ride an open device
                free = n.mem - rec[0]
                assert g.nbytes <= free, (g, rec, n.mem)
                self._slack_unindex(n, self._pos[g.node_id], dev, free)
                rec[0] += g.nbytes
                rec[1] += 1
                self._slack_index(n, self._pos[g.node_id], dev,
                                  free - g.nbytes)
        if DEBUG_POOL:
            self._debug_check_slices()

    def _free_grant(self, g: Grant) -> None:
        assert self.slicing and g.devs, g
        n = self.nodes[g.node_id]
        open_map = self._open[g.node_id]
        pos = self._pos[g.node_id]
        for dev in g.devs:
            rec = open_map[dev]
            free = n.mem - rec[0]
            self._slack_unindex(n, pos, dev, free)
            rec[0] -= g.nbytes
            rec[1] -= 1
            assert rec[0] >= 0 and rec[1] >= 0, (g, rec)
            if rec[1] == 0:
                # last tenant gone: the device closes and rejoins the
                # whole-device idle pool
                assert rec[0] == 0, (g, rec)
                del open_map[dev]
                self.free(g.node_id, 1)
            else:
                self._slack_index(n, pos, dev, free + g.nbytes)
        if not open_map:
            del self._open[g.node_id]
        if DEBUG_POOL:
            self._debug_check_slices()

    def _debug_check_slices(self) -> None:
        """Full-scan cross-check of the incremental slice accounting
        (``REPRO_DEBUG_POOL=1``): rebuild the per-type histogram, per-class
        slack sums/entries, ``total_slack`` and ``idle_bytes_by_type`` from
        ``_open`` + node idle counters and compare."""
        hist: Dict[str, List[int]] = {}
        slack_sum: Dict[Tuple[str, int], int] = {}
        entries: Dict[Tuple[str, int], List] = {}
        total_slack = 0
        idle_bytes: Dict[str, int] = {}
        for node_id, n in self.nodes.items():
            idle_bytes[n.device_type] = (idle_bytes.get(n.device_type, 0)
                                         + n.idle * n.mem)
            for dev, (used, tenants) in self._open.get(node_id, {}).items():
                assert tenants > 0 and 0 <= used <= n.mem, (node_id, dev)
                free = n.mem - used
                if free > 0:
                    key = (n.device_type, n.mem)
                    slack_sum[key] = slack_sum.get(key, 0) + free
                    entries.setdefault(key, []).append(
                        (free, self._pos[node_id], dev, node_id))
                    h = hist.setdefault(n.device_type, [0] * _HIST_BINS)
                    h[free.bit_length()] += 1
                    total_slack += free
                    idle_bytes[n.device_type] += free
        assert total_slack == self.total_slack, \
            (total_slack, self.total_slack)
        for dt, h in self._slack_hist.items():
            assert h == hist.get(dt, [0] * _HIST_BINS), dt
        for key, b in self._buckets.items():
            assert b.slack_sum == slack_sum.get(key, 0), key
            assert b.slack_entries == sorted(entries.get(key, [])), key
        for dt, v in self.idle_bytes_by_type.items():
            assert v == idle_bytes.get(dt, 0), (dt, v, idle_bytes.get(dt))

    # ------------------------------------------------------ cluster churn --
    def add_node(self, n: Node) -> None:
        """A node joins the cluster (dynamic availability).  Joining nodes
        take a fresh insertion position — a rejoining node re-enters at the
        back of its class's FIFO tie-break, exactly as a new node would."""
        self._add(n)

    def remove_node(self, node_id: str) -> Node:
        """A node leaves the cluster.  Callers must have released every
        placement on it first (the lifecycle engine preempts and requeues
        those jobs): a node with busy devices cannot silently vanish without
        desyncing job state, so fully-idle is asserted here."""
        n = self.nodes[node_id]
        assert n.idle == n.total, (node_id, n.idle, n.total)
        assert not self._open.get(node_id), \
            (node_id, "open (sliced) devices must be released first")
        del self.nodes[node_id]
        self._next_dev.pop(node_id, None)
        pos = self._pos.pop(node_id)
        bucket = self._buckets[(n.device_type, n.mem)]
        bucket.idle_sum -= n.idle
        self.total_idle -= n.idle
        self.total_devices -= n.total
        self.idle_by_type[n.device_type] -= n.idle
        self.idle_bytes_by_type[n.device_type] -= n.idle * n.mem
        if n.idle > 0:
            i = bisect_left(bucket.entries, (-n.idle, pos))
            assert i < len(bucket.entries) and bucket.entries[i][1] == pos
            bucket.entries.pop(i)
        return n

    # ----------------------------------------------------------- queries --
    def avail(self, plan: ResourcePlan) -> int:
        """Idle devices able to host ``plan`` — MARP plans are
        per-device-type (paper §IV: 'the specific number of GPU cards needed
        for various types of GPUs'), so a plan is satisfied by its own type;
        the memory check guards degenerate catalogs."""
        blist = self._by_type.get(plan.device_type)
        if not blist:
            return 0
        min_mem = plan.min_mem
        return sum(b.idle_sum for b in blist if b.mem >= min_mem)

    def slack_may_fit(self, device_type: str, nbytes: int) -> bool:
        """Histogram fit test: could *some* open device of this type hold a
        ``nbytes`` slice?  Necessary, not sufficient — any device with
        free >= B has ``free.bit_length() >= B.bit_length()``, but the
        boundary bin may hold smaller values.  This is the admission
        shards' eligibility bound; exact answers come from
        ``_slice_best_fit``."""
        hist = self._slack_hist.get(device_type)
        if not hist:
            return False
        return any(hist[i] for i in range(nbytes.bit_length(), _HIST_BINS))

    def _slice_best_fit(self, device_type: str, nbytes: int
                        ) -> Optional[Tuple[int, int, int, str]]:
        """Tightest open device able to hold a ``nbytes`` slice: minimal
        (free, pos) across the type's classes (best fit, then first-added).
        One bisect per memory class; histogram quick-reject first."""
        if not self.slack_may_fit(device_type, nbytes):
            return None
        best = None
        for b in self._by_type.get(device_type, ()):
            e = b.slack_entries
            i = bisect_left(e, (nbytes,))
            if i < len(e):
                cand = e[i]
                if best is None or (cand[0], cand[1]) < (best[0], best[1]):
                    best = cand
        return best

    def select_plan(self, plans: Sequence[ResourcePlan], *,
                    harvest: bool = False) -> Optional[ResourcePlan]:
        """Stage 1 (Algorithm 1, lines 1-10): first satisfiable plan.

        Per plan this is a couple of integer compares: plans needing more
        than the whole pool's idle count short-circuit (exact — per-type
        availability can never exceed total idle), the rest sum a handful
        of per-class counters.

        With ``harvest=True`` (colocation mode), a single-device plan with
        a byte budget is also satisfiable by slack on an open device —
        checked exactly (``_slice_best_fit``), so a selected plan always
        places.
        """
        total = self.total_idle
        by_type = self._by_type
        for plan in plans:
            need = plan.n_devices
            if (harvest and need == 1 and plan.slice_bytes > 0
                    and self._slice_best_fit(plan.device_type,
                                             plan.slice_bytes) is not None):
                return plan
            if need > total:
                continue
            blist = by_type.get(plan.device_type)
            if not blist:
                continue
            if len(blist) == 1:            # common case: one mem class
                b = blist[0]
                if b.mem >= plan.min_mem and b.idle_sum >= need:
                    return plan
                continue
            min_mem = plan.min_mem
            if sum(b.idle_sum for b in blist if b.mem >= min_mem) >= need:
                return plan
        return None

    def find_placements(self, plan: ResourcePlan, *, harvest: bool = False
                        ) -> Optional[Tuple[Placement, ...]]:
        """Stage 2 (Algorithm 1, lines 11-37).  Mutates nothing; returns the
        placement list or None if resources vanished.

        Placement preference (best-fit, smallest-adequate first — Algorithm
        1's ``fitSz``):
          1. the single node with the fewest idle devices that fits
             everything;
          2. else the smallest memory class whose total idle covers the job
             (keeps synchronous data parallelism on homogeneous devices);
          3. else greedy spill across classes, largest remainder first.

        With ``harvest=True`` a single-device byte-budgeted plan prefers
        riding an open device's slack (best fit — tightest free bytes),
        falling back to opening an idle device; either way the result is a
        single slice ``Grant`` (device ids bound at ``apply``).
        """
        if harvest and plan.n_devices == 1 and plan.slice_bytes > 0 \
                and self.slicing:
            hit = self._slice_best_fit(plan.device_type, plan.slice_bytes)
            if hit is not None:
                _, _, dev, node_id = hit
                return (Grant(node_id, 1, plan.slice_bytes,
                              exclusive=False, devs=(dev,)),)
            whole = self.find_placements(plan)
            if whole is None:
                return None
            ((node_id, _),) = whole
            return (Grant(node_id, 1, plan.slice_bytes, exclusive=False),)
        req = plan.n_devices
        buckets = [b for b in self._by_type.get(plan.device_type, ())
                   if b.mem >= plan.min_mem]
        if sum(b.idle_sum for b in buckets) < req:
            return None
        # 1) single-node best fit: smallest adequate memory class, then
        #    fewest idle devices, then first-added node
        for bucket in buckets:
            entries = bucket.entries
            # entries[:cut] have idle >= req (sorted by -idle)
            cut = bisect_left(entries, (-req + 1,))
            if cut:
                tightest = -entries[cut - 1][0]        # min idle >= req
                first = bisect_left(entries, (-tightest,))
                return ((entries[first][2], req),)
        # 2) smallest homogeneous memory class that covers the job
        alloc: List[Tuple[str, int]] = []
        for bucket in buckets:
            if bucket.idle_sum >= req:
                for neg_idle, _, node_id in bucket.entries:
                    take = min(-neg_idle, req)
                    alloc.append((node_id, take))
                    req -= take
                    if req == 0:
                        return tuple(alloc)
        # 3) greedy spill across classes (largest remainder, then smallest
        #    memory, then first-added — the seed's stable (-idle, mem) sort)
        merged = heapq.merge(*[[(neg, b.mem, pos, nid)
                                for neg, pos, nid in b.entries]
                               for b in buckets])
        for neg_idle, _, _, node_id in merged:
            take = min(-neg_idle, req)
            alloc.append((node_id, take))
            req -= take
            if req == 0:
                return tuple(alloc)
        return None                                     # unreachable: avail held

    def schedule(self, plans: Sequence[ResourcePlan], *,
                 harvest: bool = False) -> Optional[Allocation]:
        """Full HAS against the pool: plan retrieval + placement (no mutation;
        call ``apply`` with the returned placements to commit)."""
        plan = self.select_plan(plans, harvest=harvest)
        if plan is None:
            return None
        placements = self.find_placements(plan, harvest=harvest)
        if placements is None:
            return None
        return Allocation(plan=plan, placements=placements)


# ------------------------------------------------------------------------- #
# Sequence-of-nodes convenience API (orchestrator, tests).  These build a
# throwaway index; long-lived callers should hold a ClusterPool instead.

def select_plan(plans: Sequence[ResourcePlan],
                nodes: Sequence[Node]) -> Optional[ResourcePlan]:
    """Stage 1 (Algorithm 1, lines 1-10)."""
    return ClusterPool(nodes).select_plan(plans)


def place(plan: ResourcePlan, nodes: Sequence[Node]) -> Optional[Allocation]:
    """Stage 2 (Algorithm 1, lines 11-37) on a node sequence."""
    placements = ClusterPool(nodes).find_placements(plan)
    if placements is None:
        return None
    return Allocation(plan=plan, placements=placements)


def schedule(plans: Sequence[ResourcePlan],
             nodes: Sequence[Node]) -> Optional[Allocation]:
    """Full HAS: plan retrieval + placement."""
    return ClusterPool(nodes).schedule(plans)

"""MDSS — Multi-level Data Storage Service (paper §3.4).

URI-keyed, versioned, multi-tier data store:

  * writes land on the *writing* tier first (paper: "data is always
    accessible to the application", offline-capable) and propagate lazily,
  * ``synchronize`` reconciles tiers **last-writer-wins** (paper default),
  * ``ensure(uri, tier)`` is the offload fast-path: if the target tier
    already holds the latest version nothing moves (task-code-only
    offloading); otherwise only the stale entries transfer,
  * ``prefetch(uris, tier)`` is the pipelined variant: the same ensure on
    a background thread, so the transfer overlaps upstream compute — the
    executor issues it for a dispatched step's likely successors,
  * transfers run **outside** the store lock and install under a version
    guard (hazard check): a copy shipped for version *v* never overwrites
    a copy of a newer version, and a write that lands mid-transfer simply
    re-ships — concurrent readers/writers never block on the wire,
  * ``put(..., expect_version=)`` is a write fence: the put is refused
    (returns ``None``) when the entry has moved past the expected
    version — how a speculation loser is kept from clobbering newer data,
  * every cross-tier movement is accounted (bytes, modeled seconds), per
    namespace — the MDSS benchmark and the §Perf analysis read these
    counters,
  * **namespaces** (multi-tenant runtime): a URI ``ns/leaf`` belongs to
    namespace ``ns``. ``namespaced(ns, shared=...)`` returns a per-run
    view that writes under ``ns/`` but lets reads fall through to a
    common ``shared/`` namespace, so N concurrent workflows get isolated
    outputs while warm cross-run data (params, observations) is stored —
    and stays cloud-resident — exactly once. ``drop_namespace`` is run
    teardown: it frees every replica the run published,
  * **content addressing** (chunk dedup): every replica install registers
    its value's chunk digests (``wire.manifest_of``) in a per-tier chunk
    index carrying the same incremental residency accounting as the
    byte counters; ``staleness``/``stale_bytes`` then charge only chunks
    NOT already resident on the destination tier — a second tenant
    staging content-identical inputs (same params under another
    namespace, a re-upload after eviction) owes **zero** transfer bytes,
    and the locality scorer (``CostModel.placement_cost``) sees exactly
    that. A transport exposing ``transfer_ex`` (the fabric's
    RPCTransport) ships metadata only for fully-resident values;
    ``content_digest(uri)`` is the whole-value identity the runtime's
    cross-run step memoization keys on,
  * **residency budgets** (per namespace, per tier): resident bytes are
    accounted incrementally on every copy install/replace/delete, and
    ``set_namespace_budget(ns, tier, max_bytes)`` bounds a namespace's
    footprint on a tier. Crossing the budget schedules background LRU
    **eviction** of the coldest entries: the latest version is written
    back to the local tier first (plain replica movement through the
    hazard-checked transfer path — never a versioned put, so it can
    neither bump a fence epoch nor resurrect a dropped namespace), then
    the over-budget replica is deleted. ``capacity_bytes`` is the
    store-wide ceiling the runtime's admission control checks against,
    and ``eviction_bytes`` churn is the autoscaler's thrash signal.

Values are arbitrary pytrees of tensors / arrays / scalars. A ``Transport``
performs the actual movement; the default in-process transport moves every
tensor to the destination tier's device (``.to(device)``). Stored values
are immutable: a step that changes a stored tensor must write a new one.
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from repro_torch._tree import to_device, tree_leaves
from repro_torch.cloud.wire import manifest_of


class MDSSTransferError(RuntimeError):
    """A cross-tier transfer could not complete (e.g. a peer in-flight
    copy never landed). Maps to ``StepFailure`` at staging time so the
    executor's retry / tier-fallback path owns recovery."""


def namespace_of(uri: str) -> str:
    """Namespace component of a URI ('' for un-namespaced URIs)."""
    return uri.split("/", 1)[0] if "/" in uri else ""


def shard_uri(uri: str, k: int) -> str:
    """URI of shard ``k`` of a fanned-out value.

    A shard is an ordinary store entry — its own versions, manifest,
    chunk-index rows, and ``content_digest`` — so the locality scorer,
    wire dedup, and step memoization treat every shard independently:
    mutating one shard's rows re-digests (and re-ships, re-executes)
    only that shard. ``#`` never appears in namespace separators, so a
    namespaced view resolves ``ns/uri#k`` like any other leaf.
    """
    return f"{uri}#{k}"


def shard_uris(uri: str, n: int) -> List[str]:
    """All ``n`` shard URIs of ``uri``, in shard order."""
    return [shard_uri(uri, k) for k in range(n)]


def nbytes_of(value) -> int:
    total = 0
    for leaf in tree_leaves(value):
        if hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
        elif isinstance(leaf, (int, float, bool)):
            total += 8
        elif isinstance(leaf, (str, bytes)):
            total += len(leaf)
    return total


class Transport:
    """Moves a value between tiers; override for a real RPC fabric."""

    def __init__(self, tiers=None):
        self.tiers = tiers or {}

    def transfer(self, value, src: str, dst: str):
        tier = self.tiers.get(dst)
        if tier is not None and tier.device is not None:
            return to_device(value, tier.device)
        return value


@dataclass
class _Entry:
    version: int = 0
    writer: str = ""
    copies: Dict[str, Tuple[int, Any]] = field(default_factory=dict)


class MDSS:
    def __init__(self, tiers, transport: Optional[Transport] = None,
                 cost_model=None, capacity_bytes: Optional[int] = None,
                 chunk_dedup: bool = True):
        self.tiers = tiers
        self.transport = transport or Transport(tiers)
        self.cost_model = cost_model
        # content-addressed residency: replica installs register chunk
        # digests per tier, and transfer obligations charge only chunks
        # not already resident at the destination (values are treated as
        # immutable once stored — mutating a stored array in place would
        # stale its cached manifest)
        self.chunk_dedup = chunk_dedup
        # store-wide resident-byte ceiling; the runtime's admission
        # control refuses new submissions when residency nears it
        self.capacity_bytes = capacity_bytes
        self._entries: Dict[str, _Entry] = {}
        # bumped by drop_namespace: fence tokens carry the epoch, so a
        # draining step's post-drop write-back is refused instead of
        # resurrecting the namespace (while a deliberate reuse of the
        # name by a NEW submission snapshots the new epoch and proceeds)
        self._ns_epoch: Dict[str, int] = {}
        self._lock = threading.RLock()
        # one wire flight per (uri, tier): racing ensures wait, not re-ship
        self._inflight: Dict[Tuple[str, str], threading.Event] = {}
        # best-effort prefetch backpressure: beyond this many concurrent
        # prefetch threads, new requests are dropped (ensure still staged
        # synchronously at execution time, so only overlap is lost)
        self._prefetch_slots = threading.BoundedSemaphore(4)
        # a peer in-flight transfer that never lands must not hang the
        # waiter forever: after max_transfer_waits expired waits the
        # ensure raises MDSSTransferError instead of retrying
        self.transfer_wait_s: float = 300.0
        self.max_transfer_waits: int = 3
        # accounting (sync_events is a bounded recent-transfer log — the
        # cumulative counters below carry the totals; a long-lived
        # multi-tenant store must not grow a per-transfer list forever)
        self.sync_events_cap = 4096
        self.bytes_moved: Dict[Tuple[str, str], int] = {}
        self.ns_bytes_moved: Dict[str, int] = {}     # per-namespace wire bytes
        self.modeled_seconds: float = 0.0
        self.sync_events: list = []
        self.prefetch_ops: int = 0
        self.prefetch_bytes: int = 0
        self.fenced_puts: int = 0
        # residency budgets + incremental resident-byte accounting: every
        # copies mutation goes through _set_copy/_del_copy so these stay
        # in lockstep with the store without full scans
        self._budgets: Dict[Tuple[str, str], int] = {}     # (ns, tier) -> max
        self._ns_tier_bytes: Dict[Tuple[str, str], int] = {}
        self._use_tick = itertools.count(1)                # LRU clock
        self._last_used: Dict[Tuple[str, str], int] = {}   # (uri, tier)
        self._evict_pending: set = set()   # (ns, tier) enforcement scheduled
        self.evictions: int = 0
        self.eviction_bytes: int = 0       # cumulative churn (autoscaler feed)
        # rows: (uri, tier, bytes, version, ns_epoch, t) — bounded below
        self.eviction_events: list = []    # bounded like sync_events
        # replica-install log consumed by the hazard sanitizer
        # (repro_torch.analysis.sanitizer): rows (uri, tier, version, ns_epoch, t).
        # installs_total keeps the true count so a consumer can tell when
        # the bounded list has been trimmed and skip install-order checks.
        self.install_events: list = []
        self.installs_total: int = 0
        # per-tier chunk index: digest -> [refcount, length]. Kept in
        # lockstep with ``copies`` by _set_copy/_del_copy, same as the
        # residency byte counters — chunks leave the index exactly when
        # the last replica referencing them leaves the tier (eviction,
        # drop_namespace, overwrite)
        self._tier_chunks: Dict[str, Dict[bytes, list]] = {}
        self._manifest_cache: "OrderedDict[Tuple[str, int], tuple]" = \
            OrderedDict()
        self.manifest_cache_cap = 4096
        self.dedup_bytes_elided: int = 0   # transfer bytes chunk-dedup saved

    # ------------------------------------------------------------------ api
    def put(self, uri: str, value, tier: str = "local",
            expect_version: Optional[int] = None, _manifest=None):
        """New version written on ``tier`` (local-first semantics).

        With ``expect_version`` the put is a fenced write: it succeeds only
        if the entry is still at that version (compare-and-bump under the
        store lock). A stale writer — e.g. a speculation loser finishing
        after the winner already published — gets ``None`` back and the
        entry is untouched. ``_manifest`` lets batch callers pre-hash the
        value's chunk manifest outside the store lock.
        """
        if _manifest is None and self.chunk_dedup:
            # hash before taking the lock (re-entrant callers that
            # already hold it pay under the lock, same as before)
            _manifest = manifest_of(value)
        with self._lock:
            e = self._entries.setdefault(uri, _Entry())
            if expect_version is not None and e.version != expect_version:
                self.fenced_puts += 1
                return None
            e.version += 1
            e.writer = tier
            if _manifest is not None:
                self._cache_manifest((uri, e.version), _manifest)
            self._set_copy(uri, e, tier, e.version, value)
            return e.version

    def _premanifests(self, values: Dict[str, Any]) -> Dict[str, tuple]:
        """Hash a batch's manifests with NO lock held (for put_many)."""
        if not self.chunk_dedup:
            return {}
        return {uri: manifest_of(val) for uri, val in values.items()}

    def put_many(self, values: Dict[str, Any], tier: str = "local",
                 expect_versions: Optional[Dict[str, int]] = None):
        """Atomically publish several URIs (one lock hold).

        With ``expect_versions`` the whole batch is fenced **all-or-
        nothing**: if any entry moved past its expected version, nothing
        is written and ``None`` is returned — two speculation twins can
        never interleave a mixed set of a step's outputs. An absent entry
        counts as version 0: expecting a nonzero version of a URI that
        (no longer) exists is a stale expectation and fences the batch —
        e.g. the entry was dropped with its namespace mid-execution.
        """
        if expect_versions is not None:
            # cheap pre-check before paying the batch hash: a fenced
            # publish (speculation loser) is a designed-common event and
            # must not burn SHA-256 over outputs it will then discard.
            # The authoritative check re-runs under the same lock hold
            # as the writes.
            with self._lock:
                if self._fence_stale(values, expect_versions):
                    self.fenced_puts += 1
                    return None
        pre = self._premanifests(values)
        with self._lock:
            if expect_versions is not None \
                    and self._fence_stale(values, expect_versions):
                self.fenced_puts += 1
                return None
            return {uri: self.put(uri, val, tier, _manifest=pre.get(uri))
                    for uri, val in values.items()}

    def _fence_stale(self, values, expect_versions) -> bool:
        """Lock held: True if any entry moved past its expected version."""
        for uri in values:
            e = self._entries.get(uri)
            cur = 0 if e is None else e.version
            if cur != expect_versions.get(uri, 0):
                return True
        return False

    def version(self, uri: str) -> int:
        e = self._entries.get(uri)
        return 0 if e is None else e.version

    def peek_latest(self, uri: str):
        """(value, version) of the freshest replica, wherever it lives —
        a lock-held reference read, no transfer, no accounting. For
        observers (checkpointing) that need a consistent snapshot without
        paying or modeling data movement."""
        with self._lock:
            e = self._entries.get(uri)
            if e is None:
                return None, 0
            src = self._freshest_tier(e)
            if src is None:
                return None, 0
            return e.copies[src][1], e.version

    def has_latest(self, uri: str, tier: str) -> bool:
        with self._lock:
            e = self._entries.get(uri)
            if e is None:
                return False
            got = e.copies.get(tier)
            return got is not None and got[0] == e.version

    def stale_bytes(self, uris, tier: str) -> int:
        """Bytes that WOULD move to make ``tier`` current for ``uris``."""
        return sum(n for _, _, n in self.staleness(uris, tier))

    def staleness(self, uris, tier: str) -> List[Tuple[str, str, int]]:
        """Per-URI transfer obligation of placing a reader on ``tier``:
        ``(uri, freshest_src_tier, nbytes)`` for every entry whose latest
        version is NOT already resident there. The locality scheduler
        turns this into modeled transfer seconds per candidate tier.

        With chunk dedup, ``nbytes`` counts only the chunks the
        destination tier does not already hold under ANY entry — staging
        content-identical data (another tenant's copy of the same
        params, a re-upload after eviction) owes nothing, which is
        exactly what ``CostModel.placement_cost`` should charge.
        """
        uris = list(uris)
        self._warm_manifests(uris)          # hash misses outside the lock
        out: List[Tuple[str, str, int]] = []
        with self._lock:
            for uri in uris:
                e = self._entries.get(uri)
                if e is None or self.has_latest(uri, tier):
                    continue
                src = self._freshest_tier(e)
                if src is None:
                    continue
                version, value = e.copies[src]
                if self.chunk_dedup:
                    chunks = self._manifest_for(uri, version, value)[1]
                    n = self._missing_chunk_bytes(tier, chunks)
                else:
                    n = nbytes_of(value)
                out.append((uri, src, n))
        return out

    def get(self, uri: str, tier: str = "local"):
        """Value at ``tier``, syncing from the freshest tier if stale."""
        self.ensure([uri], tier)
        with self._lock:
            e = self._entries.get(uri)
            if e is None:
                raise KeyError(uri)
            return e.copies[tier][1]

    def ensure(self, uris, tier: str) -> int:
        """Make ``tier`` current for ``uris``; returns bytes moved.

        The transport call happens **outside** the store lock so a slow
        transfer never serialises unrelated puts/gets (or a concurrent
        prefetch). Installation is hazard-checked: the shipped copy is
        tagged with the version snapshotted before the transfer and never
        replaces a newer copy; if a writer bumped the entry mid-flight the
        loop re-ships the fresher version.
        """
        return sum(self._ensure_one(uri, tier) for uri in uris)

    def _ensure_one(self, uri: str, tier: str) -> int:
        moved = 0
        expired_waits = 0
        self._warm_manifests([uri])         # hash misses outside the lock
        while True:
            peer = None
            with self._lock:
                e = self._entries.get(uri)
                if e is None:
                    raise KeyError(uri)
                if self.has_latest(uri, tier):
                    self._touch(uri, tier)        # a read access, for LRU
                    return moved
                peer = self._inflight.get((uri, tier))
                if peer is None:
                    src = self._freshest_tier(e)
                    if src is None:
                        raise KeyError(f"{uri}: no replica anywhere")
                    snap_version = e.version
                    value = e.copies[src][1]
                    if self.chunk_dedup:
                        chunks = self._manifest_for(
                            uri, snap_version, value)[1]
                        missing = self._missing_chunk_bytes(tier, chunks)
                    else:
                        chunks, missing = None, None
                    flight = threading.Event()
                    self._inflight[(uri, tier)] = flight
            if peer is not None:
                # someone (e.g. a prefetch) is already shipping this copy:
                # wait for that flight instead of moving the bytes twice.
                # A flight that never lands (wedged transport, dead
                # prefetch thread) must not hang us forever: after
                # max_transfer_waits expired waits, surface a transfer
                # error — _stage_inputs maps it to StepFailure, so the
                # executor's retry/fallback path owns recovery.
                if not peer.wait(timeout=self.transfer_wait_s):
                    expired_waits += 1
                    if expired_waits >= self.max_transfer_waits:
                        raise MDSSTransferError(
                            f"{uri}: in-flight transfer to {tier} did not "
                            f"complete within {expired_waits} x "
                            f"{self.transfer_wait_s}s waits")
                continue
            try:
                # wire movement with no lock held. A chunk-aware
                # transport (transfer_ex) ships only non-resident chunks
                # — a fully-resident value is a metadata-only round trip
                # — and reports the bytes it actually owed; the default
                # transport is charged the same dedup-aware obligation.
                transfer_ex = getattr(self.transport, "transfer_ex", None)
                if transfer_ex is not None:
                    shipped, n = transfer_ex(value, src, tier,
                                             chunks=chunks,
                                             missing_bytes=missing)
                else:
                    shipped = self.transport.transfer(value, src, tier)
                    n = nbytes_of(shipped) if missing is None else missing
                if missing is not None:
                    self.dedup_bytes_elided += \
                        max(nbytes_of(shipped) - n, 0)
                with self._lock:
                    e = self._entries.get(uri)
                    if e is None:
                        raise KeyError(uri)
                    cur = e.copies.get(tier)
                    if cur is None or cur[0] < snap_version:
                        self._set_copy(uri, e, tier, snap_version, shipped)
                        moved += n
                        self._account(uri, src, tier, n)
                        self.sync_events.append((uri, src, tier, n))
                        if len(self.sync_events) > self.sync_events_cap:
                            del self.sync_events[
                                :len(self.sync_events) - self.sync_events_cap]
                    if self.has_latest(uri, tier):
                        return moved
            finally:
                with self._lock:
                    self._inflight.pop((uri, tier), None)
                flight.set()
            # version moved mid-transfer -> loop and ship the newer one

    # -------------------------------------------------------------- prefetch
    def prefetch(self, uris, tier: str) -> Optional[Future]:
        """Asynchronous :meth:`ensure` — transfer overlaps caller compute.

        Missing URIs (outputs of steps still in flight) are skipped, not
        errors: prefetch is a best-effort warm-up, correctness still rests
        on the synchronous ``ensure`` at execution time. Returns a future
        resolving to the bytes moved, or ``None`` when the request was
        dropped at the concurrency cap (stale prefetches are worthless, so
        past the cap requests are shed, not queued). Each admitted
        prefetch runs on its own short-lived daemon thread — nothing to
        shut down, nothing leaked.
        """
        uris = list(uris)
        if not self._prefetch_slots.acquire(blocking=False):
            return None
        fut: Future = Future()
        threading.Thread(target=self._prefetch_task, args=(uris, tier, fut),
                         daemon=True, name="mdss-prefetch").start()
        return fut

    def _prefetch_task(self, uris, tier: str, fut: Future):
        try:
            moved = 0
            for uri in uris:
                try:
                    moved += self._ensure_one(uri, tier)
                except Exception:
                    # best-effort by contract: a missing uri or transport
                    # hiccup must neither kill the rest of the batch nor
                    # surface on a future nobody retrieves — the one
                    # ensure that matters runs synchronously at staging
                    pass
            with self._lock:
                self.prefetch_ops += 1
                self.prefetch_bytes += moved
            fut.set_result(moved)
        finally:
            self._prefetch_slots.release()

    def synchronize(self, uri: Optional[str] = None, tiers=None):
        """Paper's ``synchronize``: reconcile replicas last-writer-wins."""
        with self._lock:
            uris = [uri] if uri else list(self._entries)
            tiers = tiers or list(self.tiers)
            pairs = [(u, t) for u in uris for t in tiers
                     if t in self._entries[u].copies
                     or t == self._entries[u].writer]
        for u, t in pairs:       # transfers outside the lock
            self.ensure([u], t)

    # ------------------------------------------------------------- internal
    def _freshest_tier(self, e: _Entry) -> Optional[str]:
        best, best_v = None, -1
        for t, (v, _) in e.copies.items():
            if v > best_v:
                best, best_v = t, v
        return best if best_v == e.version else None

    def _account(self, uri: str, src: str, dst: str, n: int):
        key = (src, dst)
        self.bytes_moved[key] = self.bytes_moved.get(key, 0) + n
        ns = namespace_of(uri)
        self.ns_bytes_moved[ns] = self.ns_bytes_moved.get(ns, 0) + n
        if self.cost_model is not None:
            self.modeled_seconds += self.cost_model.transfer_time(n, src, dst)

    def _touch(self, uri: str, tier: str):
        self._last_used[(uri, tier)] = next(self._use_tick)

    # ------------------------------------------------- content addressing
    def _manifest_for(self, uri: str, version: int, value):
        """(content_digest, [(chunk_digest, length), ...]) of a stored
        value, cached per (uri, version) — lock held. Hashing happens
        once per version however many tiers the replica reaches; the
        public put paths pre-hash OUTSIDE the lock and seed this cache,
        so a multi-MB publish does not stall other tenants' store ops."""
        key = (uri, version)
        got = self._manifest_cache.get(key)
        if got is not None:
            self._manifest_cache.move_to_end(key)
            return got
        mani = manifest_of(value)
        self._cache_manifest(key, mani)
        return mani

    def _cache_manifest(self, key, mani):
        self._manifest_cache[key] = mani
        while len(self._manifest_cache) > self.manifest_cache_cap:
            self._manifest_cache.popitem(last=False)

    def _warm_manifests(self, uris):
        """Hash any manifest-cache misses for ``uris``' freshest replicas
        with NO lock held, then seed the cache. The read paths
        (staleness, content_digest, ensure) call this first so their
        under-lock work is dict lookups, not SHA-256 of multi-MB values
        — a racing version bump can still miss and hash under the lock,
        but that is the rare case, not the steady state."""
        if not self.chunk_dedup:
            return
        with self._lock:
            todo = []
            for uri in uris:
                e = self._entries.get(uri)
                if e is None:
                    continue
                src = self._freshest_tier(e)
                if src is None:
                    continue
                version, value = e.copies[src]
                if (uri, version) not in self._manifest_cache:
                    todo.append((uri, version, value))
        if not todo:
            return
        hashed = [(u, v, manifest_of(val)) for u, v, val in todo]
        with self._lock:
            for u, v, mani in hashed:
                if (u, v) not in self._manifest_cache:
                    self._cache_manifest((u, v), mani)

    def _chunks_retain(self, tier: str, uri: str, version: int, value):
        idx = self._tier_chunks.setdefault(tier, {})
        for d, ln in self._manifest_for(uri, version, value)[1]:
            ent = idx.get(d)
            if ent is None:
                idx[d] = [1, ln]
            else:
                ent[0] += 1

    def _chunks_release(self, tier: str, uri: str, version: int, value):
        idx = self._tier_chunks.get(tier)
        if idx is None:
            return
        for d, _ in self._manifest_for(uri, version, value)[1]:
            ent = idx.get(d)
            if ent is not None:
                ent[0] -= 1
                if ent[0] <= 0:
                    del idx[d]

    def _missing_chunk_bytes(self, tier: str, chunks) -> int:
        """Bytes of ``chunks`` not resident on ``tier`` — lock held."""
        idx = self._tier_chunks.get(tier, {})
        return sum(ln for d, ln in chunks if d not in idx)

    def tier_chunk_stats(self, tier: str) -> Tuple[int, int]:
        """(distinct chunks, deduped bytes) resident on ``tier``."""
        with self._lock:
            idx = self._tier_chunks.get(tier, {})
            return len(idx), sum(ln for _, ln in idx.values())

    def content_digest(self, uri: str) -> bytes:
        """Digest identifying the freshest replica's full content — the
        identity cross-run step memoization keys on."""
        self._warm_manifests([uri])
        with self._lock:
            e = self._entries.get(uri)
            if e is None:
                raise KeyError(uri)
            src = self._freshest_tier(e)
            if src is None:
                raise KeyError(f"{uri}: no fresh replica anywhere")
            version, value = e.copies[src]
            return self._manifest_for(uri, version, value)[0]

    def _set_copy(self, uri: str, e: _Entry, tier: str, version: int, value):
        """Install/replace ``tier``'s copy (lock held) keeping the
        incremental resident-byte counters and LRU clock current, and
        schedule eviction when the write pushes a namespace over its
        budget on this tier."""
        key = (namespace_of(uri), tier)
        old = e.copies.get(tier)
        if old is not None:
            self._ns_tier_bytes[key] = \
                self._ns_tier_bytes.get(key, 0) - nbytes_of(old[1])
            if self.chunk_dedup:
                self._chunks_release(tier, uri, old[0], old[1])
        e.copies[tier] = (version, value)
        self._ns_tier_bytes[key] = \
            self._ns_tier_bytes.get(key, 0) + nbytes_of(value)
        if self.chunk_dedup:
            self._chunks_retain(tier, uri, version, value)
        self.installs_total += 1
        self.install_events.append(
            (uri, tier, version, self._ns_epoch.get(key[0], 0),
             time.perf_counter()))
        if len(self.install_events) > self.sync_events_cap:
            del self.install_events[
                :len(self.install_events) - self.sync_events_cap]
        self._touch(uri, tier)
        self._maybe_schedule_eviction(*key)

    def _del_copy(self, uri: str, e: _Entry, tier: str) -> int:
        """Drop ``tier``'s copy (lock held); returns the bytes freed."""
        old = e.copies.pop(tier, None)
        if old is None:
            return 0
        if self.chunk_dedup:
            self._chunks_release(tier, uri, old[0], old[1])
        n = nbytes_of(old[1])
        key = (namespace_of(uri), tier)
        left = self._ns_tier_bytes.get(key, 0) - n
        if left > 0:
            self._ns_tier_bytes[key] = left
        else:
            self._ns_tier_bytes.pop(key, None)
        self._last_used.pop((uri, tier), None)
        return n

    # ------------------------------------------- residency budgets / eviction
    def set_namespace_budget(self, ns: str, tier: str,
                             max_bytes: Optional[int]):
        """Bound namespace ``ns``'s resident bytes on ``tier``
        (``None`` clears the budget). If the namespace is already over,
        background eviction starts immediately. The local tier is the
        eviction write-back target and cannot carry a budget — accepting
        one would be a bound that silently never evicts."""
        if max_bytes is not None and tier == "local":
            raise ValueError(
                "local is the eviction write-back tier: a residency "
                "budget there cannot be enforced")
        with self._lock:
            key = (ns, tier)
            if max_bytes is None:
                self._budgets.pop(key, None)
                return
            self._budgets[key] = int(max_bytes)
            self._maybe_schedule_eviction(ns, tier)

    def namespace_budget(self, ns: str, tier: str) -> Optional[int]:
        with self._lock:
            return self._budgets.get((ns, tier))

    def namespace_tier_bytes(self, ns: str, tier: str) -> int:
        """Bytes currently resident for namespace ``ns`` on ``tier``
        (incremental counter — no scan)."""
        with self._lock:
            return self._ns_tier_bytes.get((ns, tier), 0)

    def resident_bytes(self, tier: Optional[str] = None) -> int:
        """Total resident bytes (all replicas), optionally one tier's."""
        with self._lock:
            return sum(v for (_, t), v in self._ns_tier_bytes.items()
                       if tier is None or t == tier)

    def over_capacity(self, headroom: float = 1.0) -> bool:
        """True when residency reaches ``headroom`` x ``capacity_bytes``
        (False when no capacity is configured) — the admission signal."""
        cap = self.capacity_bytes
        return bool(cap) and self.resident_bytes() >= headroom * cap

    def _maybe_schedule_eviction(self, ns: str, tier: str):
        """Lock held: kick a background enforcement thread for an
        over-budget (namespace, tier), at most one at a time per pair."""
        key = (ns, tier)
        budget = self._budgets.get(key)
        if tier == "local" or budget is None \
                or self._ns_tier_bytes.get(key, 0) <= budget \
                or key in self._evict_pending:
            return
        self._evict_pending.add(key)
        threading.Thread(target=self._evict_task, args=key, daemon=True,
                         name="mdss-evict").start()

    def _evict_task(self, ns: str, tier: str):
        key = (ns, tier)
        while True:
            try:
                n, _ = self.enforce_budget(ns, tier)
            except Exception:
                n = 0       # transport wedged / store torn down mid-evict
            with self._lock:
                budget = self._budgets.get(key)
                if n == 0 or budget is None \
                        or self._ns_tier_bytes.get(key, 0) <= budget:
                    # done, unenforceable (no candidates), or budget gone:
                    # stop — the next over-budget write re-triggers
                    self._evict_pending.discard(key)
                    return

    def enforce_budget(self, ns: str, tier: str,
                       writeback_tier: str = "local") -> Tuple[int, int]:
        """Evict LRU entries of ``ns`` on ``tier`` until the configured
        budget fits; returns ``(entries_evicted, bytes_evicted)``.

        Eviction is write-back-then-drop: if ``tier`` holds the only
        latest copy it is first re-replicated on ``writeback_tier``
        through the normal hazard-checked transfer path. That path is
        plain replica movement — it never bumps a version and never
        recreates an entry (a namespace dropped mid-eviction surfaces as
        ``KeyError`` and is skipped), so eviction cannot defeat the fence
        epochs that keep a draining step's stale write-back out. Entries
        with a transfer currently in flight to ``tier`` are not
        candidates (the installing thread would just re-create the copy).
        """
        budget = self._budgets.get((ns, tier))
        if budget is None or tier == writeback_tier:
            return (0, 0)
        evicted_n = evicted_b = 0
        prefix = ns + "/" if ns else ""
        guard = 0
        while True:
            guard += 1
            if guard > 10000:    # pathological transport: never spin forever
                break
            with self._lock:
                if self._ns_tier_bytes.get((ns, tier), 0) <= budget:
                    break
                cands = [(self._last_used.get((u, tier), 0), u)
                         for u, e in self._entries.items()
                         if u.startswith(prefix) and tier in e.copies
                         and (u, tier) not in self._inflight
                         and (ns != "" or "/" not in u)]
                if not cands:
                    break
                _, victim = min(cands)
            try:
                # write-back outside the lock (hazard-checked install)
                self._ensure_one(victim, writeback_tier)
            except KeyError:
                continue       # entry/namespace dropped mid-eviction
            except MDSSTransferError:
                break          # wedged transfer: give up, retry next call
            with self._lock:
                e = self._entries.get(victim)
                if e is None:
                    continue
                tcopy = e.copies.get(tier)
                wcopy = e.copies.get(writeback_tier)
                if tcopy is None:
                    continue
                if wcopy is None or wcopy[0] < tcopy[0]:
                    continue   # a newer write landed on tier: re-ship it
                n = self._del_copy(victim, e, tier)
                self.evictions += 1
                self.eviction_bytes += n
                evicted_n += 1
                evicted_b += n
                self.eviction_events.append(
                    (victim, tier, n, tcopy[0],
                     self._ns_epoch.get(namespace_of(victim), 0),
                     time.perf_counter()))
                if len(self.eviction_events) > self.sync_events_cap:
                    del self.eviction_events[
                        :len(self.eviction_events) - self.sync_events_cap]
        return evicted_n, evicted_b

    # ----------------------------------------------------------- namespaces
    def namespaced(self, ns: str, shared: Optional[str] = None
                   ) -> "NamespacedMDSS":
        """A per-run view: writes land under ``ns/``, reads of URIs absent
        from ``ns`` fall through to the ``shared`` namespace."""
        return NamespacedMDSS(self, ns, shared=shared)

    def namespace_entries(self, ns: str):
        """URIs currently stored under namespace ``ns``."""
        prefix = ns + "/"
        with self._lock:
            return [u for u in self._entries if u.startswith(prefix)]

    def namespace_bytes(self, ns: str) -> int:
        """Wire bytes moved so far on behalf of namespace ``ns``."""
        with self._lock:
            return self.ns_bytes_moved.get(ns, 0)

    def namespace_resident_bytes(self, ns: str) -> int:
        """Bytes currently resident (all replicas) under namespace ``ns``."""
        with self._lock:
            return sum(v for (n, _), v in self._ns_tier_bytes.items()
                       if n == ns)

    def drop_namespace(self, ns: str) -> Tuple[int, int]:
        """Run teardown: delete every entry under ``ns/`` (and the
        namespace's residency budgets).

        Returns ``(entries_dropped, resident_bytes_freed)``. In-flight
        work targeting dropped URIs finishes harmlessly: the transfer
        install step re-checks the entry under the lock (a missing entry
        surfaces as KeyError to the best-effort shipper), and a draining
        step's fenced write-back is refused because its fence tokens
        carry the pre-drop namespace epoch — neither resurrects the data.
        """
        prefix = ns + "/"
        with self._lock:
            doomed = [u for u in self._entries if u.startswith(prefix)]
            freed = 0
            for u in doomed:
                e = self._entries[u]
                for t in list(e.copies):
                    freed += self._del_copy(u, e, t)
                del self._entries[u]
            # purge the dropped URIs' cached manifests (AFTER the
            # deletions — _del_copy's chunk release re-warms them): a
            # reused namespace restarts versions at 1, and a stale
            # (uri, version) hit would hand the OLD content's digest to
            # new data — wrong memo keys, wrong residency pricing
            dead = set(doomed)
            for key in [k for k in self._manifest_cache if k[0] in dead]:
                del self._manifest_cache[key]
            self._ns_epoch[ns] = self._ns_epoch.get(ns, 0) + 1
            for key in [k for k in self._budgets if k[0] == ns]:
                del self._budgets[key]
        return len(doomed), freed

    # ------------------------------------------------------------ reporting
    def total_bytes_moved(self) -> int:
        return sum(self.bytes_moved.values())

    def register_metrics(self, registry):
        """Expose the store's counters — including the previously
        orphaned ``eviction_bytes`` — as pull gauges in a metrics
        registry. Gauges read under the store lock at snapshot time, so
        hot-path puts/transfers pay nothing extra."""
        registry.gauge("mdss.resident_bytes", self.resident_bytes)
        registry.gauge("mdss.bytes_moved", self.total_bytes_moved)
        registry.gauge("mdss.modeled_seconds", lambda: self.modeled_seconds)
        registry.gauge("mdss.prefetch_ops", lambda: self.prefetch_ops)
        registry.gauge("mdss.prefetch_bytes", lambda: self.prefetch_bytes)
        registry.gauge("mdss.fenced_puts", lambda: self.fenced_puts)
        registry.gauge("mdss.evictions", lambda: self.evictions)
        registry.gauge("mdss.eviction_bytes", lambda: self.eviction_bytes)
        registry.gauge("mdss.dedup_bytes_elided",
                       lambda: self.dedup_bytes_elided)
        registry.gauge("mdss.entries", lambda: len(self._entries))
        registry.gauge("mdss.chunk_index_bytes", self._chunk_index_bytes)

    def _chunk_index_bytes(self) -> int:
        """Deduped bytes across every tier's chunk index."""
        with self._lock:
            return sum(sum(ln for _, ln in idx.values())
                       for idx in self._tier_chunks.values())

    def introspect(self) -> dict:
        """Structured residency snapshot: per-(namespace, tier) resident
        bytes vs. budget, per-tier totals + chunk-index occupancy, and
        the store's cumulative counters. One lock hold — internally
        consistent."""
        with self._lock:
            residency = [
                {"namespace": ns, "tier": tier, "resident_bytes": n,
                 "budget_bytes": self._budgets.get((ns, tier))}
                for (ns, tier), n in sorted(self._ns_tier_bytes.items())]
            tier_rows = []
            for name in self.tiers:
                idx = self._tier_chunks.get(name, {})
                tier_rows.append({
                    "name": name,
                    "objects": sum(1 for e in self._entries.values()
                                   if name in e.copies),
                    "resident_bytes": sum(
                        v for (_, t), v in self._ns_tier_bytes.items()
                        if t == name),
                    "capacity_bytes": None,   # store-wide cap: see top level
                    "chunks": len(idx),
                    "chunk_bytes": sum(ln for _, ln in idx.values()),
                })
            counters = {
                "bytes_moved": sum(self.bytes_moved.values()),
                "modeled_seconds": self.modeled_seconds,
                "prefetch_ops": self.prefetch_ops,
                "prefetch_bytes": self.prefetch_bytes,
                "fenced_puts": self.fenced_puts,
                "evictions": self.evictions,
                "eviction_bytes": self.eviction_bytes,
                "dedup_bytes_elided": self.dedup_bytes_elided,
                "entries": len(self._entries),
            }
        return {"residency": residency, "tiers": tier_rows,
                "capacity_bytes": self.capacity_bytes, "counters": counters}

    def reset_accounting(self):
        self.bytes_moved.clear()
        self.ns_bytes_moved.clear()
        self.modeled_seconds = 0.0
        self.sync_events.clear()
        self.prefetch_ops = 0
        self.prefetch_bytes = 0
        self.fenced_puts = 0
        self.evictions = 0
        self.eviction_bytes = 0
        self.eviction_events.clear()
        self.install_events.clear()
        self.installs_total = 0


class NamespacedMDSS:
    """Per-run MDSS view (multi-tenant isolation with shared warm data).

    Implements the executor/manager-facing MDSS surface over a base store:

      * writes (``put``/``put_many``) always land under ``ns/uri`` — a run
        can never clobber another run's (or the shared namespace's) data,
      * reads (``get``/``ensure``/``version``/...) resolve ``uri`` to
        ``ns/uri`` when the run has written it, else fall through to
        ``shared/uri`` when a shared namespace is configured and holds the
        URI — cross-run warm data (params, observations) is stored and
        kept cloud-resident exactly once,
      * write fences (``expect_version``) compare against the *resolved*
        read version, so a fence snapshotted against a shared-namespace
        entry still means "nothing newer was published" when the fenced
        write creates the run's first private copy of the URI.

    Resolution is decided per call; dataflow (WAR/WAW) edges inside a run
    serialise its readers against its writers, and other runs never write
    this namespace, so a read resolved to ``shared`` cannot race a private
    overwrite it should have seen.
    """

    def __init__(self, base: MDSS, ns: str, shared: Optional[str] = None):
        assert "/" not in ns, f"namespace may not contain '/': {ns!r}"
        self.base = base
        self.ns = ns
        self.shared = shared if shared != ns else None

    # ------------------------------------------------------- key resolution
    def _wkey(self, uri: str) -> str:
        return f"{self.ns}/{uri}"

    def _rkey(self, uri: str) -> str:
        wk = f"{self.ns}/{uri}"
        if self.shared is None:
            return wk
        with self.base._lock:
            if wk in self.base._entries:
                return wk
            sk = f"{self.shared}/{uri}"
            if sk in self.base._entries:
                return sk
        return wk

    # ------------------------------------------------------------------ api
    def put(self, uri: str, value, tier: str = "local",
            expect_version: Optional[int] = None):
        if expect_version is None:
            return self.base.put(self._wkey(uri), value, tier)
        with self.base._lock:           # pre-check before paying the hash
            if self.version(uri) != expect_version:
                self.base.fenced_puts += 1
                return None
        mani = manifest_of(value) if self.base.chunk_dedup else None
        with self.base._lock:
            if self.version(uri) != expect_version:
                self.base.fenced_puts += 1
                return None
            return self.base.put(self._wkey(uri), value, tier,
                                 _manifest=mani)

    def fence_tokens(self, uris) -> Dict[str, Tuple[str, int, int]]:
        """Snapshot (resolved key, version, namespace epoch) per URI for
        a later fenced ``put_many``. Tokens carry the *resolution* — a
        bare version number is ambiguous across the shared/private
        boundary (shared/u at v1 and a later private run/u at v1 compare
        equal), which would let a speculation loser's late publish slip
        past the fence — and the namespace *epoch*, so a draining step's
        write-back after ``drop_namespace`` is refused rather than
        resurrecting the dropped data."""
        with self.base._lock:
            epoch = self.base._ns_epoch.get(self.ns, 0)
            return {u: (self._rkey(u), self.base.version(self._rkey(u)),
                        epoch)
                    for u in uris}

    def put_many(self, values: Dict[str, Any], tier: str = "local",
                 expect_versions: Optional[Dict] = None):
        """Fenced batch publish. ``expect_versions`` values may be plain
        ints (compat: compared against the resolved read version) or
        :meth:`fence_tokens` tuples (compared against resolution, version
        AND namespace epoch — required for correctness under shared-read
        fallback and namespace teardown)."""
        if expect_versions is not None:
            with self.base._lock:   # pre-check before paying the hash
                if self._batch_stale(values, expect_versions):
                    self.base.fenced_puts += 1
                    return None
        pre = self.base._premanifests(values)
        with self.base._lock:
            if expect_versions is not None \
                    and self._batch_stale(values, expect_versions):
                self.base.fenced_puts += 1
                return None
            return {uri: self.base.put(self._wkey(uri), val, tier,
                                       _manifest=pre.get(uri))
                    for uri, val in values.items()}

    def _batch_stale(self, values, expect_versions) -> bool:
        """Base lock held: True if any fence token no longer matches."""
        for uri in values:
            exp = expect_versions.get(uri, 0)
            if isinstance(exp, tuple):
                rkey, ver = exp[0], exp[1]
                cur = self._rkey(uri)
                stale = (cur != rkey
                         or self.base.version(cur) != ver
                         or (len(exp) > 2 and exp[2] !=
                             self.base._ns_epoch.get(self.ns, 0)))
            else:
                stale = self.version(uri) != exp
            if stale:
                return True
        return False

    def version(self, uri: str) -> int:
        return self.base.version(self._rkey(uri))

    def peek_latest(self, uri: str):
        return self.base.peek_latest(self._rkey(uri))

    def content_digest(self, uri: str) -> bytes:
        return self.base.content_digest(self._rkey(uri))

    def has_latest(self, uri: str, tier: str) -> bool:
        return self.base.has_latest(self._rkey(uri), tier)

    def stale_bytes(self, uris, tier: str) -> int:
        return self.base.stale_bytes([self._rkey(u) for u in uris], tier)

    def staleness(self, uris, tier: str):
        return self.base.staleness([self._rkey(u) for u in uris], tier)

    def get(self, uri: str, tier: str = "local"):
        return self.base.get(self._rkey(uri), tier)

    def ensure(self, uris, tier: str) -> int:
        return self.base.ensure([self._rkey(u) for u in uris], tier)

    def prefetch(self, uris, tier: str) -> Optional[Future]:
        return self.base.prefetch([self._rkey(u) for u in uris], tier)

    def synchronize(self, uri: Optional[str] = None, tiers=None):
        return self.base.synchronize(
            self._rkey(uri) if uri is not None else None, tiers)

    def resolves_shared(self, uri: str) -> bool:
        """True when a read of ``uri`` currently falls through to the
        shared namespace (the run holds no private copy)."""
        return self.shared is not None and \
            self._rkey(uri).startswith(self.shared + "/")

    # ----------------------------------------------------------- accounting
    def bytes_moved_here(self) -> int:
        return self.base.namespace_bytes(self.ns)

    def set_budget(self, tier: str, max_bytes: Optional[int]):
        """Residency budget for THIS run's namespace on ``tier``."""
        self.base.set_namespace_budget(self.ns, tier, max_bytes)

    def resident_bytes_here(self, tier: str) -> int:
        return self.base.namespace_tier_bytes(self.ns, tier)

    def drop(self) -> Tuple[int, int]:
        return self.base.drop_namespace(self.ns)

    @property
    def tiers(self):
        return self.base.tiers

    @property
    def cost_model(self):
        return self.base.cost_model

"""Lease-store backends: WHERE lease authority comes from.

The JAX package's serve/store.py, copied with the imports rewritten:
the lease stores are host-only.

The journal's lease protocol (claim / renew / fence / reclaim, see
serve/queue.py) is backend-agnostic — what varies across deployments is
the pair of primitives the protocol leans on:

  * the CLOCK the ``*_m`` journal stamps (``admitted_m``,
    ``deadline_m``, ``expires_m``, ``progress_m``, ``claimed_m``) are
    taken on, and
  * the LIVENESS oracle that lets one daemon declare another dead.

``local`` (:class:`LocalLeaseStore`) is the historical single-host
contract, byte-for-byte: stamps are the machine-wide CLOCK_MONOTONIC
(``time.monotonic()``), and a lease owner is provably dead when its
recorded pid no longer exists on this host (``os.kill(pid, 0)``).
Cheap and exact — and meaningless the moment two hosts share a spool:
pids collide across hosts and each host's monotonic clock starts at an
arbitrary boot-relative zero.

``sharedfs`` (:class:`SharedFsLeaseStore`) is the cross-host contract
for a spool on a shared filesystem. Two substitutions:

  CLOCK — every store instance calibrates its host-local monotonic
  clock against the SPOOL FILESYSTEM's timestamp domain once at
  startup (write a probe file, stat it, remember
  ``fs_delta = st_mtime - monotonic()``), and :meth:`now` returns
  ``monotonic() + fs_delta`` ever after. Stamps from different hosts
  then live in one shared domain — the service captures' ``epoch_m`` alignment
  trick, applied to the journal itself — so a cross-host
  ``expires_m <= now`` comparison is well-defined no matter which
  host's arbitrary monotonic epoch produced either side. The delta is
  frozen at init: a wall-clock step on the filesystem server after
  calibration skews hosts calibrated before/after against each other,
  which widens (never corrupts) takeover latency — the fencing token
  keeps every verdict safe regardless (see below).

  LIVENESS — pid probes are replaced by durable per-daemon heartbeat
  documents (``hosts/<daemon_id>.json``: host id, a per-process
  ``boot`` nonce, a ``stamp_m`` in the shared clock domain). Takeover
  triggers on translated lease EXPIRY (the primary path — a dead
  daemon stops renewing), on a ``boot`` nonce mismatch (the restarted-
  daemon case: same host id, new process — reclaim instantly instead
  of waiting out the lease), or on heartbeat staleness past the
  owner-declared ``stale_s`` (the backstop for a lease carrying a
  garbage far-future expiry). ``os.kill`` never crosses a host
  boundary; dutlint rule "host-locality" pins pid-liveness idioms to
  this module's local backend.

Neither backend is the AUTHORITY for exactly-once — that is always the
per-job fencing token, bumped in the same durable transaction as every
claim and checked at every durable commit. A wrong liveness verdict
(either direction) costs at most duplicated compute or takeover
latency; it can never corrupt an output. That token-over-pid argument
is what makes the liveness substitution safe to ship.

The backend choice is pinned per spool in a ``store.json`` marker so a
mixed fleet cannot happen: the first daemon writes the marker
(``resolve_store(..., pin=True)``) and every later daemon or client
either inherits it or fails loudly on an explicit mismatch.

This module must stay importable without the executor stack (the
client's poll path constructs a store per SpoolQueue).
"""

from __future__ import annotations

import json
import math
import os
import socket
import time
import uuid

from duplexumiconsensusreads_torch.io.durable import unique_tmp, write_durable

# the per-spool backend pin (see resolve_store)
STORE_MARKER = "store.json"
STORE_KINDS = ("local", "sharedfs")

# durable heartbeat documents live here, one per daemon
HB_DIRNAME = "hosts"

# a sharedfs daemon's heartbeat is declared stale after this many lease
# lengths without a fresh stamp_m — the reclaim ladder's BACKSTOP, not
# its trigger: a dead daemon's leases expire after one lease_s, well
# before its heartbeat goes stale, so staleness only decides for leases
# whose expiry stamp cannot be trusted
HB_STALE_FACTOR = 2.0

# synthetic-host knobs for multi-host tests/benches on one machine:
# distinct host identities and skewed monotonic epochs without needing
# two kernels (the calibration must cancel the skew exactly)
HOST_ID_ENV = "DUT_HOST_ID"
EPOCH_SKEW_ENV = "DUT_HOST_EPOCH_SKEW"

_HOST = socket.gethostname()


def ceil_ms(seconds: float) -> float:
    """``seconds`` rounded UP to the millisecond. Every stamp or wait
    that a threshold is judged against is written this way: an expiry
    or deadline stamp so that it never falls before its allowance ends,
    the start of a stall so that the stall is never read as longer than
    it was, and a wait that crossed its threshold so that the record
    never reads as shorter (to the nearest, a stall of 1.5004 s over a
    1.5 s threshold was recorded as 1.5)."""
    return math.ceil(seconds * 1000.0) / 1000.0


def floor_ms(seconds: float) -> float:
    """``seconds`` rounded DOWN to the millisecond: a threshold recorded
    beside a :func:`ceil_ms` wait that crossed it, so the wait always
    reads as the longer."""
    return math.floor(seconds * 1000.0) / 1000.0


def _pid_alive(pid: int) -> bool:
    """Local-host pid probe (the ``local`` backend's liveness oracle).
    Only meaningful for pids of THIS host — which is exactly why it
    lives here and why dutlint's host-locality rule keeps it here."""
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except (OSError, OverflowError):
        return True  # exists but not ours (EPERM), or unprobeable: assume alive
    return True


class LeaseStore:
    """One spool's clock + liveness contract. Subclasses implement the
    primitives; serve/queue.py and serve/service.py call only this
    surface, never ``time.monotonic()``/``os.kill`` directly (the
    host-locality lint pins that)."""

    kind = "abstract"

    # ------------------------------------------------------------ clock

    def now(self) -> float:
        """Current time in the spool's shared stamp domain — the domain
        of every ``*_m`` journal stamp and service-capture epoch."""
        raise NotImplementedError

    # ------------------------------------------------------- lease docs

    def lease_doc(self, owner: str, lease_s: float) -> dict:
        """The journal lease entry a fresh claim writes."""
        raise NotImplementedError

    def claim_rec(self, owner: str, token: int) -> dict:
        """One bounded lease_history record (quarantine diagnosis)."""
        raise NotImplementedError

    def reclaim_reason(
        self, lease, now: float, is_live=None, hosts=None
    ) -> str | None:
        """Why this lease no longer protects its job — ``"no-lease"`` /
        ``"expired"`` / ``"dead-owner"`` / ``"restarted"`` — or None
        while it still holds. ``is_live`` is the in-process daemon
        registry (local backend only); ``hosts`` a heartbeat snapshot
        from :meth:`observe` (sharedfs only)."""
        raise NotImplementedError

    # -------------------------------------------------------- liveness

    def pid_alive(self, pid: int) -> bool:
        """Is a pid embedded in spool litter (``*.tmp.<pid>.<tid>``
        staging names) possibly alive? Cross-host backends must answer
        True (pids from other hosts are unprobeable — never reap)."""
        return True

    def attach(self, daemon_id: str, lease_s: float) -> None:
        """Bind a daemon identity to this store (daemon side only;
        clients never attach). Backends with heartbeat documents write
        the first one here."""

    def beat(self) -> None:
        """Refresh this daemon's liveness evidence (fault site
        ``serve.hb`` at the caller). No-op for backends whose liveness
        is kernel-derived."""

    def observe(self) -> dict:
        """Snapshot of the fleet's heartbeat documents
        ``{daemon_id: doc}`` (fault site ``serve.store`` at the
        caller). Empty for backends without documents."""
        return {}

    def capture_epoch(self) -> float | None:
        """``epoch_m`` override for this daemon's service capture: the
        capture's clock domain must match the journal stamps so the
        fleet stitcher can align N daemons' captures. None = keep the
        recorder's own monotonic t0 (single-host domain)."""
        return None


class LocalLeaseStore(LeaseStore):
    """Single-host semantics, unchanged: CLOCK_MONOTONIC stamps,
    pid-liveness, flock + kernel as the only fleet substrate."""

    kind = "local"

    def now(self) -> float:
        return time.monotonic()

    def lease_doc(self, owner: str, lease_s: float) -> dict:
        return {
            "owner": owner,
            "pid": os.getpid(),
            "host": _HOST,
            "expires_m": ceil_ms(self.now() + lease_s),
        }

    def claim_rec(self, owner: str, token: int) -> dict:
        return {
            "owner": owner, "pid": os.getpid(), "token": token,
            "claimed_m": round(self.now(), 3),
        }

    def reclaim_reason(
        self, lease, now: float, is_live=None, hosts=None
    ) -> str | None:
        if lease is None:
            return "no-lease"
        if float(lease.get("expires_m", 0)) <= now:
            return "expired"
        if lease.get("host") == _HOST:
            pid = int(lease.get("pid", -1))
            if not _pid_alive(pid):
                return "dead-owner"
            if (
                pid == os.getpid()
                and is_live is not None
                and not is_live(lease.get("owner"))
            ):
                return "dead-owner"
        return None

    def pid_alive(self, pid: int) -> bool:
        return _pid_alive(pid)


class SharedFsLeaseStore(LeaseStore):
    """Cross-host semantics for a spool on a shared filesystem: stamps
    in the filesystem's timestamp domain, liveness from durable
    heartbeat documents, takeover by translated expiry — never by pid.

    ``host_id``/``epoch_skew`` come from the constructor, the
    ``DUT_HOST_ID``/``DUT_HOST_EPOCH_SKEW`` environment (subprocess
    multi-host tests), or default to the real hostname / zero skew.
    ``epoch_skew`` shifts this instance's view of its own monotonic
    clock — a synthetic stand-in for "a different host booted at a
    different time"; the probe calibration cancels it exactly
    (``now() = probe_mtime + monotonic_elapsed_since_probe``), which
    the clock-matrix tests pin as a regression guard."""

    kind = "sharedfs"

    def __init__(
        self, root: str, host_id: str | None = None,
        epoch_skew: float | None = None,
    ):
        self.root = root
        self.host_id = (
            host_id if host_id is not None
            else os.environ.get(HOST_ID_ENV) or _HOST
        )
        if epoch_skew is None:
            epoch_skew = float(os.environ.get(EPOCH_SKEW_ENV) or 0.0)
        self._skew = float(epoch_skew)
        # per-process nonce: a restarted daemon (same host id, same
        # daemon id on the command line) is a DIFFERENT boot, and its
        # heartbeat document proves it — the instant-takeover case
        self.boot = uuid.uuid4().hex[:12]
        self.hb_dir = os.path.join(root, HB_DIRNAME)
        os.makedirs(self.hb_dir, exist_ok=True)
        self._daemon_id: str | None = None
        self._lease_s = 0.0
        self._stale_s = 0.0
        self._beats = 0
        self._fs_delta = self._calibrate()

    # ---------------------------------------------------- fs-clock sync

    def _host_clock(self) -> float:
        return time.monotonic() + self._skew

    def _calibrate(self) -> float:
        """One probe write against the spool filesystem: the frozen
        offset from this host's (skewed) monotonic clock to the
        filesystem timestamp domain. Error is one write-to-stat
        latency; precision is the filesystem's timestamp granularity —
        both far under any sane lease_s."""
        probe = os.path.join(self.hb_dir, f".probe.{self.boot}")
        fd = os.open(probe, os.O_CREAT | os.O_WRONLY | os.O_TRUNC, 0o644)
        try:
            os.write(fd, b"probe")
            sampled = self._host_clock()
        finally:
            os.close(fd)
        try:
            mtime = os.stat(probe).st_mtime
        finally:
            try:
                os.remove(probe)
            except OSError:
                pass  # best-effort; a stray probe is inert litter
        return mtime - sampled

    def now(self) -> float:
        return self._host_clock() + self._fs_delta

    # ------------------------------------------------------- lease docs

    def lease_doc(self, owner: str, lease_s: float) -> dict:
        # no pid, no kernel hostname: the lease carries exactly the
        # identity the reclaim ladder can verify from across a host
        # boundary — owner + boot nonce + translated expiry
        return {
            "owner": owner,
            "host": self.host_id,
            "boot": self.boot,
            "expires_m": ceil_ms(self.now() + lease_s),
        }

    def claim_rec(self, owner: str, token: int) -> dict:
        return {
            "owner": owner, "boot": self.boot, "token": token,
            "claimed_m": round(self.now(), 3),
        }

    def reclaim_reason(
        self, lease, now: float, is_live=None, hosts=None
    ) -> str | None:
        # ``is_live`` (the in-process registry) is deliberately ignored:
        # across hosts the only evidence is the journal + heartbeat
        # documents, and the token makes any verdict safe
        if lease is None:
            return "no-lease"
        if float(lease.get("expires_m", 0)) <= now:
            return "expired"
        hb = (hosts or {}).get(lease.get("owner"))
        if isinstance(hb, dict):
            boot = lease.get("boot")
            if boot is not None and hb.get("boot") != boot:
                return "restarted"
            try:
                stamp = float(hb.get("stamp_m", now))
                stale_s = float(hb.get("stale_s", 0.0))
            except (TypeError, ValueError):
                return None  # garbage heartbeat: expiry still covers
            if stale_s > 0 and now - stamp > stale_s:
                return "dead-owner"
        return None

    # -------------------------------------------------------- heartbeat

    def attach(self, daemon_id: str, lease_s: float) -> None:
        self._daemon_id = daemon_id
        self._lease_s = float(lease_s)
        self._stale_s = HB_STALE_FACTOR * float(lease_s)
        self.beat()

    def beat(self) -> None:
        if self._daemon_id is None:
            return  # client-side store: no identity, no document
        self._beats += 1
        doc = {
            "daemon_id": self._daemon_id,
            "host_id": self.host_id,
            "boot": self.boot,
            "stamp_m": ceil_ms(self.now()),
            "beats": self._beats,
            "lease_s": self._lease_s,
            "stale_s": self._stale_s,
            "fs_delta": round(self._fs_delta, 6),
        }
        path = os.path.join(self.hb_dir, self._daemon_id + ".json")
        write_durable(
            path,
            json.dumps(doc, sort_keys=True).encode(),
            tmp=unique_tmp(path),
        )

    def observe(self) -> dict:
        out: dict[str, dict] = {}
        try:
            names = os.listdir(self.hb_dir)
        except OSError:
            return out
        for n in sorted(names):
            if not n.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.hb_dir, n)) as f:
                    doc = json.load(f)
            except (OSError, ValueError):
                continue  # torn/racing document: skip, expiry covers
            if isinstance(doc, dict) and isinstance(
                doc.get("daemon_id"), str
            ):
                out[doc["daemon_id"]] = doc
        return out

    def capture_epoch(self) -> float | None:
        return self.now()


def resolve_store(
    root: str, kind: str | None = None, pin: bool = False,
    host_id: str | None = None, epoch_skew: float | None = None,
) -> LeaseStore:
    """Resolve one spool's lease-store backend against its
    ``store.json`` marker. ``kind`` None inherits the marker (default
    ``local`` on an unmarked spool); an explicit ``kind`` that
    contradicts an existing marker is a hard error — a mixed-backend
    fleet would compare stamps across clock domains. ``pin=True``
    (the daemon path — clients never pin) durably writes the marker on
    an unmarked spool, implicit-default ``local`` included, so the
    SECOND daemon cannot accidentally diverge from the first."""
    os.makedirs(root, exist_ok=True)
    marker = os.path.join(root, STORE_MARKER)
    on_disk = None
    try:
        with open(marker) as f:
            doc = json.load(f)
        if isinstance(doc, dict) and isinstance(doc.get("store"), str):
            on_disk = doc["store"]
    except (OSError, ValueError):
        pass  # absent/torn marker: the next pinning daemon rewrites it
    if kind is None:
        kind = on_disk or "local"
    elif on_disk is not None and kind != on_disk:
        raise ValueError(
            f"spool {root!r} is pinned to store {on_disk!r} but "
            f"--store {kind} was requested: one spool, one clock/"
            f"liveness domain (remove the spool or drop the flag)"
        )
    if kind not in STORE_KINDS:
        raise ValueError(
            f"unknown lease store {kind!r} (expected one of {STORE_KINDS})"
        )
    if pin and on_disk is None:
        write_durable(
            marker,
            json.dumps(
                {"version": 1, "store": kind}, sort_keys=True
            ).encode(),
            tmp=unique_tmp(marker),
        )
    if kind == "sharedfs":
        return SharedFsLeaseStore(root, host_id=host_id,
                                  epoch_skew=epoch_skew)
    return LocalLeaseStore()

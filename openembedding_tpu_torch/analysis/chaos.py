"""Deterministic fault injection keyed on sync-point names (the port's
copy of ``openembedding_tpu/analysis/chaos.py``).

The port's host code names its interleavings with ``sync_point`` (the
same names as the JAX package's, at the same places: ``ckpt.delta.
commit``, ``trainer.fit.step``, ``registry.swap.commit`` ...) and routes
each arrival through the one schedule slot of ``analysis/concurrency.py``.
A :class:`FaultPlan` plugs into that slot, so faults inject at existing
markers: the n-th arrival at a named point raises (:class:`ChaosError`),
sleeps, kills the thread (:class:`ChaosKill`, a ``BaseException`` that
unwinds past ``except Exception``), tears the thread's next atomic file
commit (``utils.fs.open_atomic``: the tmp file is cut to half its bytes
and the writer dies before the rename), or drops the network
(:class:`ChaosNetError`). Plans come from code (:func:`install_plan`,
:func:`active_plan`) or from ``OE_CHAOS_PLAN`` (inline JSON or
``@/path/plan.json``, :func:`install_from_env`). Every injection is
counted as ``oe_chaos_injected_total{action=,point=}``, recorded as a
``chaos.inject`` span and appended to ``plan.injected``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from . import scope
from . import concurrency
from ..utils import fs

ACTIONS = ("raise", "delay_ms", "kill_thread", "torn_write", "drop_net")

#: counter name — renders as ``oe_chaos_injected_total{action=,point=}``
COUNTER = "chaos_injected"


class ChaosError(RuntimeError):
    """Injected recoverable fault (action ``raise``)."""


class ChaosNetError(ChaosError, ConnectionError):
    """Injected network drop (action ``drop_net``) — a
    ``ConnectionError``, so failover rotations classify it as a dead
    replica, not a logic error."""


class ChaosKill(BaseException):
    """Injected thread death (actions ``kill_thread`` / ``torn_write``).

    A ``BaseException`` on purpose: ordinary ``except Exception``
    recovery must NOT see it — the thread unwinds the way a kill would,
    and only harness-level ``except ChaosKill`` (or ``finally``) runs.
    """


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One deterministic fault: at the ``hit``-th matching arrival of
    ``point``, perform ``action`` (one-shot). ``thread`` is an fnmatch
    pattern over the arriving thread's name — pin a fault to one worker
    of a pool when global arrival order across threads is racy."""

    point: str
    action: str
    hit: int = 1
    ms: float = 10.0          # delay_ms budget
    thread: str = "*"

    def __post_init__(self):
        if not self.point:
            raise ValueError("point must be a sync-point name")
        if self.action not in ACTIONS:
            raise ValueError(f"unknown chaos action {self.action!r}; "
                             f"known: {ACTIONS}")
        if self.hit < 1:
            raise ValueError(f"hit must be >= 1 (1-based), got {self.hit}")
        if self.ms < 0:
            raise ValueError(f"ms must be >= 0, got {self.ms}")


class FaultPlan:
    """A seeded set of :class:`FaultSpec` implementing the schedule
    protocol. Install with :func:`install_plan`; every ``sync_point``
    arrival is matched against the specs and the ``hit``-th match fires
    its action exactly once. ``seed`` is carried for provenance (sweep
    tools derive their scenario ordering from it) — matching itself is
    count-based and needs no randomness."""

    def __init__(self, faults: Sequence[FaultSpec], seed: int = 0,
                 inner: Optional[Any] = None):
        self.faults = list(faults)
        self.seed = int(seed)
        self.inner = inner
        self._lock = threading.Lock()
        self._counts = [0] * len(self.faults)
        self._fired = [False] * len(self.faults)
        # armed torn commits: thread ident -> FaultSpec (consumed by
        # the fs commit hook on that thread's next atomic commit)
        self._torn: Dict[int, FaultSpec] = {}
        #: injection log: [{"point","action","hit","thread"}...]
        self.injected: List[Dict[str, Any]] = []

    # -- construction --------------------------------------------------------
    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "FaultPlan":
        if not isinstance(obj, dict):
            raise ValueError("chaos plan must be a JSON object")
        unknown = set(obj) - {"faults", "seed"}
        if unknown:
            raise ValueError(f"unknown chaos plan keys {sorted(unknown)}")
        faults = []
        for i, f in enumerate(obj.get("faults", [])):
            if not isinstance(f, dict):
                raise ValueError(f"faults[{i}] must be an object")
            known = {fl.name for fl in dataclasses.fields(FaultSpec)}
            bad = set(f) - known
            if bad:
                raise ValueError(f"faults[{i}]: unknown keys {sorted(bad)}; "
                                 f"known: {sorted(known)}")
            faults.append(FaultSpec(**f))
        return cls(faults, seed=int(obj.get("seed", 0)))

    def to_json(self) -> Dict[str, Any]:
        return {"seed": self.seed,
                "faults": [dataclasses.asdict(f) for f in self.faults]}

    # -- schedule protocol ---------------------------------------------------
    def sync(self, key: str, point: str) -> None:
        tname = key[: -(len(point) + 1)] if key.endswith("/" + point) \
            else key
        fire: Optional[FaultSpec] = None
        with self._lock:
            for i, spec in enumerate(self.faults):
                if self._fired[i] or spec.point != point:
                    continue
                if not fnmatch.fnmatchcase(tname, spec.thread):
                    continue
                self._counts[i] += 1
                if self._counts[i] == spec.hit:
                    self._fired[i] = True
                    fire = spec
                    break
            if fire is not None:
                self.injected.append({"point": point, "action": fire.action,
                                      "hit": fire.hit, "thread": tname})
        if fire is not None:
            self._fire(fire, point)
        if self.inner is not None:
            self.inner.sync(key, point)

    def _fire(self, spec: FaultSpec, point: str) -> None:
        scope.HISTOGRAMS.inc(COUNTER, point=point, action=spec.action)
        with scope.span("chaos.inject", point=point, action=spec.action):
            if spec.action == "raise":
                raise ChaosError(
                    f"chaos: injected fault at {point!r} (hit {spec.hit})")
            if spec.action == "delay_ms":
                time.sleep(spec.ms / 1e3)
                return
            if spec.action == "kill_thread":
                raise ChaosKill(
                    f"chaos: thread killed at {point!r} (hit {spec.hit})")
            if spec.action == "drop_net":
                raise ChaosNetError(
                    f"chaos: network dropped at {point!r} (hit {spec.hit})")
            # torn_write: arm this thread's next atomic commit to tear
            with self._lock:
                self._torn[threading.get_ident()] = spec

    # -- fs commit hook ------------------------------------------------------
    def commit_hook(self, path: str, tmp: str, f) -> bool:
        """Installed as ``fs.set_commit_hook`` while the plan is active.
        Returns False (commit proceeds normally) unless THIS thread has
        an armed tear; then: flush, truncate the tmp to half its bytes,
        and die BEFORE the atomic rename — the writer crashed mid-write,
        the old committed file survives under the final name, and the
        half-written tmp is debris. Recovery from the last committed
        version is exactly the guarantee the tmp+rename protocol makes
        for this crash, so the graftchaos sweep asserts it."""
        with self._lock:
            spec = self._torn.pop(threading.get_ident(), None)
        if spec is None:
            return False
        f.flush()
        size = f.tell()
        f.close()
        with open(tmp, "r+b") as t:
            t.truncate(max(1, size // 2))
        scope.HISTOGRAMS.inc(COUNTER, point="fs.commit",
                             action="torn_write_commit")
        raise ChaosKill(
            f"chaos: writer killed mid-write of {path!r} "
            f"({max(1, size // 2)}/{size} bytes in tmp, rename never "
            "ran)")


# --- global arming -----------------------------------------------------------

_ACTIVE: Optional[FaultPlan] = None


def install_plan(plan: FaultPlan) -> FaultPlan:
    """Arm ``plan``: occupy the sync-point schedule slot and the atomic-
    commit hook. Returns the plan (for ``plan.injected`` assertions)."""
    global _ACTIVE
    concurrency.install_schedule(plan)
    fs.set_commit_hook(plan.commit_hook)
    _ACTIVE = plan
    return plan


def clear_plan() -> None:
    global _ACTIVE
    concurrency.clear_schedule()
    fs.set_commit_hook(None)
    _ACTIVE = None


def current_plan() -> Optional[FaultPlan]:
    return _ACTIVE


class active_plan:
    """``with active_plan(plan) as p: ...`` — arm for the block only."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        return install_plan(self.plan)

    def __exit__(self, *exc) -> bool:
        clear_plan()
        return False


def plan_from_text(text: str) -> FaultPlan:
    """Parse a plan from inline JSON or an ``@/path/plan.json`` ref —
    the ``OE_CHAOS_PLAN`` / EnvConfig ``chaos.plan`` wire format."""
    text = text.strip()
    if text.startswith("@"):
        with open(text[1:]) as fh:
            text = fh.read()
    return FaultPlan.from_json(json.loads(text))


def install_from_env(env: Optional[Dict[str, str]] = None
                     ) -> Optional[FaultPlan]:
    """Arm the ``OE_CHAOS_PLAN`` plan when set; None otherwise. Called
    by daemon entry points (serving replica boot) so a parent process
    can chaos a child it cannot reach in-process."""
    raw = (os.environ if env is None else env).get("OE_CHAOS_PLAN", "")
    if not raw:
        return None
    return install_plan(plan_from_text(raw))


# --- sync-point discovery ----------------------------------------------------

#: subsystem buckets for sweep tools, by point-name prefix
SUBSYSTEMS: Dict[str, Sequence[str]] = {
    "ckpt": ("ckpt.", "dirty.", "trainer."),
    "ingest": ("ingest.",),
    "serving": ("registry.", "serving.", "routing.", "ha."),
    "offload": ("offload.",),
    "report": ("reporter.",),
}


def discover_sync_points(root: Optional[str] = None) -> List[str]:
    """Every ``sync_point("...")`` name in the package source, sorted —
    scanned live so the sweep can never silently drift from the code."""
    import re
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # real point names are dotted lower_snake segments; the shape filter
    # drops doc-text matches like ``sync_point("...")``
    pat = re.compile(r'sync_point\(\s*"([a-z0-9_]+(?:\.[a-z0-9_]+)+)"')
    found = set()
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            try:
                with open(os.path.join(dirpath, name)) as fh:
                    found.update(pat.findall(fh.read()))
            except OSError:
                continue
    return sorted(found)


def subsystem_of(point: str) -> str:
    for sub, prefixes in SUBSYSTEMS.items():
        if any(point.startswith(p) for p in prefixes):
            return sub
    return "other"

"""Typed system-config tree (``openembedding_tpu/utils/envconfig.py``):
the reference's EnvConfig equivalent, one frozen dataclass per section:

* ``a2a``      — owner-routed exchange sizing (bucket capacity / slack);
* ``exchange`` — the compressed-exchange precision ladder;
* ``offload``  — host-offload tier budgets;
* ``serving``  — controller port, default replica count, hash capacity,
  the binary plane's codec and the micro-batcher's sizing;
* ``report``   — accumulator reporting interval, the performance-
  evaluation gate and the traced-lock switch;
* ``chaos``    — the fault plan armed at boot;
* ``plan``     — the adaptive tuner's envelope and the ingest reader
  count (``data/stream.ShardStream``'s default).

Load precedence: built-in defaults < JSON file < environment
(``OE_<SECTION>_<FIELD>``) < explicit dict — every layer validated, unknown
keys rejected with the known set named. The port takes every section and
checker of the JAX module; where a checker reads a module the port does
not have (the exchange precisions of ``parallel/precision.py``), it
holds its own copy of the accepted names.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Dict, Optional, Tuple

from .config import to_bool

_CHECKS: Dict[type, Dict[str, Tuple[Callable[[Any], bool], str]]] = {}


def _check(cls, field: str, pred: Callable[[Any], bool], msg: str):
    _CHECKS.setdefault(cls, {})[field] = (pred, msg)


def _compress_ok(v) -> bool:
    from . import compress as compress_lib
    if v not in compress_lib.KNOWN:
        return False            # _validate adds the field context
    # a KNOWN codec whose binding is missing (zstd without zstandard)
    # raises compress.check's specific, actionable message instead of the
    # generic field error that would name zstd as acceptable
    compress_lib.check(v)
    return True


def _validate(obj) -> None:
    for field, (pred, msg) in _CHECKS.get(type(obj), {}).items():
        v = getattr(obj, field)
        if not pred(v):
            raise ValueError(
                f"{type(obj).__name__}.{field} = {v!r}: {msg}")


@dataclasses.dataclass(frozen=True)
class A2AConfig:
    """Owner-routed exchange sizing (parallel/alltoall.py)."""

    capacity: int = 0        # per-destination bucket rows; 0 = auto
    slack: float = 2.0       # auto capacity = slack * mean bucket

    def __post_init__(self):
        _validate(self)

    def spec_kwargs(self) -> Dict[str, Any]:
        """kwargs for EmbeddingSpec / make_*_specs (a2a_capacity/a2a_slack)."""
        return {"a2a_capacity": self.capacity, "a2a_slack": self.slack}


_check(A2AConfig, "capacity", lambda v: v >= 0, "must be >= 0 (0 = auto)")
_check(A2AConfig, "slack", lambda v: v > 0, "must be > 0")


@dataclasses.dataclass(frozen=True)
class ExchangeConfig:
    """Compressed-exchange precision ladder (parallel/precision.py) —
    the TPU-native analogue of the reference's RPC codec knob
    (server.message_compress, EnvConfig.cpp:27-34): precision on the
    wire instead of byte codecs. Applies to every spec built through
    ``spec_kwargs()``; per-variable EmbeddingSpec fields override."""

    precision: str = "f32"        # pulled rows on the wire: f32 | bf16
    push_precision: str = "f32"   # pushed pre-reduced grads: f32 | bf16
                                  # | int8_ef (per-row scale int8 +
                                  # error-feedback residual)

    def __post_init__(self):
        _validate(self)

    def spec_kwargs(self) -> Dict[str, Any]:
        """kwargs for EmbeddingSpec / make_*_specs."""
        return {"exchange_precision": self.precision,
                "push_precision": self.push_precision}


# the accepted names of openembedding_tpu/parallel/precision.py
EXCHANGE_PRECISIONS = ("f32", "bf16")
PUSH_PRECISIONS = ("f32", "bf16", "int8_ef")


def _exchange_precision_ok(v) -> bool:
    return v in EXCHANGE_PRECISIONS


def _push_precision_ok(v) -> bool:
    return v in PUSH_PRECISIONS


_check(ExchangeConfig, "precision", _exchange_precision_ok,
       "must be 'f32' or 'bf16' (pulled rows on the exchange wire)")
_check(ExchangeConfig, "push_precision", _push_precision_ok,
       "must be 'f32', 'bf16' or 'int8_ef' (pre-reduced gradient push)")


@dataclasses.dataclass(frozen=True)
class OffloadConfig:
    """Host-offload tier budgets (offload.py; reference server.cache_size
    MB=1024 + PMem pool knobs, EnvConfig.h:54-63)."""

    cache_capacity: int = 1 << 20
    occupancy_threshold: float = 0.7
    persist_pending_window: int = 64
    keep_fraction: float = 0.5
    # codec for the incremental persist chain ("", zlib, gated zstd)
    persist_compress: str = ""

    def __post_init__(self):
        _validate(self)

    def table_kwargs(self) -> Dict[str, Any]:
        """kwargs for ShardedOffloadedTable (budgets + persist window)."""
        return dataclasses.asdict(self)


_check(OffloadConfig, "cache_capacity", lambda v: v > 0, "must be > 0")
_check(OffloadConfig, "occupancy_threshold", lambda v: 0 < v <= 1,
       "must be in (0, 1]")
_check(OffloadConfig, "persist_pending_window", lambda v: v > 0,
       "must be > 0")
_check(OffloadConfig, "keep_fraction", lambda v: 0 <= v < 1,
       "must be in [0, 1)")
def _persist_codec_ok(v) -> bool:
    from . import compress as compress_lib
    try:
        compress_lib.check_persist_codec(v)   # the one owner of the rule
    except ValueError:
        return False
    return True


_check(OffloadConfig, "persist_compress", _persist_codec_ok,
       "must be '' or 'zlib' (the persist chain's npz container is "
       "deflate-only)")


# micro-batcher sizing defaults (the JAX package's serving/batcher.py
# reads them from here)
DEFAULT_BATCH_ROWS = 1024
DEFAULT_BATCH_WAIT_US = 200
DEFAULT_BATCH_QUEUE_ROWS = 1 << 15


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Serving controller defaults (serving/; reference controller.cc
    port 8010, create_model replica_num=3)."""

    port: int = 8010
    replica_num: int = 3
    hash_capacity: int = 1 << 20
    # binary data-plane codec (lookup responses, peer-restore row pages):
    # ""|zlib|zstd — the reference's server.message_compress
    # (client/EnvConfig.cpp:27-34)
    message_compress: str = ""
    # micro-batching lookup scheduler (serving/batcher.py): 0 disables;
    # > 0 arms the per-model batcher with this row cap per flush. Tune
    # from the serving_lookup_rows histogram (README "Serving load &
    # SLO gate"): batch_rows ~ a few x the p99 request size times the
    # concurrency you want coalesced; batch_wait_us bounds the latency
    # an idle server adds waiting for batch-mates
    batch_rows: int = 0
    batch_wait_us: int = DEFAULT_BATCH_WAIT_US
    # bounded queue depth in ROWS — offers past it get 429-busy
    batch_queue_rows: int = DEFAULT_BATCH_QUEUE_ROWS

    def __post_init__(self):
        _validate(self)


_check(ServingConfig, "port", lambda v: 0 <= v < 65536,
       "must be a port number (0 = ephemeral)")
_check(ServingConfig, "replica_num", lambda v: v >= 1, "must be >= 1")
_check(ServingConfig, "hash_capacity", lambda v: v > 0, "must be > 0")
_check(ServingConfig, "message_compress", _compress_ok,
       "must be a known, available codec ('', 'zlib', 'zstd')")
_check(ServingConfig, "batch_rows", lambda v: v >= 0,
       "must be >= 0 (0 disables micro-batching)")
_check(ServingConfig, "batch_wait_us", lambda v: v >= 0, "must be >= 0")
_check(ServingConfig, "batch_queue_rows", lambda v: v > 0, "must be > 0")


@dataclasses.dataclass(frozen=True)
class ReportConfig:
    """Observability (utils/observability.py; reference
    server.report_interval + pico_is_evaluate_performance)."""

    report_interval: float = 0.0   # seconds; 0 disables the reporter
    evaluate_performance: bool = False
    # arm the graftrace runtime lock detector (analysis/concurrency.py):
    # make_lock/make_rlock hand out TracedLock wrappers feeding the
    # lock-order graph + contention counters. Off = plain threading
    # locks, zero per-acquire cost. Env: OE_REPORT_TRACE_LOCKS=1 (read
    # both here and directly by concurrency.trace_locks_enabled, so the
    # env var works even without an EnvConfig.load)
    trace_locks: bool = False

    def __post_init__(self):
        _validate(self)


_check(ReportConfig, "report_interval", lambda v: v >= 0, "must be >= 0")


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Deterministic fault injection (analysis/chaos.py; armed by
    tools/graftchaos and the serving replica daemon at boot)."""

    # FaultPlan as inline JSON ('{"faults": [{"point": ..., "hit": 1,
    # "action": "raise"}]}') or a file ref ('@/path/plan.json'). Empty
    # = chaos disarmed. Env: OE_CHAOS_PLAN.
    plan: str = ""

    def __post_init__(self):
        _validate(self)


def _plan_ok(v: str) -> bool:
    if not v:
        return True
    if v.lstrip().startswith("@"):
        return True            # file ref — existence checked at arm time
    try:
        from ..analysis import chaos
        chaos.FaultPlan.from_json(json.loads(v))
        return True
    except (ValueError, TypeError):
        return False


_check(ChaosConfig, "plan", _plan_ok,
       "must be empty, '@/path/plan.json', or inline FaultPlan JSON")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """graftplan tuning envelope (analysis/plan.py, serving/batcher.py).

    The OFFLINE planner (tools/graftplan) writes its chosen knobs into
    the other sections; this section carries the envelope the ONLINE
    adaptive batcher is allowed to move inside — hard floor/ceiling per
    knob, the hysteresis that stops boundary flapping, and the kill
    switch (``online=False`` pins the static knobs; flipping it back
    off mid-run re-applies the configured statics). Env:
    ``OE_PLAN_<FIELD>``.
    """

    online: bool = False           # kill switch for the adaptive tuner
    rows_floor: int = 64           # adaptive max_batch_rows lower bound
    rows_ceiling: int = 8192       # ... upper bound (warmup compiles here)
    wait_floor_us: int = 50        # adaptive max_wait_us lower bound
    wait_ceiling_us: int = 2000    # ... upper bound
    adjust_interval_ms: int = 200  # tuner sampling period
    # consecutive out-of-band samples required before a knob step —
    # the hysteresis that keeps an oscillating load at the threshold
    # from flapping the knobs every sample
    hysteresis: int = 3
    step_factor: float = 2.0       # multiplicative knob step per adjust
    # planner-chosen ingest reader-pool width (data/stream.ShardStream);
    # 0 keeps the stream's own default
    readers: int = 0

    def __post_init__(self):
        _validate(self)
        _plan_bounds_ok(self)


_check(PlanConfig, "rows_floor", lambda v: v > 0, "must be > 0")
_check(PlanConfig, "rows_ceiling", lambda v: v > 0,
       "must be > 0 (and >= rows_floor)")
_check(PlanConfig, "wait_floor_us", lambda v: v >= 0, "must be >= 0")
_check(PlanConfig, "wait_ceiling_us", lambda v: v >= 0,
       "must be >= 0 (and >= wait_floor_us)")
_check(PlanConfig, "adjust_interval_ms", lambda v: v > 0, "must be > 0")
_check(PlanConfig, "hysteresis", lambda v: v >= 1, "must be >= 1")
_check(PlanConfig, "step_factor", lambda v: v > 1.0, "must be > 1.0")
_check(PlanConfig, "readers", lambda v: v >= 0,
       "must be >= 0 (0 = stream default)")


def _plan_bounds_ok(cfg: "PlanConfig") -> None:
    if cfg.rows_ceiling < cfg.rows_floor:
        raise ValueError(
            f"PlanConfig.rows_ceiling = {cfg.rows_ceiling} < rows_floor "
            f"= {cfg.rows_floor}: the adaptive envelope is empty")
    if cfg.wait_ceiling_us < cfg.wait_floor_us:
        raise ValueError(
            f"PlanConfig.wait_ceiling_us = {cfg.wait_ceiling_us} < "
            f"wait_floor_us = {cfg.wait_floor_us}: the adaptive "
            "envelope is empty")


_SECTIONS = {"a2a": A2AConfig, "exchange": ExchangeConfig,
             "offload": OffloadConfig, "serving": ServingConfig,
             "report": ReportConfig, "chaos": ChaosConfig,
             "plan": PlanConfig}


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """The full tree. Sections are frozen dataclasses; see module docs."""

    a2a: A2AConfig = dataclasses.field(default_factory=A2AConfig)
    exchange: ExchangeConfig = dataclasses.field(
        default_factory=ExchangeConfig)
    offload: OffloadConfig = dataclasses.field(default_factory=OffloadConfig)
    serving: ServingConfig = dataclasses.field(default_factory=ServingConfig)
    report: ReportConfig = dataclasses.field(default_factory=ReportConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)
    plan: PlanConfig = dataclasses.field(default_factory=PlanConfig)

    @classmethod
    def load(cls, config: Optional[Dict[str, Any]] = None,
             path: Optional[str] = None,
             env: Optional[Dict[str, str]] = None) -> "EnvConfig":
        """defaults < ``path`` (JSON file) < ``env`` (OE_SECTION_FIELD) <
        ``config`` dict. Unknown sections/fields raise, values are coerced
        to the declared field types."""
        tree: Dict[str, Dict[str, Any]] = {}

        def merge(src: Dict[str, Any], origin: str):
            for section, fields in src.items():
                if section not in _SECTIONS:
                    raise ValueError(
                        f"unknown config section {section!r} ({origin}); "
                        f"known: {sorted(_SECTIONS)}")
                if not isinstance(fields, dict):
                    raise ValueError(
                        f"config section {section!r} must be a mapping")
                known = {f.name for f in
                         dataclasses.fields(_SECTIONS[section])}
                unknown = set(fields) - known
                if unknown:
                    raise ValueError(
                        f"unknown {section} options {sorted(unknown)} "
                        f"({origin}); known: {sorted(known)}")
                tree.setdefault(section, {}).update(fields)

        if path:
            with open(path) as f:
                merge(json.load(f), origin=path)
        env = os.environ if env is None else env
        env_tree: Dict[str, Dict[str, str]] = {}
        for key, val in env.items():
            if not key.startswith("OE_"):
                continue
            parts = key[3:].lower().split("_", 1)
            if len(parts) == 2 and parts[0] in _SECTIONS:
                env_tree.setdefault(parts[0], {})[parts[1]] = val
        if env_tree:
            merge(env_tree, origin="environment")
        if config:
            merge(config, origin="config dict")

        sections = {}
        for name, scls in _SECTIONS.items():
            fields = {}
            defaults = scls()
            for k, v in tree.get(name, {}).items():
                want = type(getattr(defaults, k))
                fields[k] = to_bool(v) if want is bool else want(v)
            sections[name] = scls(**fields)
        return cls(**sections)

    def to_json(self) -> Dict[str, Dict[str, Any]]:
        return {name: dataclasses.asdict(getattr(self, name))
                for name in _SECTIONS}

    def apply_report(self):
        """Wire the report section into the observability plane: sets the
        performance-evaluation gate and starts the rank-0 periodic reporter
        when an interval is configured (WorkerContext.cpp:24-41). Returns
        the started Reporter (stop() it on shutdown) or None."""
        from . import observability
        observability.set_evaluate_performance(
            self.report.evaluate_performance)
        if self.report.trace_locks:
            # force ON (never force-off: an explicit OE_REPORT_TRACE_LOCKS
            # env var must keep working without an EnvConfig in play)
            from ..analysis.concurrency import set_trace_locks
            set_trace_locks(True)
        if self.report.report_interval > 0:
            return observability.Reporter(
                self.report.report_interval).start()
        return None

    def apply_chaos(self):
        """Arm the configured chaos plan (analysis/chaos.py) when one is
        set; returns the installed FaultPlan or None. Daemon entry
        points call this so OE_CHAOS_PLAN reaches child processes."""
        if not self.chaos.plan:
            return None
        from ..analysis import chaos
        return chaos.install_plan(chaos.plan_from_text(self.chaos.plan))

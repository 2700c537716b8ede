"""FlightRecorder: postmortem black-box dumps for the serving process.

The telemetry plane's recorders and judges are all *bounded
in-process buffers* — the trace ring, the event ring, the `TimeSeriesRing`
— which is exactly right for a healthy process and exactly wrong for a
3 a.m. incident: the moment an alert fires is also the moment the evidence
starts being overwritten. The flight recorder closes that gap the way an
aircraft black box does: when something goes wrong, freeze everything the
process knows into a durable artifact and keep serving.

One `FlightRecorder` subscribes to the `EventBus` and, on a trigger event
(``slo_burn``, ``quality_drift``, ``loop_error``, guard ``rollback`` /
``demotion`` by default) or an explicit crash report
(`record_crash(exc)` — wired into `launch/serve.py`'s fatal path and both
controller daemon loops), writes one **dump directory** containing:

* ``manifest.json`` — trigger, wall/monotonic stamps, per-router
  (table_version, stage_version) version stamps, dump format version,
  and the artifact inventory;
* ``events.jsonl`` — the full event ring at dump time;
* ``traces.jsonl`` — the last N sampled `RouteTrace`s;
* ``metrics.json`` — the registry snapshot (counters/gauges/histogram
  summaries);
* ``timeseries.json`` — the `TimeSeriesRing` window (per-point counters,
  gauges, and histogram count/sum — the burn-rate evidence);
* ``health.json`` / ``slo.json`` — the health snapshot and the SLO
  engine's last-evaluated state (``burning()`` — no re-judgement, so a
  dump can never publish fresh transitions into the bus it subscribes to);
* ``profile.json`` — the `JitProfiler` snapshot when one is attached
  (compile counters, cache sizes, per-program FLOPs/bytes).

Crash consistency: every dump is staged under ``.tmp-<name>`` and
published with one atomic ``os.rename`` — a reader (``python -m
repro_torch.obs.report replay``, ``/dumps``) never observes a half-written dump, and a crash mid-dump
leaves only a ``.tmp-`` directory the next retention sweep removes.

Noise discipline: triggers are **debounced** (one dump per
``debounce_s``; an incident that fires slo_burn + quality_drift +
rollback in one window produces ONE dump whose manifest names the first
trigger) and **bounded** (``max_dumps`` retained, oldest deleted), so a
flapping alert can neither fill the disk nor turn the recorder into the
incident. `dumps_written` / `dumps_suppressed` count both sides, mirrored
as ``flightrec_dumps_total`` / ``flightrec_suppressed_total`` when a
registry is attached.

Offline, ``python -m repro_torch.obs.report replay <dump-dir>`` renders
the postmortem timeline: bus events interleaved with the sampled trace
spans around the trigger, plus the SLO/health state at dump time
(`render_replay`).

Counterpart of `repro/obs/flightrec.py`, copied with only its imports
changed. The dump format is the reference's (`DUMP_FORMAT_VERSION`), so a
dump crosses both ways: either package's `render_replay` reads the
other's.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import clock

__all__ = [
    "DEFAULT_TRIGGERS",
    "DUMP_FORMAT_VERSION",
    "FlightRecorder",
    "list_dumps",
    "load_dump",
    "render_replay",
]

DUMP_FORMAT_VERSION = 1

# the transitions that mean "evidence is about to evaporate": alerts from
# the judgement layer, enforcement actions from the guards, daemon failures
DEFAULT_TRIGGERS = (
    "slo_burn",
    "quality_drift",
    "loop_error",
    "rollback",
    "demotion",
)


def _json_default(o):
    """Best-effort JSON for numpy scalars/arrays and exceptions in details."""
    if hasattr(o, "item"):
        return o.item()
    if hasattr(o, "tolist"):
        return o.tolist()
    return repr(o)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2, default=_json_default)


@dataclasses.dataclass(frozen=True)
class DumpRecord:
    """One retained dump, as `list_dumps` reports it."""

    name: str
    path: str
    manifest: dict


class FlightRecorder:
    """Black-box dumper: bus-triggered, debounced, bounded, crash-consistent."""

    def __init__(
        self,
        out_dir: str,
        bus=None,  # repro_torch.obs.events.EventBus
        registry=None,  # repro_torch.obs.metrics.MetricsRegistry
        tracer=None,  # repro_torch.obs.trace.RouteTracer
        ring=None,  # repro_torch.obs.timeseries.TimeSeriesRing
        slo=None,  # repro_torch.obs.slo.SLOEngine
        health=None,  # repro_torch.obs.health.HealthMonitor
        profiler=None,  # repro_torch.obs.profile.JitProfiler
        routers: Sequence = (),
        trigger_kinds: Sequence[str] = DEFAULT_TRIGGERS,
        debounce_s: float = 30.0,
        max_dumps: int = 16,
        max_traces: int = 256,
    ):
        self.out_dir = str(out_dir)
        self.bus = bus
        self.registry = registry
        self.tracer = tracer
        self.ring = ring
        self.slo = slo
        self.health = health
        self.profiler = profiler
        self.routers = list(routers)
        self.trigger_kinds = frozenset(trigger_kinds)
        self.debounce_s = float(debounce_s)
        self.max_dumps = int(max_dumps)
        self.max_traces = int(max_traces)
        assert self.max_dumps >= 1 and self.max_traces >= 1
        self.dumps_written = 0
        self.dumps_suppressed = 0
        self.last_dump_path: Optional[str] = None
        self._last_dump_mono: Optional[float] = None
        self._seq = 0  # per-process dump counter (unique names)
        self._lock = threading.Lock()
        self._c_dumps = self._c_suppressed = None
        if registry is not None:
            self._c_dumps = registry.counter("flightrec_dumps_total")
            self._c_suppressed = registry.counter("flightrec_suppressed_total")
        os.makedirs(self.out_dir, exist_ok=True)
        self._subscribed = False
        if bus is not None:
            bus.subscribe(self._on_event)
            self._subscribed = True

    def stop(self) -> None:
        """Detach from the bus (idempotent). The first step of an orderly
        shutdown: after this, draining daemons can publish freely without
        triggering dumps from a half-torn-down process."""
        if self._subscribed and self.bus is not None:
            self.bus.unsubscribe(self._on_event)
        self._subscribed = False

    # ------------------------------------------------------------- triggering
    def _on_event(self, event) -> None:
        """Bus subscriber: trigger events become dumps (debounced).

        Runs synchronously on the publisher's thread *after* the publisher
        released its own locks (the bus contract), so a dump here can read
        every surface without deadlock — but it must never publish back into
        the bus, which `dump()` guarantees by only reading latched state
        (`slo.burning()`, never `slo.evaluate()`).
        """
        if event.kind in self.trigger_kinds:
            self.dump(reason=event.kind, trigger=event.as_dict())

    def record_crash(self, exc: BaseException, source: str = "unknown") -> Optional[str]:
        """Dump on a fatal exception (the serve launcher / daemon-loop hook).

        Crash dumps share the trigger debounce: a daemon loop crashing on
        every iteration produces one dump per window, not one per step.
        """
        trigger = {
            "kind": "crash",
            "source": source,
            "error": repr(exc),
            "error_type": type(exc).__name__,
        }
        return self.dump(reason="crash", trigger=trigger)

    # ----------------------------------------------------------------- dumping
    def dump(self, reason: str, trigger: Optional[dict] = None) -> Optional[str]:
        """Write one black-box dump; returns its path (None if debounced).

        The debounce check, name allocation, and publish are serialized
        under the recorder lock; the artifact writes happen outside any
        other plane's lock (everything read here is a snapshot API).
        """
        now = clock.monotonic()
        with self._lock:
            if (
                self._last_dump_mono is not None
                and now - self._last_dump_mono < self.debounce_s
            ):
                self.dumps_suppressed += 1
                if self._c_suppressed is not None:
                    self._c_suppressed.inc()
                return None
            self._last_dump_mono = now
            self._seq += 1
            seq = self._seq
            wall = clock.wall()
            name = f"dump-{int(wall)}-{seq:04d}-{reason}"
            final = os.path.join(self.out_dir, name)
            tmp = os.path.join(self.out_dir, f".tmp-{name}")
            try:
                self._write_dump(tmp, name, reason, trigger, wall, now)
                os.rename(tmp, final)  # atomic publish: all-or-nothing
            except Exception:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            self.dumps_written += 1
            self.last_dump_path = final
            if self._c_dumps is not None:
                self._c_dumps.inc()
            self._retain()
        return final

    def _write_dump(
        self,
        tmp: str,
        name: str,
        reason: str,
        trigger: Optional[dict],
        wall: float,
        mono: float,
    ) -> None:
        os.makedirs(tmp, exist_ok=True)
        artifacts: List[str] = []
        # routers' version stamps are the dump's identity: which (table,
        # stage) composition was serving when the trigger fired
        serving: List[dict] = []
        for r in self.routers:
            stage_version, stages = r.stage_set()
            serving.append({
                "table_version": r.db.table_version,
                "stage_version": stage_version,
                "active_stages": sorted(stages.active),
            })
        if self.bus is not None:
            events = [e.as_dict() for e in self.bus.events()]
            with open(os.path.join(tmp, "events.jsonl"), "w") as f:
                for e in events:
                    f.write(json.dumps(e, default=_json_default) + "\n")
            artifacts.append("events.jsonl")
        n_traces = 0
        if self.tracer is not None:
            traces = self.tracer.traces()[-self.max_traces:]
            n_traces = len(traces)
            with open(os.path.join(tmp, "traces.jsonl"), "w") as f:
                for t in traces:
                    f.write(json.dumps(t.as_dict(), default=_json_default) + "\n")
            artifacts.append("traces.jsonl")
        if self.registry is not None:
            _write_json(os.path.join(tmp, "metrics.json"),
                        self.registry.snapshot())
            artifacts.append("metrics.json")
        if self.ring is not None:
            _write_json(os.path.join(tmp, "timeseries.json"),
                        _ring_points_dict(self.ring))
            artifacts.append("timeseries.json")
        if self.health is not None:
            _write_json(os.path.join(tmp, "health.json"),
                        self.health.snapshot())
            artifacts.append("health.json")
        if self.slo is not None:
            # latched state only — evaluate() would publish transitions into
            # the very bus this recorder subscribes to (dump-from-a-dump)
            _write_json(os.path.join(tmp, "slo.json"),
                        {"burning": self.slo.burning()})
            artifacts.append("slo.json")
        if self.profiler is not None:
            _write_json(os.path.join(tmp, "profile.json"),
                        self.profiler.snapshot())
            artifacts.append("profile.json")
        manifest = {
            "format_version": DUMP_FORMAT_VERSION,
            "name": name,
            "reason": reason,
            "trigger": trigger,
            "wall_ts": wall,
            "mono_ts": mono,
            "serving": serving,
            "n_traces": n_traces,
            "artifacts": artifacts,
        }
        _write_json(os.path.join(tmp, "manifest.json"), manifest)

    def _retain(self) -> None:
        """Keep the newest `max_dumps` dumps; sweep stale .tmp- staging."""
        try:
            entries = sorted(os.listdir(self.out_dir))
        except OSError:
            return
        for e in entries:
            if e.startswith(".tmp-"):
                path = os.path.join(self.out_dir, e)
                # a .tmp- dir whose final name exists (or that was simply
                # abandoned by a crash) is garbage either way
                if path != self.last_dump_path:
                    shutil.rmtree(path, ignore_errors=True)
        dumps = [e for e in entries if e.startswith("dump-")]
        for e in dumps[: max(0, len(dumps) - self.max_dumps)]:
            shutil.rmtree(os.path.join(self.out_dir, e), ignore_errors=True)

    # ----------------------------------------------------------------- reading
    def list(self) -> List[DumpRecord]:
        """Retained dumps, oldest first (what ``/dumps`` serves)."""
        return list_dumps(self.out_dir)

    def summary(self) -> dict:
        with self._lock:
            return {
                "out_dir": self.out_dir,
                "dumps_written": self.dumps_written,
                "dumps_suppressed": self.dumps_suppressed,
                "last_dump": self.last_dump_path,
                "debounce_s": self.debounce_s,
                "max_dumps": self.max_dumps,
                "triggers": sorted(self.trigger_kinds),
            }


def _ring_points_dict(ring) -> dict:
    """The TimeSeriesRing's window as JSON: per-point counters/gauges and
    histogram (count, sum) — bucket vectors stay in-process, the replay
    only needs the windowed activity totals."""
    points = []
    for p in ring.points():
        points.append({
            "mono": p.mono,
            "wall": p.wall,
            "counters": dict(p.counters),
            "gauges": dict(p.gauges),
            "hists": {
                k: {"count": int(h.count), "sum": float(h.sum)}
                for k, h in p.hists.items()
            },
        })
    return {"interval_s": ring.interval_s, "points": points}


# ------------------------------------------------------------------ offline


def list_dumps(out_dir: str) -> List[DumpRecord]:
    """Published dumps under `out_dir`, oldest first (manifest attached).

    Staging dirs (``.tmp-``) and dirs without a readable manifest are
    skipped — the atomic-rename protocol means those are not dumps.
    """
    out: List[DumpRecord] = []
    try:
        entries = sorted(os.listdir(out_dir))
    except OSError:
        return out
    for e in entries:
        if not e.startswith("dump-"):
            continue
        path = os.path.join(out_dir, e)
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue
        out.append(DumpRecord(name=e, path=path, manifest=manifest))
    return out


def load_dump(path: str) -> dict:
    """Load one dump directory into a dict keyed by artifact."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out: dict = {"manifest": manifest}
    for art in manifest.get("artifacts", ()):
        fp = os.path.join(path, art)
        key = art.split(".")[0]
        if art.endswith(".jsonl"):
            records = []
            with open(fp) as f:
                for line in f:
                    line = line.strip()
                    if line:
                        records.append(json.loads(line))
            out[key] = records
        else:
            with open(fp) as f:
                out[key] = json.load(f)
    return out


def render_replay(path: str, window_s: float = 60.0) -> str:
    """Postmortem timeline of one dump: what happened, in order.

    Interleaves the event ring with the sampled trace spans inside the
    trailing `window_s` before the dump, marks the trigger, and closes with
    the SLO/health/version state at dump time — the offline answer to
    "what happened at 3 a.m.?".
    """
    d = load_dump(path)
    m = d["manifest"]
    lines = [
        f"flight dump {m['name']} (format v{m['format_version']})",
        f"reason: {m['reason']}"
        + (f" | trigger: {json.dumps(m['trigger'], default=_json_default)}"
           if m.get("trigger") else ""),
    ]
    for s in m.get("serving", ()):
        lines.append(
            f"serving: table v{s['table_version']} stage v{s['stage_version']}"
            f" stages={s['active_stages'] or '(none)'}"
        )
    slo = d.get("slo")
    if slo is not None:
        lines.append(f"slo burning at dump: {slo.get('burning') or '(none)'}")
    health = d.get("health")
    if health is not None:
        lines.append(f"health at dump: {health.get('status', '?')}")

    cutoff = float(m["wall_ts"]) - float(window_s)
    timeline: List[Tuple[float, str]] = []
    for e in d.get("events", ()):
        if e["ts"] < cutoff:
            continue
        detail = {k: v for k, v in e.items()
                  if k not in ("seq", "ts", "kind", "plane")}
        mark = " <-- trigger" if (
            m.get("trigger") and e.get("seq") == m["trigger"].get("seq")
        ) else ""
        timeline.append((
            e["ts"],
            f"event [{e['seq']:5d}] {e['plane']:8s} {e['kind']:16s} "
            + " ".join(f"{k}={v}" for k, v in sorted(detail.items()))
            + mark,
        ))
    for t in d.get("traces", ()):
        if t["ts"] < cutoff:
            continue
        spans = ", ".join(f"{n} {ms:.2f}ms" for n, ms in t["spans"].items())
        timeline.append((
            t["ts"],
            f"trace #{t['trace_id']} total={t['total_ms']:.2f}ms "
            f"[{spans}] batch={t['batch_size']} path={t['path']} "
            f"table=v{t['table_version']} stage=v{t['stage_version']}",
        ))
    timeline.sort(key=lambda x: x[0])
    t0 = float(m["wall_ts"])
    lines.append(f"timeline (trailing {window_s:g}s, {len(timeline)} entries):")
    for ts, text in timeline:
        lines.append(f"  {ts - t0:+8.2f}s {text}")
    n_older = len(d.get("events", ())) + len(d.get("traces", ())) - len(timeline)
    if n_older:
        lines.append(f"  ({n_older} older record(s) outside the window; "
                     f"widen with --window)")
    metrics = d.get("metrics")
    if metrics:
        hist = metrics.get("histograms", {}).get("route_batch_ms")
        if hist:
            lines.append(
                f"route_batch_ms at dump: n={hist['count']} "
                f"p50={hist['p50']:.2f}ms p99={hist['p99']:.2f}ms"
            )
    profile = d.get("profile")
    if profile:
        for fn, row in sorted(profile.get("jits", {}).items()):
            lines.append(
                f"jit {fn}: cache={row['cache_size']} "
                f"compiles_post_warmup={row['compiles_total']}"
            )
    return "\n".join(lines) + "\n"

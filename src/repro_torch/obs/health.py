"""Live health surface: one JSON snapshot + HTTP exposition for all planes.

`HealthMonitor` aggregates the health signals the planes already maintain
but that were previously write-only attributes someone had to know to poll:

* serving — per-router (table_version, stage_version, active stages,
  `outcomes_dropped`);
* control/learn — each controller's `last_loop_error` (set by a failing
  daemon step, cleared by the next good one) and step/report counts;
* index — per-manager freshness (False = exact-fallback serving while a
  rebuild is in flight) and build/serve counters;
* stores — OutcomeStore window size and ring drops;
* events — bus per-kind counts + ring drops.

`status` folds those into one tri-state: ``"error"`` when any daemon loop
is failing (`last_loop_error` set), ``"degraded"`` when serving is correct
but not nominal (stale index serving the exact fallback, outcome events
dropped, an SLO currently burning — see `repro_torch.obs.slo`), ``"ok"``
otherwise. Clear-on-recovery is inherited from the controllers: the next
successful step clears `last_loop_error` and the snapshot goes back to
"ok" with no monitor-side state (SLO state clears when the engine's next
evaluation sees the burn gone).

`ObsServer` exposes the snapshot over HTTP for scrapers and humans:
``/metrics`` (Prometheus text exposition from the registry), ``/health``
(this snapshot as JSON; 503 on "error" so load-balancer checks fail over),
``/events?since=N`` (bus tail), ``/slo`` (the SLO engine's burn-rate
snapshot), ``/traces?since=N`` / ``/traces?id=N`` (the tracer ring — how
the report's ``--watch`` panel resolves a p99 exemplar id into its
RouteTrace), ``/dumps`` (the flight recorder's retained black-box dumps:
manifests + recorder counters, the live half of the report's ``replay``),
and ``/profile`` (the JitProfiler's per-entry load counters, cache sizes,
and stamped FLOPs/bytes, plus the sampling profiler's stacks when one is
attached). It is a daemon-threaded stdlib server — zero deps, good for
one scraper and a curl, not a public ingress.

Counterpart of `repro/obs/health.py`, copied with only its imports
changed; the report is `repro_torch.obs.report`.
"""
from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence
from urllib.parse import parse_qs, urlparse

from repro_torch.obs.events import EventBus
from repro_torch.obs.metrics import MetricsRegistry, get_registry

__all__ = ["HealthMonitor", "ObsServer"]


class HealthMonitor:
    def __init__(
        self,
        routers: Sequence = (),
        controllers: Sequence = (),  # Refinement/LearningControllers mixed
        indexes: Sequence = (),  # ToolIndexManagers
        stores: Sequence = (),  # OutcomeStores
        bus: Optional[EventBus] = None,
        slo: Optional["SLOEngine"] = None,  # repro_torch.obs.slo
    ):
        self.routers = list(routers)
        self.controllers = list(controllers)
        self.indexes = list(indexes)
        self.stores = list(stores)
        self.bus = bus
        self.slo = slo

    def snapshot(self) -> dict:
        serving = []
        for r in self.routers:
            stage_version, stages = r.stage_set()
            serving.append({
                "table_version": r.db.table_version,
                "stage_version": stage_version,
                "active_stages": sorted(stages.active),
                "outcomes_dropped": r.outcomes_dropped,
            })
        control = []
        for c in self.controllers:
            err = getattr(c, "last_loop_error", None)
            control.append({
                "controller": type(c).__name__,
                "last_loop_error": repr(err) if err is not None else None,
                "n_reports": len(getattr(c, "reports", ())),
            })
        index = [
            {"fresh": m.is_fresh(), "backend": m.backend_kind,
             "stats": dict(m.stats)}
            for m in self.indexes
        ]
        stores = [
            {"n_events": len(s), "dropped": s.dropped,
             "total_ingested": s.total_ingested}
            for s in self.stores
        ]
        loop_errors = [c for c in control if c["last_loop_error"] is not None]
        # a burning SLO is "degraded", not "error": serving is still correct,
        # it is just out of objective — same class as fallback-serving
        burning = self.slo.burning() if self.slo is not None else []
        degraded = (
            any(not m["fresh"] for m in index)
            or any(r["outcomes_dropped"] for r in serving)
            or any(s["dropped"] for s in stores)
            or bool(burning)
        )
        status = "error" if loop_errors else ("degraded" if degraded else "ok")
        snap = {
            "status": status,
            "ok": status != "error",
            "serving": serving,
            "control": control,
            "index": index,
            "stores": stores,
        }
        if self.slo is not None:
            snap["slo"] = {"burning": burning}
        if self.bus is not None:
            snap["events"] = {
                "counts": self.bus.counts(),
                "retained": len(self.bus),
                "dropped": self.bus.dropped,
            }
        return snap


class ObsServer:
    """Daemon-threaded HTTP exposition of metrics/health/events."""

    def __init__(
        self,
        monitor: Optional[HealthMonitor] = None,
        registry: Optional[MetricsRegistry] = None,
        bus: Optional[EventBus] = None,
        host: str = "127.0.0.1",
        port: int = 0,  # 0 = ephemeral; read `.port` after construction
        slo: Optional["SLOEngine"] = None,  # repro_torch.obs.slo
        tracer: Optional["RouteTracer"] = None,  # repro_torch.obs.trace
        recorder: Optional["FlightRecorder"] = None,  # repro_torch.obs.flightrec
        profiler: Optional["JitProfiler"] = None,  # repro_torch.obs.profile
        sampler: Optional["SamplingProfiler"] = None,  # repro_torch.obs.profile
    ):
        self.monitor = monitor or HealthMonitor()
        self.registry = registry or get_registry()
        self.bus = bus
        self.slo = slo
        self.tracer = tracer
        self.recorder = recorder
        self.profiler = profiler
        self.sampler = sampler
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):  # no stderr chatter per scrape
                pass

            def _send(self, code: int, body: str, ctype: str):
                data = body.encode()
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/metrics":
                    self._send(200, server.registry.render_prometheus(),
                               "text/plain; version=0.0.4")
                elif url.path == "/health":
                    snap = server.monitor.snapshot()
                    self._send(200 if snap["ok"] else 503,
                               json.dumps(snap, indent=2), "application/json")
                elif url.path == "/events" and server.bus is not None:
                    since = int(
                        parse_qs(url.query).get("since", ["-1"])[0]
                    )
                    evs = [e.as_dict() for e in server.bus.events(since)]
                    self._send(200, json.dumps(evs, indent=2),
                               "application/json")
                elif url.path == "/slo" and server.slo is not None:
                    # snapshot() evaluates — a scrape is also a judgement,
                    # and the engine's transition latch keeps events single
                    snap = server.slo.snapshot()
                    self._send(200, json.dumps(snap, indent=2),
                               "application/json")
                elif url.path == "/traces" and server.tracer is not None:
                    qs = parse_qs(url.query)
                    if "id" in qs:
                        t = server.tracer.get(int(qs["id"][0]))
                        if t is None:
                            self._send(404, "trace not retained\n",
                                       "text/plain")
                            return
                        self._send(200, json.dumps(t.as_dict(), indent=2),
                                   "application/json")
                        return
                    since = int(qs.get("since", ["-1"])[0])
                    recs = [t.as_dict() for t in server.tracer.traces()
                            if t.trace_id > since]
                    self._send(200, json.dumps(recs, indent=2),
                               "application/json")
                elif url.path == "/dumps" and server.recorder is not None:
                    body = {
                        "recorder": server.recorder.summary(),
                        "dumps": [
                            {"name": d.name, "path": d.path,
                             "manifest": d.manifest}
                            for d in server.recorder.list()
                        ],
                    }
                    self._send(200, json.dumps(body, indent=2),
                               "application/json")
                elif url.path == "/profile" and server.profiler is not None:
                    body = server.profiler.snapshot()
                    if server.sampler is not None:
                        body["sampling"] = server.sampler.snapshot()
                    self._send(200, json.dumps(body, indent=2),
                               "application/json")
                else:
                    self._send(404, "not found\n", "text/plain")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "ObsServer":
        assert self._thread is None, "obs server already running"
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="obs-server", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        """Idempotent shutdown: stop accepting, join with a bounded wait,
        release the socket. Safe to call from a signal path and again from
        an atexit/finally path — the second call is a no-op."""
        if self._thread is None:
            return
        self._httpd.shutdown()
        self._thread.join(timeout=timeout_s)
        self._httpd.server_close()
        self._thread = None

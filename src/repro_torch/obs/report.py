"""Render route traces (and live health surfaces) for humans.

  PYTHONPATH=src python -m repro_torch.obs.report trace.jsonl
  ... trace.jsonl --since 1754600000 # only records at/after that ts
  ... --health http://127.0.0.1:9100 # pretty-print a live /health
  ... --follow http://127.0.0.1:9100 # tail the live event bus
  ... --watch  http://127.0.0.1:9100 # live health+SLO+exemplar panel
  ... replay dumps/dump-...-slo_burn # postmortem a flight-recorder dump
  ... replay dumps/                  # ...or the newest dump under a root

Counterpart of `repro/obs/report.py` (the JAX package's ``repro-obs``),
copied with only its imports changed; the port installs no console script.

Reads the JSONL a `RouteTracer.export_jsonl` wrote (one RouteTrace per
line) and prints per-phase latency percentiles, the path/bucket mix, and
the version span of the traced traffic — the offline twin of the
`/metrics` histograms, with exact per-batch samples instead of bucket
estimates. Against a live `ObsServer`, ``--follow`` tails ``/events``
using the bus's monotone ``since=`` cursor (every retained event exactly
once), and ``--watch`` renders a periodic panel of ``/health`` + ``/slo``,
resolving any burning latency SLO's p99 exemplar through ``/traces?id=``
into the actual RouteTrace spans.

``replay`` is the offline postmortem surface: given a FlightRecorder dump
directory (or a dump root, where it picks the newest), it renders the
recorded timeline — bus events interleaved with sampled trace spans around
the trigger, plus the SLO/health/version state frozen at dump time
(`repro_torch.obs.flightrec.render_replay`). It needs no live server: the dump
is self-contained, which is the point of a black box.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional

from repro_torch.obs.summary import percentile_stats

__all__ = [
    "follow_events",
    "main",
    "render_trace_report",
    "render_watch_panel",
    "replay",
    "watch",
]


def _load_jsonl(path: str) -> List[dict]:
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def render_trace_report(records: List[dict]) -> str:
    if not records:
        return "no traces\n"
    lines = [f"{len(records)} traces"]
    tvs = sorted({r["table_version"] for r in records})
    svs = sorted({r["stage_version"] for r in records})
    lines.append(
        f"table versions {tvs[0]}..{tvs[-1]} | stage versions "
        f"{svs[0]}..{svs[-1]}"
    )
    paths: Dict[str, int] = {}
    buckets: Dict[int, int] = {}
    for r in records:
        paths[r["path"]] = paths.get(r["path"], 0) + 1
        buckets[r["bucket"]] = buckets.get(r["bucket"], 0) + 1
    lines.append(
        "paths: " + ", ".join(f"{p}={n}" for p, n in sorted(paths.items()))
    )
    lines.append(
        "buckets: " + ", ".join(f"{b}={n}" for b, n in sorted(buckets.items()))
    )
    by_phase: Dict[str, List[float]] = {}
    for r in records:
        for name, ms in r["spans"].items():
            by_phase.setdefault(name, []).append(float(ms))
    by_phase["total"] = [float(r["total_ms"]) for r in records]
    lines.append(f"{'phase':10s} {'n':>6s} {'p50_ms':>9s} {'p99_ms':>9s} "
                 f"{'mean_ms':>9s}")
    for name, samples in sorted(by_phase.items()):
        s = percentile_stats(samples)
        lines.append(
            f"{name:10s} {s.n:6d} {s.p50_ms:9.3f} {s.p99_ms:9.3f} "
            f"{s.mean_ms:9.3f}"
        )
    return "\n".join(lines) + "\n"


def _fetch_json(url: str, timeout: float = 5.0):
    from urllib.request import urlopen

    with urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _format_event(e: dict) -> str:
    extra = {k: v for k, v in e.items() if k not in ("seq", "ts", "kind", "plane")}
    detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
    return f"[{e['seq']:5d}] {e['plane']:8s} {e['kind']:18s} {detail}".rstrip()


def follow_events(
    url: str,
    interval: float = 1.0,
    max_polls: int = 0,
    out=None,
) -> int:
    """Tail a live ObsServer's event bus (``/events?since=``).

    The bus's monotone seq is the cursor: each poll asks only for events
    past the last seen seq, so every retained event prints exactly once.
    ``max_polls=0`` follows until interrupted (the CLI default); tests pass
    a bound. Returns the number of events printed.
    """
    out = out or sys.stdout
    base = url.rstrip("/")
    since, polls, printed = -1, 0, 0
    while True:
        try:
            evs = _fetch_json(f"{base}/events?since={since}")
        except Exception as exc:
            out.write(f"unreachable: {exc}\n")
            evs = []
        for e in evs:
            out.write(_format_event(e) + "\n")
            printed += 1
            since = max(since, int(e["seq"]))
        out.flush()
        polls += 1
        if max_polls and polls >= max_polls:
            return printed
        time.sleep(interval)


def render_watch_panel(
    health: dict,
    slo: Optional[dict],
    trace_lookup: Optional[Callable[[int], Optional[dict]]] = None,
) -> str:
    """One frame of the live panel: status line, per-SLO burn table, and
    the p99 exemplar link for latency SLOs ("your p99 bucket → this
    RouteTrace") when the tracer sampled one."""
    lines = [f"health: {health.get('status', '?')}"]
    if slo is None:
        lines.append("slo: (engine not wired)")
        return "\n".join(lines) + "\n"
    burning = slo.get("burning", [])
    lines.append(
        f"slo: {slo.get('status', '?')}"
        + (f" — burning: {', '.join(burning)}" if burning else "")
    )
    lines.append(f"{'slo':24s} {'state':8s} {'burn':>8s}  detail")
    for name, s in sorted(slo.get("slos", {}).items()):
        burn = s.get("burn")
        burn_s = f"{burn:8.2f}" if burn is not None else f"{'—':>8s}"
        if s["kind"] == "latency" and s.get("p99_ms") is not None:
            detail = f"p99={s['p99_ms']:.2f}ms vs {s['threshold_ms']:g}ms"
        else:
            detail = s.get("description", "")
        state = "BURNING" if s.get("burning") else "ok"
        lines.append(f"{name:24s} {state:8s} {burn_s}  {detail}")
        ex = s.get("p99_exemplar")
        if ex is not None:
            trace = trace_lookup(int(ex)) if trace_lookup is not None else None
            if trace is not None:
                spans = ", ".join(
                    f"{n} {ms:.2f}ms" for n, ms in trace["spans"].items()
                )
                lines.append(
                    f"{'':24s} p99 exemplar → trace #{ex} "
                    f"[{spans}] (batch={trace['batch_size']}, "
                    f"path={trace['path']}, table=v{trace['table_version']})"
                )
            else:
                lines.append(f"{'':24s} p99 exemplar → trace #{ex} "
                             f"(not retained)")
    return "\n".join(lines) + "\n"


def watch(
    url: str,
    interval: float = 2.0,
    iterations: int = 0,
    out=None,
) -> int:
    """Periodic ``/health`` + ``/slo`` panel against a live ObsServer.

    ``iterations=0`` runs until interrupted; tests pass a bound. Returns
    the number of frames rendered.
    """
    out = out or sys.stdout
    base = url.rstrip("/")
    frames = 0
    while True:
        try:
            health = _fetch_json(f"{base}/health")
        except Exception as exc:
            fp = getattr(exc, "fp", None)  # 503 still carries the snapshot
            health = json.loads(fp.read()) if fp is not None else {
                "status": f"unreachable: {exc}"
            }
        try:
            slo = _fetch_json(f"{base}/slo")
        except Exception:
            slo = None

        def _lookup(trace_id: int) -> Optional[dict]:
            try:
                return _fetch_json(f"{base}/traces?id={trace_id}")
            except Exception:
                return None

        out.write(f"== repro-obs watch @ {time.strftime('%H:%M:%S')} ==\n")
        out.write(render_watch_panel(health, slo, _lookup))
        out.flush()
        frames += 1
        if iterations and frames >= iterations:
            return frames
        time.sleep(interval)


def _render_health(url: str) -> str:
    from urllib.request import urlopen

    try:
        with urlopen(url.rstrip("/") + "/health", timeout=5) as resp:
            snap = json.loads(resp.read())
    except Exception as exc:  # includes 503 (HTTPError) — still health info
        resp = getattr(exc, "fp", None)
        if resp is None:
            return f"unreachable: {exc}\n"
        snap = json.loads(resp.read())
    return json.dumps(snap, indent=2) + "\n"


def replay(dump_path: str, window_s: float = 60.0, out=None) -> int:
    """Render a flight-recorder dump (or the newest under a dump root).

    Returns 0 on success, 2 when the path holds no readable dump.
    """
    import os

    from repro_torch.obs.flightrec import list_dumps, render_replay

    out = out or sys.stdout
    path = dump_path.rstrip("/")
    if not os.path.exists(os.path.join(path, "manifest.json")):
        dumps = list_dumps(path)
        if not dumps:
            out.write(f"no flight dumps under {dump_path}\n")
            return 2
        out.write(f"{len(dumps)} dump(s) under {path}; replaying newest\n")
        path = dumps[-1].path
    out.write(render_replay(path, window_s=window_s))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("trace", nargs="?",
                    help="JSONL file from RouteTracer.export_jsonl, or the "
                         "literal 'replay' to postmortem a flight dump")
    ap.add_argument("dump", nargs="?",
                    help="flight-recorder dump directory (with 'replay')")
    ap.add_argument("--window", type=float, default=60.0, metavar="S",
                    help="replay timeline span before the dump (seconds)")
    ap.add_argument("--since", type=float, metavar="TS", default=None,
                    help="only report JSONL traces with ts >= TS "
                         "(wall-clock epoch seconds)")
    ap.add_argument("--health", metavar="URL",
                    help="pretty-print a live ObsServer /health instead")
    ap.add_argument("--follow", metavar="URL",
                    help="tail a live ObsServer's /events (ctrl-C to stop)")
    ap.add_argument("--watch", metavar="URL",
                    help="periodic /health + /slo panel with p99 exemplar "
                         "links (ctrl-C to stop)")
    ap.add_argument("--interval", type=float, default=1.0,
                    help="poll interval for --follow/--watch (seconds)")
    ap.add_argument("--max-polls", type=int, default=0,
                    help="stop --follow after N polls (0 = forever)")
    ap.add_argument("--iterations", type=int, default=0,
                    help="stop --watch after N frames (0 = forever)")
    args = ap.parse_args(argv)
    if args.trace == "replay":
        if not args.dump:
            ap.error("replay needs a dump directory")
        return replay(args.dump, window_s=args.window)
    if args.health:
        sys.stdout.write(_render_health(args.health))
        return 0
    if args.follow:
        try:
            follow_events(args.follow, interval=args.interval,
                          max_polls=args.max_polls)
        except KeyboardInterrupt:
            pass
        return 0
    if args.watch:
        try:
            watch(args.watch, interval=args.interval,
                  iterations=args.iterations)
        except KeyboardInterrupt:
            pass
        return 0
    if not args.trace:
        ap.error("pass a trace JSONL file, or --health/--follow/--watch URL")
    records = _load_jsonl(args.trace)
    if args.since is not None:
        records = [r for r in records if float(r.get("ts", 0.0)) >= args.since]
    sys.stdout.write(render_trace_report(records))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

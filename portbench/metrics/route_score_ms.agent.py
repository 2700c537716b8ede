"""Mean of the router's own score-phase span, route_phase_ms{phase="score"},
over the window's route_batch calls."""
import math


def read(run):
    v = run.counts.get("route_score_ms")
    return None if v is None or math.isnan(v) else v

"""Sum of the topk_sim calls' bounds (one a route_batch, at the queries the
harness passed; portbench.harness.work.topk_bound_s) over the device time
of the kernels named topk_sim*, in percent."""
from portbench.harness import work


def read(run):
    calls = run.trace_work.get("route")
    t = run.trace.kernel_seconds("topk_sim") if run.trace else 0.0
    if not calls or t <= 0:
        return None
    g = run.trace_work["gateway"][0]
    return 100.0 * sum(work.topk_bound_s(q, g["tools"], g["dim"], g["k"]) for q in calls) / t

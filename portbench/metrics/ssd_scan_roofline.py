"""Sum of the ssd_scan calls' bounds (one a hybrid layer a prefill,
portbench.harness.work.ssd_bound_s) over the device time of the kernels
named ssd_scan*, in percent."""
from portbench.harness import work


def read(run):
    lengths = run.trace_work.get("prefill")
    t = run.trace.kernel_seconds("ssd_scan") if run.trace else 0.0
    if not lengths or t <= 0 or not run.model.get("hybrid"):
        return None
    bound = run.model["n_layers"] * sum(work.ssd_bound_s(run.model, s) for s in lengths)
    return 100.0 * bound / t

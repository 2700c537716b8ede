"""Sum of the flash-attention launches' bounds (one a layer a prefill,
portbench.harness.work.flash_bound_s) over the device time of the kernels
named flash_attention*, in percent."""
from portbench.harness import work


def read(run):
    lengths = run.trace_work.get("prefill")
    t = run.trace.kernel_seconds("flash_attention") if run.trace else 0.0
    if not lengths or t <= 0:
        return None
    bound = run.model["n_layers"] * sum(work.flash_bound_s(run.model, s) for s in lengths)
    return 100.0 * bound / t

"""Online refinement control plane (paper §7.2 as a running subsystem).

Closes the outcome -> refine -> validate -> swap loop against the live
router, with no changes to the serving path:

  * `OutcomeStore` — bounded, thread-safe event store routers drain into;
    builds the dense masks Alg. 1 consumes; persists via repro_torch.checkpoint.
  * `RefinementController` — step-driven (or daemon-thread) loop:
    trigger -> density gate -> refine_with_gate -> atomic swap.
  * `TableGuard` — post-swap shadow monitoring on labelled traffic;
    auto-rolls-back a regressing table through the ToolsDatabase version
    history.

Counterpart of `repro.control`: the store and the guard are copies with
only their imports changed; the controller runs `refine_with_gate` on its
device. The learning plane that consumes the store's window in the JAX
package (`repro.learn`) is not ported yet.
"""
from repro_torch.control.controller import (
    ControllerConfig,
    ControllerReport,
    RefinementController,
)
from repro_torch.control.guard import GuardConfig, GuardReport, TableGuard
from repro_torch.control.outcome_store import OutcomeStore, RefinementBatch

__all__ = [
    "ControllerConfig",
    "ControllerReport",
    "RefinementController",
    "GuardConfig",
    "GuardReport",
    "TableGuard",
    "OutcomeStore",
    "RefinementBatch",
]

"""ArtifactRegistry: versioned store of trained stage artifacts.

Counterpart of `repro/learn/registry.py`, a copy with only its imports
changed: it persists through the port's `checkpoint`, whose codec writes
the bytes `msgpack` writes, so a registry saved by either package restores
in the other.

Every trained stage (adapter head, re-ranker MLP + featurizer) becomes a
`StageArtifact` keyed by (stage, version) and stamped with the table version
it was trained against and a fingerprint of the outcome window it was
trained from — so a live `StageSet` is always attributable to a specific
training run, and a demotion can name exactly what it demoted.

Semantics mirror `ToolsDatabase`: versions are per-stage monotone, history
is bounded (`history_limit`, oldest evicted first), `rollback` drops the
condemned head version and re-exposes the previous artifact as `latest`.
Persistence round-trips through `repro_torch.checkpoint` (msgpack + compression),
the same substrate the outcome window uses, so the learning plane survives
controller restarts with its deployment lineage intact.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.obs import clock

__all__ = ["StageArtifact", "ArtifactRegistry"]


@dataclasses.dataclass(frozen=True)
class StageArtifact:
    stage: str  # "adapter" | "rerank"
    version: int  # per-stage monotone registry version
    table_version: int  # ToolsDatabase version the training set was built on
    fingerprint: str  # OutcomeStore.window_fingerprint() of the train window
    params: dict  # model params (pytree of arrays)
    aux: dict  # stage extras (e.g. featurizer state), pytree of arrays
    metrics: Dict[str, float]  # held-out gate numbers recorded at training
    created_at: float = 0.0


class ArtifactRegistry:
    """Thread-safe bounded per-stage artifact history with rollback."""

    def __init__(self, history_limit: int = 4):
        assert history_limit >= 1
        self.history_limit = int(history_limit)
        # per stage: {version -> artifact}, oldest first, newest == latest
        self._artifacts: Dict[str, "OrderedDict[int, StageArtifact]"] = {}
        self._next_version: Dict[str, int] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------ registering
    def register(
        self,
        stage: str,
        params: dict,
        *,
        table_version: int,
        fingerprint: str,
        metrics: Optional[Dict[str, float]] = None,
        aux: Optional[dict] = None,
    ) -> StageArtifact:
        """Record a trained artifact; returns it with its assigned version."""
        with self._lock:
            version = self._next_version.get(stage, 1)
            self._next_version[stage] = version + 1
            artifact = StageArtifact(
                stage=stage,
                version=version,
                table_version=int(table_version),
                fingerprint=str(fingerprint),
                params=params,
                aux=dict(aux or {}),
                metrics={k: float(v) for k, v in (metrics or {}).items()},
                created_at=clock.wall(),
            )
            history = self._artifacts.setdefault(stage, OrderedDict())
            history[version] = artifact
            while len(history) > self.history_limit:
                history.popitem(last=False)
            return artifact

    # ---------------------------------------------------------------- reading
    def stages(self) -> List[str]:
        with self._lock:
            return sorted(self._artifacts)

    def versions(self, stage: str) -> List[int]:
        """Retained versions for a stage, oldest first."""
        with self._lock:
            return list(self._artifacts.get(stage, ()))

    def latest(self, stage: str) -> Optional[StageArtifact]:
        with self._lock:
            history = self._artifacts.get(stage)
            if not history:
                return None
            return history[next(reversed(history))]

    def get(self, stage: str, version: int) -> StageArtifact:
        with self._lock:
            history = self._artifacts.get(stage, OrderedDict())
            if version not in history:
                raise KeyError(
                    f"{stage} artifact v{version} not retained "
                    f"(available: {list(history)})"
                )
            return history[version]

    def discard(self, stage: str, version: int) -> None:
        """Drop one retained artifact (idempotent).

        Used when an activation loses its compare-and-swap race: the
        registered artifact was never deployed, so it must not linger as
        `latest` and shadow the artifact that actually serves."""
        with self._lock:
            self._artifacts.get(stage, OrderedDict()).pop(version, None)

    # --------------------------------------------------------------- rollback
    def rollback(self, stage: str, to_version: Optional[int] = None) -> StageArtifact:
        """Drop artifacts newer than `to_version` (default: drop only the
        newest) and return the artifact that is now `latest` — the registry
        side of a StageGuard demotion, so a re-promotion can never resurrect
        the condemned head version as "latest"."""
        with self._lock:
            history = self._artifacts.get(stage)
            if not history or len(history) < 2 and to_version is None:
                raise RuntimeError(f"no previous {stage} artifact to roll back to")
            if to_version is None:
                newest = next(reversed(history))
                versions = list(history)
                to_version = versions[versions.index(newest) - 1]
            if to_version not in history:
                raise RuntimeError(
                    f"{stage} artifact v{to_version} not retained "
                    f"(available: {list(history)})"
                )
            for v in [v for v in history if v > to_version]:
                del history[v]
            return history[to_version]

    # ------------------------------------------------------------ persistence
    def save(self, directory: str, step: int = 0) -> str:
        """Persist all retained artifacts via repro_torch.checkpoint."""
        with self._lock:
            tree: dict = {}
            meta: dict = {
                "kind": "artifact_registry",
                "history_limit": self.history_limit,
                "next_version": dict(self._next_version),
                "entries": [],
            }
            for stage, history in self._artifacts.items():
                for version, art in history.items():
                    key = f"{stage}/{version}"
                    tree[key] = {"params": art.params, "aux": art.aux}
                    meta["entries"].append({
                        "stage": stage,
                        "version": version,
                        "table_version": art.table_version,
                        "fingerprint": art.fingerprint,
                        "metrics": art.metrics,
                        "created_at": art.created_at,
                    })
        return save_checkpoint(directory, step, tree, meta)

    @classmethod
    def restore(cls, directory: str, step: Optional[int] = None) -> "ArtifactRegistry":
        _, tree, meta = restore_checkpoint(directory, step)
        assert meta.get("kind") == "artifact_registry", (
            f"not an artifact registry: {meta}"
        )
        reg = cls(history_limit=int(meta["history_limit"]))
        for entry in meta["entries"]:
            stage, version = entry["stage"], int(entry["version"])
            blob = tree[f"{stage}/{version}"]
            art = StageArtifact(
                stage=stage,
                version=version,
                table_version=int(entry["table_version"]),
                fingerprint=entry["fingerprint"],
                params=blob["params"],
                aux=blob.get("aux", {}),
                metrics={k: float(v) for k, v in entry["metrics"].items()},
                created_at=float(entry["created_at"]),
            )
            reg._artifacts.setdefault(stage, OrderedDict())[version] = art
        for stage, history in reg._artifacts.items():
            # preserve version order (entries may round-trip out of order)
            reg._artifacts[stage] = OrderedDict(sorted(history.items()))
        reg._next_version = {k: int(v) for k, v in meta["next_version"].items()}
        return reg

"""The port stands alone: no module of `repro_torch` imports JAX or `repro`
(nor `msgpack` or `zstandard`, which the card's machine lacks), and its
entry points run on the card unless the caller asks for the CPU."""
import os
import pkgutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.embedding.bag_encoder import BagEncoder
from repro_torch.configs import get_config
from repro_torch.control import OutcomeStore, RefinementController
from repro_torch.core.adapter import train_adapter
from repro_torch.core.evaluate import BenchmarkEvaluator
from repro_torch.core.pipeline import OATSPipeline, PipelineConfig
from repro_torch.core.reranker import train_reranker
from repro_torch.index import DenseBackend, FusedBackend, ToolIndexManager
from repro_torch.launch.train import main as train_main
from repro_torch.models import model as M
from repro_torch.models.config import reduced
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.scheduler import ContinuousBatcher
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase
from repro_torch.training.trainer import Trainer, TrainerConfig

SRC = Path(repro_torch.__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch.")
    )


def test_every_port_module_imports_without_jax_or_repro():
    modules = _port_modules()
    assert {"repro_torch.router.gateway", "repro_torch.kernels.topk_sim.kernel",
            "repro_torch.convert", "repro_torch.data.benchmarks",
            "repro_torch.models.model", "repro_torch.router.scheduler",
            "repro_torch.kernels.flash_attention.kernel",
            "repro_torch.kernels.ssd_scan.kernel",
            "repro_torch.metrics.retrieval", "repro_torch.core.outcomes",
            "repro_torch.core.refine", "repro_torch.optim", "repro_torch.optim.base",
            "repro_torch.optim.adamw", "repro_torch.core.adapter",
            "repro_torch.core.reranker", "repro_torch.core.deployment",
            "repro_torch.core.baselines", "repro_torch.core.pipeline",
            "repro_torch.core.evaluate", "repro_torch.cache.route_cache",
            "repro_torch.checkpoint.msgpack_ckpt", "repro_torch.control.outcome_store",
            "repro_torch.control.guard", "repro_torch.control.controller",
            "repro_torch.obs.summary", "repro_torch.obs.events", "repro_torch.obs.trace",
            "repro_torch.obs.quality", "repro_torch.obs.timeseries", "repro_torch.obs.health",
            "repro_torch.router.latency", "repro_torch.traffic.generator",
            "repro_torch.traffic.harness", "repro_torch.scenarios",
            "repro_torch.optim.adafactor", "repro_torch.optim.sgd",
            "repro_torch.optim.schedules", "repro_torch.data.lm_data",
            "repro_torch.training", "repro_torch.training.train_step",
            "repro_torch.training.trainer", "repro_torch.launch.train",
            "repro_torch.analysis", "repro_torch.analysis.retrace",
            "repro_torch.analysis.lockgraph", "repro_torch.common.meshctx",
            "repro_torch.common.sharding", "repro_torch.models.moe_shard_map",
            "repro_torch.models.decode_shard_map", "repro_torch.launch.mesh",
            "repro_torch.launch.specs", "repro_torch.launch.state_specs",
            "repro_torch.launch.hbm_model", "repro_torch.launch.hlo_analysis",
            "repro_torch.launch.dryrun", "repro_torch.models.params",
            "repro_torch.models.quant"} <= set(modules)
    blocked = ("jax", "repro", "msgpack", "zstandard")
    code = (
        "import importlib, sys, tempfile\n"
        f"for name in {blocked!r}:\n"
        "    sys.modules[name] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        f"                and m.split('.')[0] in {blocked!r})\n"
        "assert not leaked, leaked\n"
        # the outcome window persists without msgpack or zstandard
        "import numpy as np\n"
        "from repro_torch.control import OutcomeStore\n"
        "from repro_torch.router.gateway import OutcomeEvent\n"
        "store = OutcomeStore(n_tools=3, capacity=2)\n"
        "for i in range(3):\n"
        "    store.append(OutcomeEvent(np.arange(i + 1), i, i % 2, float(i)))\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    store.save(d, step=1)\n"
        "    back = OutcomeStore.restore(d)\n"
        "assert back.window_fingerprint() == store.window_fingerprint()\n"
        "assert [e.query_tokens.tolist() for e in back.snapshot_events()] == [[0, 1], [0, 1, 2]]\n"
        "print('imported', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_nothing_of_jax_or_repro():
    script = SRC.parent / "chip_smoke.py"
    text = script.read_text()
    for banned in ("import jax", "from jax", "import repro\n", "from repro.", "from repro "):
        assert banned not in text, banned


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")


def test_entry_points_default_to_the_card(no_cuda):
    vocab = SimpleNamespace(word_vecs=np.ones((5, 384), np.float32))
    bench = SimpleNamespace(vocab=vocab)
    table = np.eye(4, 384, dtype=np.float32)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.zeros(1, np.int64), 0) for i in range(4)],
                       table)
    for build in (
        lambda: SemanticRouter(db, embed_fn=lambda t: table[0]),
        lambda: ToolIndexManager(db),
        lambda: DenseBackend(table, 0),
        lambda: FusedBackend(table, 0),
        lambda: BagEncoder(vocab),
        lambda: M.init(reduced(get_config("hymba-1.5b")), torch.Generator()),
        lambda: ContinuousBatcher(reduced(get_config("hymba-1.5b")), {}),
        lambda: OATSPipeline.fit(bench, PipelineConfig()),
        lambda: BenchmarkEvaluator(bench),
        lambda: train_reranker(np.zeros((4, 7), np.float32), np.zeros(4, np.float32)),
        lambda: train_adapter(table, table, (np.zeros(0, np.int64),) * 3, table,
                              np.eye(4, dtype=np.float32)),
        lambda: RefinementController(db, OutcomeStore(n_tools=4), lambda t: table[:len(t)]),
        lambda: Trainer(reduced(get_config("hymba-1.5b")), TrainerConfig()),
        lambda: train_main(["--arch", "hymba-1.5b", "--smoke", "--steps", "1"]),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # asking for the CPU explicitly works
    router = SemanticRouter(db, embed_fn=lambda t: table[0], device="cpu", metrics=False)
    assert router.device == torch.device("cpu")
    assert router.route(np.zeros(1, np.int64)).tools[0] == 0


def test_learning_and_ivf_entry_points_default_to_the_card(no_cuda):
    from repro_torch.index import IVFBackend
    from repro_torch.learn import AdapterTrainer, RerankerTrainer, TrainedStage, stage_ndcg
    from repro_torch.router.stages import StageSet

    table = np.eye(8, 384, dtype=np.float32)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.zeros(1, np.int64), 0) for i in range(8)],
                       table)
    trained = TrainedStage("adapter", {"w1": np.zeros((384, 256), np.float32)}, {}, {})
    for build in (
        lambda: IVFBackend(table, 0),
        lambda: ToolIndexManager(db, backend="ivf"),
        lambda: AdapterTrainer(),
        lambda: RerankerTrainer(),
        lambda: trained.apply_to(StageSet()),
        lambda: stage_ndcg(table, table[:2], [np.zeros(1, np.int64)] * 2,
                           np.eye(2, 8, dtype=np.float32), StageSet()),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # on the CPU when asked
    assert IVFBackend(table, 0, device="cpu").topk(table[:2], 3)[1][:, 0].tolist() == [0, 1]

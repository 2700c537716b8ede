"""The port stands alone: no module of `repro_torch` imports JAX or `repro`,
and its entry points run on the card unless the caller asks for the CPU."""
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
from repro_torch.index import DenseBackend, FusedBackend, ToolIndexManager
from repro_torch.router.gateway import SemanticRouter
from repro_torch.router.tooldb import ToolRecord, ToolsDatabase

SRC = Path(repro_torch.__file__).resolve().parents[1]


def _port_modules():
    return sorted(
        m.name
        for m in pkgutil.walk_packages(repro_torch.__path__, prefix="repro_torch.")
    )


def test_every_port_module_imports_without_jax_or_repro():
    modules = _port_modules()
    assert {"repro_torch.router.gateway", "repro_torch.kernels.topk_sim.kernel",
            "repro_torch.convert", "repro_torch.data.benchmarks"} <= set(modules)
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if sys.modules[m] is not None\n"
        "                and (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.'))))\n"
        "assert not leaked, leaked\n"
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
    table = np.eye(4, 384, dtype=np.float32)
    db = ToolsDatabase([ToolRecord(i, f"t{i}", np.zeros(1, np.int64), 0) for i in range(4)],
                       table)
    for build in (
        lambda: SemanticRouter(db, embed_fn=lambda t: table[0]),
        lambda: ToolIndexManager(db),
        lambda: DenseBackend(table, 0),
        lambda: FusedBackend(table, 0),
        lambda: BagEncoder(vocab),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    # asking for the CPU explicitly works
    router = SemanticRouter(db, embed_fn=lambda t: table[0], device="cpu", metrics=False)
    assert router.device == torch.device("cpu")
    assert router.route(np.zeros(1, np.int64)).tools[0] == 0

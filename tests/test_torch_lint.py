"""The port's AST lint (`repro_torch.analysis`) against the JAX package's
(`repro.analysis`): both engines run on the same files, and their findings
are compared by rule, file, line and column, and by message once
`repro_torch.` reads `repro.`.

(a) every true-positive and true-negative fixture of `tests/test_analysis.py`,
with its sources and relpaths: the findings are equal, for the fixture's
rule and for all rules; (b) the repo under the checked-in baseline; (c) the
plumbing: noqa, baseline matching and stale entries, parse errors, the CLI
(`--list-rules`, an unknown `--rule`, `--write-baseline` byte for byte);
(d) the torch patterns, where the reference finds nothing and the port
finds each planted site; (e) two packages' `kernels/topk_x/` that the
reference keys to one; (f) the CLI over `src` with `jax` and `repro`
blocked."""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

from repro.analysis import engine as ref_engine
from repro.analysis import findings as ref_findings
from repro.analysis.__main__ import main as ref_main
from repro_torch.analysis import engine, findings
from repro_torch.analysis.__main__ import main
from repro_torch.analysis.rules import REGISTRY

REPO = Path(__file__).resolve().parent.parent


def _key(f, port: bool):
    message = f.message.replace("repro_torch.", "repro.") if port else f.message
    return (f.rule, f.file, f.line, f.col, message)


def _keys(fs, port: bool):
    return [_key(f, port) for f in fs]


def _both(paths, **kwargs):
    """(reference result, port result) of `run` on the same paths."""
    return ref_engine.run(paths, **kwargs), engine.run(paths, **kwargs)


def _assert_same(ref, got):
    for part in ("active", "suppressed", "baselined"):
        assert _keys(got[part], True) == _keys(ref[part], False), part
    assert got["stale_baseline"] == ref["stale_baseline"]
    assert got["errors"] == ref["errors"]


def _write(root: Path, files: dict) -> None:
    for rel, text in files.items():
        f = root / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(text)


# ------------------------------------------------- (a) the reference's fixtures

# (id, rule, relpath, source, flags): tests/test_analysis.py's one-file
# fixtures, the same sources at the same relpaths; `flags` says whether the
# fixture is a true positive there
_FILE_CASES = [
    ("mesh-api-raw", "mesh-api", "mod.py",
     "import jax\n"
     "from jax.sharding import use_mesh\n"
     "def f(m):\n"
     "    jax.set_mesh(m)\n"
     "    return jax.sharding.get_abstract_mesh()\n", True),
    ("mesh-api-meshctx", "mesh-api", "common/meshctx.py",
     "import jax\n\ndef g(m):\n    jax.set_mesh(m)\n", False),
    ("mesh-api-mesh-type", "mesh-api", "mod.py",
     "import jax\n\ndef h(m: 'jax.sharding.Mesh'):\n    return m\n", False),
    ("cas-bare", "cas-discipline", "mod.py",
     "def f(db, router, t, s):\n"
     "    db.swap_table(t)\n"
     "    db.rollback()\n"
     "    router.set_stages(s)\n"
     "    router.rollback_stages()\n", True),
    ("cas-expected", "cas-discipline", "mod.py",
     "def f(db, router, registry, t, s, v):\n"
     "    db.swap_table(t, expect_current=v)\n"
     "    db.rollback(v, v)\n"
     "    router.set_stages(s, expect_version=v)\n"
     "    router.rollback_stages(expect_current=v)\n"
     "    registry.rollback('adapter', to_version=v)\n", False),
    ("snapshot-foreign", "snapshot-discipline", "mod.py",
     "def f(db):\n    return db._table, db._history\n", True),
    ("snapshot-self", "snapshot-discipline", "mod.py",
     "class T:\n    def g(self):\n        return self._table\n", False),
    ("snapshot-owner", "snapshot-discipline", "router/tooldb.py",
     "def f(db):\n    return db._table\n", False),
    ("jit-in-function", "jit-in-function", "mod.py",
     "import jax\n"
     "def train():\n"
     "    g = jax.jit(lambda x: x)\n"
     "    @jax.jit\n"
     "    def step(p):\n"
     "        return p\n"
     "    return g, step\n", True),
    ("jit-module-scope", "jit-in-function", "mod.py",
     "import functools, jax\n"
     "@functools.partial(jax.jit, static_argnames=('k',))\n"
     "def f(x, k: int):\n"
     "    return x\n"
     "g = jax.jit(f)\n", False),
    ("jit-static-traced", "jit-static-scalar", "mod.py",
     "import jax\n@jax.jit\ndef f(x, k: int):\n    return x\n", True),
    ("jit-static-argnames", "jit-static-scalar", "mod.py",
     "import functools, jax\n"
     "@functools.partial(jax.jit, static_argnames=('k', 'mode'))\n"
     "def f(x, k: int, mode: str):\n"
     "    return x\n", False),
    ("jit-static-assignment", "jit-static-scalar", "mod.py",
     "import jax\n"
     "def f(x, k: int):\n"
     "    return x\n"
     "g = jax.jit(f)\n"
     "h = jax.jit(f, static_argnames=('k',))\n", True),
    ("pow2-manual", "pow2-bucket", "mod.py",
     "def pad(n):\n    return (1 << max(n - 1, 0).bit_length()) - n\n", True),
    ("pow2-bucketing", "pow2-bucket", "common/bucketing.py",
     "def pad(n):\n    return (1 << max(n - 1, 0).bit_length()) - n\n", False),
    ("lock-dispatch-under-lock", "lock-dispatch", "router/mod.py",
     "import jax.numpy as jnp\n"
     "from repro.core.retrieval import topk_dense\n"
     "class S:\n"
     "    def f(self, q, t):\n"
     "        with self._lock:\n"
     "            a = jnp.asarray(q)\n"
     "            return topk_dense(a, t, 5)\n", True),
    ("lock-dispatch-nested-def", "lock-dispatch", "index/mod.py",
     "import jax.numpy as jnp\n"
     "class S:\n"
     "    def f(self, q):\n"
     "        with self._lock:\n"
     "            def later():\n"
     "                return jnp.asarray(q)\n"
     "            return later\n"
     "    def g(self, q):\n"
     "        a = jnp.asarray(q)\n"
     "        with self._lock:\n"
     "            self.out = a\n", False),
    ("lock-dispatch-outside-packages", "lock-dispatch", "tools/mod.py",
     "import jax.numpy as jnp\n"
     "def f(lock, q):\n"
     "    with lock:\n"
     "        return jnp.asarray(q)\n", False),
    ("cache-unstamped", "cache-version-stamp", "mod.py",
     "def serve(cache, q, tools, scores, tv, sv):\n"
     "    hit = cache.lookup_batch(q, table_version=tv)\n"
     "    cache.insert_batch(q, tools, scores)\n"
     "    return hit\n", True),
    ("cache-stamped", "cache-version-stamp", "mod.py",
     "def serve(route_cache, q, tools, scores, tv, sv):\n"
     "    hit = route_cache.lookup_batch(q, table_version=tv, stage_version=sv)\n"
     "    route_cache.insert_batch(q, tools, scores, table_version=tv,\n"
     "                             stage_version=sv)\n"
     "    return hit\n", False),
    ("cache-noncache-receiver", "cache-version-stamp", "mod.py",
     "def f(store, q):\n    return store.lookup_batch(q)\n", False),
    ("cache-lock-dispatch", "cache-version-stamp", "cache/mod.py",
     "import jax.numpy as jnp\n"
     "class C:\n"
     "    def lookup(self, q):\n"
     "        with self._lock:\n"
     "            return jnp.asarray(q)\n", True),
    ("cache-lock-dispatch-elsewhere", "cache-version-stamp", "tools/mod.py",
     "import jax.numpy as jnp\n"
     "class C:\n"
     "    def lookup(self, q):\n"
     "        with self._lock:\n"
     "            return jnp.asarray(q)\n", False),
    *[(f"obs-raw-{pkg}", "obs-discipline", f"{pkg}/mod.py",
       "import time\n"
       "def serve(q):\n"
       "    t0 = time.perf_counter()\n"
       "    print('served', q)\n"
       "    return time.time() - t0\n"
       "def wait():\n"
       "    return time.monotonic()\n", True)
      for pkg in ("router", "index", "control", "learn")],
    *[(f"obs-clock-{pkg}", "obs-discipline", f"{pkg}/mod.py",
       "import time\n"
       "from repro.obs import clock\n"
       "def serve(q):\n"
       "    t0 = clock.perf()\n"
       "    time.sleep(0.01)\n"
       "    return clock.duration_ms(t0)\n", False)
      for pkg in ("router", "control")],
    *[(f"obs-outside-{rel.split('/')[0]}", "obs-discipline", rel,
       "import time\n"
       "def bench():\n"
       "    print(time.perf_counter())\n", False)
      for rel in ("launch/mod.py", "obs/clock.py")],
    ("thread-silent", "thread-discipline", "mod.py",
     "import threading\n"
     "class C:\n"
     "    def start(self):\n"
     "        def loop():\n"
     "            while True:\n"
     "                self.step()\n"
     "        self._t = threading.Thread(target=loop, daemon=True)\n", True),
    ("thread-swallowing", "thread-discipline", "mod.py",
     "import threading\n"
     "class C:\n"
     "    def start(self):\n"
     "        def loop():\n"
     "            while True:\n"
     "                try:\n"
     "                    self.step()\n"
     "                except Exception:\n"
     "                    pass\n"
     "        self._t = threading.Thread(target=loop, daemon=True)\n", True),
    ("thread-recording", "thread-discipline", "mod.py",
     "import threading\n"
     "class C:\n"
     "    def start(self):\n"
     "        def loop():\n"
     "            while True:\n"
     "                try:\n"
     "                    self.step()\n"
     "                    self.last_loop_error = None\n"
     "                except Exception as exc:\n"
     "                    self.last_loop_error = exc\n"
     "        self._t = threading.Thread(target=loop, daemon=True)\n", False),
]


@pytest.mark.parametrize("case", _FILE_CASES, ids=[c[0] for c in _FILE_CASES])
def test_reference_fixture_findings_equal(tmp_path, case):
    _, rule, rel, source, flags = case
    _write(tmp_path, {rel: source})
    path = str(tmp_path / rel)
    ref, got = _both([path], tests_dir=None, rules=[rule])
    _assert_same(ref, got)
    assert bool(ref["active"]) == flags
    _assert_same(*_both([path], tests_dir=None))  # every rule at once


# (id, files, scanned dir, tests files or None, flags): the kernel-contract
# fixtures, each state the reference's tests put the tree in
_KERNEL_CASES = [
    ("kernel-bare", {"kernels/mykern/kernel.py": "def run():\n    return 0\n"},
     {"test_nothing.py": "def test_x():\n    pass\n"}, True),
    ("kernel-ref-and-test", {"kernels/mykern/kernel.py": "def run():\n    return 0\n",
                             "kernels/mykern/ref.py": "def run_ref():\n    return 0\n"},
     {"test_nothing.py": "def test_x():\n    pass\n",
      "test_mykern.py": "from x.kernels.mykern.kernel import run\n"}, False),
    ("kernel-topk-sentinel", {"kernels/topk_fancy/kernel.py":
                              "NEG = -1e30\ndef run():\n    return NEG\n",
                              "kernels/topk_fancy/ref.py": "def run_ref():\n    return 0\n"},
     None, True),
    ("kernel-topk-neg-inf", {"kernels/topk_fancy/kernel.py":
                             "from repro.core.retrieval import NEG_INF\nNEG = NEG_INF\n"
                             "def run():\n    return NEG\n",
                             "kernels/topk_fancy/ref.py": "def run_ref():\n    return 0\n"},
     None, False),
]


@pytest.mark.parametrize("case", _KERNEL_CASES, ids=[c[0] for c in _KERNEL_CASES])
def test_reference_kernel_fixture_findings_equal(tmp_path, case):
    _, files, tests, flags = case
    _write(tmp_path, files)
    tests_dir = None
    if tests is not None:
        _write(tmp_path / "tests", tests)
        tests_dir = str(tmp_path / "tests")
    ref, got = _both([str(tmp_path / "kernels")], tests_dir=tests_dir,
                     rules=["kernel-contract"])
    _assert_same(ref, got)
    assert bool(ref["active"]) == flags


def test_real_controllers_findings_equal():
    paths = [str(REPO / f"src/{pkg}/{plane}/controller.py")
             for pkg in ("repro", "repro_torch") for plane in ("control", "learn")]
    ref, got = _both(paths, tests_dir=None, rules=["thread-discipline"])
    _assert_same(ref, got)
    assert got["active"] == []


# ----------------------------------------------------------------- (b) the repo


def test_repo_findings_equal_under_checked_in_baseline(monkeypatch):
    monkeypatch.chdir(REPO)
    ref = ref_engine.run(["src"], tests_dir="tests",
                         baseline=ref_findings.Baseline.load("analysis_baseline.json"))
    got = engine.run(["src"], tests_dir="tests",
                     baseline=findings.Baseline.load("analysis_baseline.json"))
    assert ref["active"] == [] and got["active"] == []
    assert _keys(got["baselined"], True) == _keys(ref["baselined"], False)
    assert {f.rule for f in got["baselined"]} == {"jit-in-function"}
    assert len(got["baselined"]) == 8
    assert got["stale_baseline"] == ref["stale_baseline"] == []
    assert got["errors"] == ref["errors"] == []
    # the port's suppressed findings are the reference's plus mesh-api sites
    extra = list(_keys(got["suppressed"], True))
    for k in _keys(ref["suppressed"], False):
        extra.remove(k)
    assert all(rule == "mesh-api" for rule, *_ in extra), extra


def test_other_trees_findings_equal(monkeypatch):
    """The tests, examples, benchmarks and scripts: no kernels/ or serving
    package there, so every rule agrees, the port's patterns included."""
    monkeypatch.chdir(REPO)
    _assert_same(*_both(["tests", "examples", "benchmarks", "scripts"], tests_dir=None))


# ----------------------------------------------------------- (c) the plumbing


def test_noqa_parsing_equal():
    lines = [
        "x = 1",
        "db.swap_table(t)  # repro: noqa[cas-discipline]",
        "y = 2  # repro: noqa",
        "z = 3  # repro: noqa[a-rule, b-rule]",
        "w = 4  # repro:noqa[mesh-api]",
    ]
    got = findings.noqa_rules_by_line(lines)
    assert got == ref_findings.noqa_rules_by_line(lines)
    assert got == {2: {"cas-discipline"}, 3: None, 4: {"a-rule", "b-rule"}, 5: {"mesh-api"}}


def test_noqa_suppresses_the_same_findings(tmp_path):
    _write(tmp_path, {"mod.py": "def f(db, t):\n"
                                "    db.swap_table(t)  # repro: noqa[cas-discipline]\n"
                                "    db.rollback()  # repro: noqa[some-other-rule]\n"
                                "    db.set_stages(t)  # repro: noqa\n"})
    ref, got = _both([str(tmp_path / "mod.py")], tests_dir=None)
    _assert_same(ref, got)
    assert len(got["suppressed"]) == 2 and len(got["active"]) == 1
    assert engine.exit_code(got) == ref_engine.exit_code(ref) == 1


def test_baseline_content_matching_and_stale_entries(tmp_path):
    f = tmp_path / "mod.py"
    f.write_text("def f(db, t):\n    db.swap_table(t)\n")
    (finding,) = engine.run([str(f)], tests_dir=None, rules=["cas-discipline"])["active"]
    entries = [findings.Baseline.entry_for(finding, "db.swap_table(t)", "test entry"),
               {"rule": "cas-discipline", "file": "gone.py", "content": "db.swap_table(t)",
                "justification": "obsolete"}]
    f.write_text("import os\n\n" + f.read_text())  # the flagged line moves down
    ref = ref_engine.run([str(f)], tests_dir=None, baseline=ref_findings.Baseline(entries))
    got = engine.run([str(f)], tests_dir=None, baseline=findings.Baseline(entries))
    _assert_same(ref, got)
    assert got["active"] == [] and len(got["baselined"]) == 1
    assert got["stale_baseline"] == [entries[1]]


def test_parse_errors_equal(tmp_path):
    _write(tmp_path, {"broken.py": "def f(:\n", "ok.py": "x = 1\n"})
    ref, got = _both([str(tmp_path)], tests_dir=None)
    _assert_same(ref, got)
    assert len(got["errors"]) == 1 and engine.exit_code(got) == 1


def _cli(fn, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = fn(argv)
    return rc, out.getvalue()


def test_cli_list_rules_and_unknown_rule():
    rc, text = _cli(main, ["--list-rules"])
    ref_rc, ref_text = _cli(ref_main, ["--list-rules"])
    ids = [line.split(" ", 1)[0] for line in text.splitlines()]
    assert rc == ref_rc == 0
    assert ids == [line.split(" ", 1)[0] for line in ref_text.splitlines()]
    assert ids == sorted(REGISTRY) and len(ids) == 11
    assert main(["--rule", "no-such-rule"]) == ref_main(["--rule", "no-such-rule"]) == 2


def test_cli_write_baseline_byte_for_byte(tmp_path, monkeypatch):
    _write(tmp_path, {"mod.py": "def f(db, t):\n    db.swap_table(t)\n    db.rollback()\n",
                      "router/mod.py": "import time\ndef g():\n    return time.time()\n"})
    monkeypatch.chdir(tmp_path)
    written = {}
    for name, fn in (("ref", ref_main), ("port", main)):
        bl = tmp_path / f"{name}.json"
        assert _cli(fn, ["mod.py", "router", "--tests-dir", "", "--no-baseline"])[0] == 1
        argv = ["mod.py", "router", "--tests-dir", "", "--baseline", str(bl)]
        assert _cli(fn, argv + ["--write-baseline"])[0] == 0
        written[name] = bl.read_bytes()
        assert _cli(fn, argv)[0] == 0  # clean under what it wrote
    assert written["port"] == written["ref"]
    assert len(json.loads(written["port"])["entries"]) == 3


def test_cli_json_output_equal(tmp_path, monkeypatch):
    _write(tmp_path, {"mod.py": "def f(db, t):\n    db.swap_table(t)\n"})
    monkeypatch.chdir(tmp_path)
    rc, text = _cli(main, ["mod.py", "--tests-dir", "", "--json"])
    ref_rc, ref_text = _cli(ref_main, ["mod.py", "--tests-dir", "", "--json"])
    assert rc == ref_rc == 1
    assert json.loads(text) == json.loads(ref_text)


# ----------------------------------------------------------- (d) torch patterns

_MESH_PRIVATE = (
    "import torch\n"
    "import torch.distributed as dist\n"
    "import torch.distributed._functional_collectives as funcol\n"
    "from torch.distributed.tensor import DTensor, _redistribute\n"
    "from torch.distributed.tensor._ops import _view_ops\n"
    "from torch.distributed.tensor.placement_types import _StridedShard\n"
    "def f(x):\n"
    "    dist._coalescing_manager(x)\n"
    "    torch.distributed.tensor._ops.foo\n"
    "    DTensor._op_dispatcher.sharding_propagator\n"
    "    torch._C._clear_DTensor_sharding_propagator_cache()\n"
    "    _redistribute._gen_transform_infos.cache_clear()\n"
    "    return _view_ops.propagate_shape_and_sharding, _StridedShard, funcol\n"
)
_MESH_PUBLIC = (
    "import torch\n"
    "import torch.distributed as dist\n"
    "from torch.distributed.tensor import DTensor, Replicate, Shard\n"
    "from torch.distributed.device_mesh import DeviceMesh\n"
    "from torch.distributed.tensor.experimental import implicit_replication\n"
    "def f(x, mesh: DeviceMesh):\n"
    "    with torch.distributed.tensor.experimental.implicit_replication():\n"
    "        y = DTensor.from_local(x, mesh, [Replicate(), Shard(0)])\n"
    "    dist.all_reduce(x, group=dist.group.WORLD)\n"
    "    return y.__class__.__name__, torch._C._get_tracing_state()\n"
)
_LOCK_DEVICE = (
    "import torch\n"
    "from repro_torch.kernels.topk_sim.kernel import topk_sim_cuda\n"
    "class S:\n"
    "    def f(self, q, t, device):\n"
    "        with self._lock:\n"
    "            a = torch.from_numpy(q).to(device)\n"
    "            b = q.cuda()\n"
    "            c = topk_sim_cuda(a, t, 5)\n"
    "            z = torch.zeros(3, device=device)\n"
    "            return a, b, c, z, t.to(device=device, non_blocking=True)\n"
)
_LOCK_HOST = (
    "import numpy as np\n"
    "import torch\n"
    "class S:\n"
    "    def f(self, q, t):\n"
    "        with self._lock:\n"
    "            a = np.asarray(q, np.float32) @ t.T\n"
    "            def later():\n"
    "                return torch.zeros(3, device='cuda').cuda()\n"
    "            b = torch.from_numpy(a).to(torch.float32)\n"
    "            return a, later, b, torch.zeros(3), b.to(dtype=torch.bfloat16)\n"
)

# (id, rule, relpath, source, the lines the port flags)
_TORCH_CASES = [
    ("mesh-api-private", "mesh-api", "launch/mod.py", _MESH_PRIVATE,
     [3, 4, 5, 6, 8, 9, 10, 11, 12]),
    ("mesh-api-private-in-meshctx", "mesh-api", "common/meshctx.py", _MESH_PRIVATE, []),
    ("mesh-api-public", "mesh-api", "launch/mod.py", _MESH_PUBLIC, []),
    ("lock-dispatch-device", "lock-dispatch", "router/mod.py", _LOCK_DEVICE,
     [6, 7, 8, 9, 10]),
    ("lock-dispatch-host", "lock-dispatch", "router/mod.py", _LOCK_HOST, []),
    ("lock-dispatch-device-outside-packages", "lock-dispatch", "tools/mod.py",
     _LOCK_DEVICE, []),
    ("cache-lock-device", "cache-version-stamp", "cache/mod.py", _LOCK_DEVICE,
     [6, 7, 8, 9, 10]),
    ("cache-lock-host", "cache-version-stamp", "cache/mod.py", _LOCK_HOST, []),
]


@pytest.mark.parametrize("case", _TORCH_CASES, ids=[c[0] for c in _TORCH_CASES])
def test_torch_patterns_port_finds_what_reference_misses(tmp_path, case):
    _, rule, rel, source, lines = case
    _write(tmp_path, {rel: source})
    ref, got = _both([str(tmp_path / rel)], tests_dir=None, rules=[rule])
    assert ref["active"] == []
    assert [f.line for f in got["active"]] == lines
    assert all(f.rule == rule for f in got["active"])
    if rule == "cache-version-stamp":
        assert all("critical section" in f.message for f in got["active"])


def test_mesh_api_noqa_silences_a_torch_site(tmp_path):
    _write(tmp_path, {"mod.py": "from torch.distributed.tensor import _redistribute"
                                "  # repro: noqa[mesh-api]\n"})
    got = engine.run([str(tmp_path / "mod.py")], tests_dir=None, rules=["mesh-api"])
    assert got["active"] == [] and len(got["suppressed"]) == 1


# ------------------------------------------------------------ (e) the shadow case


def test_kernel_contract_checks_each_package_kernel(tmp_path):
    _write(tmp_path, {
        "a/kernels/topk_x/kernel.py": "from repro.core.retrieval import NEG_INF\n"
                                      "def run():\n    return NEG_INF\n",
        "a/kernels/topk_x/ref.py": "def run_ref():\n    return 0\n",
        "b/kernels/topk_x/kernel.py": "def run():\n    return -1e30\n",
        "tests/test_topk_x.py": "from a.kernels.topk_x.kernel import run\n",
    })
    # b scanned first, so the reference's name key keeps a's kernel.py
    paths = [str(tmp_path / "b"), str(tmp_path / "a")]
    tests = str(tmp_path / "tests")
    ref, got = _both(paths, tests_dir=tests, rules=["kernel-contract"])
    assert ref["active"] == []
    faulty = str(tmp_path / "b/kernels/topk_x/kernel.py")
    assert {(f.file, f.line) for f in got["active"]} == {(faulty, 1), (faulty, 2)}
    assert sorted(f.message for f in got["active"]) == [
        "hardcoded top-K padding sentinel -1e+30 in `kernel.py`",
        "kernel `topk_x` has no ref.py oracle sibling",
    ]
    # scanned the other way round, both lints see the faulty one
    ref, got = _both(paths[::-1], tests_dir=tests, rules=["kernel-contract"])
    _assert_same(ref, got)
    assert len(got["active"]) == 2


# ------------------------------------------------------------ (f) stands alone


def test_cli_over_src_without_jax_or_repro():
    code = ("import runpy, sys\n"
            "for name in ('jax', 'repro', 'torch'):\n"
            "    sys.modules[name] = None\n"
            "sys.argv = ['python -m repro_torch.analysis', 'src']\n"
            "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == (
        "0 finding(s), 8 baselined, 0 suppressed, 0 parse error(s)")

"""The port's multi-device runtime against the JAX package's, on 2x2 meshes.

One JAX subprocess with 4 forced host devices (as `tests/test_distributed.py`
runs the reference) writes one npz holding every case's inputs and the
reference's outputs: the shard_map MoE with capacity unbound and bound,
the seq-sharded decode of four architectures, and the tool-axis
refinement. Its model trees have wq, wk, wv at a d_model fan-in
(`M.attention_at_d_model_fan_in`, as `test_torch_models.py` carries them):
the reference's init makes attention logits so large that float32
rounding differences between XLA and torch move its outputs. Then one
4-rank gloo job of the port (this file run as a script, one process a
rank, on the CPU) runs the same cases on a 2x2 ("data", "model") mesh and
holds them to the reference's own tolerances: MoE logits 1e-4, decode
logits 2e-3 and cache 1e-3, refinement 1e-5. The same job holds
`named_sharding` and `logical_constraint`, and `Trainer(mesh=)`,
data-parallel over the mesh's data axis, against the single-process
Trainer: the gradients leaf by leaf, the loss and the params after SGD
steps within 1e-4, and its checkpoint. `spec_for` and `set_policy` are
held against the JAX package's in this process.
"""
import argparse
import os
import socket
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
DECODE_ARCHS = ("musicgen-medium", "stablelm-3b", "qwen2.5-3b", "hymba-1.5b")
JAX_TIMEOUT_S = 240
RANK_TIMEOUT_S = 240

# ----------------------------------------------------------- the reference
JAX_CASES = """
import dataclasses, sys, jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.common.meshctx import make_mesh, use_mesh
from repro.common.sharding import set_policy
from repro.configs import get_config
from repro.core.refine import refine_embeddings
from repro.models.config import reduced
from repro.models import model as M
from repro_torch.models.model import attention_at_d_model_fan_in
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
def flat(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[prefix + "/".join(str(p.key) for p in path)] = np.asarray(leaf)
rng = np.random.default_rng(0)
# the MoE: capacity unbound (test_distributed.py's case) and bound
for case, cf in (("moe", 8.0), ("moe_bound", 1.0)):
    cfg = reduced(get_config("dbrx-132b"), capacity_factor=cf)
    cfg2 = dataclasses.replace(cfg, moe_impl="shard_map")
    params = attention_at_d_model_fan_in(cfg, M.init(cfg, jax.random.PRNGKey(0)))
    batch = {"tokens": jnp.asarray(rng.integers(0, cfg.vocab_size, (4, 32)), jnp.int32)}
    with use_mesh(mesh):
        l1, a1 = jax.jit(lambda p, b: M.forward(cfg, p, b))(params, batch)
        l2, a2 = jax.jit(lambda p, b: M.forward(cfg2, p, b))(params, batch)
    flat(case + ":params/", params)
    out[case + ":tokens"] = np.asarray(batch["tokens"])
    out[case + ":gspmd"], out[case + ":shard_map"] = np.asarray(l1), np.asarray(l2)
    out[case + ":aux"] = np.asarray(a2)
# the seq-sharded decode
for arch in %(archs)r:
    cfg = reduced(get_config(arch))
    cfg2 = dataclasses.replace(cfg, decode_attn="seq_shard")
    params = attention_at_d_model_fan_in(cfg, M.init(cfg, jax.random.PRNGKey(0)))
    B, S = 2, 32
    shape = (B, S, cfg.n_codebooks) if cfg.n_codebooks else (B, S)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, shape), jnp.int32)
    _, cache = M.prefill(cfg, params, {"tokens": toks[:, :S-1]}, max_cache_len=S)
    dec = {"token": toks[:, S-1:S], "pos": jnp.asarray(S-1, jnp.int32)}
    with use_mesh(mesh):
        set_policy("tp_kvs")
        l2, c2 = jax.jit(lambda p, c, b: M.decode_step(cfg2, p, c, b))(params, cache, dec)
        set_policy("tp")
    flat(arch + ":params/", params)
    out[arch + ":tokens"] = np.asarray(toks)
    out[arch + ":logits"], out[arch + ":k"] = np.asarray(l2), np.asarray(c2["k"])
# the tool-axis refinement
def unit(x): return x / np.linalg.norm(x, axis=-1, keepdims=True)
qe = jnp.asarray(unit(rng.normal(size=(64, 32))).astype(np.float32))
te = jnp.asarray(unit(rng.normal(size=(16, 32))).astype(np.float32))
rel = np.zeros((64, 16), np.float32)
rel[np.arange(64), rng.integers(0, 16, 64)] = 1.0
rel = jnp.asarray(rel)
mesh1 = make_mesh((4,), ("model",))
with use_mesh(mesh1):
    te_s = jax.device_put(te, NamedSharding(mesh1, P("model", None)))
    rel_s = jax.device_put(rel, NamedSharding(mesh1, P(None, "model")))
    refined = refine_embeddings(te_s, qe, rel_s)
out["refine:q"], out["refine:t"] = np.asarray(qe), np.asarray(te)
out["refine:rel"] = np.asarray(rel)
out["refine:out"] = np.asarray(refined)
np.savez(sys.argv[1], **out)
""" % {"archs": DECODE_ARCHS}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _env() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"  # four ranks share the CPU
    return env


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "cases.npz"
    env = _env()
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("OMP_NUM_THREADS")
    out = subprocess.run([sys.executable, "-c", JAX_CASES, str(path)], env=env,
                         capture_output=True, text=True, timeout=JAX_TIMEOUT_S)
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return path


@pytest.fixture(scope="module")
def port_run(reference, tmp_path_factory):
    """The 4-rank gloo job over the reference's npz: {rank: (rc, log)}."""
    tmp = tmp_path_factory.mktemp("port_ranks")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), "--world", "4", "--port", str(port),
         "--npz", str(reference), "--tmp", str(tmp)],
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = {}
    try:
        for r, p in enumerate(procs):
            logs[r] = (p.wait(timeout=RANK_TIMEOUT_S), p.stdout.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    return logs


CASES = ("moe", "moe_bound", *(f"decode {a}" for a in DECODE_ARCHS), "refine",
         "placements", "trainer")


@pytest.mark.slow
@pytest.mark.parametrize("case", CASES)
def test_port_on_2x2_gloo_matches_reference(port_run, case):
    """Every rank ran the case and held it to its tolerance (a rank's log
    has one `ok <case>` line a case it passed)."""
    text = "\n".join(f"--- rank {r} rc={rc}\n{log}" for r, (rc, log) in port_run.items())
    for r, (rc, log) in port_run.items():
        assert f"ok {case} " in log, f"rank {r} did not pass {case!r}:\n{text}"
    assert all(rc == 0 for rc, _ in port_run.values()), text


# -------------------------------------------------- spec_for, both packages
SPEC_CASES = [
    # (policy, logical axes, mesh axis names, shape, mesh sizes)
    ("tp", ("batch", None, "heads", None), ("pod", "data", "model"), None, None),
    ("tp", ("batch", None), ("data", "model"), None, None),
    ("tp", ("layers", "embed", "kv_heads", None), ("pod", "data", "model"),
     (32, 4096, 8, 128), {"pod": 2, "data": 16, "model": 16}),
    ("tp", ("layers", "embed", "kv_heads", None), ("pod", "data", "model"),
     (32, 4096, 32, 128), {"pod": 2, "data": 16, "model": 16}),
    ("tp", ("vocab", "embed"), ("pod", "data", "model"), (49155, 4096),
     {"pod": 2, "data": 16, "model": 16}),
    ("fsdp", ("batch", "embed"), ("pod", "data", "model"), (64, 4096),
     {"pod": 2, "data": 16, "model": 16}),
    ("tp_kvs", ("layers", "batch", "kv_seq", "kv_heads", None), ("data", "model"),
     (2, 4, 32, 8, 64), {"data": 2, "model": 2}),
    ("tp_sp", ("batch", "act_seq", None), ("data", "model"), (4, 30, 8),
     {"data": 2, "model": 4}),
    ("tp_relaxed", ("batch", "heads"), ("data", "model"), (3, 25), {"data": 2, "model": 4}),
]


def _as_tuple(spec) -> tuple:
    return tuple(tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


@pytest.mark.parametrize("policy,axes,names,shape,sizes", SPEC_CASES)
def test_spec_for_and_set_policy_match_reference(policy, axes, names, shape, sizes):
    from repro.common import sharding as jax_sharding
    from repro_torch.common import sharding

    relax = policy == "tp_relaxed"
    with jax_sharding.set_policy(policy), sharding.set_policy(policy):
        assert sharding.get_policy() == jax_sharding.get_policy() == policy
        ref = jax_sharding.spec_for(axes, names, shape, sizes, relax_uneven=relax)
        got = sharding.spec_for(axes, names, shape, sizes, relax_uneven=relax)
    assert got == _as_tuple(ref)
    assert sharding.get_policy() == jax_sharding.get_policy() == "tp"


def test_set_policy_rejects_unknown_names():
    from repro_torch.common import sharding

    with pytest.raises(KeyError):
        sharding.set_policy("no-such-policy")


def test_make_mesh_raises_without_a_process_group():
    import torch.distributed as dist

    from repro_torch.common import meshctx

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        meshctx.make_mesh((1,), ("model",), device="cpu")
    assert meshctx.current_mesh() is None


def test_block_range_cuts_as_torch_chunk():
    import torch

    from repro_torch.common.sharding import block_range

    for n in (0, 1, 5, 16, 2413):
        for parts in (1, 2, 3, 4):
            chunks = torch.arange(n).chunk(parts)
            got = [block_range(n, parts, i) for i in range(parts)]
            want = [(int(c[0]), int(c[-1]) + 1) for c in chunks if len(c)]
            assert [g for g in got if g[1] > g[0]] == want


class _Mesh:
    """A stand-in mesh of `shape` (no process group): what the sharded
    modules check before their first collective."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)

    def axis_index(self, name):
        return 0


def test_sharded_modules_refuse_what_they_cannot_split():
    """No fallback: a model axis that does not divide the experts or the
    cache slots raises, as do grad-requiring inputs to the forward-only
    expert-parallel dispatch."""
    import dataclasses

    import torch

    from repro_torch.common import meshctx
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.models.decode_shard_map import decode_cache_specs
    from repro_torch.models.moe_shard_map import moe_block_shard_map, shard_expert_params

    cfg = dataclasses.replace(reduced(get_config("dbrx-132b")), moe_impl="shard_map")
    p = {k: v[0] for k, v in M.init(cfg, torch.Generator().manual_seed(0),
                                    "cpu")["layers"]["moe"].items()}
    x = torch.zeros((1, 4, cfg.d_model))
    with meshctx.use_mesh(_Mesh(data=1, model=3)):
        with pytest.raises(ValueError, match="must divide over the model axis 3"):
            moe_block_shard_map(p, x, cfg)
    with meshctx.use_mesh(_Mesh(data=1, model=1)):
        with pytest.raises(ValueError, match="forward-only"):
            moe_block_shard_map(p, x.requires_grad_(), cfg)
    x = x.detach()
    with meshctx.use_mesh(_Mesh(data=1, model=2)):  # neither E nor E/2 experts held
        with pytest.raises(ValueError, match="expert weights hold 1 experts"):
            moe_block_shard_map({**p, "w_gate": p["w_gate"][:1]}, x, cfg)
    with pytest.raises(ValueError, match="must divide over the model axis 3"):
        shard_expert_params(cfg, {"layers": {"moe": {}}}, _Mesh(data=1, model=3))
    seq = dataclasses.replace(reduced(get_config("qwen2.5-3b")), decode_attn="seq_shard")
    cache = {"k": torch.zeros((2, 2, 33, 2, 64)), "v": torch.zeros((2, 2, 33, 2, 64))}
    with pytest.raises(ValueError, match="cache slots 33 must divide"):
        decode_cache_specs(seq, cache, _Mesh(data=1, model=2))
    assert meshctx.current_mesh() is None


def test_shard_decode_cache_copies_even_an_unsplit_block():
    """Decode writes its cache in place: a rank's block must not alias the
    full cache, also on a mesh of one rank where the block is all of it."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.config import reduced
    from repro_torch.models.decode_shard_map import shard_decode_cache

    cfg = reduced(get_config("hymba-1.5b"), decode_attn="seq_shard")
    cache = {"k": torch.zeros((2, 2, 32, 1, 64)), "state": torch.zeros((2, 2, 4, 32, 16))}
    for mesh in (_Mesh(data=1, model=1), _Mesh(data=1, model=2)):
        local = shard_decode_cache(cfg, cache, mesh)
        for name, t in local.items():
            t.fill_(1.0)
            assert float(cache[name].abs().max()) == 0.0, (mesh.shape, name)


def test_shard_expert_params_keeps_this_ranks_experts():
    """A rank's expert weights are its block of E/m along "model", copied
    where cut; every other leaf is the same tensor."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.models.moe_shard_map import EXPERT_WEIGHTS, shard_expert_params

    cfg = reduced(get_config("dbrx-132b"))
    full = M.init(cfg, torch.Generator().manual_seed(0), "cpu")
    e = cfg.n_experts
    one = shard_expert_params(cfg, full, _Mesh(data=1, model=1))
    for n in EXPERT_WEIGHTS:
        assert one["layers"]["moe"][n] is full["layers"]["moe"][n]
    mesh = _Mesh(data=1, model=2)
    mesh.axis_index = lambda name: 1
    half = shard_expert_params(cfg, full, mesh)
    for n in EXPERT_WEIGHTS:
        w, held = full["layers"]["moe"][n], half["layers"]["moe"][n]
        assert held.shape == (w.shape[0], e // 2, *w.shape[2:]) and held.is_contiguous()
        assert torch.equal(held, w[:, e // 2:]) and held.data_ptr() != w.data_ptr()
    assert half["layers"]["moe"]["router"] is full["layers"]["moe"]["router"]
    assert half["embed"] is full["embed"]


@pytest.mark.parametrize("index", [0, 1])
def test_init_expert_parallel_draws_the_shard_of_one_devices_model(index):
    """Cutting each expert weight as it is drawn gives the rank the same
    params as drawing the whole model and cutting it after; the generator
    ends in the same state."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.models.moe_shard_map import init_expert_parallel, shard_expert_params
    from repro_torch.optim.base import tree_leaves

    cfg = reduced(get_config("dbrx-132b"))
    mesh = _Mesh(data=1, model=2)
    mesh.axis_index = lambda name: index
    g_full, g_cut = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    want = shard_expert_params(cfg, M.init(cfg, g_full, "cpu"), mesh)
    got = init_expert_parallel(cfg, g_cut, mesh, "cpu")
    assert got["layers"]["moe"]["w_up"].shape[1] == cfg.n_experts // 2
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)
        assert a.is_contiguous()
    assert torch.equal(torch.randn(4, generator=g_cut), torch.randn(4, generator=g_full))
    with pytest.raises(ValueError, match="must divide over the model axis 3"):
        init_expert_parallel(cfg, g_cut, _Mesh(data=1, model=3), "cpu")


def test_masks_from_topk_on_a_column_slice_equals_the_full_masks_slice():
    """The sharded refinement's masks: the global top-K shifted into a
    slice's columns, the ids outside it invalid, give that slice of the
    masks of the whole table, for either choice of positives."""
    import torch

    from repro_torch.core.outcomes import masks_from_topk

    g = torch.Generator().manual_seed(0)
    rel = (torch.rand((6, 10), generator=g) < 0.3).float()
    top = torch.stack([torch.randperm(10, generator=g)[:4] for _ in range(6)])
    for positives in ("ground_truth", "retrieved"):
        full = masks_from_topk(top, rel, positives)
        for lo, hi in ((0, 5), (5, 10), (3, 4)):
            got = masks_from_topk(top - lo, rel[:, lo:hi], positives,
                                  valid=(top >= lo) & (top < hi))
            for a, b in zip(got, full):
                assert torch.equal(a, b[:, lo:hi]), (positives, lo, hi)


# ------------------------------------------------------------ one rank
def _tree(npz, prefix):
    """The nested params dict under `prefix` of the reference's npz."""
    from repro_torch.convert import params_from_jax

    tree = {}
    for key in npz.files:
        if key.startswith(prefix):
            node = tree
            *parents, leaf = key[len(prefix):].split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = npz[key]
    return params_from_jax(tree, "cpu")


def _rank_main(args) -> int:
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.common import meshctx, sharding
    from repro_torch.configs import get_config
    from repro_torch.core.refine import refine_embeddings
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.models.decode_shard_map import (decode_cache_specs, gather_decode_cache,
                                                     shard_decode_cache)
    from repro_torch.models.moe_shard_map import shard_expert_params

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    mesh = meshctx.make_mesh((2, 2), ("data", "model"), device="cpu")
    npz = np.load(args.npz)
    sizes = meshctx.axis_sizes_dict(mesh)

    def rows(x):
        spec = sharding.spec_for(("batch",) + (None,) * (x.dim() - 1), mesh.axis_names,
                                 x.shape, sizes)
        return sharding.local_shard(x, spec, mesh), spec

    def report(case, err, tol):
        assert err < tol, (case, err, tol)
        print(f"ok {case} {err:.3g} < {tol}", flush=True)

    with torch.no_grad():
        # ---- the MoE, through forward, as the reference's test drives it
        for case, cf in (("moe", 8.0), ("moe_bound", 1.0)):
            cfg = dataclasses.replace(reduced(get_config("dbrx-132b"), capacity_factor=cf),
                                      moe_impl="shard_map")
            full = _tree(npz, case + ":params/")
            # this rank holds its E/2 experts, as the reference's in_specs
            # hand each program its block
            params = shard_expert_params(cfg, full, mesh)
            lo = mesh.axis_index("model") * cfg.n_experts // 2
            for n in ("w_gate", "w_up", "w_down"):
                held, w = params["layers"]["moe"][n], full["layers"]["moe"][n]
                assert held.shape[1] == cfg.n_experts // 2, (n, held.shape)
                assert torch.equal(held, w[:, lo:lo + held.shape[1]])
            tokens, spec = rows(torch.from_numpy(npz[case + ":tokens"]))
            with meshctx.use_mesh(mesh):
                logits, aux = M.forward(cfg, params, {"tokens": tokens})
                # all E experts held: the block takes its own, the same logits
                assert torch.equal(M.forward(cfg, full, {"tokens": tokens})[0], logits)
                logits = sharding.gather_shards(logits, spec[:1], mesh)
            ref = torch.from_numpy(npz[case + ":shard_map"])
            gspmd = torch.from_numpy(npz[case + ":gspmd"])
            if case == "moe_bound":  # the per-shard capacity drops other tokens
                assert float((gspmd - ref).abs().max()) > 1e-2
            assert abs(float(aux) - float(npz[case + ":aux"])) < 1e-5
            report(case, float((logits - ref).abs().max()), 1e-4)

        # ---- the seq-sharded decode
        for arch in DECODE_ARCHS:
            cfg = dataclasses.replace(reduced(get_config(arch)), decode_attn="seq_shard")
            params = _tree(npz, arch + ":params/")
            toks = torch.from_numpy(npz[arch + ":tokens"])
            s = toks.shape[1]
            _, cache = M.prefill(cfg, params, {"tokens": toks[:, :s - 1]}, max_cache_len=s)
            with meshctx.use_mesh(mesh):
                specs = decode_cache_specs(cfg, cache, mesh)
                local = shard_decode_cache(cfg, cache, mesh)
                token, spec = rows(toks[:, s - 1:s])
                logits, local = M.decode_step(cfg, params, local, {"token": token, "pos": s - 1})
                logits = sharding.gather_shards(logits, spec[:1], mesh)
                k = gather_decode_cache(local, specs, mesh)["k"]
            err = float((logits - torch.from_numpy(npz[arch + ":logits"])).abs().max())
            kerr = float((k - torch.from_numpy(npz[arch + ":k"])).abs().max())
            assert kerr < 1e-3, (arch, kerr)
            report(f"decode {arch}", err, 2e-3)

        # ---- the tool-axis refinement over a 4-rank "model" mesh
        mesh1 = meshctx.make_mesh((4,), ("model",), device="cpu")
        q, t, rel = (torch.from_numpy(npz["refine:" + n]) for n in ("q", "t", "rel"))
        with meshctx.use_mesh(mesh1):
            t_s = sharding.distribute_rows(t, mesh1, ("model", None))
            rel_s = sharding.distribute_rows(rel, mesh1, (None, "model"))
            out = sharding.gather_rows(refine_embeddings(t_s, q, rel_s))
        report("refine", float((out - torch.from_numpy(npz["refine:out"])).abs().max()), 1e-5)

    # ---- named_sharding's placements, logical_constraint's redistribution
    _placements_case(mesh, report)
    # ---- Trainer(mesh=): data-parallel over "data", against one process
    _trainer_case(mesh, Path(args.tmp), report)
    dist.destroy_process_group()
    return 0


def _placements_case(mesh, report) -> None:
    import torch
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.common import meshctx, sharding

    _, placements = sharding.named_sharding(mesh, ("batch", None, "heads"), (4, 8, 6))
    assert placements == (Shard(0), Shard(2)), placements
    _, placements = sharding.named_sharding(mesh, ("batch", "kv_heads"), (4, 3))
    assert placements == (Shard(0), Replicate()), placements  # 3 heads: replicated
    with sharding.set_policy("fsdp"):  # batch over both axes: Shard(0) on each
        assert sharding.named_sharding(mesh, ("batch",), (8,))[1] == (Shard(0), Shard(0))
    x = torch.arange(24.0).reshape(4, 6)
    with meshctx.use_mesh(mesh):
        assert sharding.logical_constraint(x, "batch", "heads") is x
        spread = sharding.logical_constraint(
            sharding.distribute_rows(x, mesh, (None, None)), "batch", "heads")
        assert spread.placements == (Shard(0), Shard(1)), spread.placements
        err = float((sharding.gather_rows(spread) - x).abs().max())
    report("placements", err, 1e-12)


def _trainer_case(mesh, tmp: Path, report) -> None:
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint.msgpack_ckpt import restore_checkpoint
    from repro_torch.common import meshctx
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.config import reduced
    from repro_torch.optim.base import tree_leaves
    from repro_torch.training.train_step import TrainConfig
    from repro_torch.training.trainer import Trainer, TrainerConfig

    cfg = reduced(get_config("qwen2.5-3b"))
    rng = np.random.default_rng(3)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (4, 32)).astype(np.int32)}
               for _ in range(2)]
    train = TrainConfig(optimizer="sgd", learning_rate=0.05, warmup_steps=0, total_steps=10)
    tc = TrainerConfig(steps=2, log_every=1, seed=0, train=train)
    single = Trainer(cfg, tc, device="cpu")
    ckpt = tmp / "mesh_ckpt"
    sharded = Trainer(cfg, dataclasses.replace(tc, ckpt_every=2, ckpt_dir=str(ckpt)),
                      mesh=mesh)

    # the gradients of one batch, leaf by leaf: this rank's rows, averaged
    batch = {"tokens": torch.from_numpy(batches[0]["tokens"])}
    g_single = torch.autograd.grad(M.loss_fn(cfg, single.params, batch)[0],
                                   tree_leaves(single.params))
    local = {"tokens": sharded._rows(batches[0]["tokens"])}
    with meshctx.use_mesh(mesh):
        g_local = torch.autograd.grad(M.loss_fn(cfg, sharded.params, local)[0],
                                      tree_leaves(sharded.params))
    g_mesh = sharded._data_mean(list(g_local))
    gerr = max(float((a - b).abs().max()) for a, b in zip(g_single, g_mesh))

    h_single = single.fit(iter(batches), log=lambda *_: None)
    h_mesh = sharded.fit(iter(batches), log=lambda *_: None)
    lerr = max(abs(a["loss"] - b["loss"]) for a, b in zip(h_single, h_mesh))
    perr = max(float((a - b).abs().max()) for a, b in
               zip(tree_leaves(single.params), tree_leaves(sharded.params)))
    step, tree, _ = restore_checkpoint(str(ckpt))
    saved, want = _flatten(tree["params"]), _flatten(single.params)
    assert set(saved) == set(want)
    cerr = max(float((torch.as_tensor(np.asarray(saved[k])) - want[k].detach()).abs().max())
               for k in want)
    assert step == 2 and cerr < 1e-4, (step, cerr)
    assert lerr < 1e-4 and perr < 1e-4, (lerr, perr)
    report("trainer", gerr, 1e-4)
    dist.barrier()


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="One rank of the port's 2x2 gloo job.")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--npz", required=True)
    ap.add_argument("--tmp", default=tempfile.gettempdir())
    sys.exit(_rank_main(ap.parse_args()))

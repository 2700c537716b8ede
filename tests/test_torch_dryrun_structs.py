"""The dry-run's structs against the JAX package's.

Every struct's shape, dtype and spec (params, int8 params, the three
optimizers' states, inputs and caches) is held to the reference's, at the
production axis sizes for the four policies (the port's structs on the
fake process group's 256- and 512-rank meshes, the reference's builders
run with `spec_for` on synthetic sizes, as tests/test_sharding_and_launch.py
resolves them), and on a 2x2 mesh against JAX's own structs (a JAX
subprocess with 4 forced host devices, and this file run as a script over
a fake 2x2 mesh): global shapes, dtypes, specs and each rank's block.
"""
import argparse
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.common import sharding as j_sharding
from repro.configs import get_config as j_get_config
from repro.launch import specs as j_specs
from repro.launch import state_specs as j_state_specs
from repro.models import model as JM
from repro.models import params as j_params
from repro.models import quant as j_quant

from repro_torch.common import sharding
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import specs, state_specs
from repro_torch.launch.mesh import make_fake_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models.config import reduced
from repro_torch.models.params import param_shardings, param_structs
from repro_torch.models.quant import quantized_structs

REPO = Path(__file__).resolve().parent.parent
ARCHS = sorted(ARCHITECTURES)
POLICIES = ("tp", "tp_sp", "tp_kvs", "fsdp")
OPTIMIZERS = ("adamw", "adafactor", "sgd")
SMALL_SHAPE = {"train": (4, 64), "prefill": (4, 64), "decode": (4, 64)}  # batch, seq
SUBPROCESS_TIMEOUT_S = 240


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """The fake process group this module makes is torn down after it."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ------------------------------------------------------------- structs


def _leaves(tree, prefix=""):
    """(path, leaf) of a tree of dicts and named tuples, keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def _port_record(x, mesh):
    """(shape, dtype, spec, local shape) of a port struct."""
    from torch.distributed.tensor import DTensor

    dtype = str(x.dtype).replace("torch.", "")
    if isinstance(x, DTensor):
        return (tuple(x.shape), dtype, sharding.dtensor_spec(x, mesh),
                tuple(x.to_local().shape))
    return tuple(x.shape), dtype, None, tuple(x.shape)


def _norm_spec(spec):
    return None if spec is None else tuple(
        tuple(e) if isinstance(e, (list, tuple)) else e for e in spec)


def _port_structs(cfg, shape, mesh):
    """Every struct tree of one (config, shape) on `mesh`, by name."""
    pspecs = M.make_specs(cfg)
    dtype = getattr(torch, cfg.dtype)
    out = {"params": param_structs(pspecs, dtype, mesh),
           "quantized": quantized_structs(pspecs, mesh, dtype),
           "inputs": specs.input_specs(cfg, shape, mesh)}
    for opt in OPTIMIZERS:
        out[opt] = state_specs.opt_state_structs(opt, pspecs, mesh)
    if shape.kind == "decode":
        out["cache"] = specs.cache_structs(cfg, shape, mesh)
    return out


class _Struct(types.SimpleNamespace):
    """Stands in for jax.ShapeDtypeStruct when the reference's builders run
    on a mesh description without devices."""


def _reference_structs(cfg, shape, names, sizes, monkeypatch):
    """The reference's struct builders run against a mesh of `sizes`
    without devices: its `named_sharding` resolves each leaf's spec with
    `spec_for` on the synthetic sizes."""
    mesh = types.SimpleNamespace(axis_names=tuple(names),
                                 devices=np.empty(tuple(sizes[n] for n in names)))
    monkeypatch.setattr(j_sharding, "NamedSharding", lambda m, spec: spec)
    monkeypatch.setattr(jax, "ShapeDtypeStruct",
                        lambda s, d, sharding=None: _Struct(shape=tuple(s), dtype=d,
                                                            spec=sharding))
    pspecs = JM.make_specs(cfg)
    dtype = jnp.dtype(cfg.dtype)
    out = {"params": j_params.param_structs(pspecs, dtype, mesh),
           "quantized": j_quant.quantized_structs(pspecs, mesh, dtype),
           "inputs": j_specs.input_specs(cfg, shape, mesh)}
    for opt in OPTIMIZERS:
        out[opt] = j_state_specs.opt_state_structs(opt, pspecs, mesh)
    if shape.kind == "decode":
        out["cache"] = j_specs.cache_structs(cfg, shape, mesh)
    monkeypatch.undo()
    return out


def _local_shape(shape, spec, sizes):
    if spec is None:
        return tuple(shape)
    out = []
    for n, entry in zip(shape, spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
        out.append(n // int(np.prod([sizes[a] for a in axes])) if axes else n)
    return tuple(out)


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("multi_pod", [False, True], ids=["single", "multi"])
def test_structs_resolve_as_the_reference_at_production_sizes(policy, multi_pod,
                                                              monkeypatch):
    mesh = make_production_mesh(multi_pod=multi_pod)
    sizes = dict(mesh.shape)
    with sharding.set_policy(policy), j_sharding.set_policy(policy):
        for arch in ARCHS:
            for name in specs.SHAPES:
                shape = specs.SHAPES[name]
                cfg = specs.variant_for_shape(get_config(arch), shape)
                j_cfg = j_specs.variant_for_shape(j_get_config(arch), j_specs.SHAPES[name])
                got = _port_structs(cfg, shape, mesh)
                want = _reference_structs(j_cfg, j_specs.SHAPES[name], mesh.axis_names,
                                          sizes, monkeypatch)
                assert sorted(got) == sorted(want)
                shardings = dict(_leaves(param_shardings(mesh, M.make_specs(cfg))))
                for path, x in _leaves(got["params"]):
                    assert shardings[path] == (mesh, x.placements), (arch, path)
                for tree in got:
                    g, w = list(_leaves(got[tree])), list(_leaves(want[tree]))
                    assert [p for p, _ in g] == [p for p, _ in w], (arch, name, tree)
                    for (path, x), (_, y) in zip(g, w):
                        spec = _norm_spec(y.spec)
                        rec = (tuple(y.shape), str(jnp.dtype(y.dtype)), spec,
                               _local_shape(y.shape, spec, sizes))
                        assert _port_record(x, mesh) == rec, (arch, name, tree, path)


# the JAX side of the 2x2 comparison: its own structs on 4 forced devices
JAX_STRUCTS = """
import json, sys, jax, jax.numpy as jnp
from repro.common.meshctx import make_mesh
from repro.common.sharding import set_policy
from repro.configs import ARCHITECTURES, get_config
from repro.launch.specs import ShapeCase, cache_structs, input_specs
from repro.launch.state_specs import opt_state_structs
from repro.models import model as M
from repro.models.config import reduced
from repro.models.params import param_structs
from repro.models.quant import quantized_structs
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
def walk(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            walk(tree[k], prefix + k + "/")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            walk(getattr(tree, k), prefix + k + "/")
    else:
        sh = tree.sharding
        spec = None if sh is None else [list(e) if isinstance(e, tuple) else e for e in sh.spec]
        local = list(tree.shape) if sh is None else list(sh.shard_shape(tree.shape))
        out[prefix[:-1]] = [list(tree.shape), str(jnp.dtype(tree.dtype)), spec, local]
for policy in %(policies)r:
    set_policy(policy)
    for arch in sorted(ARCHITECTURES):
        cfg = reduced(get_config(arch), dtype="bfloat16")
        pspecs = M.make_specs(cfg)
        walk(param_structs(pspecs, jnp.bfloat16, mesh), f"{policy}:{arch}:params/")
        walk(quantized_structs(pspecs, mesh, jnp.bfloat16), f"{policy}:{arch}:quantized/")
        for opt in %(optimizers)r:
            walk(opt_state_structs(opt, pspecs, mesh), f"{policy}:{arch}:{opt}/")
        for kind, (b, s) in %(shapes)r.items():
            shape = ShapeCase(kind, s, b, kind)
            walk(input_specs(cfg, shape, mesh), f"{policy}:{arch}:inputs_{kind}/")
            if kind == "decode":
                walk(cache_structs(cfg, shape, mesh), f"{policy}:{arch}:cache/")
json.dump(out, open(sys.argv[1], "w"))
""" % {"policies": POLICIES, "optimizers": OPTIMIZERS, "shapes": SMALL_SHAPE}


def _port_structs_2x2(out_path):
    """This file as a script: the port's structs on a fake 4-rank group."""
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    out = {}
    for policy in POLICIES:
        with sharding.set_policy(policy):
            for arch in ARCHS:
                cfg = reduced(get_config(arch), dtype="bfloat16")
                trees = {}
                for kind, (b, s) in SMALL_SHAPE.items():
                    shape = specs.ShapeCase(kind, s, b, kind)
                    got = _port_structs(cfg, shape, mesh)
                    trees.update({k: v for k, v in got.items() if k != "inputs"})
                    trees[f"inputs_{kind}"] = got["inputs"]
                for tree, value in trees.items():
                    for path, x in _leaves(value):
                        shape_, dtype, spec, local = _port_record(x, mesh)
                        spec = None if spec is None else [
                            list(e) if isinstance(e, tuple) else e for e in spec]
                        out[f"{policy}:{arch}:{tree}/{path}"] = [
                            list(shape_), dtype, spec, list(local)]
    with open(out_path, "w") as f:
        json.dump(out, f)


def test_structs_match_jax_structs_on_a_2x2_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    j_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jax_out, port_out = tmp_path / "jax.json", tmp_path / "port.json"
    procs = [subprocess.Popen([sys.executable, "-c", JAX_STRUCTS, str(jax_out)], env=j_env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
             subprocess.Popen([sys.executable, __file__, "--port-structs", str(port_out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)]
    for p in procs:
        log, _ = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        assert p.returncode == 0, log
    want, got = json.loads(jax_out.read_text()), json.loads(port_out.read_text())
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--port-structs", required=True)
    _port_structs_2x2(ap.parse_args().port_structs)

"""The dry-run's own outputs, per device, for every family and program
(reduced configs in bf16, batch 4 x 64 tokens, over a fake 2x2
("data", "model") group, "tp" policy).

* No rank computes another's block: 4 x each device's FLOPs equals the
  FLOPs of the same program on plain tensors, exactly.
* Against the JAX package's dry-run (two subprocesses with 4 forced host
  devices compile the reference's `build_program` over a 2x2 mesh, layers
  unrolled so that XLA counts each one), in bands set from readings of
  both packages at these sizes:
  - FLOPs a device: at most the reference's (XLA counts every op, the port
    the matrix products only), and at least 0.7 of it for train and
    prefill (readings 0.74-0.95), 0.25 for decode (0.26-0.51: at these
    widths a token's elementwise work is a large share);
  - collectives: all-gathers and all-reduces in both, the port's total
    count within 0.5-2.5x the reference's (readings 0.86-2.20) and its
    wire bytes within 0.15-2x (0.21-1.43);
  - argument bytes a device: the reference's exactly, except where XLA
    drops an argument the program never reads (the VLM decode's
    cross-attention K/V weights, read only at prefill: +3.4 %), so within
    0-5 % above; temp bytes at most 1.25x the reference's (0.06-0.86).
* The partitioned ops compute the plain ones' values: on 4 gloo ranks
  (this file run as a script), `sharding.project` (FSDP + tensor-parallel
  and partial-sum products), `gqa_attention` and the SSD scan through
  `blockwise` and the vocab-parallel `token_nll`, forward and gradients, against the same ops
  on plain tensors, within 1e-6 of the largest value (float32 sums in
  another order).
"""
import argparse
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import CollectiveStats
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.specs import ShapeCase
from repro_torch.models.config import reduced
from repro_torch.training.train_step import TrainConfig

REPO = Path(__file__).resolve().parent.parent
ARCHS = sorted(ARCHITECTURES)
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64
SUBPROCESS_TIMEOUT_S = 240
FLOPS_FLOOR = {"train": 0.7, "prefill": 0.7, "decode": 0.25}

# the reference's dry-run of each program over 4 forced host devices
JAX_COSTS = """
import dataclasses, json, sys, jax
from repro.common.meshctx import cost_analysis_dict, make_mesh, use_mesh
from repro.configs import get_config
from repro.launch.dryrun import build_program
from repro.launch.hlo_analysis import parse_collectives
from repro.launch.specs import ShapeCase
from repro.models.config import reduced
from repro.training.train_step import TrainConfig
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch in sys.argv[2].split(","):
    cfg = dataclasses.replace(reduced(get_config(arch), dtype="bfloat16"), scan_unroll=True)
    for kind in %(kinds)r:
        fn, args = build_program(cfg, ShapeCase(kind, %(seq)d, %(batch)d, kind), mesh,
                                 TrainConfig())
        with use_mesh(mesh):
            compiled = jax.jit(fn).lower(*args).compile()
        colls = parse_collectives(compiled.as_text())
        ma = compiled.memory_analysis()
        out[arch + ":" + kind] = {
            "flops": float(cost_analysis_dict(compiled)["flops"]),
            "count_by_type": colls.count_by_type, "bytes_by_type": colls.bytes_by_type,
            "argument_bytes": ma.argument_size_in_bytes, "temp_bytes": ma.temp_size_in_bytes}
json.dump(out, open(sys.argv[1], "w"))
""" % {"kinds": KINDS, "seq": SEQ, "batch": BATCH}


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the JAX subprocesses (half the archs each) when the module
    starts; `wait()` gives their records."""
    tmp = tmp_path_factory.mktemp("jax_costs")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    halves = (ARCHS[::2], ARCHS[1::2])
    procs = [(tmp / f"{i}.json", subprocess.Popen(
        [sys.executable, "-c", JAX_COSTS, str(tmp / f"{i}.json"), ",".join(archs)], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for i, archs in enumerate(halves)]
    records = {}

    def wait():
        while procs:
            path, p = procs.pop()
            log, _ = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
            assert p.returncode == 0, log
            records.update(json.loads(path.read_text()))
        return records

    yield wait
    for _, p in procs:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module", autouse=True)
def fake_group(reference):
    """The fake process group this module makes is torn down after it; the
    reference's subprocesses start first."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


_PORT: dict = {}


def _port(arch: str, kind: str, partitioned: bool) -> dict:
    """The port's dry-run of one program, on the 2x2 mesh or unpartitioned
    (plain fake tensors, what one device would run); computed once."""
    key = (arch, kind, partitioned)
    if key not in _PORT:
        mesh = make_fake_mesh((2, 2), ("data", "model")) if partitioned else None
        cfg = reduced(get_config(arch), dtype="bfloat16")
        assert not D.needs_repeat_kv(cfg, mesh)
        fn, args = D.build_program(cfg, ShapeCase(kind, SEQ, BATCH, kind), mesh, TrainConfig())
        cost, colls, mem, _ = D.run_program(fn, args, mesh)
        _PORT[key] = {"flops": cost.flops, "collectives": colls, **mem}
    return _PORT[key]


@pytest.mark.parametrize("arch", ARCHS)
def test_no_rank_computes_another_ranks_block(arch):
    for kind in KINDS:
        dev, whole = _port(arch, kind, True), _port(arch, kind, False)
        assert 4 * dev["flops"] == whole["flops"] > 0, (kind, dev["flops"], whole["flops"])


@pytest.mark.parametrize("arch", ARCHS)
def test_costs_per_device_within_the_references_bands(arch, reference):
    want = reference()
    for kind in KINDS:
        got, ref = _port(arch, kind, True), want[f"{arch}:{kind}"]
        tag = (arch, kind)
        ratio = got["flops"] / ref["flops"]
        assert FLOPS_FLOOR[kind] <= ratio <= 1.0, (tag, ratio)
        colls = got["collectives"]
        ref_colls = CollectiveStats(ref["bytes_by_type"], ref["count_by_type"])
        for name in ("all-gather", "all-reduce"):
            assert colls.count_by_type[name] > 0 and ref_colls.count_by_type[name] > 0, tag
        counts = sum(colls.count_by_type.values()) / sum(ref_colls.count_by_type.values())
        assert 0.5 <= counts <= 2.5, (tag, counts)
        wire = colls.wire_bytes / ref_colls.wire_bytes
        assert 0.15 <= wire <= 2.0, (tag, wire)
        args = got["argument_bytes"] / ref["argument_bytes"]
        assert 1.0 <= args <= 1.05, (tag, args)
        assert got["temp_bytes"] <= 1.25 * ref["temp_bytes"], tag


def _values_rank(rank: int, port: int, out: str) -> None:
    """One of 4 gloo ranks on a (2, 2) mesh: each partitioned op and its
    gradients against the plain op on the whole tensors; rank 0 writes the
    largest differences."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.common import meshctx, sharding
    from repro_torch.models import layers, ssm

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    mesh = meshctx.make_mesh((2, 2), ("data", "model"), "cpu")
    dm, g = mesh.device_mesh, torch.Generator().manual_seed(0)

    def both(fn, tensors, placements):
        """The largest |difference| of the outputs, and of the gradients,
        each over the plain op's largest |value|."""
        parts = [distribute_tensor(t, dm, p).detach().requires_grad_(t.is_floating_point())
                 for t, p in zip(tensors, placements)]
        whole = [t.clone().requires_grad_(t.is_floating_point()) for t in tensors]
        with meshctx.use_mesh(mesh):
            got = fn(*parts).full_tensor()
        want = fn(*whole)
        (got * got).sum().backward()
        (want * want).sum().backward()
        grads = [((p.grad.full_tensor() - w.grad).abs().max() / w.grad.abs().max()).item()
                 for p, w in zip(parts, whole) if w.grad is not None]
        return ((got - want).abs().max() / want.abs().max()).item(), max(grads)

    x = torch.randn(4, 6, 8, generator=g)
    heads, rows = ("batch", None, "ssm_heads", None), ("batch", None, None, None)
    res = {
        "project heads": both(lambda a, w: sharding.project("bsd,dhk->bshk", a, w),
                              (x, torch.randn(8, 4, 5, generator=g)),
                              ([Shard(0), Replicate()], [Shard(0), Shard(1)])),
        "project partial": both(lambda a, w: sharding.project("bshk,hkd->bsd", a, w),
                                (torch.randn(4, 6, 4, 5, generator=g),
                                 torch.randn(4, 5, 8, generator=g)),
                                ([Shard(0), Shard(2)], [Shard(2), Shard(0)])),
        "attention": both(lambda q, k, v: layers.gqa_attention(
            q, k, v, torch.ones(1, 6, 6, dtype=torch.bool).tril()),
            tuple(torch.randn(4, 6, h, 5, generator=g) for h in (4, 2, 2)),
            ([Shard(0), Shard(2)],) * 3),
        # B and C whole over the heads' axis, A over the rows': partial gradients
        "ssd scan": both(lambda x_, dt, a, b, c: sharding.blockwise(
            lambda *t: ssm.ssd_chunked(*t, chunk=4)[0], (x_, dt, a, b, c),
            (heads, heads[:3], heads[2:3], rows, rows), (heads,)),
            (torch.randn(4, 8, 4, 3, generator=g), torch.rand(4, 8, 4, generator=g),
             torch.randn(4, generator=g), torch.randn(4, 8, 1, 2, generator=g),
             torch.randn(4, 8, 1, 2, generator=g)),
            ([Shard(0), Shard(2)], [Shard(0), Shard(2)], [Replicate(), Shard(0)],
             [Shard(0), Replicate()], [Shard(0), Replicate()])),
        "token_nll": both(sharding.token_nll,
                          (torch.randn(4, 3, 10, generator=g),
                           torch.randint(0, 10, (4, 3), generator=g)),
                          ([Shard(0), Shard(2)], [Shard(0), Replicate()])),
    }
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_partitioned_ops_compute_the_plain_values_on_4_gloo_ranks(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    out, port = tmp_path / "values.json", _free_port()
    procs = [subprocess.Popen([sys.executable, __file__, "--values-rank", str(r), "--port",
                               str(port), "--out", str(out)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
    for p in procs:
        log, _ = p.communicate(timeout=SUBPROCESS_TIMEOUT_S)
        assert p.returncode == 0, log
    # float32, the sums in another order across ranks
    for name, (value, grad) in json.loads(out.read_text()).items():
        assert value <= 1e-6 and grad <= 1e-6, (name, value, grad)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--values-rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _values_rank(a.values_rank, a.port, a.out)

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
    count within 0.5-2.5x the reference's (readings 0.76-2.20) and its
    wire bytes at most the reference's (readings 0.12-0.73: XLA's CPU
    backend moves the bf16 program's collectives as float32), and at
    least 0.15 of it for train and prefill (0.42-0.73). A decode step
    moves a token's activations where the reference gathers weights, and
    its floor is what it must move, from the cell's shapes
    (`_decode_wire_floor`: the vocab-parallel lookup's partial rows and
    the FSDP gathers that `sharding.project` must make; readings 0.07-0.88
    of the port's wire, which is 0.12-0.41 of the reference's). A projection
    gathered whole onto every rank breaks the ceiling (mamba2's in_proj
    read 1.43 at prefill when it was);
  - argument bytes a device: the reference's exactly, except where XLA
    drops an argument the program never reads (the VLM decode's
    cross-attention K/V weights, read only at prefill: +3.4 %), so within
    0-5 % above; temp bytes at most 1.25x the reference's (0.01-0.81).
* A one-token decode at batch 1, which "data" cannot split (reduced
  command-r-plus-104b and dbrx-132b), against the reference's same
  program over the 2x2 mesh (a JAX subprocess): no all-to-all, and wire
  at most the reference's and at least a floor from the shapes
  (`_one_token_wire_floor`: the lookup's and the partial products'
  all-reduces). A weight re-laid onto an output dimension (an all-to-all
  a weight) breaks it.
* The MoE block alone, where its dispatch dominates (reduced dbrx-132b
  and arctic-480b with their own expert counts and top-k, 4 x 512
  tokens), forward and its gradients, against the reference's over the
  same 2x2 mesh (a JAX subprocess): temp bytes a device at most 1.25x the
  reference's, argument bytes equal, and no storage of the whole
  gather-back buffer [E * cap + 1, D] at the peak. A dispatch run
  replicated (every rank scattering every row into the whole buffer), or
  the gather-back's buffer pinned replicated, breaks the band.
* Where the embedding lookup dominates (a decode step of reduced
  mamba2-2.7b, its table tied, and qwen2.5-3b, untied, with a 16,384-row
  vocabulary, 4 tokens) and the Mamba-2 block alone (reduced mamba2-2.7b,
  8 whole SSM heads a rank, 4 x 512 tokens, forward and its gradients),
  against the reference's over the same mesh: argument bytes equal, temp
  and wire bytes at most 1.25x the reference's. A table gathered whole
  onto every rank, or the in_proj output cut off its shards' edges (and
  so gathered whole), breaks the band.
* The partitioned ops compute the plain ones' values: on 4 gloo ranks
  (this file run as a script), `sharding.project` (FSDP + tensor-parallel
  and partial-sum products; a one-token row against FSDP weights,
  contracted in place, and a batch-1 prefill's rows, which re-lay them),
  `gqa_attention` and the SSD scan through `blockwise`, the
  vocab-parallel `token_nll`, the MoE dispatch's `scatter_rows` and its
  gather-back's `take_rows` (dropped targets among them; its forward
  exactly), the vocab-parallel `lookup_rows` (alone, exactly; under
  a tied head; musicgen's offset codebooks) and the Mamba-2 block and its
  decode step on in_proj's column groups, forward and gradients, against
  the same ops on plain tensors, within 1e-6 of the largest value
  (float32 sums in another order).
"""
import argparse
import json
import math
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.common.sharding import spec_for, struct
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import CollectiveStats
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.specs import ShapeCase
from repro_torch.models import layers, model as M, ssm
from repro_torch.models.config import reduced
from repro_torch.models.params import init_params, param_structs
from repro_torch.training.train_step import TrainConfig

REPO = Path(__file__).resolve().parent.parent
ARCHS = sorted(ARCHITECTURES)
KINDS = ("train", "prefill", "decode")
BATCH, SEQ = 4, 64
SUBPROCESS_TIMEOUT_S = 240
FLOPS_FLOOR = {"train": 0.7, "prefill": 0.7, "decode": 0.25}

# the reference's dry-run of each program over 4 forced host devices
_JAX_COSTS = """
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
"""
JAX_COSTS = _JAX_COSTS % {"kinds": KINDS, "seq": SEQ, "batch": BATCH}

# a one-token decode at batch 1, which "data" = 2 cannot split: an
# attention architecture and a MoE one
ONE_TOKEN_ARCHS = ("command-r-plus-104b", "dbrx-132b")
JAX_ONE_TOKEN = _JAX_COSTS % {"kinds": ("decode",), "seq": SEQ, "batch": 1}


# the MoE block alone: full expert counts and top-k at reduced width, and
# enough tokens that the dispatch's rows and buffers dominate its memory
MOE_ARCHS = ("arctic-480b", "dbrx-132b")
MOE_BATCH, MOE_SEQ = 4, 512
JAX_MOE = """
import json, sys, jax, jax.numpy as jnp
from repro.common.meshctx import make_mesh, use_mesh
from repro.common.sharding import named_sharding
from repro.configs import get_config
from repro.models import layers, model as JM
from repro.models.config import reduced
from repro.models.params import param_structs
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
for arch in %(archs)r:
    full = get_config(arch)
    cfg = reduced(full, dtype="bfloat16", n_experts=full.n_experts,
                  experts_per_token=full.experts_per_token)
    p = param_structs(JM._moe_specs(cfg, 1), jnp.bfloat16, mesh)
    shape = (%(batch)d, %(seq)d, cfg.d_model)
    x = jax.ShapeDtypeStruct(shape, jnp.bfloat16,
                             sharding=named_sharding(mesh, ("batch", None, None), shape))
    def forward(p, x):
        return layers.moe_block({k: v[0] for k, v in p.items()}, x, cfg)
    def loss(p, x):
        y, aux = forward(p, x)
        return jnp.mean(jnp.square(y.astype(jnp.float32))) + aux
    for kind, fn in (("forward", forward), ("train", jax.grad(loss, argnums=(0, 1)))):
        with use_mesh(mesh):
            ma = jax.jit(fn).lower(p, x).compile().memory_analysis()
        out[arch + ":" + kind] = {"argument_bytes": ma.argument_size_in_bytes,
                                  "temp_bytes": ma.temp_size_in_bytes}
json.dump(out, open(sys.argv[1], "w"))
""" % {"archs": MOE_ARCHS, "batch": MOE_BATCH, "seq": MOE_SEQ}


# where the vocab-parallel lookup and the head-sharded Mamba-2 block
# dominate: a decode step of reduced mamba2-2.7b (its table tied) and
# qwen2.5-3b (untied) with a vocabulary large against d_model, and the
# Mamba-2 block alone (reduced mamba2-2.7b: 16 SSM heads, 8 a rank over
# "model"), forward and its gradients
EMBED_ARCHS, EMBED_VOCAB, EMBED_BATCH, EMBED_SEQ = ("mamba2-2.7b", "qwen2.5-3b"), 16384, 4, 64
SSM_BATCH, SSM_SEQ = 4, 512
JAX_PARTS = """
import dataclasses, json, sys, jax, jax.numpy as jnp
from repro.common.meshctx import make_mesh, use_mesh
from repro.common.sharding import named_sharding
from repro.configs import get_config
from repro.launch.dryrun import build_program
from repro.launch.hlo_analysis import parse_collectives
from repro.launch.specs import ShapeCase
from repro.models import model as JM, ssm
from repro.models.config import reduced
from repro.models.params import param_structs
from repro.training.train_step import TrainConfig
mesh = make_mesh((2, 2), ("data", "model"))
out = {}
def record(key, fn, *args):
    with use_mesh(mesh):
        compiled = jax.jit(fn).lower(*args).compile()
    ma = compiled.memory_analysis()
    out[key] = {"argument_bytes": ma.argument_size_in_bytes, "temp_bytes": ma.temp_size_in_bytes,
                "wire_bytes": parse_collectives(compiled.as_text()).wire_bytes}
for arch in %(archs)r:
    cfg = dataclasses.replace(reduced(get_config(arch), dtype="bfloat16", vocab_size=%(vocab)d),
                              scan_unroll=True)
    fn, args = build_program(cfg, ShapeCase("decode", %(seq)d, %(batch)d, "decode"), mesh,
                             TrainConfig())
    record(arch + ":decode", fn, *args)
cfg = reduced(get_config("mamba2-2.7b"), dtype="bfloat16")
p = param_structs(JM._ssm_specs(cfg, 1), jnp.bfloat16, mesh)
shape = (%(ssm_batch)d, %(ssm_seq)d, cfg.d_model)
x = jax.ShapeDtypeStruct(shape, jnp.bfloat16,
                         sharding=named_sharding(mesh, ("batch", None, None), shape))
def forward(p, x):
    return ssm.ssm_block({k: v[0] for k, v in p.items()}, x, cfg)
def loss(p, x):
    return jnp.mean(jnp.square(forward(p, x).astype(jnp.float32)))
record("ssm:forward", forward, p, x)
record("ssm:train", jax.grad(loss, argnums=(0, 1)), p, x)
json.dump(out, open(sys.argv[1], "w"))
""" % {"archs": EMBED_ARCHS, "vocab": EMBED_VOCAB, "seq": EMBED_SEQ, "batch": EMBED_BATCH,
       "ssm_batch": SSM_BATCH, "ssm_seq": SSM_SEQ}


def _jax_subprocess(script: str, path: Path, *args: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    return subprocess.Popen([sys.executable, "-c", script, str(path), *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _records(path: Path, proc: subprocess.Popen) -> dict:
    log, _ = proc.communicate(timeout=SUBPROCESS_TIMEOUT_S)
    assert proc.returncode == 0, log
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Starts the JAX subprocesses (half the archs each) when the module
    starts; `wait()` gives their records."""
    tmp = tmp_path_factory.mktemp("jax_costs")
    halves = (ARCHS[::2], ARCHS[1::2])
    procs = [(tmp / f"{i}.json", _jax_subprocess(JAX_COSTS, tmp / f"{i}.json", ",".join(archs)))
             for i, archs in enumerate(halves)]
    records = {}

    def wait():
        while procs:
            records.update(_records(*procs.pop()))
        return records

    yield wait
    for _, p in procs:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def moe_reference(tmp_path_factory):
    """The reference's MoE block alone on 4 forced host devices, started
    when the module starts; `wait()` gives its records."""
    path = tmp_path_factory.mktemp("jax_moe") / "moe.json"
    procs = [(path, _jax_subprocess(JAX_MOE, path))]
    records = {}

    def wait():
        while procs:
            records.update(_records(*procs.pop()))
        return records

    yield wait
    for _, p in procs:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def parts_reference(tmp_path_factory):
    """The reference's embedding-dominated decode steps and Mamba-2 block on
    4 forced host devices, started when the module starts; `wait()` gives
    its records."""
    path = tmp_path_factory.mktemp("jax_parts") / "parts.json"
    procs = [(path, _jax_subprocess(JAX_PARTS, path))]
    records = {}

    def wait():
        while procs:
            records.update(_records(*procs.pop()))
        return records

    yield wait
    for _, p in procs:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module")
def one_token_reference(tmp_path_factory):
    """The reference's batch-1 decodes of ONE_TOKEN_ARCHS on 4 forced host
    devices, started when the module starts; `wait()` gives its records."""
    path = tmp_path_factory.mktemp("jax_one_token") / "one_token.json"
    procs = [(path, _jax_subprocess(JAX_ONE_TOKEN, path, ",".join(ONE_TOKEN_ARCHS)))]
    records = {}

    def wait():
        while procs:
            records.update(_records(*procs.pop()))
        return records

    yield wait
    for _, p in procs:
        p.kill()
        p.communicate()


@pytest.fixture(scope="module", autouse=True)
def fake_group(reference, moe_reference, parts_reference, one_token_reference):
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


def _decode_wire_floor(cfg) -> int:
    """The wire bytes a decode step of the port must move on the 2x2 mesh,
    from its shapes (bf16, 2 bytes a value):

    * the vocab-parallel lookup, where "model" splits the table's rows: a
      rank's partial rows (each token's and codebook's, the columns of its
      block: "data" splits them) summed over "model", an all-reduce (its
      bytes twice);
    * the FSDP gathers: a weight whose contracted "embed" rows "data"
      splits, read by activations whose rows "data" splits, is gathered
      over "data" (`sharding.project`), so that a rank holds at least the
      weight over "model"'s 2 ranks. The first layer's mixer reads the
      looked-up rows so (`_embed_tokens` constrains them to the batch's
      rows), through its input projections (attention's q, k and v, the
      SSM's in_proj), and so does an untied head."""
    specs = M.make_specs(cfg)
    axes = ("data", "model")
    table = specs["embed"].shape
    floor = 0
    if spec_for(specs["embed"].axes, axes, table, {"data": 2, "model": 2})[0]:
        ids = BATCH * (cfg.n_codebooks or 1)
        floor += 2 * ids * (table[1] // 2) * 2
    weights = [w for block in ("attn", "ssm") for w in specs["layers"].get(block, {}).values()
               if w.axes[1] == "embed"]
    for w in weights:
        floor += math.prod(w.shape[1:]) * 2 // 2
    if "lm_head" in specs:
        floor += math.prod(specs["lm_head"].shape) * 2 // 2
    return floor


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
        assert wire <= 1.0, (tag, wire)
        if kind == "decode":
            floor = _decode_wire_floor(reduced(get_config(arch), dtype="bfloat16"))
            assert colls.wire_bytes >= floor, (tag, colls.wire_bytes, floor)
        else:
            assert wire >= 0.15, (tag, wire)
        args = got["argument_bytes"] / ref["argument_bytes"]
        assert 1.0 <= args <= 1.05, (tag, args)
        assert got["temp_bytes"] <= 1.25 * ref["temp_bytes"], tag


def _one_token_wire_floor(cfg) -> int:
    """The wire bytes a decode step at batch 1 must move on the 2x2 mesh,
    from its shapes (bf16, 2 bytes a value), each an all-reduce (its bytes
    twice):

    * the vocab-parallel lookup's partial rows, as `_decode_wire_floor`'s;
    * the partial products: "data" cannot split the one row, so a weight
      whose contracted "embed" rows it splits is contracted in place
      (`sharding.project`) and this rank's output block, whole over "data"
      and split over "model" where its axes resolve there, is summed over
      "data": the attention's q, k and v, the MLP's gate and up, the SSM's
      in_proj a layer, and the head."""
    specs = M.make_specs(cfg)
    axes, sizes = ("data", "model"), {"data": 2, "model": 2}

    def reduced_block(shape, names) -> int:
        spec = spec_for(names, axes, shape, sizes)
        return 2 * 2 * math.prod(n // (2 if e else 1) for n, e in zip(shape, spec))

    table = specs["embed"].shape
    floor = 0
    if spec_for(specs["embed"].axes, axes, table, sizes)[0]:
        floor += reduced_block((cfg.n_codebooks or 1, table[1] // 2), (None, None))
    for block in ("attn", "mlp", "ssm"):
        for w in specs["layers"].get(block, {}).values():
            if w.axes[1] == "embed":
                floor += w.shape[0] * reduced_block(w.shape[2:], w.axes[2:])
    head = specs.get("lm_head")
    if head is not None:
        floor += reduced_block(head.shape[1:], head.axes[1:])
    else:
        floor += reduced_block(table[:1], specs["embed"].axes[:1])
    return floor


@pytest.mark.parametrize("arch", ONE_TOKEN_ARCHS)
def test_one_token_decode_within_the_references_band(arch, one_token_reference):
    """A one-token decode at batch 1 keeps every FSDP weight in its block:
    re-laying them onto an output dimension (an all-to-all a weight, then
    the output gathered back) breaks the ceiling and the no-all-to-all
    rule. Its wire at most the reference's, at least the floor from the
    shapes."""
    cfg = reduced(get_config(arch), dtype="bfloat16")
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    fn, args = D.build_program(cfg, ShapeCase("decode", SEQ, 1, "decode"), mesh, TrainConfig())
    _, colls, _, _ = D.run_program(fn, args, mesh)
    ref = one_token_reference()[f"{arch}:decode"]
    ref_colls = CollectiveStats(ref["bytes_by_type"], ref["count_by_type"])
    assert colls.count_by_type["all-to-all"] == 0, (arch, colls.count_by_type)
    assert colls.wire_bytes <= ref_colls.wire_bytes, (arch, colls.wire_bytes / ref_colls.wire_bytes)
    floor = _one_token_wire_floor(cfg)
    assert colls.wire_bytes >= floor, (arch, colls.wire_bytes, floor)


@pytest.mark.parametrize("kind", ("forward", "train"))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_dispatch_memory_within_the_references_band(arch, kind, moe_reference):
    full = get_config(arch)
    cfg = reduced(full, dtype="bfloat16", n_experts=full.n_experts,
                  experts_per_token=full.experts_per_token)
    mesh, train = make_fake_mesh((2, 2), ("data", "model")), kind == "train"
    p = param_structs(M._moe_specs(cfg, 1), torch.bfloat16, mesh, requires_grad=train)
    x = struct(mesh, ("batch", None, None), (MOE_BATCH, MOE_SEQ, cfg.d_model), torch.bfloat16,
               requires_grad=train)

    def forward(p, x):
        return layers.moe_block({k: v[0] for k, v in p.items()}, x, cfg)

    def grads(p, x):
        y, aux = forward(p, x)
        return torch.autograd.grad(torch.mean(torch.square(y.float())) + aux, [*p.values(), x])

    cost, _, got, _ = D.run_program(grads if train else forward, (p, x), mesh)
    ref = moe_reference()[f"{arch}:{kind}"]
    assert got["argument_bytes"] == ref["argument_bytes"], (arch, kind)
    assert got["temp_bytes"] <= 1.25 * ref["temp_bytes"], (
        arch, kind, got["temp_bytes"] / ref["temp_bytes"])
    # the gather-back is partitioned: no rank holds the whole expert output
    # with its zero row (the reference pins it replicated)
    whole = [cfg.n_experts * layers.moe_capacity(MOE_BATCH * MOE_SEQ, cfg) + 1, cfg.d_model]
    assert not [b for b in cost.peak_buffers() if b[2] == whole], (arch, kind, cost.peak_buffers())


def _within_the_references_band(tag, got: dict, wire: float, ref: dict) -> None:
    """Argument bytes equal, temp and wire bytes at most 1.25x the
    reference's."""
    assert got["argument_bytes"] == ref["argument_bytes"], tag
    assert got["temp_bytes"] <= 1.25 * ref["temp_bytes"], (
        tag, got["temp_bytes"] / ref["temp_bytes"])
    assert wire <= 1.25 * ref["wire_bytes"], (tag, wire / ref["wire_bytes"])


@pytest.mark.parametrize("arch", EMBED_ARCHS)
def test_embedding_dominated_decode_within_the_references_band(arch, parts_reference):
    """A table gathered whole onto every rank (each rank's lookup in the
    replicated table) breaks the band: the reference's lookup stays
    vocab-parallel."""
    cfg = reduced(get_config(arch), dtype="bfloat16", vocab_size=EMBED_VOCAB)
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    fn, args = D.build_program(cfg, ShapeCase("decode", EMBED_SEQ, EMBED_BATCH, "decode"), mesh,
                               TrainConfig())
    _, colls, got, _ = D.run_program(fn, args, mesh)
    if cfg.is_attention_free:  # XLA drops the decode position (int32) that nothing reads
        got = dict(got, argument_bytes=got["argument_bytes"] - 4)
    _within_the_references_band((arch, "decode"), got, colls.wire_bytes,
                                parts_reference()[f"{arch}:decode"])


@pytest.mark.parametrize("kind", ("forward", "train"))
def test_ssm_block_within_the_references_band(kind, parts_reference):
    """The in_proj output cut at columns that are not its shards' edges
    (gathered whole onto every rank, and the conv, norm and gate after it
    run replicated) breaks the band: the reference keeps the heads split."""
    cfg = reduced(get_config("mamba2-2.7b"), dtype="bfloat16")
    mesh, train = make_fake_mesh((2, 2), ("data", "model")), kind == "train"
    p = param_structs(M._ssm_specs(cfg, 1), torch.bfloat16, mesh, requires_grad=train)
    x = struct(mesh, ("batch", None, None), (SSM_BATCH, SSM_SEQ, cfg.d_model), torch.bfloat16,
               requires_grad=train)

    def forward(p, x):
        return ssm.ssm_block({k: v[0] for k, v in p.items()}, x, cfg, use_kernel=False)

    def grads(p, x):
        y = forward(p, x)
        return torch.autograd.grad(torch.mean(torch.square(y.float())), [*p.values(), x])

    _, colls, got, _ = D.run_program(grads if train else forward, (p, x), mesh)
    _within_the_references_band(("ssm", kind), got, colls.wire_bytes,
                                parts_reference()[f"ssm:{kind}"])


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
        """The largest |difference| of the outputs (each output of a tuple),
        and of the gradients, each over the plain op's largest |value|."""
        parts = [distribute_tensor(t, dm, p).detach().requires_grad_(t.is_floating_point())
                 for t, p in zip(tensors, placements)]
        whole = [t.clone().requires_grad_(t.is_floating_point()) for t in tensors]
        with meshctx.use_mesh(mesh):
            got = fn(*parts)
        want = fn(*whole)
        got = [o.full_tensor() for o in (got if isinstance(got, tuple) else (got,))]
        want = want if isinstance(want, tuple) else (want,)
        sum((o * o).sum() for o in got).backward()
        sum((o * o).sum() for o in want).backward()
        grads = [((p.grad.full_tensor() - w.grad).abs().max() / w.grad.abs().max()).item()
                 for p, w in zip(parts, whole) if w.grad is not None]
        return (max(((o - w).abs().max() / w.abs().max()).item() for o, w in zip(got, want)),
                max(grads))

    x = torch.randn(4, 6, 8, generator=g)
    heads, rows = ("batch", None, "ssm_heads", None), ("batch", None, None, None)
    table, tokens = torch.randn(96, 8, generator=g), torch.randint(0, 96, (4, 6), generator=g)
    codes = torch.randint(0, 48, (4, 6, 4), generator=g)
    take_targets = torch.cat([torch.tensor([12, 0, 11]), torch.randint(0, 13, (21,), generator=g)])
    vocab, by_rows = ([Shard(1), Shard(0)],), [Shard(0), Replicate()]

    def tied(t, i):
        return sharding.project("bsd,dv->bsv", sharding.lookup_rows(t, i), t.T)
    # reduced mamba2-2.7b in float32, as the model initialises it: 8 SSM
    # heads of 8 over "model", 4 a rank
    ssm_cfg = reduced(get_config("mamba2-2.7b"), d_model=32, ssm_state=4, ssm_head_dim=8,
                      ssm_chunk=4)
    specs = M._ssm_specs(ssm_cfg, 1)
    ssm_names = sorted(specs)
    ssm_params = [v[0] for _, v in sorted(init_params(specs, g, device="cpu").items())]
    ssm_placed = [list(sharding.named_sharding(mesh, specs[k].axes[1:], specs[k].shape[1:])[1])
                  for k in ssm_names]
    ssm_x = torch.randn(4, 8, ssm_cfg.d_model, generator=g)
    conv = torch.randn(4, ssm_cfg.ssm_conv_width - 1,
                       ssm_cfg.d_inner + 2 * ssm_cfg.ssm_n_groups * ssm_cfg.ssm_state, generator=g)
    # float64, so that the step's float32 read of it is a copy (as of a
    # bf16 cache) and its write in place leaves the graph whole
    state = torch.randn(4, ssm_cfg.ssm_heads, ssm_cfg.ssm_head_dim, ssm_cfg.ssm_state,
                        generator=g, dtype=torch.float64)
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
        # 24 rows into 4 experts' 3 slots (target 12: dropped, some rows
        # added twice); rows split over "data" or whole, targets whole
        **{f"scatter_rows {name}": both(
            lambda t, d: sharding.scatter_rows((4, 3, 5), t, d, ("experts",)),
            (torch.randint(0, 13, (24,), generator=g), torch.randn(24, 5, generator=g)),
            ([Replicate(), Replicate()], rows))
           for name, rows in (("rows split", [Shard(0), Replicate()]),
                              ("rows whole", [Replicate(), Replicate()]))},
        # a one-token decode's row, whole over "data" (one row cannot
        # split), against FSDP weights whose "embed" rows "data" splits: x
        # cut to the weight's block, the output a partial sum ("one row");
        # a batch-1 prefill's 16 rows, whose partial output would move more
        # than the weight block, re-lay the weight instead ("prefill")
        **{f"project {name}": both(lambda a, w: sharding.project(eq, a, w),
                                   (torch.randn(*x_shape, generator=g),
                                    torch.randn(*w_shape, generator=g)),
                                   ([Replicate(), Replicate()], w_placed))
           for name, eq, x_shape, w_shape, w_placed in (
               ("one row", "bsd,dhk->bshk", (1, 1, 8), (8, 4, 5), [Shard(0), Shard(1)]),
               ("one row, w_down", "bsf,fd->bsd", (1, 1, 8), (8, 6), [Shard(1), Shard(0)]),
               ("one row, tied head", "bsd,dv->bsv", (1, 1, 8), (8, 12), [Shard(0), Shard(1)]),
               ("prefill", "bsd,dhk->bshk", (1, 16, 8), (8, 4, 5), [Shard(0), Shard(1)]))},
        # the MoE gather-back from a buffer of 4 experts' 3 slots split over
        # "model": 24 rows (target 12: dropped, zeros; some rows read
        # twice), split over "data" or whole
        **{f"take_rows {name}": both(
            lambda b, t: sharding.take_rows(b, t, ("experts",)),
            (torch.randn(4, 3, 5, generator=g), take_targets), ([Replicate(), Shard(0)], rows))
           for name, rows in (("rows split", [Shard(0), Replicate()]),
                              ("rows whole", [Replicate(), Replicate()]))},
        # the vocab-parallel lookup: a table of 96 rows split over "model"
        # and its columns over "data", 24 tokens split over "data"; alone,
        # and tied (its transpose the head, as mamba2, hymba and granite
        # tie theirs); musicgen's offset codebooks (4 of 48 rows each); and
        # 64 tokens against 12 rows, whose partial rows would move more
        # than the table: the table gathered
        "lookup_rows": both(sharding.lookup_rows, (table, tokens), (*vocab, by_rows)),
        "lookup_rows tied": both(tied, (table, tokens), (*vocab, by_rows)),
        "lookup_rows codebooks": both(
            lambda t, i: sharding.lookup_rows(t, i).sum(dim=2),
            (torch.randn(192, 8, generator=g), codes + torch.arange(4) * 48), (*vocab, by_rows)),
        "lookup_rows gathered, tied": both(
            tied, (table[:12], torch.randint(0, 12, (4, 16), generator=g)), (*vocab, by_rows)),
        # the Mamba-2 block and its decode step: in_proj's column groups
        # (z, x and dt over the heads' axis, B and C whole) against the one
        # product on plain tensors
        "ssm_block": both(lambda *t: ssm.ssm_block(dict(zip(ssm_names, t)), t[-1], ssm_cfg,
                                                   use_kernel=False),
                          (*ssm_params, ssm_x), (*ssm_placed, by_rows)),
        "ssm_decode": both(lambda *t: ssm.ssm_decode(
            dict(zip(ssm_names, t)), t[-3], ssm_cfg, t[-2].clone(), t[-1].clone()),
            (*ssm_params, ssm_x[:, :1], conv, state),
            (*ssm_placed, by_rows, by_rows, [Shard(0), Shard(1)])),
    }
    # each row has one rank that adds it and the others add zeros: the
    # lookup is exact (the count of entries that differ)
    with meshctx.use_mesh(mesh):
        rows = sharding.lookup_rows(distribute_tensor(table, dm, vocab[0]),
                                    distribute_tensor(tokens, dm, by_rows)).full_tensor()
    res["lookup_rows exact"] = [(rows != table[tokens]).sum().item(), 0.0]
    # and so is the gather-back, dropped targets included
    buf = torch.randn(4, 3, 5, generator=g)
    with meshctx.use_mesh(mesh):
        taken = sharding.take_rows(distribute_tensor(buf, dm, [Replicate(), Shard(0)]),
                                   distribute_tensor(take_targets, dm, by_rows),
                                   ("experts",)).full_tensor()
    want = torch.cat([buf.reshape(12, 5), buf.new_zeros(1, 5)])[take_targets]
    res["take_rows exact"] = [(taken != want).sum().item(), 0.0]
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
    res = json.loads(out.read_text())
    for name, (value, grad) in res.items():
        assert value <= 1e-6 and grad <= 1e-6, (name, value, grad)
    assert res["lookup_rows exact"][0] == 0
    assert res["take_rows exact"][0] == 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--values-rank", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    _values_rank(a.values_rank, a.port, a.out)

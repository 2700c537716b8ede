"""The port's dry-run against the JAX package's, on the CPU.

Pure arithmetic is held equal to the reference's exactly: the analytic HBM
model over every config, shape, optimizer, mesh size and weight width;
`quantized_bytes`; the shapes, long-context variants and program names.
The structs are held to the reference's in tests/test_torch_dryrun_structs.py,
and every family goes through the dry-run in
tests/test_torch_dryrun_families.py. The optimizer structs against the
port's optimizers' own state. The counters: wire bytes, the collectives of a hand-written 4-rank program,
roofline dominance at the card's constants, fake-tensor runs against real
ones at 2x2, the single-rank mesh against FlopCounterMode on the plain
program, and the two-depth probe against the direct count.
"""
import dataclasses
import json

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import hbm_model as j_hbm
from repro.launch import specs as j_specs
from repro.launch import hlo_analysis as j_hlo
from repro.launch.hlo_analysis import CollectiveStats as JCollectiveStats
from repro.models import model as JM
from repro.models import quant as j_quant

from repro_torch.common import sharding
from repro_torch.common.meshctx import cost_analysis_dict
from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch import hbm_model, hlo_analysis, specs, state_specs
from repro_torch.models import model as M
from repro_torch.models.config import reduced
from repro_torch.launch.mesh import fake_world, make_fake_mesh
from repro_torch.models.quant import quantized_bytes
from repro_torch.training.train_step import TrainConfig

ARCHS = sorted(ARCHITECTURES)


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """The fake process groups this module makes are torn down after it."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


# ------------------------------------------------------- pure arithmetic


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_hbm_bytes_equals_reference(arch):
    for name in specs.SHAPES:
        shape, j_shape = specs.SHAPES[name], j_specs.SHAPES[name]
        cfg = specs.variant_for_shape(get_config(arch), shape)
        j_cfg = j_specs.variant_for_shape(j_get_config(arch), j_shape)
        kinds = [("train", "adamw"), ("train", "adafactor"), ("prefill", "adamw"),
                 ("decode", "adamw")]
        for kind, opt in kinds:
            for chips, shards in ((256, 16), (512, 16), (1, 1)):
                for wb in (2.0, 1.07):
                    args = (kind, shape.global_batch, shape.seq_len, chips, shards, opt)
                    got = hbm_model.analytic_hbm_bytes(cfg, *args, weight_bytes=wb)
                    want = j_hbm.analytic_hbm_bytes(j_cfg, *args, weight_bytes=wb)
                    assert got == want, (arch, name, kind, opt, chips, wb)


@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_bytes_equals_reference(arch):
    assert quantized_bytes(M.make_specs(get_config(arch))) == j_quant.quantized_bytes(
        JM.make_specs(j_get_config(arch)))


def test_shapes_variants_and_programs_equal_reference():
    assert {k: dataclasses.asdict(v) for k, v in specs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in j_specs.SHAPES.items()}
    assert specs.LONG_CONTEXT_WINDOW == j_specs.LONG_CONTEXT_WINDOW
    for arch in ARCHS:
        for name in specs.SHAPES:
            got = specs.variant_for_shape(get_config(arch), specs.SHAPES[name])
            want = j_specs.variant_for_shape(j_get_config(arch), j_specs.SHAPES[name])
            assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, name)
    for kind in ("train", "prefill", "decode"):
        assert specs.program_for(kind) == j_specs.program_for(kind)


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


def test_opt_state_structs_match_the_port_optimizers_init():
    """The dry-run's optimizer structs have exactly the shapes and dtypes
    of the port's optimizers' real state (reduced granite-3-8b)."""
    from repro_torch import optim

    cfg = reduced(get_config("granite-3-8b"))
    pspecs = M.make_specs(cfg)
    params = M.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for name, opt in (("adamw", optim.adamw(1e-3)), ("adafactor", optim.adafactor(1e-3)),
                      ("sgd", optim.sgd(1e-3, momentum=0.9))):
        structs = state_specs.opt_state_structs(name, pspecs, mesh=None)
        real = opt.init(params)
        s_leaves, r_leaves = list(_leaves(structs)), list(_leaves(real))
        assert [p for p, _ in s_leaves] == [p for p, _ in r_leaves], name
        for (path, s), (_, r) in zip(s_leaves, r_leaves):
            assert (tuple(s.shape), s.dtype) == (tuple(r.shape), r.dtype), (name, path)


# ------------------------------------------------------------- counters


def test_wire_bytes_weigh_as_the_reference():
    by = {"all-gather": 16 * 512 * 2, "all-reduce": 1024 * 4, "all-to-all": 2 * 8 * 64 * 4,
          "collective-permute": 16 * 2, "reduce-scatter": 96}
    counts = {k: 1 for k in by}
    got = hlo_analysis.CollectiveStats(dict(by), dict(counts))
    assert got.wire_bytes == JCollectiveStats(dict(by), dict(counts)).wire_bytes == \
        pytest.approx(2 * 1024 * 4 + 16 * 512 * 2 + 2 * 8 * 64 * 4 + 16 * 2 + 96)
    assert got.total_bytes == sum(by.values())
    assert hlo_analysis.COLLECTIVES == j_hlo._COLLECTIVES
    assert hlo_analysis._WIRE_WEIGHT == j_hlo._WIRE_WEIGHT


def test_collectives_from_trace_on_a_4_rank_program():
    """One all-gather, one all-reduce, one all-to-all and one send/recv
    pair: each counted once, by the bytes of its result buffer (the recv is
    the pair's other end, not a second permute)."""
    import torch.distributed as dist

    fake_world()
    group = dist.new_group([0, 1, 2, 3])
    x = torch.ones(3, 5)
    with hlo_analysis.collectives_from_trace() as stats:
        gathered = torch.empty(12, 5)
        dist.all_gather_into_tensor(gathered, x, group=group)
        dist.all_reduce(x, group=group)
        swapped = torch.empty(8, 2)
        dist.all_to_all_single(swapped, torch.ones(8, 2), group=group)
        dist.send(torch.ones(7), dst=1, group=group)
        dist.recv(torch.empty(7), src=1, group=group)
    assert stats.count_by_type == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 0,
                                   "all-to-all": 1, "collective-permute": 1}
    assert stats.bytes_by_type == {"all-reduce": 60, "all-gather": 240, "reduce-scatter": 0,
                                   "all-to-all": 64, "collective-permute": 28}
    assert stats.wire_bytes == 2 * 60 + 240 + 64 + 28


def test_dtensor_redistributions_count_under_the_reference_kinds():
    """Shard -> Replicate is an all-gather, Partial -> Shard a
    reduce-scatter, Shard(0) -> Shard(1) an all-to-all (the CPU group runs
    it as an all-gather and a chunk; it still counts once as all-to-all)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = make_fake_mesh((2, 2), ("data", "model"))
    x = sharding.struct(mesh, ("batch", None), (8, 6), torch.float32)
    p = DTensor.from_local(x.to_local(), mesh.device_mesh, [Shard(0), Partial()],
                           run_check=False, shape=x.shape, stride=x.stride())
    with sharding.fake_mode(), hlo_analysis.collectives_from_trace() as stats:
        x.redistribute(mesh.device_mesh, [Replicate(), Replicate()])
        x.redistribute(mesh.device_mesh, [Shard(1), Replicate()])
        p.redistribute(mesh.device_mesh, [Shard(0), Shard(1)])
    assert stats.count_by_type == {"all-reduce": 0, "all-gather": 1, "reduce-scatter": 1,
                                   "all-to-all": 1, "collective-permute": 0}
    assert stats.bytes_by_type["all-gather"] == 8 * 6 * 4  # the gathered tensor
    assert stats.bytes_by_type["reduce-scatter"] == 4 * 3 * 4  # this rank's block


def test_roofline_terms_dominance_at_the_cards_constants():
    assert hlo_analysis.HW["peak_flops"] == 989e12 and hlo_analysis.HW["hbm_bw"] == 3.35e12
    t = hlo_analysis.roofline_terms(989e12, 0.0, 0.0)  # 1 s of compute
    assert t["dominant"] == "compute" and t["compute_s"] == pytest.approx(1.0)
    t = hlo_analysis.roofline_terms(0.0, 3.35e12, 0.0)
    assert t["dominant"] == "memory" and t["memory_s"] == pytest.approx(1.0)
    t = hlo_analysis.roofline_terms(0.0, 0.0, 50e9)  # the NIC, which every axis crosses
    assert t["dominant"] == "collective" and t["collective_s"] == pytest.approx(1.0)
    t = hlo_analysis.roofline_terms(0.0, 0.0, 450e9, link_bw=hlo_analysis.HW["nvlink_bw"])
    assert t["collective_s"] == pytest.approx(1.0)


def _realize(tree, generator):
    """Real tensors in the layout of a struct tree: DTensors keep their
    placements, with seeded local blocks."""
    from torch.distributed.tensor import DTensor

    def real(x):
        if isinstance(x, DTensor):
            local = x.to_local()
            block = (torch.randn(tuple(local.shape), generator=generator).to(local.dtype)
                     if local.dtype.is_floating_point else torch.zeros(
                         tuple(local.shape), dtype=local.dtype))
            out = DTensor.from_local(block, x.device_mesh, x.placements, run_check=False,
                                     shape=x.shape, stride=x.stride())
            return out.detach().requires_grad_() if x.requires_grad else out
        t = (torch.randn(tuple(x.shape), generator=generator).to(x.dtype)
             if x.dtype.is_floating_point else torch.zeros(tuple(x.shape), dtype=x.dtype))
        return t.requires_grad_() if x.requires_grad else t

    if isinstance(tree, dict):
        return {k: _realize(v, generator) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_realize(v, generator) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_realize(v, generator) for v in tree)
    return real(tree)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b"])
def test_fake_run_counts_what_a_real_run_counts(arch):
    """At a 2x2 fake group the fake-tensor prefill's FLOPs, bytes and
    collectives equal the same program's on real CPU tensors of the same
    layout."""
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    cfg = reduced(get_config(arch), dtype="bfloat16")
    if D.needs_repeat_kv(cfg, mesh):
        cfg = dataclasses.replace(cfg, repeat_kv=True)
    shape = specs.ShapeCase("prefill", 32, 4, "prefill")
    fn, args = D.build_program(cfg, shape, mesh, TrainConfig())
    fake_cost, fake_colls, fake_mem, _ = D.run_program(fn, args, mesh)
    real_cost, real_colls, real_mem, _ = D.run_program(
        fn, _realize(args, torch.Generator().manual_seed(0)), mesh, fake=False)
    assert fake_cost.flops == real_cost.flops > 0
    assert fake_cost.bytes_accessed == real_cost.bytes_accessed
    assert fake_colls.count_by_type == real_colls.count_by_type
    assert fake_colls.bytes_by_type == real_colls.bytes_by_type
    # the same arguments and outputs; under DTensor a fake intermediate (a
    # collective's output) is sometimes released an op later than a real
    # one, so the fake peak may sit above the real one, never below
    for key in ("argument_bytes", "output_bytes", "alias_bytes"):
        assert fake_mem[key] == real_mem[key], key
    assert real_mem["temp_bytes"] <= fake_mem["temp_bytes"] <= 1.5 * real_mem["temp_bytes"]


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_one_rank_mesh_counts_what_flop_counter_mode_counts(kind):
    """On the (1, 1) mesh the dry-run's FLOPs equal FlopCounterMode's on the
    plain program (no DTensor, real CPU tensors): phase 16's premise."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = reduced(get_config("hymba-1.5b"), dtype="bfloat16", sliding_window=16)
    shape = specs.ShapeCase(kind, 32, 2, kind)
    mesh = make_fake_mesh((1, 1), ("data", "model"))
    fn, args = D.build_program(cfg, shape, mesh, TrainConfig(), remat=False)
    cost, colls, _, _ = D.run_program(fn, args, mesh)
    fn, args = D.build_program(cfg, shape, None, TrainConfig(), remat=False)
    plain = _realize(args, torch.Generator().manual_seed(0))
    with FlopCounterMode(display=False) as counter:
        fn(*plain)
    assert cost.flops == counter.get_total_flops() > 0
    assert cost_analysis_dict(fn, *plain)["flops"] == float(counter.get_total_flops())


def test_probe_extrapolation_equals_the_direct_count():
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    cfg = reduced(get_config("granite-3-8b"), dtype="bfloat16", n_layers=6)
    shape = specs.ShapeCase("prefill", 32, 4, "prefill")
    fn, args = D.build_program(cfg, shape, mesh, TrainConfig())
    cost, colls, _, _ = D.run_program(fn, args, mesh)
    probe = D.probe_corrected_costs(cfg, shape, mesh, TrainConfig())
    assert probe["probe_depths"] == [2, 4]
    assert probe["flops"] == cost.flops
    assert probe["bytes_accessed"] == cost.bytes_accessed
    assert probe["wire_bytes"] == colls.wire_bytes


# the keys of the reference's record (repro/launch/dryrun.py::run_one)
RECORD_KEYS = {"arch", "variant", "shape", "kind", "mesh", "policy", "moe_impl", "repeat_kv",
               "decode_attn", "quantize", "chips", "params", "active_params", "lower_s",
               "compile_s", "per_device", "hlo_raw", "probe", "collectives", "roofline",
               "model_flops_global", "useful_flops_ratio"}


def test_main_writes_a_record_with_the_reference_keys(tmp_path, capsys):
    """The launcher at full width on the single-rank mesh: hymba-1.5b's
    long_500k decode (the SSM state and a 1,024-slot window)."""
    D.main(["--arch", "hymba-1.5b", "--shape", "long_500k", "--mesh", "1x1",
            "--out", str(tmp_path)])
    assert "All dry-runs passed." in capsys.readouterr().out
    rec = json.loads((tmp_path / "hymba-1.5b__long_500k__1x1.json").read_text())
    assert RECORD_KEYS <= set(rec)
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes", "flops",
            "bytes_accessed", "hbm_bytes_analytic"} <= set(rec["per_device"])
    assert rec["probe"]["flops_matches_direct"] and rec["chips"] == 1
    assert rec["per_device"]["hbm_bytes_analytic"] == j_hbm.analytic_hbm_bytes(
        j_specs.variant_for_shape(j_get_config("hymba-1.5b"), j_specs.SHAPES["long_500k"]),
        "decode", 1, 524288, 1, 1, "adamw")
    assert rec["per_device"]["alias_bytes"] > 0  # the cache, written in place


def test_a_failing_program_prints_fail_and_exits_1(capsys, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("no rule")

    monkeypatch.setattr(D, "build_program", broken)
    with pytest.raises(SystemExit) as err:
        D.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k", "--mesh", "1x1",
                "--no-probe", "--out", "/nonexistent"])
    assert err.value.code == 1
    assert "FAIL qwen2.5-3b x decode_32k x 1x1: no rule" in capsys.readouterr().out

"""Every family through the dry-run: train, prefill and decode of each
reduced config (bf16) on fake tensors over a fake 2x2 ("data", "model")
mesh, under the "tp" policy.

At these widths every sharded dimension divides by 2 (d_model 256, 4
heads of 64 and 2 or 4 KV heads, the SSM's 16 heads of 32, 4 experts,
vocabularies of 512, batch 4), so no spec drops an axis and no config
takes the `repeat_kv` form; over the production mesh's 16 ranks some do
not (qwen2.5-3b's 2 KV heads, hymba-1.5b's 25 heads and 50 SSM heads),
and there the specs replicate them as the reference's do
(tests/test_torch_dryrun_structs.py), the attention takes `repeat_kv`,
and the views DTensor cannot split run replicated (`replicated_views`).
"""
import pytest
import torch

from repro_torch.configs import ARCHITECTURES, get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.hlo_analysis import COLLECTIVES
from repro_torch.launch.mesh import make_fake_mesh
from repro_torch.launch.specs import ShapeCase
from repro_torch.models.config import reduced
from repro_torch.training.train_step import TrainConfig


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    """The fake process group this module makes is torn down after it."""
    yield
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_every_family_gets_through_the_dry_run(arch, kind):
    mesh = make_fake_mesh((2, 2), ("data", "model"))
    cfg = reduced(get_config(arch), dtype="bfloat16")
    assert not D.needs_repeat_kv(cfg, mesh)
    fn, args = D.build_program(cfg, ShapeCase(kind, 64, 4, kind), mesh, TrainConfig())
    cost, colls, mem, _ = D.run_program(fn, args, mesh)
    assert cost.flops > 0 and cost.bytes_accessed > 0
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0
    assert set(colls.count_by_type) == set(COLLECTIVES)
    # the weights are sharded over both axes: FSDP gathers them at least
    assert colls.count_by_type["all-gather"] > 0
    if kind == "decode":
        assert mem["alias_bytes"] > 0  # the cache, written in place
    if kind == "train":  # new params and optimizer state
        assert mem["output_bytes"] > 0

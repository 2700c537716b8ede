"""The port's training path against the JAX package's, on the CPU.

For the eleven reduced configs of `tests/test_torch_models.py` (`CASES`:
hymba with and without GQA, qwen2.5-3b, granite-3-8b, stablelm-3b,
command-r-plus-104b, mamba2, dbrx and arctic (MoE), the
VLM with its gates open and seeded image embeddings, musicgen's
codebooks), one JAX parameter tree, its attention rescaled to a d_model
fan-in (`M.attention_at_d_model_fan_in`, as that file does: at the init's
own scale the softmax is one-hot up to near-ties), is carried across with
`convert` and the same batch goes through both packages:

* `loss_fn` (loss, ce, aux) and its gradients leaf by leaf, `jax.grad`
  against autograd, at that file's tolerances: 1e-4, or 1e-3 where an SSD
  scan is on the path; `remat=True` equal to `remat=False`;
* three `make_train_step` steps with AdamW, Adafactor and SGD on reduced
  hymba and dbrx against the JAX jitted step (params, grad_norm, loss);
* `choose_optimizer` on all ten full configs, by param count alone;
* `synthetic_lm_batches`, the Trainer's save/restore round trip (bf16
  params too), a JAX `Trainer` checkpoint continued by the port's
  `Trainer` on the JAX trajectory, and the two launchers with the same
  arguments (both started from one carried-across init).

The kernel ops' repair is here too: on their kernel path `flash_attention`
and `ssd_scan` raise when an input requires grad, and `forward`'s
`use_kernel` reaches both.
"""
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_models import CASES, _batches, _tokens

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.data import lm_data as jax_lm_data
from repro.launch import train as jax_launch_train
from repro.models import model as JM
from repro.models.config import reduced as jax_reduced
from repro.training import train_step as jax_train_step
from repro.training import trainer as jax_trainer
from repro_torch.configs import ARCHITECTURES
from repro_torch.convert import params_from_jax
from repro_torch.data import lm_data
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rope_heads.ops import rope_heads
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch import train as launch_train
from repro_torch.models import layers, model as M
from repro_torch.models.config import reduced
from repro_torch.models.params import tree_leaves
from repro_torch.optim.base import tree_map
from repro_torch.training import train_step, trainer

CPU = "cpu"
NO_BACKWARD = "the kernel has no backward"


def _jax_params(cfg, jcfg):
    return M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(
        cfg, JM.init(jcfg, jax.random.PRNGKey(0))))


def _port_params(jp):
    return tree_map(lambda t: t.requires_grad_(),
                    params_from_jax(jax.tree.map(np.asarray, jp), CPU))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced models' tensors are small: torch's intra-op threads only
    contend with the suite's other workers. One thread here, restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def pairs():
    """name -> (cfg, JAX cfg, JAX params, numpy params), built once."""
    out = {}
    for name, (arch, over, _) in CASES.items():
        cfg = reduced(ARCHITECTURES[arch], **over)
        jcfg = jax_reduced(JAX_ARCHITECTURES[arch], **over)
        jp = _jax_params(cfg, jcfg)
        out[name] = (cfg, jcfg, jp, jax.tree.map(np.asarray, jp))
    return out


def _close(got, ref, tol, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=tol, rtol=tol,
                               err_msg=what)


def _sorted_leaves(tree, prefix=""):
    """(path, leaf) in sorted-key order, a NamedTuple's fields in order, as
    `jax.tree.leaves` lists them."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _sorted_leaves(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, tuple):
        return [x for name, v in zip(tree._fields, tree)
                for x in _sorted_leaves(v, f"{prefix}/{name}")]
    return [(prefix, tree)]


def _grads(cfg, params, batch):
    loss, metrics = M.loss_fn(cfg, params, batch)
    leaves = [leaf for _, leaf in tree_leaves(params)]
    return loss, metrics, torch.autograd.grad(loss, leaves)


# ------------------------------------------------------------ loss and grads
@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(pairs, case):
    cfg, jcfg, jp, npp = pairs[case]
    tol = CASES[case][2]
    jb, tb = _batches(cfg, _tokens(cfg, seed=2), seed=2)
    (jloss, jm), jgrads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(jcfg, p, jb), has_aux=True))(jp)
    tp = _port_params(npp)
    loss, metrics, grads = _grads(cfg, tp, tb)
    assert set(metrics) == set(jm) == {"ce", "aux", "loss"}
    for key in metrics:
        assert metrics[key].dtype == torch.float32 and metrics[key].dim() == 0
        _close(metrics[key], jm[key], tol, key)
    assert (float(metrics["aux"].detach()) != 0.0) == (cfg.arch_type == "moe")
    _close(loss, jloss, tol, "loss")
    jflat = jax.tree.flatten_with_path(jgrads)[0]
    paths = [path for path, _ in tree_leaves(tp)]
    assert paths == ["/".join(k.key for k in p) for p, _ in jflat]
    for path, g, (_, jg) in zip(paths, grads, jflat):
        assert g is not None and g.shape == jg.shape, path
        _close(g, jg, tol, f"grad {path}")
    # every leaf gets a gradient: no path of the loss is cut (the VLM's
    # cross layers too, their gates open)
    assert [path for path, g in zip(paths, grads) if not bool(g.abs().max() > 0)] == []


@pytest.mark.parametrize("case", sorted(CASES))
def test_remat_changes_no_value(pairs, case):
    """cfg.remat checkpoints each self layer: the same loss and grads."""
    cfg, _, _, npp = pairs[case]
    _, tb = _batches(cfg, _tokens(cfg, seed=3), seed=3)
    loss, _, grads = _grads(cfg, _port_params(npp), tb)
    loss_r, _, grads_r = _grads(dataclasses.replace(cfg, remat=True), _port_params(npp), tb)
    torch.testing.assert_close(loss_r, loss, atol=1e-6, rtol=1e-6)
    for g, g_r in zip(grads, grads_r):
        torch.testing.assert_close(g_r, g, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------ the train step
# AdamW divides each gradient by its own RMS: a gradient that float32
# summation order leaves at ~1e-8, its sign undetermined, moves its weight
# by +-lr in either package (one embedding element of 131,072 in reduced
# dbrx does at lr 1e-3). At lr 1e-5 three such steps stay inside 1e-4;
# the moments, linear and quadratic in the gradient, are held at the same
# tolerance, and the normalised update itself at 1e-6 on equal gradients
# in test_torch_optim.py. Adafactor (factored statistics) and SGD do not
# amplify: their lrs move the params by more than the tolerance.
STEP_LR = {"adamw": 1e-5, "adafactor": 1e-3, "sgd": 1e-1}


@pytest.mark.parametrize("case", ["hymba", "dbrx"])
@pytest.mark.parametrize("opt", ["adamw", "adafactor", "sgd"])
def test_train_steps_match_jax(pairs, case, opt):
    """Three steps from one init over three batches: params, optimizer
    state, grad_norm and loss after each within the case's tolerance."""
    cfg, jcfg, jp, npp = pairs[case]
    tol = CASES[case][2]
    kw = dict(optimizer=opt, learning_rate=STEP_LR[opt], warmup_steps=1, total_steps=10)
    jstep, jopt = jax_train_step.make_train_step(jcfg, jax_train_step.TrainConfig(**kw))
    tstep, topt = train_step.make_train_step(cfg, train_step.TrainConfig(**kw))
    jstep = jax.jit(jstep)
    tp = _port_params(npp)
    js, ts = jopt.init(jp), topt.init(tp)
    assert type(ts).__name__ == type(js).__name__
    for i in range(3):
        jb, tb = _batches(cfg, _tokens(cfg, seed=10 + i), seed=10 + i)
        jp, js, jm = jstep(jp, js, jb)
        tp, ts, tm = tstep(tp, ts, tb)
        assert set(tm) == set(jm) == {"ce", "aux", "loss", "grad_norm"}
        for key in tm:
            _close(tm[key], jm[key], tol, f"step {i + 1} {key}")
        jstate = jax.tree.flatten_with_path(js)[0]
        tstate = _sorted_leaves(ts)
        assert len(jstate) == len(tstate)
        for (path, t), (_, j) in zip(tstate, jstate):
            assert t.shape == j.shape and str(t.dtype) == f"torch.{j.dtype}", path
            _close(t, j, tol, f"step {i + 1} state {path}")
        for (path, t), jleaf in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            assert t.requires_grad and t.is_leaf, path
            _close(t, jleaf, tol, f"step {i + 1} param {path}")
    moved = max(float((t.detach() - torch.from_numpy(np.array(a))).abs().max())
                for (_, t), a in zip(tree_leaves(tp), jax.tree.leaves(pairs[case][3])))
    assert moved > (2 * STEP_LR[opt] if opt == "adamw" else tol)


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_choose_optimizer_on_the_full_configs(arch):
    """Adafactor above 3e10 params, AdamW below, as the reference picks,
    from `param_count()` alone: nothing is allocated."""
    cfg, jcfg = ARCHITECTURES[arch], JAX_ARCHITECTURES[arch]
    tc, jtc = train_step.TrainConfig(), jax_train_step.TrainConfig()
    assert train_step.ADAFACTOR_THRESHOLD == jax_train_step.ADAFACTOR_THRESHOLD
    ours = train_step.choose_optimizer(cfg, tc).init.__qualname__.split(".")[0]
    theirs = jax_train_step.choose_optimizer(jcfg, jtc).init.__qualname__.split(".")[0]
    assert ours == theirs == ("adafactor" if cfg.param_count() > 30_000_000_000 else "adamw")
    with pytest.raises(ValueError, match="unknown optimizer"):
        train_step.choose_optimizer(cfg, train_step.TrainConfig(optimizer="lion"))


# ------------------------------------------------------------------ the data
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "dbrx-132b", "mamba2-2.7b", "hymba-1.5b",
                                  "llama-3.2-vision-90b", "musicgen-medium"])
def test_synthetic_lm_batches_match_jax(arch):
    """One arch a family: the first three batches equal, image embeddings
    and codebook frames included."""
    cfg = reduced(ARCHITECTURES[arch])
    data = lm_data.LMDataConfig(batch_size=2, seq_len=24, seed=5)
    ours = lm_data.synthetic_lm_batches(cfg, data)
    theirs = jax_lm_data.synthetic_lm_batches(
        jax_reduced(JAX_ARCHITECTURES[arch]), jax_lm_data.LMDataConfig(**dataclasses.asdict(data)))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


# ------------------------------------------------------------- the trainer
def _trainer_cfg(tmp_path, opt="auto", steps=2, dtype="float32"):
    cfg = reduced(ARCHITECTURES["hymba-1.5b"], sliding_window=16, dtype=dtype)
    tcfg = trainer.TrainerConfig(steps=steps, log_every=1, ckpt_dir=str(tmp_path),
                                 train=train_step.TrainConfig(optimizer=opt, learning_rate=1e-3,
                                                              warmup_steps=1))
    return cfg, tcfg


def _data(cfg, skip=0):
    it = lm_data.synthetic_lm_batches(cfg, lm_data.LMDataConfig(batch_size=2, seq_len=32))
    for _ in range(skip):
        next(it)
    return it


@pytest.mark.parametrize("opt,dtype", [("adamw", "float32"), ("adafactor", "bfloat16"),
                                       ("sgd", "float32")])
def test_trainer_save_restore_round_trip(tmp_path, opt, dtype):
    """A trainer saved after two steps and restored into a fresh one holds
    the same params and optimizer state bit for bit (bf16 params too), and
    both take the same third step."""
    cfg, tcfg = _trainer_cfg(tmp_path, opt, dtype=dtype)
    a = trainer.Trainer(cfg, tcfg, device=CPU)
    a.fit(_data(cfg), log=lambda _: None)
    a.save()
    b = trainer.Trainer(cfg, dataclasses.replace(tcfg, seed=1), device=CPU)
    b.restore()
    assert b.step == a.step == 2 and type(b.opt_state) is type(a.opt_state)
    fa, fb = (_sorted_leaves({"params": t.params, "opt_state": t.opt_state}) for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and torch.equal(x.detach(), y.detach()), path
    assert all(v.requires_grad for _, v in tree_leaves(b.params))
    a.tcfg = b.tcfg = dataclasses.replace(tcfg, steps=1)
    a.fit(_data(cfg, skip=2), log=lambda _: None)
    b.fit(_data(cfg, skip=2), log=lambda _: None)
    assert a.history[-1]["step"] == b.history[-1]["step"] == 3
    assert a.history[-1]["loss"] == b.history[-1]["loss"]


def test_restore_refuses_another_model(tmp_path):
    cfg, tcfg = _trainer_cfg(tmp_path)
    a = trainer.Trainer(cfg, tcfg, device=CPU)
    a.save()
    other = dataclasses.replace(cfg, d_ff=cfg.d_ff // 2)
    with pytest.raises(ValueError, match="checkpoint leaf"):
        trainer.Trainer(other, tcfg, device=CPU).restore()
    with pytest.raises(ValueError, match="does not match"):
        trainer.Trainer(cfg, dataclasses.replace(
            tcfg, train=dataclasses.replace(tcfg.train, optimizer="adafactor")),
            device=CPU).restore()


@pytest.fixture
def one_init(monkeypatch):
    """Both packages' `init` return one JAX init, rescaled as the parity
    tests rescale it, so a JAX trainer and the port's train one model."""
    def patch(cfg, jcfg):
        npp = jax.tree.map(np.asarray, M.attention_at_d_model_fan_in(
            cfg, JM.init(jcfg, jax.random.PRNGKey(0))))
        monkeypatch.setattr(JM, "init", lambda *_a, **_k: jax.tree.map(jnp.asarray, npp))
        monkeypatch.setattr(M, "init", lambda *_a, **_k: params_from_jax(npp, CPU))
    return patch


def test_jax_trainer_checkpoint_continues_in_the_port(tmp_path, one_init):
    """The JAX Trainer trains two steps and saves; the port's Trainer
    restores that file and takes steps 3 and 4 on the batches the JAX
    trainer took next: the same losses, grad norms and params."""
    cfg, tcfg = _trainer_cfg(tmp_path)
    jcfg = jax_reduced(JAX_ARCHITECTURES["hymba-1.5b"], sliding_window=16)
    one_init(cfg, jcfg)
    jtcfg = jax_trainer.TrainerConfig(
        steps=2, log_every=1, ckpt_dir=str(tmp_path),
        train=jax_train_step.TrainConfig(**dataclasses.asdict(tcfg.train)))
    jt = jax_trainer.Trainer(jcfg, jtcfg)
    jdata = jax_lm_data.synthetic_lm_batches(jcfg, jax_lm_data.LMDataConfig(batch_size=2,
                                                                            seq_len=32))
    jt.fit(jdata, log=lambda _: None)
    jt.save()
    jt.fit(jdata, log=lambda _: None)
    pt = trainer.Trainer(cfg, dataclasses.replace(tcfg, seed=7), device=CPU)
    pt.restore()
    assert pt.step == 2 and int(pt.opt_state.step) == 2
    pt.fit(_data(cfg, skip=2), log=lambda _: None)
    assert [m["step"] for m in pt.history] == [m["step"] for m in jt.history[2:]] == [3, 4]
    for ours, theirs in zip(pt.history, jt.history[2:]):
        for key in ("loss", "ce", "aux", "grad_norm"):
            assert abs(ours[key] - theirs[key]) <= 1e-3 * max(1.0, abs(theirs[key])), key
    for (path, t), j in zip(tree_leaves(pt.params), jax.tree.leaves(jt.params)):
        _close(t, j, 1e-3, f"param {path}")


def test_train_launcher_matches_jax(one_init, capsys):
    """`repro_torch.launch.train --device cpu` and `repro.launch.train`
    with the same arguments, from one init: the same logged steps and
    losses within 1e-3, the same closing line, and the loss falls."""
    arch = "hymba-1.5b"
    one_init(reduced(ARCHITECTURES[arch]), jax_reduced(JAX_ARCHITECTURES[arch]))
    argv = ["--arch", arch, "--smoke", "--steps", "12", "--batch-size", "2",
            "--seq-len", "64"]
    theirs = jax_launch_train.main(argv)
    jax_out = capsys.readouterr().out
    ours = launch_train.main(argv + ["--device", "cpu"])
    our_out = capsys.readouterr().out
    assert [m["step"] for m in ours] == [m["step"] for m in theirs] == [1, 10]
    for a, b in zip(ours, theirs):
        for key in ("loss", "ce", "grad_norm"):
            assert abs(a[key] - b[key]) <= 1e-3 * max(1.0, abs(b[key])), key
    assert ours[-1]["loss"] < ours[0]["loss"]
    line = re.compile(r"^loss (\d+\.\d{4}) -> (\d+\.\d{4}) \((-?\d+\.\d)% drop\)$", re.M)
    (ja, jb, _), (ta, tb, _) = line.findall(jax_out)[-1], line.findall(our_out)[-1]
    assert abs(float(ja) - float(ta)) <= 1e-3 and abs(float(jb) - float(tb)) <= 1e-3
    assert len(re.findall(r"^step +\d+ loss=", our_out, re.M)) == 2


# ---------------------------------------------------------------- the repair
def _requires_grad(*ts):
    return [t.clone().requires_grad_() for t in ts]


@pytest.mark.parametrize("which", ["flash_attention", "ssd_scan", "rope_heads"])
def test_kernel_path_raises_on_grad_requiring_inputs(which):
    """The kernels have no backward: on their path (here forced with
    use_kernel=True; on the card by the device) an input that requires
    grad raises before any device check, instead of a silent zero grad.
    Under no_grad the kernel path is taken as before (on CPU tensors it
    then refuses the device); the plain path differentiates."""
    g = torch.Generator().manual_seed(0)
    if which == "flash_attention":
        args = [torch.randn(4, 8, 16, generator=g) for _ in range(3)]
        op = lambda *a, **kw: flash_attention(*a, **kw)  # noqa: E731
    elif which == "rope_heads":
        args = [torch.randn(1, 8, n, 64, generator=g) for n in (4, 2, 2)]
        pos = torch.arange(8)[None]
        op = lambda *a, **kw: rope_heads(*a, pos, 1e4, **kw)  # noqa: E731
    else:
        args = [torch.randn(1, 32, 2, 8, generator=g), torch.rand(1, 32, 2, generator=g),
                torch.randn(2, generator=g), torch.randn(1, 32, 1, 4, generator=g),
                torch.randn(1, 32, 1, 4, generator=g)]
        op = lambda *a, **kw: ssd_scan(*a, 16, **kw)  # noqa: E731
    for i in range(len(args)):
        inputs = list(args)
        inputs[i] = inputs[i].clone().requires_grad_()
        with pytest.raises(ValueError, match=f"{which}: {NO_BACKWARD}.*use_kernel=False"):
            op(*inputs, use_kernel=True)
        with torch.no_grad(), pytest.raises(ValueError) as err:
            op(*inputs, use_kernel=True)  # reaches the kernel, which refuses CPU tensors
        assert NO_BACKWARD not in str(err.value)
    out = op(*_requires_grad(*args), use_kernel=False)
    out = out[0] if isinstance(out, tuple) else out
    assert out.requires_grad and out.grad_fn is not None


@pytest.mark.parametrize("case", ["hymba", "mamba2", "vlm"])
def test_forward_threads_use_kernel_to_both_ops(pairs, case):
    """forward(use_kernel=True) with grad-requiring params reaches the
    kernel ops' check: the attention block's rope_heads first in hymba and
    in the VLM's first (self-attention) layer, the scan in mamba2, the cross
    layer's flash attention in the VLM (called alone)."""
    cfg, _, _, npp = pairs[case]
    tp = _port_params(npp)
    _, tb = _batches(cfg, _tokens(cfg))
    first = "ssd_scan" if cfg.arch_type == "ssm" else "rope_heads"
    with pytest.raises(ValueError, match=f"{first}: {NO_BACKWARD}"):
        M.forward(cfg, tp, tb, use_kernel=True)
    if cfg.cross_attn_every:
        x = torch.zeros(1, 3, cfg.d_model)
        k = torch.zeros(1, cfg.n_image_tokens, cfg.n_kv_heads, cfg.hd)
        with pytest.raises(ValueError, match=f"flash_attention: {NO_BACKWARD}"):
            layers.cross_attn_block(M._layer(tp["cross"], 0), x, cfg, k, k, use_kernel=True)
    logits, _ = M.forward(cfg, tp, tb)  # on the CPU, None takes the plain versions
    assert logits.grad_fn is not None

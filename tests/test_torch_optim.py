"""The port's optimizer and the learned stages' training pieces against the
JAX package, at the same params carried across.

AdamW steps within 1e-6 (with and without weight decay: the reference
decays inside the update, `u -= lr * wd * p`, which `torch.optim.AdamW`
does not); Adafactor steps (factored and full statistics, float32 and
bfloat16 params) and SGD steps (with and without Nesterov) within 1e-6;
every learning-rate schedule within 1e-6 over steps 0-300; the InfoNCE and BCE (dropout 0) losses and their gradients
within 1e-5; triplet mining (numpy) exactly equal; the paper's parameter
counts. Inputs and params are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jax_optim
from repro.core import adapter as jax_adapter
from repro.core import reranker as jax_reranker
from repro_torch import optim
from repro_torch.core import adapter, reranker

TOL = dict(atol=1e-5, rtol=1e-5)


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(5,)) * scale).astype(np.float32),
            "inner": {"v": (rng.normal(size=(3,)) * scale).astype(np.float32)}}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return optim.tree_map(lambda a: torch.from_numpy(np.asarray(a).copy()), tree)


def _sorted_leaves(tree):
    """Leaves in sorted-key order, as `jax.tree.leaves` lists a dict's."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _sorted_leaves(tree[k])]
    return [tree]


def _assert_trees_close(t_tree, j_tree, **tol):
    jl = jax.tree.leaves(j_tree)
    tl = _sorted_leaves(t_tree)
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **tol)


# ------------------------------------------------------------------- adamw
@pytest.mark.parametrize("weight_decay", [0.0, 1e-4, 0.1])
def test_adamw_steps_match_jax(weight_decay):
    """Three steps from the same params and gradients: updates, moments and
    params within 1e-6 after each."""
    jopt = jax_optim.adamw(1e-3, weight_decay=weight_decay)
    topt = optim.adamw(1e-3, weight_decay=weight_decay)
    jp, tp = _to_jax(_tree(0)), _to_torch(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree(10 + step, scale=0.3)
        ju, js = jopt.update(_to_jax(g), js, jp)
        tu, ts = topt.update(_to_torch(g), ts, tp)
        _assert_trees_close(tu, ju, atol=1e-6, rtol=0)
        _assert_trees_close(ts.mu, js.mu, atol=1e-6, rtol=0)
        _assert_trees_close(ts.nu, js.nu, atol=1e-6, rtol=0)
        assert int(ts.step) == int(js.step) == step + 1
        jp, tp = jax_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _assert_trees_close(tp, jp, atol=1e-6, rtol=0)


def test_adam_is_adamw_without_decay():
    p, g = _to_torch(_tree(1)), _to_torch(_tree(2))
    a, b = optim.adam(1e-2), optim.adamw(1e-2)
    ua, _ = a.update(g, a.init(p), p)
    ub, _ = b.update(g, b.init(p), p)
    for x, y in zip(optim.base.tree_leaves(ua), optim.base.tree_leaves(ub)):
        assert torch.equal(x, y)


def test_global_norm_and_clip_match_jax():
    t = _tree(3)
    np.testing.assert_allclose(float(optim.global_norm(_to_torch(t))),
                               float(jax_optim.global_norm(_to_jax(t))), atol=1e-6)
    for max_norm in (0.5, 1e6):
        tc, tn = optim.clip_by_global_norm(_to_torch(t), max_norm)
        jc, jn = jax_optim.clip_by_global_norm(_to_jax(t), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), atol=1e-6)
        _assert_trees_close(tc, jc, atol=1e-6, rtol=0)


def test_schedule_callable_passes_through():
    sched = optim.as_schedule(lambda step: step.float() * 0.5)
    assert float(sched(torch.tensor(4))) == 2.0
    assert float(optim.as_schedule(3e-4)(torch.tensor(1))) == pytest.approx(3e-4)


# ------------------------------------------------ adafactor, sgd, schedules
def _mixed_tree(seed, dtype=np.float32, scale=1.0):
    """Leaves Adafactor factors ([7, 5], [2, 3, 4]) and keeps whole ([5],
    [1, 4]: an axis of 1, [3])."""
    rng = np.random.default_rng(seed)
    shapes = {"w": (7, 5), "b": (5,), "row": (1, 4), "stack": (2, 3, 4), "inner": {"v": (3,)}}

    def draw(shape):
        if isinstance(shape, dict):
            return {k: draw(v) for k, v in shape.items()}
        return (rng.normal(size=shape) * scale).astype(np.float32)

    tree = draw(shapes)
    if dtype == "bfloat16":
        tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), tree)
    return tree


def _mixed_to_torch(tree):
    from repro_torch.convert import params_from_jax
    return params_from_jax(tree, "cpu")


def _assert_sorted_close(t_tree, j_tree, tol=1e-6):
    """Leaf by leaf in sorted-key order (a NamedTuple's fields in order),
    shapes and dtypes equal, values within `tol`, absolute and relative
    (the second-moment statistics reach ~10, where a float32 ulp is ~1e-6)."""
    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        if isinstance(tree, tuple):
            return [x for v in tree for x in leaves(v)]
        return [tree]

    jl, tl = jax.tree.leaves(j_tree), leaves(t_tree)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert tuple(b.shape) == a.shape and str(b.dtype) == f"torch.{a.dtype}"
        np.testing.assert_allclose(b.detach().float().numpy(), np.asarray(a, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_adafactor_steps_match_jax(dtype):
    """Four steps of a warmup-cosine Adafactor: updates, the row / column
    (or full) statistics and the params after each within 1e-6."""
    sched_j = jax_optim.warmup_cosine(1e-2, 2, 6)
    sched_t = optim.warmup_cosine(1e-2, 2, 6)
    jopt, topt = jax_optim.adafactor(sched_j), optim.adafactor(sched_t)
    p0 = _mixed_tree(0, dtype)
    jp, tp = _to_jax(p0), _mixed_to_torch(p0)
    js, ts = jopt.init(jp), topt.init(tp)
    assert set(ts.stats["w"]) == {"vr", "vc"} and set(ts.stats["stack"]) == {"vr", "vc"}
    assert set(ts.stats["row"]) == {"v"} and set(ts.stats["b"]) == {"v"}
    assert tuple(ts.stats["stack"]["vr"].shape) == (2, 3)
    assert tuple(ts.stats["stack"]["vc"].shape) == (2, 4)
    for step in range(4):
        g = _mixed_tree(20 + step, scale=0.3 * (step + 1))
        ju, js = jopt.update(_to_jax(g), js, jp)
        tu, ts = topt.update(_mixed_to_torch(g), ts, tp)
        _assert_sorted_close(tu, ju)
        _assert_sorted_close(ts, js)
        assert int(ts.step) == int(js.step) == step + 1
        jp, tp = jax_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _assert_sorted_close(tp, jp)
        want = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        assert all(x.dtype == want for x in optim.base.tree_leaves(tp))


def test_adafactor_clips_the_update_rms():
    """One huge gradient: the update's RMS is clip_threshold times lr."""
    p = {"w": torch.zeros(8, 6)}
    opt = optim.adafactor(1e-2, clip_threshold=1.0)
    u, _ = opt.update({"w": torch.full((8, 6), 1e6)}, opt.init(p), p)
    assert float(torch.sqrt(torch.mean(u["w"] ** 2))) == pytest.approx(1e-2, rel=1e-5)


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_steps_match_jax(nesterov):
    """Three momentum steps: updates, the float32 momentum and the params
    after each within 1e-6."""
    jopt = jax_optim.sgd(jax_optim.linear_warmup(0.1, 2), momentum=0.9, nesterov=nesterov)
    topt = optim.sgd(optim.linear_warmup(0.1, 2), momentum=0.9, nesterov=nesterov)
    jp, tp = _to_jax(_tree(0)), _to_torch(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(3):
        g = _tree(30 + step, scale=0.3)
        ju, js = jopt.update(_to_jax(g), js, jp)
        tu, ts = topt.update(_to_torch(g), ts, tp)
        _assert_trees_close(tu, ju, atol=1e-6, rtol=0)
        _assert_trees_close(ts.momentum, js.momentum, atol=1e-6, rtol=0)
        assert int(ts.step) == int(js.step) == step + 1
        jp, tp = jax_optim.apply_updates(jp, ju), optim.apply_updates(tp, tu)
        _assert_trees_close(tp, jp, atol=1e-6, rtol=0)


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("linear_warmup", (1e-3, 100)),
    ("linear_warmup", (1e-3, 0)),
    ("cosine_decay", (1e-3, 200)),
    ("cosine_decay", (1e-3, 200, 0.1)),
    ("warmup_cosine", (3e-4, 100, 300)),
    ("warmup_cosine", (1e-2, 10, 250, 1e-4)),
])
def test_schedules_match_jax(name, args):
    """Every schedule over steps 0-300 from an int32 step, float32 out."""
    jf, tf = getattr(jax_optim, name)(*args), getattr(optim, name)(*args)
    for step in range(301):
        t = tf(torch.tensor(step, dtype=torch.int32))
        assert t.dtype == torch.float32 and t.dim() == 0
        j = jf(jnp.asarray(step, jnp.int32))
        np.testing.assert_allclose(float(t), float(j), atol=1e-6, rtol=0, err_msg=str(step))


def test_clip_promotes_bf16_leaves_as_jax():
    """A bf16 leaf times the float32 scale comes back float32 in both."""
    g = {"w": jnp.asarray(np.full((4, 3), 2.0), jnp.bfloat16)}
    jc, _ = jax_optim.clip_by_global_norm(g, 1.0)
    tc, _ = optim.clip_by_global_norm({"w": torch.full((4, 3), 2.0, dtype=torch.bfloat16)}, 1.0)
    assert jc["w"].dtype == jnp.float32 and tc["w"].dtype == torch.float32
    np.testing.assert_allclose(tc["w"].numpy(), np.asarray(jc["w"]), atol=1e-7)


# ------------------------------------------------------------------ losses
def _adapter_params(seed=0):
    rng = np.random.default_rng(seed)
    d, h = adapter.DIM, adapter.HIDDEN
    return {"w1": (rng.normal(size=(d, h)) * np.sqrt(2.0 / d)).astype(np.float32),
            "b1": (rng.normal(size=(h,)) * 0.01).astype(np.float32),
            "w2": (rng.normal(size=(h, d)) * 0.05).astype(np.float32),
            "b2": (rng.normal(size=(d,)) * 0.01).astype(np.float32)}


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("adapt_tools", [True, False])
def test_info_nce_loss_and_grads_match_jax(adapt_tools):
    rng = np.random.default_rng(4)
    b, h, d = 16, 4, adapter.DIM
    q, pos = _unit(rng.normal(size=(b, d))), _unit(rng.normal(size=(b, d)))
    negs = _unit(rng.normal(size=(b, h, d)))
    params = _adapter_params()
    jl, jg = jax.value_and_grad(jax_adapter._info_nce)(
        _to_jax(params), jnp.asarray(q), jnp.asarray(pos), jnp.asarray(negs), 0.07, 1.0,
        adapt_tools)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tl = adapter._info_nce(tp, torch.from_numpy(q), torch.from_numpy(pos),
                           torch.from_numpy(negs), 0.07, 1.0, adapt_tools)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for name in params:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jg[name]), **TOL,
                                   err_msg=name)


def _mlp_params(seed=0):
    rng = np.random.default_rng(seed)
    out = {}
    for li, (din, dout) in enumerate(zip(reranker.LAYERS[:-1], reranker.LAYERS[1:])):
        out[f"w{li}"] = (rng.normal(size=(din, dout)) * np.sqrt(2.0 / din)).astype(np.float32)
        out[f"b{li}"] = (rng.normal(size=(dout,)) * 0.1).astype(np.float32)
    return out


def test_bce_loss_and_grads_match_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(64, reranker.LAYERS[0])).astype(np.float32)
    y = (rng.random(64) < 0.3).astype(np.float32)
    params = _mlp_params()
    jl, jg = jax.value_and_grad(jax_reranker._bce_loss)(
        _to_jax(params), jnp.asarray(x), jnp.asarray(y), None, 0.0)
    tp = {k: torch.from_numpy(v).requires_grad_(True) for k, v in params.items()}
    tl = reranker._bce_loss(tp, torch.from_numpy(x), torch.from_numpy(y), None, 0.0)
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), **TOL)
    for name in params:
        np.testing.assert_allclose(tp[name].grad.numpy(), np.asarray(jg[name]), **TOL,
                                   err_msg=name)


def test_mlp_dropout_draws_from_its_generator():
    """Dropout masks come from the generator: one seed gives one output,
    another seed another; dropout 0 (or no generator) is the plain forward."""
    params = {k: torch.from_numpy(v) for k, v in _mlp_params().items()}
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(64, 7)).astype(np.float32))
    exact = reranker.mlp_forward(params, x)
    a = reranker.mlp_forward(params, x, dropout=0.1, generator=torch.Generator().manual_seed(3))
    b = reranker.mlp_forward(params, x, dropout=0.1, generator=torch.Generator().manual_seed(3))
    c = reranker.mlp_forward(params, x, dropout=0.1, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, exact)
    assert torch.equal(reranker.mlp_forward(params, x, dropout=0.0,
                                            generator=torch.Generator()), exact)
    assert torch.equal(reranker.mlp_forward(params, x, dropout=0.1), exact)


# ----------------------------------------------------------------- triplets
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_mine_triplets_is_the_reference(masked, seed):
    rng = np.random.default_rng(7)
    q, t, d = 60, 30, 16
    qe, te = _unit(rng.normal(size=(q, d))), _unit(rng.normal(size=(t, d)))
    rel = (rng.random((q, t)) < 0.07).astype(np.float32)
    rel[:3] = 0.0
    mask = ((rng.random((q, t)) < 0.5) | (rel > 0)).astype(np.float32) if masked else None
    if masked:
        mask[3:6] = rel[3:6]  # too few negatives: these queries are skipped
    a = jax_adapter.mine_triplets(qe, te, rel, n_hard=4, candidate_mask=mask, seed=seed)
    b = adapter.mine_triplets(qe, te, rel, n_hard=4, candidate_mask=mask, seed=seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
        assert y.dtype == x.dtype
    assert len(b[0]) > 0


# ---------------------------------------------------------- params, init
def test_paper_parameter_counts():
    """§4.2: MLP [7,64,32,1] = 2,625 params; §4.3: adapter = 197,248."""
    g = torch.Generator().manual_seed(0)
    assert reranker.mlp_param_count(reranker.init_mlp(g)) == 2625
    assert adapter.adapter_param_count(adapter.init_adapter(g)) == 197248


def test_adapter_starts_as_identity():
    ad = adapter.init_adapter(torch.Generator().manual_seed(0))
    x = _unit(np.random.default_rng(0).normal(size=(5, 384)))
    y = adapter.adapter_apply(ad, torch.from_numpy(x)).numpy()
    assert np.allclose(x, y, atol=1e-6)


def test_init_scales_match_the_reference():
    """He-normal weights: the same std as the JAX init (sqrt(2 / din)),
    within sampling error, and zero biases."""
    g = torch.Generator().manual_seed(1)
    mlp = reranker.init_mlp(g)
    for li, din in enumerate(reranker.LAYERS[:-1]):
        w = mlp[f"w{li}"]
        assert abs(float(w.std()) / np.sqrt(2.0 / din) - 1) < 0.2
        assert float(mlp[f"b{li}"].abs().max()) == 0.0
    ad = adapter.init_adapter(g)
    assert abs(float(ad["w1"].std()) / np.sqrt(2.0 / adapter.DIM) - 1) < 0.02
    assert float(ad["w2"].abs().max()) == 0.0


def test_train_reranker_and_adapter_reduce_their_losses():
    """A few epochs on separable data: BCE falls; InfoNCE falls and the
    early-stopped adapter is never worse on validation than the identity."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(600, 7)).astype(np.float32)
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float32)
    _, losses = reranker.train_reranker(
        x, y, reranker.RerankerConfig(epochs=5, batch_size=64), device="cpu")
    assert losses[-1] < losses[0]
    q, t, d = 80, 20, adapter.DIM
    te = _unit(rng.normal(size=(t, d)))
    rel = np.zeros((q, t), np.float32)
    rel[np.arange(q), rng.integers(0, t, q)] = 1.0
    qe = _unit(rel @ te + 0.8 * rng.normal(size=(q, d)))
    trip = adapter.mine_triplets(qe[:60], te, rel[:60], n_hard=4)
    _, hist = adapter.train_adapter(qe[:60], te, trip, qe[60:], rel[60:],
                                    config=adapter.AdapterConfig(epochs=3, lr=1e-3),
                                    device="cpu")
    assert len(hist["loss"]) == 3 and hist["loss"][-1] < hist["loss"][0]
    assert len(hist["val_ndcg"]) == 4

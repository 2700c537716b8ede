"""The port's serving launcher against the JAX package's.

`repro.launch.serve.main` and `repro_torch.launch.serve.main` run with the
same arguments (the port on the CPU): bare, and with the route cache, the
learning step, trace export, the flight recorder and the obs server, on
each index backend (the port's `fused` for the JAX package's `pallas`).
Their printed results must be equal: router R@5 (under IVF held as
`tests/test_torch_index.py` holds the port's IVF against the JAX IVF:
within 0.005), the outcome-log count, the index stats, the route cache's
hit rate and counters, the learning plan and each stage's decision, the
live stages and the count of exported traces.

Every model family runs behind the launcher: `--arch` dbrx-132b,
arctic-480b, llama-3.2-vision-90b and musicgen-medium at `--smoke` print
the JAX launcher's results too (codebook prompts [1, 32, 4], zero image
embeddings, as the reference feeds them).

`generate`, the pool's per-request prefill and greedy decode, is held
against the JAX `prefill` + `decode_step` sequence on reduced hymba-1.5b,
qwen2.5-3b, dbrx-132b, arctic-480b, llama-3.2-vision-90b (gates opened,
zero image embeddings, as the launcher feeds) and musicgen-medium (frames
of 4 codebook ids)
in float32, the parameters carried across with `repro_torch.convert`:
equal greedy tokens and every step's logits within the tolerances of
`tests/test_torch_models.py` (1e-4 attention-only, 1e-3 with the SSD
scan). A normal exit leaves no obs server port or telemetry thread alive.
"""
import contextlib
import io
import re
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHITECTURES
from repro.launch import serve as jax_serve
from repro.models import model as JM
from repro.models.config import reduced as jax_reduced
from repro_torch.configs import ARCHITECTURES
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.config import reduced

SMALL = ["--smoke", "--requests", "3", "--max-new-tokens", "2", "--n-tools", "40",
         "--n-queries", "120"]
JAX_BACKEND = {"dense": "dense", "fused": "pallas", "ivf": "ivf"}


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def _results(text):
    """The printed results that do not depend on the clock (the health line
    does: an SLO may burn on a slow first batch)."""
    got = serve.printed_results(text)
    for key in ("serve_s", "selection_ms", "health"):
        got.pop(key)
    return got


@pytest.mark.parametrize("backend", ["dense", "fused", "ivf"])
@pytest.mark.parametrize("wired", ["bare", "wired"])
def test_launcher_prints_the_jax_results(backend, wired, tmp_path):
    extra = []
    if wired == "wired":
        extra = ["--route-cache", "--learn", "--metrics-port", "0", "--trace-every", "1"]
    argv = {side: SMALL + extra for side in ("jax", "port")}
    if wired == "wired":
        for side in argv:
            argv[side] = argv[side] + ["--trace-export", str(tmp_path / f"{side}.jsonl"),
                                       "--dump-dir", str(tmp_path / f"{side}-dumps")]
    theirs = _results(_run(jax_serve.main, argv["jax"] + ["--backend", JAX_BACKEND[backend]]))
    ours = _results(_run(serve.main, argv["port"] + ["--backend", backend, "--device", "cpu"]))
    want = {"r5", "outcomes", "index", "decisions"}
    if wired == "wired":
        want |= {"cache", "plan", "live stages", "traces"}
        assert ours["traces"] == 1 and len(ours["decisions"]) == 2
    assert want <= set(ours) and set(ours) == set(theirs)
    if backend == "ivf":
        assert abs(ours.pop("r5") - theirs.pop("r5")) <= 0.005
    assert ours == theirs


@pytest.mark.parametrize("arch", ["arctic-480b", "dbrx-132b", "llama-3.2-vision-90b",
                                  "musicgen-medium"])
def test_launcher_prints_the_jax_results_for_each_family(arch):
    argv = SMALL + ["--arch", arch]
    theirs = _results(_run(jax_serve.main, argv))
    ours = _results(_run(serve.main, argv + ["--device", "cpu"]))
    assert {"r5", "outcomes", "index", "decisions"} <= set(ours) and ours == theirs


GENERATE_CASES = {"hymba-1.5b": 1e-3, "qwen2.5-3b": 1e-4, "dbrx-132b": 1e-4,
                  "arctic-480b": 1e-4, "llama-3.2-vision-90b": 1e-4, "musicgen-medium": 1e-4}


@pytest.fixture(scope="module")
def pool_pairs():
    """name -> (port cfg, JAX cfg, JAX params, port params), reduced, float32;
    the VLM's gates opened."""
    out = {}
    for name in GENERATE_CASES:
        cfg, jcfg = reduced(ARCHITECTURES[name]), jax_reduced(JAX_ARCHITECTURES[name])
        jp = M.open_cross_gates(cfg, M.attention_at_d_model_fan_in(
            cfg, JM.init(jcfg, jax.random.PRNGKey(0))))
        out[name] = (cfg, jcfg, jp, params_from_jax(jax.tree.map(np.asarray, jp), "cpu"))
    return out


@pytest.mark.parametrize("arch,tol", list(GENERATE_CASES.items()))
def test_generate_matches_the_jax_sequence(pool_pairs, arch, tol):
    cfg, jcfg, jp, tp = pool_pairs[arch]
    n_new = 6
    rng = np.random.default_rng(0)
    shape = (1, serve.PROMPT_LEN) + ((cfg.n_codebooks,) if cfg.n_codebooks else ())
    prompt = rng.integers(0, cfg.vocab_size, shape)
    jbatch = {"tokens": jnp.asarray(prompt, jnp.int32)}
    if cfg.cross_attn_every:  # the JAX launcher's zero image embeddings
        jbatch["image_embeds"] = jnp.zeros((1, cfg.n_image_tokens, cfg.d_model))
    tokens, logits = serve.generate(cfg, tp, torch.from_numpy(prompt), n_new)
    # the JAX launcher's sequence
    jl, cache = JM.prefill(jcfg, jp, jbatch, max_cache_len=serve.MAX_CACHE_LEN)
    jsteps = [jl[:, -1:]]
    tok = jnp.argmax(jsteps[-1], axis=-1).astype(jnp.int32)
    jtokens = []
    for step in range(n_new):
        jtokens.append(np.asarray(tok).reshape(-1).tolist() if cfg.n_codebooks
                       else int(tok[0, 0]))
        if step == n_new - 1:
            break
        jl, cache = JM.decode_step(jcfg, jp, cache, {
            "token": tok, "pos": jnp.asarray(serve.PROMPT_LEN + step, jnp.int32)})
        jsteps.append(jl[:, -1:])
        tok = jnp.argmax(jsteps[-1], axis=-1).astype(jnp.int32)
    assert tokens == jtokens and len(tokens) == n_new
    assert len(logits) == n_new
    for step, (got, ref) in enumerate(zip(logits, jsteps)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=tol, rtol=tol,
                                   err_msg=f"step {step}")


def test_without_a_card_the_launcher_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(SMALL)  # --device defaults to cuda


def test_normal_exit_leaves_no_server_port_or_telemetry_thread(tmp_path):
    before = set(threading.enumerate())
    text = _run(serve.main, SMALL + ["--device", "cpu", "--metrics-port", "0",
                                     "--profile-daemons", "--dump-dir", str(tmp_path)])
    host, port = re.search(r"== obs: http://([0-9.]+):(\d+)\{", text).groups()
    alive = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not {"timeseries-ring", "obs-server", "sampling-profiler"} & set(alive), alive
    with pytest.raises(OSError):  # nothing listens on the server's port any more
        socket.create_connection((host, int(port)), timeout=2).close()


@pytest.mark.parametrize("backend", ["dense", "fused", "ivf"])
def test_launcher_warms_the_index_before_the_profiler_baseline(backend, monkeypatch):
    """The launcher hands the index every padded bucket up to --route-batch
    at k and at the re-ranker's k x 5 before its profiler's first collect,
    the baseline; on the CPU the warm-up launches nothing and counts
    nothing in the index stats."""
    from repro_torch.index.manager import ToolIndexManager
    from repro_torch.kernels.topk_sim import kernel as topk_kernel
    from repro_torch.obs.profile import JitProfiler

    calls = []
    warm, collect = ToolIndexManager.warm, JitProfiler.collect

    def recorded_warm(self, batch_size, ks):
        calls.append(("warm", batch_size, tuple(ks), dict(self.stats)))
        before = topk_kernel.launches
        warm(self, batch_size, ks)
        assert topk_kernel.launches == before
        calls[-1] += (dict(self.stats),)

    def recorded_collect(self):
        calls.append(("collect",))
        return collect(self)

    monkeypatch.setattr(ToolIndexManager, "warm", recorded_warm)
    monkeypatch.setattr(JitProfiler, "collect", recorded_collect)
    _run(serve.main, SMALL + ["--backend", backend, "--route-batch", "8", "--device", "cpu"])
    assert calls[0][:3] == ("warm", 8, (5, 25)) and calls[1] == ("collect",)
    assert calls[0][3] == calls[0][4]  # the index stats are unchanged

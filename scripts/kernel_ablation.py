#!/usr/bin/env python3
"""Time the port's cluster-route, wgmma-route and select-route topk_sim and
three-phase ssd_scan kernels with one part removed or replaced at a time, on
one NVIDIA card.

    python3 scripts/kernel_ablation.py

Run from the root of a checkout on a machine with a Hopper card and nvcc.
It copies `src/repro_torch/kernels/csrc/{topk_sim,ssd_scan}.cu`, in each
copy sets one loop bound or condition so that one part does no work, builds
every copy with nvcc into its own library under the ignored
`src/repro_torch/kernels/build/` (all builds at once), and times each at
the main paths' shapes: topk_sim's cluster route at Q=8 and Q=64 over
2,413 rows and Q=8 over 8,192 (k=25, D=384), its wgmma route's pass 1 at
Q=8 and Q=64 over 100,000 rows (k=5, D=384), its select route's two passes
at (Q, T, D, k) = (64, 2,413, 384, 130), (64, 100,000, 384, 130),
(8, 2,413, 1,536, 25) and (8, 100,003, 384, 130), with pass 2 also at every
cluster size for the full kernel, and each scan phase at hymba-1.5b's
layer shape (x 1x2048x50x64 bf16, N 16), as the profiler's device time per
launch (a launch alone is shorter than its host dispatch, so CUDA events
around back-to-back calls would time the host). A part's cost reads as the full
time less the time without it; parts overlap, so the differences need not
add up to the whole. The copies compute wrong results and are only timed,
but for the select route's "per-bin atomics", which computes the same
histograms as the kernel by one atomic per distinct bin a warp
(__match_any_sync) in place of a thread's runs.
Prints one line a variant and the card's name and power limit.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

# variant -> [(text, replacement)] in the kernel's source; each text occurs once
TOPK_PARTS = {
    "full": [],
    "no products": [("for (int j = 0; j < n_slices; ++j) {", "for (int j = 0; j < 0; ++j) {")],
    "no loads": [
        ("    for (int c = 0; c < min(stages, n_chunks); ++c) issue(c);\n", ""),
        ("    mbar_wait(bar0 + 8 * (c % stages), (c / stages) & 1);\n", ""),
        ("      issue(c + stages);\n", ""),
    ],
    "no offers": [("for (int ql = warp; ql < nq; ql += CWARPS) {",
                   "for (int ql = warp; ql < 0; ql += CWARPS) {")],
    "no merge": [("for (int ql = rank; ql < nq; ql += cs) {",
                  "for (int ql = rank; ql < 0; ql += cs) {")],
}
WGMMA_PARTS = {
    "full": [],
    "no filter": [("if (r < len && q < q_hi && !(a < thr[h & 1])) {", "if (false) {")],
    "no compaction": [
        ("          cand[q * CAND + slot] = pack_key(",
         "          if (slot < CAND) cand[q * CAND + slot] = pack_key("),
        ("if (c <= CAND - ROWS) continue;  // warp-uniform", "if (true) continue;"),
        ("    const int c0 = cnt[n];", "    const int c0 = min(cnt[n], CAND);"),
    ],
    "no end selection": [
        ("    const int c = prune(n, c0, fmaxf(vb[n], kth_candidate(n, c0)) - 2.f * margin(n));",
         "    const int c = c0;")],
    "no row norms": [("      for (int u = 0; u < 4; ++u) {  // rows past T and columns past D read as zeros",
                      "      for (int u = 0; u < 0; ++u) {")],
    "no rescore": [("for (int p = wt; p < total; p += 128) {\n      int n, i;",
                    "for (int p = wt; p < 0; p += 128) {\n      int n, i;")],
    "no exact offers": [
        ("      offer(lists + n * k, k, stage + warp * 128, c, lane, [&](int i) { return cand[n * CAND + i]; });\n"
         "      if (lane == 0) {\n        cnt[n] = 0;",
         "      if (lane == 0) {\n        cnt[n] = 0;")],
}
SELECT_PARTS = {
    "full": [],
    "no products": [("      for (int g = 0; g < G; ++g) {", "      for (int g = 0; g < 0; ++g) {")],
    "per-bin atomics": [
        ("        if (bin[u] == BINS) continue;\n        if (bin[u] == run_bin) {",
         "        const unsigned peers = __match_any_sync(FULL, bin[u]);\n"
         "        if (bin[u] < BINS && lane == __ffs(peers) - 1)\n"
         "          atomicAdd(&h[bin[u]], static_cast<unsigned>(__popc(peers)));\n"
         "        continue;\n        if (bin[u] == run_bin) {"),
    ],
}
SELECT_SHAPES = ((64, 2413, 384, 130), (64, 100_000, 384, 130), (8, 2413, 1536, 25),
                 (8, 100_003, 384, 130))
SSD_PARTS = {
    "full": [],
    "no M xd": [("for (int s = 0; s < r0 + 4; ++s) {", "for (int s = 0; s < 0; ++s) {")],
    "no C state^T": [("  for (int nn = 0; nn < n; ++nn) {\n    float cv[4], sv[NC];",
                      "  for (int nn = 0; nn < 0; ++nn) {\n    float cv[4], sv[NC];")],
    "no M": [("  if (tx <= ty) {", "  if (false) {")],
    "no global loads": [("if (base + u * THREADS < total) v[u] = load(base + u * THREADS);",
                         "v[u] = make_uint4(0, 0, 0, 0);")],
}


def build(kernel: str, variant: str, pairs) -> Path:
    from repro_torch.kernels import nvcc

    src = (nvcc.CSRC / f"{kernel}.cu").read_text()
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{kernel} / {variant}: {old!r} found {src.count(old)} times")
        src = src.replace(old, new)
    tag = variant.replace(" ", "_").replace("^", "")
    nvcc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = nvcc.BUILD_DIR / f"ablation_{kernel}_{tag}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(src)
    proc = subprocess.run([nvcc._nvcc(), *nvcc.NVCC_FLAGS, "-I", str(nvcc.CSRC), "-o", str(so),
                           str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {cu.name}:\n{proc.stdout}{proc.stderr}")
    return so


def device_ms(fn, kernel_name: str, iters: int = 50) -> float:
    """Device time per launch of the kernels whose name holds `kernel_name`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel_name in e.key)
    return total / 1e3 / iters


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.core.retrieval import NEG_INF
    from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
    from repro_torch.kernels.topk_sim import kernel as topk_kernel

    jobs = [("topk_sim", v, p) for v, p in TOPK_PARTS.items()]
    jobs += [("topk_sim", f"wgmma {v}", p) for v, p in WGMMA_PARTS.items()]
    jobs += [("topk_sim", f"select {v}", p) for v, p in SELECT_PARTS.items()]
    jobs += [("ssd_scan", v, p) for v, p in SSD_PARTS.items()]
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        libs = list(pool.map(lambda job: build(*job), jobs))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def unit(n, d):
        x = torch.randn((n, d), generator=gen, device=dev)
        return (x / x.norm(dim=1, keepdim=True)).contiguous()

    queries, table = unit(64, 384), unit(8192, 384)
    x = torch.randn((1, 2048, 50, 64), generator=gen, device=dev).to(torch.bfloat16)
    dt = 0.1 + 0.5 * torch.rand((1, 2048, 50), generator=gen, device=dev)
    a_log = torch.randn((50,), generator=gen, device=dev) * 0.5
    bm, cm = ((torch.randn((1, 2048, 1, 16), generator=gen, device=dev) * 0.3)
              .to(torch.bfloat16) for _ in range(2))
    scores = torch.empty((64, 25), device=dev)
    idx = torch.empty((64, 25), dtype=torch.int64, device=dev)
    # (library path, qb, stages) -> cluster size; keyed by path, not id(): a
    # freed library's id can come back for the next one, whose kernels would
    # then launch without the cluster attributes the plan sets
    plans = {}

    def cluster_call(lib, n_q, n_t, qb):
        stages = topk_kernel.cluster_stages(qb, 384, 25)
        key = (lib._name, qb, stages)
        if key not in plans:
            cs = ctypes.c_int(0)
            rc = lib.topk_sim_cluster_plan(0, qb, 384, 25, stages, ctypes.byref(cs))
            if rc or not cs.value:
                raise RuntimeError(f"cluster plan failed ({rc}, cs={cs.value})")
            plans[key] = cs.value
        rc = lib.topk_sim_cluster_launch(0, qb, plans[key], queries.data_ptr(), table.data_ptr(),
                                         n_q, n_t, 384, 25, stages, NEG_INF, scores.data_ptr(),
                                         idx.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    big = unit(100_000, 384)
    counter = torch.zeros(1, dtype=torch.int64, device=dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def wgmma_call(lib, n_q, k):
        n, n_split, rows, stages = topk_kernel.wgmma_plan(n_q, 100_000, 384, k, n_sms)
        coef, abs_coef = topk_kernel.margin_coefs(384)
        part = torch.empty((n_q, n_split, k), dtype=torch.int64, device=dev)
        rc = lib.topk_sim_wgmma_launch(0, n, queries.data_ptr(), big.data_ptr(), n_q, 100_000,
                                       384, k, n_split, rows, stages, coef, abs_coef, NEG_INF,
                                       part.data_ptr(), counter.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"launch failed: {rc}")

    select_inputs = {shape: (unit(shape[0], shape[2]), unit(shape[1], shape[2]))
                     for shape in SELECT_SHAPES}

    def select_calls(lib, shape, cs=None):
        """(pass 1, pass 2) of the select route at `shape` as select_plan
        sizes them, pass 2 at cluster size `cs` where given."""
        n_q, n_t, d, k = shape
        q, t = select_inputs[shape]
        plan = topk_kernel.select_plan(n_q, n_t, d, k, n_sms)
        if cs is not None:
            held = 8 * k if k <= topk_kernel.SEL_SMEM_KEYS else 0
            room = (topk_kernel.SMEM_OPT_IN - topk_kernel.SEL_FIXED_BYTES - held) // 4
            slice_keys = -(-n_t // cs)
            plan = plan._replace(cs=cs, cap=min(slice_keys, room),
                                 threads=1024 if slice_keys >= topk_kernel.SEL_BIG_SLICE else 512)
        sims = torch.empty((n_q, n_t), device=dev)
        out_s = torch.empty((n_q, k), device=dev)
        out_i = torch.empty((n_q, k), dtype=torch.int64, device=dev)

        def pass1():
            rc = lib.topk_sim_select_scores_launch(0, plan.bq, plan.br, plan.stages, q.data_ptr(),
                                                   t.data_ptr(), n_q, n_t, d, sims.data_ptr(),
                                                   stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        def pass2():
            rc = lib.topk_sim_select_topk_launch(0, plan.threads, plan.cs, plan.cap,
                                                 sims.data_ptr(), n_q, n_t, k,
                                                 topk_kernel.select_sort_len(k), sims.data_ptr(),
                                                 out_s.data_ptr(), out_i.data_ptr(), stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        pass1()
        return pass1, pass2

    for (kernel, variant, _), so in zip(jobs, libs):
        lib = ctypes.CDLL(str(so))
        getattr(lib, f"{kernel}_error_string").restype = ctypes.c_char_p
        if variant.startswith("wgmma"):
            topk_kernel._bind(lib)
            times = [f"Q={n_q} {device_ms(lambda: wgmma_call(lib, n_q, 5), 'topk_sim_wgmma'):.4f} ms"
                     for n_q in (8, 64)]
            print(f"topk_sim wgmma pass 1 T=100000 k=5, {variant[6:]}: " + ", ".join(times),
                  flush=True)
        elif variant.startswith("select"):
            topk_kernel._bind(lib)
            for shape in SELECT_SHAPES:
                pass1, pass2 = select_calls(lib, shape)
                print(f"topk_sim select Q,T,D,k={shape}, {variant[7:]}: pass 1 "
                      f"{device_ms(pass1, 'topk_sim_select_scores'):.4f} ms, pass 2 "
                      f"{device_ms(pass2, 'topk_sim_select_topk'):.4f} ms", flush=True)
                if variant == "select full":
                    times = [f"{cs} {device_ms(select_calls(lib, shape, cs)[1], 'topk_sim_select_topk'):.4f} ms"
                             for cs in (1, 2, 4, 8, 16)]
                    print(f"topk_sim select Q,T,D,k={shape}, pass 2 by cluster size: "
                          + ", ".join(times), flush=True)
        elif kernel == "topk_sim":
            topk_kernel._bind(lib)
            times = []
            for n_q, n_t in ((8, 2413), (64, 2413), (8, 8192)):
                qb = topk_kernel.cluster_qb(n_q)
                ms = device_ms(lambda: cluster_call(lib, n_q, n_t, qb), "topk_sim_cluster")
                times.append(f"Q={n_q} T={n_t} {ms:.4f} ms")
            print(f"topk_sim cluster, {variant}: " + ", ".join(times), flush=True)
            if variant == "full":  # the queries a cluster takes, at Q = 64
                times = [f"{qb} {device_ms(lambda: cluster_call(lib, 64, 2413, qb), 'topk_sim_cluster'):.4f} ms"
                         for qb in (8, 16, 32)]
                print("topk_sim cluster, Q=64 T=2413 by queries per block: " + ", ".join(times),
                      flush=True)
        else:
            ssd_kernel._bind(lib)
            ctx = ssd_kernel.prepare(x, dt, a_log, bm, cm, 256)
            ctx.lib = lib
            times = {phase: device_ms(lambda phase=phase: ssd_kernel.launch_phase(ctx, phase),
                                      f"ssd_scan_{phase}")
                     for phase in ssd_kernel.PHASES}
            print(f"ssd_scan, {variant}: " + ", ".join(f"{p} {t:.4f} ms" for p, t in times.items()),
                  flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Hopper CUDA kernels for fused similarity + top-K: build, binding, routing
and launch.

Replace the Pallas TPU kernel `repro/kernels/topk_sim/kernel.py::
topk_sim_pallas`. The source is `repro_torch/kernels/csrc/topk_sim.cu`
(its header says what bounds each kernel and how it is cut). `build()`
compiles it with nvcc for `sm_90a` into a shared library with a plain C
interface (`kernels/nvcc.py`), cached under `kernels/build/` by a hash of
the source, and loads it with ctypes. Nothing here runs at import: the CPU
tests import this module on machines with no nvcc and no card.

The source holds four routes, and `topk_route` picks one before launch
from shape and alignment: "cluster" (one launch; a thread-block cluster per
query block streams the table through shared memory with bulk copies and
merges its lists in distributed shared memory) for tables of up to
`CLUSTER_MAX_T` rows; "wgmma" (two launches: TF32 products on the tensor
cores fed by TMA filter the rows, the survivors are rescored in exact
float32, then the split route's merge) for larger tables with
WGMMA_MIN_Q <= Q <= 64 and Q * k <= WGMMA_MAX_QK (forced, it takes
Q <= 64 and k <= 32); and "split" (two launches: float32 FMAs over table
slices on the whole card, then a merge through a scratch tensor) for the
rest and for inputs the bulk copies cannot take; "select" (two launches:
register-tiled float32 FMA chains, fed by a ring of asynchronous copies,
write a [Q, T] score scratch; then a thread-block cluster a query runs a
32-bit radix select over the scores held in its blocks' shared memory,
takes the lowest rows among ties at the threshold, and ranks the k
survivors in its leader block; `select_plan` sizes both passes) only for
what the other three refuse, k > MAX_K or D > MAX_D: it takes any k <= T
and any D, as the Pallas kernel does. None falls back to another. The
wgmma and select routes return bitwise what the split route returns
where it can run.

`topk_sim_cuda` checks its inputs, allocates the outputs (and the two-pass
routes' scratch) with `torch.empty`, and launches on the current stream.
Each kernel launch adds one to `launches` and to `launches_by_route[route]`,
so a run can show that its main path went through the kernels, and through
which; the wgmma route also adds its rescored (query, row) pairs to a
counter on the card (`rescored()`). A launch the runtime refuses, a tensor
map that fails to encode, or a cluster that cannot be resident, raises.

What the process has compiled and loaded for this kernel is the live
counterpart of the reference's jit cache: the library (built and loaded
once) and each route's kernels, which CUDA loads lazily at the route's
first launch. `launched_routes` holds the routes launched so far, and
`PROBE._cache_size()` counts the library plus those routes; `repro_torch.obs.profile`
reads it through `router.gateway.hot_path_jits()`. `cost(n_q, n_t, d, k)`
is the call's analytic work, FLOPs and bytes, from its shapes alone.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Set, Tuple

import torch

from repro_torch.common.bucketing import pow2_bucket
from repro_torch.core.retrieval import NEG_INF
from repro_torch.kernels.nvcc import CudaLibrary, sm_count

__all__ = [
    "CLUSTER_MAX_T",
    "LIBRARY",
    "PROBE",
    "ROUTES",
    "WGMMA_MAX_K",
    "WGMMA_MAX_QK",
    "WGMMA_MIN_Q",
    "build",
    "build_info",
    "can_take",
    "cluster_qb",
    "cluster_stages",
    "cost",
    "launched_routes",
    "launches",
    "launches_by_route",
    "margin_coefs",
    "rescored",
    "reset_rescored",
    "SelectPlan",
    "select_plan",
    "select_sort_len",
    "split_plan",
    "topk_route",
    "topk_sim_cuda",
    "wgmma_plan",
    "wgmma_smem_bytes",
]

# the kernel's own limits and tile sizes; they must match topk_sim.cu
TB = 128  # table rows per tile of pass 1
MAX_K = 128
MAX_D = 1024
MAX_CAND = 4096  # n_split * k, merged in shared memory by pass 2
BLOCKS_PER_SM = 4  # pass 1's grid target
# the cluster route's
CR = 32  # table rows per ring chunk
CTILE = 128  # sc_s columns: rows offered to the lists at once
MAX_STAGES = 4  # ring depth
BAR_BYTES = 128
CWARPS = 8  # warps a block
MAX_CS = 16  # blocks a cluster
SMEM_OPT_IN = 227 * 1024
# the largest table the cluster route takes (on an H100 it beat the split
# route at 6,144 rows for Q = 8 and 64 and lost at 8,192 for Q = 64) and its
# queries per block for batches of more than 8 (16 beat 8 and 32 at Q = 64),
# from chip_smoke.py's and scripts/kernel_ablation.py's timing
CLUSTER_MAX_T = 6144
CLUSTER_QB = 16
# the wgmma route's
WROWS = 64  # table rows per tile (wgmma's M)
WBOXW = 32  # float32 columns of one 128B-swizzled box
WBOX_BYTES = WROWS * 128
WCAND = 96  # TF32 candidates a query holds: room for a tile's 64 rows
WGMMA_MAX_Q = 64
WGMMA_MAX_K = 32  # the first filter threshold's k-th of 32 row-group maxima
WMIN_STAGES, WMAX_STAGES = 4, 24
# what topk_route sends to the wgmma route, from chip_smoke.py's crossover
# timing on an H100 over 100,000 rows: at k = 5 it lost to the split route
# at Q <= 8 and won from Q = 9; its list work grows with Q * k: it won at
# Q * k = 320 (64 x 5) and 256 (16 x 16), lost by 4-7% at 400 (16 x 25),
# came within 3% either way at 640 (64 x 10), and lost from 1,024 (64 x 16)
WGMMA_MIN_Q = 9
WGMMA_MAX_QK = 320
# the select route's (sel:: in topk_sim.cu). Pass 1: tiles of BQ queries x BR
# rows, largest first, a thread per 4 x 4 (one to eight warps a block),
# chunks of SEL_DC columns (two boxes of 128-byte rows), a ring of up to
# SEL_MAX_STAGES in SEL_RING_BYTES, so two blocks fit an SM. Pass 2: 512
# threads a block, 1,024 for slices of SEL_BIG_SLICE keys or more (a block
# that holds such a slice has its SM to itself), clusters of up to
# SEL_MAX_CS; the cluster doubles
# while the grid stays within one block an SM and a slice keeps
# SEL_MIN_SLICE keys, and past that while a slice outgrows a block's shared
# memory. The leader ranks up to SEL_SMEM_KEYS survivors in shared memory; a
# [Q, pow2(k)] scratch takes more (its bitonic network indexes with 32-bit
# ints).
SEL_TILES = tuple((bq, br) for bq in (64, 32, 16, 8) for br in (128, 64, 32)
                  if 512 <= bq * br <= 4096)
SEL_DC = 64
SEL_RING_BYTES = 96 * 1024
SEL_MAX_STAGES = 4
SEL_MAX_CS = 16
SEL_MIN_SLICE = 2048
SEL_BIG_SLICE = 16384
SEL_FIXED_BYTES = 4 * (4 * 256 + 256 + 1024 // 32 + 4)  # histograms, totals, scan, ints
SEL_SMEM_KEYS = 4096
SEL_MAX_K = 2**30
ROUTES = ("cluster", "split", "wgmma", "select")

launches = 0  # kernel launches since the last reset (1 a call on "cluster", 2 on the others)
launches_by_route = dict.fromkeys(ROUTES, 0)  # the same launches, by route
launched_routes: Set[str] = set()  # routes launched at least once in this process; never reset
_cluster_size: Dict[tuple, int] = {}  # (device, qb, d, k, stages) -> 16 or 8
# device index -> uint64 counter on the card: (query, row) pairs the wgmma
# route rescored in float32
_rescored: Dict[int, torch.Tensor] = {}


def _bind(lib: ctypes.CDLL) -> None:
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.topk_sim_partial_launch.argtypes = [
        ci, ci, vp, vp, ci, ci, ci, ci, ci, ci, ctypes.c_float, vp, vp,
    ]
    lib.topk_sim_partial_launch.restype = ci
    lib.topk_sim_merge_launch.argtypes = [
        ci, vp, ci, ci, ci, ctypes.c_float, vp, vp, vp,
    ]
    lib.topk_sim_merge_launch.restype = ci
    lib.topk_sim_cluster_plan.argtypes = [ci, ci, ci, ci, ci, ctypes.POINTER(ci)]
    lib.topk_sim_cluster_plan.restype = ci
    lib.topk_sim_cluster_launch.argtypes = [
        ci, ci, ci, vp, vp, ci, ci, ci, ci, ci, ctypes.c_float, vp, vp, vp,
    ]
    lib.topk_sim_cluster_launch.restype = ci
    lib.topk_sim_wgmma_launch.argtypes = [
        ci, ci, vp, vp, ci, ci, ci, ci, ci, ci, ci, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, vp, vp, vp,
    ]
    lib.topk_sim_wgmma_launch.restype = ci
    lib.topk_sim_select_scores_launch.argtypes = [ci, ci, ci, ci, vp, vp, ci, ci, ci, vp, vp]
    lib.topk_sim_select_scores_launch.restype = ci
    lib.topk_sim_select_topk_launch.argtypes = [
        ci, ci, ci, ci, vp, ci, ci, ci, ci, vp, vp, vp, vp,
    ]
    lib.topk_sim_select_topk_launch.restype = ci
    lib.topk_sim_select_launch.argtypes = [
        ci, ci, ci, ci, ci, ci, ci, vp, vp, ci, ci, ci, ci, ci, vp, vp, vp, vp, vp,
    ]
    lib.topk_sim_select_launch.restype = ci


LIBRARY = CudaLibrary("topk_sim", _bind)
build_info = LIBRARY.info  # path, seconds, cached, ptxas log of the build


def build() -> Path:
    """Compile (once per source hash) and load the kernel library."""
    LIBRARY.load()
    return Path(build_info["path"])


def cost(n_q: int, n_t: int, d: int, k: int) -> Dict[str, float]:
    """The work of one call, from its shapes: {"flops": 2QTD, the products as
    multiply-adds; "bytes_accessed": each input read once (float32 queries
    and table) and each output written once (float32 scores, int64
    indices)}."""
    return {"flops": float(2 * n_q * n_t * d),
            "bytes_accessed": float(4 * (n_q * d + n_t * d) + n_q * k * (4 + 8))}


class _Probe:
    """This kernel as `router.gateway.hot_path_jits()` lists it: what the
    process has compiled and loaded, its analytic cost and its route, read
    without building, loading or launching anything."""

    cost = staticmethod(cost)

    @staticmethod
    def _cache_size() -> int:
        """The library loaded (0 or 1) plus the routes launched at least once."""
        return LIBRARY.loads + len(launched_routes)

    @staticmethod
    def route(n_q: int, n_t: int, d: int, k: int) -> str:
        """The route `topk_route` gives these shapes on 16-byte aligned
        tensors, as the allocator returns them."""
        probe = torch.empty((1, d))
        return topk_route(n_q, n_t, d, k, probe, probe)


PROBE = _Probe()


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(n_q: int, n_t: int, k: int, n_sms: int) -> Tuple[int, int, int]:
    """(queries per block, n_split, rows_per_split) for pass 1.

    A batch of up to 8 queries takes the 8-query block, so it does not pay
    for 32 query slots. Enough table slices that the grid holds about
    BLOCKS_PER_SM blocks per SM, each slice a whole number of tiles, and
    n_split * k candidates per query within what pass 2 merges in shared
    memory.
    """
    qb = 8 if n_q <= 8 else 32
    n_split = _cdiv(BLOCKS_PER_SM * n_sms, _cdiv(n_q, qb))
    n_split = max(1, min(n_split, MAX_CAND // k, _cdiv(n_t, TB)))
    rows = _cdiv(_cdiv(n_t, n_split), TB) * TB
    return qb, _cdiv(n_t, rows), rows


def cluster_qb(n_q: int) -> int:
    """Queries per cluster on the cluster route: 8 for batches of up to 8,
    else CLUSTER_QB."""
    return 8 if n_q <= 8 else CLUSTER_QB


def cluster_smem_bytes(qb: int, d: int, k: int, stages: int) -> int:
    """Dynamic shared memory of one cluster-route block (as topk_sim.cu)."""
    return (BAR_BYTES + 4 * d * (qb + stages * CR) + 4 * qb * CTILE
            + 8 * (CWARPS * MAX_K + qb * k + MAX_CS * k))


@functools.lru_cache(maxsize=None)
def cluster_stages(qb: int, d: int, k: int) -> int:
    """The deepest ring (<= MAX_STAGES) that fits a block; 0 if not two."""
    for stages in range(MAX_STAGES, 1, -1):
        if cluster_smem_bytes(qb, d, k, stages) <= SMEM_OPT_IN:
            return stages
    return 0


def _cluster_takes(n_q: int, d: int, k: int, tensors) -> bool:
    """Whether the cluster kernel can take these inputs at all: rows of a
    whole number of 16-byte units on 16-byte aligned bases (bulk copies),
    and a ring of at least two stages in shared memory."""
    return (d % 4 == 0 and d <= MAX_D and 1 <= k <= MAX_K
            and all(t.data_ptr() % 16 == 0 for t in tensors)
            and cluster_stages(cluster_qb(n_q), d, k) >= 2)


def wgmma_n(n_q: int) -> int:
    """The wgmma route's N: Q padded to 8, 16, 32 or 64."""
    return next(n for n in (8, 16, 32, 64) if n_q <= n)


def _wgmma_warps(n: int) -> int:
    """Consumer warps of a wgmma-route block for N queries: one warpgroup
    for N = 8, two (N / 2 queries each) above."""
    return 4 if n == 8 else 8


def wgmma_smem_bytes(n: int, d: int, k: int, stages: int) -> int:
    """Dynamic shared memory of one wgmma-route block (as topk_sim.cu)."""
    nb = _cdiv(d, WBOXW)
    return (1024 + nb * n * 128 + stages * (WBOX_BYTES + 16)
            + 8 * (n * (k + WCAND) + _wgmma_warps(n) * 128) + 20 * n + 48)


@functools.lru_cache(maxsize=None)
def wgmma_stages(n: int, d: int, k: int) -> int:
    """The deepest ring of table boxes (<= WMAX_STAGES) that fits a block;
    0 if not WMIN_STAGES."""
    for stages in range(WMAX_STAGES, WMIN_STAGES - 1, -1):
        if wgmma_smem_bytes(n, d, k, stages) <= SMEM_OPT_IN:
            return stages
    return 0


def wgmma_plan(n_q: int, n_t: int, d: int, k: int, n_sms: int) -> Tuple[int, int, int, int]:
    """(N, n_split, rows_per_split, stages) for the wgmma route's pass 1:
    about one block per SM, each a slice of whole 64-row tiles, and
    n_split * k candidates per query within what pass 2 merges."""
    n_split = max(1, min(n_sms, MAX_CAND // k, _cdiv(n_t, WROWS)))
    rows = _cdiv(_cdiv(n_t, n_split), WROWS) * WROWS
    n = wgmma_n(n_q)
    return n, _cdiv(n_t, rows), rows, wgmma_stages(n, d, k)


def _wgmma_takes(n_q: int, d: int, k: int, tensors) -> bool:
    """Whether the wgmma kernel can take these inputs at all: TMA rows of a
    whole number of 16-byte units (D % 4 == 0) and at least one box wide,
    16-byte aligned bases, Q <= 64, k <= 32, and a ring in shared memory."""
    return (d % 4 == 0 and WBOXW <= d <= MAX_D and 1 <= n_q <= WGMMA_MAX_Q
            and 1 <= k <= WGMMA_MAX_K and all(t.data_ptr() % 16 == 0 for t in tensors)
            and wgmma_stages(wgmma_n(n_q), d, k) >= WMIN_STAGES)


def select_sort_len(k: int) -> int:
    """The select route's sort length: k rounded up to a power of two."""
    return pow2_bucket(k)


class SelectPlan(NamedTuple):
    """Both passes of the select route for one call's shapes."""

    bq: int  # pass 1: queries a block
    br: int  # pass 1: table rows a block
    grid: Tuple[int, int]  # pass 1: (row tiles, query tiles)
    stages: int  # pass 1: chunks in the ring
    scores_smem: int  # pass 1: dynamic shared memory of a block, bytes
    threads: int  # pass 2: threads a block, 512 or 1024
    cs: int  # pass 2: blocks a query's cluster
    cap: int  # pass 2: a block's keys held in shared memory (the rest streams)
    topk_smem: int  # pass 2: dynamic shared memory of a block, bytes


@functools.lru_cache(maxsize=256)
def select_plan(n_q: int, n_t: int, d: int, k: int, n_sms: int) -> SelectPlan:
    """The select route's plan, from shapes alone (as topk_sim.cu sizes it).

    Pass 1 takes the largest tile of SEL_TILES, no more queries a block than
    Q needs, whose grid has at least one block an SM; where none has, the
    last (smallest). Pass 2's cluster doubles from 1, up to SEL_MAX_CS,
    while Q * 2CS blocks stay within one an SM and a slice of the T keys
    keeps SEL_MIN_SLICE, then while a slice is more than a block's shared
    memory holds beside the histograms (and the leader's k survivors,
    k <= SEL_SMEM_KEYS) in SMEM_OPT_IN; past 16 blocks the rest of a slice
    streams from the scratch in each pass. A block takes 1,024 threads for
    a slice of SEL_BIG_SLICE keys or more, else 512.
    """
    most = min(64, max(8, pow2_bucket(n_q)))
    tiles = [t for t in SEL_TILES if t[0] <= most]

    def grid(t):
        return _cdiv(n_t, t[1]), _cdiv(n_q, t[0])

    bq, br = next((t for t in tiles if grid(t)[0] * grid(t)[1] >= n_sms), tiles[-1])
    stage = 4 * SEL_DC * (bq + br)
    stages = max(1, min(SEL_MAX_STAGES, _cdiv(d, SEL_DC), SEL_RING_BYTES // stage))
    held = 8 * k if k <= SEL_SMEM_KEYS else 0
    room = (SMEM_OPT_IN - SEL_FIXED_BYTES - held) // 4  # keys a block holds
    cs = 1
    while cs < SEL_MAX_CS and (_cdiv(n_t, cs) > room or (
            n_q * 2 * cs <= n_sms and _cdiv(n_t, 2 * cs) >= SEL_MIN_SLICE)):
        cs *= 2
    cap = min(_cdiv(n_t, cs), room)
    threads = 1024 if _cdiv(n_t, cs) >= SEL_BIG_SLICE else 512
    return SelectPlan(bq, br, grid((bq, br)), stages, BAR_BYTES + 1024 + stages * stage,
                      threads, cs, cap, held + SEL_FIXED_BYTES + 4 * cap)


def can_take(route: str, queries: torch.Tensor, table: torch.Tensor, k: int) -> bool:
    """Whether `route`'s kernel can take these inputs (any table size): the
    split route takes every k <= MAX_K and D <= MAX_D, the select route
    everything the wrapper accepts."""
    n_q, d = queries.shape
    if route == "cluster":
        return _cluster_takes(n_q, d, k, (table, queries))
    if route == "wgmma":
        return _wgmma_takes(n_q, d, k, (table, queries))
    if route == "split":
        return 1 <= k <= MAX_K and d <= MAX_D
    return route == "select"


def topk_route(n_q: int, n_t: int, d: int, k: int, table: torch.Tensor,
               queries: Optional[torch.Tensor] = None) -> str:
    """"cluster" for a table of at most CLUSTER_MAX_T rows that the cluster
    kernel can take (D % 4 == 0, 16-byte aligned table and queries, the
    ring in shared memory); "wgmma" for a larger one, a batch of at least
    WGMMA_MIN_Q queries and Q * k <= WGMMA_MAX_QK (where it beat the split
    route), if the wgmma kernel can take it (also 32 <= D, Q <= 64,
    k <= 32); "select" where k > MAX_K or D > MAX_D, which no other route
    takes; else "split"."""
    tensors = (table,) if queries is None else (table, queries)
    if k > MAX_K or d > MAX_D:
        return "select"
    if n_t <= CLUSTER_MAX_T:
        return "cluster" if _cluster_takes(n_q, d, k, tensors) else "split"
    if (n_q >= WGMMA_MIN_Q and n_q * k <= WGMMA_MAX_QK
            and _wgmma_takes(n_q, d, k, tensors)):
        return "wgmma"
    return "split"


def margin_coefs(d: int) -> Tuple[float, float]:
    """(coef, abs_coef): the wgmma route's filter margin for a query q is
    E = coef |q| M + abs_coef (|q| + M + 1), M a bound on the row norms
    (the kernel takes the largest of the tiles it has seen), a bound on
    |TF32 tensor-core score - float32 FMA-chain score| for any float32
    inputs of depth d (the derivation is in topk_sim.cu's header)."""
    def gamma(n: int, u: float) -> float:
        return n * u / (1 - n * u)

    tf32 = 2.0**-10  # relative error of truncating a float32 to TF32's 10 bits
    c = (2 * tf32 + tf32 * tf32 + gamma(2 * d, 2.0**-23) * (1 + tf32) ** 2
         + gamma(d, 2.0**-24))
    return c * (1 + 2.0**-8) + 2.0**-20, d * 2.0**-126


def rescored() -> int:
    """(query, row) pairs the wgmma route has rescored in float32 since the
    last `reset_rescored` (reads the card's counters: synchronises)."""
    return sum(int(c.item()) for c in _rescored.values())


def reset_rescored() -> None:
    for c in _rescored.values():
        c.zero_()


def topk_sim_cuda(
    queries: torch.Tensor,  # [Q, D] float32, contiguous, on a CUDA device
    table: torch.Tensor,  # [T, D] float32, contiguous, same device
    k: int,
    route: Optional[str] = None,  # None: topk_route's choice; forced only to measure
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores [Q, k] float32 descending, indices [Q, k] int64) by a kernel."""
    global launches
    for name, x in (("queries", queries), ("table", table)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {x.device}")
        if x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {x.dtype}")
        if x.dim() != 2 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
    if queries.device != table.device:
        raise ValueError(f"queries on {queries.device} but table on {table.device}")
    n_q, d = queries.shape
    n_t = table.shape[0]
    if table.shape[1] != d:
        raise ValueError(f"queries have D={d} but table rows D={table.shape[1]}")
    if d < 1:
        raise ValueError(f"D={d}: rows must have at least one column")
    if not 1 <= k <= n_t:
        raise ValueError(f"k={k} outside [1, T={n_t}]")  # as lax.top_k refuses
    if n_t >= 2**31 - 1:
        raise ValueError(f"T={n_t} does not fit the kernel's 32-bit row ids")
    if k > SEL_MAX_K:
        raise ValueError(f"k={k} above the select route's sort network ({SEL_MAX_K})")
    if route is None:
        route = topk_route(n_q, n_t, d, k, table, queries)
    elif route not in ROUTES or not can_take(route, queries, table, k):
        raise ValueError(f"route {route!r} cannot take these inputs")
    dev = queries.device
    n_sms = sm_count(dev, "topk_sim")
    scores = torch.empty((n_q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((n_q, k), dtype=torch.int64, device=dev)
    if n_q == 0:
        return scores, idx
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    if route == "cluster":
        qb = cluster_qb(n_q)
        stages = cluster_stages(qb, d, k)
        key = (dev.index, qb, d, k, stages)
        cs = _cluster_size.get(key)
        if cs is None:
            out = ctypes.c_int(0)
            LIBRARY.check(lib.topk_sim_cluster_plan(dev.index, qb, d, k, stages,
                                                    ctypes.byref(out)), "topk_sim_cluster plan")
            if out.value == 0:
                raise RuntimeError(
                    f"topk_sim_cluster: no cluster of 16 or 8 blocks with "
                    f"{cluster_smem_bytes(qb, d, k, stages)} bytes of shared memory each can "
                    f"be resident on {torch.cuda.get_device_name(dev)}")
            cs = _cluster_size[key] = out.value
        rc = lib.topk_sim_cluster_launch(
            dev.index, qb, cs, queries.data_ptr(), table.data_ptr(), n_q, n_t, d, k, stages,
            NEG_INF, scores.data_ptr(), idx.data_ptr(), stream,
        )
        LIBRARY.check(rc, "topk_sim_cluster")
        launches += 1
        launches_by_route["cluster"] += 1
        launched_routes.add("cluster")
        return scores, idx
    if route == "select":  # pass 1 (scores) and pass 2 (selection) in one host call
        plan = select_plan(n_q, n_t, d, k, n_sms)
        sims = torch.empty((n_q, n_t), dtype=torch.float32, device=dev)
        p = select_sort_len(k)
        # the sort's scratch, read only past SEL_SMEM_KEYS
        sort_buf = (torch.empty((n_q, p), dtype=torch.int64, device=dev) if k > SEL_SMEM_KEYS
                    else sims)
        rc = lib.topk_sim_select_launch(
            dev.index, plan.bq, plan.br, plan.stages, plan.threads, plan.cs, plan.cap,
            queries.data_ptr(), table.data_ptr(), n_q, n_t, d, k, p, sims.data_ptr(),
            sort_buf.data_ptr(), scores.data_ptr(), idx.data_ptr(), stream,
        )
        LIBRARY.check(rc, "topk_sim_select")
        launches += 2
        launches_by_route["select"] += 2
        launched_routes.add("select")
        return scores, idx
    if route == "wgmma":
        counter = _rescored.get(dev.index)
        if counter is None:
            counter = _rescored[dev.index] = torch.zeros(1, dtype=torch.int64, device=dev)
        n_pad, n_split, rows, stages = wgmma_plan(n_q, n_t, d, k, n_sms)
        coef, abs_coef = margin_coefs(d)
        partial = torch.empty((n_q, n_split, k), dtype=torch.int64, device=dev)
        rc = lib.topk_sim_wgmma_launch(
            dev.index, n_pad, queries.data_ptr(), table.data_ptr(), n_q, n_t, d, k, n_split,
            rows, stages, coef, abs_coef, NEG_INF,
            partial.data_ptr(), counter.data_ptr(), stream,
        )
        LIBRARY.check(rc, "topk_sim_wgmma")
    else:
        qb, n_split, rows = split_plan(n_q, n_t, k, n_sms)
        partial = torch.empty((n_q, n_split, k), dtype=torch.int64, device=dev)
        rc = lib.topk_sim_partial_launch(
            dev.index, qb, queries.data_ptr(), table.data_ptr(), n_q, n_t, d, k,
            n_split, rows, NEG_INF, partial.data_ptr(), stream,
        )
        LIBRARY.check(rc, "topk_sim_partial")
    launches += 1
    launches_by_route[route] += 1
    rc = lib.topk_sim_merge_launch(
        dev.index, partial.data_ptr(), n_q, n_split, k, NEG_INF,
        scores.data_ptr(), idx.data_ptr(), stream,
    )
    LIBRARY.check(rc, "topk_sim_merge")
    launches += 1
    launches_by_route[route] += 1
    launched_routes.add(route)
    return scores, idx

"""AST rules for the repo-specific invariant analyzer.

Counterpart of `repro/analysis/rules.py`: the same eleven rules, which give
the reference's findings on any tree, with three changes. `kernel-contract`
keys each kernel by its directory path, so a `kernels/<name>/` in each of
two packages gets its own checks (the reference keeps the last one it
scans); `mesh-api` also flags the PyTorch drift the rule exists to pin
(private `torch.distributed` names, `DTensor._*`, `torch._C._*DTensor*`);
and `lock-dispatch` (with `cache-version-stamp`'s scan of `cache/`) also
matches the dispatch `lockgraph.watch_dispatch` counts at run time.
Messages and hints name `repro_torch` modules where the reference names
`repro` ones.

Each rule encodes one invariant the serving/control/index/learning planes
rely on but that generic linters cannot know. Rules come in two kinds:

  * **module rules** — run per parsed file (`check(module) -> findings`);
  * **project rules** — run once over the whole scanned file set plus the
    tests directory (`check_project(modules, tests_dir)`), for contracts
    that span files (kernel/ref/parity-test triples).

Registering a new rule: subclass `Rule`, set `rule_id`/`description`/
`hint`, implement `check` (or `check_project` with `project = True`), and
decorate with `@register`. The engine discovers rules through `REGISTRY`.
See `repro_torch.analysis.__init__` for the rule catalog with rationale.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Set

from repro_torch.analysis.findings import Finding

__all__ = ["ModuleInfo", "Rule", "REGISTRY", "register"]


# --------------------------------------------------------------------- model


class ModuleInfo:
    """One parsed source file handed to every module rule."""

    def __init__(self, path: Path, rel: str, text: str):
        self.path = path
        self.rel = rel  # posix path used in findings/baseline (stable key)
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=str(path))

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""


class Rule:
    rule_id = ""
    description = ""
    hint = ""
    project = False  # True: check_project(modules, tests_dir) once per run

    def finding(self, module: ModuleInfo, node: ast.AST, message: str) -> Finding:
        return Finding(
            rule=self.rule_id,
            file=module.rel,
            line=getattr(node, "lineno", 1),
            col=getattr(node, "col_offset", 0),
            message=message,
            hint=self.hint,
        )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:  # module rules
        return iter(())

    def check_project(
        self, modules: Sequence[ModuleInfo], tests_dir: Optional[Path]
    ) -> Iterator[Finding]:  # project rules
        return iter(())


REGISTRY: Dict[str, Rule] = {}


def register(cls):
    inst = cls()
    assert inst.rule_id and inst.rule_id not in REGISTRY
    REGISTRY[inst.rule_id] = inst
    return cls


# ------------------------------------------------------------------- helpers


def dotted(node: ast.AST) -> Optional[str]:
    """'jax.sharding.use_mesh' for nested Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_jax_jit(node: ast.AST) -> bool:
    """True for `jax.jit` / `jit` references and `functools.partial(jax.jit, ...)`."""
    d = dotted(node)
    if d in ("jax.jit", "jit"):
        return True
    if isinstance(node, ast.Call):
        fd = dotted(node.func)
        if fd in ("functools.partial", "partial") and node.args:
            return _is_jax_jit(node.args[0])
        return _is_jax_jit(node.func)
    return False


def _static_names_from_jit(node: ast.AST, fn: Optional[ast.FunctionDef]) -> Set[str]:
    """Parameter names made static by a jit expression (decorator or call)."""
    static: Set[str] = set()
    if not isinstance(node, ast.Call):
        return static
    nums: List[int] = []
    for kw in node.keywords:
        if kw.arg == "static_argnames":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                static.add(v.value)
            elif isinstance(v, (ast.Tuple, ast.List, ast.Set)):
                for elt in v.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
                        static.add(elt.value)
        elif kw.arg == "static_argnums":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                nums.append(v.value)
            elif isinstance(v, (ast.Tuple, ast.List)):
                for elt in v.elts:
                    if isinstance(elt, ast.Constant) and isinstance(elt.value, int):
                        nums.append(elt.value)
    if fn is not None and nums:
        params = [a.arg for a in fn.args.args]
        for i in nums:
            if 0 <= i < len(params):
                static.add(params[i])
    # nested partial: functools.partial(jax.jit, static_argnames=...)
    if node.args and isinstance(node.args[0], ast.Call):
        static |= _static_names_from_jit(node.args[0], fn)
    return static


class _FuncStackWalker(ast.NodeVisitor):
    """Base visitor tracking the enclosing-function nesting depth."""

    def __init__(self):
        self.func_depth = 0

    def visit_FunctionDef(self, node):
        self.func_depth += 1
        self.generic_visit(node)
        self.func_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef


def _in_packages(rel: str, packages: Iterable[str]) -> bool:
    return any(f"/{p}/" in f"/{rel}" or rel.startswith(f"{p}/") for p in packages)


# --------------------------------------------------------------------- rules


def _private(name: str) -> bool:
    """A leading underscore that is not a dunder (`_ops`, not `__name__`)."""
    return name.startswith("_") and not (name.startswith("__") and name.endswith("__"))


@register
class MeshApiRule(Rule):
    rule_id = "mesh-api"
    description = (
        "Raw JAX mesh-context APIs (set_mesh/use_mesh/get_abstract_mesh/"
        "make_mesh/shard_map/thread_resources), or private torch.distributed "
        "names (`_`-prefixed modules and attributes, DTensor._*, "
        "torch._C._*DTensor*), outside common/meshctx.py — these drift "
        "across JAX and torch releases; meshctx is the one place that "
        "papers over them."
    )
    hint = (
        "route through repro_torch.common.meshctx "
        "(current_mesh/use_mesh/make_mesh/axis_sizes_dict/shard_map)"
    )

    BAD_EXACT = {
        "jax.set_mesh",
        "jax.sharding.use_mesh",
        "jax.sharding.get_abstract_mesh",
        "jax.make_mesh",
        "jax.shard_map",
    }
    BAD_PREFIX = ("jax._src.mesh", "jax.experimental.shard_map")
    BAD_IMPORT_FROM = {
        "jax": {"set_mesh", "make_mesh", "shard_map"},
        "jax.sharding": {"use_mesh", "get_abstract_mesh"},
        "jax.experimental.shard_map": None,  # None: any name
        "jax._src.mesh": None,
    }

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if module.rel.endswith("common/meshctx.py"):
            return
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Attribute):
                d = dotted(node)
                if d is None:
                    continue
                if d in self.BAD_EXACT or d.startswith(self.BAD_PREFIX):
                    yield self.finding(module, node, f"raw JAX mesh API `{d}`")
                elif node.attr == "thread_resources" and d.startswith("jax"):
                    yield self.finding(module, node, f"raw JAX mesh API `{d}`")
            elif isinstance(node, ast.ImportFrom) and node.module:
                allowed = self.BAD_IMPORT_FROM.get(node.module, ...)
                if allowed is ...:
                    if node.module.startswith(self.BAD_PREFIX):
                        yield self.finding(
                            module, node,
                            f"import from drift-prone `{node.module}`",
                        )
                    continue
                for alias in node.names:
                    if allowed is None or alias.name in allowed:
                        yield self.finding(
                            module, node,
                            f"`from {node.module} import {alias.name}` is a "
                            f"raw mesh API",
                        )
        yield from self._torch_drift(module)

    def _torch_drift(self, module: ModuleInfo) -> Iterator[Finding]:
        """Private torch.distributed names reached by an import or by a
        dotted chain (each chain once, at its outermost attribute), with
        local names resolved through the module's imports."""
        bound: Dict[str, str] = {}  # local name -> the dotted path it names
        inner: Set[int] = set()  # attributes that are part of a longer chain
        nodes = list(ast.walk(module.tree))
        for node in nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if alias.asname:
                        bound[alias.asname] = alias.name
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                for alias in node.names:
                    bound[alias.asname or alias.name] = f"{node.module}.{alias.name}"
            elif isinstance(node, ast.Attribute) and isinstance(node.value, ast.Attribute):
                inner.add(id(node.value))
        for node in nodes:
            if isinstance(node, ast.Import):
                for alias in node.names:
                    parts = alias.name.split(".")
                    if parts[:2] == ["torch", "distributed"] and any(map(_private, parts)):
                        yield self.finding(
                            module, node, f"import of private `{alias.name}`"
                        )
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                parts = node.module.split(".")
                if parts[:2] != ["torch", "distributed"]:
                    continue
                if any(map(_private, parts)):
                    yield self.finding(
                        module, node, f"import from private `{node.module}`"
                    )
                    continue
                for alias in node.names:
                    if _private(alias.name):
                        yield self.finding(
                            module, node,
                            f"`from {node.module} import {alias.name}` is a "
                            f"private torch.distributed name",
                        )
            elif isinstance(node, ast.Attribute) and id(node) not in inner:
                d = dotted(node)
                if d is None:
                    continue
                root, _, rest = d.partition(".")
                attrs = rest.split(".")  # what the chain adds to its root
                parts = bound.get(root, root).split(".") + attrs
                if parts[:2] == ["torch", "distributed"] and any(map(_private, attrs)):
                    yield self.finding(
                        module, node, f"private torch.distributed name `{d}`"
                    )
                elif (parts[:2] == ["torch", "_C"] and "DTensor" in parts[-1]) or any(
                    a == "DTensor" and _private(b) for a, b in zip(parts, parts[1:])
                ):
                    yield self.finding(module, node, f"DTensor internal `{d}`")


@register
class CasDisciplineRule(Rule):
    rule_id = "cas-discipline"
    description = (
        "swap_table/rollback/set_stages/rollback_stages called without the "
        "compare-and-swap expectation keyword — a bare call can silently "
        "clobber a concurrent deployment (the lost-update the versioned "
        "stores exist to refuse)."
    )
    hint = (
        "pass expect_current= (tables/stage rollback) or expect_version= "
        "(set_stages) from the snapshot the change was derived from"
    )

    REQUIRED = {
        "swap_table": "expect_current",
        "rollback": "expect_current",
        "rollback_stages": "expect_current",
        "set_stages": "expect_version",
    }
    # receivers whose `rollback` is bounded-history trimming, not a serving
    # CAS (ArtifactRegistry.rollback has no expectation parameter by design:
    # it is always called with the registry lock's owner having just read
    # the live StageSet)
    EXEMPT_RECEIVER_PARTS = ("registry", "registries")

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            meth = node.func.attr
            kw_required = self.REQUIRED.get(meth)
            if kw_required is None:
                continue
            recv = dotted(node.func.value) or ""
            last = recv.split(".")[-1].lower()
            if any(p in last for p in self.EXEMPT_RECEIVER_PARTS):
                continue
            if any(kw.arg == kw_required for kw in node.keywords):
                continue
            if len(node.args) >= 2:  # expectation passed positionally
                continue
            yield self.finding(
                module, node,
                f"`{recv or '<expr>'}.{meth}(...)` without {kw_required}= "
                f"is not compare-and-swap",
            )


@register
class SnapshotDisciplineRule(Rule):
    rule_id = "snapshot-discipline"
    description = (
        "Direct access to another object's mutable versioned-store fields "
        "(_table/_history/_stages/_stage_history/_swap_listeners) outside "
        "the owning module — bypasses the atomic snapshot()/stage_set() "
        "read and can observe a half-completed swap."
    )
    hint = (
        "read through ToolsDatabase.snapshot() / SemanticRouter.stage_set() "
        "(atomic version+value) instead of reaching into private state"
    )

    PRIVATE = {"_table", "_history", "_stages", "_stage_history", "_swap_listeners"}
    OWNERS = ("router/tooldb.py", "router/gateway.py", "router/stages.py")

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if module.rel.endswith(self.OWNERS):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Attribute) or node.attr not in self.PRIVATE:
                continue
            if isinstance(node.value, ast.Name) and node.value.id in ("self", "cls"):
                continue  # a class's own private state is its own business
            recv = dotted(node.value) or "<expr>"
            yield self.finding(
                module, node,
                f"direct access to versioned-store internal "
                f"`{recv}.{node.attr}`",
            )


@register
class JitInFunctionRule(Rule):
    rule_id = "jit-in-function"
    description = (
        "jax.jit applied inside a function body — every call/instance gets "
        "a fresh trace cache, so the compile cost the module-level jits pay "
        "once is paid per object (a multi-ms stall if it ever reaches the "
        "hot path)."
    )
    hint = (
        "hoist the jit to module scope; if the closure is deliberate "
        "(per-process singleton, offline training loop), baseline it with "
        "a justification"
    )

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        findings: List[Finding] = []
        seen_lines: Set[int] = set()
        rule = self

        class V(_FuncStackWalker):
            def visit_FunctionDef(self, node):
                if self.func_depth > 0:  # nested def: check jit decorators
                    for dec in node.decorator_list:
                        if _is_jax_jit(dec) and dec.lineno not in seen_lines:
                            seen_lines.add(dec.lineno)
                            findings.append(rule.finding(
                                module, dec,
                                f"`@jax.jit` on `{node.name}` defined inside "
                                f"a function",
                            ))
                super().visit_FunctionDef(node)

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Call(self, node):
                if (
                    self.func_depth > 0
                    and dotted(node.func) in ("jax.jit", "jit")
                    and node.lineno not in seen_lines
                ):
                    seen_lines.add(node.lineno)
                    findings.append(rule.finding(
                        module, node, "jax.jit(...) called inside a function"
                    ))
                self.generic_visit(node)

        V().visit(module.tree)
        yield from findings


@register
class JitStaticScalarRule(Rule):
    rule_id = "jit-static-scalar"
    description = (
        "A jitted function takes a Python-scalar parameter (int/bool/str "
        "annotation) that is not in static_argnames — shape-controlling "
        "scalars silently become traced values (wrong results or tracer "
        "errors), and hashable config scalars belong in the compile key."
    )
    hint = "add the parameter to static_argnames (or drop the jit wrapper)"

    SCALAR_ANNOTATIONS = {"int", "bool", "str"}

    def _scalar_params(self, fn: ast.FunctionDef) -> List[str]:
        out = []
        for a in list(fn.args.args) + list(fn.args.kwonlyargs):
            ann = a.annotation
            if isinstance(ann, ast.Name) and ann.id in self.SCALAR_ANNOTATIONS:
                out.append(a.arg)
        return out

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        # defs decorated with jit (any nesting level)
        defs: Dict[str, ast.FunctionDef] = {}
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            defs.setdefault(node.name, node)
            for dec in node.decorator_list:
                if not _is_jax_jit(dec):
                    continue
                static = _static_names_from_jit(dec, node)
                for p in self._scalar_params(node):
                    if p not in static:
                        yield self.finding(
                            module, dec,
                            f"jitted `{node.name}` takes scalar `{p}` "
                            f"outside static_argnames",
                        )
        # assignment form: g = jax.jit(local_fn, ...)
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and dotted(node.func) in ("jax.jit", "jit")):
                continue
            if not node.args or not isinstance(node.args[0], ast.Name):
                continue
            target = defs.get(node.args[0].id)
            if target is None or target.decorator_list:
                continue  # unresolvable or already checked via decorator
            static = _static_names_from_jit(node, target)
            for p in self._scalar_params(target):
                if p not in static:
                    yield self.finding(
                        module, node,
                        f"jax.jit({target.name}) leaves scalar `{p}` "
                        f"outside static_argnames",
                    )


@register
class Pow2BucketRule(Rule):
    rule_id = "pow2-bucket"
    description = (
        "Hand-rolled power-of-two bucket arithmetic (`1 << n.bit_length()`) "
        "outside common/bucketing.py — every jitted entry point must agree "
        "on ONE bucketing function or the retrace budget is per-module "
        "luck, and the retrace detector's expected-bucket set goes stale."
    )
    hint = "use repro_torch.common.bucketing.pow2_bucket / expected_buckets"

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if module.rel.endswith("common/bucketing.py"):
            return
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.LShift)):
                continue
            if not (isinstance(node.left, ast.Constant) and node.left.value == 1):
                continue
            uses_bit_length = any(
                isinstance(sub, ast.Attribute) and sub.attr == "bit_length"
                for sub in ast.walk(node.right)
            )
            if uses_bit_length:
                yield self.finding(
                    module, node, "manual power-of-two bucket computation"
                )


# dtypes a `Tensor.to(...)` argument may name without naming a device
_TORCH_DTYPES = {
    "float16", "float32", "float64", "bfloat16", "half", "float", "double",
    "int8", "int16", "int32", "int64", "uint8", "short", "int", "long", "bool",
    "complex64", "complex128", "float8_e4m3fn", "float8_e5m2",
}


def _names_a_dtype(arg: ast.AST) -> bool:
    d = dotted(arg) or ""
    leaf = d.split(".")[-1]
    return (d.startswith("torch.") and leaf in _TORCH_DTYPES) or "dtype" in leaf.lower()


@register
class LockDispatchRule(Rule):
    rule_id = "lock-dispatch"
    description = (
        "JAX dispatch (jnp.*/jax.*/known jitted entry points/device_put) or "
        "torch device dispatch (Tensor.to(<device>)/.cuda()/the CUDA kernel "
        "wrappers/torch.*(device=...)) "
        "lexically inside a `with <lock>:` block in the serving-adjacent "
        "packages — device work under a hot-path lock stalls every thread "
        "contending for it (a compile is a multi-ms budget breach for all "
        "of them)."
    )
    hint = (
        "compute device work outside the critical section; hold the lock "
        "only to publish the result (see ToolIndexManager._build)"
    )

    PACKAGES = ("router", "control", "learn", "index")
    KNOWN_JITTED = {
        "topk_dense",
        "rerank_topk_scored",
        "topk_sim",
        "topk_sim_pallas",
        "adapter_apply",
        "refine_embeddings",
        "batched_recall_at_k",
        "batched_ndcg_at_k",
    }
    # the port's dispatch that `lockgraph.watch_dispatch` counts at run time
    # besides the shared names above: the kernel wrappers
    KERNEL_WRAPPERS = {"topk_sim_cuda", "flash_attention_cuda", "ssd_scan_cuda"}
    LOCKISH = ("lock", "cond", "mutex")

    def _is_lockish(self, expr: ast.AST) -> bool:
        d = dotted(expr if not isinstance(expr, ast.Call) else expr.func)
        if d is None:
            return False
        return any(p in d.split(".")[-1].lower() for p in self.LOCKISH)

    def _dispatchy(self, call: ast.Call, jitted: Set[str]) -> Optional[str]:
        d = dotted(call.func)
        if d is None:
            return None
        if d.startswith(("jnp.", "jax.")):
            return d
        parts = d.split(".")
        if parts[-1] == "device_put" or parts[-1] in jitted or d in jitted:
            return d
        return None

    def _torch_dispatchy(self, call: ast.Call) -> Optional[str]:
        """`Tensor.to` naming a device (a keyword, or a positional argument
        that is not a dtype), `.cuda()`, a kernel wrapper, or any `torch.*`
        call given `device=`."""
        func = call.func
        d = dotted(func)
        if d is not None:
            if d.split(".")[-1] in self.KERNEL_WRAPPERS:
                return d
            if d.startswith("torch.") and any(kw.arg == "device" for kw in call.keywords):
                return d
        if not isinstance(func, ast.Attribute):
            return None
        name = d or f"<expr>.{func.attr}"
        if func.attr == "cuda":
            return name
        if func.attr == "to" and (
            any(kw.arg == "device" for kw in call.keywords)
            or any(not _names_a_dtype(a) for a in call.args)
        ):
            return name
        return None

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not _in_packages(module.rel, self.PACKAGES):
            return
        # names jitted in this module (assignments + decorated defs) extend
        # the cross-module known set
        jitted = set(self.KNOWN_JITTED)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if _is_jax_jit(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            jitted.add(t.id)
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if any(_is_jax_jit(dec) for dec in node.decorator_list):
                    jitted.add(node.name)

        findings: List[Finding] = []
        rule = self

        def scan_node(sub, lock_name: str):
            # a def/lambda nested under the with does not run there — do
            # not descend (ast.walk would; recurse by hand instead)
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return
            if isinstance(sub, ast.Call):
                d = rule._dispatchy(sub, jitted)
                if d is not None:
                    findings.append(rule.finding(
                        module, sub,
                        f"JAX dispatch `{d}(...)` inside `with {lock_name}:`",
                    ))
                else:
                    d = rule._torch_dispatchy(sub)
                    if d is not None:
                        findings.append(rule.finding(
                            module, sub,
                            f"device dispatch `{d}(...)` inside `with {lock_name}:`",
                        ))
            for child in ast.iter_child_nodes(sub):
                scan_node(child, lock_name)

        def scan_body(stmts, lock_name: str):
            for stmt in stmts:
                scan_node(stmt, lock_name)

        for node in ast.walk(module.tree):
            if not isinstance(node, ast.With):
                continue
            for item in node.items:
                if self._is_lockish(item.context_expr):
                    name = dotted(item.context_expr) or "<lock>"
                    scan_body(node.body, name)
                    break
        yield from findings


@register
class CacheVersionStampRule(Rule):
    rule_id = "cache-version-stamp"
    description = (
        "A route-cache lookup/insert site missing an explicit "
        "table_version=/stage_version= stamp, or JAX or torch device dispatch "
        "(lock-dispatch's patterns) lexically under a lock in the `cache/` "
        "package — the cache's exact-invalidation story holds only if every "
        "entry is stamped with the snapshot its scores came from, and the "
        "cache lock is a hot-path lock the gateway takes per batch."
    )
    hint = (
        "pass table_version=/stage_version= from the same snapshot that "
        "produced the scores (the topk's returned version, not a racy live "
        "read); keep cache critical sections numpy-only — dispatch before "
        "taking the lock"
    )

    STAMPED_METHODS = ("lookup_batch", "insert_batch")
    STAMPS = ("table_version", "stage_version")

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            if node.func.attr not in self.STAMPED_METHODS:
                continue
            recv = dotted(node.func.value) or ""
            if "cache" not in recv.split(".")[-1].lower():
                continue
            kws = {kw.arg for kw in node.keywords}
            missing = [s for s in self.STAMPS if s not in kws]
            if missing:
                yield self.finding(
                    module, node,
                    f"`{recv}.{node.func.attr}(...)` without "
                    f"{'/'.join(s + '=' for s in missing)} — unstamped cache "
                    f"traffic defeats exact invalidation",
                )
        # the lock-dispatch scan, scoped to the cache package (which the
        # lock-dispatch rule's serving-package list predates)
        if _in_packages(module.rel, ("cache",)):
            scoped = LockDispatchRule()
            scoped.PACKAGES = ("cache",)
            for f in scoped.check(module):
                yield Finding(
                    self.rule_id, f.file, f.line, f.col,
                    f.message + " (route-cache critical section)", self.hint,
                )


@register
class ThreadDisciplineRule(Rule):
    rule_id = "thread-discipline"
    description = (
        "A daemon thread's locally-defined loop either lets exceptions kill "
        "it silently or catches them without recording the failure — a dead "
        "or flapping control/learning plane that no guard or health check "
        "can detect."
    )
    hint = (
        "wrap the loop body in try/except Exception and record the failure "
        "on an attribute a health check reads (e.g. self.last_loop_error = "
        "exc; clear it on success)"
    )

    def _local_def(self, enclosing: ast.FunctionDef, name: str):
        for stmt in ast.walk(enclosing):
            if isinstance(stmt, ast.FunctionDef) and stmt.name == name:
                return stmt
        return None

    def _handler_records_error(self, handler: ast.ExceptHandler) -> bool:
        for sub in ast.walk(handler):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if isinstance(t, ast.Attribute) and (
                        "error" in t.attr.lower() or "exception" in t.attr.lower()
                    ):
                        return True
            if isinstance(sub, ast.Call):
                d = dotted(sub.func) or ""
                leaf = d.split(".")[-1].lower()
                if "error" in leaf or "exception" in leaf:
                    return True
        return False

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        for fn in ast.walk(module.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                d = dotted(node.func) or ""
                if d.split(".")[-1] != "Thread":
                    continue
                daemon = any(
                    kw.arg == "daemon"
                    and isinstance(kw.value, ast.Constant)
                    and kw.value.value is True
                    for kw in node.keywords
                )
                if not daemon:
                    continue
                target = next(
                    (kw.value for kw in node.keywords if kw.arg == "target"), None
                )
                if not isinstance(target, ast.Name):
                    continue  # bound method target: judged where defined
                loop = self._local_def(fn, target.id)
                if loop is None:
                    continue
                handlers = [
                    h
                    for t in ast.walk(loop)
                    if isinstance(t, ast.Try)
                    for h in t.handlers
                    if h.type is None
                    or (isinstance(h.type, ast.Name)
                        and h.type.id in ("Exception", "BaseException"))
                ]
                if not handlers:
                    yield self.finding(
                        module, node,
                        f"daemon loop `{target.id}` has no except Exception: "
                        f"the first transient failure kills the thread "
                        f"silently",
                    )
                elif not any(self._handler_records_error(h) for h in handlers):
                    yield self.finding(
                        module, node,
                        f"daemon loop `{target.id}` swallows exceptions "
                        f"without recording them where a health check can "
                        f"see the failure",
                    )


@register
class KernelContractRule(Rule):
    rule_id = "kernel-contract"
    description = (
        "Every kernels/<name>/kernel.py must ship a ref.py oracle sibling "
        "and a parity test referencing the kernel; top-K kernels must pad "
        "with the canonical NEG_INF sentinel (the gateway filters selected "
        "tools by `score > NEG_INF / 2` — a drifted sentinel silently "
        "surfaces padding as results)."
    )
    hint = (
        "add ref.py + a tests/ parity test importing repro_torch.kernels.<name>; "
        "import NEG_INF from repro_torch.core.retrieval instead of hardcoding"
    )
    project = True

    def check_project(
        self, modules: Sequence[ModuleInfo], tests_dir: Optional[Path]
    ) -> Iterator[Finding]:
        # keyed by the kernel's directory, not its name: `kernels/<name>/`
        # in each of two packages is two kernels
        kernels: Dict[str, ModuleInfo] = {}
        by_rel = {m.rel: m for m in modules}
        for m in modules:
            parts = m.rel.split("/")
            if len(parts) >= 3 and parts[-3] == "kernels" and parts[-1] == "kernel.py":
                kernels[m.rel.rsplit("/", 1)[0]] = m
        test_text = ""
        if tests_dir is not None and tests_dir.is_dir():
            test_text = "\n".join(
                p.read_text() for p in sorted(tests_dir.rglob("*.py"))
            )
        for kdir, kmod in sorted(kernels.items()):
            parts = kdir.split("/")
            name = parts[-1]
            package = "repro" if parts[-3:-2] == ["repro"] else "repro_torch"
            if not (kmod.path.parent / "ref.py").exists():
                yield self.finding(
                    kmod, kmod.tree,
                    f"kernel `{name}` has no ref.py oracle sibling",
                )
            if tests_dir is not None and f"kernels.{name}" not in test_text:
                yield self.finding(
                    kmod, kmod.tree,
                    f"no parity test references {package}.kernels.{name}",
                )
            if "topk" not in name:
                continue  # the NEG_INF padding contract is a top-K contract
            for sibling in ("kernel.py", "ref.py", "ops.py"):
                smod = by_rel.get(f"{kdir}/{sibling}")
                if smod is None:
                    continue
                if "NEG_INF" in smod.text:
                    imported = any(
                        isinstance(n, ast.ImportFrom)
                        and any(a.name == "NEG_INF" for a in n.names)
                        for n in ast.walk(smod.tree)
                    )
                    if not imported:
                        yield Finding(
                            self.rule_id, smod.rel, 1, 0,
                            f"`{sibling}` names NEG_INF without importing "
                            f"the canonical constant", self.hint,
                        )
                for node in ast.walk(smod.tree):
                    val = None
                    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
                        if isinstance(node.operand, ast.Constant) and isinstance(
                            node.operand.value, (int, float)
                        ):
                            val = -float(node.operand.value)
                    elif isinstance(node, ast.Constant) and isinstance(
                        node.value, (int, float)
                    ):
                        val = float(node.value)
                    if val is not None and val <= -1e29:
                        yield Finding(
                            self.rule_id, smod.rel, node.lineno,
                            node.col_offset,
                            f"hardcoded top-K padding sentinel {val:g} in "
                            f"`{sibling}`", self.hint,
                        )


@register
class ObsDisciplineRule(Rule):
    rule_id = "obs-discipline"
    description = (
        "Direct `time.time()`/`time.perf_counter()`/`time.monotonic()` or "
        "`print()` in the serving-path packages (`router/`, `index/`) and "
        "the daemon planes (`control/`, `learn/`) — timing there must flow "
        "through `repro_torch.obs.clock` (one monotonic source per recorded "
        "duration; wall-clock steps from NTP slew corrupt latency "
        "histograms and controller cooldown/cadence arithmetic) and "
        "operator output through the telemetry plane (metrics/events), not "
        "stdout a serving process never reads."
    )
    hint = (
        "use repro_torch.obs.clock (perf/monotonic/wall/duration_ms) for timing "
        "and the MetricsRegistry/EventBus for operator-facing output"
    )

    PACKAGES = ("router", "index", "control", "learn")
    FORBIDDEN_TIME = {"time.time", "time.perf_counter", "time.monotonic"}

    def check(self, module: ModuleInfo) -> Iterator[Finding]:
        if not _in_packages(module.rel, self.PACKAGES):
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            d = dotted(node.func)
            if d in self.FORBIDDEN_TIME:
                yield self.finding(
                    module, node,
                    f"`{d}()` in a serving-path package; use the "
                    f"repro_torch.obs.clock equivalent",
                )
            elif d == "print":
                yield self.finding(
                    module, node,
                    "`print()` in a serving-path package; publish to the "
                    "telemetry plane instead",
                )

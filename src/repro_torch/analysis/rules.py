"""The torchlint rule catalog (the port of ``repro.analysis.rules``): each
rule encodes a bug class of this repository in its PyTorch form, under the
reference rule's id.  See the module docstring of ``repro_torch.analysis``
for how to add one.

R000 suppression-without-justification  accepted risk must say why
R001 seed-reuse                         one seed behind two generators
R002 host-sync-in-hot-loop              the per-metric sync class
R003 rebound-attribute-in-capture       the frozen-reference class
R007 blocking-drain-in-dispatch-loop    sync on the just-dispatched step

R004, R005 and R006 have no port rule (:data:`NOT_PORTED` says why);
``--catalog`` lists them.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.core import Finding, Module, Rule, register_rule, \
    rule_ids
from repro_torch.analysis.scopes import CAPTURED, FuncInfo, ScopeGraph, \
    _enclosing_class, attr_chain, last_name, qualified, rebound_self_attrs, \
    shallow_walk

#: the reference's rules the port has none for, and why
NOT_PORTED: Dict[str, Tuple[str, str]] = {
    "R004": ("python-control-flow-on-tracer",
             "eager PyTorch has no tracer: a branch on a tensor is a host "
             "sync, and under CUDA-graph capture that sync raises rather "
             "than silently freezing the branch"),
    "R005": ("donated-buffer-reuse",
             "the port donates no buffer (DistConfig.donate_state has no "
             "effect): a step rewrites its state in place"),
    "R006": ("recompile-hazard",
             "the port has no jit and no static arguments: nothing "
             "recompiles per call"),
}

# torch namespaces whose calls return host objects (streams, events,
# ranks, settings), not tensors on the device
_TORCH_HOST_NAMESPACES = {"cuda", "distributed", "backends", "utils",
                          "profiler", "testing", "hub", "jit", "compiler",
                          "library", "multiprocessing", "version"}
_TORCH_HOST = {"no_grad", "enable_grad", "inference_mode", "set_grad_enabled",
               "is_grad_enabled", "device", "Generator", "manual_seed",
               "seed", "initial_seed", "is_tensor", "is_floating_point",
               "get_default_dtype", "set_default_dtype", "finfo", "iinfo",
               "Size", "dtype", "autocast", "set_printoptions",
               "use_deterministic_algorithms"}
# factories: a tensor on the host unless a device is named
_TORCH_FACTORIES = {"tensor", "as_tensor", "from_numpy", "zeros", "ones",
                    "empty", "full", "arange", "linspace", "logspace", "eye",
                    "rand", "randn", "randint", "randperm"}
# attribute reads that are host metadata of a tensor
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda",
                 "requires_grad"}

# per-value conversions: one host sync (or host conversion) per value
_SCALAR_BUILTINS = {"float", "int", "bool", "complex"}
# transfers off the device; the result is a host tensor / array
_FETCH_METHODS = {"cpu", "numpy"}


def _target_names(target: ast.expr) -> List[str]:
    """The names an assignment target binds (not ``i`` of ``x[i] = v``)."""
    return [e.id for e in ast.walk(target)
            if isinstance(e, ast.Name) and isinstance(e.ctx, ast.Store)]


def _terminates(stmts: List[ast.stmt]) -> bool:
    """Does control flow definitely leave this statement list?"""
    return any(isinstance(s, (ast.Return, ast.Raise, ast.Break,
                              ast.Continue)) for s in stmts)


def _local_names(fi: FuncInfo) -> Set[str]:
    """Parameter + locally-bound names of a function (shallow)."""
    node = fi.node
    names: Set[str] = set(fi.params)
    a = node.args
    for extra in ([a.vararg] if a.vararg else []) + \
                 ([a.kwarg] if a.kwarg else []) + list(a.kwonlyargs):
        names.add(extra.arg)
    for n in shallow_walk(node):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            tgts = n.targets if isinstance(n, ast.Assign) else [n.target]
            for t in tgts:
                names.update(_target_names(t))
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            names.update(_target_names(n.target))
        elif isinstance(n, ast.comprehension):
            names.update(_target_names(n.target))
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            names.update(_target_names(n.optional_vars))
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.ExceptHandler) and n.name:
            names.add(n.name)
    return names


def _is_cpu_to(call: ast.Call) -> bool:
    """``x.to("cpu")`` / ``x.to(device="cpu")``."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    vals = list(call.args[:1]) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
    return any(isinstance(v, ast.Constant) and v.value == "cpu" for v in vals)


def _fetch_receiver(call: ast.Call) -> Optional[ast.expr]:
    """The tensor a transfer off the device reads (``x`` of ``x.cpu()``,
    ``x.numpy()``, ``x.tolist()``, ``x.to("cpu")``, ``np.asarray(x)``),
    else None."""
    f = call.func
    if isinstance(f, ast.Attribute) and not call.args and \
            not call.keywords and f.attr in _FETCH_METHODS | {"tolist"}:
        return f.value
    if _is_cpu_to(call):
        return call.func.value
    if isinstance(f, ast.Attribute) and f.attr in ("asarray", "array") \
            and attr_chain(f)[:1] in (["np"], ["numpy"]) and call.args:
        return call.args[0]
    return None


def _scalar_arg(call: ast.Call) -> Optional[ast.expr]:
    """The value a per-value conversion reads (``x`` of ``float(x)``,
    ``int(x)``, ``x.item()``), else None."""
    f = call.func
    if isinstance(f, ast.Name) and f.id in _SCALAR_BUILTINS \
            and len(call.args) == 1:
        return call.args[0]
    if isinstance(f, ast.Attribute) and f.attr == "item" and not call.args:
        return f.value
    return None


def _is_fetch(e: ast.expr) -> bool:
    return isinstance(e, ast.Call) and _fetch_receiver(e) is not None


# ------------------------------------------------------- step dispatchers
class _Dispatch:
    """Which calls of one module dispatch a training step: the port's
    ``jax.jit`` dispatch.  A step dispatcher is a function that directly
    calls a captured root (``BaseTrainer.step`` runs ``_step_body``, which
    ``FusedStep`` captures), or a callable built by a dispatching
    constructor: ``torch.cuda.make_graphed_callables(...)``, a call of a
    capture wrapper, an instance of a class with a capturing method
    (``FusedStep``) or a function returning one (``make_fused_step``);
    also through a name or ``self.<attr>`` bound to one."""

    @classmethod
    def of(cls, module: Module, graph: ScopeGraph) -> "_Dispatch":
        """The module's index, built once per run (R002 and R007 share
        it)."""
        key = ("dispatch", module.rel)
        if key not in graph.derived:
            graph.derived[key] = cls(module, graph)
        return graph.derived[key]

    def __init__(self, module: Module, graph: ScopeGraph):
        self.module = module
        self.graph = graph
        self.imports = graph.imports.get(module.rel, {})
        self._steppers: Dict[int, bool] = {}
        self._ctors: Dict[int, bool] = {}
        self._locals: Dict[int, Set[str]] = {}
        # class -> self.<attr>s holding dispatchers
        self.class_attrs: Dict[str, Set[str]] = {}
        for fi in graph.module_functions(module):
            if isinstance(fi.node, ast.Lambda) or fi.class_name is None:
                continue
            for n in graph.walk(fi.node):
                if isinstance(n, ast.Assign) and self.is_ctor(n.value, fi):
                    for t in n.targets:
                        for attr in rebound_self_attrs(t):
                            self.class_attrs.setdefault(
                                fi.class_name, set()).add(attr)

    def is_ctor(self, value: ast.expr, fi: Optional[FuncInfo],
                depth: int = 0) -> bool:
        """Does evaluating ``value`` build a step dispatcher?"""
        if isinstance(value, ast.IfExp):
            return (self.is_ctor(value.body, fi, depth)
                    or self.is_ctor(value.orelse, fi, depth))
        if not isinstance(value, ast.Call):
            return False
        hit = self._ctors.get(id(value))
        if hit is None:
            hit = self._ctors[id(value)] = self._builds(value, fi, depth)
        return hit

    def _builds(self, value: ast.Call, fi: Optional[FuncInfo],
                depth: int) -> bool:
        if qualified(value.func, self.imports) == \
                "torch.cuda.make_graphed_callables":
            return True
        name = last_name(value.func)
        if any(id(m.node) in self.graph.capturing
               for ci in self.graph.classes.get(name or "", [])
               for m in ci.methods.values()):
            return True
        for t in self.graph.resolve_call(value, self.module, fi):
            if CAPTURED in self.graph.wrapper_positions.get(id(t.node), {}):
                return True
            if depth < 2 and not isinstance(t.node, ast.Lambda) and any(
                    isinstance(r, ast.Return) and r.value is not None
                    and self.is_ctor(r.value, t, depth + 1)
                    for r in self.graph.walk(t.node)):
                return True
        return False

    def local_names(self, fi: FuncInfo) -> Set[str]:
        """Names in ``fi`` bound to step dispatchers."""
        out = self._locals.get(id(fi.node))
        if out is None:
            out = self._locals[id(fi.node)] = {
                t.id for n in self.graph.walk(fi.node)
                if isinstance(n, ast.Assign) and self.is_ctor(n.value, fi)
                for t in n.targets if isinstance(t, ast.Name)}
        return out

    def _is_stepper(self, fi: FuncInfo) -> bool:
        hit = self._steppers.get(id(fi.node))
        if hit is None:
            roots = self.graph.roots[CAPTURED]
            hit = any(t in roots
                      for t in self.graph.edges.get(id(fi.node), ()))
            self._steppers[id(fi.node)] = hit
        return hit

    def is_dispatch(self, call: ast.Call, fi: Optional[FuncInfo],
                    local: Set[str]) -> bool:
        f = call.func
        if isinstance(f, ast.Name) and f.id in local:
            return True
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id == "self" and fi is not None:
            cls = _enclosing_class(fi)
            if cls and any(f.attr in self.class_attrs.get(c, ())
                           for c in self.graph.family(cls)):
                return True
        if isinstance(f, ast.Call) and self.is_ctor(f, fi):
            return True               # make_graphed_callables(g, a)(x)
        return any(self._is_stepper(t) for t in
                   self.graph.resolve_call(call, self.module, fi))


# =========================================================================
@register_rule
class R000SuppressionHygiene(Rule):
    id = "R000"
    name = "suppression-without-justification"
    rationale = ("a `# torchlint: disable=` without a reason hides risk "
                 "silently; audits need the why next to the what")

    def check(self, module: Module, graph: ScopeGraph) -> Iterator[Finding]:
        known = set(rule_ids())
        for sup in module.suppressions:
            snippet = module.lines[sup.line - 1].strip() \
                if sup.line <= len(module.lines) else ""
            if not sup.rules:
                yield Finding(self.id, module.rel, sup.line, 0,
                              "torchlint suppression names no rule ids "
                              "(expected `# torchlint: disable=R0xx — "
                              "<reason>`)", snippet)
                continue
            bad = [r for r in sup.rules if r not in known]
            if bad:
                yield Finding(self.id, module.rel, sup.line, 0,
                              f"torchlint suppression names unknown rule "
                              f"id(s) {bad}", snippet)
            if not sup.reason:
                yield Finding(self.id, module.rel, sup.line, 0,
                              f"torchlint suppression of "
                              f"{','.join(sup.rules)} has no justification "
                              "— write `# torchlint: disable=R0xx — "
                              "<reason>`", snippet)


# =========================================================================
@register_rule
class R001SeedReuse(Rule):
    id = "R001"
    name = "seed-reuse"
    rationale = ("two generators seeded with the same seed draw the same "
                 "\"random\" numbers (the PRNG-key-reuse class) — fold the "
                 "seed per stream first (fold_seed(seed, i))")

    def check(self, module: Module, graph: ScopeGraph) -> Iterator[Finding]:
        for fi in graph.module_functions(module):
            if not isinstance(fi.node, ast.Lambda):
                yield from self._check_func(module, graph, fi)

    def _check_func(self, module: Module, graph: ScopeGraph, fi: FuncInfo
                    ) -> Iterator[Finding]:
        # a generator feeds samplers when its expression is read other than
        # as the receiver of its own manual_seed
        seeded_recv: Set[int] = set()
        for n in graph.walk(fi.node):
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) \
                    and n.func.attr == "manual_seed":
                seeded_recv.add(id(n.func.value))
        read = {ast.unparse(n) for n in graph.walk(fi.node)
                if isinstance(n, (ast.Name, ast.Attribute))
                and isinstance(n.ctx, ast.Load) and id(n) not in seeded_recv}
        versions: Dict[str, int] = {}
        # (seed expression, versions of its names) -> first seeding call
        seen: Dict[Tuple, ast.Call] = {}
        findings: List[Finding] = []
        reported: Set[int] = set()

        def bump(names) -> None:
            for name in names:
                versions[name] = versions.get(name, 0) + 1

        def seed(call: ast.Call, holder: Optional[str]) -> None:
            recv = call.func.value
            if isinstance(recv, ast.Call):
                used = holder is None or holder in read  # a fresh generator
            elif attr_chain(recv)[:1] == ["torch"]:
                used = True                       # the global generator
            else:
                used = ast.unparse(recv) in read
            if not used or len(call.args) != 1:
                return
            arg = call.args[0]
            names = sorted({e.id for e in ast.walk(arg)
                            if isinstance(e, ast.Name)})
            key = (ast.dump(arg),
                   tuple((n, versions.get(n, 0)) for n in names))
            first = seen.get(key)
            if first is not None and id(call) not in reported:
                reported.add(id(call))
                where = ("on an earlier iteration" if first is call
                         else f"at line {first.lineno}")
                findings.append(self.finding(
                    module, call,
                    f"seed `{ast.unparse(arg)}` already seeded a generator "
                    f"{where} — both draw the same numbers; fold the seed "
                    "per stream (fold_seed(seed, i))"))
            seen.setdefault(key, call)

        def scan(node: ast.AST, holder: Optional[str] = None) -> None:
            """Seeding calls in evaluation order; a comprehension's element
            runs twice, its targets rebound in between."""
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef, ast.Lambda)):
                return
            if isinstance(node, (ast.ListComp, ast.SetComp,
                                 ast.GeneratorExp, ast.DictComp)):
                targets = [name for g in node.generators
                           for name in _target_names(g.target)]
                for g in node.generators:
                    scan(g.iter)
                elts = ([node.key, node.value]
                        if isinstance(node, ast.DictComp) else [node.elt])
                for _ in range(2):
                    bump(targets)
                    for e in elts:
                        scan(e)
                return
            for child in ast.iter_child_nodes(node):
                scan(child)
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "manual_seed":
                seed(node, holder)

        def exec_stmts(stmts: List[ast.stmt]) -> None:
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                if isinstance(s, ast.If):
                    scan(s.test)
                    base = dict(seen)
                    exec_stmts(s.body)
                    after_body = dict(seen)
                    seen.clear()
                    seen.update(base)
                    exec_stmts(s.orelse)
                    if _terminates(s.orelse):
                        seen.clear()
                        seen.update(base)
                    if not _terminates(s.body):
                        # branch merge (a terminating branch never reaches
                        # the fall-through)
                        for k, v in after_body.items():
                            seen.setdefault(k, v)
                    continue
                if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                    scan(s.iter if isinstance(s, (ast.For, ast.AsyncFor))
                         else s.test)
                    for _ in range(2):          # loop-carried reuse
                        if isinstance(s, (ast.For, ast.AsyncFor)):
                            bump(_target_names(s.target))
                        exec_stmts(s.body)
                    exec_stmts(s.orelse)
                    continue
                if isinstance(s, ast.Try):
                    exec_stmts(s.body)
                    for h in s.handlers:
                        exec_stmts(h.body)
                    exec_stmts(s.orelse)
                    exec_stmts(s.finalbody)
                    continue
                if isinstance(s, (ast.With, ast.AsyncWith)):
                    for item in s.items:
                        scan(item.context_expr)
                    exec_stmts(s.body)
                    continue
                if isinstance(s, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    tgts = (s.targets if isinstance(s, ast.Assign)
                            else [s.target])
                    holder = (tgts[0].id if len(tgts) == 1
                              and isinstance(tgts[0], ast.Name) else
                              ast.unparse(tgts[0]) if len(tgts) == 1
                              and isinstance(tgts[0], ast.Attribute)
                              else None)
                    if s.value is not None:
                        scan(s.value, holder)
                    for t in tgts:
                        bump(_target_names(t))
                    continue
                scan(s)

        exec_stmts(fi.node.body)
        yield from findings


# =========================================================================
@register_rule
class R002HostSyncInHotLoop(Rule):
    id = "R002"
    name = "host-sync-in-hot-loop"
    rationale = ("per-value float()/.item() or per-tensor .cpu()/.tolist() "
                 "in a step loop serializes host/device round-trips (the "
                 "per-metric sync class: ~8 syncs per train step) — stack "
                 "once, fetch once, convert once")

    #: conversions (or transfers) inside one loop body are only flagged
    #: from this count on: a single fetch per iteration is the sanctioned
    #: pattern; the bug class is per-METRIC fan-out
    LOOP_SYNC_THRESHOLD = 2

    def check(self, module: Module, graph: ScopeGraph) -> Iterator[Finding]:
        # captured code also runs eagerly (the first step, and every step
        # without perf.fuse_step), so no function is exempt
        dispatch = _Dispatch.of(module, graph)
        for fi in graph.module_functions(module):
            if isinstance(fi.node, ast.Lambda):
                continue
            yield from self._check_body(module, graph, dispatch, fi,
                                        fi.node.body)
        yield from self._check_body(module, graph, dispatch, None,
                                    module.tree.body)

    # ------------------------------------------------------------------
    def _check_body(self, module: Module, graph: ScopeGraph,
                    dispatch: _Dispatch, fi: Optional[FuncInfo],
                    body: List[ast.stmt]) -> Iterator[Finding]:
        imports = graph.imports.get(module.rel, {})
        env: Dict[str, str] = {}           # name -> "dev" | "fetched"
        local_disp = dispatch.local_names(fi) if fi is not None else set()
        findings: List[Finding] = []
        reported: Set[int] = set()

        def is_device_call(call: ast.Call) -> bool:
            """A ``torch.*`` call that returns a tensor on the device."""
            parts = (qualified(call.func, imports) or "").split(".")
            if parts[0] != "torch" or len(parts) < 2:
                return False
            if parts[1] in _TORCH_HOST_NAMESPACES or parts[-1] in _TORCH_HOST:
                return False
            return parts[-1] not in _TORCH_FACTORIES or any(
                kw.arg == "device" for kw in call.keywords)

        def kind_of(e: ast.expr) -> Optional[str]:
            if isinstance(e, ast.Name):
                return env.get(e.id)
            if isinstance(e, ast.Call):
                if _is_fetch(e):
                    f = e.func
                    tolist = isinstance(f, ast.Attribute) and \
                        f.attr == "tolist"
                    return None if tolist else "fetched"
                if _scalar_arg(e) is not None:
                    return None              # a host Python number
                if is_device_call(e):
                    return "dev"
                if dispatch.is_dispatch(e, fi, local_disp):
                    return "dev"
                if isinstance(e.func, ast.Attribute):
                    return kind_of(e.func.value)   # x.mean(), m.items()
                return None
            if isinstance(e, ast.Attribute):
                if e.attr in _STATIC_ATTRS:
                    return None
                return kind_of(e.value)
            if isinstance(e, ast.Subscript):
                return kind_of(e.value)
            if isinstance(e, ast.BinOp):
                return _max_kind(kind_of(e.left), kind_of(e.right))
            if isinstance(e, ast.UnaryOp):
                return kind_of(e.operand)
            if isinstance(e, (ast.Tuple, ast.List)):
                k = None
                for el in e.elts:
                    k = _max_kind(k, kind_of(el))
                return k
            if isinstance(e, (ast.ListComp, ast.GeneratorExp)):
                return kind_of(e.elt)
            if isinstance(e, ast.DictComp):
                return kind_of(e.value)
            if isinstance(e, ast.IfExp):
                return _max_kind(kind_of(e.body), kind_of(e.orelse))
            if isinstance(e, ast.Starred):
                return kind_of(e.value)
            return None

        def fresh_dev(e: ast.expr) -> bool:
            return any(isinstance(n, ast.Call) and is_device_call(n)
                       for n in ast.walk(e))

        def calls(node: ast.AST) -> Iterator[ast.Call]:
            if isinstance(node, ast.Call):
                yield node
            for n in shallow_walk(node):
                if isinstance(n, ast.Call):
                    yield n

        def flag(call: ast.Call, msg: str) -> None:
            if id(call) not in reported:
                reported.add(id(call))
                findings.append(self.finding(module, call, msg))

        def check_fresh(s: ast.stmt) -> None:
            # a scalar conversion fused onto device compute: flagged anywhere
            for call in calls(s):
                arg = _scalar_arg(call)
                if arg is not None and fresh_dev(arg):
                    flag(call, "a scalar conversion of a freshly computed "
                               "device value forces an extra host sync — "
                               "convert from an already-fetched tensor or "
                               "keep it on the device")

        def loop_syncs(loop: ast.stmt) -> None:
            """Per-value conversions and repeated transfers in one loop."""
            conv: List[Tuple[ast.Call, str]] = []
            fetches: List[ast.Call] = []
            for call in calls(loop):
                arg = _scalar_arg(call)
                if arg is not None:
                    k = kind_of(arg) or ("dev" if fresh_dev(arg) else None)
                    if k:
                        conv.append((call, k))
                    continue
                recv = _fetch_receiver(call)
                if recv is not None and not _is_fetch(recv) and \
                        (kind_of(recv) == "dev" or fresh_dev(recv)):
                    fetches.append(call)
            if len(conv) >= self.LOOP_SYNC_THRESHOLD:
                for call, k in conv:
                    origin = ("on a device value" if k == "dev" else
                              "on an already-fetched value")
                    flag(call, f"per-value conversion {origin} inside a hot "
                               f"loop — {len(conv)} conversions per "
                               "iteration; stack the values, fetch them "
                               "with ONE .cpu().tolist() and convert at "
                               "the transfer site")
            if len(fetches) >= self.LOOP_SYNC_THRESHOLD:
                for call in fetches:
                    flag(call, f"{len(fetches)} transfers off the device per "
                               "loop iteration — torch.stack them into one "
                               "transfer")

        def walk_stmts(stmts: List[ast.stmt], in_loop: bool) -> None:
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
                    if isinstance(s, (ast.For, ast.AsyncFor)):
                        k = kind_of(s.iter)
                        for name in _target_names(s.target):
                            if k:
                                env[name] = k
                            else:
                                env.pop(name, None)
                    walk_stmts(s.body, True)   # pass 1: establish taint
                    if not in_loop:
                        loop_syncs(s)          # ...then scan the loop
                    check_fresh(s)
                    walk_stmts(s.body, True)   # pass 2: loop-carried
                    walk_stmts(s.orelse, in_loop)
                    continue
                check_fresh(s)
                if isinstance(s, (ast.Assign, ast.AnnAssign)):
                    if s.value is not None:
                        k = kind_of(s.value)
                        tgts = (s.targets if isinstance(s, ast.Assign)
                                else [s.target])
                        for t in tgts:
                            for name in _target_names(t):
                                if k:
                                    env[name] = k
                                else:
                                    env.pop(name, None)
                elif isinstance(s, ast.If):
                    walk_stmts(s.body, in_loop)
                    walk_stmts(s.orelse, in_loop)
                elif isinstance(s, ast.Try):
                    walk_stmts(s.body, in_loop)
                    for h in s.handlers:
                        walk_stmts(h.body, in_loop)
                    walk_stmts(s.orelse, in_loop)
                    walk_stmts(s.finalbody, in_loop)
                elif isinstance(s, (ast.With, ast.AsyncWith)):
                    walk_stmts(s.body, in_loop)

        walk_stmts(body, False)
        yield from findings


def _max_kind(a: Optional[str], b: Optional[str]) -> Optional[str]:
    order = {None: 0, "fetched": 1, "dev": 2}
    return a if order[a] >= order[b] else b


# =========================================================================
@register_rule
class R003ReboundAttributeInCapture(Rule):
    id = "R003"
    name = "rebound-attribute-in-capture"
    rationale = ("a CUDA-graph replay reads the tensors its capture saw: an "
                 "attribute rebound after capture is silently stale (the "
                 "frozen-reference class), and a checkpointed forward "
                 "recomputes with the new value — write it in place")

    def check(self, module: Module, graph: ScopeGraph) -> Iterator[Finding]:
        for fi in graph.module_functions(module):
            kinds = graph.scope_kinds(fi)
            if not kinds:
                continue
            yield from self._check_self_reads(module, graph, fi, kinds[0])
            if fi.parent is not None:
                yield from self._check_nonlocal(module, graph, fi, kinds[0])

    def _check_self_reads(self, module: Module, graph: ScopeGraph,
                          fi: FuncInfo, kind: str) -> Iterator[Finding]:
        cls_name = _enclosing_class(fi)
        if not cls_name:
            return
        seen: Set[str] = set()
        for n in graph.walk(fi.node):
            if not (isinstance(n, ast.Attribute)
                    and isinstance(n.value, ast.Name)
                    and n.value.id == "self"
                    and isinstance(n.ctx, ast.Load)
                    and n.attr not in seen):
                continue
            seen.add(n.attr)
            # rebinding in __init__ happens before any capture; rebinding
            # inside a captured (or recomputed) scope is part of it
            writers = sorted({w.name for w in graph.family_attr_writers(
                cls_name, n.attr)
                if w.name not in ("__init__", "__post_init__")
                and not graph.scope_kinds(w)})
            if writers:
                yield self.finding(
                    module, n,
                    f"{kind} scope `{fi.qualname}` reads `self.{n.attr}`, "
                    f"which {writers} rebind outside any captured scope — "
                    "a graph replay keeps the tensor the capture read and "
                    "a recompute reads the new one; write it in place "
                    "(`.copy_`, `.fill_`) or pass it as an argument")

    def _check_nonlocal(self, module: Module, graph: ScopeGraph,
                        fi: FuncInfo, kind: str) -> Iterator[Finding]:
        local = _local_names(fi)
        explicit_nonlocal: Set[str] = {
            name for n in graph.walk(fi.node)
            if isinstance(n, ast.Nonlocal) for name in n.names}
        free_reads: Dict[str, ast.Name] = {}
        for n in graph.walk(fi.node):
            if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                    and n.id not in local \
                    and n.id not in explicit_nonlocal \
                    and n.id not in free_reads:
                free_reads[n.id] = n
        parent = fi.parent
        def_line = fi.node.lineno
        while parent is not None:
            for n in graph.walk(parent.node):
                if not isinstance(n, (ast.Assign, ast.AugAssign)):
                    continue
                if n.lineno <= def_line:
                    continue
                tgts = (n.targets if isinstance(n, ast.Assign)
                        else [n.target])
                for t in tgts:
                    for name in _target_names(t):
                        if name in free_reads and name != fi.name:
                            yield self.finding(
                                module, free_reads.pop(name),
                                f"{kind} closure `{fi.qualname}` captures "
                                f"`{name}`, reassigned at line {n.lineno} "
                                "after the definition — a replay keeps the "
                                "old value; pass it as an argument")
            parent = parent.parent


# =========================================================================
@register_rule
class R007BlockingDrainInDispatchLoop(Rule):
    id = "R007"
    name = "blocking-drain-in-dispatch-loop"
    rationale = (".item()/.cpu()/.tolist()/float()/synchronize() on the "
                 "output of the step dispatched in the SAME loop iteration "
                 "serializes host and device (the pre-pipeline TrainLoop "
                 "shape) — buffer results and drain them a step late")

    def check(self, module: Module, graph: ScopeGraph) -> Iterator[Finding]:
        dispatch = _Dispatch.of(module, graph)
        for fi in graph.module_functions(module):
            if isinstance(fi.node, ast.Lambda):
                continue
            yield from self._check_func(module, dispatch, fi)

    def _check_func(self, module: Module, dispatch: _Dispatch,
                    fi: FuncInfo) -> Iterator[Finding]:
        local_disp = dispatch.local_names(fi)
        findings: List[Finding] = []
        reported: Set[int] = set()

        def is_dispatch(call: ast.Call) -> bool:
            return dispatch.is_dispatch(call, fi, local_disp)

        def dispatched_in(e: ast.expr, hot: Set[str]) -> bool:
            return any(
                (isinstance(n, ast.Name) and n.id in hot)
                or (isinstance(n, ast.Call) and is_dispatch(n))
                for n in ast.walk(e))

        def sync_shapes(s: ast.stmt):
            """(call, drained expr or None for "everything", label) for the
            blocking fetches under s."""
            for n in shallow_walk(s):
                if not isinstance(n, ast.Call):
                    continue
                f = n.func
                if isinstance(f, ast.Attribute) and \
                        f.attr == "synchronize" and not n.args:
                    yield n, None, ".synchronize()"
                    continue
                arg = _scalar_arg(n)
                if arg is None:
                    recv = _fetch_receiver(n)
                    if recv is not None and not _is_fetch(recv):
                        arg = recv
                if arg is not None:
                    label = (f.id + "()" if isinstance(f, ast.Name) else
                             "." + f.attr + "()" if isinstance(
                                 f, ast.Attribute) else "fetch")
                    yield n, arg, label

        def targets_of(s: ast.stmt) -> List[str]:
            if isinstance(s, ast.Assign):
                names: List[str] = []
                for t in s.targets:
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        names.extend(e.id for e in t.elts
                                     if isinstance(e, ast.Name))
                return names
            if isinstance(s, ast.AnnAssign) and \
                    isinstance(s.target, ast.Name) and s.value is not None:
                return [s.target.id]
            return []

        def handle(stmts: List[ast.stmt], hot: Set[str],
                   it: Optional[Dict[str, bool]]) -> None:
            """``it`` is the running loop iteration's state (None outside
            a loop): whether a step was dispatched in it so far."""
            for s in stmts:
                if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.ClassDef)):
                    continue
                if isinstance(s, (ast.For, ast.While, ast.AsyncFor)):
                    handle(s.body, set(hot),
                           {"dispatched": bool(it and it["dispatched"])})
                    handle(s.orelse, set(hot), it)
                    continue
                if isinstance(s, ast.If):
                    a, b = set(hot), set(hot)
                    handle(s.body, a, it)
                    handle(s.orelse, b, it)
                    hot |= a | b
                    continue
                if isinstance(s, (ast.With, ast.AsyncWith)):
                    handle(s.body, hot, it)
                    continue
                if isinstance(s, ast.Try):
                    handle(s.body, hot, it)
                    for h in s.handlers:
                        handle(h.body, set(hot), it)
                    handle(s.orelse, hot, it)
                    handle(s.finalbody, hot, it)
                    continue
                if it is None:
                    continue
                for call, arg, label in sync_shapes(s):
                    if id(call) in reported:
                        continue
                    if (it["dispatched"] if arg is None
                            else dispatched_in(arg, hot)):
                        reported.add(id(call))
                        findings.append(self.finding(
                            module, call,
                            f"{label} on the output of the step dispatched "
                            "this iteration blocks until the device "
                            "finishes — dispatch runs ahead only if results "
                            "are buffered and drained >=1 step late "
                            "(deque) or after the loop"))
                if any(isinstance(n, ast.Call) and is_dispatch(n)
                       for n in shallow_walk(s)):
                    it["dispatched"] = True
                names = targets_of(s)
                hot.difference_update(names)
                value = getattr(s, "value", None)
                if names and isinstance(value, ast.Call) \
                        and is_dispatch(value):
                    hot.update(names)

        handle(fi.node.body, set(), None)
        yield from findings

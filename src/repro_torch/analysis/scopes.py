"""Captured- and recomputed-scope graph (the port of
``repro.analysis.scopes``).

Where the JAX package's linter asks one question of every function (can it
run under a JAX trace?), the port asks two, because eager PyTorch has two
places where code runs at another time than it reads its inputs:

- **captured**: the function is called, transitively, from the body of a
  ``with torch.cuda.graph(...)`` block, or is passed to
  ``torch.cuda.make_graphed_callables``.  A replay runs the kernels the
  capture recorded, on the tensors the capture saw: a Python value read
  there is frozen at capture time.
- **recomputed**: the function is the first argument of
  ``torch.utils.checkpoint.checkpoint``, so its forward runs again during
  the backward and must read what the first run read.

Construction, all stdlib ``ast`` (the reference's):

1. **Index** every function/method/lambda and class across the linted
   modules (nested defs are first-class nodes; classes record which
   methods rebind which ``self.<attr>``: R003's mutation map).
2. **Wrapper positions**: a repo function whose parameter flows into a
   capture block, ``make_graphed_callables`` or ``checkpoint`` (``def
   capture(fn): with torch.cuda.graph(g): fn()``) captures or recomputes
   that argument position at every call site.  Detection is transitive to
   a fixed point: a parameter forwarded into another wrapper's position
   makes the forwarding function a wrapper too.
3. **Roots**: every function called in a capture block, passed to one of
   the two function-taking calls, or passed at a wrapper position.
4. **Edges**: calls resolved by name: ``self.x`` binds within the class
   family (base + subclasses, so ``BaseTrainer`` reaching ``self.loss_fn``
   marks every trainer's override), module aliases bind to the imported
   module, a local name binds to the values assigned to it in its function
   (``fn`` of ``for fn, args in units``, ``functools.partial(f, ...)``, a
   parameter's default), anything else to every arity-compatible function
   of that name.  Deliberately over-approximate: a linter would rather walk
   into one function too many than miss a captured scope.
5. **Reachability**: BFS from each kind's roots; ``graph.is_captured(fn)``
   and ``graph.is_recomputed(fn)``.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from repro_torch.analysis.core import Module

CAPTURED = "captured"
RECOMPUTED = "recomputed"
KINDS = (CAPTURED, RECOMPUTED)

# calls that take a function, by qualified name: (kind, position of it)
FN_TAKERS: Dict[str, Tuple[str, int]] = {
    "torch.cuda.make_graphed_callables": (CAPTURED, 0),
    "torch.utils.checkpoint.checkpoint": (RECOMPUTED, 0),
}
# context managers whose body is captured into a CUDA graph
CAPTURE_BLOCKS = {"torch.cuda.graph"}

# local-binding resolution follows at most this many bindings in a row
_BINDING_DEPTH = 4


def last_name(expr: ast.expr) -> Optional[str]:
    """Trailing identifier of a Name/Attribute chain (``torch.cuda.graph``
    -> ``"graph"``)."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    if isinstance(expr, ast.Name):
        return expr.id
    return None


def attr_chain(expr: ast.expr) -> List[str]:
    """["torch", "cuda", "graph"] for ``torch.cuda.graph``; [] when the
    chain does not start at a name."""
    parts: List[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if not isinstance(expr, ast.Name):
        return []
    parts.append(expr.id)
    return list(reversed(parts))


def qualified(expr: ast.expr, imports: Dict[str, str]) -> Optional[str]:
    """The dotted name a Name/Attribute chain denotes through the module's
    imports (``cp.checkpoint`` with ``import torch.utils.checkpoint as cp``
    -> ``"torch.utils.checkpoint.checkpoint"``)."""
    chain = attr_chain(expr)
    if not chain:
        return None
    return ".".join([imports.get(chain[0], chain[0])] + chain[1:])


def is_capture_block(item: ast.withitem, imports: Dict[str, str]) -> bool:
    ctx = item.context_expr
    return (isinstance(ctx, ast.Call)
            and qualified(ctx.func, imports) in CAPTURE_BLOCKS)


def unwrap_partial(arg: ast.expr) -> ast.expr:
    """``f`` of ``functools.partial(f, ...)``, else ``arg``."""
    while isinstance(arg, ast.Call) and last_name(arg.func) == "partial" \
            and arg.args:
        arg = arg.args[0]
    return arg


def fn_taker_args(call: ast.Call, imports: Dict[str, str]
                  ) -> List[Tuple[str, ast.expr]]:
    """(kind, function expression) for each function ``call`` captures or
    recomputes: ``checkpoint(f, ...)``, ``make_graphed_callables(f, ...)``
    (or a tuple of callables), either through ``functools.partial``."""
    spec = FN_TAKERS.get(qualified(call.func, imports) or "")
    if spec is None or len(call.args) <= spec[1]:
        return []
    kind, pos = spec
    arg = unwrap_partial(call.args[pos])
    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) else [arg]
    return [(kind, unwrap_partial(e)) for e in elts]


def shallow_walk(node: ast.AST) -> Iterator[ast.AST]:
    """``ast.walk`` that does not descend into nested function/class
    definitions (they are separate graph nodes)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        n = stack.pop()
        yield n
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda,
                          ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(n))


def captured_calls(with_node: ast.With) -> Iterator[ast.Call]:
    """Every call in the body of a capture block (nested defs excluded)."""
    for stmt in with_node.body:
        for n in shallow_walk(stmt):
            if isinstance(n, ast.Call):
                yield n


def rebound_self_attrs(target: ast.expr) -> Iterator[str]:
    """``attr`` for each ``self.<attr>`` an assignment target rebinds;
    item assignment (``self.x[k] = v``) writes in place and rebinds
    nothing."""
    if isinstance(target, ast.Attribute):
        if isinstance(target.value, ast.Name) and target.value.id == "self":
            yield target.attr
    elif isinstance(target, (ast.Tuple, ast.List)):
        for e in target.elts:
            yield from rebound_self_attrs(e)
    elif isinstance(target, ast.Starred):
        yield from rebound_self_attrs(target.value)


class FuncInfo:
    """One function/method/lambda definition."""

    __slots__ = ("node", "module", "name", "qualname", "class_name",
                 "parent", "is_method", "min_pos", "max_pos", "kw_names",
                 "has_varkw", "params", "defaults")

    def __init__(self, node, module: Module, name: str, qualname: str,
                 class_name: Optional[str], parent: Optional["FuncInfo"]):
        self.node = node
        self.module = module
        self.name = name
        self.qualname = qualname
        self.class_name = class_name
        self.parent = parent
        a = node.args
        pos = list(a.posonlyargs) + list(a.args)
        self.params = [p.arg for p in pos]
        self.is_method = (class_name is not None and parent is None
                          and bool(pos) and pos[0].arg in ("self", "cls"))
        n_self = 1 if self.is_method else 0
        self.min_pos = max(0, len(pos) - len(a.defaults) - n_self)
        self.max_pos = None if a.vararg else len(pos) - n_self
        self.kw_names = {p.arg for p in pos[n_self:]} | \
                        {p.arg for p in a.kwonlyargs}
        self.has_varkw = a.kwarg is not None
        # parameter -> default expression (evaluated in the parent scope)
        self.defaults: Dict[str, ast.expr] = dict(zip(
            self.params[len(pos) - len(a.defaults):], a.defaults))
        self.defaults.update((p.arg, d) for p, d in
                             zip(a.kwonlyargs, a.kw_defaults) if d is not None)

    def accepts(self, npos: int, kwnames: Set[str], lenient: bool) -> bool:
        """Could a call with ``npos`` positional args + ``kwnames`` bind?"""
        if lenient:
            return True
        if self.max_pos is not None and npos > self.max_pos:
            return False
        if not self.has_varkw and not (kwnames <= self.kw_names):
            return False
        if npos + len(kwnames) < self.min_pos:
            return False
        return True

    def __repr__(self):
        return f"<FuncInfo {self.module.rel}:{self.qualname}>"


class ClassInfo:
    __slots__ = ("node", "module", "name", "bases", "methods",
                 "attr_writers")

    def __init__(self, node: ast.ClassDef, module: Module):
        self.node = node
        self.module = module
        self.name = node.name
        self.bases = [last_name(b) for b in node.bases
                      if last_name(b) is not None]
        self.methods: Dict[str, FuncInfo] = {}
        # attr -> {method names that rebind self.attr}
        self.attr_writers: Dict[str, Set[str]] = {}


class ScopeGraph:
    def __init__(self, modules: Sequence[Module]):
        self.modules = list(modules)
        self.functions: Dict[int, FuncInfo] = {}        # id(node) -> info
        self.by_name: Dict[str, List[FuncInfo]] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}   # name -> defs
        self.module_by_dotted: Dict[str, Module] = {}
        self.imports: Dict[str, Dict[str, str]] = {}    # rel -> alias->dotted
        self.module_funcs: Dict[str, Dict[str, FuncInfo]] = {}
        # function -> kind -> positions whose argument it captures or
        # recomputes
        self.wrapper_positions: Dict[int, Dict[str, Set[int]]] = {}
        # functions holding a capture block or a make_graphed_callables call
        self.capturing: Set[int] = set()
        self.edges: Dict[int, Set[int]] = {}
        self.roots: Dict[str, Set[int]] = {k: set() for k in KINDS}
        self.reached: Dict[str, Set[int]] = {k: set() for k in KINDS}
        self._family_cache: Dict[str, Set[str]] = {}
        self._bound_cache: Dict[int, Set[str]] = {}
        self._nested_cache: Dict[int, Dict[str, FuncInfo]] = {}
        self._resolve_memo: Dict[int, List[FuncInfo]] = {}
        self._walk_cache: Dict[int, List[ast.AST]] = {}
        #: per-run data that rules derive once and share, by key
        self.derived: Dict[tuple, object] = {}

        for mod in self.modules:
            self.module_by_dotted[mod.dotted] = mod
            self._index_module(mod)
        self._find_wrappers()
        for mod in self.modules:
            self._roots_and_edges(mod)
        self._bfs()

    # ------------------------------------------------------------- indexing
    def _index_module(self, mod: Module) -> None:
        imports: Dict[str, str] = {}
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    # ``import a.b`` binds ``a``, the top package
                    imports[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module:
                for a in node.names:
                    imports[a.asname or a.name] = f"{node.module}.{a.name}"
        self.imports[mod.rel] = imports
        self.module_funcs[mod.rel] = {}
        new_classes: List[ClassInfo] = []

        def visit(node, cls: Optional[ClassInfo], fn: Optional[FuncInfo],
                  qual: str):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    ci = ClassInfo(child, mod)
                    self.classes.setdefault(ci.name, []).append(ci)
                    new_classes.append(ci)
                    visit(child, ci, None, f"{qual}{child.name}.")
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    fi = FuncInfo(child, mod, child.name,
                                  f"{qual}{child.name}",
                                  cls.name if cls else
                                  (fn.class_name if fn else None), fn)
                    self._add_func(fi, mod, cls, fn)
                    visit(child, None, fi, f"{qual}{child.name}.")
                elif isinstance(child, ast.Lambda):
                    fi = FuncInfo(child, mod, "<lambda>",
                                  f"{qual}<lambda>",
                                  fn.class_name if fn else
                                  (cls.name if cls else None), fn)
                    self.functions[id(child)] = fi
                    visit(child, None, fi, f"{qual}<lambda>.")
                else:
                    visit(child, cls, fn, qual)

        visit(mod.tree, None, None, "")

        # self.<attr> rebinding map, per class
        for ci in new_classes:
            for mname, mi in ci.methods.items():
                for n in ast.walk(mi.node):
                    if isinstance(n, ast.Assign):
                        tgts = n.targets
                    elif isinstance(n, ast.AugAssign) or (
                            isinstance(n, ast.AnnAssign)
                            and n.value is not None):
                        tgts = [n.target]
                    else:
                        continue
                    for t in tgts:
                        for attr in rebound_self_attrs(t):
                            ci.attr_writers.setdefault(attr, set()).add(mname)

    def _add_func(self, fi: FuncInfo, mod: Module, cls: Optional[ClassInfo],
                  parent: Optional[FuncInfo]) -> None:
        self.functions[id(fi.node)] = fi
        self.by_name.setdefault(fi.name, []).append(fi)
        if cls is not None and parent is None:
            cls.methods[fi.name] = fi
        if cls is None and parent is None:
            self.module_funcs[mod.rel][fi.name] = fi

    # ------------------------------------------------------------- wrappers
    def _find_wrappers(self) -> None:
        """Functions whose parameter flows into a capture block,
        ``make_graphed_callables`` or ``checkpoint``: calling them captures
        or recomputes that argument.

        Runs to a fixed point, so the property is transitive: a parameter
        forwarded into an already-known wrapper's position makes the
        forwarding function a wrapper at that position too."""
        for fi in list(self.functions.values()):
            if isinstance(fi.node, ast.Lambda):
                continue
            imports = self.imports[fi.module.rel]
            params = fi.params[1:] if fi.is_method else fi.params
            for n in self.walk(fi.node):
                if isinstance(n, ast.Call):
                    takers = fn_taker_args(n, imports)
                    if any(k == CAPTURED for k, _ in takers):
                        self.capturing.add(id(fi.node))
                    for kind, arg in takers:
                        if isinstance(arg, ast.Name) and arg.id in params:
                            self._mark_wrapper(fi, kind,
                                               params.index(arg.id))
                elif isinstance(n, ast.With) and any(
                        is_capture_block(i, imports) for i in n.items):
                    self.capturing.add(id(fi.node))
                    for c in captured_calls(n):
                        f = unwrap_partial(c.func)
                        if isinstance(f, ast.Name) and f.id in params:
                            self._mark_wrapper(fi, CAPTURED,
                                               params.index(f.id))
        # transitive closure over wrapper-to-wrapper forwarding
        changed = True
        while changed:
            changed = False
            for fi in list(self.functions.values()):
                if isinstance(fi.node, ast.Lambda):
                    continue
                params = fi.params[1:] if fi.is_method else fi.params
                for n in self.walk(fi.node):
                    if not isinstance(n, ast.Call):
                        continue
                    for callee in self.resolve_call(n, fi.module, fi):
                        if self._inherit_wrapper(fi, params, n, callee):
                            changed = True

    def _mark_wrapper(self, fi: FuncInfo, kind: str, pos: int) -> bool:
        wp = self.wrapper_positions.setdefault(id(fi.node), {})
        if pos in wp.get(kind, ()):
            return False
        wp.setdefault(kind, set()).add(pos)
        return True

    def _inherit_wrapper(self, fi: FuncInfo, params: List[str],
                         call: ast.Call, callee: FuncInfo) -> bool:
        """Propagate ``callee``'s wrapper marks onto ``fi`` when one of
        ``fi``'s parameters is forwarded positionally into a wrapped
        position of ``callee``.  Returns True when anything new landed."""
        by_kind = self.wrapper_positions.get(id(callee.node))
        if not by_kind or callee.node is fi.node:
            return False
        changed = False
        for kind, positions in list(by_kind.items()):
            for idx in positions:
                if idx >= len(call.args):
                    continue
                arg = unwrap_partial(call.args[idx])
                if isinstance(arg, ast.Name) and arg.id in params:
                    changed |= self._mark_wrapper(fi, kind,
                                                  params.index(arg.id))
        return changed

    # ------------------------------------------------------ class families
    def family(self, class_name: str) -> Set[str]:
        """Names connected to ``class_name`` through base-class edges (both
        directions): a base reaching ``self.x`` may bind any subclass
        override and vice versa."""
        if class_name in self._family_cache:
            return self._family_cache[class_name]
        adj: Dict[str, Set[str]] = {}
        for name, cis in self.classes.items():
            adj.setdefault(name, set())
            for ci in cis:
                for b in ci.bases:
                    if b in self.classes:
                        adj[name].add(b)
                        adj.setdefault(b, set()).add(name)
        seen = {class_name}
        frontier = [class_name]
        while frontier:
            cur = frontier.pop()
            for nxt in adj.get(cur, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        self._family_cache[class_name] = seen
        return seen

    def family_methods(self, class_name: str, method: str) -> List[FuncInfo]:
        out = []
        for cname in self.family(class_name):
            for ci in self.classes.get(cname, []):
                if method in ci.methods:
                    out.append(ci.methods[method])
        return out

    def family_attr_writers(self, class_name: str, attr: str
                            ) -> List[FuncInfo]:
        """The methods of ``class_name``'s family that rebind
        ``self.<attr>``."""
        out: List[FuncInfo] = []
        for cname in self.family(class_name):
            for ci in self.classes.get(cname, []):
                out.extend(ci.methods[m]
                           for m in sorted(ci.attr_writers.get(attr, ())))
        return out

    # ----------------------------------------------------------- resolution
    def resolve_callable(self, expr: ast.expr, mod: Module,
                         encl: Optional[FuncInfo]) -> List[FuncInfo]:
        """Function definitions a function-valued expression may denote."""
        return self._resolve(expr, mod, encl, 0)[0]

    def _resolve(self, expr: ast.expr, mod: Module, encl: Optional[FuncInfo],
                 depth: int) -> Tuple[List[FuncInfo], bool]:
        """(candidates, exact): ``exact`` is False when the value came
        through a binding or a ``partial``, whose arity the call site does
        not show."""
        if isinstance(expr, ast.Lambda):
            fi = self.functions.get(id(expr))
            return ([fi] if fi else []), True
        if isinstance(expr, ast.Call):
            inner = unwrap_partial(expr)
            if inner is expr:
                return self._resolve_returned(expr, mod, encl, depth), False
            return self._resolve(inner, mod, encl, depth)[0], False
        if isinstance(expr, (ast.IfExp, ast.BoolOp)):
            branches = ([expr.body, expr.orelse]
                        if isinstance(expr, ast.IfExp) else expr.values)
            out: Dict[int, FuncInfo] = {}
            for b in branches:
                for hit in self._resolve(b, mod, encl, depth)[0]:
                    out[id(hit.node)] = hit
            return list(out.values()), False
        if isinstance(expr, ast.Subscript):
            return self._resolve_stored(expr.value, mod, encl, depth), False
        if isinstance(expr, ast.Name):
            # enclosing nested defs, then module level, then global
            f = encl
            while f is not None:
                hit = self._nested_defs(f).get(expr.id)
                if hit is not None:
                    return [hit], True
                # a local binding shadows everything: what it may hold is
                # what the function assigns to it
                if expr.id in self._bound_names(f):
                    return self._resolve_binding(expr.id, f, mod, depth), \
                        False
                f = f.parent
            if expr.id in self.module_funcs.get(mod.rel, {}):
                return [self.module_funcs[mod.rel][expr.id]], True
            dotted = self.imports.get(mod.rel, {}).get(expr.id)
            if dotted:
                hit = self._resolve_dotted(dotted)
                if hit:
                    return hit, True
            if expr.id in self._module_assigned(mod):
                return [], True
            return self.by_name.get(expr.id, []), True
        if isinstance(expr, ast.Attribute):
            name = expr.attr
            recv = expr.value
            if isinstance(recv, ast.Name) and recv.id in ("self", "cls"):
                cls_name = _enclosing_class(encl)
                if cls_name:
                    hits = self.family_methods(cls_name, name)
                    if hits:
                        return hits, True
                return [fi for fi in self.by_name.get(name, [])
                        if fi.is_method], True
            if isinstance(recv, ast.Name):
                alias = self.imports.get(mod.rel, {}).get(recv.id)
                if alias and alias in self.module_by_dotted:
                    target = self.module_by_dotted[alias]
                    hit = self.module_funcs.get(target.rel, {}).get(name)
                    if hit:
                        return [hit], True
                    # a package re-exporting a submodule's function
                    hits = self._resolve_dotted(
                        self.imports.get(target.rel, {}).get(name, ""))
                    if hits:
                        return hits, True
            # `<recv>.get(...)` etc. is almost always a container op, not
            # a repo method: the global fallback would wire dict lookups
            # to every class that happens to define `get`
            if name in _CONTAINER_PROTOCOL:
                return [], True
            return self.by_name.get(name, []), True
        return [], True

    def _resolve_binding(self, name: str, fi: FuncInfo, mod: Module,
                         depth: int) -> List[FuncInfo]:
        """The functions a name bound in ``fi`` may hold: what its
        assignments, its ``for`` targets (over a local list of tuples) and
        its default (a parameter) evaluate to."""
        if depth >= _BINDING_DEPTH:
            return []
        out: Dict[int, FuncInfo] = {}

        def add(expr: ast.expr, scope: Optional[FuncInfo]) -> None:
            for hit in self._resolve(expr, mod, scope, depth + 1)[0]:
                out[id(hit.node)] = hit

        if name in fi.defaults:
            add(fi.defaults[name], fi.parent)
        body = self.walk(fi.node)
        for value in _binding_values(body, name):
            add(value, fi)
        for n in body:
            if not isinstance(n, (ast.For, ast.comprehension)):
                continue
            pos = _target_position(n.target, name)
            if pos is None:
                continue
            for elt in _iter_elements(body, n.iter):
                if pos == -1:
                    add(elt, fi)
                elif isinstance(elt, ast.Tuple) and pos < len(elt.elts):
                    add(elt.elts[pos], fi)
        return list(out.values())

    def _resolve_returned(self, call: ast.Call, mod: Module,
                          encl: Optional[FuncInfo],
                          depth: int) -> List[FuncInfo]:
        """The functions a call may return: what each candidate callee's
        ``return`` statements evaluate to in its own scope (a factory
        returning its nested ``run``), or, for ``<container>.get(k)`` on
        ``self.<attr>``, what the class family stores in that attribute."""
        if depth >= _BINDING_DEPTH:
            return []
        f = call.func
        if isinstance(f, ast.Attribute) and f.attr == "get":
            return self._resolve_stored(f.value, mod, encl, depth)
        out: Dict[int, FuncInfo] = {}
        for callee in self._resolve(f, mod, encl, depth + 1)[0]:
            if isinstance(callee.node, ast.Lambda):
                values = [callee.node.body]
            else:
                values = [n.value for n in self.walk(callee.node)
                          if isinstance(n, ast.Return)
                          and n.value is not None]
            for v in values:
                for hit in self._resolve(v, callee.module, callee,
                                         depth + 1)[0]:
                    out[id(hit.node)] = hit
        return list(out.values())

    def _resolve_stored(self, container: ast.expr, mod: Module,
                        encl: Optional[FuncInfo],
                        depth: int) -> List[FuncInfo]:
        """The functions read back from ``self.<attr>[k]`` (or
        ``self.<attr>.get(k)``): every value the class family assigns to
        an item of ``self.<attr>``."""
        cls_name = _enclosing_class(encl)
        if not (cls_name and isinstance(container, ast.Attribute)
                and isinstance(container.value, ast.Name)
                and container.value.id == "self") \
                or depth >= _BINDING_DEPTH:
            return []
        out: Dict[int, FuncInfo] = {}
        for cname in self.family(cls_name):
            for ci in self.classes.get(cname, []):
                for mi in ci.methods.values():
                    for n in self.walk(mi.node):
                        if not isinstance(n, ast.Assign) or not any(
                                _is_self_item(t, container.attr)
                                for t in n.targets):
                            continue
                        for hit in self._resolve(n.value, mi.module, mi,
                                                 depth + 1)[0]:
                            out[id(hit.node)] = hit
        return list(out.values())

    def _resolve_dotted(self, dotted: str) -> List[FuncInfo]:
        if dotted in self.module_by_dotted:
            return []
        mod_path, _, sym = dotted.rpartition(".")
        target = self.module_by_dotted.get(mod_path)
        if target:
            hit = self.module_funcs.get(target.rel, {}).get(sym)
            if hit:
                return [hit]
        return []

    def resolve_call(self, call: ast.Call, mod: Module,
                     encl: Optional[FuncInfo]) -> List[FuncInfo]:
        """Call targets, arity-filtered (a 5-arg ``scheduler.step(...)``
        never binds a 2-arg ``Trainer.step``).  Memoized per call node:
        several rules resolve the same calls."""
        memo = self._resolve_memo.get(id(call))
        if memo is not None:
            return memo
        cands, exact = self._resolve(call.func, mod, encl, 0)
        lenient = (not exact
                   or any(isinstance(a, ast.Starred) for a in call.args)
                   or any(kw.arg is None for kw in call.keywords))
        npos = len(call.args)
        kwnames = {kw.arg for kw in call.keywords if kw.arg}
        out = [fi for fi in cands if fi.accepts(npos, kwnames, lenient)]
        self._resolve_memo[id(call)] = out
        return out

    # -------------------------------------------------------- roots + edges
    def _roots_and_edges(self, mod: Module) -> None:
        imports = self.imports[mod.rel]

        def add_roots(kind: str, fis: Sequence[FuncInfo]) -> None:
            self.roots[kind].update(id(fi.node) for fi in fis)

        def handle_body(owner: Optional[FuncInfo], body_owner_node):
            for n in self.walk(body_owner_node):
                if isinstance(n, ast.With) and any(
                        is_capture_block(i, imports) for i in n.items):
                    for c in captured_calls(n):
                        add_roots(CAPTURED, self.resolve_call(c, mod, owner))
                if not isinstance(n, ast.Call):
                    continue
                # (a) a direct function-taking call
                for kind, arg in fn_taker_args(n, imports):
                    add_roots(kind, self.resolve_callable(arg, mod, owner))
                # (b) a wrapper call site
                for fi in self.resolve_call(n, mod, owner):
                    for kind, positions in self.wrapper_positions.get(
                            id(fi.node), {}).items():
                        for idx in positions:
                            if idx < len(n.args):
                                add_roots(kind, self.resolve_callable(
                                    unwrap_partial(n.args[idx]), mod, owner))
                # (c) a plain call edge
                if owner is not None:
                    tgts = self.resolve_call(n, mod, owner)
                    if tgts:
                        self.edges.setdefault(id(owner.node), set()).update(
                            id(t.node) for t in tgts)

        for fi in self.functions.values():
            if fi.module is mod:
                handle_body(fi, fi.node)
        handle_body(None, mod.tree)       # module-level calls

    def _bfs(self) -> None:
        for kind in KINDS:
            frontier = list(self.roots[kind])
            reached = set(frontier)
            while frontier:
                cur = frontier.pop()
                for nxt in self.edges.get(cur, ()):
                    if nxt not in reached:
                        reached.add(nxt)
                        frontier.append(nxt)
            self.reached[kind] = reached

    def _nested_defs(self, fi: FuncInfo) -> Dict[str, FuncInfo]:
        cached = self._nested_cache.get(id(fi.node))
        if cached is None:
            cached = {
                n.name: self.functions[id(n)]
                for n in self.walk(fi.node)
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
            self._nested_cache[id(fi.node)] = cached
        return cached

    def _bound_names(self, fi: FuncInfo) -> Set[str]:
        """Names bound inside ``fi`` by parameters or plain statements
        (assignments, for/with/except targets): NOT nested defs."""
        cached = self._bound_cache.get(id(fi.node))
        if cached is not None:
            return cached
        node = fi.node
        a = node.args
        names: Set[str] = set(fi.params)
        names.update(p.arg for p in a.kwonlyargs)
        if a.vararg:
            names.add(a.vararg.arg)
        if a.kwarg:
            names.add(a.kwarg.arg)
        names |= _stmt_bound_names(node)
        self._bound_cache[id(fi.node)] = names
        return names

    def _module_assigned(self, mod: Module) -> Set[str]:
        cached = self._bound_cache.get(id(mod.tree))
        if cached is not None:
            return cached
        names = _stmt_bound_names(mod.tree)
        self._bound_cache[id(mod.tree)] = names
        return names

    # ------------------------------------------------------------- queries
    def walk(self, node: ast.AST) -> List[ast.AST]:
        """``shallow_walk(node)``, computed once per node: the rules walk
        each function many times."""
        out = self._walk_cache.get(id(node))
        if out is None:
            out = self._walk_cache[id(node)] = list(shallow_walk(node))
        return out

    def is_captured(self, fi: FuncInfo) -> bool:
        return id(fi.node) in self.reached[CAPTURED]

    def is_recomputed(self, fi: FuncInfo) -> bool:
        return id(fi.node) in self.reached[RECOMPUTED]

    def scope_kinds(self, fi: FuncInfo) -> List[str]:
        """The kinds of scope ``fi`` runs in ([] for plain eager code)."""
        return [k for k in KINDS if id(fi.node) in self.reached[k]]

    def module_functions(self, mod: Module) -> List[FuncInfo]:
        return [fi for fi in self.functions.values() if fi.module is mod]


# attribute names resolved only against self/cls or module aliases, never
# through the global by-name fallback (dict/list/set protocol)
_CONTAINER_PROTOCOL = {
    "get", "items", "keys", "values", "pop", "popitem", "setdefault",
    "update", "append", "extend", "insert", "remove", "add", "discard",
    "clear", "copy", "index", "count", "sort", "reverse", "join",
    "move_to_end",
}


def _stmt_bound_names(node: ast.AST) -> Set[str]:
    names: Set[str] = set()

    def targets(t: ast.expr) -> Iterator[str]:
        for e in ast.walk(t):
            if isinstance(e, ast.Name) and isinstance(e.ctx, ast.Store):
                yield e.id

    for n in shallow_walk(node):
        if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            for t in (n.targets if isinstance(n, ast.Assign)
                      else [n.target]):
                names.update(targets(t))
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            names.update(targets(n.target))
        elif isinstance(n, ast.comprehension):
            names.update(targets(n.target))
        elif isinstance(n, ast.withitem) and n.optional_vars is not None:
            names.update(targets(n.optional_vars))
        elif isinstance(n, ast.ExceptHandler) and n.name:
            names.add(n.name)
        elif isinstance(n, ast.NamedExpr):
            names.update(targets(n.target))
    return names


def _binding_values(body: List[ast.AST], name: str) -> List[ast.expr]:
    """The expressions ``name = ...`` (or ``a, name = x, y``, or ``name
    += ...``) assigns to ``name`` among a function's nodes ``body``."""
    out: List[ast.expr] = []
    for n in body:
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    out.append(n.value)
                elif isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                        n.value, (ast.Tuple, ast.List)) \
                        and len(t.elts) == len(n.value.elts):
                    out.extend(v for e, v in zip(t.elts, n.value.elts)
                               if isinstance(e, ast.Name) and e.id == name)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)) and \
                isinstance(n.target, ast.Name) and n.target.id == name \
                and n.value is not None:
            out.append(n.value)
    return out


def _is_self_item(target: ast.expr, attr: str) -> bool:
    """Whether an assignment target is ``self.<attr>[...]``."""
    return (isinstance(target, ast.Subscript)
            and isinstance(target.value, ast.Attribute)
            and target.value.attr == attr
            and isinstance(target.value.value, ast.Name)
            and target.value.value.id == "self")


def _target_position(target: ast.expr, name: str) -> Optional[int]:
    """-1 when a loop target is ``name`` itself, k when it is a flat tuple
    with ``name`` at index k, else None."""
    if isinstance(target, ast.Name):
        return -1 if target.id == name else None
    if isinstance(target, (ast.Tuple, ast.List)):
        for k, e in enumerate(target.elts):
            if isinstance(e, ast.Name) and e.id == name:
                return k
    return None


def _iter_elements(body: List[ast.AST], it: ast.expr,
                   seen: frozenset = frozenset()) -> List[ast.expr]:
    """The element expressions a loop over ``it`` may yield, where ``it``
    is a literal list/tuple, a comprehension, a concatenation of those, or
    a local name bound to them."""
    if isinstance(it, (ast.List, ast.Tuple)):
        return list(it.elts)
    if isinstance(it, (ast.ListComp, ast.GeneratorExp)):
        return [it.elt]
    if isinstance(it, ast.BinOp) and isinstance(it.op, ast.Add):
        return (_iter_elements(body, it.left, seen)
                + _iter_elements(body, it.right, seen))
    if isinstance(it, ast.Name) and it.id not in seen:
        return [e for v in _binding_values(body, it.id)
                for e in _iter_elements(body, v, seen | {it.id})]
    return []


def _enclosing_class(fi: Optional[FuncInfo]) -> Optional[str]:
    while fi is not None:
        if fi.class_name:
            return fi.class_name
        fi = fi.parent
    return None

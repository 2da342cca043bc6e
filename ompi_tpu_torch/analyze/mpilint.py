"""mpilint — the project-native static analyzer, rooted at
``ompi_tpu_torch/`` (the port of ``ompi_tpu/analyze/mpilint.py``).

Pure stdlib ``ast``: one parse of every file under the scanned root,
one shared index, six project-specific rules. Each rule exists because
the reference shipped (and fixed) the bug class it catches; the
reference's rule catalog with worked examples is docs/ANALYSIS.md.

Rules (names are the baseline/suppression namespace):

- ``mca_var``   — MCA-var discipline: every ``var_get``/``var_set``
  name literal must resolve to exactly one ``var_register`` site
  (typos, undocumented vars); dynamic (f-string) names are flagged —
  spell registered names out (the bare ``mpi_base_ft_inject_`` prefix
  bug class); conflicting duplicate registrations are flagged. The
  registration index doubles as the generator of the port's MCA-var
  index, ``analyze/MCAVARS.md``.
- ``pvar``      — pvar discipline: every ``pvar_read``/``pvar_write``
  literal must match a ``pvar_register``/``pvar_register_dict`` site
  (exact name, f-string pattern, or dict prefix), and a
  check-and-register (``pvar_register`` conditional on a membership
  test) must sit under a lock — the SPC-install race class.
- ``closure``   — completion-closure rule: a class with a
  request-completion path (``_deliver``/``_fail``) that consumes a
  stored callable attribute (``*_fn``/``*_cb``/``*_callback``) must
  clear it (``self.x = None``) in EVERY completion method — the
  ``RankRequest._cancel_fn`` reference-cycle class.
- ``lock_blocking`` — no blocking call (``time.sleep``, socket
  recv/send/accept/connect, ``subprocess``, thread ``join``) lexically
  inside a ``with <lock>:`` block on the pml/btl/progress hot paths.
- ``span_balance`` — every ``trace.begin(...)`` token bound to a local
  must be consumed by a ``trace.end(tok)`` inside a ``finally`` of the
  same function (all exits), and a begin whose token is discarded is
  an unclosable span.

Baseline (``analyze/baseline.json``): keys are line-number-free
(``rule:relpath:detail``) so they survive unrelated edits; every entry
carries a one-line ``why``. Stale entries (suppressing nothing) are
reported and fail the strict tier-1 run.
"""
from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# hot paths for the lock_blocking rule (relative, '/'-separated)
HOT_PREFIXES = ("pml/", "btl/", "runtime/progress")

_BLOCKING_SOCKET_METHODS = {"sendall", "recv", "recv_into", "recvfrom",
                            "accept", "connect", "makefile",
                            "getaddrinfo", "create_connection"}
_CALLABLE_ATTR_RE = re.compile(r"^_\w*(?:_fn|_cb|_callback)$|^_fn$|^_cb$")
_VAR_NAME_RE = re.compile(r"^[a-z][a-z0-9]*_[a-z0-9_]+$")


@dataclass
class Finding:
    rule: str
    path: str            # relative to the scanned root
    line: int
    message: str
    key: str             # stable (line-free) baseline key

    def to_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "key": self.key}


@dataclass
class _Module:
    rel: str             # '/'-separated relative path
    path: str
    tree: ast.AST
    parents: Dict[ast.AST, ast.AST] = field(default_factory=dict)

    def ancestors(self, node: ast.AST) -> Iterable[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            yield cur
            cur = self.parents.get(cur)


# --------------------------------------------------------------------------
# small AST helpers
# --------------------------------------------------------------------------
def _call_name(call: ast.Call) -> Optional[str]:
    f = call.func
    if isinstance(f, ast.Name):
        return f.id
    if isinstance(f, ast.Attribute):
        return f.attr
    return None


def _receiver_names(call: ast.Call) -> List[str]:
    """Dotted receiver chain of a call, outermost first (``a.b.c()`` ->
    ``["a", "b"]``); empty for bare-name calls."""
    out: List[str] = []
    f = call.func
    while isinstance(f, ast.Attribute):
        f = f.value
        if isinstance(f, ast.Attribute):
            out.append(f.attr)
        elif isinstance(f, ast.Name):
            out.append(f.id)
    return out


def _str_const(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _fstring_pattern(node: ast.JoinedStr) -> Tuple[str, str]:
    """(literal_prefix, regex) for an f-string name."""
    prefix_parts: List[str] = []
    rx_parts: List[str] = []
    literal_so_far = True
    for part in node.values:
        s = _str_const(part)
        if s is not None:
            rx_parts.append(re.escape(s))
            if literal_so_far:
                prefix_parts.append(s)
        else:
            literal_so_far = False
            rx_parts.append(r"[A-Za-z0-9_]+")
    return "".join(prefix_parts), "^" + "".join(rx_parts) + "$"


def _mentions_lock(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and "lock" in sub.id.lower():
            return True
        if isinstance(sub, ast.Attribute) and "lock" in sub.attr.lower():
            return True
    return False


def _enclosing_function(mod: _Module, node: ast.AST) -> Optional[ast.AST]:
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _qualname(mod: _Module, node: ast.AST) -> str:
    parts: List[str] = []
    for anc in mod.ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef,
                            ast.ClassDef)):
            parts.append(anc.name)
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        parts.insert(0, node.name)
    return ".".join(reversed(parts)) or "<module>"


# --------------------------------------------------------------------------
# scanning
# --------------------------------------------------------------------------
def _scan(root: str) -> List[_Module]:
    mods: List[_Module] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames
                             if d not in ("__pycache__", ".git"))
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root).replace(os.sep, "/")
            try:
                with open(path, encoding="utf-8") as f:
                    tree = ast.parse(f.read(), path)
            except (OSError, SyntaxError) as e:
                raise RuntimeError(f"mpilint: cannot parse {rel}: {e}")
            mod = _Module(rel, path, tree)
            for parent in ast.walk(tree):
                for child in ast.iter_child_nodes(parent):
                    mod.parents[child] = parent
            mods.append(mod)
    return mods


# --------------------------------------------------------------------------
# rule: mca_var
# --------------------------------------------------------------------------
_VAR_READ_FUNCS = ("var_get", "var_set", "var_source", "var_overridden")


def collect_var_registry(mods: List[_Module]) -> Dict[str, List[Dict]]:
    """full var name -> registration sites (the MCAVARS.md source)."""
    regs: Dict[str, List[Dict]] = {}
    for mod in mods:
        if mod.rel.startswith("mca/"):
            continue                     # the var-store plumbing itself
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and _call_name(node) == "var_register"):
                continue
            parts = [_str_const(a) for a in node.args[:3]]
            if len(parts) < 3 or any(p is None for p in parts):
                continue                 # dynamic: rule_mca_var flags it
            full = "_".join(p for p in parts if p)
            kw = {k.arg: k.value for k in node.keywords if k.arg}
            site = {"path": mod.rel, "line": node.lineno,
                    "vtype": _str_const(kw.get("vtype")) or "str",
                    "default": (ast.unparse(kw["default"])
                                if "default" in kw else "None"),
                    "help": _str_const(kw.get("help")) or ""}
            regs.setdefault(full, []).append(site)
    return regs


def rule_mca_var(mods: List[_Module], ctx: Dict[str, Any]) -> List[Finding]:
    """MCA-var discipline: literal names resolve to exactly one
    registration; dynamic names and conflicting duplicates are flagged."""
    regs = ctx["var_registry"]
    out: List[Finding] = []
    # conflicting duplicate registrations (same-file re-register of the
    # idempotent `_register_vars()` idiom is one site; a second file
    # re-registering with a different default/type is a conflict)
    for full, sites in sorted(regs.items()):
        by_file: Dict[str, Dict] = {}
        for s in sites:
            by_file.setdefault(s["path"], s)
        if len(by_file) > 1:
            shapes = {(s["vtype"], s["default"]) for s in by_file.values()}
            if len(shapes) > 1:
                where = ", ".join(f"{s['path']}:{s['line']}"
                                  for s in by_file.values())
                out.append(Finding(
                    "mca_var", sites[0]["path"], sites[0]["line"],
                    f"MCA var '{full}' registered with conflicting "
                    f"default/type at {where}",
                    f"mca_var:{full}:conflict"))
    for mod in mods:
        if mod.rel.startswith("mca/"):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            name = _call_name(node)
            if name == "var_register":
                parts = [_str_const(a) for a in node.args[:3]]
                if len(parts) == 3 and any(p is None for p in parts):
                    fn = _enclosing_function(mod, node)
                    qn = fn.name if fn is not None else "<module>"
                    out.append(Finding(
                        "mca_var", mod.rel, node.lineno,
                        "dynamic var_register name (non-literal "
                        "framework/component/name) — the registry "
                        "cannot index it",
                        f"mca_var:{mod.rel}:dynamic-register@{qn}"))
                continue
            if name not in _VAR_READ_FUNCS or not node.args:
                continue
            # skip the var-store's own API plumbing (cvar_read etc.
            # pass the caller's name through a variable — unlintable)
            arg = node.args[0]
            lit = _str_const(arg)
            if lit is not None:
                if not _VAR_NAME_RE.match(lit):
                    continue             # not an MCA name shape
                sites = regs.get(lit)
                if not sites:
                    out.append(Finding(
                        "mca_var", mod.rel, node.lineno,
                        f"{name}('{lit}') does not resolve to any "
                        "var_register site (typo or undocumented var)",
                        f"mca_var:{mod.rel}:{lit}"))
            elif isinstance(arg, ast.JoinedStr):
                prefix, rx = _fstring_pattern(arg)
                if not prefix or "_" not in prefix:
                    continue             # no literal MCA-style prefix
                matches = sorted(n for n in regs if re.match(rx, n))
                detail = (f"matches {len(matches)} registered vars "
                          f"(e.g. {matches[0]})" if matches
                          else "matches NO registered var")
                out.append(Finding(
                    "mca_var", mod.rel, node.lineno,
                    f"dynamic (f-string) var name '{prefix}…' passed "
                    f"to {name} — {detail}; spell registered names as "
                    "literals so the registry can check them",
                    f"mca_var:{mod.rel}:dynamic:{prefix}"))
    return out


# --------------------------------------------------------------------------
# rule: pvar
# --------------------------------------------------------------------------
def _collect_pvar_registry(mods: List[_Module]) -> Dict[str, Any]:
    names: Dict[str, List[str]] = {}
    patterns: List[Tuple[str, str]] = []   # (regex, where)
    prefixes: List[str] = []
    for mod in mods:
        if mod.rel.startswith("mca/"):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            cname = _call_name(node)
            if cname == "pvar_register":
                lit = _str_const(node.args[0])
                if lit is not None:
                    names.setdefault(lit, []).append(
                        f"{mod.rel}:{node.lineno}")
                elif isinstance(node.args[0], ast.JoinedStr):
                    _, rx = _fstring_pattern(node.args[0])
                    patterns.append((rx, f"{mod.rel}:{node.lineno}"))
            elif cname == "pvar_register_dict":
                lit = _str_const(node.args[0])
                if lit is not None:
                    prefixes.append(lit)
                elif isinstance(node.args[0], ast.JoinedStr):
                    pfx, _ = _fstring_pattern(node.args[0])
                    if pfx:
                        prefixes.append(pfx)
    return {"names": names, "patterns": patterns, "prefixes": prefixes}


def rule_pvar(mods: List[_Module], ctx: Dict[str, Any]) -> List[Finding]:
    """pvar discipline: reads/writes resolve to a registration; a
    check-and-register must hold a lock across check AND register."""
    reg = ctx["pvar_registry"]
    out: List[Finding] = []

    def resolves(name: str) -> bool:
        if name in reg["names"] or name.startswith("spc_"):
            return True                  # spc_* auto-installed (pvar.py)
        if any(name.startswith(p if p.endswith("_") else p + "_")
               for p in reg["prefixes"]):
            return True
        return any(re.match(rx, name) for rx, _ in reg["patterns"])

    for mod in mods:
        if mod.rel.startswith("mca/"):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            cname = _call_name(node)
            if cname in ("pvar_read", "pvar_write") and node.args:
                lit = _str_const(node.args[0])
                if lit is not None and not resolves(lit):
                    out.append(Finding(
                        "pvar", mod.rel, node.lineno,
                        f"{cname}('{lit}') has no matching "
                        "pvar_register/pvar_register_dict site",
                        f"pvar:{mod.rel}:{lit}"))
            elif cname in ("pvar_register", "pvar_register_dict"):
                # check-and-register: registration conditional on a
                # membership test must be lock-guarded (the
                # _install_spc_pvars race: unlocked `in` check vs
                # concurrent writers)
                cond = None
                locked = False
                for anc in mod.ancestors(node):
                    if isinstance(anc, ast.If) and cond is None and any(
                            isinstance(c, ast.Compare) and any(
                                isinstance(op, (ast.In, ast.NotIn))
                                for op in c.ops)
                            for c in ast.walk(anc.test)):
                        cond = anc
                    if isinstance(anc, ast.With) and any(
                            _mentions_lock(item.context_expr)
                            for item in anc.items):
                        locked = True
                    if isinstance(anc, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                        break
                if cond is not None and not locked:
                    fn = _enclosing_function(mod, node)
                    qn = fn.name if fn is not None else "<module>"
                    out.append(Finding(
                        "pvar", mod.rel, node.lineno,
                        "check-and-register race: pvar registration "
                        "conditional on a membership test without a "
                        "lock held across check and register",
                        f"pvar:{mod.rel}:guard@{qn}"))
    return out


# --------------------------------------------------------------------------
# rule: closure
# --------------------------------------------------------------------------
_COMPLETION_METHODS = ("_deliver", "_fail")


def rule_closure(mods: List[_Module], ctx: Dict[str, Any]) -> List[Finding]:
    """Completion-closure rule (the ``_cancel_fn`` cycle): a
    deferred-callable attribute consumed by a class with completion
    methods must be cleared (``self.x = None``) in every one of them —
    a surviving closure captures the request and pins its payload
    until a gen-2 GC pass."""
    # pass 1: attribute names that anything in the tree arms with a
    # callable (obj._x_fn = lambda ... / a function reference)
    armed: set = set()
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            for tgt in node.targets:
                if isinstance(tgt, ast.Attribute) \
                        and _CALLABLE_ATTR_RE.match(tgt.attr) \
                        and not (isinstance(node.value, ast.Constant)
                                 and node.value.value is None):
                    armed.add(tgt.attr)
    out: List[Finding] = []
    for mod in mods:
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = {n.name: n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))}
            completion = [m for m in _COMPLETION_METHODS if m in methods]
            if not completion:
                continue
            # attrs this class consumes: self.x / getattr(self, 'x')
            used: set = set()
            for sub in ast.walk(cls):
                if isinstance(sub, ast.Attribute) \
                        and isinstance(sub.value, ast.Name) \
                        and sub.value.id == "self" \
                        and sub.attr in armed:
                    used.add(sub.attr)
                if isinstance(sub, ast.Call) \
                        and _call_name(sub) == "getattr" \
                        and len(sub.args) >= 2 \
                        and isinstance(sub.args[0], ast.Name) \
                        and sub.args[0].id == "self":
                    lit = _str_const(sub.args[1])
                    if lit in armed:
                        used.add(lit)
            for attr in sorted(used):
                for mname in completion:
                    clears = any(
                        isinstance(s, ast.Assign)
                        and any(isinstance(t, ast.Attribute)
                                and t.attr == attr
                                and isinstance(t.value, ast.Name)
                                and t.value.id == "self"
                                for t in s.targets)
                        and isinstance(s.value, ast.Constant)
                        and s.value.value is None
                        for s in ast.walk(methods[mname]))
                    if not clears:
                        out.append(Finding(
                            "closure", mod.rel, methods[mname].lineno,
                            f"{cls.name}.{mname} does not clear "
                            f"self.{attr} — the completion closure "
                            "keeps the request (and its payload) "
                            "alive in a reference cycle",
                            f"closure:{mod.rel}:{cls.name}."
                            f"{mname}:{attr}"))
    return out


# --------------------------------------------------------------------------
# rule: lock_blocking
# --------------------------------------------------------------------------
def _is_blocking_call(node: ast.Call) -> Optional[str]:
    name = _call_name(node)
    recv = _receiver_names(node)
    if name == "sleep" and (not recv or recv[0] == "time"):
        return "time.sleep"
    if "subprocess" in recv or name in ("Popen", "check_call",
                                        "check_output"):
        return f"subprocess.{name}"
    if name in _BLOCKING_SOCKET_METHODS:
        # str.join-style false positives are impossible here; recv()
        # etc. on ANY receiver inside a lock is the hazard
        return f".{name}"
    if name == "join" and recv and any("thread" in r.lower()
                                       for r in recv):
        return ".join (thread)"
    return None


def rule_lock_blocking(mods: List[_Module],
                       ctx: Dict[str, Any]) -> List[Finding]:
    """No blocking call lexically inside a ``with <lock>:`` block on
    the pml/btl/progress hot paths (a blocked holder stalls every
    reader/sender thread contending the lock)."""
    all_hot = bool(ctx.get("all_hot"))
    out: List[Finding] = []
    for mod in mods:
        if not all_hot and not mod.rel.startswith(HOT_PREFIXES):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.With):
                continue
            if not any(_mentions_lock(item.context_expr)
                       for item in node.items):
                continue
            # walk the body but not nested function/lambda bodies —
            # a closure defined under the lock runs later, outside it
            stack: List[ast.AST] = list(node.body)
            while stack:
                sub = stack.pop()
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(sub, ast.Call):
                    what = _is_blocking_call(sub)
                    if what is not None:
                        fn = _enclosing_function(mod, node)
                        qn = fn.name if fn is not None else "<module>"
                        out.append(Finding(
                            "lock_blocking", mod.rel, sub.lineno,
                            f"blocking call {what} inside a "
                            "with-<lock> block on a hot path",
                            f"lock_blocking:{mod.rel}:{qn}:{what}"))
                stack.extend(ast.iter_child_nodes(sub))
    return out


# --------------------------------------------------------------------------
# rule: span_balance
# --------------------------------------------------------------------------
def _is_trace_call(node: ast.Call, method: str) -> bool:
    f = node.func
    if isinstance(f, ast.Name):
        return f.id == method
    if isinstance(f, ast.Attribute) and f.attr == method:
        recv = _receiver_names(node)
        return bool(recv) and any("trace" in r or r == "core"
                                  for r in recv)
    return False


def rule_span_balance(mods: List[_Module],
                      ctx: Dict[str, Any]) -> List[Finding]:
    """Every ``begin`` token bound to a local must reach ``end(tok)``
    inside a ``finally`` of the same function — otherwise an exception
    between begin and end leaks the span on that exit path. Tokens
    stored on ``self`` (cross-scope spans like the detector's
    suspect/clear pair) are outside static reach and are skipped."""
    out: List[Finding] = []
    for mod in mods:
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            # names bound from a begin() call directly in THIS function
            # (not in nested defs — they have their own entry)
            begins: Dict[str, int] = {}
            discarded: List[int] = []
            ends_in_finally: set = set()
            nested = {sub for child in ast.walk(fn)
                      if isinstance(child, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                      and child is not fn
                      for sub in ast.walk(child)}
            for node in ast.walk(fn):
                if node in nested:
                    continue
                if isinstance(node, ast.Assign):
                    has_begin = any(
                        isinstance(c, ast.Call)
                        and _is_trace_call(c, "begin")
                        for c in ast.walk(node.value))
                    if has_begin:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                begins.setdefault(t.id, node.lineno)
                elif isinstance(node, ast.Expr) \
                        and isinstance(node.value, ast.Call) \
                        and _is_trace_call(node.value, "begin"):
                    discarded.append(node.lineno)
                elif isinstance(node, ast.Try):
                    for fin in node.finalbody:
                        for c in ast.walk(fin):
                            if isinstance(c, ast.Call) \
                                    and _is_trace_call(c, "end") \
                                    and c.args \
                                    and isinstance(c.args[0], ast.Name):
                                ends_in_finally.add(c.args[0].id)
            for name, line in sorted(begins.items()):
                if name not in ends_in_finally:
                    out.append(Finding(
                        "span_balance", mod.rel, line,
                        f"span token '{name}' from trace.begin() is "
                        "not ended in a finally — an exception exit "
                        "leaks the span",
                        f"span_balance:{mod.rel}:{fn.name}:{name}"))
            for line in discarded:
                out.append(Finding(
                    "span_balance", mod.rel, line,
                    "trace.begin() token discarded — the span can "
                    "never be ended",
                    f"span_balance:{mod.rel}:{fn.name}:<discarded>"))
    return out


# --------------------------------------------------------------------------
# rule: histogram_balance
# --------------------------------------------------------------------------
def _is_hist_call(node: ast.Call, method: str) -> bool:
    """``<hist-ish>.start()`` / ``<hist-ish>.observe(...)`` — receiver
    chain must contain a name mentioning "hist" so ``thread.start()``
    and friends never match."""
    f = node.func
    if isinstance(f, ast.Attribute) and f.attr == method:
        recv = _receiver_names(node)
        return any("hist" in r.lower() for r in recv)
    return False


def rule_histogram_balance(mods: List[_Module],
                           ctx: Dict[str, Any]) -> List[Finding]:
    """Every histogram timing token from ``hist.start()`` bound to a
    local must reach ``observe(tok)`` inside a ``finally`` of the same
    function — otherwise an exception between start and observe loses
    the sample on exactly the exits (errors, timeouts) the latency
    histogram most needs to count. The span_balance contract, applied
    to the telemetry plane's timer API; the gated idiom
    ``tok = hist.start() if active else None`` satisfies it because
    ``observe(None)`` is a no-op."""
    out: List[Finding] = []
    for mod in mods:
        funcs = [n for n in ast.walk(mod.tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            starts: Dict[str, int] = {}
            discarded: List[int] = []
            observed_in_finally: set = set()
            nested = {sub for child in ast.walk(fn)
                      if isinstance(child, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                      and child is not fn
                      for sub in ast.walk(child)}
            for node in ast.walk(fn):
                if node in nested:
                    continue
                if isinstance(node, ast.Assign):
                    has_start = any(
                        isinstance(c, ast.Call)
                        and _is_hist_call(c, "start")
                        for c in ast.walk(node.value))
                    if has_start:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                starts.setdefault(t.id, node.lineno)
                elif isinstance(node, ast.Expr) \
                        and isinstance(node.value, ast.Call) \
                        and _is_hist_call(node.value, "start"):
                    discarded.append(node.lineno)
                elif isinstance(node, ast.Try):
                    for fin in node.finalbody:
                        for c in ast.walk(fin):
                            if isinstance(c, ast.Call) \
                                    and isinstance(c.func, ast.Attribute) \
                                    and c.func.attr == "observe" \
                                    and c.args \
                                    and isinstance(c.args[0], ast.Name):
                                observed_in_finally.add(c.args[0].id)
            for name, line in sorted(starts.items()):
                if name not in observed_in_finally:
                    out.append(Finding(
                        "histogram_balance", mod.rel, line,
                        f"histogram token '{name}' from hist.start() "
                        "is not observed in a finally — an exception "
                        "exit drops the sample the latency histogram "
                        "most needs",
                        f"histogram_balance:{mod.rel}:{fn.name}:"
                        f"{name}"))
            for line in discarded:
                out.append(Finding(
                    "histogram_balance", mod.rel, line,
                    "hist.start() token discarded — the sample can "
                    "never be observed",
                    f"histogram_balance:{mod.rel}:{fn.name}:"
                    "<discarded>"))
    return out


# --------------------------------------------------------------------------
# registry / driver
# --------------------------------------------------------------------------
RULES: Dict[str, Callable[[List[_Module], Dict[str, Any]], List[Finding]]] \
    = {
        "mca_var": rule_mca_var,
        "pvar": rule_pvar,
        "closure": rule_closure,
        "lock_blocking": rule_lock_blocking,
        "span_balance": rule_span_balance,
        "histogram_balance": rule_histogram_balance,
    }


def default_baseline_path() -> str:
    return os.path.join(_PKG_ROOT, "analyze", "baseline.json")


def load_baseline(path: Optional[str]) -> Dict[str, str]:
    """key -> why. Missing file = empty baseline."""
    if not path:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            data = json.load(f)
    except OSError:
        return {}
    out: Dict[str, str] = {}
    for ent in data.get("suppressions", []):
        out[ent["key"]] = ent.get("why", "")
    return out


def run_lint(root: Optional[str] = None,
             baseline: Optional[str] = "default",
             rules: Optional[List[str]] = None,
             all_hot: bool = False) -> Dict[str, Any]:
    """Run the rule set over ``root`` (default: the installed
    ``ompi_tpu_torch`` package). Returns the full report; ``ok`` is True
    when no non-baselined finding AND no stale baseline entry."""
    root = root or _PKG_ROOT
    if baseline == "default":
        baseline = (default_baseline_path()
                    if os.path.abspath(root) == _PKG_ROOT else None)
    base = load_baseline(baseline)
    mods = _scan(root)
    ctx: Dict[str, Any] = {
        "all_hot": all_hot,
        "var_registry": collect_var_registry(mods),
        "pvar_registry": _collect_pvar_registry(mods),
    }
    selected = rules or list(RULES)
    findings: List[Finding] = []
    for name in selected:
        findings.extend(RULES[name](mods, ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    hit: set = set()
    open_f: List[Finding] = []
    suppressed: List[Dict[str, Any]] = []
    for f in findings:
        if f.key in base:
            hit.add(f.key)
            suppressed.append({**f.to_dict(), "why": base[f.key]})
        else:
            open_f.append(f)
    stale = sorted(set(base) - hit) if rules is None else []
    return {"ok": not open_f and not stale,
            "root": os.path.abspath(root),
            "files": len(mods),
            "rules": sorted(selected),
            "findings": [f.to_dict() for f in open_f],
            "suppressed": suppressed,
            "stale_baseline": stale,
            "var_registry": ctx["var_registry"]}


# --------------------------------------------------------------------------
# analyze/MCAVARS.md generation
# --------------------------------------------------------------------------
def default_mcavars_path() -> str:
    return os.path.join(_PKG_ROOT, "analyze", "MCAVARS.md")


def render_mcavars(registry: Optional[Dict[str, List[Dict]]] = None) -> str:
    """The generated MCA-var reference table (analyze/MCAVARS.md) —
    line-number-free so the committed file only changes when a var
    actually changes; tests/test_torch_lint_clean.py freshness-checks
    it."""
    if registry is None:
        registry = collect_var_registry(_scan(_PKG_ROOT))
    lines = [
        "# MCA variables (generated — do not edit)",
        "",
        "Generated by `python -m ompi_tpu_torch.tools.mpilint --emit-mcavars`"
        " from the",
        "static `var_register` sites mpilint indexes; the tier-1 test",
        "`tests/test_torch_lint_clean.py` fails when this file is stale.",
        "Set any var via `OMPI_TPU_TORCH_MCA_<name>` in the environment,",
        "or `mca.var.var_set`.",
        "",
        "| Variable | Type | Default | Registered in | Help |",
        "|---|---|---|---|---|",
    ]
    for full in sorted(registry):
        sites = registry[full]
        files = sorted({s["path"] for s in sites})
        s0 = sites[0]
        help_txt = " ".join(s0["help"].split())
        if len(help_txt) > 160:
            help_txt = help_txt[:157] + "..."
        default = s0["default"].replace("|", "\\|")
        lines.append(f"| `{full}` | {s0['vtype']} | `{default}` | "
                     f"{', '.join(files)} | {help_txt} |")
    lines.append("")
    return "\n".join(lines)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    import sys
    ap = argparse.ArgumentParser(
        prog="python -m ompi_tpu_torch.tools.mpilint",
        description="Project-native static analyzer: MCA-var/pvar "
                    "discipline, completion-closure, blocking-under-"
                    "lock, span balance.")
    ap.add_argument("--root", default=None,
                    help="tree to scan (default: the ompi_tpu_torch "
                         "package)")
    ap.add_argument("--baseline", default="default",
                    help="baseline JSON ('none' disables; default: "
                         "analyze/baseline.json when scanning the "
                         "package)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule subset (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--emit-mcavars", metavar="PATH", default=None,
                    help="write the generated MCA-var table and exit")
    ap.add_argument("--format", choices=("json", "text"), default="text")
    args = ap.parse_args(argv)

    if args.list_rules:
        for name, fn in RULES.items():
            doc = (fn.__doc__ or "").strip().split("\n")[0]
            print(f"{name}: {doc}")
        return 0
    if args.emit_mcavars:
        text = render_mcavars()
        if args.emit_mcavars == "-":
            sys.stdout.write(text)
        else:
            with open(args.emit_mcavars, "w", encoding="utf-8") as f:
                f.write(text)
        return 0

    rules = args.rules.split(",") if args.rules else None
    baseline = None if args.baseline == "none" else args.baseline
    report = run_lint(args.root, baseline, rules)
    if args.format == "json":
        slim = {k: v for k, v in report.items() if k != "var_registry"}
        print(json.dumps(slim, indent=1))
    else:
        for f in report["findings"]:
            print(f"{f['path']}:{f['line']}: [{f['rule']}] "
                  f"{f['message']}  (key: {f['key']})")
        for k in report["stale_baseline"]:
            print(f"stale baseline entry (suppresses nothing): {k}")
        n = len(report["findings"])
        print(f"mpilint: {report['files']} files, "
              f"{len(report['rules'])} rules, {n} finding(s), "
              f"{len(report['suppressed'])} baselined, "
              f"{len(report['stale_baseline'])} stale")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

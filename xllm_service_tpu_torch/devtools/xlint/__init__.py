"""xlint — project-specific concurrency-invariant static analysis.

An AST pass over the whole tree enforcing the invariants the orchestration
plane otherwise maintains only by convention:

=========================  ==================================================
rule id                    invariant
=========================  ==================================================
``no-blocking-under-lock`` no ``time.sleep``, RPC/channel calls, ``requests``
                           / socket I/O, or coordination-client calls
                           lexically inside a ``with <lock>`` block
``lock-discipline``        locks acquired only via ``with`` (no bare
                           ``.acquire()``); every lock attribute declared at
                           ``__init__`` (or class/module scope) with a
                           ``# lock-order: N`` annotation
``lock-order``             the static lock-acquisition graph (nested ``with``
                           blocks + one level of project-resolvable calls)
                           respects the declared order and is acyclic
``fault-point``            every ``FAULTS.check("p")``/``FAULTS.fire("p")``
                           names a point registered in ``common/faults.py``'s
                           ``FAULT_POINTS``, and no registered point is dead
``span-point``             every ``TRACER.span("p")``/``TRACER.start_span``
                           names a point registered in ``common/tracing.py``'s
                           ``SPAN_POINTS``, and no registered point is dead
``metrics-registry``       metric instruments are created only in
                           ``common/metrics.py`` and none is dead; labeled
                           instruments are written only via ``.labels(...)``
                           with exactly the declared labelnames
``hot-json``               functions registered in ``rpc/wire.py``'s
                           ``HOT_PATH_FUNCTIONS`` contain no hand-rolled
                           ``json.dumps``/``json=`` encoding — dispatch
                           bytes come from ``rpc.wire``; stale registry
                           entries are violations too
``broad-except``           no bare ``except:`` anywhere; in scheduler/rpc/
                           coordination/engine paths every ``except
                           Exception`` handler logs or re-raises
``rcu-frozen``             types registered in ``devtools/rcu.py``'s
                           ``RCU_FROZEN_TYPES`` are never mutated after
                           construction — not in their own methods, not
                           through a local holding a published value
                           (``rcu.thaw(x, reason)`` is the declared-writer
                           hatch)
``rcu-publish``            writes to attributes registered in
                           ``RCU_PUBLICATIONS`` are a
                           single reference swap of a freshly built object
                           under the declared writer lock (one level of
                           call-site summaries, like the lock-order graph)
                           — never a field-by-field update
``rcu-read``               functions registered in ``HOT_PATH_FUNCTIONS``
                           load each publication attribute at most once
                           (a double load is a torn read: the two loads
                           may observe different snapshots)
``async-blocking``         no blocking primitives (``time.sleep``,
                           ``requests.*``/session HTTP, socket I/O,
                           coordination calls, channel RPC / ``_get`` /
                           ``_post``) lexically inside ``async def`` —
                           they stall the whole event loop
``state-decl``             every attribute assigned outside ``__init__`` in
                           a class registered in ``devtools/ownership.py``'s
                           ``STATE_CLASSES`` carries a declared discipline in
                           ``STATE_DISCIPLINES``; stale registry entries
                           (missing class / never-assigned attribute /
                           unknown lock / unknown or dead thread role /
                           ``rcu`` without an ``RCU_PUBLICATIONS`` entry)
                           are violations too
``state-write``            ``lock:<attr>``-disciplined attributes are
                           written only while the declared lock is held
                           (lexically, or via transitive ``*_locked``
                           call-site summaries); ``confined:<role>``
                           attributes rebound only from the role's entry
                           functions; ``init-only``/``immutable`` never
                           rebound after construction (``immutable`` never
                           mutated in place either)
``state-read``             functions registered in ``HOT_PATH_FUNCTIONS``
                           do not read lock-guarded mutable attributes
                           without the lock — go through an RCU snapshot
                           or take it
``pair-release``           every acquire site of a ``finally``-scope pair
                           registered in ``devtools/lifecycle.py``'s
                           ``EFFECT_PAIRS`` is discharged by a try/finally
                           that reaches the declared release (in the
                           acquiring function or every resolvable caller)
                           or by the declared ownership transfer; stale /
                           malformed / dead registry entries are
                           violations too
``pair-once``              no path releases a ``finally``-scope pair twice:
                           two unconditional releases in one function, or
                           an unconditional release lexically after the
                           declared ownership transfer, are flagged —
                           guard the release with the slot-ownership flag
``pair-evict``             labeled metric series are evicted only through
                           the blessed helper the ``evict``-scope pair
                           declares (no direct ``INSTRUMENT.remove(...)``
                           outside metrics.py), and no function writes to
                           an instrument after evicting its series (the
                           gauge-resurrection shape)
=========================  ==================================================

``async with`` acquisitions of declared asyncio locks participate in the
lock-discipline and lock-order rules exactly like threaded ``with``.

Escape hatches are inline comments with a mandatory reason::

    # xlint: allow-broad-except(error is surfaced as a client status)
    # xlint: allow-blocking-under-lock(single-writer frame serialization)
    # xlint: allow-lock-order(reason)
    # xlint: allow-bare-acquire(reason)
    # xlint: allow-lock-annotation(reason)
    # xlint: allow-span-point(reason)
    # xlint: allow-hot-json(reason)
    # xlint: allow-rcu-frozen(reason)
    # xlint: allow-rcu-publish(reason)
    # xlint: allow-rcu-read(reason)
    # xlint: allow-async-blocking(reason)
    # xlint: allow-state-decl(reason)
    # xlint: allow-state-write(reason)
    # xlint: allow-state-read(reason)
    # xlint: allow-pair-release(reason)
    # xlint: allow-pair-once(reason)
    # xlint: allow-pair-evict(reason)

The state rules also accept the runtime hatch — writes lexically inside
``with ownership.escape("reason"):`` are exempt (and an empty reason is
itself a violation, mirroring ``rcu.thaw`` and ``lifecycle.escape``).

Run: ``python -m xllm_service_tpu_torch.devtools.xlint xllm_service_tpu_torch``
(exit 0 = clean, 1 = violations, 2 = usage error). ``--format json``
emits one machine-readable object (``{"profile", "roots", "files",
"count", "violations": [{"rule", "path", "line", "message"}, ...],
"hatches": [{"path", "line", "kind", "reason"}, ...]}`` — the hatches
list surfaces every escape-hatch reason in the tree, comment hatches and
``ownership.escape``/``rcu.thaw``/``lifecycle.escape`` runtime hatches
alike, so readers can audit them) with the same exit codes —
tests consume it. The whole tree is parsed ONCE per run:
every rule shares the same per-file AST and cached node walks
(``SourceFile.walk`` / ``Project.fn_walk``).

``--changed <git-ref>`` lints the full tree but REPORTS only violations
in files changed vs the ref (``git diff --name-only <ref>``), plus any
violation in a registry file — full-tree semantics are preserved (the
registries are cross-checked against every call site, so killing the
last call site of a fault point from an unchanged registry still
reports), while the output stays scoped to your diff.

Support code (tests/, benchmarks/) is linted with the RELAXED profile —
``python -m xllm_service_tpu_torch.devtools.xlint --support tests benchmarks``
— which drops the declaration-discipline rule (support code does not
register locks/points) but keeps the behavioral rules: blocking under a
lock in a bench driver corrupts the measurement it wraps just as surely
as it stalls a scheduler. Files under a ``xlint_fixtures`` directory are
skipped unless they are the scan root (they are deliberate
anti-patterns).
"""

from __future__ import annotations

import ast
import re
import sys
from dataclasses import dataclass, field
from pathlib import Path

_SUPPRESS_RE = re.compile(r"#\s*xlint:\s*allow-([a-z-]+)\(([^)]*)\)")

#: Rule tokens accepted in suppression comments.
SUPPRESSIBLE = {
    "broad-except", "blocking-under-lock", "lock-order", "bare-acquire",
    "lock-annotation", "local-lock", "span-point", "hot-json",
    "rcu-frozen", "rcu-publish", "rcu-read", "async-blocking",
    "state-decl", "state-write", "state-read",
    "pair-release", "pair-once", "pair-evict",
}


@dataclass(frozen=True)
class Violation:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass
class SourceFile:
    path: Path
    rel: str                      # path relative to the scan root's parent
    tree: ast.Module
    lines: list[str]
    # line number -> set of rule tokens allowed on that line.
    suppressions: dict[int, set[str]] = field(default_factory=dict)
    # Registered comment hatches with their reasons, in line order:
    # (line, token, reason). The JSON output surfaces these (plus the
    # runtime escape/thaw hatches) so hatch reasons stay auditable.
    hatches: "list[tuple[int, str, str]]" = field(default_factory=list)
    # Cached flat node list: the tree is parsed once per run and every
    # rule shares the same walk instead of re-walking per rule (the
    # single-parse/single-walk contract the CLI advertises).
    _nodes: "list[ast.AST] | None" = field(default=None, repr=False)

    def walk(self) -> "list[ast.AST]":
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes

    def allowed(self, token: str, *linenos: int) -> bool:
        # A hatch comment may trail the offending line or sit on its own
        # line directly above it.
        return any(token in self.suppressions.get(ln, ())
                   or token in self.suppressions.get(ln - 1, ())
                   for ln in linenos)

    def line_comment_order(self, lineno: int) -> int | None:
        """Parse a trailing ``# lock-order: N`` annotation."""
        if 1 <= lineno <= len(self.lines):
            m = re.search(r"#\s*lock-order:\s*(-?\d+)", self.lines[lineno - 1])
            if m:
                return int(m.group(1))
        return None


def _parse_suppressions(lines: list[str]) -> tuple[
        dict[int, set[str]], "list[tuple[int, str, str]]"]:
    """Comment hatches → (line→tokens map, [(line, token, reason)]).
    The reason is mandatory: an empty one does not register the
    suppression (so the violation it meant to silence still fires)."""
    out: dict[int, set[str]] = {}
    hatches: list[tuple[int, str, str]] = []
    for i, line in enumerate(lines, 1):
        for m in _SUPPRESS_RE.finditer(line):
            token, reason = m.group(1), m.group(2).strip()
            if token in SUPPRESSIBLE and reason:
                out.setdefault(i, set()).add(token)
                hatches.append((i, token, reason))
    return out, hatches


# Runtime escape hatches whose reason argument position we know:
# ownership.escape(reason) / lifecycle.escape(reason) take it first,
# rcu.thaw(obj, reason) second.
_RUNTIME_HATCHES = {"escape": 0, "thaw": 1}


def _runtime_hatches(f: "SourceFile") -> "list[tuple[int, str, str]]":
    """``escape(...)``/``thaw(...)`` calls with their literal reasons —
    the runtime half of the hatch audit. Non-literal reasons surface as
    ``"<dynamic>"`` (still auditable, just not statically)."""
    out: list[tuple[int, str, str]] = []
    for node in f.walk():
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else \
            fn.attr if isinstance(fn, ast.Attribute) else None
        if name not in _RUNTIME_HATCHES:
            continue
        idx = _RUNTIME_HATCHES[name]
        if len(node.args) > idx:
            a = node.args[idx]
            reason = a.value if isinstance(a, ast.Constant) \
                and isinstance(a.value, str) else "<dynamic>"
        else:
            reason = ""   # missing reason: the state/rcu rules flag it
        out.append((node.lineno, name, reason))
    return out


def load_files(roots: list[str]) -> tuple[list[SourceFile], list[Violation]]:
    """Parse every .py under the given roots. Unparseable files are
    reported as violations (a linter that skips broken files lies)."""
    files: list[SourceFile] = []
    errors: list[Violation] = []
    seen: set[Path] = set()
    for root in roots:
        rp = Path(root)
        paths = sorted(rp.rglob("*.py")) if rp.is_dir() else [rp]
        base = rp.parent
        root_in_fixtures = "xlint_fixtures" in rp.resolve().parts
        for p in paths:
            p = p.resolve()
            if p in seen:
                continue
            if "xlint_fixtures" in p.parts and not root_in_fixtures:
                # Deliberate anti-pattern fixtures: linted only when the
                # fixture tree itself is the scan root (the rule tests).
                continue
            seen.add(p)
            try:
                rel = str(p.relative_to(base.resolve()))
            except ValueError:
                rel = str(p)
            try:
                src = p.read_text()
                tree = ast.parse(src, filename=str(p))
            except (OSError, SyntaxError) as e:
                errors.append(Violation("parse", rel, getattr(e, "lineno", 0)
                                        or 0, f"cannot parse: {e}"))
                continue
            lines = src.splitlines()
            suppressions, hatches = _parse_suppressions(lines)
            files.append(SourceFile(path=p, rel=rel, tree=tree, lines=lines,
                                    suppressions=suppressions,
                                    hatches=hatches))
    return files, errors


def run(roots: list[str], profile: str = "strict",
        stats: "dict | None" = None) -> list[Violation]:
    """Lint ``roots``. ``profile="support"`` (tests/, benchmarks/) drops
    the declaration-discipline rule — support code does not register
    locks or points — but keeps every behavioral rule; the registry
    rules are inert on partial trees anyway (no registry file in the
    roots). The tree is parsed once; every rule shares the parse and
    the cached walks. ``stats`` (optional dict) receives run metadata
    (currently ``files``)."""
    from . import rules

    files, violations = load_files(roots)
    if stats is not None:
        stats["files"] = len(files)
        hatches = []
        for f in files:
            for line, token, reason in f.hatches:
                hatches.append({"path": f.rel, "line": line,
                                "kind": f"comment:{token}",
                                "reason": reason})
            for line, name, reason in _runtime_hatches(f):
                hatches.append({"path": f.rel, "line": line,
                                "kind": f"runtime:{name}",
                                "reason": reason})
        stats["hatches"] = sorted(hatches,
                                  key=lambda h: (h["path"], h["line"]))
    project = rules.Project(files)
    active = rules.ALL_RULES if profile == "strict" else rules.SUPPORT_RULES
    for rule_fn in active:
        violations.extend(rule_fn(project))
    return sorted(set(violations), key=lambda v: (v.path, v.line, v.rule))


#: Flags the CLI understands; anything else dash-prefixed is a usage
#: error (stable exit code 2, so callers can tell "violations" from
#: "you invoked me wrong").
_KNOWN_FLAGS = {"-q", "--support", "--format", "--changed"}

#: Registry files: violations here are NEVER filtered by --changed —
#: the registries are bidirectionally cross-checked against every call
#: site, so an unchanged registry can go stale because of your diff.
_REGISTRY_BASENAMES = {"faults.py", "tracing.py", "wire.py", "rcu.py",
                       "ownership.py", "lifecycle.py", "metrics.py"}


def _changed_files(ref: str) -> "set[str] | None":
    """Basenamed-relative paths changed vs `ref` (tracked diff +
    untracked), or None when git can't answer (bad ref / not a repo)."""
    import subprocess
    out: set[str] = set()
    for cmd in (["git", "diff", "--name-only", ref],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(cmd, capture_output=True, text=True,
                                 check=True)
        except (OSError, subprocess.CalledProcessError):
            return None
        out.update(line.strip() for line in res.stdout.splitlines()
                   if line.strip().endswith(".py"))
    return out


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quiet = "-q" in argv
    profile = "support" if "--support" in argv else "strict"
    fmt = "text"
    changed_ref: "str | None" = None
    roots: list[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--format":
            if i + 1 >= len(argv) or argv[i + 1] not in ("text", "json"):
                print("xlint: --format takes 'text' or 'json'",
                      file=sys.stderr)
                return 2
            fmt = argv[i + 1]
            i += 2
            continue
        if a == "--changed":
            if i + 1 >= len(argv) or argv[i + 1].startswith("-"):
                print("xlint: --changed takes a git ref", file=sys.stderr)
                return 2
            changed_ref = argv[i + 1]
            i += 2
            continue
        if a.startswith("-") and a not in _KNOWN_FLAGS:
            print(f"xlint: unknown flag {a!r} (known: "
                  f"{' '.join(sorted(_KNOWN_FLAGS))})", file=sys.stderr)
            return 2
        if not a.startswith("-"):
            roots.append(a)
        i += 1
    if not roots:
        pkg = Path(__file__).resolve().parents[2]
        roots = [str(pkg)]
    stats: dict = {}
    violations = run(roots, profile=profile, stats=stats)
    if changed_ref is not None:
        # Full-tree analysis (registry cross-checks and call-graph
        # summaries need the whole tree), output scoped to the diff.
        changed = _changed_files(changed_ref)
        if changed is None:
            print(f"xlint: --changed {changed_ref!r}: git diff failed "
                  f"(bad ref or not a git checkout)", file=sys.stderr)
            return 2
        changed_norm = {c.replace("\\", "/") for c in changed}

        def keep(v: Violation) -> bool:
            p = v.path.replace("\\", "/")
            if Path(p).name in _REGISTRY_BASENAMES:
                return True
            return any(c == p or c.endswith("/" + p) for c in changed_norm)

        violations = [v for v in violations if keep(v)]
    if fmt == "json":
        import json as _json

        print(_json.dumps({
            "profile": profile,
            "roots": roots,
            "files": stats.get("files", 0),
            "changed": changed_ref,
            "count": len(violations),
            "violations": [{"rule": v.rule, "path": v.path,
                            "line": v.line, "message": v.message}
                           for v in violations],
            "hatches": stats.get("hatches", []),
        }, indent=None))
        return 1 if violations else 0
    for v in violations:
        print(v)
    if not violations and not quiet:
        scope = f", changed vs {changed_ref}" if changed_ref else ""
        print(f"xlint: clean ({len(roots)} root(s), {profile} "
              f"profile{scope})")
    return 1 if violations else 0

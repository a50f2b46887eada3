"""Static-analysis package behind ``scripts/lint.py`` (docs/ANALYSIS.md).

The reference gates its tree with xref + elvis in CI; this image has
no ruff/mypy/pyflakes and installs are off-limits, so the gate is
stdlib-``ast`` built. Where the old single-file linter knew only
generic Python smells, this package checks the invariants THIS
codebase lives by:

  core.py             F401/F811/B006/E722/E711/F631 (generic smells)
  domains.py          CD101/CD103/CD104 — thread-domain call graph +
                      async misuse (emqx_tpu/concurrency.py markers)
  locks.py            CD102 — registered shared-attribute writes
                      outside their lock
  metrics_drift.py    RD201/RD202/RD203/RD204 — metric name registry
                      + docs/OBSERVABILITY.md cross-check
  faults_drift.py     RD211..RD214 — fault-point catalog vs sites vs
                      docs/ROBUSTNESS.md vs the test suite
  config_drift.py     RD221/RD222 — closed-schema config dataclasses
                      vs etc/emqx_tpu.toml
  telemetry_drift.py  RD231/RD232 — telemetry STAGES vs observe sites
  device_purity.py    DP301 — host-sync constructs in emqx_tpu/ops/
  pragmas.py          the ``# lint: ok-<RULE> <why>`` waiver engine
                      (LNT001/LNT002)

Every checker module exposes ``RULES`` (id -> one-line description),
``check(fi, ctx)`` (per-file findings) and optionally
``finalize(ctx)`` (repo-level findings after all files are seen).
W605/E999 are produced by the parse step in :func:`parse_file`.
"""

from __future__ import annotations

import ast
import dataclasses
import re
import warnings
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Set, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str
    msg: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.msg}"


class FileInfo:
    """One parsed source file handed to every checker."""

    def __init__(self, path: str, src: str,
                 tree: Optional[ast.Module]) -> None:
        self.path = path
        self.src = src
        self.lines = src.splitlines()
        self.tree = tree


class Context:
    """Repo-level data shared by the drift checkers, plus the scratch
    the per-file passes accumulate for ``finalize``. Tests construct
    one by hand with fixture registries (``Context()`` is empty)."""

    def __init__(self) -> None:
        self.root: Optional[Path] = None
        # -- metrics registry (emqx_tpu/metrics.py + .new() sites)
        self.metric_names: Set[str] = set()
        self.gauge_metrics: Set[str] = set()
        self.metric_registry_loc: Tuple[str, int] = ("", 0)
        # -- stats gauge registry (emqx_tpu/stats.py STATS_KEYS)
        self.stats_keys: Set[str] = set()
        # -- docs corpora
        self.docs_observability: str = ""
        self.docs_robustness: str = ""
        self.tests_text: str = ""
        # -- fault catalog (emqx_tpu/faults.py POINTS)
        self.fault_points: Dict[str, int] = {}   # point -> def line
        self.fault_catalog_path: str = "emqx_tpu/faults.py"
        # -- telemetry stages (emqx_tpu/telemetry.py), and the port's
        # (emqx_tpu_torch/telemetry.py)
        self.stages: Tuple[str, ...] = ()
        self.stages_loc: Tuple[str, int] = ("", 0)
        self.port_stages: Tuple[str, ...] = ()
        self.port_stages_loc: Tuple[str, int] = ("", 0)
        # -- config schema: section -> {field -> (path, line)}
        self.schema: Dict[str, Dict[str, Tuple[str, int]]] = {}
        # -- example toml: section -> {key -> line}; plus path
        self.toml_keys: Dict[str, Dict[str, int]] = {}
        self.toml_path: str = "etc/emqx_tpu.toml"
        # -- device-purity whitelist: ops/ function names that ARE
        # the sanctioned fetch/transfer seams
        self.device_whitelist: Set[str] = set()
        # -- per-file scratch the finalize passes read
        self.fire_sites: List[Tuple[str, int, str]] = []
        self.stage_sites: List[Tuple[str, int, str]] = []
        self.metric_sites: List[Tuple[str, int, str, str]] = []

    # a name is "documented" when it appears verbatim in the docs
    # text, or a family glob ``prefix.*`` in the docs covers it
    _GLOB = re.compile(r"`([a-z0-9_.]+)\.\*`")

    def documented(self, name: str, text: str) -> bool:
        if name in text:
            return True
        for m in self._GLOB.finditer(text):
            if name.startswith(m.group(1) + "."):
                return True
        return False


def parse_file(path: Path, rel: str) -> Tuple[FileInfo, List[Finding]]:
    """Read + parse one file; surfaces W605 (SyntaxWarning escalated)
    and E999 as findings with ``tree = None``."""
    src = path.read_text(encoding="utf-8")
    findings: List[Finding] = []
    tree: Optional[ast.Module] = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", SyntaxWarning)
            tree = ast.parse(src, filename=rel)
    except SyntaxWarning as w:
        findings.append(Finding(rel, getattr(w, "lineno", 0) or 0,
                                "W605", str(w)))
    except SyntaxError as e:
        findings.append(Finding(rel, e.lineno or 0, "E999",
                                e.msg or "syntax error"))
    return FileInfo(rel, src, tree), findings


# -- context construction (the real repo; tests hand-build instead) ------

def _literal_strs(node: ast.AST) -> List[str]:
    out = []
    for elt in getattr(node, "elts", []):
        if isinstance(elt, ast.Constant) and isinstance(elt.value, str):
            out.append(elt.value)
    return out


def _read(root: Path, rel: str) -> str:
    p = root / rel
    try:
        return p.read_text(encoding="utf-8")
    except OSError:
        return ""


#: ops/ functions that ARE the sanctioned device→host transfer seams
#: (DP301): each one exists so every other kernel call can stay
#: async — a sync inside any of these is the coalesced fetch the
#: dispatch pipeline planned for, not a stall
DEVICE_FETCH_SEAMS = frozenset({
    "fetch_walk_result",  # ops/walk_pallas.py — walk parity/bench
})


def build_context(root: Path) -> Context:
    ctx = Context()
    ctx.root = root
    ctx.device_whitelist = set(DEVICE_FETCH_SEAMS)
    # metrics registry: every *_METRICS list literal in metrics.py,
    # the GAUGE_METRICS set, plus .new("literal") registrations
    # anywhere in the package (retainer/monitors register at attach)
    mpath = root / "emqx_tpu" / "metrics.py"
    if mpath.exists():
        tree = ast.parse(mpath.read_text(encoding="utf-8"))
        for node in tree.body:
            if isinstance(node, ast.Assign) and node.targets and \
                    isinstance(node.targets[0], ast.Name):
                name = node.targets[0].id
                if name.endswith("_METRICS") and \
                        isinstance(node.value, (ast.List, ast.Tuple)):
                    ctx.metric_names.update(_literal_strs(node.value))
                    ctx.metric_registry_loc = ("emqx_tpu/metrics.py",
                                               node.lineno)
                if name == "GAUGE_METRICS":
                    for sub in ast.walk(node.value):
                        if isinstance(sub, (ast.Set, ast.List,
                                            ast.Tuple)):
                            ctx.gauge_metrics.update(
                                _literal_strs(sub))
    for rel in sorted((root / "emqx_tpu").rglob("*.py")):
        try:
            tree = ast.parse(rel.read_text(encoding="utf-8"))
        except SyntaxError:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr == "new" and node.args and \
                    isinstance(node.args[0], ast.Constant) and \
                    isinstance(node.args[0].value, str):
                ctx.metric_names.add(node.args[0].value)
    # stats gauge registry
    spath = root / "emqx_tpu" / "stats.py"
    if spath.exists():
        tree = ast.parse(spath.read_text(encoding="utf-8"))
        for node in tree.body:
            if isinstance(node, ast.Assign) and node.targets and \
                    isinstance(node.targets[0], ast.Name) and \
                    node.targets[0].id == "STATS_KEYS":
                ctx.stats_keys.update(_literal_strs(node.value))
    # fault catalog
    fpath = root / "emqx_tpu" / "faults.py"
    if fpath.exists():
        tree = ast.parse(fpath.read_text(encoding="utf-8"))
        for node in tree.body:
            if isinstance(node, ast.AnnAssign) and \
                    isinstance(node.target, ast.Name) and \
                    node.target.id == "POINTS" and \
                    isinstance(node.value, ast.Dict):
                for k in node.value.keys:
                    if isinstance(k, ast.Constant) and \
                            isinstance(k.value, str):
                        ctx.fault_points[k.value] = k.lineno
    # telemetry stages, of the JAX package and of the port
    for pkg, attr in (("emqx_tpu", "stages"),
                      ("emqx_tpu_torch", "port_stages")):
        tpath = root / pkg / "telemetry.py"
        if not tpath.exists():
            continue
        tree = ast.parse(tpath.read_text(encoding="utf-8"))
        for node in tree.body:
            if isinstance(node, (ast.Assign, ast.AnnAssign)):
                tgt = node.targets[0] if isinstance(node, ast.Assign) \
                    else node.target
                if isinstance(tgt, ast.Name) and tgt.id == "STAGES" \
                        and isinstance(node.value,
                                       (ast.List, ast.Tuple)):
                    setattr(ctx, attr,
                            tuple(_literal_strs(node.value)))
                    setattr(ctx, attr + "_loc",
                            (f"{pkg}/telemetry.py", node.lineno))
    # config schema + example toml
    from analysis import config_drift
    config_drift.load_schema(ctx)
    config_drift.load_toml(ctx)
    # docs + tests corpora
    ctx.docs_observability = _read(root, "docs/OBSERVABILITY.md")
    ctx.docs_robustness = _read(root, "docs/ROBUSTNESS.md")
    parts = []
    tdir = root / "tests"
    if tdir.is_dir():
        for p in sorted(tdir.glob("*.py")):
            parts.append(_read(root, f"tests/{p.name}"))
    ctx.tests_text = "\n".join(parts)
    return ctx


# -- checker registry ----------------------------------------------------

def checkers():
    from analysis import (config_drift, core, device_purity, domains,
                          faults_drift, locks, metrics_drift,
                          telemetry_drift)
    return (core, domains, locks, metrics_drift, faults_drift,
            config_drift, telemetry_drift, device_purity)


def all_rules() -> Dict[str, str]:
    from analysis import pragmas
    rules: Dict[str, str] = {
        "W605": "invalid escape sequence in a plain string literal",
        "E999": "syntax error",
    }
    for mod in checkers():
        rules.update(mod.RULES)
    rules.update(pragmas.RULES)
    return rules


def run(files: Sequence[FileInfo], ctx: Context,
        parse_findings: Sequence[Finding] = (),
        rule: Optional[str] = None):
    """Run every checker over ``files``, apply pragma suppression,
    and return ``(kept, suppressed, per_rule_counts)``. ``rule``
    filters the report to one rule id (stale-pragma detection is then
    off — pragmas for other rules would look unused)."""
    from analysis import pragmas
    findings: List[Finding] = list(parse_findings)
    mods = checkers()
    for fi in files:
        if fi.tree is None:
            continue
        for mod in mods:
            findings.extend(mod.check(fi, ctx))
    for mod in mods:
        fin = getattr(mod, "finalize", None)
        if fin is not None:
            findings.extend(fin(ctx))
    by_path = {fi.path: fi for fi in files}
    kept, suppressed = pragmas.apply(findings, by_path,
                                     check_stale=rule is None)
    if rule is not None:
        kept = [f for f in kept if f.rule == rule]
    counts: Dict[str, int] = {}
    for f in kept:
        counts[f.rule] = counts.get(f.rule, 0) + 1
    return kept, suppressed, counts


def analyze_source(src: str, path: str = "emqx_tpu/example.py",
                   ctx: Optional[Context] = None,
                   rule: Optional[str] = None):
    """Test/fixture entry point: lint one in-memory source blob.
    Returns ``(kept, suppressed)`` finding lists."""
    findings: List[Finding] = []
    tree: Optional[ast.Module] = None
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error", SyntaxWarning)
            tree = ast.parse(src, filename=path)
    except SyntaxWarning as w:
        findings.append(Finding(path, getattr(w, "lineno", 0) or 0,
                                "W605", str(w)))
    except SyntaxError as e:
        findings.append(Finding(path, e.lineno or 0, "E999",
                                e.msg or "syntax error"))
    fi = FileInfo(path, src, tree)
    kept, suppressed, _counts = run([fi], ctx or Context(),
                                    parse_findings=findings, rule=rule)
    return kept, suppressed

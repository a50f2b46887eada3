#!/usr/bin/env python
"""The repo's static-analysis gate (driver for scripts/analysis/).

The reference gates its tree with xref + elvis in CI
(/root/reference/rebar.config:27-30). This image has no
ruff/mypy/pyflakes and installs are off-limits, so the gate is built
on stdlib ``ast`` — and beyond the generic smells it checks the
invariants THIS codebase lives by: thread/loop-affinity domains,
lock-guarded shared state, and the five parallel registries
(metrics, stats gauges, fault points, closed-schema TOML, telemetry
stages) that must stay in sync with docs/. Rule catalog:
docs/ANALYSIS.md.

Usage:
    python scripts/lint.py [paths...]        # full gate (ci.sh)
    python scripts/lint.py --stats           # + per-rule counts
    python scripts/lint.py --rule CD102      # one rule only
    python scripts/lint.py --list-rules      # catalog

Exit status is nonzero on any unwaived finding. Waivers are inline
``# lint: ok-<RULE> <why>`` pragmas — and are themselves checked
(reason required, stale pragmas flagged).
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

import analysis  # noqa: E402  (needs the scripts/ dir on sys.path)

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_TARGETS = ["emqx_tpu", "emqx_tpu_torch", "tests", "scripts",
                   "bench.py", "__graft_entry__.py"]


def main(argv) -> int:
    rule = None
    stats = False
    targets = []
    it = iter(argv)
    for a in it:
        if a == "--rule":
            rule = next(it, None)
            if rule is None:
                print("--rule needs a rule id (see --list-rules)")
                return 2
        elif a == "--stats":
            stats = True
        elif a == "--list-rules":
            for rid, desc in sorted(analysis.all_rules().items()):
                print(f"{rid:7s} {desc}")
            return 0
        elif a.startswith("-"):
            print(__doc__)
            return 2
        else:
            targets.append(a)
    rules = analysis.all_rules()
    if rule is not None and rule not in rules:
        print(f"unknown rule {rule!r}; see --list-rules")
        return 2

    paths = []
    for t in targets or DEFAULT_TARGETS:
        p = Path(t)
        paths.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    ctx = analysis.build_context(ROOT)
    files = []
    parse_findings = []
    for p in paths:
        try:
            rel = str(p.resolve().relative_to(ROOT))
        except ValueError:
            rel = str(p)
        fi, errs = analysis.parse_file(p, rel)
        files.append(fi)
        parse_findings.extend(errs)
    kept, suppressed, counts = analysis.run(
        files, ctx, parse_findings=parse_findings, rule=rule)
    for f in sorted(kept, key=lambda f: (f.path, f.line, f.rule)):
        print(f.render())
    if stats:
        print("-- per-rule findings --")
        sup_by_rule = {}
        for f in suppressed:
            sup_by_rule[f.rule] = sup_by_rule.get(f.rule, 0) + 1
        for rid in sorted(set(counts) | set(sup_by_rule)):
            line = f"{rid:7s} {counts.get(rid, 0):4d}"
            if sup_by_rule.get(rid):
                line += f"   ({sup_by_rule[rid]} waived)"
            print(line)
    print(f"lint: {len(files)} files, {len(kept)} finding(s), "
          f"{len(suppressed)} waived")
    return 1 if kept else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

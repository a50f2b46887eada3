"""RD23x — telemetry stage registry vs observe sites.

The ``STAGES`` tuple in ``emqx_tpu/telemetry.py`` (and, for the port,
in ``emqx_tpu_torch/telemetry.py``: each package's sites are held to
its own registry) is the single
source of truth three surfaces render from: the per-stage histogram
dict, the Prometheus ``emqx_tpu_publish_stage_<stage>_ms`` families,
and the ``ctl telemetry`` table — all built by iterating STAGES, so
an observed stage that is NOT in the tuple silently drops every
sample (``Telemetry.finish`` and ``observe_stage`` both no-op on an
unknown name rather than KeyError):

  RD231  a literal stage observed via ``span.add``/``span.add_ms``/
         ``observe_stage`` (or a ``span.stages["..."]`` store) is
         not in STAGES — its samples vanish without a trace.
  RD232  a STAGES entry has no observe site anywhere — a stage that
         renders as a permanently-zero histogram row in every
         surface (the usual smell after a pipeline refactor).

Receivers accepted for ``add``/``add_ms`` are span-shaped only
(``span.…``, ``…​.span.…``, ``self`` inside telemetry.py) so
``set.add("...")`` never false-positives.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from analysis import FileInfo, Finding

RULES = {
    "RD231": "observed telemetry stage not in STAGES",
    "RD232": "STAGES entry with no observe site (always-zero row)",
}


#: package → the Context attribute holding its STAGES registry
_REGISTRIES = {"emqx_tpu": "stages", "emqx_tpu_torch": "port_stages"}


def _package(path: str) -> Optional[str]:
    """The package whose registry a file's sites answer to, or None."""
    top = path.replace("\\", "/").split("/", 1)[0]
    return top if top in _REGISTRIES else None


def _registry(ctx, pkg: str):
    attr = _REGISTRIES[pkg]
    return getattr(ctx, attr), getattr(ctx, attr + "_loc")


def _chain(node) -> Optional[str]:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _span_receiver(func: ast.Attribute, path: str) -> bool:
    chain = _chain(func.value)
    if chain is None:
        return False
    if chain == "self" and path.endswith("telemetry.py"):
        return True
    # the broker binds `sp = pb.span` before instrumented sections
    return chain.split(".")[-1] in ("span", "sp")


def check(fi: FileInfo, ctx) -> List[Finding]:
    pkg = _package(fi.path)
    if pkg is None:
        return []
    stages, _loc = _registry(ctx, pkg)
    out: List[Finding] = []
    for node in ast.walk(fi.tree):
        stage = None
        line = 0
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            lit = (node.args and isinstance(node.args[0], ast.Constant)
                   and isinstance(node.args[0].value, str))
            if attr == "observe_stage" and lit:
                stage, line = node.args[0].value, node.lineno
            elif attr in ("add", "add_ms") and lit and \
                    _span_receiver(node.func, fi.path):
                stage, line = node.args[0].value, node.lineno
        elif isinstance(node, (ast.Assign, ast.AugAssign)):
            tgt = node.targets[0] if isinstance(node, ast.Assign) \
                else node.target
            if isinstance(tgt, ast.Subscript) and \
                    isinstance(tgt.value, ast.Attribute) and \
                    tgt.value.attr == "stages" and \
                    isinstance(tgt.slice, ast.Constant) and \
                    isinstance(tgt.slice.value, str):
                stage, line = tgt.slice.value, node.lineno
        if stage is None:
            continue
        ctx.stage_sites.append((fi.path, line, stage))
        if stages and stage not in stages:
            out.append(Finding(
                fi.path, line, "RD231",
                f"stage '{stage}' is not in {pkg}/telemetry.STAGES — "
                f"its samples are silently dropped by every surface"))
    return out


def finalize(ctx) -> List[Finding]:
    out: List[Finding] = []
    for pkg in _REGISTRIES:
        stages, (path, line) = _registry(ctx, pkg)
        observed = {s for p, _l, s in ctx.stage_sites
                    if _package(p) == pkg}
        if not stages or not observed:
            continue
        for stage in stages:
            if stage not in observed:
                out.append(Finding(
                    path, line, "RD232",
                    f"STAGES entry '{stage}' has no observe site — it "
                    f"renders as a permanently-zero histogram row"))
    return out

"""SARIF 2.1.0 output for flightcheck — CI code-scanning integration;
twin of ``fraud_detection_tpu/analysis/sarif.py``.

One static format buys every downstream surface at once: GitHub code
scanning annotates PR diffs from an uploaded SARIF run, editors render it
inline, and the artifact is a durable machine-readable record of a run
(the JSON ``--json`` mode stays the ad-hoc scripting surface).

The emitter produces the minimal valid document: one run, the full rule
catalog as ``tool.driver.rules`` (so ruleIndex resolves), one ``result``
per finding at ``error`` level, and the pragma-suppressed count in the
run properties. :func:`validate` checks the structural subset of the
2.1.0 schema this emitter exercises — required properties, types, index
consistency — so tests (and a paranoid CI) can assert validity without a
network fetch of the real schema.
"""

from __future__ import annotations

import posixpath
from typing import Dict, Iterable, List

from fraud_detection_tpu_torch.analysis.core import RULES, Finding

#: The driver name; the reference emits "flightcheck", and the port names
#: itself apart so the two packages' uploads stay distinguishable.
TOOL_NAME = "flightcheck-torch"
SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def _tool_version() -> str:
    try:
        from fraud_detection_tpu_torch import __version__
        return str(__version__)
    except Exception:  # pragma: no cover - import cycles in odd layouts
        return "0"


def build(findings: Iterable[Finding], *, suppressed: int = 0,
          n_files: int = 0, uri_prefix: str = "fraud_detection_tpu_torch") -> Dict:
    """Findings -> SARIF 2.1.0 document (a plain dict, json.dump-ready).
    ``uri_prefix`` roots the artifact URIs at the repo (GitHub resolves
    annotation paths from the repository root, not the package root)."""
    rule_ids = sorted(RULES)
    rule_index = {rid: i for i, rid in enumerate(rule_ids)}
    rules = [{
        "id": rid,
        "name": RULES[rid][0],
        "shortDescription": {"text": RULES[rid][1]},
        "defaultConfiguration": {"level": "error"},
        "helpUri": ("https://github.com/fraud-detection-tpu/"
                    "fraud-detection-tpu/blob/main/docs/static_analysis.md"),
    } for rid in rule_ids]
    results: List[Dict] = []
    for f in findings:
        results.append({
            "ruleId": f.rule,
            "ruleIndex": rule_index.get(f.rule, -1),
            "level": "error",
            "message": {"text": f.message},
            "locations": [{
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": posixpath.join(uri_prefix, f.path)
                        if uri_prefix else f.path,
                        "uriBaseId": "%SRCROOT%",
                    },
                    "region": {"startLine": max(1, int(f.line))},
                },
            }],
        })
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": TOOL_NAME,
                "version": _tool_version(),
                "informationUri": SARIF_SCHEMA,
                "rules": rules,
            }},
            "columnKind": "utf16CodeUnits",
            "results": results,
            "properties": {
                "suppressedByPragma": int(suppressed),
                "filesAnalyzed": int(n_files),
            },
        }],
    }


def validate(doc: Dict) -> List[str]:
    """Structural 2.1.0 validation of the subset :func:`build` emits.
    Returns human-readable problems (empty list = valid)."""
    errors: List[str] = []

    def need(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    need(isinstance(doc, dict), "document must be an object")
    if not isinstance(doc, dict):
        return errors
    need(doc.get("version") == SARIF_VERSION,
         f"version must be {SARIF_VERSION!r}, got {doc.get('version')!r}")
    runs = doc.get("runs")
    need(isinstance(runs, list) and len(runs) >= 1,
         "runs must be a non-empty array")
    if not isinstance(runs, list):
        return errors
    for i, run in enumerate(runs):
        where = f"runs[{i}]"
        if not isinstance(run, dict):
            errors.append(f"{where} must be an object")
            continue
        driver = run.get("tool", {}).get("driver") \
            if isinstance(run.get("tool"), dict) else None
        need(isinstance(driver, dict) and isinstance(driver.get("name"), str)
             and driver.get("name"),
             f"{where}.tool.driver.name is required and must be a string")
        rules = driver.get("rules", []) if isinstance(driver, dict) else []
        rule_ids = []
        for j, rule in enumerate(rules):
            need(isinstance(rule, dict)
                 and isinstance(rule.get("id"), str) and rule.get("id"),
                 f"{where}.tool.driver.rules[{j}].id is required")
            if isinstance(rule, dict):
                rule_ids.append(rule.get("id"))
        results = run.get("results")
        need(isinstance(results, list), f"{where}.results must be an array")
        for j, res in enumerate(results or []):
            rwhere = f"{where}.results[{j}]"
            if not isinstance(res, dict):
                errors.append(f"{rwhere} must be an object")
                continue
            msg = res.get("message")
            need(isinstance(msg, dict) and isinstance(msg.get("text"), str),
                 f"{rwhere}.message.text is required")
            rid = res.get("ruleId")
            if rid is not None:
                need(rid in rule_ids,
                     f"{rwhere}.ruleId {rid!r} not in tool.driver.rules")
                idx = res.get("ruleIndex")
                if idx is not None and idx >= 0:
                    need(idx < len(rule_ids) and rule_ids[idx] == rid,
                         f"{rwhere}.ruleIndex {idx} does not point at "
                         f"{rid!r}")
            for k, loc in enumerate(res.get("locations", [])):
                phys = loc.get("physicalLocation", {}) \
                    if isinstance(loc, dict) else {}
                art = phys.get("artifactLocation", {})
                need(isinstance(art.get("uri"), str) and art.get("uri"),
                     f"{rwhere}.locations[{k}] artifactLocation.uri "
                     f"required")
                region = phys.get("region", {})
                start = region.get("startLine")
                need(isinstance(start, int) and start >= 1,
                     f"{rwhere}.locations[{k}] region.startLine must be a "
                     f"positive integer")
    return errors

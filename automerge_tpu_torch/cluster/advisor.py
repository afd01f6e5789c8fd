"""Report-only placement advisor: ranked, explained recommendations.

ROADMAP item 1 (read scale-out and elastic placement) needs an
actuation loop; this module is the half that can be built — and
trusted — first: a **pure function** from one telemetry snapshot (the
per-group heat tables of obs/heat.py, the seconds-based staleness of
the replication hub, per-doc store tiers) to an ordered list of
migration / replication / attention recommendations, each with a
human-readable reason. It never moves anything: the router's
``clusterAdvise`` RPC serves its output, the ``cluster-top`` CLI
renders it live, and actuation stays a small follow-up that consumes
the same list.

Being a pure function of its input dict is the whole design: the unit
tests feed synthetic skew and assert exact output; determinism comes
from sorted iteration and explicit tie-breaks (score desc, then kind,
then doc name) — no clocks, no randomness, no I/O.

Rule set (each rule names itself in the reason string):

* **imbalance** — when one group's total request heat exceeds
  ``imbalance_ratio``× the coolest group's, recommend moving the
  hottest group's *coldest* documents (cold ballast moves cheap and
  frees capacity without relocating the hotspot) to the coolest group;
* **hot-doc** — when a single document carries more than ``hot_frac``
  of its group's heat, migration would only move the hotspot, so
  recommend adding a read replica for that document instead;
* **staleness** — a follower whose staleness exceeds
  ``staleness_threshold`` seconds gets an attention recommendation
  (replication is the bottleneck there, not placement);
* **tier** — a document ranked in its group's top few by heat but
  resident warm/cold is paying hydration latency on a hot path:
  recommend promotion.

The port of ``automerge_tpu/cluster/advisor.py``, unchanged: the same
snapshot gives the same recommendations in both packages.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _group_load(heat: dict) -> float:
    return sum(
        float(e.get("rank", 0.0))
        for e in (heat.get("entries") or ())
    )


def _fmt(v: float) -> str:
    return f"{v:.2f}"


def advise(
    snapshot: dict,
    *,
    max_recommendations: int = 8,
    imbalance_ratio: float = 2.0,
    hot_frac: float = 0.7,
    staleness_threshold: float = 1.0,
    migrate_docs: int = 3,
) -> dict:
    """Snapshot in, ranked explained recommendations out. See the
    module docstring for the shape contract: ``snapshot["groups"]`` is
    a list of ``{"group": idx, "leader": addr, "heat": <heatStatus>,
    "staleness": <hub staleness_report>, "tiers": {doc: tier}}`` (all
    parts optional — missing telemetry shrinks the rule set, it never
    raises)."""
    groups = sorted(
        (g for g in (snapshot.get("groups") or ()) if isinstance(g, dict)),
        key=lambda g: g.get("group", 0),
    )
    recs: List[dict] = []
    loads: Dict[int, float] = {}
    for g in groups:
        loads[g.get("group", 0)] = _group_load(g.get("heat") or {})

    # -- imbalance / hot-doc (needs at least two groups) ---------------------
    if len(groups) >= 2:
        by_load = sorted(groups, key=lambda g: (loads[g.get("group", 0)],
                                                g.get("group", 0)))
        coolest, hottest = by_load[0], by_load[-1]
        lo = loads[coolest.get("group", 0)]
        hi = loads[hottest.get("group", 0)]
        if hi > 0.0 and hi > imbalance_ratio * max(lo, 1e-9):
            entries = sorted(
                ((hottest.get("heat") or {}).get("entries") or ()),
                key=lambda e: (-float(e.get("rank", 0.0)),
                               str(e.get("doc", ""))),
            )
            top = entries[0] if entries else None
            if top is not None and float(top.get("rank", 0.0)) > hot_frac * hi:
                recs.append({
                    "kind": "replicate",
                    "doc": str(top.get("doc", "")),
                    "group": hottest.get("group", 0),
                    "score": round(float(top.get("rank", 0.0)), 4),
                    "reason": (
                        f"doc {top.get('doc')!r} carries "
                        f"{_fmt(100.0 * float(top.get('rank', 0.0)) / hi)}% "
                        f"of group {hottest.get('group', 0)}'s heat "
                        f"({_fmt(hi)} vs coolest group "
                        f"{coolest.get('group', 0)} at {_fmt(lo)}); "
                        "migrating it would only move the hotspot — add a "
                        "read replica and route reads there instead"
                    ),
                })
            else:
                # cold ballast: cheapest-to-move docs first, never the
                # hottest (moving the top doc moves the problem)
                ballast = sorted(
                    entries[1:] if len(entries) > 1 else entries,
                    key=lambda e: (float(e.get("rank", 0.0)),
                                   str(e.get("doc", ""))),
                )
                gap = hi - lo
                for e in ballast[:migrate_docs]:
                    recs.append({
                        "kind": "migrate",
                        "doc": str(e.get("doc", "")),
                        "group": hottest.get("group", 0),
                        "to": coolest.get("group", 0),
                        "score": round(gap, 4),
                        "reason": (
                            f"group {hottest.get('group', 0)} carries "
                            f"{_fmt(hi)} heat vs group "
                            f"{coolest.get('group', 0)}'s {_fmt(lo)} "
                            f"(> {imbalance_ratio:g}x); "
                            f"doc {e.get('doc')!r} is cold ballast there "
                            f"(rank {_fmt(float(e.get('rank', 0.0)))}) — "
                            "moving it rebalances without relocating the "
                            "hot set"
                        ),
                    })

    # -- staleness attention --------------------------------------------------
    for g in groups:
        stale = g.get("staleness") or {}
        for follower in sorted(stale):
            per = (stale.get(follower) or {}).get("computed") or {}
            if not per:
                continue
            worst_doc = max(sorted(per), key=lambda d: per[d])
            worst = float(per[worst_doc])
            if worst > staleness_threshold:
                recs.append({
                    "kind": "staleness",
                    "doc": str(worst_doc),
                    "group": g.get("group", 0),
                    "node": str(follower),
                    "score": round(worst, 4),
                    "reason": (
                        f"follower {follower} is {_fmt(worst)}s stale on "
                        f"doc {worst_doc!r} (threshold "
                        f"{staleness_threshold:g}s): replication, not "
                        "placement, is the bottleneck — check link health "
                        "before routing reads there"
                    ),
                })

    # -- tier mismatch --------------------------------------------------------
    for g in groups:
        tiers = g.get("tiers") or {}
        entries = sorted(
            ((g.get("heat") or {}).get("entries") or ()),
            key=lambda e: (-float(e.get("rank", 0.0)), str(e.get("doc", ""))),
        )
        for e in entries[:3]:
            doc = str(e.get("doc", ""))
            tier = tiers.get(doc)
            rank = float(e.get("rank", 0.0))
            if tier in ("warm", "cold") and rank > 0.0:
                recs.append({
                    "kind": "promote",
                    "doc": doc,
                    "group": g.get("group", 0),
                    "score": round(rank, 4),
                    "reason": (
                        f"doc {doc!r} ranks top-3 by heat in group "
                        f"{g.get('group', 0)} (rank {_fmt(rank)}) but is "
                        f"resident {tier}: every access pays hydration — "
                        "promote it to the hot tier"
                    ),
                })

    recs.sort(key=lambda r: (-r["score"], r["kind"], r.get("doc", "")))
    return {
        "recommendations": recs[:max_recommendations],
        "groupLoads": {str(k): round(v, 4) for k, v in sorted(loads.items())},
        "groups": [
            {
                "group": g.get("group", 0),
                "leader": g.get("leader"),
                "load": round(loads[g.get("group", 0)], 4),
                "docs": len((g.get("heat") or {}).get("entries") or ()),
            }
            for g in groups
        ],
    }


def render_text(advice: dict, top: Optional[int] = None) -> str:
    """The ``cluster-top`` / ``clusterAdvise`` human rendering."""
    lines = []
    groups = advice.get("groups") or []
    if groups:
        lines.append(f"  {'group':<7} {'leader':<24} {'load':>10} {'docs':>6}")
        for g in groups:
            lines.append(
                f"  {g.get('group', 0):<7} {str(g.get('leader', '')):<24} "
                f"{g.get('load', 0.0):>10.2f} {g.get('docs', 0):>6}"
            )
    recs = advice.get("recommendations") or []
    if not recs:
        lines.append("no recommendations: load is balanced and "
                     "replication is fresh")
    else:
        lines.append("recommendations (report-only; nothing was moved):")
        for i, r in enumerate(recs[: top or len(recs)], start=1):
            lines.append(f"  {i}. [{r.get('kind')}] "
                         f"score {r.get('score', 0.0):g}")
            lines.append(f"     {r.get('reason', '')}")
    return "\n".join(lines) + "\n"

"""Counts since a reset, read from the ``obs`` registry's counters.

The port's ``compressed.stats()`` and ``batched.stats()`` predate its
``obs`` layer. Their counts now live in ``obs`` under the reference's
names (``oplog.ovc_join``, ``device.kernel_launches{path=batched}``, ...);
a ``CounterView`` keeps the old readers: ``read()`` gives each count's
growth since the view's last ``reset()``. Prometheus counters stay
monotone, so a reset only moves the view's baseline. Reading creates no
family and no label set.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from . import registry


class CounterView:
    """``spec``: {key: (counter name, label filter, label to split by)}.
    The filter ({label: allowed values}) keeps the label sets it admits;
    a key split by a label reads as {label value: count}, any other key
    as one number, the sum over the admitted label sets."""

    def __init__(self, spec: Dict[str, Tuple[str, Optional[dict], Optional[str]]]):
        self.spec = spec
        self._base = self._totals()

    def _totals(self) -> dict:
        out = {}
        with registry.lock:
            fams = registry._families
            for key, (name, where, by) in self.spec.items():
                total = {} if by else 0
                fam = fams.get((name, "counter"))
                for labels, child in (fam.children.items() if fam else ()):
                    lab = dict(labels)
                    if where and any(lab.get(k) not in v for k, v in where.items()):
                        continue
                    if by:
                        total[lab[by]] = total.get(lab[by], 0) + child.value
                    else:
                        total += child.value
                out[key] = total
        return out

    def reset(self) -> None:
        self._base = self._totals()

    def read(self) -> dict:
        """Each count's growth since the last reset (a registry cleared
        since, as ``obs.reset_all`` does, counts from zero)."""
        cur, base = self._totals(), self._base
        out = {}
        for key, v in cur.items():
            b = base.get(key)
            if isinstance(v, dict):
                d = {k: n - b.get(k, 0) if n >= b.get(k, 0) else n
                     for k, n in v.items()}
                out[key] = {k: n for k, n in d.items() if n}
            else:
                out[key] = v - b if v >= b else v
        return out

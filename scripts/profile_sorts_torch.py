#!/usr/bin/env python3
"""Where the time of the port's two sort-free kernels goes on the card.

    python3 scripts/profile_sorts_torch.py [--quick]

For ``sort_winners`` (K5) and ``radix_sort`` (K6's sort) at the text and
record fan-ins, and ``sort_winners`` at P = 2^20 + 12,345 (synthetic),
each beside ``torch.sort`` of the same keys: the CUDA-event
milliseconds of one call (as ``chip_smoke.py`` times it, host work of the
wrapper included) and, from ``torch.profiler``, the device time of each
CUDA kernel and memset the call runs, per call. Their difference is what
the host adds. ``--quick`` uses a 20,000-edit text fan-in and a
4,096-record store instead of the full-width ones. Needs a CUDA card;
prints the card's name and power limit first and one JSON line per row.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as S  # noqa: E402

REPS = 20


def device_ms(fn) -> tuple:
    """(device ms per call summed over its kernels, {kernel: ms per call})
    of ``fn()`` from torch.profiler over REPS calls after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            per[e.key[:60]] = t / REPS / 1e3
    return sum(per.values()), per


def row(shape: str, name: str, fn) -> None:
    total, per = device_ms(fn)
    print(json.dumps({"shape": shape, "fn": name, "event_ms": S.cuda_ms(fn, REPS),
                      "device_ms": total, "kernels": per}), flush=True)


def fanin_inputs(log, device):
    """sort_winners' inputs and the sibling keys of one fan-in's padded
    columns, as its merge makes them."""
    from automerge_tpu_torch.convert import columns_from_numpy
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import succ_vis as SV

    c = columns_from_numpy(log.padded_columns(), device)
    sv = SV.succ_vis(c["action"], c["value_tag"], c["value_i32"], c["covered"],
                     c["pred_src"], c["pred_tgt"])
    win_in = (c["action"], c["insert"], c["elem_ref"], c["obj_dense"], c["prop"],
              c["width"], sv[3])
    fo = F.forest(c["action"], c["insert"], c["elem_ref"], c["obj_dense"])
    return win_in, F.sibling_keys(fo[0], fo[1])


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("profile_sorts_torch: no CUDA device")
    print(S.card_line(), flush=True)
    from automerge_tpu_torch.kernels import forest as F
    from automerge_tpu_torch.kernels import radix_sort as RS
    from automerge_tpu_torch.kernels import sort_winners as SO
    from automerge_tpu_torch.ops.oplog import OpLog
    from automerge_tpu_torch.storage.change import parse_change

    device = torch.device("cuda", 0)
    if sys.argv[1:] == ["--quick"]:
        S.BASE_EDITS, S.REPLICAS, S.RECORDS, S.RECORD_REPLICAS = 20_000, 64, 4096, 64
    blobs = S.workload(S.BASE_EDITS, S.REPLICAS, S.PER_REPLICA)[0]
    text = OpLog.from_changes([parse_change(b)[0] for b in blobs])
    base, reps = S.record_workload()[:2]
    records = OpLog.from_changes([parse_change(b)[0] for b in [base] + reps])
    for shape, log in (("text", text), ("records", records)):
        win_in, sib = fanin_inputs(log, device)
        P = sib.numel()
        digits = F.sibling_digits(P)
        tag = f"{shape} P={P}"
        keys = S.group_keys(*win_in[:5])
        row(tag, "sort_winners", lambda: SO.sort_winners(*win_in))
        row(tag, "torch.sort(group keys)", lambda: torch.sort(keys))
        row(tag, f"radix_sort{digits}", lambda: RS.radix_sort(sib, digits))
        row(tag, "torch.sort(sib)", lambda: torch.sort(sib))
    wide = S.winner_columns(S.WIDE_P, 11, device)
    wide_keys = S.group_keys(*wide[:5])
    row(f"synthetic P={S.WIDE_P}", "sort_winners", lambda: SO.sort_winners(*wide))
    row(f"synthetic P={S.WIDE_P}", "torch.sort(group keys)", lambda: torch.sort(wide_keys))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Typing rates of the port's ``AutoDoc`` with its native edit sessions on
and off (the Python path), at the typing trace's full width.

Types the first ``--edits`` edits of ``workload.load_trace`` (all 260,000 by
default) one ``splice_text`` at a time, a commit every ``--every`` edits,
into an ``AutoDoc`` on ``--device`` with the sessions on, then into one with
them off; reads the text of each (for the sessions, the stale read and the
op-store rebuild through the merge kernels on the device) and checks that
both saves are byte for byte equal and the text is the trace's. Prints one
line per path and, last, one JSON object with the seconds and rates.

    python scripts/session_rates_torch.py                 # the card
    python scripts/session_rates_torch.py --device cpu --edits 24000
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--edits", type=int, default=None,
                    help="edits of the trace to type (default: all)")
    ap.add_argument("--every", type=int, default=1000, help="edits per commit")
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as S
    from automerge_tpu_torch import workload as W

    def sync():
        if str(args.device).startswith("cuda"):
            torch.cuda.synchronize()

    edits = W.load_trace(args.edits)
    want = S.replay_text(edits)
    out = {"device": str(args.device), "edits": len(edits), "every": args.every}
    if str(args.device).startswith("cuda"):
        out["card"] = S.card_line()
    saves = {}
    for sessions in (True, False):
        name = "sessions" if sessions else "python"
        doc = S.session_doc(args.device, sessions)
        with S.gc_pauses() as pauses:
            text_obj, typed_s, commits = S.type_trace(doc, edits, args.every)
        t0 = time.perf_counter()
        got = doc.text(text_obj)
        sync()
        t1 = time.perf_counter()
        doc.length(text_obj)
        sync()
        t2 = time.perf_counter()
        if got != want:
            raise AssertionError(f"{name}: the text is not the trace's")
        saves[name] = doc.save()
        out[name] = {"typed_s": typed_s, "edits_per_s": len(edits) / typed_s,
                     "gc_s": sum(s for _, s in pauses), "commits": commits,
                     "read_s": t1 - t0, "rebuild_s": t2 - t1}
        print(f"{name}: {len(edits)} edits in {typed_s:.3f} s, "
              f"{len(edits) / typed_s:.1f} edits/s, {commits} commits; the read "
              f"{t1 - t0:.6f} s, the rebuild {t2 - t1:.6f} s", flush=True)
        del doc
    if saves["sessions"] != saves["python"]:
        raise AssertionError("the sessions' save differs from the Python path's")
    out["save_bytes"] = len(saves["sessions"])
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

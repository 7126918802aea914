"""prep_idle_ms.serve: milliseconds a request in which the device was idle
while the host was preparing a batch: inside the program's
``serve.windows`` (the history windows), ``serve.history_gather`` or
``serve.to_device`` (the pageable copies) spans of main/reco_topk.py, each
idle gap cut against their intervals (harness/idle.py). Moves
serve_p95_ms."""
from harness.idle import idle_s_inside

SPANS = ("serve.windows", "serve.history_gather", "serve.to_device")


def read(rec):
    if rec.info["kind"] != "serve":
        return None
    s = idle_s_inside(rec, SPANS)
    return None if s is None else 1e3 * s / rec.info["steps"]

"""host_ms.serve: the host's milliseconds a request in the serving loop's
batch preparation: iter_infer_batches (the history windows),
UserHistory.gather and to_device (the host clock of their spans). Moves
serve_p95_ms."""

SPANS = ("iter_infer_batches", "history_gather", "to_device")


def read(rec):
    if rec.info["kind"] != "serve":
        return None
    parts = [rec.host_s(n) for n in SPANS]
    if all(p is None for p in parts):
        return None
    return 1e3 * sum(p or 0.0 for p in parts) / rec.info["steps"]

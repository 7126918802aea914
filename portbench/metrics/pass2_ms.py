"""pass2_ms: device milliseconds a request of the operations launched inside
the program's ``topk.pass2`` span (ops/topk.py's fused_catalog_topk: the
candidate ids, the gather of kp x 16 catalog rows a user, the batched
products, the mask and the final selection). Moves serve_users_per_s."""


def read(rec):
    if rec.info["kind"] != "serve":
        return None
    s = rec.device_s_under("topk.pass2")
    return None if s is None else 1e3 * s / rec.info["steps"]

"""user_tower_ms: device milliseconds a request of the operations launched
inside the model's user_emb (the tower: rows 1 and 3 at d=64). Moves
serve_users_per_s."""


def read(rec):
    if rec.info["kind"] != "serve":
        return None
    s = rec.device_s_under("user_emb")
    return None if s is None else 1e3 * s / rec.info["steps"]

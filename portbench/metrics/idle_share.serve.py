"""idle_share.serve: the share of the traced serving window in which no
device operation ran, in %: 1 - (the union of the device operations'
intervals) / the window. Moves serve_users_per_s."""


def read(rec):
    if rec.info["kind"] != "serve" or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)

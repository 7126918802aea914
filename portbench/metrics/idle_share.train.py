"""idle_share.train: the share of the traced training window in which no
device operation ran, in %: 1 - (the union of the device operations'
intervals) / the window. Moves train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train" or rec.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.busy_s() / rec.window_s)

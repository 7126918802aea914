"""augment_ms: device milliseconds a step of the operations launched inside
DeviceAugmenter.augment (negatives with row 8's membership kernel, the
history windows). Moves train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.device_s_under("augment")
    return None if s is None else 1e3 * s / rec.info["steps"]

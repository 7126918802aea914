"""hstu_encoder_ms: device milliseconds a step of the operations launched
inside the program's ``hstu.encoder`` span (models/modules.py::HSTUEncoder:
the forward of the eight HSTU layers, their projections, SiLU, norms, gate,
dropout and the attention kernel's forward). The backward runs outside the
span. Moves train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train":
        return None
    s = rec.device_s_under("hstu.encoder")
    return None if s is None else 1e3 * s / rec.info["steps"]

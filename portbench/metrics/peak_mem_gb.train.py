"""peak_mem_gb.train: torch.cuda.max_memory_allocated() over the traced
training window (reset at its start), in GB (1e9 bytes). Moves
train_examples_per_s."""


def read(rec):
    if rec.info["kind"] != "train" or not rec.info.get("peak_mem_bytes"):
        return None
    return rec.info["peak_mem_bytes"] / 1e9

"""pass2_useful_share: of the catalog rows fused_catalog_topk re-scored in
pass 2, the share it selected, in %: 100 x ``topk_selected`` (B k) over
``topk_rows_rescored`` (B kp 16) from the program's counters
(utils/tracing.py's ``counters()``), which count only while a profiler
runs, so over the traced window. None where the program has no such
counters or re-scored nothing. Moves serve_users_per_s."""


def program_counters():
    try:
        from unirec_tpu_torch.utils import tracing
    except ImportError:
        return {}
    return tracing.counters()


def read(rec):
    if rec.info["kind"] != "serve":
        return None
    c = program_counters()
    if not c.get("topk_rows_rescored"):
        return None
    return 100.0 * c["topk_selected"] / c["topk_rows_rescored"]

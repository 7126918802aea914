from unirec_tpu_torch.facility.evaluation.evaluators import (  # noqa: F401
    MultiPositiveEvaluator,
    OnePositiveEvaluator,
    SessionWiseEvaluator,
    build_evaluator,
)

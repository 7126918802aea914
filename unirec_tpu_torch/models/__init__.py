"""Model zoo of the port; importing it registers every ported model."""
from unirec_tpu_torch.models import sequential  # noqa: F401

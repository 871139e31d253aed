"""Training data (port of ``repro.data``)."""
from repro_torch.data.loader import DataConfig, make_loader  # noqa: F401
from repro_torch.data.synthetic import (  # noqa: F401
    synthetic_batches,
    synthetic_lm_tokens,
)

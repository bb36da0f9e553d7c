"""The port's ``repro.train``: the AdamW optimizer with mixed-precision
master weights (``optimizer``), int8 gradient compression with error
feedback (``grad_compress``) and the training loop (``loop``)."""
from repro_torch.train import optimizer  # noqa: F401

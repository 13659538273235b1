"""Optimizers and schedules of the port (``repro.optim``): an optimizer is
``(init, update, apply_)`` over parameter trees; ``update`` returns the
updates that are added to the parameters, ``apply_`` writes the step in
place."""

from repro_torch.optim.optimizers import (Optimizer, adamw, apply_updates,
                                          make_optimizer, sgd)
from repro_torch.optim.schedule import (constant, cosine_decay,
                                        linear_warmup_cosine)

__all__ = ["Optimizer", "adamw", "apply_updates", "sgd", "make_optimizer",
           "constant", "cosine_decay", "linear_warmup_cosine"]

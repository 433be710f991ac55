"""Distribution layer — the port of ``repro.sharding``: mesh-agnostic
partition rules plus the sparsity-on-the-wire subsystem, the bitmap-aware
collectives (``collectives``) and the explicit data-parallel training step
(``spmd_step``) on ``torch.distributed``."""
from .context import constraint, sharding_rules, current_rules  # noqa: F401
from . import collectives, partition, spmd_step  # noqa: F401

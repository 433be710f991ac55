"""The port's models: the paper's CNNs on the sparse units, and the FFN
block with the shared building blocks it needs."""
from . import cnn  # noqa: F401

"""The paper's CNNs on the port's sparse units."""
from . import cnn  # noqa: F401

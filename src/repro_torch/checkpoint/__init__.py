"""Crash-safe checkpoints in the reference's on-disk format."""
from .checkpoint import (CheckpointCorruptError, CheckpointError,  # noqa: F401
                         latest_step, load_state, restore,
                         restore_resharded, save,
                         set_crash_hook)

"""Launch layer: the step factory and the guarded single-device trainer."""

"""Launch layer: the step factories, the guarded trainer (single-process
or data-parallel over a ``mesh.Mesh``) and the serving entry point."""

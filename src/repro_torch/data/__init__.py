from .pipeline import image_batch  # noqa: F401

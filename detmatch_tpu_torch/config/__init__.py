from .config import Config  # noqa: F401

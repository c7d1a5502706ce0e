from . import oracle  # noqa: F401

from . import sgmse  # noqa: F401

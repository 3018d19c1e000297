from .base import BreverBaseModel, ModelRegistry, count_params  # noqa: F401

from . import convtasnet, tfgridnet  # noqa: F401

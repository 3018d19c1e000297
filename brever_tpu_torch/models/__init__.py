from .base import BreverBaseModel, ModelRegistry, count_params  # noqa: F401

from . import convtasnet, sgmse, tfgridnet  # noqa: F401

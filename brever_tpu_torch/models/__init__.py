from .base import BreverBaseModel, ModelRegistry, count_params  # noqa: F401

from . import convtasnet, dccrn, sgmse, tfgridnet  # noqa: F401

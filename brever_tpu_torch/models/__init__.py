from .base import BreverBaseModel, ModelRegistry, count_params  # noqa: F401

from . import convtasnet, dccrn, ffnn, manner, sgmse, tfgridnet  # noqa: F401

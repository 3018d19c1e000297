from .base import BreverBaseModel, ModelRegistry, count_params  # noqa: F401

from . import (convtasnet, dccrn, ffnn, manner, metricgan, sgmse,  # noqa: F401
               tfgridnet)

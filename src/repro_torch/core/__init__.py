"""Core of the port: the packed matrix, tree growth and boosting."""
from repro_torch.core.booster import Booster, BoosterConfig
from repro_torch.core.convert import booster_from_numpy
from repro_torch.core.dmatrix import DeviceDMatrix

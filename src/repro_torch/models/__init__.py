"""Assigned-architecture substrate of the port: dense / MoE / SSM / hybrid /
enc-dec backbones on one device, their partition specs as data, train,
prefill and decode paths; counterpart of `repro.models`."""
from repro_torch.models.api import Model, build_model, NO_SHARDING, ShardingRules
from repro_torch.models.config import ArchConfig, ShapeConfig, SHAPES
from repro_torch.models.convert import params_from_numpy, params_to_numpy

__all__ = ["Model", "build_model", "NO_SHARDING", "ShardingRules",
           "ArchConfig", "ShapeConfig", "SHAPES", "params_from_numpy", "params_to_numpy"]

from quickrank_tpu_torch.optimization.cleaver import PRUNING_METHODS, Cleaver
from quickrank_tpu_torch.optimization.factory import optimization_factory

__all__ = ["Cleaver", "PRUNING_METHODS", "optimization_factory"]

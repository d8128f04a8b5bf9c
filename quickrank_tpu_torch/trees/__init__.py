from quickrank_tpu_torch.trees.structs import EnsembleTensors

__all__ = ["EnsembleTensors"]

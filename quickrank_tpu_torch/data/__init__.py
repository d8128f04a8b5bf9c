from quickrank_tpu_torch.data.dataset import Dataset
from quickrank_tpu_torch.data.svml import read_svml, write_svml

__all__ = ["Dataset", "read_svml", "write_svml"]

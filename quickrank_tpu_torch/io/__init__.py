from quickrank_tpu_torch.io.xml_model import load_model, save_model

__all__ = ["load_model", "save_model"]

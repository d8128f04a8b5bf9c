from quickrank_tpu_torch.utils.profiling import phase_timer, trace

__all__ = ["phase_timer", "trace"]

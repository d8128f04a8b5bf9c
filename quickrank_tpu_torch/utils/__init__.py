from quickrank_tpu_torch.utils.profiling import phase_timer, span, trace

__all__ = ["phase_timer", "span", "trace"]

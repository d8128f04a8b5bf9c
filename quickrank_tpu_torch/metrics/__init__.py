from quickrank_tpu_torch.metrics.metrics import (  # noqa: F401
    Dcg,
    Map,
    Metric,
    Ndcg,
    Rmse,
    Tndcg,
    metric_factory,
)

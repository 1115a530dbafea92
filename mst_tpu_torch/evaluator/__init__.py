from mst_tpu_torch.evaluator.logs import (
    MetricsLogger,
    extract_epoch_curve,
    extract_test_metrics,
    extract_train_metrics,
)
from mst_tpu_torch.evaluator.metrics import min_ade_fde

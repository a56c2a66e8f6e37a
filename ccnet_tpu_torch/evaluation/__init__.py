from ccnet_tpu_torch.evaluation.evaluator import Evaluator
from ccnet_tpu_torch.evaluation.metrics import (
    ConfusionAccumulator,
    confusion_matrix,
    cross_process_sum,
    iou_from_confusion,
)
from ccnet_tpu_torch.evaluation.sliding import (
    compute_tiles,
    predict_multiscale,
    predict_sliding,
    predict_whole,
)

__all__ = [
    "ConfusionAccumulator",
    "confusion_matrix",
    "cross_process_sum",
    "iou_from_confusion",
    "compute_tiles",
    "predict_sliding",
    "predict_whole",
    "predict_multiscale",
    "Evaluator",
]

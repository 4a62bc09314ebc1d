from fraud_detection_tpu_torch.eval.metrics import (  # noqa: F401
    ClassificationReport,
    confusion_matrix,
    evaluate_classification,
    roc_auc,
)

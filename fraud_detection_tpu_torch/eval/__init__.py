from fraud_detection_tpu_torch.eval.metrics import (  # noqa: F401
    ClassificationReport,
    confusion_matrix,
    evaluate_classification,
    roc_auc,
)
from fraud_detection_tpu_torch.eval.word_associations import (  # noqa: F401
    SideVocabulary,
    WordAssociation,
    analyze_word_associations,
    model_feature_importances,
    tree_feature_importances,
)

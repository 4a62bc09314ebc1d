from fraud_detection_tpu_torch.data.loader import (  # noqa: F401
    REFERENCE_DATASET_URL,
    DialogueRow,
    as_xy,
    clean_rows,
    load_dialogue_csv,
)
from fraud_detection_tpu_torch.data.synthetic import (  # noqa: F401
    Dialogue,
    generate_corpus,
    train_val_test_split,
)

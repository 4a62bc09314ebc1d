from fraud_detection_tpu_torch.data.synthetic import (  # noqa: F401
    Dialogue,
    generate_corpus,
    train_val_test_split,
)

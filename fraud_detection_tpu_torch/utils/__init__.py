from fraud_detection_tpu_torch.utils.logging import configure, get_logger  # noqa: F401

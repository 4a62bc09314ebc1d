"""See the package docstring: twin of fraud_detection_tpu.checkpoint."""

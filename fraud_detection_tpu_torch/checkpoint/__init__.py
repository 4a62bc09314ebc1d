"""See the package docstring: twin of fraud_detection_tpu.checkpoint."""

from fraud_detection_tpu_torch.checkpoint.spark_artifact import (
    SparkPipelineArtifact,
    load_spark_pipeline,
)
from fraud_detection_tpu_torch.checkpoint.hf_convert import load_hf_checkpoint
from fraud_detection_tpu_torch.checkpoint.spark_writer import save_spark_pipeline
from fraud_detection_tpu_torch.checkpoint.train_state import (
    load_train_state,
    save_train_state,
)

__all__ = ["SparkPipelineArtifact", "load_spark_pipeline", "save_spark_pipeline",
           "load_train_state", "save_train_state", "load_hf_checkpoint"]

from fraud_detection_tpu_torch.stream.broker import (  # noqa: F401
    CommitFailedError,
    InProcessBroker,
    InProcessConsumer,
    InProcessProducer,
    Message,
)
from fraud_detection_tpu_torch.stream.engine import (  # noqa: F401
    StreamingClassifier,
    StreamStats,
)

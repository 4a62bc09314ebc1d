from fraud_detection_tpu_torch.stream.annotations import (  # noqa: F401
    AsyncAnnotationLane,
)
from fraud_detection_tpu_torch.stream.broker import (  # noqa: F401
    CommitFailedError,
    InProcessAssignedConsumer,
    InProcessBroker,
    InProcessConsumer,
    InProcessProducer,
    Message,
)
from fraud_detection_tpu_torch.stream.engine import (  # noqa: F401
    StreamingClassifier,
    StreamStats,
)
from fraud_detection_tpu_torch.stream.kafka import kafka_available  # noqa: F401

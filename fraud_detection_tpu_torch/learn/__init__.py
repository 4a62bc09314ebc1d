"""Closed-loop online learning beside the serving engine — twin of
``fraud_detection_tpu/learn/``: the label lane (stream/feedback.py records
joined against :class:`~fraud_detection_tpu_torch.learn.store.WindowStore`),
the warm-started boosted-tree refresh (models/train_trees.py
``refresh_gradient_boosting``, the tree kernels on the card), and the
:class:`~fraud_detection_tpu_torch.learn.loop.LearnLoop` lane that
publishes candidates into the registry lifecycle.
"""

from fraud_detection_tpu_torch.learn.loop import LearnConfig, LearnLoop
from fraud_detection_tpu_torch.learn.store import StoredRow, WindowStore

__all__ = ["LearnConfig", "LearnLoop", "StoredRow", "WindowStore"]

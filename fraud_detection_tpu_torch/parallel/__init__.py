from fraud_detection_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEATURE_AXIS,
    batch_sharding,
    feature_sharding,
    global_batch_from_local,
    initialize_distributed,
    make_hybrid_mesh,
    make_mesh,
    pad_to_multiple,
    replicated,
    shard_rows,
)

__all__ = [
    "DATA_AXIS", "FEATURE_AXIS", "batch_sharding", "feature_sharding",
    "make_mesh", "make_hybrid_mesh", "initialize_distributed",
    "global_batch_from_local", "pad_to_multiple", "replicated", "shard_rows",
]

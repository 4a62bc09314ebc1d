"""PyTorch/CUDA port of ``fraud_detection_tpu``'s serving path, tree
trainers and explanation LLM.

Raw UTF-8 dialogue bytes go through a hand-written CUDA byte-scan kernel
(tokenize + murmur3 hash + stop-word identity pack, ``ops/featurize_kernel``),
a torch count/pack pass, and logistic-regression or tree-ensemble scoring
(``models/``); ``stream/engine`` micro-batches broker messages through that
pipeline and commits offsets after delivery. ``app/train`` trains decision
trees, random forests and gradient boosting level by level over the CUDA
histogram and split-gain kernels (``ops/histogram``) and writes native
checkpoints the serving pipeline loads. ``models/llm`` is the explanation
decoder, whose long prefills run the CUDA causal flash-attention kernel
(``ops/attention``) and whose int8 weights run the CUDA W8A16 product
(``ops/int8_matmul``); ``checkpoint/hf_convert`` loads it from a Hugging
Face checkpoint directory; ``explain/`` wraps it (and HTTP or canned
backends) for the agent and for the engine's ``explain_batch_fn``. ``registry/`` and
``learn/`` are the model lifecycle around the engine: versioned models,
hot swap, shadow scoring, gated promotion, and a learn lane whose drift
refreshes (``models/train_trees.refresh_gradient_boosting``) run the tree
kernels on the card beside serving.

Module paths mirror the JAX package (``featurize/hashing.py`` here is the
twin of ``fraud_detection_tpu/featurize/hashing.py``). This package imports
``torch`` and never ``jax`` or ``fraud_detection_tpu``. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU every kernel
runs as its plain torch version.

Importing this package imports nothing heavy: import the submodules.
"""

__version__ = "0.1.0"

"""Build the port's featurizer and models from plain numpy arrays.

Every argument is what ``np.asarray`` gives for the JAX package's arrays
(its featurizer's ``idf``, its LogisticRegression / TreeEnsemble fields, its
language model's parameter dict), so a JAX ``ServingPipeline`` or
``LanguageModel`` carries across without this package importing JAX; any
other source of the same arrays works alike.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from fraud_detection_tpu_torch.featurize.text import StopWordFilter
from fraud_detection_tpu_torch.featurize.tfidf import HashingTfIdfFeaturizer
from fraud_detection_tpu_torch.models.linear import LogisticRegression
from fraud_detection_tpu_torch.models.llm import (_QUANT_REDUCE_AXES, Q8,
                                                  Transformer,
                                                  TransformerConfig)
from fraud_detection_tpu_torch.models.trees import TreeEnsemble
from fraud_detection_tpu_torch.utils.device import resolve_device


def featurizer_from_arrays(num_features: int, idf: Optional[np.ndarray],
                           binary_tf: bool = False,
                           stopwords: Optional[Sequence[str]] = None,
                           case_sensitive: bool = False,
                           remove_stopwords: bool = True,
                           legacy: bool = False) -> HashingTfIdfFeaturizer:
    """HashingTF(+IDF) featurizer; ``stopwords`` None = Spark's default
    English list."""
    return HashingTfIdfFeaturizer(
        num_features=int(num_features),
        idf=None if idf is None else np.asarray(idf, np.float32),
        binary_tf=bool(binary_tf),
        stop_filter=StopWordFilter(stopwords, case_sensitive),
        remove_stopwords=bool(remove_stopwords),
        legacy=bool(legacy))


def logistic_from_arrays(weights, intercept, threshold: float = 0.5,
                         device="cuda") -> LogisticRegression:
    return LogisticRegression.from_arrays(weights, intercept, threshold,
                                          device=device)


def trees_from_arrays(feature, threshold, left, right, leaf, tree_weights,
                      kind: str = "decision_tree", max_depth: int = 8,
                      bias: float = 0.0, device="cuda") -> TreeEnsemble:
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return TreeEnsemble(
        feature=t(feature, np.int32), threshold=t(threshold, np.float32),
        left=t(left, np.int32), right=t(right, np.int32),
        leaf=t(leaf, np.float32), tree_weights=t(tree_weights, np.float32),
        kind=str(kind), max_depth=int(max_depth), bias=float(bias))


def llm_params_from_arrays(cfg: TransformerConfig, params: Mapping[str, object],
                           device="cuda") -> Transformer:
    """The decoder's weights from a JAX-layout parameter dict (``embed``,
    ``lm_head`` when untied, ``l{l}.wq`` ..., ``ln_f``), name for name, cast
    to ``cfg.dtype`` on ``device``. A weight-only int8 leaf (the JAX
    package's ``Q8``) arrives as its ``(q, scale)`` pair of arrays and stays
    int8 with an f32 scale. Raises on a missing, extra or misshapen array."""
    dev = resolve_device(device)
    model = Transformer(cfg, device="meta")
    names = model.param_names()
    if sorted(params) != sorted(names):
        raise ValueError(f"parameter names differ: missing "
                         f"{sorted(set(names) - set(params))}, extra "
                         f"{sorted(set(params) - set(names))}")
    for name in names:
        want = tuple(model.param(name).shape)
        value = params[name]
        if isinstance(value, tuple):
            q, scale = (np.asarray(a) for a in value)
            axes = _QUANT_REDUCE_AXES.get(name.rsplit(".", 1)[-1], ())
            scale_shape = tuple(1 if i in axes else d
                                for i, d in enumerate(want))
            if q.shape != want or scale.shape != scale_shape:
                raise ValueError(f"{name}: q {q.shape} and scale "
                                 f"{scale.shape}, want {want} and "
                                 f"{scale_shape}")
            model.set_param(name, Q8(
                torch.from_numpy(q.astype(np.int8)).to(dev),
                torch.from_numpy(scale.astype(np.float32)).to(dev)))
            continue
        arr = np.array(value, dtype=np.float32)
        if tuple(arr.shape) != want:
            raise ValueError(f"{name}: shape {arr.shape}, want {want}")
        model.set_param(name, torch.from_numpy(arr).to(dev, cfg.dtype))
    return model

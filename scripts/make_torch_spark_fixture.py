#!/usr/bin/env python3
"""Write ``tests/data/torch_spark_fixture/``: a Spark ``PipelineModel``
directory in the layout of the reference's shipped serving artifact
(SURVEY.md §2.2), made with pyarrow, and the JAX package's labels and
probabilities on seeded texts beside it (``expected.json``).

    python scripts/make_torch_spark_fixture.py [--seed 17] [--out DIR]

Needs pyarrow and the JAX package (``fraud_detection_tpu``), so it runs
where the repository's CPU tests run, not on the GPU machine. The fixture
is what the PyTorch port's parquet reader is held against: bytes pyarrow
wrote, in Spark's column types.

The pipeline: Tokenizer -> StopWordsRemover (the English stop list inline in
``defaultParamMap``) -> HashingTF(10000) -> IDFModel (numDocs 1,150; docFreq
drawn from --seed, idf by Spark's formula) -> LogisticRegressionModel (a
sparse 1 x 10,000 coefficient matrix, stored as Spark compresses a row
matrix: CSR, ``isTransposed`` true, with 4,081 non-zeros N(0, 0.25) drawn
from --seed among the buckets with docFreq > 0; the intercept puts 30% of
the texts above the threshold). Columns carry Spark's types (``type`` int8,
``numRows``/``numCols`` int32, ``isTransposed`` boolean, non-null fields
required); parquet is written as Spark 3.5 writes it: format 1.0 with
dictionary pages (PLAIN_DICTIONARY), snappy, data page v1, ``list/element``
lists.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
SPARK_VERSION = "3.5.5"
FEATURES, NUM_DOCS, NNZ = 10_000, 1150, 4081
N_TEXTS = 256
FLAG_SHARE = 0.3
# a trained model's coefficient scale (margins of a few units, as the
# shipped artifact's intercept of -7.2 suggests), not unit normals
COEF_SCALE = 0.25


def uid(cls: str, seed: int) -> str:
    return f"{cls}_{hashlib.sha1(f'{cls}:{seed}'.encode()).hexdigest()[:12]}"


def write_stage(root: Path, idx: int, stage_uid: str, cls: str, params: dict,
                defaults: dict, table=None) -> None:
    import pyarrow.parquet as pq

    d = root / "stages" / f"{idx}_{stage_uid}"
    (d / "metadata").mkdir(parents=True)
    meta = {"class": cls, "timestamp": 1743734319540,
            "sparkVersion": SPARK_VERSION, "uid": stage_uid,
            "paramMap": params, "defaultParamMap": defaults}
    (d / "metadata" / "part-00000").write_text(json.dumps(meta) + "\n")
    (d / "metadata" / "_SUCCESS").write_text("")
    if table is not None:
        (d / "data").mkdir()
        pq.write_table(
            table, str(d / "data" /
                       f"part-00000-{stage_uid[-12:]}-c000.snappy.parquet"),
            compression="snappy", use_dictionary=True, version="1.0",
            data_page_version="1.0", use_compliant_nested_type=True)
        (d / "data" / "_SUCCESS").write_text("")


def vector_type():
    import pyarrow as pa

    return pa.struct([
        pa.field("type", pa.int8(), nullable=False),
        pa.field("size", pa.int32()),
        pa.field("indices", pa.list_(pa.field("element", pa.int32(),
                                              nullable=False))),
        pa.field("values", pa.list_(pa.field("element", pa.float64(),
                                             nullable=False)))])


def matrix_type():
    import pyarrow as pa

    ints = pa.list_(pa.field("element", pa.int32(), nullable=False))
    return pa.struct([
        pa.field("type", pa.int8(), nullable=False),
        pa.field("numRows", pa.int32(), nullable=False),
        pa.field("numCols", pa.int32(), nullable=False),
        pa.field("colPtrs", ints),
        pa.field("rowIndices", ints),
        pa.field("values", pa.list_(pa.field("element", pa.float64(),
                                             nullable=False))),
        pa.field("isTransposed", pa.bool_(), nullable=False)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=17)
    ap.add_argument("--out", default=str(ROOT / "tests" / "data" /
                                         "torch_spark_fixture"))
    args = ap.parse_args(argv)

    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(ROOT))
    import pyarrow as pa

    from fraud_detection_tpu.checkpoint import load_spark_pipeline
    from fraud_detection_tpu.data import generate_corpus
    from fraud_detection_tpu.featurize.tfidf import HashingTfIdfFeaturizer
    from fraud_detection_tpu.featurize.text import load_default_stopwords
    from fraud_detection_tpu.models.pipeline import ServingPipeline

    rng = np.random.default_rng(args.seed)
    doc_freq = np.where(rng.random(FEATURES) < 0.55,
                        np.minimum(rng.zipf(1.5, FEATURES), NUM_DOCS), 0)
    idf = np.log((NUM_DOCS + 1.0) / (doc_freq + 1.0))
    cols = np.sort(rng.choice(np.flatnonzero(doc_freq > 0), NNZ,
                              replace=False))
    values = rng.normal(0.0, COEF_SCALE, NNZ)
    weights = np.zeros(FEATURES)
    weights[cols] = values
    texts = [d.text for d in generate_corpus(n=N_TEXTS, seed=args.seed)]
    feat = HashingTfIdfFeaturizer(num_features=FEATURES,
                                  idf=idf.astype(np.float32))
    margins = np.asarray(feat.featurize_dense(texts)) @ weights
    intercept = -float(np.quantile(margins, 1.0 - FLAG_SHARE))

    out = Path(args.out)
    shutil.rmtree(out, ignore_errors=True)
    (out / "metadata").mkdir(parents=True)
    uids = [uid(c, args.seed) for c in ("Tokenizer", "StopWordsRemover",
                                        "HashingTF", "IDF",
                                        "LogisticRegression")]
    feature = "org.apache.spark.ml.feature."
    write_stage(out, 0, uids[0], feature + "Tokenizer",
                {"inputCol": "clean_text", "outputCol": "words"}, {})
    write_stage(out, 1, uids[1], feature + "StopWordsRemover",
                {"inputCol": "words", "outputCol": "filtered_words"},
                {"stopWords": load_default_stopwords(),
                 "caseSensitive": False, "locale": "en"})
    write_stage(out, 2, uids[2], feature + "HashingTF",
                {"inputCol": "filtered_words", "outputCol": "raw_features",
                 "numFeatures": FEATURES},
                {"binary": False, "numFeatures": 262144})
    idf_table = pa.Table.from_pylist([{
        "idf": {"type": 1, "size": None, "indices": None,
                "values": idf.tolist()},
        "docFreq": doc_freq.tolist(), "numDocs": NUM_DOCS}],
        schema=pa.schema([
            pa.field("idf", vector_type()),
            pa.field("docFreq", pa.list_(pa.field("element", pa.int64(),
                                                  nullable=False))),
            pa.field("numDocs", pa.int64(), nullable=False)]))
    write_stage(out, 3, uids[3], feature + "IDFModel",
                {"inputCol": "raw_features", "outputCol": "features"},
                {"minDocFreq": 0}, idf_table)
    lr_table = pa.Table.from_pylist([{
        "numClasses": 2, "numFeatures": FEATURES,
        "interceptVector": {"type": 1, "size": None, "indices": None,
                            "values": [intercept]},
        "coefficientMatrix": {"type": 0, "numRows": 1, "numCols": FEATURES,
                              "colPtrs": [0, NNZ],
                              "rowIndices": cols.tolist(),
                              "values": values.tolist(),
                              "isTransposed": True},
        "isMultinomial": False}],
        schema=pa.schema([
            pa.field("numClasses", pa.int32(), nullable=False),
            pa.field("numFeatures", pa.int32(), nullable=False),
            pa.field("interceptVector", vector_type()),
            pa.field("coefficientMatrix", matrix_type()),
            pa.field("isMultinomial", pa.bool_(), nullable=False)]))
    write_stage(out, 4, uids[4],
                "org.apache.spark.ml.classification.LogisticRegressionModel",
                {"featuresCol": "features", "labelCol": "label_index"},
                {"threshold": 0.5, "regParam": 0.0, "maxIter": 100,
                 "standardization": True, "family": "auto"}, lr_table)
    (out / "metadata" / "part-00000").write_text(json.dumps({
        "class": "org.apache.spark.ml.PipelineModel",
        "timestamp": 1743734319540, "sparkVersion": SPARK_VERSION,
        "uid": uid("PipelineModel", args.seed),
        "paramMap": {"stageUids": uids}, "defaultParamMap": {}}) + "\n")

    pipe = ServingPipeline.from_spark_artifact(load_spark_pipeline(str(out)),
                                               batch_size=64)
    got = pipe.predict(texts)
    (out / "expected.json").write_text(json.dumps({
        "corpus": {"n": N_TEXTS, "seed": args.seed},
        "intercept": intercept,
        "labels": got.labels.tolist(),
        "probabilities": got.probabilities.tolist()}) + "\n")
    size = sum(f.stat().st_size for f in out.rglob("*") if f.is_file())
    print(f"wrote {out}: {size} bytes, {int(got.labels.sum())} of "
          f"{len(texts)} texts flagged")
    return 0


if __name__ == "__main__":
    sys.exit(main())

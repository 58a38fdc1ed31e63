"""DataFrame ↔ TFRecord conversion utilities.

Copied from the JAX package's ``dfutil.py`` (it is jax-free) with the package
name rewritten. Capability-parity with the reference's dfutil.py — but where
the reference shelled DataFrames through the tensorflow-hadoop jar
(dfutil.py:39-41,63-65) and TF's Example class, this uses the framework's own
TFRecord codec (:mod:`tensorflowonspark_tpu_torch.tfrecord`), so it works on the
local backend (shards on a shared filesystem) and on pyspark alike.

Matching the reference surface: ``saveAsTFRecords`` / ``loadTFRecords`` /
``toTFExample`` / ``fromTFExample`` / ``infer_schema`` / ``isLoadedDF``
(loaded-DF provenance, reference dfutil.py:15-26).
"""

import logging
import os
import weakref

from tensorflowonspark_tpu_torch import tfrecord

logger = logging.getLogger(__name__)

#: provenance registry: DataFrames produced by loadTFRecords (reference
#: dfutil.py:15-26). Weak values so entries die with their DataFrame — id()
#: reuse after GC can't produce false positives.
loadedDF = weakref.WeakValueDictionary()
_loaded_dirs = {}


def isLoadedDF(df):
    return loadedDF.get(id(df)) is df


def loadedDFSource(df):
    """Input directory a loaded DataFrame came from, or None — the provenance
    lookup the reference's pipeline used to reuse already-converted TFRecords
    (reference pipeline.py tfrecord_dir reuse)."""
    return _loaded_dirs.get(id(df)) if isLoadedDF(df) else None


def toTFExample(row, columns, binary_features=()):
    """One row (sequence) → feature dict ready for Example encoding.

    dtype mapping mirrors the reference's table (dfutil.py:84-131): ints →
    Int64List, floats → FloatList, strings/bytes → BytesList; list columns map
    to multi-valued features; columns named in ``binary_features`` are written
    as raw bytes.
    """
    features = {}
    for name, value in zip(columns, row):
        if value is None:
            continue
        if name in binary_features:
            features[name] = [bytes(value) if not isinstance(value, bytes) else value]
            continue
        if isinstance(value, (list, tuple)):
            vals = list(value)
        else:
            vals = [value]
        if vals and isinstance(vals[0], float):
            vals = [float(v) for v in vals]
        features[name] = vals
    return features


def fromTFExample(example, columns=None, binary_features=()):
    """Decoded example dict → row tuple in ``columns`` order
    (reference dfutil.py:171-211)."""
    decoded = {}
    for name, (kind, values) in example.items():
        if kind == "bytes":
            if name in binary_features:
                decoded[name] = values[0] if len(values) == 1 else values
            else:
                strings = [v.decode("utf-8", "replace") for v in values]
                decoded[name] = strings[0] if len(strings) == 1 else strings
        else:
            decoded[name] = values[0] if len(values) == 1 else values
    if columns is None:
        columns = sorted(decoded)
    return tuple(decoded.get(c) for c in columns)


def infer_schema(example, binary_features=()):
    """Column names + kinds from a decoded example
    (reference dfutil.py:134-168 inferred Spark types the same way)."""
    schema = {}
    for name, (kind, values) in sorted(example.items()):
        multi = len(values) > 1
        if kind == "bytes" and name not in binary_features:
            kind = "string"
        schema[name] = {"kind": kind, "multi": multi}
    return schema


def saveAsTFRecords(df, output_dir, binary_features=()):
    """Write a DataFrame as TFRecord shards, one per partition
    (reference dfutil.py:29-41)."""
    columns = list(df.columns)
    if not tfrecord.is_uri(output_dir):
        output_dir = os.path.abspath(os.path.expanduser(output_dir))
    tfrecord.makedirs(output_dir)
    bin_feats = tuple(binary_features)

    def _write_partition(pidx, it):
        import uuid as _uuid

        examples = [toTFExample(row, columns, bin_feats) for row in it]
        if not examples:
            return []
        # commit protocol standing in for the Hadoop output committer: write
        # to a temp name, then rename onto the deterministic per-partition
        # name — task retries/speculative duplicates overwrite instead of
        # duplicating records (atomic locally; on object stores the rename is
        # delete+copy, so duplicates overwrite but the final shard may be
        # transiently absent — see tfrecord.rename)
        final = "{}/part-r-{:05d}".format(output_dir.rstrip("/"), pidx)
        tmp = final + "." + _uuid.uuid4().hex[:8] + ".tmp"
        n = tfrecord.write_shard(tmp, examples)
        tfrecord.rename(tmp, final)
        return [n]

    rdd = df.rdd
    counts = rdd.mapPartitionsWithIndex(_write_partition).collect()
    logger.info("wrote %d records in %d shards to %s", sum(counts), len(counts), output_dir)
    return output_dir


def loadTFRecords(sc, input_dir, binary_features=(), columns=None):
    """Read TFRecord shards back into a DataFrame (reference dfutil.py:44-81):
    schema inferred from the first record, provenance recorded in
    ``loadedDF``."""
    if not tfrecord.is_uri(input_dir):
        input_dir = os.path.abspath(os.path.expanduser(input_dir))
    shards = tfrecord.list_shards(input_dir)
    if not shards:
        raise FileNotFoundError("no TFRecord shards under {}".format(input_dir))
    bin_feats = tuple(binary_features)

    if columns is None:
        # union the schema over the whole first shard plus the first record of
        # every other shard: a None value makes toTFExample omit that column
        # from a record, so no single record (or single shard) is a reliable
        # schema witness
        names = set()
        for example in tfrecord.read_examples(shards[0]):
            names.update(infer_schema(example, bin_feats))
        for path in shards[1:]:
            try:
                names.update(infer_schema(next(tfrecord.read_examples(path)), bin_feats))
            except StopIteration:
                pass
        columns = sorted(names)

    def _read_shard(it):
        rows = []
        for path in it:
            for example in tfrecord.read_examples(path):
                rows.append(fromTFExample(example, columns, bin_feats))
        return rows

    rdd = sc.parallelize(shards, len(shards)).mapPartitions(_read_shard)
    if hasattr(sc, "createDataFrame"):  # local backend: wrap the lazy RDD
        from tensorflowonspark_tpu_torch.backends.local import LocalDataFrame

        df = LocalDataFrame(rdd, columns)
    else:  # pyspark SparkContext: go through the session
        from pyspark.sql import SparkSession

        df = SparkSession.builder.getOrCreate().createDataFrame(rdd, columns)
    loadedDF[id(df)] = df
    _loaded_dirs[id(df)] = input_dir
    weakref.finalize(df, _loaded_dirs.pop, id(df), None)
    logger.info("loaded %d shards from %s as columns %s", len(shards), input_dir, columns)
    return df

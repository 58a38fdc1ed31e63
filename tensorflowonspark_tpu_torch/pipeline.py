"""ML-pipeline layer: Estimator/Model wrappers over the cluster runtime — the
port of the JAX package's ``pipeline.py``.

Capability-parity with the reference's pipeline.py: the same
``Has*`` param-mixin surface (pipeline.py:49-293), the ``Namespace``
args adapter (pipeline.py:296-336), ``merge_args_params`` (pipeline.py:343),
``TFEstimator._fit`` spinning up a cluster over the input DataFrame
(pipeline.py:392-432), and ``TFModel._transform`` running single-process
batch inference per executor with input/output column↔tensor mappings and a
per-worker model cache (pipeline.py:435-644).

Differences from the reference: the trained artifact is a **model bundle**
(:mod:`tensorflowonspark_tpu_torch.train.export`: host weights + pickled
predict-fn builder) rather than a TF SavedModel; ``protocol`` keeps the JAX
package's ICI/DCN names rather than grpc/RDMA (``dcn`` turns the
torch.distributed world on); the ``jax_distributed`` keyword keeps its name
and selects the torch.distributed world, as ``TFCluster.run``'s does. The
platform rides the env lane (``env={"TOS_PLATFORM": "cpu"}``; the card by
default) to the training cluster and, through the :class:`TFModel` that
``fit`` returns, to the executors that run ``transform``.

When pyspark is installed, :class:`TFEstimator`/:class:`TFModel` subclass
``pyspark.ml.Estimator``/``pyspark.ml.Model`` (the reference subclassed them
too, pipeline.py:349,433), so they pass ``pyspark.ml.Pipeline``'s isinstance
checks and sit in real ML pipelines. Without pyspark the bases degrade to
``object`` and everything runs against the local backend's ``LocalDataFrame``.
"""

import argparse
import logging

logger = logging.getLogger(__name__)

try:  # real pyspark.ml citizenship when pyspark is importable
    from pyspark.ml import Estimator as _MLEstimatorBase
    from pyspark.ml import Model as _MLModelBase
except Exception:  # local backend: no pyspark dependency

    class _MLEstimatorBase:
        pass

    class _MLModelBase:
        pass


# -- param plumbing (pyspark.ml.param.Param equivalent) ------------------------


def _nullable_str(value):
    """str converter that keeps None as None: str(None) == "None" would turn
    e.g. setMasterNode(None) into a bogus 'None' cluster role, and
    setModelDir(None) into a directory literally named None."""
    return None if value is None else str(value)


class Param:
    def __init__(self, name, doc, converter=None):
        self.name = name
        self.doc = doc
        self.converter = converter

    def __repr__(self):
        return "Param({})".format(self.name)


class Params:
    """Minimal pyspark.ml.param.Params: typed params with defaults + setters.

    When the pyspark bases are live, their ``Params``/``Identifiable`` chain
    runs first (sets ``uid`` and pyspark's own empty maps) and then this
    class installs its string-keyed maps; the accessors defined here shadow
    pyspark's Param-object-keyed machinery throughout (``_param_index`` is
    deliberately not named ``_params`` — pyspark's ``Params.__init__`` sets
    an instance attribute of that name which would shadow a method).
    """

    def __init__(self):
        super().__init__()
        self._paramMap = {}
        self._defaultParamMap = {}

    def _param_index(self):
        out = {}
        for klass in type(self).__mro__:
            for name, val in vars(klass).items():
                if isinstance(val, Param):
                    out[val.name] = val
        return out

    def _set(self, **kwargs):
        params = self._param_index()
        for name, value in kwargs.items():
            if name not in params:
                raise ValueError("unknown param {!r}".format(name))
            p = params[name]
            self._paramMap[p.name] = p.converter(value) if p.converter else value
        return self

    def _setDefault(self, **kwargs):
        for name, value in kwargs.items():
            self._defaultParamMap[name] = value
        return self

    def getOrDefault(self, param):
        name = param.name if isinstance(param, Param) else param
        if name in self._paramMap:
            return self._paramMap[name]
        return self._defaultParamMap.get(name)

    def isDefined(self, param):
        name = param.name if isinstance(param, Param) else param
        return name in self._paramMap or name in self._defaultParamMap

    def extractParamMap(self, extra=None):
        """Defaults overlaid with explicit settings, then ``extra``.

        ``extra`` accepts pyspark's dict-of-Param (or string) keys —
        ``Pipeline.copy()`` / ML persistence call
        ``extractParamMap(extra)``, so refusing the argument would
        TypeError inside pyspark internals."""
        out = dict(self._defaultParamMap)
        out.update(self._paramMap)
        if extra:
            for k, v in extra.items():
                out[k.name if isinstance(k, Param) else k] = v
        return out

    def copyParamsTo(self, other):
        other._paramMap.update(self._paramMap)
        other._defaultParamMap.update(self._defaultParamMap)
        return other


def _toDict(value):
    """reference TFTypeConverters.toDict (pipeline.py:39-46)."""
    if not isinstance(value, dict):
        raise TypeError("expected a dict, got {!r}".format(type(value)))
    return value


# -- Has* mixins: the reference's 17 (pipeline.py:49-293) ----------------------


class HasBatchSize(Params):
    batch_size = Param("batch_size", "number of records per batch", int)

    def __init__(self):
        super().__init__()
        self._setDefault(batch_size=100)

    def setBatchSize(self, value):
        return self._set(batch_size=value)

    def getBatchSize(self):
        return self.getOrDefault("batch_size")


class HasClusterSize(Params):
    cluster_size = Param("cluster_size", "number of nodes in the cluster", int)

    def __init__(self):
        super().__init__()
        self._setDefault(cluster_size=1)

    def setClusterSize(self, value):
        return self._set(cluster_size=value)

    def getClusterSize(self):
        return self.getOrDefault("cluster_size")


class HasEpochs(Params):
    epochs = Param("epochs", "number of epochs to train", int)

    def __init__(self):
        super().__init__()
        self._setDefault(epochs=1)

    def setEpochs(self, value):
        return self._set(epochs=value)

    def getEpochs(self):
        return self.getOrDefault("epochs")


class HasGraceSecs(Params):
    grace_secs = Param("grace_secs", "seconds to wait after feeding (for final export)", int)

    def __init__(self):
        super().__init__()
        self._setDefault(grace_secs=30)

    def setGraceSecs(self, value):
        return self._set(grace_secs=value)

    def getGraceSecs(self):
        return self.getOrDefault("grace_secs")


class HasInputMapping(Params):
    input_mapping = Param("input_mapping", "mapping of input DataFrame column to input tensor", _toDict)

    def __init__(self):
        super().__init__()

    def setInputMapping(self, value):
        return self._set(input_mapping=value)

    def getInputMapping(self):
        return self.getOrDefault("input_mapping")


class HasInputMode(Params):
    input_mode = Param("input_mode", "input data feeding mode (InputMode.SPARK only here)", int)

    def __init__(self):
        super().__init__()
        from tensorflowonspark_tpu_torch.TFCluster import InputMode

        self._setDefault(input_mode=InputMode.SPARK)

    def setInputMode(self, value):
        from tensorflowonspark_tpu_torch.TFCluster import InputMode

        if value != InputMode.SPARK:
            # the reference rejects TENSORFLOW mode in pipelines too
            # (pipeline.py:121-124)
            raise ValueError("TFEstimator only supports InputMode.SPARK")
        return self._set(input_mode=value)

    def getInputMode(self):
        return self.getOrDefault("input_mode")


class HasMasterNode(Params):
    master_node = Param("master_node", "job name of the master/chief node", _nullable_str)

    def __init__(self):
        super().__init__()
        self._setDefault(master_node="chief")

    def setMasterNode(self, value):
        return self._set(master_node=value)

    def getMasterNode(self):
        return self.getOrDefault("master_node")


class HasModelDir(Params):
    model_dir = Param("model_dir", "directory to write checkpoints", _nullable_str)

    def __init__(self):
        super().__init__()

    def setModelDir(self, value):
        return self._set(model_dir=value)

    def getModelDir(self):
        return self.getOrDefault("model_dir")


class HasNumPS(Params):
    num_ps = Param("num_ps", "number of ps nodes (API compat; no parameter servers here)", int)
    driver_ps_nodes = Param("driver_ps_nodes", "run ps nodes on driver (unsupported)", bool)

    def __init__(self):
        super().__init__()
        self._setDefault(num_ps=0, driver_ps_nodes=False)

    def setNumPS(self, value):
        return self._set(num_ps=value)

    def getNumPS(self):
        return self.getOrDefault("num_ps")

    def setDriverPSNodes(self, value):
        return self._set(driver_ps_nodes=value)

    def getDriverPSNodes(self):
        return self.getOrDefault("driver_ps_nodes")


class HasOutputMapping(Params):
    output_mapping = Param("output_mapping", "mapping of output tensor to output DataFrame column", _toDict)

    def __init__(self):
        super().__init__()

    def setOutputMapping(self, value):
        return self._set(output_mapping=value)

    def getOutputMapping(self):
        return self.getOrDefault("output_mapping")


class HasProtocol(Params):
    protocol = Param(
        "protocol",
        "fabric selection: 'ici' (single slice; default) | 'dcn' (cross-host/"
        "slice: forces the torch.distributed world on). Reference: grpc/rdma",
        str,
    )

    def __init__(self):
        super().__init__()
        self._setDefault(protocol="ici")

    def setProtocol(self, value):
        return self._set(protocol=value)

    def getProtocol(self):
        return self.getOrDefault("protocol")


class HasReaders(Params):
    readers = Param(
        "readers",
        "input-pipeline reader/parse threads per node (lands in the trainer "
        "children as TOS_DATA_THREADS, the data.ImagePipeline default)",
        int,
    )

    def __init__(self):
        super().__init__()
        self._setDefault(readers=1)

    def setReaders(self, value):
        return self._set(readers=value)

    def getReaders(self):
        return self.getOrDefault("readers")


class HasSteps(Params):
    steps = Param("steps", "maximum number of steps to train", int)

    def __init__(self):
        super().__init__()
        self._setDefault(steps=1000)

    def setSteps(self, value):
        return self._set(steps=value)

    def getSteps(self):
        return self.getOrDefault("steps")


class HasTensorboard(Params):
    tensorboard = Param("tensorboard", "launch tensorboard/profiler on chief", bool)

    def __init__(self):
        super().__init__()
        self._setDefault(tensorboard=False)

    def setTensorboard(self, value):
        return self._set(tensorboard=value)

    def getTensorboard(self):
        return self.getOrDefault("tensorboard")


class HasTFRecordDir(Params):
    tfrecord_dir = Param("tfrecord_dir", "directory of TFRecords to use as input", _nullable_str)

    def __init__(self):
        super().__init__()

    def setTFRecordDir(self, value):
        return self._set(tfrecord_dir=value)

    def getTFRecordDir(self):
        return self.getOrDefault("tfrecord_dir")


class HasExportDir(Params):
    export_dir = Param("export_dir", "directory to export the trained model bundle", _nullable_str)

    def __init__(self):
        super().__init__()

    def setExportDir(self, value):
        return self._set(export_dir=value)

    def getExportDir(self):
        return self.getOrDefault("export_dir")


class HasSignatureDefKey(Params):
    signature_def_key = Param("signature_def_key", "bundle signature to use (API compat)", _nullable_str)

    def __init__(self):
        super().__init__()
        self._setDefault(signature_def_key="serving_default")

    def setSignatureDefKey(self, value):
        return self._set(signature_def_key=value)

    def getSignatureDefKey(self):
        return self.getOrDefault("signature_def_key")


class HasTagSet(Params):
    tag_set = Param("tag_set", "bundle tag set (API compat)", _nullable_str)

    def __init__(self):
        super().__init__()
        self._setDefault(tag_set="serve")

    def setTagSet(self, value):
        return self._set(tag_set=value)

    def getTagSet(self):
        return self.getOrDefault("tag_set")


class Namespace(object):
    """argparse.Namespace-alike accepting dict / Namespace / argv list
    (reference pipeline.py:296-336)."""

    def __init__(self, d=None):
        if d is None:
            return
        if isinstance(d, dict):
            self.__dict__.update(d)
        elif isinstance(d, argparse.Namespace) or isinstance(d, Namespace):
            self.__dict__.update(vars(d))
        elif isinstance(d, (list, tuple)):
            self.argv = list(d)
        else:
            raise TypeError("unsupported Namespace source: {!r}".format(type(d)))

    def __contains__(self, item):
        return item in self.__dict__

    def __iter__(self):
        return iter(self.__dict__)

    def __repr__(self):
        return "Namespace({})".format(self.__dict__)


class TFParams(Params):
    """Base for estimator/model: merges argparse-style args with ML params
    (params win — reference pipeline.py:339-348)."""

    args = None

    def merge_args_params(self):
        args = Namespace(vars(self.args) if self.args is not None else {})
        for name, value in self.extractParamMap().items():
            setattr(args, name, value)
        return args


class TFEstimator(TFParams, HasBatchSize, HasClusterSize, HasEpochs, HasGraceSecs,
                  HasInputMapping, HasInputMode, HasMasterNode, HasModelDir, HasNumPS,
                  HasProtocol, HasReaders, HasSteps, HasTensorboard, HasTFRecordDir,
                  HasExportDir, _MLEstimatorBase):
    """Spark-ML Estimator (a real ``pyspark.ml.Estimator`` subclass when
    pyspark is installed): ``fit(df)`` trains ``train_fn`` on a cluster
    fed from the DataFrame and returns a :class:`TFModel`
    (reference pipeline.py:351-432).

    ``train_fn(args, ctx)`` is the user's ``main_fun``; it should honor
    ``args.batch_size`` / ``args.steps`` / ``args.export_dir`` and export a
    model bundle (``tensorflowonspark_tpu_torch.train.export.export_model``) on the
    chief when feeding ends.
    """

    def __init__(self, train_fn, tf_args=None, export_fn=None, env=None, jax_distributed=None,
                 obs=None):
        """``env``/``jax_distributed``/``obs`` forward to ``TFCluster.run``
        (e.g. ``env={"TOS_PLATFORM": "cpu"}`` for CPU clusters; ``obs=False``
        turns the observability plane off for this estimator's clusters)."""
        # cooperative super: every Has* mixin sets its defaults, Params (the
        # MRO root before object) creates the maps first
        super().__init__()
        self.train_fn = train_fn
        self.export_fn = export_fn
        self.env = env
        self.jax_distributed = jax_distributed
        self.obs = obs
        #: merged cluster metrics snapshot captured at the end of the last
        #: ``fit`` (before shutdown); None until a fit completes
        self.cluster_metrics_ = None
        self.args = Namespace(tf_args) if tf_args is not None else Namespace({})

    def fit(self, dataset, params=None):
        # pyspark's Estimator.fit(params=dict) copies the stage; here extra
        # params are applied in place (this estimator's maps are string-keyed)
        if isinstance(params, (list, tuple)):
            # pyspark's list-of-param-maps form (CrossValidator et al.) wants
            # one trained model per map — each map here is a full cluster
            # run; refuse clearly rather than AttributeError on .items()
            raise NotImplementedError(
                "TFEstimator.fit does not support a list of param maps; fit "
                "once per configuration (each fit is a full cluster run)"
            )
        if params:
            # pyspark fits a COPY carrying the extra params; match that
            # observable contract by restoring the pre-call map afterwards
            # instead of letting call-scoped params stick to the stage
            saved = dict(self._paramMap)
            self._set(**{(k.name if isinstance(k, Param) else k): v
                         for k, v in params.items()})
            try:
                return self._fit(dataset)
            finally:
                self._paramMap = saved
        return self._fit(dataset)

    def _fit(self, dataset):
        from tensorflowonspark_tpu_torch import TFCluster

        args = self.merge_args_params()
        logger.info("TFEstimator.fit: cluster_size=%s epochs=%s batch_size=%s",
                    args.cluster_size, args.epochs, args.batch_size)

        input_cols = sorted(args.input_mapping)
        rdd = dataset.rdd
        sc = getattr(rdd, "_sc", None)  # local backend
        if sc is None:
            sc = rdd.context  # real pyspark

        tfrecord_dir = getattr(args, "tfrecord_dir", None)
        if tfrecord_dir:
            # materialize the input DataFrame as TFRecord shards
            # (reference dfutil flow), provenance-aware: a DataFrame that was
            # LOADED from this very directory is not re-written (reference
            # loadedDF registry, dfutil.py:15-26). The feed then reads the
            # materialized shards, so the source DataFrame is evaluated at
            # most once per fit.
            import os as _os

            from tensorflowonspark_tpu_torch import dfutil, tfrecord

            if not tfrecord.is_uri(tfrecord_dir):  # match loadTFRecords' form
                tfrecord_dir = _os.path.abspath(_os.path.expanduser(tfrecord_dir))
            if dfutil.isLoadedDF(dataset) and dfutil.loadedDFSource(dataset) == tfrecord_dir:
                logger.info("input DataFrame already lives at %s; reusing", tfrecord_dir)
            else:
                dfutil.saveAsTFRecords(dataset, tfrecord_dir)
            # feed from the shards, not the source DataFrame: no second
            # evaluation of an expensive input
            dataset = dfutil.loadTFRecords(sc, tfrecord_dir, columns=list(dataset.columns))

        env = dict(self.env or {})
        if getattr(args, "readers", 0):
            # `readers` → input-pipeline thread count in the trainer children
            # (tensorflowonspark_tpu_torch.data.ImagePipeline default; reference
            # HasReaders controlled the enqueue-thread count)
            env.setdefault("TOS_DATA_THREADS", str(args.readers))
        jax_distributed = self.jax_distributed
        if jax_distributed is None and getattr(args, "protocol", "ici") == "dcn":
            # 'dcn' = the cluster spans hosts/slices: the cross-process
            # torch.distributed world is mandatory (reference: protocol chose
            # the grpc vs grpc+verbs transport, TFNode.py:126-129)
            jax_distributed = True
        cluster = TFCluster.run(
            sc, self.train_fn, args, args.cluster_size, num_ps=args.num_ps,
            tensorboard=args.tensorboard, input_mode=TFCluster.InputMode.SPARK,
            master_node=args.master_node, driver_ps_nodes=args.driver_ps_nodes,
            env=env or None, jax_distributed=jax_distributed, obs=self.obs,
        )
        try:
            cluster.train(dataset.select(input_cols).rdd, args.epochs)
            try:
                # capture while node channels are still up — after shutdown the
                # executor managers (and their published snapshots) are gone
                self.cluster_metrics_ = cluster.metrics()
            except Exception as e:
                logger.debug("could not capture cluster metrics: %s", e)
        finally:
            # also after a failed feed: a node error must not leave the
            # nodes and the reservation server running (shutdown raises it)
            cluster.shutdown(grace_secs=args.grace_secs)

        model = TFModel(self.args, env=self.env)
        self.copyParamsTo(model)
        return model


class TFModel(TFParams, HasBatchSize, HasInputMapping, HasOutputMapping, HasModelDir,
              HasExportDir, HasSignatureDefKey, HasTagSet, _MLModelBase):
    """Spark-ML Model (a real ``pyspark.ml.Model``/``Transformer`` subclass
    when pyspark is installed): ``transform(df)`` runs batch inference from
    the exported bundle in each executor's python worker, no cluster needed
    (reference pipeline.py:435-644).

    ``env`` is the estimator's env lane (:class:`TFEstimator` hands its own
    on): with ``{"TOS_PLATFORM": "cpu"}`` the executors load the bundle on
    the CPU, otherwise on the card."""

    def __init__(self, tf_args=None, env=None):
        super().__init__()
        self.args = Namespace(tf_args) if tf_args is not None else Namespace({})
        self.env = env

    def transform(self, dataset, params=None):
        if params:
            # call-scoped extra params, same restore contract as fit()
            saved = dict(self._paramMap)
            self._set(**{(k.name if isinstance(k, Param) else k): v
                         for k, v in params.items()})
            try:
                return self._transform(dataset)
            finally:
                self._paramMap = saved
        return self._transform(dataset)

    def _transform(self, dataset):
        from tensorflowonspark_tpu_torch import util

        args = self.merge_args_params()
        logger.info("TFModel.transform: batch_size=%s export_dir=%s",
                    args.batch_size, getattr(args, "export_dir", None))
        input_cols = sorted(args.input_mapping)
        tensor_names = [args.input_mapping[c] for c in input_cols]
        output_items = sorted((args.output_mapping or {"output": "prediction"}).items())
        output_tensors = [t for t, _ in output_items]
        output_cols = [c for _, c in output_items]
        task = _RunModel(
            export_dir=getattr(args, "export_dir", None) or getattr(args, "model_dir", None),
            batch_size=args.batch_size,
            tensor_names=tensor_names,
            output_tensors=output_tensors,
            platform=(self.env or {}).get(util.ENV_PLATFORM, "gpu"),
        )
        rows = dataset.select(input_cols).rdd.mapPartitions(task)
        return _build_dataframe(dataset, rows, output_cols)


def _build_dataframe(source_df, rows, output_cols):
    rdd = rows
    # local backend: wrap back into a LocalDataFrame; pyspark: createDataFrame
    sc = getattr(rdd, "_sc", None)
    if sc is not None and hasattr(sc, "createDataFrame"):
        from tensorflowonspark_tpu_torch.backends.local import LocalDataFrame

        return LocalDataFrame(rdd, output_cols)
    # df.sparkSession is the Spark>=3.3 surface; sql_ctx was removed in
    # Spark 4 (kept as the fallback for older pyspark)
    spark = getattr(source_df, "sparkSession", None) or getattr(source_df, "sql_ctx", None)
    if spark is not None:
        return spark.createDataFrame(rdd, output_cols)
    return rdd


#: per-worker-process model cache (reference pred_fn/global_args cache,
#: pipeline.py:492-496): transform tasks landing on the same executor reuse
#: the loaded bundle instead of re-reading it per partition
_model_cache = {}


class _RunModel:
    """mapPartitions closure: batches rows → predict_fn → output rows
    (reference _run_model_tf2, pipeline.py:585-644).

    The predict runs in the executor process itself, on ``platform``
    (``"gpu"``: the card, through the bundle's builder; ``"cpu"``). The
    executors of both backends are spawned processes (the local backend's
    start with multiprocessing ``spawn``), so each sets up its own CUDA
    context here even when the driver process already holds one; an
    executor must not be forked from a process with CUDA up."""

    def __init__(self, export_dir, batch_size, tensor_names, output_tensors, platform="gpu"):
        if not export_dir:
            raise ValueError("TFModel needs export_dir (or model_dir) pointing at a model bundle")
        self.export_dir = export_dir
        self.batch_size = batch_size
        self.tensor_names = tensor_names
        self.output_tensors = output_tensors
        self.platform = platform

    def __call__(self, iterator):
        import numpy as np

        key = (self.export_dir, self.platform)
        bundle = _model_cache.get(key)
        if bundle is None:
            from tensorflowonspark_tpu_torch.train import export as export_lib

            device = "cpu" if self.platform == "cpu" else None  # None: the card
            bundle = export_lib.load_model(self.export_dir, device=device)
            _model_cache[key] = bundle
        predict_fn, params, model_state = bundle

        results = []
        for batch in yield_batch(iterator, self.batch_size):
            n = len(batch)
            cols = list(zip(*batch))
            arrays = {
                name: np.asarray(col) for name, col in zip(self.tensor_names, cols)
            }
            # pad the final partial batch so the predict sees one shape, then
            # truncate
            if n < self.batch_size:
                arrays = {
                    k: np.concatenate([v, np.repeat(v[-1:], self.batch_size - n, axis=0)])
                    for k, v in arrays.items()
                }
            out = predict_fn(params, model_state, arrays)
            if not isinstance(out, dict):
                out = {self.output_tensors[0]: out}
            out_cols = [np.asarray(out[t])[:n] for t in self.output_tensors]
            for row in zip(*[c.tolist() for c in out_cols]):
                results.append(tuple(row))
        return results


def yield_batch(iterator, batch_size):
    """Group an iterator of rows into lists of ≤ batch_size
    (reference pipeline.py:688-710)."""
    batch = []
    for row in iterator:
        batch.append(row)
        if len(batch) >= batch_size:
            yield batch
            batch = []
    if batch:
        yield batch

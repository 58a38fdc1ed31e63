"""TFEstimator/TFModel pyspark.ml citizenship, provable WITHOUT pyspark.

`tensorflowonspark_tpu_torch.pipeline` subclasses ``pyspark.ml.Estimator/Model``
when pyspark imports (the reference subclassed them too, pipeline.py:349,433).
This image has no pyspark, so these tests run the import in a SUBPROCESS with
a stub ``pyspark.ml`` package that reproduces the real bases' load-bearing
behavior (pyspark 3.x ``ml/param/__init__.py`` + ``ml/base.py``):

* ``Params.__init__`` sets an INSTANCE attribute ``self._params = None``
  (which would shadow a method of that name — why ours is ``_param_index``),
  and ``_copy_params()`` scans ``dir(cls)`` for pyspark ``Param`` descriptors;
* ``Identifiable.__init__`` sets ``self.uid``;
* ``Estimator``/``Transformer`` are ABCs with abstract ``_fit``/``_transform``
  and concrete ``fit``/``transform`` wrappers;
* ``Pipeline._fit`` isinstance-checks every stage against
  ``Estimator``/``Transformer`` (pipeline.py ``_fit`` — the check that
  duck-typed classes fail) and builds a ``PipelineModel``.

The CI pyspark job runs the same shape against REAL pyspark on a real
local-cluster (tests/test_real_pyspark.py::test_ml_pipeline_fit_transform).
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUB = '''
from abc import ABCMeta, abstractmethod
import uuid


class Param:
    """pyspark.ml.param.Param stand-in (parent/name/doc triple)."""

    def __init__(self, parent, name, doc):
        self.parent = parent
        self.name = name
        self.doc = doc

    def _copy_new_parent(self, parent):
        return Param(parent, self.name, self.doc)


class Identifiable:
    def __init__(self):
        super().__init__()
        self.uid = type(self).__name__ + "_" + uuid.uuid4().hex[:12]

    def __repr__(self):
        return self.uid


class Params(Identifiable, metaclass=ABCMeta):
    def __init__(self):
        super().__init__()
        self._paramMap = {}
        self._defaultParamMap = {}
        self._params = None  # the instance attr that shadows same-named methods
        self._copy_params()

    def _copy_params(self):
        cls = type(self)
        for name in dir(cls):
            attr = getattr(cls, name)
            if isinstance(attr, Param):
                setattr(self, name, attr._copy_new_parent(self))

    @property
    def params(self):
        if self._params is None:
            self._params = [
                getattr(self, x) for x in dir(self)
                if x != "params" and isinstance(getattr(type(self), x, None), Param)
            ]
        return self._params


class Estimator(Params, metaclass=ABCMeta):
    @abstractmethod
    def _fit(self, dataset):
        raise NotImplementedError()

    def fit(self, dataset, params=None):
        return self._fit(dataset)


class Transformer(Params, metaclass=ABCMeta):
    @abstractmethod
    def _transform(self, dataset):
        raise NotImplementedError()

    def transform(self, dataset, params=None):
        return self._transform(dataset)


class Model(Transformer, metaclass=ABCMeta):
    pass


class Pipeline(Params):
    def __init__(self, stages):
        super().__init__()
        self.stages = stages

    def fit(self, dataset):
        return self._fit(dataset)

    def _fit(self, dataset):
        stages = self.stages
        for stage in stages:
            if not (isinstance(stage, Estimator) or isinstance(stage, Transformer)):
                raise TypeError(
                    "Cannot recognize a pipeline stage of type %s." % type(stage)
                )
        indexOfLastEstimator = -1
        for i, stage in enumerate(stages):
            if isinstance(stage, Estimator):
                indexOfLastEstimator = i
        transformers = []
        for i, stage in enumerate(stages):
            if i <= indexOfLastEstimator:
                if isinstance(stage, Transformer):
                    transformers.append(stage)
                    dataset = stage.transform(dataset)
                else:
                    model = stage.fit(dataset)
                    transformers.append(model)
                    if i < indexOfLastEstimator:
                        dataset = model.transform(dataset)
            else:
                transformers.append(stage)
        return PipelineModel(transformers)


class PipelineModel(Model):
    def __init__(self, stages):
        super().__init__()
        self.stages = stages

    def _transform(self, dataset):
        for stage in self.stages:
            dataset = stage.transform(dataset)
        return dataset
'''

DRIVER = '''
import os, sys

os.environ["TOS_PLATFORM"] = "cpu"
sys.path.insert(0, {repo!r})

import pyspark.ml as ml  # the stub
import numpy as np

from tensorflowonspark_tpu_torch import pipeline


def main():
    # -- citizenship: real subclasses, not duck types -----------------------
    assert issubclass(pipeline.TFEstimator, ml.Estimator), pipeline.TFEstimator.__mro__
    assert issubclass(pipeline.TFModel, ml.Model)
    assert issubclass(pipeline.TFModel, ml.Transformer)

    # -- init chain: pyspark Params/Identifiable ran (uid), and its
    #    `self._params = None` did not break the string-keyed param maps ----
    est = pipeline.TFEstimator(lambda a, c: None, {{"other": "keep"}})
    assert getattr(est, "uid", "").startswith("TFEstimator_"), est.uid
    est.setBatchSize(32).setClusterSize(2)
    assert est.getBatchSize() == 32
    assert est.extractParamMap()["epochs"] == 1  # mixin defaults intact
    args = est.merge_args_params()
    assert args.batch_size == 32 and args.other == "keep"

    # -- Pipeline._fit isinstance gate + fit/transform dispatch -------------
    class RecordingEstimator(pipeline.TFEstimator):
        def _fit(self, dataset):
            model = pipeline.TFModel(self.args)
            self.copyParamsTo(model)
            model.fitted_on = dataset
            return model

    est2 = RecordingEstimator(lambda a, c: None, {{}}).setBatchSize(4)
    pm = ml.Pipeline(stages=[est2]).fit("DATASET")
    assert isinstance(pm, ml.PipelineModel)
    tf_model = pm.stages[0]
    assert isinstance(tf_model, pipeline.TFModel) and isinstance(tf_model, ml.Model)
    assert tf_model.fitted_on == "DATASET"
    assert tf_model.getBatchSize() == 4
    assert getattr(tf_model, "uid", "").startswith("TFModel_")

    # a non-stage object is still rejected by the gate
    try:
        ml.Pipeline(stages=[object()]).fit("DATASET")
    except TypeError:
        pass
    else:
        raise AssertionError("Pipeline accepted a non-Estimator stage")

    # -- TFModel.transform through the REAL _transform path (numpy bundle,
    #    local backend DataFrame) inside the PipelineModel ------------------
    from tensorflowonspark_tpu_torch.backends.local import LocalSparkContext
    from tensorflowonspark_tpu_torch.train import export

    sc = LocalSparkContext(num_executors=1)
    try:
        bundle = os.path.join({tmp!r}, "bundle")

        def predict_builder():
            def predict(params, model_state, arrays):
                return {{"y_": arrays["x"] @ params["w"]}}

            return predict

        export.export_model(bundle, predict_builder,
                            {{"w": np.array([[2.0], [1.0]], np.float32)}})
        tf_model.setInputMapping({{"features": "x"}}).setExportDir(bundle)
        tf_model.setOutputMapping({{"y_": "prediction"}})
        df = sc.createDataFrame([([1.0, 2.0],), ([3.0, 4.0],)], ["features"], 1)
        out = pm.transform(df)  # PipelineModel.transform -> TFModel._transform
        preds = [row[0][0] for row in out.collect()]
        assert preds == [4.0, 10.0], preds
    finally:
        sc.stop()

    print("PYSPARK_ML_CITIZENSHIP_OK")


if __name__ == "__main__":  # LocalSparkContext spawns processes that
    main()                  # re-import this module
'''


def test_pyspark_ml_citizenship_via_stub(tmp_path):
    pkg = tmp_path / "stub" / "pyspark"
    (pkg / "ml").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "ml" / "__init__.py").write_text(STUB)
    driver = tmp_path / "driver.py"
    driver.write_text(DRIVER.format(repo=REPO, tmp=str(tmp_path)))
    env = dict(os.environ)
    env["PYTHONPATH"] = "{}{}{}".format(
        tmp_path / "stub", os.pathsep, env.get("PYTHONPATH", "")
    )
    env["TOS_PLATFORM"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(driver)], env=env, cwd=REPO,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "PYSPARK_ML_CITIZENSHIP_OK" in proc.stdout

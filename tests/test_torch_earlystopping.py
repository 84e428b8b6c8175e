"""Early stopping in the port (``train/earlystopping.py``) against the
JAX package's, on the CPU.

The same tiny MLP (JAX weights through ``params_from_jax``) trained by
both packages' ``EarlyStoppingTrainer`` on the same batches, one step a
dispatch and four: the same termination reason and details, best epoch
and epoch count, the best score and every epoch's held-out score within
1e-6 (rtol and atol). The savers return the best model (from its file,
on the model's device; in memory, in the model's own tensors), the
iteration conditions stop an epoch early, and a run resumed from its
checkpoint ends as the uninterrupted one does.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu.data import dataset as jdata
from deeplearning4j_tpu.nn import layers as jlayers
from deeplearning4j_tpu.nn.config import InputType as JInputType
from deeplearning4j_tpu.nn.config import NeuralNetConfiguration as JConf
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.train import earlystopping as jes
from deeplearning4j_tpu.train import updaters as jupd
from deeplearning4j_tpu_torch.data.dataset import (DataSet,
                                                   ListDataSetIterator)
from deeplearning4j_tpu_torch.nn import layers as L
from deeplearning4j_tpu_torch.nn.config import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.train import earlystopping as es
from deeplearning4j_tpu_torch.train import updaters
from deeplearning4j_tpu_torch.train.resilience import CheckpointConfig

torch.set_num_threads(2)

TOL = 1e-6


def _conf(Conf, M, It, upd):
    return (Conf.Builder().seed(3).updater(upd.Adam(0.05)).list()
            .layer(M.DenseLayer(nOut=16, activation="relu"))
            .layer(M.OutputLayer(nOut=3, lossFunction="mcxent",
                                 activation="softmax"))
            .setInputType(It.feedForward(4)).build())


def _arrays(n, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 4).astype(np.float32)
    # a noisy rule, so the held-out loss turns up once the net overfits
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(int) + (x[:, 2] > 1)
    flip = rng.rand(n) < 0.3
    y = np.where(flip, rng.randint(0, 3, n), y)
    return x, np.eye(3, dtype=np.float32)[y]


def _pair():
    j = JMLN(_conf(JConf, jlayers, JInputType, jupd))
    j.init()
    t = MultiLayerNetwork(_conf(NeuralNetConfiguration, L, InputType,
                                updaters)).params_from_jax(
        j._params, j._states, device="cpu")
    return j, t


def _trainer(mod, it_cls, ds_cls, net, saver, k=1, checkpoint=None,
             max_epochs=12, iter_conds=()):
    val = it_cls(ds_cls(*_arrays(64, 9)), 32)
    cfg = (mod.EarlyStoppingConfiguration.Builder()
           .scoreCalculator(mod.DataSetLossCalculator(val))
           .epochTerminationConditions(
               mod.MaxEpochsTerminationCondition(max_epochs),
               mod.ScoreImprovementEpochTerminationCondition(2))
           .iterationTerminationConditions(*iter_conds)
           .modelSaver(saver).build())
    return mod.EarlyStoppingTrainer(cfg, net, it_cls(ds_cls(*_arrays(48, 1)),
                                                     8),
                                    steps_per_dispatch=k,
                                    checkpoint=checkpoint)


def _port(net, saver, **kw):
    return _trainer(es, ListDataSetIterator, DataSet, net, saver, **kw)


def _jax(net, saver, **kw):
    return _trainer(jes, jdata.ListDataSetIterator, jdata.DataSet, net,
                    saver, **kw)


@pytest.mark.parametrize("k", [1, 4])
def test_the_result_matches_jax(k, tmp_path):
    j, t = _pair()
    rj = _jax(j, jes.InMemoryModelSaver(), k=k).fit()
    rt = _port(t, es.LocalFileModelSaver(str(tmp_path)), k=k).fit()
    assert (rt.termination_reason, rt.termination_details) == \
        (rj.termination_reason, rj.termination_details) == \
        ("EpochTerminationCondition",
         "ScoreImprovementEpochTerminationCondition")
    assert rt.best_epoch == rj.best_epoch and \
        rt.total_epochs == rj.total_epochs < 12
    assert sorted(rt.score_vs_epoch) == sorted(rj.score_vs_epoch)
    np.testing.assert_allclose(
        [rt.score_vs_epoch[e] for e in sorted(rt.score_vs_epoch)],
        [rj.score_vs_epoch[e] for e in sorted(rj.score_vs_epoch)],
        rtol=TOL, atol=TOL)
    np.testing.assert_allclose(rt.best_score, rj.best_score, rtol=TOL,
                               atol=TOL)
    best = rt.getBestModel()
    assert best is not t and best._device == torch.device("cpu")
    val = ListDataSetIterator(DataSet(*_arrays(64, 9)), 32)
    assert es.DataSetLossCalculator(val).calculateScore(best) == \
        rt.best_score


def test_the_in_memory_saver_restores_the_best_into_the_model():
    _, t = _pair()
    r = _port(t, es.InMemoryModelSaver()).fit()
    best = r.getBestModel()
    # the last epochs did not improve: their params were replaced
    assert best is t and r.best_epoch < r.total_epochs
    assert r.score_vs_epoch[r.total_epochs] != r.best_score
    val = ListDataSetIterator(DataSet(*_arrays(64, 9)), 32)
    assert es.DataSetLossCalculator(val).calculateScore(best) == \
        r.best_score


def test_an_iteration_condition_ends_the_run():
    _, t = _pair()
    r = _port(t, es.InMemoryModelSaver(), iter_conds=[
        es.MaxScoreIterationTerminationCondition(-1.0)]).fit()
    assert (r.termination_reason, r.termination_details, r.total_epochs) \
        == ("IterationTerminationCondition",
            "MaxScoreIterationTerminationCondition", 0)
    assert t.getIterationCount() == 1


def test_a_resumed_run_ends_as_the_uninterrupted_one(tmp_path):
    _, a = _pair()
    ra = _port(a, es.LocalFileModelSaver(str(tmp_path / "a")),
               max_epochs=4).fit()
    _, b = _pair()
    _port(b, es.LocalFileModelSaver(str(tmp_path / "b")), max_epochs=2,
          checkpoint=CheckpointConfig(str(tmp_path / "ck"))).fit()
    _, c = _pair()
    rc = _port(c, es.LocalFileModelSaver(str(tmp_path / "b")),
               max_epochs=4, checkpoint=CheckpointConfig(
                   str(tmp_path / "ck"), resume=True)).fit()
    assert (rc.best_epoch, rc.total_epochs) == (ra.best_epoch,
                                                ra.total_epochs)
    assert rc.score_vs_epoch == ra.score_vs_epoch
    assert torch.equal(c.params(), a.params())

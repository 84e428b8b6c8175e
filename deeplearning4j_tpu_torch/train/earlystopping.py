"""Early stopping — the port of ``deeplearning4j_tpu/train/earlystopping.py``:
validation-driven termination and the best model's save.

Reference parity: ``org.deeplearning4j.earlystopping.*`` —
``EarlyStoppingConfiguration``, ``EarlyStoppingTrainer``, score calculators
(``DataSetLossCalculator``), termination conditions
(``MaxEpochsTerminationCondition``, ``ScoreImprovementEpochTerminationCondition``,
``MaxScoreIterationTerminationCondition``, ``MaxTimeIterationTerminationCondition``),
``EarlyStoppingResult``, ``LocalFileModelSaver`` / ``InMemoryModelSaver``
(SURVEY.md §2.2 "Early stopping").

A ``LocalFileModelSaver`` reloads the best model on the device of the
model it saved.
"""

from __future__ import annotations

import os
import time
import warnings
from typing import List

import numpy as np
import torch

from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.train import stepping
from deeplearning4j_tpu_torch.train.resilience import CheckpointManager


class DataSetLossCalculator:
    """Average loss over a validation iterator (ref: DataSetLossCalculator)."""

    def __init__(self, iterator, average: bool = True):
        self.iterator = iterator
        self.average = average

    def calculateScore(self, model) -> float:
        total, n = 0.0, 0
        self.iterator.reset()
        while self.iterator.hasNext():
            ds = self.iterator.next()
            total += model.score(ds) * ds.numExamples()
            n += ds.numExamples()
        return total / max(n, 1) if self.average else total


class ClassificationScoreCalculator:
    """Negative accuracy so 'lower is better' holds (ref:
    ClassificationScoreCalculator uses the Evaluation metric)."""

    def __init__(self, iterator):
        self.iterator = iterator

    def calculateScore(self, model) -> float:
        ev = model.evaluate(self.iterator)
        return -ev.accuracy()


class MaxEpochsTerminationCondition:
    def __init__(self, max_epochs: int):
        self.max_epochs = max_epochs

    def terminate(self, epoch: int, score: float, best_epoch: int) -> bool:
        return epoch >= self.max_epochs


class ScoreImprovementEpochTerminationCondition:
    """Stop after N epochs without score improvement (ref class of the
    same name)."""

    def __init__(self, max_epochs_without_improvement: int,
                 min_improvement: float = 0.0):
        self.patience = max_epochs_without_improvement
        self.min_improvement = min_improvement

    def terminate(self, epoch: int, score: float, best_epoch: int) -> bool:
        return (epoch - best_epoch) > self.patience


class MaxScoreIterationTerminationCondition:
    """Abort if score explodes (ref class of the same name)."""

    def __init__(self, max_score: float):
        self.max_score = max_score

    def terminate_iteration(self, score: float) -> bool:
        return score > self.max_score or not np.isfinite(score)


class MaxTimeIterationTerminationCondition:
    def __init__(self, max_seconds: float):
        self.max_seconds = max_seconds
        self._start = None

    def terminate_iteration(self, score: float) -> bool:
        # monotonic: an NTP wall-clock step must not end (or extend)
        # the training budget spuriously (W210)
        if self._start is None:
            self._start = time.monotonic()
            return False
        return (time.monotonic() - self._start) > self.max_seconds


class InMemoryModelSaver:
    def __init__(self):
        self.best = None
        self._model_ref = None

    def saveBestModel(self, model, score):
        self.best = [t.detach().clone() for t in
                     cc.state_tensors(model._params, model._states)]
        self._model_ref = model

    def getBestModel(self):
        """The model with the best params and layer states copied back
        into its own tensors (None when nothing was saved, e.g. a resumed
        run that never beat its restored best score)."""
        if self.best is None:
            return None
        model = self._model_ref
        with torch.no_grad():
            torch._foreach_copy_(
                cc.state_tensors(model._params, model._states), self.best)
        return model


class LocalFileModelSaver:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self.best_path = os.path.join(directory, "bestModel.zip")
        self._model_cls = None
        self._device = None

    def saveBestModel(self, model, score):
        model.save(self.best_path)
        self._model_cls = type(model)
        self._device = model._device

    def getBestModel(self):
        # None when nothing was ever saved (or the zip is gone) — e.g. a
        # resumed run whose restored best was never beaten; the trainer
        # falls back to the final model instead of crashing
        if self._model_cls is None or not os.path.exists(self.best_path):
            return None
        return self._model_cls.load(self.best_path, device=self._device)


class EarlyStoppingConfiguration:
    """ref: EarlyStoppingConfiguration.Builder."""

    def __init__(self, score_calculator, epoch_termination_conditions: List,
                 iteration_termination_conditions: List = None,
                 model_saver=None, evaluate_every_n_epochs: int = 1):
        self.score_calculator = score_calculator
        self.epoch_conditions = epoch_termination_conditions
        self.iter_conditions = iteration_termination_conditions or []
        self.saver = model_saver or InMemoryModelSaver()
        self.eval_every = evaluate_every_n_epochs

    class Builder:
        def __init__(self):
            self._score = None
            self._epoch_conds = []
            self._iter_conds = []
            self._saver = None
            self._every = 1

        def scoreCalculator(self, sc):
            self._score = sc
            return self

        def epochTerminationConditions(self, *conds):
            self._epoch_conds.extend(conds)
            return self

        def iterationTerminationConditions(self, *conds):
            self._iter_conds.extend(conds)
            return self

        def modelSaver(self, saver):
            self._saver = saver
            return self

        def evaluateEveryNEpochs(self, n):
            self._every = n
            return self

        def build(self):
            return EarlyStoppingConfiguration(self._score, self._epoch_conds,
                                              self._iter_conds, self._saver,
                                              self._every)


class EarlyStoppingResult:
    """ref: EarlyStoppingResult."""

    def __init__(self, termination_reason: str, termination_details: str,
                 score_vs_epoch: dict, best_epoch: int, best_score: float,
                 total_epochs: int, best_model):
        self.termination_reason = termination_reason
        self.termination_details = termination_details
        self.score_vs_epoch = score_vs_epoch
        self.best_epoch = best_epoch
        self.best_score = best_score
        self.total_epochs = total_epochs
        self.best_model = best_model

    def getBestModel(self):
        return self.best_model

    def getBestModelEpoch(self):
        return self.best_epoch

    def getBestModelScore(self):
        return self.best_score


class EarlyStoppingTrainer:
    """ref: EarlyStoppingTrainer (works for MultiLayerNetwork and
    ComputationGraph — both expose fit/score).

    ``steps_per_dispatch=K`` routes each epoch through the megastep path
    (ROADMAP PR-2 follow-up): K consecutive same-signature batches run as
    ONE compiled ``lax.scan`` dispatch, with iteration termination
    conditions scored between megabatches (the score checked after a
    K-step dispatch is the dispatch's final per-step loss — conditions
    fire at dispatch granularity, epoch semantics are unchanged).

    ``checkpoint=CheckpointConfig(dir, resume=True)`` (train.resilience)
    checkpoints the model + the trainer's own search state (best score /
    best epoch / score history) after every scored epoch, and resumes
    both from the newest validated checkpoint — an early-stopping run
    killed at epoch 37 restarts with its best-score bookkeeping intact
    instead of rediscovering (or worse, forgetting) its best model. Use
    a ``LocalFileModelSaver`` so the best model itself also survives the
    process."""

    def __init__(self, config: EarlyStoppingConfiguration, model,
                 train_iterator, steps_per_dispatch: int = 1,
                 checkpoint=None):
        self.config = config
        self.model = model
        self.iterator = train_iterator
        self.steps_per_dispatch = max(int(steps_per_dispatch), 1)
        self.checkpoint = checkpoint

    def _epoch_batches(self):
        self.iterator.reset()
        while self.iterator.hasNext():
            yield self.iterator.next()

    def _epoch_items(self):
        """Per-dispatch work items: plain DataSets at K=1, MegaBatches
        (with single-step fallbacks at signature changes / epoch tails)
        at K>1."""
        if self.steps_per_dispatch <= 1:
            return self._epoch_batches()
        return stepping.group_into_megabatches(self._epoch_batches(),
                                                self.steps_per_dispatch)

    def _resume(self, manager):
        """Restore model + search state from the newest valid checkpoint.
        Returns (best_score, best_epoch, scores, epoch)."""
        fresh = (float("inf"), -1, {}, 0)
        if manager is None or not self.checkpoint.resume:
            return fresh
        info = manager.restore(self.model)
        if info is None:
            return fresh
        es = (info.get("extra") or {}).get("earlystopping") or {}
        if isinstance(self.config.saver, LocalFileModelSaver) \
                and os.path.exists(self.config.saver.best_path):
            # re-arm the saver so getBestModel() works without a fresh
            # saveBestModel() call in the resumed process
            self.config.saver._model_cls = type(self.model)
            self.config.saver._device = self.model._device
        elif es.get("best_epoch", -1) >= 0:
            warnings.warn(
                "EarlyStoppingTrainer resume: the best-score bookkeeping was "
                "restored, but this saver cannot reload the best MODEL from a "
                "previous process — the result falls back to the final model "
                "unless the resumed run finds a new best. Use "
                "LocalFileModelSaver for resumable runs.", stacklevel=2)
        return (es.get("best_score", float("inf")),
                es.get("best_epoch", -1),
                {int(k): v for k, v in (es.get("scores") or {}).items()},
                int(es.get("epoch", 0)))

    def fit(self) -> EarlyStoppingResult:
        cfg = self.config
        manager = None
        if self.checkpoint is not None:
            manager = CheckpointManager(self.checkpoint)
        best_score, best_epoch, scores, epoch = self._resume(manager)
        reason, details = "MaxEpochs", ""
        while True:
            # one epoch, watching iteration conditions between dispatches
            aborted = False
            for item in self._epoch_items():
                if isinstance(item, stepping.MegaBatch):
                    self.model._fit_mega(item)
                else:
                    self.model._fit_one(item)
                for ic in cfg.iter_conditions:
                    if ic.terminate_iteration(self.model.score()):
                        reason = "IterationTerminationCondition"
                        details = type(ic).__name__
                        aborted = True
                        break
                if aborted:
                    break
            if aborted:
                break
            epoch += 1
            if epoch % cfg.eval_every == 0:
                score = cfg.score_calculator.calculateScore(self.model)
                scores[epoch] = score
                if score < best_score:
                    best_score = score
                    best_epoch = epoch
                    cfg.saver.saveBestModel(self.model, score)
            if manager is not None:
                manager.save(self.model, extra={"earlystopping": {
                    "best_score": best_score, "best_epoch": best_epoch,
                    "scores": {str(k): v for k, v in scores.items()},
                    "epoch": epoch}})
            stop = False
            for ec in cfg.epoch_conditions:
                if ec.terminate(epoch, scores.get(epoch, best_score), best_epoch):
                    reason = "EpochTerminationCondition"
                    details = type(ec).__name__
                    stop = True
                    break
            if stop:
                break
        best_model = cfg.saver.getBestModel() if best_epoch >= 0 else None
        if best_model is None:
            best_model = self.model
        return EarlyStoppingResult(reason, details, scores, best_epoch,
                                   best_score, epoch, best_model)

"""Data-parallel training over ranks — the port of ``ParallelWrapper``
in ``deeplearning4j_tpu/parallel/wrapper.py``.

``ParallelWrapper`` (ref: DL4J's single-node data parallelism) trains a
network synchronously over the mesh's data axis: every rank is handed
the same global batches, keeps its rows, and the step sums the
gradients over the data group before they are normalized, so each rank
applies the same update to the same replicated params (no averaging
interval, no gradient encoding). It runs the network's own ``fit`` with
a replicated :class:`~deeplearning4j_tpu_torch.distributed.gspmd.
ShardedTrainingPlan` attached: the wrapper and the GSPMD trainer with
such a plan run one step, with one reduction order.

Not ported yet (ROADMAP.md, the next slice): ``ParallelInference``.
"""

from __future__ import annotations

import warnings

from deeplearning4j_tpu_torch.parallel.mesh import DeviceMesh


class ParallelWrapper:
    """Sync data-parallel trainer over the mesh (ref: ParallelWrapper)."""

    def __init__(self, model, mesh: DeviceMesh = None,
                 prefetch_buffer: int = 2, workers: int = None):
        self.model = model
        self.mesh = mesh or DeviceMesh.data_parallel()
        self.mesh.require_data_only("ParallelWrapper")
        self.prefetch = prefetch_buffer

    def _plan(self):
        from deeplearning4j_tpu_torch.distributed.gspmd import \
            ShardedTrainingPlan
        plan = getattr(self.model, "_sharding_plan", None)
        if plan is None or plan.signature() != \
                ShardedTrainingPlan(self.mesh).signature():
            plan = ShardedTrainingPlan(self.mesh)
        return plan

    def _attach(self):
        model = self.model
        if not model._initialized:
            model.init(device=self.mesh.device)
        plan = self._plan()
        model.setShardingPlan(plan)
        plan.apply(model)
        return plan

    def validate(self, batch_size: int = None, **kw):
        """Static lint of the wrapped model against THIS wrapper's mesh:
        the configuration analysis plus the E1xx/W10x distribution lints.
        Extra keywords forward to ``analysis.analyze``."""
        return self.model.validate(batch_size=batch_size,
                                   mesh=self.mesh.spec(), **kw)

    def warmup(self, shapes, *, steps_per_dispatch: int = 1, dtype=None,
               label_dtype=None, policy=None):
        """Warm the wrapped model's steps under THIS wrapper's mesh
        through the compile cache's seam: ``(features, labels)`` pairs
        warm the train step (K steps a dispatch for
        ``steps_per_dispatch`` > 1), bare feature shapes the forward. The
        batch dims pad up to the data-axis multiple as ``fit`` pads real
        batches, and each rank warms its rows' step — the step ``fit``
        dispatches."""
        from deeplearning4j_tpu_torch.distributed.gspmd import local_shapes
        from deeplearning4j_tpu_torch.nn import compilecache as _cc
        k = max(int(steps_per_dispatch), 1)
        local = local_shapes(shapes, self.mesh.size("data"), k)
        self._attach()
        if policy is not None:
            self.model.setPrecisionPolicy(policy)
        _cc.warmup(self.model, local, steps_per_dispatch=k, dtype=dtype,
                   label_dtype=label_dtype)
        return self.model

    def fit(self, iterator, epochs: int = 1, steps_per_dispatch: int = 1,
            checkpoint=None, nan_policy=None, faults=None, elastic=None):
        """Train on ``iterator`` (every rank hands the same global
        batches); ``steps_per_dispatch=K`` runs K steps a dispatch (a
        captured CUDA graph on the card, its all-reduces inside).
        ``checkpoint=``/``nan_policy=``/``faults=`` run the fit under the
        resilience layer as the model's own ``fit`` does (data rank 0
        writes the checkpoints). ``elastic=ElasticConfig(...)`` (or
        True) runs :func:`~deeplearning4j_tpu_torch.parallel.elastic.
        fit_elastic`: on a rank's loss the survivors agree on a step,
        form a smaller group and resume from that step's checkpoint
        (requires ``checkpoint=``; ``self.mesh`` is the shrunk mesh
        after a recovery)."""
        if elastic is not None and elastic is not False:
            from deeplearning4j_tpu_torch.parallel import elastic as _elastic
            cfg = elastic if isinstance(elastic, _elastic.ElasticConfig) \
                else _elastic.ElasticConfig()
            return _elastic.fit_elastic(
                self, iterator, epochs=epochs,
                steps_per_dispatch=steps_per_dispatch,
                checkpoint=checkpoint, nan_policy=nan_policy, faults=faults,
                config=cfg)
        self._attach()
        return self.model.fit(
            iterator, epochs=epochs, steps_per_dispatch=steps_per_dispatch,
            prefetch=self.prefetch or 0, checkpoint=checkpoint,
            nan_policy=nan_policy, faults=faults)

    def averagingFrequency(self, n):
        # API-parity shim: the gradients are summed every step; there is
        # no averaging interval to configure
        warnings.warn(
            "ParallelWrapper.averagingFrequency has no effect: gradients are "
            "all-reduced synchronously every step (no interval)",
            stacklevel=2)
        return self

    def workers(self, n):
        warnings.warn(
            "ParallelWrapper.workers has no effect: the worker count is the "
            "mesh's data-axis size (%d); pass a different DeviceMesh instead"
            % self.mesh.size("data"), stacklevel=2)
        return self

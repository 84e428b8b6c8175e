"""The eval gate: no candidate reaches the registry without a verdict.

The gate sits between "the trainer produced a checkpoint" and
"``registry.load()``" — the single place the lifecycle loop can stop a
bad model BEFORE it costs a captured bucket ladder, let alone traffic.
It scores the candidate on a held-out eval set (by preference the
live-traffic capture, so the score reflects production inputs) and
compares against the serving incumbent:

- **finiteness** — a candidate whose outputs are NaN/Inf on real eval
  rows is rejected outright (the classic poisoned-checkpoint failure);
- **scorecard** — with labels, candidate loss must stay within
  ``max_regression`` of the incumbent's loss on the same rows;
- **loss parity** — without labels, the candidate's outputs must stay
  within a relative ``parity_bound`` of the incumbent's (a continuous-
  training step should refine the function, not replace it).

A failing candidate is returned as a structured :class:`GateVerdict`
(reason + both scores + detail) the driver quarantines and records — it
is never loaded, so a gate rejection costs zero serving-side work.

The verdicts, reasons, formulas and the
``dl4j_lifecycle_gate_verdicts_total`` labels are the JAX package's. The
outputs stay where the model computed them: finiteness is one
``torch.isfinite`` reduction, the mean squared error and the output
scale are summed in float64 a few rows at a time (a BERT-base logit row
of 128 x 30522 is 15.6 MB in fp32), and only scalars reach the host.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch import profiler as _prof

_REG = _prof.get_registry()
GATE_VERDICTS = _REG.counter(
    "dl4j_lifecycle_gate_verdicts_total",
    "Eval-gate decisions by outcome",
    labelnames=("outcome",))

#: elements a float64 temporary of the reductions holds at most (256 MB)
_CHUNK_ELEMENTS = 1 << 25


def as_tensor(out) -> torch.Tensor:
    """A model's output as a tensor, left on its device (a numpy result
    becomes a CPU tensor)."""
    if isinstance(out, torch.Tensor):
        return out
    return torch.from_numpy(np.ascontiguousarray(np.asarray(out)))


def _forward(model, x) -> torch.Tensor:
    from deeplearning4j_tpu_torch.serving.server import resolve_forward
    with torch.inference_mode():
        return as_tensor(resolve_forward(model)(x))


def _row_chunks(*ts):
    """Row slices of broadcast tensors, each small enough that its
    float64 copy stays under ``_CHUNK_ELEMENTS``."""
    ts = torch.broadcast_tensors(*ts)
    if ts[0].dim() == 0:
        yield ts
        return
    per_row = max(ts[0][0].numel(), 1)
    step = max(_CHUNK_ELEMENTS // per_row, 1)
    for i in range(0, ts[0].shape[0], step):
        yield tuple(t[i:i + step] for t in ts)


def _mse(a: torch.Tensor, b) -> float:
    b = as_tensor(b).to(a.device)
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    n = 0
    for ca, cb in _row_chunks(a, b):
        total += ((ca.double() - cb.double()) ** 2).sum()
        n += ca.numel()
    return float(total) / max(n, 1)


def _mean_abs(a: torch.Tensor) -> float:
    total = torch.zeros((), dtype=torch.float64, device=a.device)
    for (ca,) in _row_chunks(a):
        total += ca.double().abs().sum()
    return float(total) / max(a.numel(), 1)


class GatePolicy:
    """Tuning knobs for :class:`EvalGate`.

    - ``max_regression``: with labels, allow candidate_loss up to
      ``incumbent_loss * (1 + max_regression) + abs_slack``.
    - ``parity_bound``: without labels, allow relative output
      divergence vs the incumbent up to this bound.
    - ``require_finite``: reject non-finite candidate outputs.
    - ``min_eval_rows``: refuse to pass a candidate on fewer rows (an
      empty eval set proves nothing — fail CLOSED, reason
      ``"insufficient_eval"``).
    """

    __slots__ = ("max_regression", "parity_bound", "require_finite",
                 "min_eval_rows", "abs_slack")

    def __init__(self, max_regression: float = 0.05,
                 parity_bound: float = 0.25,
                 require_finite: bool = True,
                 min_eval_rows: int = 1,
                 abs_slack: float = 1e-6):
        if max_regression < 0 or parity_bound < 0:
            raise ValueError("gate bounds must be non-negative")
        self.max_regression = float(max_regression)
        self.parity_bound = float(parity_bound)
        self.require_finite = bool(require_finite)
        self.min_eval_rows = int(min_eval_rows)
        self.abs_slack = float(abs_slack)


class GateVerdict:
    """Structured gate outcome: truthy = candidate may load. A failing
    verdict carries the machine-readable ``reason`` the driver writes
    into the quarantine record."""

    __slots__ = ("passing", "reason", "candidate_score",
                 "incumbent_score", "detail")

    def __init__(self, passing: bool, reason: Optional[str] = None,
                 candidate_score: Optional[float] = None,
                 incumbent_score: Optional[float] = None,
                 detail: Optional[dict] = None):
        self.passing = bool(passing)
        self.reason = reason
        self.candidate_score = candidate_score
        self.incumbent_score = incumbent_score
        self.detail = detail or {}

    def __bool__(self) -> bool:
        return self.passing

    def to_dict(self) -> dict:
        return {"passing": self.passing, "reason": self.reason,
                "candidate_score": self.candidate_score,
                "incumbent_score": self.incumbent_score,
                "detail": self.detail}

    def __repr__(self):
        if self.passing:
            return "GateVerdict(PASS)"
        return f"GateVerdict(FAIL: {self.reason})"


class EvalGate:
    """Score a candidate against the serving incumbent on held-out
    rows. ``score_fn(model, x, y) -> float`` overrides the default
    scorer (MSE vs labels, or vs the incumbent's outputs when
    unlabeled); lower is better either way.

    ``eval_x`` may be a tensor (used where it lies; the lifecycle driver
    hands one on the registry's device, in the serving dtype) or an
    array, which goes to ``device`` (``cuda`` unless told, as every entry
    point of the port)."""

    def __init__(self, policy: Optional[GatePolicy] = None,
                 score_fn: Optional[Callable] = None, device=None):
        self.policy = policy or GatePolicy()
        self.score_fn = score_fn
        self.device = device

    def _rows(self, eval_x) -> torch.Tensor:
        if isinstance(eval_x, torch.Tensor):
            return eval_x if self.device is None \
                else eval_x.to(self.device)
        from deeplearning4j_tpu_torch.device import resolve_device
        x = np.ascontiguousarray(np.asarray(eval_x))
        return torch.from_numpy(x).to(
            resolve_device(self.device))

    def evaluate(self, candidate, incumbent, eval_x,
                 eval_y=None) -> GateVerdict:
        pol = self.policy
        n = 0 if eval_x is None else int(eval_x.shape[0]
                                         if hasattr(eval_x, "shape")
                                         else np.asarray(eval_x).shape[0])
        if n < pol.min_eval_rows:
            # fail CLOSED: no evidence is not a pass
            v = GateVerdict(False, "insufficient_eval",
                            detail={"rows": n,
                                    "min_rows": pol.min_eval_rows})
            GATE_VERDICTS.labels(outcome="insufficient_eval").inc()
            return v
        x = self._rows(eval_x)
        cand_out = _forward(candidate, x)
        if pol.require_finite:
            bad = int((~torch.isfinite(cand_out)).sum())
            if bad:
                v = GateVerdict(False, "non_finite_outputs",
                                detail={"non_finite_values": bad,
                                        "rows": n})
                GATE_VERDICTS.labels(outcome="non_finite").inc()
                return v
        inc_out = None if incumbent is None else _forward(incumbent, x)
        if self.score_fn is not None:
            cand = float(self.score_fn(candidate, x, eval_y))
            inc = (float(self.score_fn(incumbent, x, eval_y))
                   if incumbent is not None else None)
        elif eval_y is not None:
            cand = _mse(cand_out, eval_y)
            inc = _mse(inc_out, eval_y) if inc_out is not None else None
        else:
            # unlabeled: parity vs the incumbent's function
            cand = (_mse(cand_out, inc_out) if inc_out is not None
                    else 0.0)
            inc = 0.0 if inc_out is not None else None
        detail = {"rows": n, "labeled": eval_y is not None}
        if inc is not None and eval_y is None and self.score_fn is None:
            # parity mode: divergence bound relative to output scale
            scale = _mean_abs(inc_out) ** 2 + pol.abs_slack
            rel = cand / scale
            detail["parity_rel"] = rel
            if rel > pol.parity_bound:
                v = GateVerdict(False, "parity_violation", cand, inc,
                                detail)
                GATE_VERDICTS.labels(outcome="parity_violation").inc()
                return v
        elif inc is not None:
            bound = inc * (1.0 + pol.max_regression) + pol.abs_slack
            detail["bound"] = bound
            if cand > bound:
                v = GateVerdict(False, "scorecard_regression", cand, inc,
                                detail)
                GATE_VERDICTS.labels(
                    outcome="scorecard_regression").inc()
                return v
        GATE_VERDICTS.labels(outcome="pass").inc()
        return GateVerdict(True, None, cand, inc, detail)

"""Updaters — the port of ``deeplearning4j_tpu/train/updaters.py``: the
eleven ND4J updaters (``Sgd``, ``NoOp``, ``Adam``, ``AdamW``, ``AMSGrad``,
``AdaMax``, ``Nadam``, ``Nesterovs``, ``RmsProp``, ``AdaGrad``,
``AdaDelta``), the gradient-normalization helpers the train step applies
before them, and L1/L2 regularization. ``to_config`` / ``from_config``
write and read the JAX package's JSON (``{"@class": "Adam",
"learning_rate": {...}, ...}``), so a ``TrainingConfig`` saved by either
package loads in the other.

Same contract as the JAX package: ``apply(grad, state, lr, t)`` returns
``(update, new_state)`` and the caller SUBTRACTS ``update`` from the
param (the reference's ``params.subi(update)``). The math is fp32 on
fp32 master params. ``t`` is a Python int or a 0-d device tensor (the
networks' and the transformer step's device clock), which a captured
step reads at every replay. Adam is DL4J's form, ``alpha = lr*sqrt(1-b2^t) /
(1-b1^t)``, ``update = alpha*m / (sqrt(v) + eps)``: epsilon sits outside
the bias correction, unlike ``torch.optim.Adam``, so that is not used.

``lr_at`` multiplies the schedule's rate by ``_lr_scale`` (the
``NanPolicy.BACKOFF_LR`` knob of ``train.resilience``): a Python float,
or, once a network has made it one (``BaseNetwork._ensure_lr_scale``), a
0-d fp32 device tensor of the network's dispatch state that recovery
writes in place, so a captured step reads the new scale at its next
replay and nothing is captured again.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.train.schedules import ISchedule, resolve

State = Dict[str, Any]


class IUpdater:
    """Config object: ``init_state(param)`` + ``apply(grad, state, lr,
    t)``; ``lr`` comes from the schedule at iteration ``t``."""

    #: default learning rate if none given (each reference config's)
    DEFAULT_LR = 0.001
    has_state = True

    def __init__(self, learning_rate=None):
        self.learning_rate = resolve(self.DEFAULT_LR if learning_rate is None
                                     else learning_rate)

    def lr_at(self, t, epoch=0):
        lr = self.learning_rate.valueAt(t, epoch)
        scale = self.__dict__.get("_lr_scale", 1.0)
        if isinstance(scale, torch.Tensor) or scale != 1.0:
            return lr * scale
        return lr

    def init_state(self, param) -> State:
        return {}

    def apply(self, grad, state: State, lr, t) -> Tuple[torch.Tensor, State]:
        raise NotImplementedError

    def to_config(self):
        d = {"@class": type(self).__name__}
        for k, v in self.__dict__.items():
            if k.startswith("_"):
                continue                  # run-time caches, not config
            d[k] = v.to_config() if isinstance(v, ISchedule) else v
        return d

    @staticmethod
    def from_config(d):
        d = dict(d)
        name = d.pop("@class")
        if name not in UPDATERS:
            raise ValueError(f"unknown updater {name!r} (known: "
                             f"{sorted(UPDATERS)})")
        obj = UPDATERS[name].__new__(UPDATERS[name])
        for k, v in d.items():
            if k == "learning_rate" and isinstance(v, dict):
                v = ISchedule.from_config(v)
            setattr(obj, k, v)
        return obj

    def __repr__(self):
        return f"{type(self).__name__}({self.__dict__})"


class Sgd(IUpdater):
    """update = lr * g (ref: SgdUpdater)."""

    DEFAULT_LR = 0.1
    has_state = False

    def apply(self, grad, state, lr, t):
        return lr * grad, state


class Adam(IUpdater):
    """ref: AdamUpdater — alpha_t = lr*sqrt(1-b2^t)/(1-b1^t)."""

    DEFAULT_LR = 0.001

    def __init__(self, learning_rate=None, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}

    def alpha(self, lr, t):
        """``lr*sqrt(1-b2^(t+1))/(1-b1^(t+1))`` in fp32, as the JAX step
        traces it: a Python float for a Python ``t`` (numpy's fp32
        ``pow``), a 0-d fp32 tensor beside a 0-d device ``t``, so a
        captured step reads the counter at replay (the same bits on the
        CPU: both round ``powf``)."""
        if isinstance(t, torch.Tensor):
            # one computation a step, not one a leaf: the clock's version
            # counter moves with every in-place update of it; a value made
            # while a CUDA graph is captured is never read eagerly (nor
            # the reverse)
            capturing = t.is_cuda and torch.cuda.is_current_stream_capturing()
            key = (t.data_ptr(), t._version, str(t.device),
                   id(lr) if isinstance(lr, torch.Tensor) else lr, capturing)
            memo = self.__dict__.get("_alpha_memo")
            if memo is not None and memo[0] == key:
                return memo[1]
            t1 = t.float() + 1
            alpha = lr * torch.sqrt(1 - self.beta2 ** t1) \
                / (1 - self.beta1 ** t1)
            self._alpha_memo = (key, alpha)
            return alpha
        t1 = np.float32(t) + np.float32(1)
        one = np.float32(1)
        return float(np.float32(lr) * np.sqrt(
            one - np.float32(self.beta2) ** t1)
            / (one - np.float32(self.beta1) ** t1))

    def apply(self, grad, state, lr, t):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad.square()
        update = self.alpha(lr, t) * m / (torch.sqrt(v) + self.epsilon)
        return update, {"m": m, "v": v}


class AdamW(Adam):
    """Adam + decoupled weight decay (ref: AdamW). The trainer adds
    ``weight_decay_update`` because it needs the param value."""

    def __init__(self, learning_rate=None, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(learning_rate, beta1, beta2, epsilon)
        self.weight_decay = weight_decay

    def weight_decay_update(self, param, lr):
        return lr * self.weight_decay * param


class AMSGrad(Adam):
    """ref: AMSGradUpdater — Adam on the running maximum of v."""

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "v": torch.zeros_like(param),
                "vhat": torch.zeros_like(param)}

    def apply(self, grad, state, lr, t):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad.square()
        vhat = torch.maximum(state["vhat"], v)
        update = self.alpha(lr, t) * m / (torch.sqrt(vhat) + self.epsilon)
        return update, {"m": m, "v": v, "vhat": vhat}


class AdaMax(Adam):
    """ref: AdaMaxUpdater — the infinity-norm variant."""

    def init_state(self, param):
        return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}

    def apply(self, grad, state, lr, t):
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        u = torch.maximum(self.beta2 * state["u"], grad.abs())
        update = (lr / _one_minus_pow(self.beta1, t)) * m / (u + self.epsilon)
        return update, {"m": m, "u": u}


class Nadam(Adam):
    """ref: NadamUpdater — Nesterov-accelerated Adam."""

    def apply(self, grad, state, lr, t):
        c1 = _one_minus_pow(self.beta1, t)
        m = self.beta1 * state["m"] + (1 - self.beta1) * grad
        v = self.beta2 * state["v"] + (1 - self.beta2) * grad.square()
        m_hat = m / c1
        v_hat = v / _one_minus_pow(self.beta2, t)
        update = lr * (self.beta1 * m_hat + (1 - self.beta1) * grad / c1) \
            / (torch.sqrt(v_hat) + self.epsilon)
        return update, {"m": m, "v": v}


class NoOp(IUpdater):
    """Frozen params (ref: NoOpUpdater)."""

    has_state = False

    def __init__(self, learning_rate=None):
        super().__init__(0.0)

    def apply(self, grad, state, lr, t):
        return torch.zeros_like(grad), state


class Nesterovs(IUpdater):
    """ref: NesterovsUpdater (Bengio's form): v' = mu*v - lr*g; the step
    applied is mu^2*v - (1+mu)*lr*g."""

    DEFAULT_LR = 0.1

    def __init__(self, learning_rate=None, momentum: float = 0.9):
        super().__init__(learning_rate)
        self.momentum = momentum

    def init_state(self, param):
        return {"v": torch.zeros_like(param)}

    def apply(self, grad, state, lr, t):
        mu = self.momentum
        v_new = mu * state["v"] - lr * grad
        update = -(mu * v_new - lr * grad)
        return update, {"v": v_new}


class RmsProp(IUpdater):
    """ref: RmsPropUpdater."""

    DEFAULT_LR = 0.1

    def __init__(self, learning_rate=None, rms_decay: float = 0.95,
                 epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.rms_decay, self.epsilon = rms_decay, epsilon

    def init_state(self, param):
        return {"g2": torch.zeros_like(param)}

    def apply(self, grad, state, lr, t):
        g2 = self.rms_decay * state["g2"] \
            + (1 - self.rms_decay) * grad.square()
        update = lr * grad / (torch.sqrt(g2) + self.epsilon)
        return update, {"g2": g2}


class AdaGrad(IUpdater):
    """ref: AdaGradUpdater."""

    DEFAULT_LR = 0.1

    def __init__(self, learning_rate=None, epsilon: float = 1e-6):
        super().__init__(learning_rate)
        self.epsilon = epsilon

    def init_state(self, param):
        return {"h": torch.zeros_like(param)}

    def apply(self, grad, state, lr, t):
        h = state["h"] + grad.square()
        update = lr * grad / (torch.sqrt(h) + self.epsilon)
        return update, {"h": h}


class AdaDelta(IUpdater):
    """ref: AdaDeltaUpdater — no learning rate."""

    def __init__(self, rho: float = 0.95, epsilon: float = 1e-6):
        super().__init__(1.0)
        self.rho, self.epsilon = rho, epsilon

    def init_state(self, param):
        return {"Eg2": torch.zeros_like(param), "Ex2": torch.zeros_like(param)}

    def apply(self, grad, state, lr, t):
        rho, eps = self.rho, self.epsilon
        eg2 = rho * state["Eg2"] + (1 - rho) * grad.square()
        update = grad * torch.sqrt(state["Ex2"] + eps) / torch.sqrt(eg2 + eps)
        ex2 = rho * state["Ex2"] + (1 - rho) * update.square()
        return update, {"Eg2": eg2, "Ex2": ex2}


def _one_minus_pow(beta: float, t):
    """``1 - beta^(t+1)`` in fp32: a Python float for a Python ``t``
    (numpy's fp32 ``pow``), a 0-d fp32 tensor beside a device ``t``."""
    if isinstance(t, torch.Tensor):
        return 1 - beta ** (t.float() + 1)
    return float(np.float32(1) - np.float32(beta)
                 ** (np.float32(t) + np.float32(1)))


UPDATERS = {c.__name__: c for c in
            (Sgd, NoOp, Adam, AdamW, AMSGrad, AdaMax, Nadam, Nesterovs,
             RmsProp, AdaGrad, AdaDelta)}


def clip_by_value(grads: List[torch.Tensor], clip: float):
    """ref: GradientNormalization.ClipElementWiseAbsoluteValue."""
    return [torch.clamp(g, -clip, clip) for g in grads]


def _norms(grads: List[torch.Tensor], sq=None):
    """Each tensor's L2 norm, or the roots of given squared norms ``sq``
    (a data-parallel step's, where some gradients are pieces)."""
    if sq is None:
        return [torch.sqrt(torch.sum(g.square())) for g in grads]
    return list(torch.sqrt(sq).unbind(0))


def clip_by_norm(grads: List[torch.Tensor], max_norm: float, sq=None):
    """Per-tensor L2 clip (ref: ClipL2PerLayer/PerParamType); ``sq``: the
    tensors' squared norms when given (see :func:`_norms`)."""
    out = []
    for g, n in zip(grads, _norms(grads, sq)):
        out.append(g * torch.clamp(max_norm / torch.clamp_min(n, 1e-12),
                                   max=1.0))
    return out


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        sq=None):
    """Global-norm clip over every gradient (``sq``: as
    :func:`clip_by_norm`)."""
    gn = torch.sqrt(sum(torch.sum(g.square()) for g in grads)) \
        if sq is None else torch.sqrt(sq.sum())
    scale = torch.clamp(max_norm / torch.clamp_min(gn, 1e-12), max=1.0)
    return [g * scale for g in grads]


def renormalize_l2(grads: List[torch.Tensor], sq=None):
    """ref: GradientNormalization.RenormalizeL2PerLayer — divide by norm
    (``sq``: as :func:`clip_by_norm`)."""
    return [g / torch.clamp_min(n, 1e-12)
            for g, n in zip(grads, _norms(grads, sq))]


def apply_regularization(param, grad, l1: float = 0.0, l2: float = 0.0):
    """ref semantics: L1/L2 fold into the gradient BEFORE the updater."""
    if l2 > 0:
        grad = grad + l2 * param
    if l1 > 0:
        grad = grad + l1 * torch.sign(param)
    return grad

"""A3C + the policy abstraction — the port of ``deeplearning4j_tpu/rl/
a3c.py``.

Reference parity: ``org.deeplearning4j.rl4j.learning.async.a3c
.discrete.A3CDiscreteDense`` and the policy hierarchy ``rl4j.policy.
{Policy, ACPolicy, DQNPolicy, EpsGreedy}``.

As in the JAX package, N rollout workers (threads, one MDP each) act with
the current shared parameters and push n-step rollouts, padded to
``n_step`` with a validity mask, to a queue; one learner applies an
advantage-actor-critic step (policy gradient + value regression + entropy
bonus, DL4J's Adam: ``alpha = lr*sqrt(1-b2^t)/(1-b1^t)``) a rollout. The
step, ``_a3c_step``, updates the parameters, the moments and the clock in
place and runs through :class:`~..nn.compilecache.CachedDispatch` (scope
``"rl:a3c"``). The workers' one-row forwards run on their own threads
while the learner replays, so every forward and every call of the
dispatch (its capture and its replays) happen under the A3C lock
(``InstrumentedLock("rl:a3c")``): a forward never reads a half-written
parameter, and no capture runs beside another thread's launches. All
randomness is numpy ``RandomState``, as in the JAX package.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.profiler.locks import InstrumentedLock
from deeplearning4j_tpu_torch.rl.dqn import _host, _mlp_init
from deeplearning4j_tpu_torch.rl.mdp import MDP


# ------------------------------------------------------------------ policies
class Policy:
    """ref: rl4j.policy.Policy — maps observations to actions and can
    play an episode on an MDP."""

    def nextAction(self, obs) -> int:
        raise NotImplementedError

    def play(self, mdp: MDP, max_steps: int = 1000) -> float:
        obs = mdp.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done = mdp.step(self.nextAction(obs))
            total += r
            if done:
                break
        return total


class DQNPolicy(Policy):
    """ref: rl4j.policy.DQNPolicy — greedy over a Q-network
    ``q_fn(params, obs[None])``."""

    def __init__(self, q_fn: Callable, params):
        self._q_fn = q_fn
        self._params = params

    def nextAction(self, obs) -> int:
        q = _host(self._q_fn(self._params,
                             np.asarray(obs, np.float32)[None]))
        return int(np.argmax(q[0]))


class ACPolicy(Policy):
    """ref: rl4j.policy.ACPolicy — samples from the actor's softmax (or
    argmax when deterministic)."""

    def __init__(self, pi_fn: Callable, params, deterministic: bool = False,
                 seed: int = 0):
        self._pi_fn = pi_fn
        self._params = params
        self._det = deterministic
        self._rng = np.random.RandomState(seed)

    def nextAction(self, obs) -> int:
        logits = _host(self._pi_fn(self._params,
                                   np.asarray(obs, np.float32)[None]))[0]
        if self._det:
            return int(np.argmax(logits))
        p = np.exp(logits.astype(np.float64) - logits.max())
        p /= p.sum()   # float64: np.random.choice rejects float32 round-off
        return int(self._rng.choice(len(p), p=p))


class EpsGreedy(Policy):
    """ref: rl4j.policy.EpsGreedy — anneals exploration around any policy."""

    def __init__(self, inner: Policy, action_space_n: int,
                 eps_start: float = 1.0, eps_end: float = 0.05,
                 anneal_steps: int = 1000, seed: int = 0):
        self.inner = inner
        self.n = action_space_n
        self.eps_start, self.eps_end = eps_start, eps_end
        self.anneal = anneal_steps
        self._t = 0
        self._rng = np.random.RandomState(seed)

    def epsilon(self) -> float:
        frac = min(self._t / max(self.anneal, 1), 1.0)
        return self.eps_start + (self.eps_end - self.eps_start) * frac

    def nextAction(self, obs) -> int:
        self._t += 1
        if self._rng.rand() < self.epsilon():
            return int(self._rng.randint(self.n))
        return self.inner.nextAction(obs)


# ----------------------------------------------------------------------- A3C
class A3CConfiguration:
    """ref: A3CConfiguration (rl4j async configs)."""

    def __init__(self, seed: int = 123, gamma: float = 0.99,
                 learning_rate: float = 7e-3, n_step: int = 16,
                 num_threads: int = 2, max_steps: int = 12000,
                 entropy_beta: float = 0.01, value_coef: float = 0.25,
                 max_episode_steps: int = 500):
        self.seed = seed
        self.gamma = gamma
        self.learning_rate = learning_rate
        self.n_step = n_step
        self.num_threads = num_threads
        self.max_steps = max_steps
        self.entropy_beta = entropy_beta
        self.value_coef = value_coef
        self.max_episode_steps = max_episode_steps


def _trunk(params, x, n_trunk: int):
    for i in range(n_trunk):
        x = torch.relu(x @ params[f"W{i}"] + params[f"b{i}"])
    return x


def _logits(params, x, n_trunk: int):
    return _trunk(params, x, n_trunk) @ params["Wpi"] + params["bpi"]


def _value(params, x, n_trunk: int):
    return (_trunk(params, x, n_trunk) @ params["Wv"] + params["bv"])[..., 0]


def _a3c_loss(params, obs, actions, returns, mask, *, beta, vc, n_trunk):
    """The JAX loss: rollouts arrive padded to ``n_step`` with a validity
    mask (one static shape, one captured graph)."""
    n = torch.clamp(mask.sum(), min=1.0)
    # log-softmax as z - logsumexp(z): the CPU's log_softmax runs each
    # [n_step, 2] batch on the whole OpenMP pool, whose spinning threads
    # starve the other threads of a busy host
    z = _logits(params, obs, n_trunk)
    logp = z - z.logsumexp(-1, keepdim=True)
    v = _value(params, obs, n_trunk)
    adv = (returns - v) * mask
    # per-rollout advantage normalization: keeps the policy gradient scale
    # independent of the (growing) return scale
    a = adv.detach()
    mean = a.sum() / n
    std = torch.sqrt(((a - mean) * mask).square().sum() / n)
    a = (a - mean) * mask / (std + 1e-6)
    pg = -(logp.gather(1, actions[:, None])[:, 0] * a).sum() / n
    v_loss = adv.square().sum() / n
    entropy = -((logp.exp() * logp).sum(1) * mask).sum() / n
    return pg + vc * v_loss - beta * entropy


def _a3c_step(params, opt_state, t, obs, actions, returns, mask, *, beta, vc,
              lr, n_trunk, b1=0.9, b2=0.999, eps=1e-8):
    """One learner update: the loss's gradients, then DL4J's Adam at step
    ``t + 1``; ``params``, ``opt_state`` (m, v) and the int clock ``t``
    change in place. Returns the loss on the device."""
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        loss = _a3c_loss(leaves, obs, actions, returns, mask, beta=beta,
                         vc=vc, n_trunk=n_trunk)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    with torch.no_grad():
        tf = t.float() + 1.0
        alpha = lr * torch.sqrt(1 - b2 ** tf) / (1 - b1 ** tf)
        for k, g in zip(names, grads):
            m, v = opt_state[k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g.square())
            params[k].sub_(alpha * m / (torch.sqrt(v) + eps))
        t.add_(1)
    return loss.detach()


class A3CDiscreteDense:
    """ref: A3CDiscreteDense — advantage actor-critic over a dense MLP
    with shared trunk and separate policy/value heads, on ``device``
    (``cuda`` unless the caller names another)."""

    def __init__(self, mdp_factory: Callable[[int], MDP],
                 conf: A3CConfiguration = None,
                 hidden: Tuple[int, ...] = (64,), device=None):
        self.conf = conf or A3CConfiguration()
        self.device = dev = resolve_device(device)
        self.mdp_factory = mdp_factory
        probe = mdp_factory(0)
        self.obs_dim = int(np.prod(probe.getObservationSpace().shape))
        self.n_actions = probe.getActionSpace().n
        probe.close()
        rng = np.random.RandomState(self.conf.seed)
        trunk_sizes = [self.obs_dim, *hidden]
        self._n_trunk = len(trunk_sizes) - 1
        self.params: Dict[str, torch.Tensor] = _mlp_init(rng, trunk_sizes,
                                                         dev)
        H = trunk_sizes[-1]
        lim = float(np.sqrt(6.0 / (H + self.n_actions)))
        self.params["Wpi"] = torch.from_numpy(rng.uniform(
            -lim, lim, (H, self.n_actions)).astype(np.float32)).to(dev)
        self.params["bpi"] = torch.zeros(self.n_actions, device=dev)
        limv = float(np.sqrt(6.0 / (H + 1)))
        self.params["Wv"] = torch.from_numpy(rng.uniform(
            -limv, limv, (H, 1)).astype(np.float32)).to(dev)
        self.params["bv"] = torch.zeros(1, device=dev)
        self.opt_state = {k: (torch.zeros_like(p), torch.zeros_like(p))
                          for k, p in self.params.items()}
        self._t = torch.zeros((), dtype=torch.int32, device=dev)
        c = self.conf
        kw = dict(beta=c.entropy_beta, vc=c.value_coef, lr=c.learning_rate,
                  n_trunk=self._n_trunk)

        def step(obs, actions, returns, mask):
            return _a3c_step(self.params, self.opt_state, self._t, obs,
                             actions, returns, mask, **kw)
        self._dispatch = cc.CachedDispatch(
            step, "rl:a3c", state=lambda: cc.state_tensors(
                self.params, self.opt_state, self._t), always_capture=True)
        self.episode_rewards: List[float] = []
        self._lock = InstrumentedLock("rl:a3c")
        self._worker_error = None

    # ---------------------------------------------------------- networks
    def _pi_fn(self, params, x):
        with torch.no_grad():
            return _logits(params, torch.as_tensor(
                np.asarray(x, np.float32), device=self.device),
                self._n_trunk)

    def _value_fn(self, params, x):
        with torch.no_grad():
            return _value(params, torch.as_tensor(
                np.asarray(x, np.float32), device=self.device),
                self._n_trunk)

    # ------------------------------------------------------------ training
    def _worker(self, wid: int, rollouts: "queue.Queue",
                stop: threading.Event):
        try:
            self._worker_body(wid, rollouts, stop)
        except BaseException as e:   # surface worker crashes to train()
            with self._lock:
                if self._worker_error is None:
                    self._worker_error = e
            stop.set()

    def _worker_body(self, wid: int, rollouts: "queue.Queue",
                     stop: threading.Event):
        mdp = self.mdp_factory(self.conf.seed + 100 + wid)
        rng = np.random.RandomState(self.conf.seed + 200 + wid)
        gamma = self.conf.gamma
        obs = mdp.reset()
        ep_reward, ep_steps = 0.0, 0
        while not stop.is_set():
            traj_o, traj_a, traj_r = [], [], []
            done = False
            for _ in range(self.conf.n_step):
                with self._lock:
                    logits = _host(self._pi_fn(
                        self.params, np.asarray(obs, np.float32)[None]))[0]
                p = np.exp(logits.astype(np.float64) - logits.max())
                p /= p.sum()
                a = int(rng.choice(self.n_actions, p=p))
                nxt, r, done = mdp.step(a)
                traj_o.append(np.asarray(obs, np.float32))
                traj_a.append(a)
                traj_r.append(r)
                ep_reward += r
                ep_steps += 1
                obs = nxt
                if done or ep_steps >= self.conf.max_episode_steps:
                    break
            # n-step discounted returns bootstrapped from V(s_T)
            if done or ep_steps >= self.conf.max_episode_steps:
                boot = 0.0
                with self._lock:    # every worker appends here
                    self.episode_rewards.append(ep_reward)
                obs = mdp.reset()
                ep_reward, ep_steps = 0.0, 0
            else:
                with self._lock:
                    boot = float(_host(self._value_fn(
                        self.params, np.asarray(obs, np.float32)[None]))[0])
            rets = np.zeros(len(traj_r), np.float32)
            acc = boot
            for i in reversed(range(len(traj_r))):
                acc = traj_r[i] + gamma * acc
                rets[i] = acc
            T = len(traj_r)
            n = self.conf.n_step
            obs_p = np.zeros((n, self.obs_dim), np.float32)
            obs_p[:T] = np.stack(traj_o)
            act_p = np.zeros((n,), np.int64)
            act_p[:T] = traj_a
            ret_p = np.zeros((n,), np.float32)
            ret_p[:T] = rets
            mask = np.zeros((n,), np.float32)
            mask[:T] = 1.0
            rollouts.put((obs_p, act_p, ret_p, mask))
        mdp.close()

    def _update(self, obs, actions, rets, mask):
        """One learner step from a host rollout, under the A3C lock."""
        dev = self.device
        args = [torch.from_numpy(a).to(dev) for a in (obs, actions, rets,
                                                       mask)]
        with self._lock:
            return self._dispatch(*args)

    def train(self) -> "A3CDiscreteDense":
        """Run workers + learner until max_steps env steps are consumed."""
        with self._lock:            # BEFORE workers start: a crash during
            self._worker_error = None   # startup must not be erased
        # a rollout a worker waiting at most: the JAX queue holds 64 but
        # stays near empty, its learner's step being one compiled call
        # far quicker than a rollout; the port's eager step on the CPU is
        # not, and a deeper queue there fills with stale rollouts that
        # collapse the policy
        rollouts: "queue.Queue" = queue.Queue(maxsize=self.conf.num_threads)
        stop = threading.Event()
        workers = [threading.Thread(target=self._worker,
                                    args=(i, rollouts, stop), daemon=True)
                   for i in range(self.conf.num_threads)]
        for w in workers:
            w.start()
        consumed = 0
        try:
            while consumed < self.conf.max_steps:
                try:
                    obs, actions, rets, mask = rollouts.get(timeout=60.0)
                except queue.Empty:
                    if self._worker_error is not None:
                        raise RuntimeError("A3C worker died") \
                            from self._worker_error
                    raise
                consumed += int(mask.sum())
                self._update(obs, actions, rets, mask)
        finally:
            stop.set()
            # drain so workers blocked on put() can observe stop and exit
            try:
                while True:
                    rollouts.get_nowait()
            except queue.Empty:
                pass
            for w in workers:
                w.join(timeout=5.0)
        return self

    # -------------------------------------------------------------- policy
    def getPolicy(self, deterministic: bool = True) -> ACPolicy:
        """ref: A3CDiscreteDense.getPolicy -> ACPolicy."""
        return ACPolicy(self._pi_fn, self.params,
                        deterministic=deterministic, seed=self.conf.seed)

    def evaluate(self, episodes: int = 10, max_steps: int = 500) -> float:
        mdp = self.mdp_factory(self.conf.seed + 999)
        pol = self.getPolicy(deterministic=True)
        total = [pol.play(mdp, max_steps=max_steps) for _ in range(episodes)]
        mdp.close()
        return float(np.mean(total))

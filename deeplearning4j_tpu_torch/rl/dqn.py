"""Deep Q-learning — the port of ``deeplearning4j_tpu/rl/dqn.py`` (ref:
``org.deeplearning4j.rl4j.learning.sync.qlearning.discrete.
QLearningDiscreteDense`` + ``QLearningConfiguration`` + ``ExpReplay``).

The replay buffer and the environment live on the host, with the JAX
package's numpy draws: from the same seeds the initial parameters, the
replay batches and the exploration match it draw for draw. The TD update
(online and target network, the Bellman backup, Adam) is one function on
the card, ``_td_step``, which updates the parameters, the Adam moments and
the step clock in place, run through
:class:`~..nn.compilecache.CachedDispatch` (scope ``"rl:dqn"``): one
captured CUDA graph replayed an update. The target network is a copy
refreshed in place every ``target_dqn_update_freq`` updates, so the
captured graph keeps reading it where it recorded it. Double-DQN action
selection.

The step's Adam is the JAX step's own, with eps after the bias correction
(``p - lr * m_hat / (sqrt(v_hat) + eps)``), not DL4J's updater.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.nn import compilecache as cc
from deeplearning4j_tpu_torch.rl.mdp import MDP


@dataclass
class QLearningConfiguration:
    """ref: QLearning.QLConfiguration."""
    seed: int = 123
    max_epoch_step: int = 200
    max_step: int = 15000
    exp_repeat: int = 1
    batch_size: int = 64
    target_dqn_update_freq: int = 200
    update_start: int = 500
    reward_factor: float = 1.0
    gamma: float = 0.99
    error_clamp: float = 1.0
    min_epsilon: float = 0.05
    epsilon_nb_step: int = 3000
    exp_replay_size: int = 10000
    learning_rate: float = 1e-3
    double_dqn: bool = True


class ExpReplay:
    """Uniform ring-buffer replay (ref: org.deeplearning4j.rl4j.util
    ExpReplay)."""

    def __init__(self, capacity: int, obs_dim: int, seed: int):
        self.capacity = capacity
        self._rng = np.random.RandomState(seed)
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros(capacity, np.int32)
        self.rewards = np.zeros(capacity, np.float32)
        self.dones = np.zeros(capacity, np.float32)
        self._n = 0
        self._pos = 0

    def store(self, s, a, r, s2, done):
        i = self._pos
        self.obs[i] = s
        self.actions[i] = a
        self.rewards[i] = r
        self.next_obs[i] = s2
        self.dones[i] = float(done)
        self._pos = (i + 1) % self.capacity
        self._n = min(self._n + 1, self.capacity)

    def __len__(self):
        return self._n

    def getBatch(self, size: int):
        idx = self._rng.randint(0, self._n, size)
        return (self.obs[idx], self.actions[idx], self.rewards[idx],
                self.next_obs[idx], self.dones[idx])


def _mlp_init(rng: np.random.RandomState, sizes: List[int],
              device) -> Dict[str, torch.Tensor]:
    """Glorot-uniform weights and zero biases from ``rng``'s draws (the
    JAX package's, in its order), as tensors on ``device``."""
    params = {}
    for i in range(len(sizes) - 1):
        lim = np.sqrt(6.0 / (sizes[i] + sizes[i + 1]))
        params[f"W{i}"] = torch.from_numpy(
            rng.uniform(-lim, lim, (sizes[i], sizes[i + 1]))
            .astype(np.float32)).to(device)
        params[f"b{i}"] = torch.zeros(sizes[i + 1], dtype=torch.float32,
                                      device=device)
    return params


def _mlp_apply(params: Dict, x, n_layers: int):
    for i in range(n_layers):
        x = x @ params[f"W{i}"] + params[f"b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return x


def _host(x) -> np.ndarray:
    """A network's output (or anything array-like) as a host array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _td_step(params, target_params, opt_state, t, s, a, r, s2, done, *,
             gamma, clamp, lr, n_layers, double, b1=0.9, b2=0.999,
             eps=1e-8):
    """One TD update, as the JAX step: the clipped-error loss on the
    online network against the (double-)DQN target, then Adam with eps
    after the bias correction. ``params``, ``opt_state`` (m, v) and the
    clock ``t`` (fp32, the update's number after this call) change in
    place; returns the loss on the device."""
    t.add_(1)
    with torch.no_grad():
        q_next_t = _mlp_apply(target_params, s2, n_layers)
        if double:
            a_star = _mlp_apply(params, s2, n_layers).argmax(1)
            q_next = q_next_t.gather(1, a_star[:, None])[:, 0]
        else:
            q_next = q_next_t.max(1).values
        y = r + gamma * (1.0 - done) * q_next
    names = list(params)
    leaves = {k: params[k].detach().requires_grad_(True) for k in names}
    with torch.enable_grad():
        q = _mlp_apply(leaves, s, n_layers)
        q_sa = q.gather(1, a[:, None])[:, 0]
        d = q_sa - y
        # ref: errorClamp; jnp.clip's max-then-min (a tie splits its
        # gradient, as torch.maximum/minimum do)
        err = torch.minimum(torch.maximum(d, torch.full_like(d, -clamp)),
                            torch.full_like(d, clamp))
        loss = torch.mean(err * d)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    with torch.no_grad():
        c1, c2 = 1 - b1 ** t, 1 - b2 ** t
        for k, g in zip(names, grads):
            m, v = opt_state[k]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            params[k].sub_(lr * (m / c1) / (torch.sqrt(v / c2) + eps))
    return loss.detach()


class QLearningDiscreteDense:
    """ref: QLearningDiscreteDense — DQN over a dense MLP Q-network, on
    ``device`` (``cuda`` unless the caller names another)."""

    def __init__(self, mdp: MDP, conf: QLearningConfiguration = None,
                 hidden: Tuple[int, ...] = (64, 64), device=None):
        self.mdp = mdp
        self.conf = conf or QLearningConfiguration()
        self.device = resolve_device(device)
        self.obs_dim = int(np.prod(mdp.getObservationSpace().shape))
        self.n_actions = mdp.getActionSpace().n
        rng = np.random.RandomState(self.conf.seed)
        sizes = [self.obs_dim, *hidden, self.n_actions]
        self._n_layers = len(sizes) - 1
        self.params = _mlp_init(rng, sizes, self.device)
        self.target_params = {k: v.clone() for k, v in self.params.items()}
        self.opt_state = {k: (torch.zeros_like(v), torch.zeros_like(v))
                          for k, v in self.params.items()}
        self._t = torch.zeros((), dtype=torch.float32, device=self.device)
        self.replay = ExpReplay(self.conf.exp_replay_size, self.obs_dim,
                                self.conf.seed + 1)
        self._rng = np.random.RandomState(self.conf.seed + 2)
        c = self.conf
        kw = dict(gamma=c.gamma, clamp=c.error_clamp, lr=c.learning_rate,
                  n_layers=self._n_layers, double=c.double_dqn)

        def step(s, a, r, s2, done):
            return _td_step(self.params, self.target_params, self.opt_state,
                            self._t, s, a, r, s2, done, **kw)
        self._dispatch = cc.CachedDispatch(
            step, "rl:dqn", state=lambda: cc.state_tensors(
                self.params, self.opt_state, self._t), always_capture=True)
        self.episode_rewards: List[float] = []
        self.updates = 0

    def _q_fn(self, params, x):
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
            return _mlp_apply(params, x, self._n_layers)

    # ------------------------------------------------------------ epsilon
    def _epsilon(self, step: int) -> float:
        c = self.conf
        frac = min(1.0, step / max(c.epsilon_nb_step, 1))
        return 1.0 + frac * (c.min_epsilon - 1.0)

    def _act(self, obs, step: int) -> int:
        if self._rng.rand() < self._epsilon(step):
            return self.mdp.getActionSpace().randomAction(self._rng)
        q = _host(self._q_fn(self.params, np.ravel(obs)[None]))
        return int(q[0].argmax())

    def _update(self, s, a, r, s2, d):
        """One TD update from a host batch (its arrays copied once)."""
        dev = self.device
        return self._dispatch(
            torch.from_numpy(s).to(dev), torch.from_numpy(a).long().to(dev),
            torch.from_numpy(r).to(dev), torch.from_numpy(s2).to(dev),
            torch.from_numpy(d).to(dev))

    # ------------------------------------------------------------- training
    def train(self) -> "QLearningDiscreteDense":
        c = self.conf
        total = 0
        while total < c.max_step:
            obs = self.mdp.reset()
            ep_reward = 0.0
            for _ in range(c.max_epoch_step):
                a = self._act(obs, total)
                nxt, r, done = self.mdp.step(a)
                self.replay.store(np.ravel(obs), a, r * c.reward_factor,
                                  np.ravel(nxt), done)
                obs = nxt
                ep_reward += r
                total += 1
                if total >= c.update_start and len(self.replay) >= c.batch_size:
                    self._update(*self.replay.getBatch(c.batch_size))
                    self.updates += 1
                    if self.updates % c.target_dqn_update_freq == 0:
                        with torch.no_grad():
                            for k, v in self.params.items():
                                self.target_params[k].copy_(v)
                if done or total >= c.max_step:
                    break
            self.episode_rewards.append(ep_reward)
        return self

    # ------------------------------------------------------------- policy
    def getPolicy(self):
        """Greedy policy over the trained Q-network (ref: DQNPolicy)."""
        def policy(obs) -> int:
            q = _host(self._q_fn(self.params, np.ravel(obs)[None]))
            return int(q[0].argmax())
        return policy

    def evaluate(self, episodes: int = 10,
                 max_steps: Optional[int] = None) -> float:
        """Average greedy-policy return; episodes are CAPPED (an MDP with
        no internal terminal guarantee must not hang the evaluator)."""
        cap = max_steps if max_steps is not None \
            else 10 * self.conf.max_epoch_step
        policy = self.getPolicy()
        totals = []
        for _ in range(episodes):
            obs = self.mdp.reset()
            tot = 0.0
            for _ in range(cap):
                obs, r, done = self.mdp.step(policy(obs))
                tot += r
                if done:
                    break
            totals.append(tot)
        return float(np.mean(totals))

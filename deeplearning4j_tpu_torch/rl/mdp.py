"""MDP interface + built-in environments — the port's copy of
``deeplearning4j_tpu/rl/mdp.py`` (numpy only).

Reference parity: ``org.deeplearning4j.rl4j.mdp.MDP`` (+ the gym adapter
and toy MDPs the reference ships). The environment runs on the HOST (tiny
scalar dynamics); only the networks' math runs on the device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


class ObservationSpace:
    def __init__(self, shape):
        self.shape = tuple(shape)


class DiscreteActionSpace:
    def __init__(self, n: int):
        self.n = int(n)

    def randomAction(self, rng: np.random.RandomState) -> int:
        return int(rng.randint(self.n))


class MDP:
    """ref: org.deeplearning4j.rl4j.mdp.MDP."""

    def getObservationSpace(self) -> ObservationSpace:
        raise NotImplementedError

    def getActionSpace(self) -> DiscreteActionSpace:
        raise NotImplementedError

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> Tuple[np.ndarray, float, bool]:
        """-> (observation, reward, done)."""
        raise NotImplementedError

    def isDone(self) -> bool:
        raise NotImplementedError

    def close(self):
        pass


class CartPole(MDP):
    """Classic cart-pole balancing (ref: rl4j's gym CartPole-v0 usage;
    dynamics are the standard Barto-Sutton-Anderson equations)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LENGTH = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 200

    def __init__(self, seed: int = 0):
        self._rng = np.random.RandomState(seed)
        self._state = None
        self._steps = 0
        self._done = True

    def getObservationSpace(self):
        return ObservationSpace((4,))

    def getActionSpace(self):
        return DiscreteActionSpace(2)

    def reset(self):
        self._state = self._rng.uniform(-0.05, 0.05, 4)
        self._steps = 0
        self._done = False
        return self._state.astype(np.float32).copy()

    def isDone(self):
        return self._done

    def step(self, action: int):
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        total_mass = self.CART_MASS + self.POLE_MASS
        pm_l = self.POLE_MASS * self.POLE_HALF_LENGTH
        cos, sin = np.cos(theta), np.sin(theta)
        temp = (force + pm_l * theta_dot ** 2 * sin) / total_mass
        theta_acc = (self.GRAVITY * sin - cos * temp) / (
            self.POLE_HALF_LENGTH * (4.0 / 3.0
                                     - self.POLE_MASS * cos ** 2 / total_mass))
        x_acc = temp - pm_l * theta_acc * cos / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        theta += self.DT * theta_dot
        theta_dot += self.DT * theta_acc
        self._state = np.asarray([x, x_dot, theta, theta_dot])
        self._steps += 1
        self._done = bool(abs(x) > self.X_LIMIT
                          or abs(theta) > self.THETA_LIMIT
                          or self._steps >= self.MAX_STEPS)
        return self._state.astype(np.float32).copy(), 1.0, self._done

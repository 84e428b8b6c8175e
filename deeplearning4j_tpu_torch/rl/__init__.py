"""RL4J equivalent — the port of ``deeplearning4j_tpu/rl`` (ref: the
reference's rl4j module): MDP interface, built-in CartPole, DQN
(QLearningDiscreteDense) with experience replay, double-DQN targets and a
captured TD step, and A3C with the policy hierarchy (``rl.a3c``)."""

from deeplearning4j_tpu_torch.rl.mdp import (CartPole, DiscreteActionSpace,
                                             MDP, ObservationSpace)
from deeplearning4j_tpu_torch.rl.dqn import (ExpReplay,
                                             QLearningConfiguration,
                                             QLearningDiscreteDense)

__all__ = ["MDP", "CartPole", "ObservationSpace", "DiscreteActionSpace",
           "QLearningDiscreteDense", "QLearningConfiguration", "ExpReplay"]

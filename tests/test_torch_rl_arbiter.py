"""The port's RL (``deeplearning4j_tpu_torch.rl``) and Arbiter
(``deeplearning4j_tpu_torch.arbiter``) against the JAX package's
(``tests/test_rl_arbiter.py``), on the CPU.

- CartPole, ``ExpReplay``, epsilon, the policies and the arbiter's
  generators and runner: exactly (host code over the same numpy draws).
- One TD step (single and double DQN) and one A3C update from the same
  parameters and batch: parameters, Adam moments and loss within 1e-5
  (fp32, one update; the reductions sum in another order).
- Bounded learning runs at the JAX tests' configurations: DQN on
  CartPole (``evaluate(10)`` > 80), A3C's "solved" rule, the runner over
  the port's networks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from deeplearning4j_tpu import arbiter as jarb
from deeplearning4j_tpu import rl as jrl
from deeplearning4j_tpu.rl import a3c as ja3c
from deeplearning4j_tpu_torch import arbiter as tarb
from deeplearning4j_tpu_torch import rl as trl
from deeplearning4j_tpu_torch.rl import a3c as ta3c

TOL = 1e-5


# ---------------------------------------------------------------- exact
def test_cartpole_steps_equal_the_jax_ones():
    for seed in (0, 1, 5):
        a, b = trl.CartPole(seed=seed), jrl.CartPole(seed=seed)
        np.testing.assert_array_equal(a.reset(), b.reset())
        acts = np.random.RandomState(seed).randint(0, 2, 400)
        for act in acts:
            sa, ra, da = a.step(int(act))
            sb, rb, db = b.step(int(act))
            np.testing.assert_array_equal(sa, sb)
            assert (ra, da) == (rb, db)
            if da:
                np.testing.assert_array_equal(a.reset(), b.reset())
        assert a.getActionSpace().n == b.getActionSpace().n == 2
        assert a.getObservationSpace().shape == (4,)


def test_cartpole_dynamics_and_termination():
    """The JAX test: a constant push falls over before the cap."""
    env = trl.CartPole(seed=0)
    env.reset()
    total, steps, done = 0.0, 0, False
    while not done:
        _, r, done = env.step(1)
        total += r
        steps += 1
    assert steps < trl.CartPole.MAX_STEPS and total == steps


def test_exp_replay_equals_the_jax_one():
    a = trl.ExpReplay(capacity=8, obs_dim=3, seed=0)
    b = jrl.ExpReplay(capacity=8, obs_dim=3, seed=0)
    for i in range(12):          # wraps past capacity
        for rep in (a, b):
            rep.store(np.full(3, i, np.float32), i % 2, float(i),
                      np.full(3, i + 1, np.float32), i % 3 == 0)
    assert len(a) == len(b) == 8
    for size in (16, 5):
        for x, y in zip(a.getBatch(size), b.getBatch(size)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    assert a.getBatch(16)[2].min() >= 4.0


def test_epsilon_and_exploration_equal_the_jax_ones():
    conf = dict(seed=2, max_step=400, update_start=100, batch_size=32,
                epsilon_nb_step=300)
    t = trl.QLearningDiscreteDense(trl.CartPole(seed=3),
                                   trl.QLearningConfiguration(**conf),
                                   hidden=(16,), device="cpu")
    j = jrl.QLearningDiscreteDense(jrl.CartPole(seed=3),
                                   jrl.QLearningConfiguration(**conf),
                                   hidden=(16,))
    for step in (0, 1, 150, 299, 300, 5000):
        assert t._epsilon(step) == j._epsilon(step)
    # the same initial parameters from the same draws
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v))
    # exploring steps take the same actions (the greedy ones compare the
    # same Q-network: equal argmax)
    obs = np.zeros(4, np.float32)
    for step in range(0, 600, 7):
        assert t._act(obs, step) == j._act(obs, step)


def _fake_net(params, x):
    return np.asarray([[0.0, 10.0]])


def _fake_jax_net(params, x):
    return jnp.asarray([[0.0, 10.0]])


def test_policies_equal_the_jax_ones():
    pol, jpol = ta3c.DQNPolicy(_fake_net, {}), ja3c.DQNPolicy(_fake_jax_net,
                                                              {})
    assert pol.nextAction(np.zeros(4)) == jpol.nextAction(np.zeros(4)) == 1
    ac = ta3c.ACPolicy(_fake_net, {}, deterministic=True)
    assert ac.nextAction(np.zeros(4)) == 1
    # stochastic actor: the same seeded choices
    logits = np.asarray([[0.3, -0.2, 0.1]], np.float32)
    ac = ta3c.ACPolicy(lambda p, x: torch.from_numpy(logits), {}, seed=4)
    jac = ja3c.ACPolicy(lambda p, x: jnp.asarray(logits), {}, seed=4)
    assert [ac.nextAction(np.zeros(4)) for _ in range(50)] == \
        [jac.nextAction(np.zeros(4)) for _ in range(50)]
    eg = ta3c.EpsGreedy(pol, action_space_n=2, eps_start=1.0, eps_end=0.05,
                        anneal_steps=30, seed=0)
    jeg = ja3c.EpsGreedy(jpol, action_space_n=2, eps_start=1.0,
                         eps_end=0.05, anneal_steps=30, seed=0)
    assert [eg.nextAction(np.zeros(4)) for _ in range(60)] == \
        [jeg.nextAction(np.zeros(4)) for _ in range(60)]
    assert eg.epsilon() == jeg.epsilon()
    explore = ta3c.EpsGreedy(pol, 2, 1.0, 1.0, 1, seed=0)
    assert {explore.nextAction(np.zeros(4)) for _ in range(50)} == {0, 1}


SPACES = {"lr": ("ContinuousSpace", (1e-4, 1e-1), {"log": True}),
          "m": ("ContinuousSpace", (0.0, 0.9), {}),
          "n": ("IntegerSpace", (2, 5), {}),
          "act": ("DiscreteSpace", (["relu", "tanh", "elu"],), {})}


def _spaces(pkg):
    return {k: getattr(pkg, cls)(*args, **kw)
            for k, (cls, args, kw) in SPACES.items()}


def test_generators_equal_the_jax_ones():
    it, jit = iter(tarb.RandomSearchGenerator(_spaces(tarb), seed=3)), \
        iter(jarb.RandomSearchGenerator(_spaces(jarb), seed=3))
    for _ in range(30):
        c, jc = next(it), next(jit)
        assert c == jc
        assert 1e-4 <= c["lr"] <= 1e-1 and 2 <= c["n"] <= 5
    for shuffle in (False, True):
        g = list(tarb.GridSearchCandidateGenerator(
            _spaces(tarb), discretization_count=3, shuffle=shuffle, seed=1))
        jg = list(jarb.GridSearchCandidateGenerator(
            _spaces(jarb), discretization_count=3, shuffle=shuffle, seed=1))
        assert g == jg and len(g) == 3 * 3 * 3 * 3
    assert tarb.CategoricalSpace is tarb.DiscreteSpace
    assert tarb.IntegerSpace(2, 3).grid(5) == jarb.IntegerSpace(2, 3).grid(5)


def test_runner_equals_the_jax_one():
    def score(cand):
        return (cand["lr"] - 0.2) ** 2 + (0.1 if cand["units"] != 16 else 0)

    def run(pkg, **kw):
        runner = pkg.OptimizationRunner(pkg.OptimizationConfiguration(
            candidate_generator=pkg.GridSearchCandidateGenerator(
                {"lr": pkg.ContinuousSpace(0.0, 0.4),
                 "units": pkg.DiscreteSpace([8, 16])},
                discretization_count=5),
            score_function=score, **kw))
        return runner, runner.execute()
    for kw in ({"max_candidates": 10, "minimize": True},
               {"max_candidates": 4, "minimize": False}):
        (r, best), (jr, jbest) = run(tarb, **kw), run(jarb, **kw)
        assert best.candidate == jbest.candidate and best.index == jbest.index
        assert [x.score for x in r.results] == [x.score for x in jr.results]
        assert r.numCandidatesCompleted() == jr.numCandidatesCompleted()
    r, best = run(tarb, max_candidates=10)
    assert best.candidate["lr"] == pytest.approx(0.2)
    assert best.candidate["units"] == 16
    nan_runner = tarb.OptimizationRunner(tarb.OptimizationConfiguration(
        candidate_generator=tarb.GridSearchCandidateGenerator(
            {"x": tarb.DiscreteSpace([1, 2])}), score_function=lambda c:
        float("nan")))
    with pytest.raises(RuntimeError, match="non-finite"):
        nan_runner.execute()


# ------------------------------------------------------- one update each
def _td_pair(double, seed=4):
    conf = dict(seed=seed, batch_size=32, learning_rate=3e-3,
                double_dqn=double, gamma=0.9, error_clamp=0.5)
    t = trl.QLearningDiscreteDense(trl.CartPole(seed=0),
                                   trl.QLearningConfiguration(**conf),
                                   hidden=(24, 16), device="cpu")
    j = jrl.QLearningDiscreteDense(jrl.CartPole(seed=0),
                                   jrl.QLearningConfiguration(**conf),
                                   hidden=(24, 16))
    # a target network that differs from the online one
    rng = np.random.RandomState(seed + 10)
    for k, v in j.params.items():
        tgt = (np.asarray(v) + rng.randn(*v.shape).astype(np.float32) * 0.1)
        j.target_params[k] = jnp.asarray(tgt)
        t.target_params[k].copy_(torch.from_numpy(tgt))
    return t, j


@pytest.mark.parametrize("double", [False, True], ids=["dqn", "double_dqn"])
def test_one_td_step_equals_the_jax_step(double):
    t, j = _td_pair(double)
    rng = np.random.RandomState(7)
    batch = (rng.randn(32, 4).astype(np.float32),
             rng.randint(0, 2, 32).astype(np.int32),
             rng.rand(32).astype(np.float32),
             rng.randn(32, 4).astype(np.float32),
             (rng.rand(32) < 0.2).astype(np.float32))
    for step in range(2):       # the second step runs Adam from moments
        jp, js, jloss = j._step_fn(j.params, j.target_params, j.opt_state,
                                   jnp.asarray(step + 1, jnp.float32),
                                   *map(jnp.asarray, batch))
        j.params, j.opt_state = jp, js
        loss = t._update(*batch)
    assert float(t._t) == 2.0
    assert abs(float(loss) - float(jloss)) <= TOL * max(1.0, abs(float(jloss)))
    for k in jp:
        np.testing.assert_allclose(t.params[k].numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL)
        for a, b in zip(t.opt_state[k], js[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=1e-9)


def test_one_a3c_update_equals_the_jax_update():
    conf = dict(seed=7, n_step=16, learning_rate=7e-3)
    t = ta3c.A3CDiscreteDense(trl.CartPole, ta3c.A3CConfiguration(**conf),
                              hidden=(32,), device="cpu")
    j = ja3c.A3CDiscreteDense(jrl.CartPole, ja3c.A3CConfiguration(**conf),
                              hidden=(32,))
    for k, v in j.params.items():
        np.testing.assert_array_equal(t.params[k].numpy(), np.asarray(v))
    rng = np.random.RandomState(3)
    for T in (16, 9):           # a full rollout, then a masked one
        obs = rng.randn(16, 4).astype(np.float32)
        act = rng.randint(0, 2, 16)
        rets = (rng.rand(16) * 10).astype(np.float32)
        mask = (np.arange(16) < T).astype(np.float32)
        jp, js, j._t, jloss = j._step_fn(
            j.params, j.opt_state, j._t, jnp.asarray(obs),
            jnp.asarray(act.astype(np.int32)), jnp.asarray(rets),
            jnp.asarray(mask))
        j.params, j.opt_state = jp, js
        loss = t._update(obs, act.astype(np.int64), rets, mask)
        assert abs(float(loss) - float(jloss)) <= TOL * max(1.0,
                                                            abs(float(jloss)))
    assert int(t._t) == int(j._t) == 2
    for k in jp:
        np.testing.assert_allclose(t.params[k].numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL)
        for a, b in zip(t.opt_state[k], js[k]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=TOL,
                                       atol=1e-9)
    assert t._dispatch.scope == "rl:a3c" and t._lock.name == "rl:a3c"


# --------------------------------------------------- bounded learning runs
def test_dqn_learns_cartpole():
    """The JAX test's configuration: 6,000 steps, hidden 48 x 48."""
    conf = trl.QLearningConfiguration(
        seed=1, max_step=6000, epsilon_nb_step=2500, update_start=300,
        target_dqn_update_freq=250, learning_rate=1e-3, batch_size=64)
    dqn = trl.QLearningDiscreteDense(trl.CartPole(seed=0), conf,
                                     hidden=(48, 48), device="cpu").train()
    avg = dqn.evaluate(10)
    assert avg > 80.0, avg
    assert dqn._dispatch.scope == "rl:dqn" and dqn.updates == 6000 - 300 + 1


def test_dqn_policy_is_greedy_and_deterministic():
    mdp = trl.CartPole(seed=3)
    conf = trl.QLearningConfiguration(seed=2, max_step=400, update_start=100,
                                      batch_size=32)
    dqn = trl.QLearningDiscreteDense(mdp, conf, hidden=(16,),
                                     device="cpu").train()
    policy = dqn.getPolicy()
    obs = mdp.reset()
    assert policy(obs) == policy(obs) and policy(obs) in (0, 1)


def test_a3c_solves_cartpole():
    """The JAX test's rule: train in 5k-step chunks (at most 12) until a
    10-episode window of training rewards exceeds 150 and the stochastic
    policy plays > 80 on fresh episodes."""
    conf = ta3c.A3CConfiguration(seed=7, num_threads=2, max_steps=5000,
                                 learning_rate=7e-3, n_step=32,
                                 max_episode_steps=200)
    a3c = ta3c.A3CDiscreteDense(trl.CartPole, conf, hidden=(64,),
                                device="cpu")

    def best_window(rs, w=10):
        if len(rs) < w:
            return 0.0
        return max(float(np.mean(rs[i:i + w]))
                   for i in range(len(rs) - w + 1))
    mdp = trl.CartPole(seed=3)
    solved = False
    for _ in range(12):
        a3c.train()
        if best_window(a3c.episode_rewards) <= 150.0:
            continue
        pol = a3c.getPolicy(deterministic=False)
        plays = [pol.play(mdp, max_steps=200) for _ in range(5)]
        if np.mean(plays) > 80.0:
            solved = True
            break
    assert solved, a3c.episode_rewards[-12:]


def test_the_runner_trains_port_networks():
    """The JAX test's search over real networks, on the port's
    MultiLayerNetwork: lr 3e-2 beats 1e-5."""
    from deeplearning4j_tpu_torch.data.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.config import (InputType,
                                                    NeuralNetConfiguration)
    from deeplearning4j_tpu_torch.nn.layers import DenseLayer, OutputLayer
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.train import updaters

    rng = np.random.RandomState(0)
    x = rng.randn(64, 4).astype(np.float32)
    y = np.eye(2, dtype=np.float32)[(x.sum(1) > 0).astype(int)]
    ds = DataSet(x, y)

    def score(cand):
        conf = (NeuralNetConfiguration.Builder().seed(7)
                .updater(updaters.Adam(cand["lr"])).list()
                .layer(DenseLayer(nOut=8, activation="relu"))
                .layer(OutputLayer(nOut=2, lossFunction="mcxent",
                                   activation="softmax"))
                .setInputType(InputType.feedForward(4)).build())
        net = MultiLayerNetwork(conf).init(device="cpu")
        for _ in range(15):
            net.fit(ds)
        return float(net.score()), net

    runner = tarb.OptimizationRunner(tarb.OptimizationConfiguration(
        candidate_generator=tarb.GridSearchCandidateGenerator(
            {"lr": tarb.DiscreteSpace([1e-5, 3e-2])},
            discretization_count=2),
        score_function=score, max_candidates=2, minimize=True,
        keep_models=True))
    best = runner.execute()
    assert best.candidate["lr"] == pytest.approx(3e-2)
    assert best.model is not None


def test_rl_runs_on_the_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trl.QLearningDiscreteDense(trl.CartPole())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ta3c.A3CDiscreteDense(trl.CartPole)

"""The port's RLlib part 2 against the JAX package's, on the CPU, no
cluster.

The same inputs, made with numpy from a seed, go through both packages;
the port's params are the JAX init, carried across by ``weights_from_jax``
(``set_weights(jax_policy.get_weights())``), and where the JAX package
draws noise with its PRNG keys the port is fed those same draws.
Tolerances are those of ``test_torch_rllib_parity.py``:

* the replay buffers (samples, importance weights, priorities) and the two
  multi-agent games over 200 seeded steps: equal exactly (numpy, copied);
  so are parameter noise's sigma sequence and the episode rewards of two
  whole QMIX ``step()``s;
* ``_perturb`` on the JAX package's own per-leaf draws and SAC's
  ``_sample_action`` logp on fixed noise: within 1e-6; QMIX's ``mix``
  within 1e-6 relative (it reaches ~60, where an f32 ulp is 4e-6);
* updates (RND, DQN with both ``double_q``, SAC, TD3 with its delay, DDPG,
  QMIX's three mixers, a multi-agent PPO policy): params within rtol 1e-4,
  atol 1e-6; stats within 1e-5 relative, of the stat or of a floor where
  it is a mean of terms that nearly cancel: ``STAT_FLOOR`` = 1.0 for the
  Q-learning losses and TD errors (differences of Q-values of size ~1,
  f32 rounding of each term alone moves them by ~1e-7 absolute) and SAC's
  and TD3's actor losses (means of ``alpha * logp - Q`` whose terms are
  of size ~1), ``LOGP_SCALE`` = 0.69 for PPO's as in part 1.  In QMIX's
  single update, an element whose grad is zero in exact arithmetic (f32
  leaves ~1e-9 of either sign) is held to lr, the most Adam's first step
  moves it (see the case);
* DQN's epsilon-greedy actions over 50 steps: equal exactly;
* ``tree_leaves`` equals ``jax.tree.leaves`` on each part-2 weight tree,
  and DQN, SAC and QMIX checkpoints restore across the packages both ways.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import rllib as jrl
from ray_tpu.rllib import exploration as jexp
from ray_tpu.rllib import multi_agent as jma
from ray_tpu.rllib import qmix as jqmix
from ray_tpu.rllib import replay_buffer as jrb
from ray_tpu.rllib import sac as jsac
from ray_tpu_torch import rllib as trl
from ray_tpu_torch.rllib import exploration as texp
from ray_tpu_torch.rllib import multi_agent as tma
from ray_tpu_torch.rllib import policy as tpolicy
from ray_tpu_torch.rllib import qmix as tqmix
from ray_tpu_torch.rllib import replay_buffer as trb
from ray_tpu_torch.rllib import sac as tsac
from ray_tpu_torch.rllib.env import Space

CPU = {"device": "cpu"}
STAT_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
STAT_FLOOR = 1.0
LOGP_SCALE = 0.69
BOX = Space("box", shape=(1,), low=-2.0, high=2.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close_stats(js, ts, floor=STAT_FLOOR):
    assert set(js) == set(ts), (sorted(js), sorted(ts))
    for k in js:
        ref = max(abs(js[k]), floor)
        assert abs(js[k] - ts[k]) <= STAT_RTOL * ref, (k, js[k], ts[k])


def _close_params(jw, tw):
    jl, tl = jax.tree.leaves(jw), tpolicy.tree_leaves(tw)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        b = b.detach().numpy() if isinstance(b, torch.Tensor) else b
        np.testing.assert_allclose(np.asarray(a), b, **PARAM_TOL)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- buffers and envs, exactly ---------------------------------------------

def _transitions(rng, n, base=0):
    return trl.SampleBatch({
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": np.arange(base, base + n, dtype=np.float32),
        "dones": rng.random(n) < 0.1})


def test_replay_buffers_equal_exactly():
    rng = np.random.default_rng(0)
    adds = [_transitions(rng, 24, 24 * i) for i in range(3)]
    ju, tu = jrb.ReplayBuffer(40, seed=5), trb.ReplayBuffer(40, seed=5)
    jp = jrb.PrioritizedReplayBuffer(40, alpha=0.7, seed=5)
    tp = trb.PrioritizedReplayBuffer(40, alpha=0.7, seed=5)
    for b in adds:
        for a, c in ((ju, tu), (jp, tp)):
            np.testing.assert_array_equal(a.add(b), c.add(b))
    for s1, s2 in ((ju.sample(32), tu.sample(32)),
                   (jp.sample(32, beta=0.5), tp.sample(32, beta=0.5))):
        assert sorted(s1) == sorted(s2)
        for k in s1:
            np.testing.assert_array_equal(s1[k], s2[k])
    prios = np.abs(rng.normal(size=32)).astype(np.float32) * 3
    jp.update_priorities(s1["batch_indexes"], prios)
    tp.update_priorities(s2["batch_indexes"], prios)
    np.testing.assert_array_equal(jp._prios, tp._prios)
    assert jp._max_prio == tp._max_prio
    a, b = jp.sample(64, beta=0.4), tp.sample(64, beta=0.4)
    np.testing.assert_array_equal(a["batch_indexes"], b["batch_indexes"])
    np.testing.assert_array_equal(a["weights"], b["weights"])


@pytest.mark.parametrize("name", ["CoordinationGame-v0", "TwoStepGame-v0"])
def test_multi_agent_envs_bit_identical(name):
    envs = [mod.MA_ENV_REGISTRY[name]() for mod in (jma, tma)]
    obs = [e.reset(seed=3) for e in envs]
    rng = np.random.default_rng(4)
    n = envs[0].action_space.n
    for _ in range(200):
        for a in obs[0]:
            np.testing.assert_array_equal(obs[0][a], obs[1][a])
        acts = {a: int(rng.integers(n)) for a in envs[0].agents}
        outs = [e.step(acts) for e in envs]
        (o1, r1, d1, _), (o2, r2, d2, _) = outs
        assert (r1, d1) == (r2, d2)
        obs = [o1, o2]
        if d1["__all__"]:
            obs = [e.reset() for e in envs]


# -- exploration -----------------------------------------------------------

def test_parameter_noise_perturb_and_sigma():
    params = _np_tree({"net": jexp._mlp_init(jax.random.PRNGKey(1),
                                             (6, 16, 3)),
                       "pi": {"w": jnp.ones((3, 2)), "b": jnp.zeros(2)}})
    jpn = jexp.ParameterNoise(seed=3, initial_sigma=0.2)
    k = jax.random.split(jpn._rng)[1]
    leaves = jax.tree.leaves(params)
    draws = [jax.random.normal(kk, p.shape, p.dtype) for p, kk in
             zip(leaves, jax.random.split(k, len(leaves)))]
    want = jpn._perturb(params, k, jpn.sigma)
    got = texp._perturb(trl.weights_from_jax(params, "cpu"),
                        [_t(d) for d in draws], 0.2)
    for a, b in zip(jax.tree.leaves(want), tpolicy.tree_leaves(got)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)
    tpn = texp.ParameterNoise(seed=3, initial_sigma=0.2)
    rng = np.random.default_rng(0)
    for _ in range(40):
        clean = rng.integers(0, 3, 16)
        noisy = np.where(rng.random(16) < rng.random(), 1, clean)
        assert jpn.adapt_sigma(clean, noisy) == tpn.adapt_sigma(clean, noisy)


def test_rnd_errors_bonuses_and_predictor():
    jr = jexp.RNDCuriosity(6, seed=2)
    tr = texp.RNDCuriosity(6, seed=2, device="cpu")
    tr.target = trl.weights_from_jax(_np_tree(jr.target), "cpu")
    tr.predictor = trl.weights_from_jax(_np_tree(jr.predictor), "cpu")
    rng = np.random.default_rng(3)
    for _ in range(5):
        obs = rng.normal(size=(32, 6)).astype(np.float32)
        je = np.asarray(jr._errors_fn(jr.predictor, jr.target,
                                      jnp.asarray(obs)))
        te = texp._errors(tr.predictor, tr.target, _t(obs)).numpy()
        np.testing.assert_allclose(je, te, rtol=STAT_RTOL)
        np.testing.assert_allclose(jr.intrinsic_and_train(obs),
                                   tr.intrinsic_and_train(obs),
                                   rtol=STAT_RTOL)
    _close_params(jr.predictor, tr.predictor)


# -- DQN -------------------------------------------------------------------

def _dqn_pair(cfg):
    jpol = jrl.DQNPolicy(4, Space("discrete", n=3), dict(cfg), seed=0)
    tpol = trl.DQNPolicy(4, Space("discrete", n=3), {**cfg, **CPU}, seed=0)
    tpol.set_weights(jpol.get_weights())
    tpol.target_params = trl.weights_from_jax(
        _np_tree(jpol.target_params), "cpu")
    return jpol, tpol


@pytest.mark.parametrize("double_q", [True, False])
def test_dqn_updates_match_jax(double_q):
    jpol, tpol = _dqn_pair({"lr": 1e-3, "hiddens": (32, 32),
                            "double_q": double_q})
    rng = np.random.default_rng(1)
    buf = trb.PrioritizedReplayBuffer(256, seed=0)
    buf.add(trl.SampleBatch({
        "obs": rng.normal(size=(256, 4)).astype(np.float32),
        "next_obs": rng.normal(size=(256, 4)).astype(np.float32),
        "actions": rng.integers(0, 3, 256),
        "rewards": rng.normal(size=256).astype(np.float32),
        "dones": rng.random(256) < 0.2}))
    for i in range(3):
        batch = buf.sample(64, beta=0.4)
        js, ts = jpol.learn_on_batch(batch), tpol.learn_on_batch(batch)
        np.testing.assert_allclose(js.pop("td_errors"), ts.pop("td_errors"),
                                   rtol=STAT_RTOL, atol=STAT_RTOL)
        _close_stats(js, ts)
        _close_params(jpol.params, tpol.params)
        if i == 1:
            jpol.update_target()
            tpol.update_target()
        buf.update_priorities(batch["batch_indexes"],
                              np.linspace(0.1, 2.0, 64))


def test_dqn_epsilon_greedy_actions_equal():
    jpol, tpol = _dqn_pair({"epsilon_timesteps": 200})
    rng = np.random.default_rng(2)
    for _ in range(50):
        obs = rng.normal(size=(8, 4)).astype(np.float32)
        np.testing.assert_array_equal(jpol.compute_actions(obs)["actions"],
                                      tpol.compute_actions(obs)["actions"])


# -- SAC, TD3, DDPG --------------------------------------------------------

def _continuous_batch(rng, n=64, obs_dim=3):
    return trl.SampleBatch({
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "next_obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.uniform(-2, 2, (n, 1)).astype(np.float32),
        "rewards": rng.normal(size=n).astype(np.float32),
        "dones": rng.random(n) < 0.1})


def test_sac_sample_action_logp_within_1e6():
    actor = _np_tree(jsac._mlp_init(jax.random.PRNGKey(0), (3, 32, 2)))
    obs = np.random.default_rng(0).normal(size=(64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    eps = jax.random.normal(key, (64, 1))
    ja, jl = jsac._sample_action(actor, jnp.asarray(obs), key, 1, 2.0)
    ta, tl = tsac._sample_action(trl.weights_from_jax(actor, "cpu"),
                                 _t(obs), _t(eps), 1, 2.0)
    np.testing.assert_allclose(np.asarray(ja), ta.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), atol=1e-6)


def _jax_noise(jpol, n, act_dim=1, pair=True):
    """The draws the JAX policy's next update makes from its key."""
    k = jax.random.split(jpol._key)[1]
    if not pair:
        return _t(jax.random.normal(k, (n, act_dim)))
    k1, k2 = jax.random.split(k)
    return (_t(jax.random.normal(k1, (n, act_dim))),
            _t(jax.random.normal(k2, (n, act_dim))))


def _continuous_pair(jcls, tcls, cfg):
    jpol = jcls(3, BOX, dict(cfg), seed=0)
    tpol = tcls(3, BOX, {**cfg, **CPU}, seed=0)
    tpol.set_weights(jpol.get_weights())
    tpol.target = trl.weights_from_jax(_np_tree(jpol.target), "cpu")
    return jpol, tpol


def test_sac_updates_match_jax():
    cfg = {"hiddens": (32, 32), "actor_lr": 1e-3, "critic_lr": 1e-3,
           "alpha_lr": 1e-3, "tau": 0.1}
    jpol, tpol = _continuous_pair(jrl.SACPolicy, trl.SACPolicy, cfg)
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = _continuous_batch(rng)
        noise = _jax_noise(jpol, 64)
        _close_stats(jpol.learn_on_batch(batch),
                     tpol.learn_on_batch(batch, noise=noise))
        _close_params(jpol.params, tpol.params)
        _close_params(jpol.target, tpol.target)


def test_td3_and_ddpg_updates_match_jax():
    cfg = {"hiddens": (32, 32), "actor_lr": 1e-3, "critic_lr": 1e-3,
           "tau": 0.1, "policy_delay": 2}
    rng = np.random.default_rng(4)
    jpol, tpol = _continuous_pair(jrl.TD3Policy, trl.TD3Policy, cfg)
    for i in range(4):
        before = tpol.get_weights()["actor"], dict(tpol.target)
        batch = _continuous_batch(rng)
        noise = _jax_noise(jpol, 64, pair=False)
        ts = tpol.learn_on_batch(batch, noise=noise)
        _close_stats(jpol.learn_on_batch(batch), ts)
        _close_params(jpol.params, tpol.params)
        _close_params(jpol.target, tpol.target)
        moved = not np.array_equal(before[0][0]["w"],
                                   tpol.get_weights()["actor"][0]["w"])
        assert moved == (i % 2 == 0)
        assert (tpol.target["q1"] is not before[1]["q1"]) == (i % 2 == 0)
        if i % 2:
            assert ts["actor_loss"] == 0.0
    jpol, tpol = _continuous_pair(
        jrl.DDPGPolicy, trl.DDPGPolicy,
        {**cfg, "policy_delay": 1, "target_noise": 0.0,
         "target_noise_clip": 0.0})
    for _ in range(2):
        batch = _continuous_batch(rng)
        noise = _jax_noise(jpol, 64, pair=False)
        _close_stats(jpol.learn_on_batch(batch),
                     tpol.learn_on_batch(batch, noise=noise))
        _close_params(jpol.params, tpol.params)
        _close_params(jpol.target, tpol.target)


# -- QMIX ------------------------------------------------------------------

def test_qmix_mix_within_1e6():
    mp = _np_tree(jqmix.mixer_init(jax.random.PRNGKey(0), 2, 3, 8))
    rng = np.random.default_rng(5)
    state = rng.normal(size=(16, 3)).astype(np.float32)
    qs = rng.normal(size=(16, 2)).astype(np.float32)
    # Q_tot reaches ~60, where an f32 ulp is 4e-6: held relative.
    np.testing.assert_allclose(
        np.asarray(jqmix.mix(mp, jnp.asarray(qs), jnp.asarray(state))),
        tqmix.mix(trl.weights_from_jax(mp, "cpu"), _t(qs), _t(state)).numpy(),
        rtol=1e-6, atol=1e-6)


def _qmix_pair(**training):
    cfg = (jrl.QMIXConfig().environment("TwoStepGame-v0")
           .training(**training).debugging(seed=0).to_dict())
    ja, ta = jrl.QMIX(config=dict(cfg)), trl.QMIX(config={**cfg, **CPU})
    ta.q_params = trl.weights_from_jax(_np_tree(ja.q_params), "cpu")
    ta.m_params = trl.weights_from_jax(_np_tree(ja.m_params), "cpu")
    ta.t_q, ta.t_m = ta.q_params, ta.m_params
    return ja, ta


@pytest.mark.parametrize("mixer", ["qmix", "vdn", "none"])
def test_qmix_update_matches_jax(mixer):
    ja, ta = _qmix_pair(mixer=mixer, lr=1e-3)
    rng = np.random.default_rng(6)
    B = 32
    batch = {"obs": rng.normal(size=(B, 2, 5)).astype(np.float32),
             "actions": rng.integers(0, 2, (B, 2)).astype(np.int32),
             "rewards": rng.normal(size=B).astype(np.float32),
             "dones": rng.random(B) < 0.5,
             "state": rng.normal(size=(B, 3)).astype(np.float32),
             "next_obs": rng.normal(size=(B, 2, 5)).astype(np.float32),
             "next_state": rng.normal(size=(B, 3)).astype(np.float32)}
    (jq, jm), _, jloss = ja._update(
        (ja.q_params, ja.m_params), (ja.t_q, ja.t_m), ja.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()})
    _, grads = ta.loss_and_grads(ta.device_batch(batch))
    tloss = float(ta._update(ta.device_batch(batch)))
    _close_stats({"loss": float(jloss)}, {"loss": tloss})
    # Adam's first step moves an element by lr * g / (|g| + 1e-8): where a
    # grad is exactly zero in exact arithmetic (the huber's +-1/B terms
    # cancel over a hidden unit's rows), f32 summation order leaves
    # ~1e-9 of either sign, and that element moves by up to lr in either
    # package.  Those elements (|g| under 1e-6 of their leaf's max) are
    # held to lr; every other element to the params tolerance.
    for a, b, g in zip(jax.tree.leaves((jq, jm)),
                       tpolicy.tree_leaves((ta.q_params, ta.m_params)),
                       jax.tree.leaves(grads)):
        a, b = np.asarray(a), b.numpy()
        noise = np.abs(g) <= 1e-6 * np.abs(g).max()
        np.testing.assert_allclose(a[~noise], b[~noise], **PARAM_TOL)
        assert np.all(np.abs(a[noise] - b[noise]) <= 1e-3)


def test_qmix_two_steps_match_jax():
    ja, ta = _qmix_pair(learning_starts=16, train_batch_size=16,
                        epsilon_timesteps=24, target_network_update_freq=4,
                        lr=1e-3)
    for _ in range(2):
        jr, tr = ja.step(), ta.step()
        assert jr["episode_reward_mean"] == tr["episode_reward_mean"]
        assert jr["num_env_steps_sampled"] == tr["num_env_steps_sampled"]
        _close_stats({"loss": jr["loss"]}, {"loss": tr["loss"]})
    _close_params((ja.q_params, ja.m_params), (ta.q_params, ta.m_params))


# -- multi-agent PPO -------------------------------------------------------

def test_multi_agent_sampler_batches_and_update_match_jax():
    def cfg(pkg):
        c = (pkg.MultiAgentPPOConfig().environment("CoordinationGame-v0")
             .rollouts(num_envs_per_worker=2, rollout_fragment_length=8)
             .training(lr=1e-3, num_sgd_iter=2, sgd_minibatch_size=64)
             .multi_agent(policies={"a": {}, "b": {"hiddens": (32, 32)}},
                          policy_mapping_fn=lambda aid: "a"
                          if aid == "agent_0" else "b"))
        return {**c.to_dict(), **CPU}
    js = jma.MultiAgentRolloutSampler(cfg(jrl))
    ts = tma.MultiAgentRolloutSampler(cfg(trl))
    jb, tb = js.sample(), ts.sample()
    assert jb.count == tb.count == 16
    for pid in ("a", "b"):
        assert sorted(jb[pid]) == sorted(tb[pid])
        for k in jb[pid]:
            assert ((jb[pid][k].shape, jb[pid][k].dtype)
                    == (tb[pid][k].shape, tb[pid][k].dtype)), (pid, k)
        jp, tp = js.policies[pid], ts.policies[pid]
        tp.set_weights(jp.get_weights())
        _close_stats(jp.learn_on_batch(jb[pid]), tp.learn_on_batch(jb[pid]),
                     floor=LOGP_SCALE)
        _close_params(jp.get_weights(), tp.get_weights())


# -- trees and checkpoints -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _part_two_trees():
    k = jax.random.PRNGKey(0)
    sac = jrl.SACPolicy(3, BOX, {"hiddens": (8, 8)}, seed=0)
    td3 = jrl.TD3Policy(3, BOX, {"hiddens": (8, 8)}, seed=0)
    q = jqmix._mlp_init(k, (5, 8, 2))
    return {
        "sac_params": sac.params, "sac_target": sac.target,
        "td3_params": td3.params, "td3_target": td3.target,
        "exploration_mlp": jexp._mlp_init(k, (6, 8, 4)),
        "dqn": jrl.DQNPolicy(4, Space("discrete", n=2), {"hiddens": (8,)},
                             seed=0).params,
        "qmix_opt_tree": (q, jqmix.mixer_init(k, 2, 3, 4)),
        "vdn_opt_tree": (q, {}),
    }


TREES = ["sac_params", "sac_target", "td3_params", "td3_target",
         "exploration_mlp", "dqn", "qmix_opt_tree", "vdn_opt_tree"]


@pytest.mark.parametrize("name", TREES)
def test_tree_leaves_follow_jax_order(name):
    tree = _np_tree(_part_two_trees()[name])
    ported = trl.weights_from_jax(tree, "cpu")
    want = jax.tree.leaves(tree)
    got = tpolicy.tree_leaves(ported)
    assert len(want) == len(got) > 0
    for a, b in zip(want, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    back = tpolicy.tree_unflatten(ported, [x * 2 for x in got])
    assert (jax.tree.structure(tpolicy.tree_to_numpy(back))
            == jax.tree.structure(tree))


def _algo(pkg, name, seed):
    if name == "qmix":
        cfg = (pkg.QMIXConfig().environment("TwoStepGame-v0")
               .training(learning_starts=16, train_batch_size=16))
    elif name == "dqn":
        cfg = (pkg.DQNConfig().environment("CartPole-v1")
               .training(learning_starts=16, train_batch_size=16,
                         num_train_iters=2))
    else:
        cfg = (pkg.SACConfig().environment("Pendulum-v1")
               .training(learning_starts=16, train_batch_size=16,
                         num_train_iters=2, hiddens=(16, 16)))
    if name != "qmix":
        cfg = cfg.rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                           rollout_fragment_length=8)
    cfg = cfg.debugging(seed=seed)
    if pkg is trl:
        cfg = cfg.resources(device="cpu")
    return cfg.build()


def _weights(algo):
    if isinstance(algo, (jrl.QMIX, trl.QMIX)):
        state = algo.save_checkpoint()
        return {"q": state["q"], "m": state["m"]}
    return algo.get_policy().get_weights()


@pytest.mark.parametrize("name", ["dqn", "sac", "qmix"])
@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_checkpoints_cross(name, direction, tmp_path):
    from ray_tpu.air import Checkpoint as JCheckpoint
    from ray_tpu_torch.air import Checkpoint as TCheckpoint
    src_pkg, dst_pkg, dst_ckpt = ((trl, jrl, JCheckpoint)
                                  if direction == "torch_to_jax"
                                  else (jrl, trl, TCheckpoint))
    src = _algo(src_pkg, name, 0)
    for _ in range(2):
        src.train()
    path = src.save().to_directory(str(tmp_path / "ckpt"))
    want = _weights(src)
    src.stop()
    dst = _algo(dst_pkg, name, 1)
    dst.restore(dst_ckpt.from_directory(path))
    got = _weights(dst)
    dst.stop()
    assert jax.tree.structure(want) == jax.tree.structure(got)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

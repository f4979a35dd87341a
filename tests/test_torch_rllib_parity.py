"""The port's RLlib against the JAX package's, on the CPU, no cluster.

The same inputs, made with numpy from a seed, go through both packages;
the port's params are the JAX init carried across by ``weights_from_jax``
(``set_weights(jax_policy.get_weights())``).  Tolerances:

* the six envs, 4 envs each, 200 steps of one seeded action sequence:
  observations, rewards and dones bit-identical;
* ``compute_gae``, ``compute_mc_returns``, ES's centered ranks and
  perturbed evaluations, ``DatasetReader``'s minibatch order and the IS
  estimator: equal exactly (numpy, copied);
* ``ac_forward`` and the distributions' logp/entropy: within 1e-6;
* one update of PPO (dp 1 and dp 4 against JAX's dp 1; a minibatch that
  covers the whole batch, so JAX's permutation cannot change the
  minibatches), IMPALA, APPO, A2C, BC, MARWIL, CQL and the recurrent and
  attention PPO: stats within 1e-5 relative, params within rtol 1e-4,
  atol 1e-6 (the JAX package's own dp test tolerances).  A stat is held
  to 1e-5 of its own size or of the size of the logps it averages
  (~0.69), whichever is larger: the policy losses and PPO's ``approx_kl``
  are means of terms of that size that nearly cancel (normalized
  advantages sum to zero), and f32 rounding of the terms alone moves
  such a mean by ~1e-4 of itself;
* ``vtrace`` on fixed [8, 16] inputs: within 1e-6;
* ``lstm_seq_forward`` and ``attn_seq_forward`` on [T=16, n=4] with
  resets: within 1e-5;
* a ``RolloutWorker`` of each package returns batches with the same keys,
  shapes and dtypes, and a ``PPO`` checkpoint of each restores in the
  other;
* the policy registry resolves part 2's names (``dqn``, ``sac``, ``td3``,
  ``ddpg``) to classes named as the JAX package's (part 2's updates:
  ``test_torch_rllib_parity_offpolicy.py``).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu import rllib as jrl
from ray_tpu.rllib import catalog as jcatalog
from ray_tpu.rllib import es as jes
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib import policy as jpolicy
from ray_tpu.rllib import recurrent as jrecurrent
from ray_tpu.rllib import rollout_worker as jrw
from ray_tpu.rllib.env import make_vector_env as jmake
from ray_tpu_torch import rllib as trl
from ray_tpu_torch.rllib import catalog as tcatalog
from ray_tpu_torch.rllib import es as tes
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import offline as toffline
from ray_tpu_torch.rllib import policy as tpolicy
from ray_tpu_torch.rllib import recurrent as trecurrent
from ray_tpu_torch.rllib import rollout_worker as trw
from ray_tpu_torch.rllib.env import Space
from ray_tpu_torch.rllib.env import make_vector_env as tmake

CPU = {"device": "cpu"}
STAT_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-6)
LOGP_SCALE = 0.69


def _t(x):
    return torch.as_tensor(np.array(x))


def _close_stats(js, ts):
    assert set(js) == set(ts), (sorted(js), sorted(ts))
    for k in js:
        ref = max(abs(js[k]), LOGP_SCALE)
        assert abs(js[k] - ts[k]) <= STAT_RTOL * ref, (k, js[k], ts[k])


def _close_params(jw, tw):
    jl, tl = jax.tree.leaves(jw), tpolicy.tree_leaves(tw)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        np.testing.assert_allclose(np.asarray(a), b, **PARAM_TOL)


# -- envs ------------------------------------------------------------------

ENVS = ["CartPole-v1", "Pendulum-v1", "RepeatPrevious-v0", "SparseChain-v0",
        "BreakoutMini-v0", "FreewayMini-v0"]


@pytest.mark.parametrize("name", ENVS)
def test_envs_bit_identical(name):
    envs = [make(name, 4, seed=3) for make in (jmake, tmake)]
    obs = [e.vector_reset(seed=3) for e in envs]
    np.testing.assert_array_equal(obs[0], obs[1])
    space = envs[0].action_space
    rng = np.random.default_rng(7)
    for _ in range(200):
        if space.kind == "discrete":
            a = rng.integers(0, space.n, 4)
        else:
            a = rng.uniform(-2.0, 2.0, (4,) + tuple(space.shape)).astype(
                np.float32)
        (o1, r1, d1, _), (o2, r2, d2, _) = [e.vector_step(a) for e in envs]
        np.testing.assert_array_equal(o1, o2)
        np.testing.assert_array_equal(r1, r2)
        np.testing.assert_array_equal(d1, d2)


# -- numpy parts, exactly --------------------------------------------------

def test_gae_and_mc_returns_equal():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(32, 4)).astype(np.float32)
    v = rng.normal(size=(32, 4)).astype(np.float32)
    d = rng.random((32, 4)) < 0.1
    last = rng.normal(size=4).astype(np.float32)
    for a, b in zip(jpolicy.compute_gae(r, v, d, last, 0.99, 0.95),
                    tpolicy.compute_gae(r, v, d, last, 0.99, 0.95)):
        np.testing.assert_array_equal(a, b)
    flat_r, flat_d = r[:, 0].astype(np.float64), d[:, 0]
    np.testing.assert_array_equal(
        joffline.compute_mc_returns(flat_r, flat_d, 0.9),
        toffline.compute_mc_returns(flat_r, flat_d, 0.9))


def test_es_ranks_and_perturbed_evaluations_equal():
    x = np.random.default_rng(1).normal(size=(10, 2)).astype(np.float32)
    np.testing.assert_array_equal(jes._centered_ranks(x),
                                  tes._centered_ranks(x))
    cfg = {"env": "CartPole-v1", "hiddens": (8, 8), "episode_horizon": 60}
    workers = [mod.ESEvalWorker(dict(cfg), 2) for mod in (jes, tes)]
    n = sum(int(np.prod(s)) for s in workers[0].shapes)
    theta = np.random.default_rng(2).normal(size=n).astype(np.float32)
    outs = [w.evaluate(theta, [11, 12, 13], 0.1) for w in workers]
    assert outs[0] == outs[1]


def test_dataset_reader_order_and_is_estimator_equal(tmp_path):
    rng = np.random.default_rng(0)
    w = trl.DatasetWriter(str(tmp_path))
    for i in range(3):
        w.write(trl.SampleBatch({
            "obs": rng.normal(size=(20, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, 20),
            "action_logp": rng.normal(size=20).astype(np.float32) - 1.0,
            "rewards": rng.normal(size=20).astype(np.float32),
            "dones": rng.random(20) < 0.2}))
    readers = [mod.DatasetReader(str(tmp_path), seed=5)
               for mod in (joffline, toffline)]
    its = [r.iter_batches(16) for r in readers]
    for _ in range(8):
        a, b = next(its[0]), next(its[1])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    data = readers[0].read_all()

    class Target:
        def logp_for(self, obs, actions):
            return np.asarray(obs[:, 0] * 0.1 - 0.7, np.float32)

    assert (joffline.ImportanceSamplingEstimator(0.9).estimate(data, Target())
            == toffline.ImportanceSamplingEstimator(0.9).estimate(
                data, Target()))


# -- network and distributions ---------------------------------------------

def _jax_params(obs_dim, num_outputs, hiddens=(64, 64), value_head=True,
                seed=0):
    return jax.tree.map(np.asarray, jpolicy.ac_init(
        jax.random.PRNGKey(seed), obs_dim, num_outputs, hiddens,
        value_head=value_head))


def test_ac_forward_and_distributions_within_1e6():
    params = _jax_params(6, 4)
    tparams = trl.weights_from_jax(params, "cpu")
    obs = np.random.default_rng(0).normal(size=(32, 6)).astype(np.float32)
    jpi, jv = jpolicy.ac_forward(params, jnp.asarray(obs))
    tpi, tv = tpolicy.ac_forward(tparams, _t(obs))
    np.testing.assert_allclose(np.asarray(jpi), tpi.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-6)
    np.testing.assert_allclose(
        np.asarray(jpolicy.head_forward(params, jnp.asarray(obs))),
        tpolicy.head_forward(tparams, _t(obs)).numpy(), atol=1e-6)
    rng = np.random.default_rng(1)
    acts = rng.integers(0, 4, 32)
    cont = rng.normal(size=(32, 2)).astype(np.float32)
    out = (rng.normal(size=(32, 4)) * 3).astype(np.float32)
    for jd, td, a, o in ((jpolicy.Categorical, tpolicy.Categorical, acts,
                          np.asarray(jpi)),
                         (jpolicy.DiagGaussian, tpolicy.DiagGaussian, cont,
                          out)):
        np.testing.assert_allclose(
            np.asarray(jd.logp(jnp.asarray(o), jnp.asarray(a))),
            td.logp(_t(o), _t(a)).numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(jd.entropy(jnp.asarray(o))),
                                   td.entropy(_t(o)).numpy(), atol=1e-6)


def test_weights_from_jax_checks_the_tree():
    params = _jax_params(4, 2)
    with pytest.raises(TypeError, match="float32"):
        trl.weights_from_jax({**params, "pi": {
            "w": params["pi"]["w"].astype(np.float64),
            "b": params["pi"]["b"]}}, "cpu")
    with pytest.raises(ValueError, match="layer"):
        trl.weights_from_jax({**params, "pi": {
            "w": params["pi"]["w"], "b": np.zeros(3, np.float32)}}, "cpu")
    pol = trl.PPOPolicy(4, Space("discrete", n=2), dict(CPU), seed=0)
    with pytest.raises(ValueError, match="match"):
        pol.set_weights(_jax_params(4, 2, hiddens=(32, 32)))


# -- updates ---------------------------------------------------------------

def _ppo_batch(n, rng, obs_dim=4):
    return {
        "obs": rng.normal(size=(n, obs_dim)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "action_logp": np.full(n, -0.69, np.float32),
        "vf_preds": rng.normal(size=n).astype(np.float32) * 0.1,
        "advantages": rng.normal(size=n).astype(np.float32),
        "value_targets": rng.normal(size=n).astype(np.float32),
    }


@pytest.mark.parametrize("dp", [1, 4])
def test_ppo_update_matches_jax(dp):
    cfg = {"lr": 1e-3, "num_sgd_iter": 3, "sgd_minibatch_size": 64}
    batch = _ppo_batch(64, np.random.default_rng(1))
    jpol = jrl.PPOPolicy(4, Space("discrete", n=2), dict(cfg), seed=0)
    tpol = trl.PPOPolicy(4, Space("discrete", n=2),
                         {**cfg, **CPU, "num_learner_devices": dp}, seed=0)
    tpol.set_weights(jpol.get_weights())
    js = jpol.learn_on_batch(batch)
    ts = tpol.learn_on_batch(batch)
    _close_stats(js, ts)
    _close_params(jpol.get_weights(), tpol.get_weights())


def _seq_batch(rng, B=8, T=16):
    return {
        "obs": rng.normal(size=(B, T, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, (B, T)),
        "action_logp": (rng.normal(size=(B, T)) * 0.3 - 0.69).astype(
            np.float32),
        "rewards": rng.normal(size=(B, T)).astype(np.float32),
        "dones": rng.random((B, T)) < 0.1,
        "bootstrap_obs": rng.normal(size=(B, 4)).astype(np.float32),
    }


def test_vtrace_within_1e6():
    rng = np.random.default_rng(4)
    args = [rng.normal(size=(8, 16)).astype(np.float32) * 0.3 - 0.7
            for _ in range(2)]
    rewards = rng.normal(size=(8, 16)).astype(np.float32)
    dones = rng.random((8, 16)) < 0.15
    values = rng.normal(size=(8, 16)).astype(np.float32)
    boot = rng.normal(size=8).astype(np.float32)
    jout = jimpala.vtrace(*map(jnp.asarray, args), jnp.asarray(rewards),
                          jnp.asarray(dones), jnp.asarray(values),
                          jnp.asarray(boot), 0.99, 1.0, 0.9)
    tout = timpala.vtrace(*map(_t, args), _t(rewards), _t(dones),
                          _t(values), _t(boot), 0.99, 1.0, 0.9)
    for a, b in zip(jout, tout):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)


@pytest.mark.parametrize("algo,dp", [("impala", 1), ("impala", 4),
                                     ("appo", 1)])
def test_impala_and_appo_updates_match_jax(algo, dp):
    jcls = {"impala": jrl.ImpalaPolicy, "appo": jrl.APPOPolicy}[algo]
    tcls = {"impala": trl.ImpalaPolicy, "appo": trl.APPOPolicy}[algo]
    batch = _seq_batch(np.random.default_rng(3))
    cfg = {"lr": 1e-3, "hiddens": (32, 32)}
    jpol = jcls(4, Space("discrete", n=2), dict(cfg), seed=0)
    tpol = tcls(4, Space("discrete", n=2),
                {**cfg, **CPU, "num_learner_devices": dp}, seed=0)
    tpol.set_weights(jpol.get_weights())
    for _ in range(2):
        js = jpol.learn_on_batch(jimpala._to_device(batch))
        ts = tpol.learn_on_batch(timpala._to_device(batch, "cpu"))
        _close_stats(js, ts)
    _close_params(jpol.get_weights(), tpol.get_weights())


def test_a2c_update_matches_jax():
    batch = _ppo_batch(96, np.random.default_rng(5))
    jpol = jrl.A2CPolicy(4, Space("discrete", n=2), {"lr": 1e-3}, seed=0)
    tpol = trl.A2CPolicy(4, Space("discrete", n=2), {"lr": 1e-3, **CPU},
                         seed=0)
    tpol.set_weights(jpol.get_weights())
    for _ in range(2):
        _close_stats(jpol.learn_on_batch(batch), tpol.learn_on_batch(batch))
    _close_params(jpol.get_weights(), tpol.get_weights())


def _offline_minibatches(tmp_path, n=2):
    rng = np.random.default_rng(6)
    w = trl.DatasetWriter(str(tmp_path))
    for _ in range(2):
        w.write(trl.SampleBatch({
            "obs": rng.normal(size=(40, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, 40),
            "rewards": rng.normal(size=40).astype(np.float32),
            "next_obs": rng.normal(size=(40, 4)).astype(np.float32),
            "dones": rng.random(40) < 0.1}))
    data = toffline.DatasetReader(str(tmp_path)).read_all()
    data["returns"] = toffline.compute_mc_returns(
        np.asarray(data["rewards"], np.float64), data["dones"], 0.99)
    it = toffline.DatasetReader(str(tmp_path), seed=1).iter_batches(
        32, data=data)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("name", ["bc", "marwil"])
def test_bc_and_marwil_updates_match_jax(name, tmp_path):
    mbs = _offline_minibatches(tmp_path)
    jcls = {"bc": jrl.BCPolicy, "marwil": jrl.MARWILPolicy}[name]
    tcls = {"bc": trl.BCPolicy, "marwil": trl.MARWILPolicy}[name]
    cfg = {"lr": 1e-3, "beta": 1.0,
           "moving_average_sqd_adv_norm_start": 4.0}
    jpol = jcls(4, Space("discrete", n=2), dict(cfg), seed=0)
    tpol = tcls(4, Space("discrete", n=2), {**cfg, **CPU}, seed=0)
    tpol.set_weights(jpol.get_weights())
    for mb in mbs:
        _close_stats(jpol.learn_on_batch(mb), tpol.learn_on_batch(mb))
    _close_params(jpol.get_weights(), tpol.get_weights())
    np.testing.assert_allclose(
        jpol.logp_for(mbs[0]["obs"], mbs[0]["actions"]),
        tpol.logp_for(mbs[0]["obs"], mbs[0]["actions"]), atol=1e-6)


def test_cql_update_matches_jax(tmp_path):
    """The CQL update alone: each package's ``CQL._build_update`` on a
    stand-in for the local DQN policy (part 2), holding ``ac_init``'s
    trunk + pi head."""
    mbs = _offline_minibatches(tmp_path)
    params = _jax_params(4, 2, value_head=False)
    cfg = {"cql_alpha": 0.5, "gamma": 0.99, "lr": 5e-4}

    def algo(cls, policy):
        a = cls.__new__(cls)
        a.config = dict(cfg)
        a.workers = types.SimpleNamespace(
            local_worker=types.SimpleNamespace(policy=policy))
        a._build_update()
        return a

    jpol = types.SimpleNamespace(params=params)
    ja = algo(joffline.CQL, jpol)
    tpol = types.SimpleNamespace(params=trl.weights_from_jax(params, "cpu"),
                                 device=torch.device("cpu"))
    ta = algo(toffline.CQL, tpol)
    for b in mbs:
        jpol.params, ja._opt_state, loss, td, cons = ja._update(
            jpol.params, ja._target, ja._opt_state,
            *[jnp.asarray(np.asarray(
                b[k], None if k == "actions" else np.float32))
              for k in ("obs", "actions", "rewards", "next_obs", "dones")])
        _close_stats({"cql_loss": float(loss), "td_loss": float(td),
                      "conservative_gap": float(cons)}, ta._cql_step(b))
    _close_params(jpol.params, tpol.params)


def _recurrent_inputs(rng, T=16, n=4, D=3):
    obs = rng.normal(size=(T, n, D)).astype(np.float32)
    resets = (rng.random((T, n)) < 0.2).astype(np.float32)
    return obs, resets


@pytest.mark.parametrize("core", ["lstm", "attention"])
def test_sequence_forwards_within_1e5(core):
    rng = np.random.default_rng(8)
    obs, resets = _recurrent_inputs(rng)
    if core == "lstm":
        params = jax.tree.map(np.asarray, jrecurrent.lstm_init(
            jax.random.PRNGKey(1), 3, 2, embed=16, hidden=16))
        state0 = rng.normal(size=(4, 2, 16)).astype(np.float32)
        jfn, tfn = jrecurrent.lstm_seq_forward, trecurrent.lstm_seq_forward
    else:
        params = jax.tree.map(np.asarray, jcatalog.attn_init(
            jax.random.PRNGKey(1), 3, 2, embed=16, memory=4))
        state0 = rng.normal(size=(4, 4, 16)).astype(np.float32)
        jfn, tfn = jcatalog.attn_seq_forward, tcatalog.attn_seq_forward
    jpi, jv = jfn(params, jnp.asarray(state0), jnp.asarray(obs),
                  jnp.asarray(resets))
    tpi, tv = tfn(trl.weights_from_jax(params, "cpu"), _t(state0), _t(obs),
                  _t(resets))
    np.testing.assert_allclose(np.asarray(jpi), tpi.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(jv), tv.numpy(), atol=1e-5)


@pytest.mark.parametrize("core", ["lstm", "attention"])
def test_recurrent_ppo_update_matches_jax(core):
    rng = np.random.default_rng(9)
    T, n = 16, 4
    obs, resets = _recurrent_inputs(rng, T, n)
    if core == "lstm":
        cfg = {"lstm_cell_size": 16, "lstm_embed": 16}
        jcls, tcls, shape = (jrl.RecurrentPPOPolicy, trl.RecurrentPPOPolicy,
                             (n, 2, 16))
    else:
        cfg = {"model": {"attention_dim": 16, "attention_memory": 4}}
        jcls, tcls, shape = (jrl.AttentionPPOPolicy, trl.AttentionPPOPolicy,
                             (n, 4, 16))
    cfg.update(lr=1e-3, num_sgd_iter=2)
    batch = {
        "obs": obs, "actions": rng.integers(0, 2, (T, n)),
        "action_logp": np.full((T, n), -0.69, np.float32),
        "vf_preds": np.zeros((T, n), np.float32),
        "advantages": rng.normal(size=(T, n)).astype(np.float32),
        "value_targets": rng.normal(size=(T, n)).astype(np.float32),
        "rewards": rng.normal(size=(T, n)).astype(np.float32),
        "dones": resets > 0,
        "state_in": rng.normal(size=shape).astype(np.float32) * 0.1,
        "resets": resets,
    }
    jpol = jcls(3, Space("discrete", n=2), dict(cfg), seed=0)
    tpol = tcls(3, Space("discrete", n=2), {**cfg, **CPU}, seed=0)
    tpol.set_weights(jpol.get_weights())
    _close_stats(jpol.learn_on_batch(batch), tpol.learn_on_batch(batch))
    _close_params(jpol.get_weights(), tpol.get_weights())


# -- batches and checkpoints -----------------------------------------------

@pytest.mark.parametrize("policy", ["ppo", "a2c", "impala",
                                    "recurrent_ppo"])
def test_rollout_batches_have_one_layout(policy):
    cfg = {"env": "CartPole-v1", "num_envs_per_worker": 4,
           "rollout_fragment_length": 16, "policy": policy, **CPU}
    jb = jrw.RolloutWorker(dict(cfg), worker_index=1).sample()
    tb = trw.RolloutWorker(dict(cfg), worker_index=1).sample()
    assert sorted(jb) == sorted(tb)
    for k in jb:
        assert (jb[k].shape, jb[k].dtype) == (tb[k].shape, tb[k].dtype), k


def _ppo_algo(pkg, seed):
    cfg = (pkg.PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                     rollout_fragment_length=8)
           .debugging(seed=seed))
    if pkg is trl:
        cfg = cfg.resources(device="cpu")
    return cfg.build()


@pytest.mark.parametrize("direction", ["torch_to_jax", "jax_to_torch"])
def test_ppo_checkpoints_cross(direction, tmp_path):
    from ray_tpu.air import Checkpoint as JCheckpoint
    from ray_tpu_torch.air import Checkpoint as TCheckpoint
    src_pkg, dst_pkg, dst_ckpt = ((trl, jrl, JCheckpoint)
                                  if direction == "torch_to_jax"
                                  else (jrl, trl, TCheckpoint))
    src = _ppo_algo(src_pkg, 0)
    src.train()
    path = src.save().to_directory(str(tmp_path / "ckpt"))
    want = src.get_policy().get_weights()
    src.stop()
    dst = _ppo_algo(dst_pkg, 1)
    dst.restore(dst_ckpt.from_directory(path))
    got = dst.get_policy().get_weights()
    dst.stop()
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", ["dqn", "sac", "td3", "ddpg"])
def test_part_two_policy_names_resolve(name):
    """The port's registry resolves RLlib part 2's policy names to classes
    named as the JAX package's."""
    assert (trw._resolve_policy_class(name).__name__
            == jrw._resolve_policy_class(name).__name__)

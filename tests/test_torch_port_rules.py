"""Rules the PyTorch port keeps.

* ``ray_tpu_torch/`` and ``chip_smoke.py`` import nothing of JAX and
  nothing of the JAX package (they keep their own copies instead), and
  name no ``ray_tpu.`` module in a string either (``-m ray_tpu._private...``
  would launch the JAX package's processes past the import check).
* The port's runtime (``ray_tpu_torch/_private``) and the layers the
  cluster's workers run on it (``dag``, ``runtime_env``, ``workflow``,
  ``dashboard``, ``serve``, ``air``, ``train``, ``data``, ``tune``,
  ``rllib``, ``job``, ``autoscaler``, ``scripts``) are clean under
  ``ray_tpu``'s own linter, rtlint.
* The port never falls back quietly from the card to the CPU or from a
  kernel to its plain version: entry points raise without a card unless
  given ``device="cpu"``, and the kernel and model modules catch nothing.
"""

import ast
import asyncio
import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "ray_tpu_torch"
FORBIDDEN = {"jax", "jaxlib", "ray_tpu"}


def _port_files():
    # The kernel tests run on the card, which has no JAX, so they too; the
    # gang ranks of the multi-rank tests import _torch_gang.py alone; and
    # the runtime tests' modules are imported by the cluster's workers.
    tests = ROOT / "tests"
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"] + [
        tests / f"{name}.py" for name in (
            "test_torch_flash_kernel", "test_torch_flash_bwd_kernel",
            "test_torch_flash_tiles_kernel",
            "test_torch_splash_kernel", "test_torch_llama_kernel",
            "test_torch_moe_kernel", "_torch_gang", "_torch_runtime",
            "test_torch_core_basic", "test_torch_actors",
            "test_torch_placement_group", "test_torch_wire",
            "test_torch_lease_wait",
            "test_torch_shm_hygiene", "test_torch_serialization",
            "test_torch_gpu_resources", "test_torch_runtime_gpu",
            "test_torch_cancel", "test_torch_config", "test_torch_forkserver",
            "test_torch_cluster", "test_torch_locality_scheduling",
            "test_torch_object_store_recovery",
            "test_torch_partition_tolerance", "test_torch_pubsub_gcs_ft",
            "test_torch_push_transfer", "test_torch_reconstruction",
            "test_torch_refcount_fuzz", "test_torch_scheduling",
            "test_torch_spilling", "test_torch_wait_semantics",
            "test_torch_worker_logs", "test_torch_data_integrity",
            "test_torch_observability", "test_torch_fault_injection",
            "test_torch_tracing_usage", "test_torch_chaos",
            "test_torch_partition_chaos", "test_torch_data_chaos",
            "test_torch_native_sanitizers", "test_torch_runtime_env",
            "test_torch_workflow_dag", "test_torch_dashboard",
            "test_torch_serve", "test_torch_serve_resilience",
            "test_torch_serve_streaming", "test_torch_serve_fleet",
            "test_torch_serve_chaos", "test_torch_head_restart_serve",
            "_torch_train_loops", "test_torch_air", "test_torch_train",
            "test_torch_train_resilience", "test_torch_train_chaos",
            "test_torch_train_torch_trainer", "test_torch_train_gpu",
            "test_torch_collective", "test_torch_orbax_checkpoint",
            "test_torch_data", "test_torch_data_arrow", "test_torch_data_lazy",
            "test_torch_data_ingest", "test_torch_data_gpu",
            "test_torch_batch_predictor", "test_torch_gbdt_sklearn_trainer",
            "test_torch_transformers_trainer", "test_torch_util_pool_queue",
            "test_torch_tune", "test_torch_tune_searchers",
            "test_torch_checkpoint_uri", "test_torch_tune_gpu_resources",
            "test_torch_tune_gpu", "test_torch_rllib",
            "test_torch_rllib_learner", "test_torch_rllib_offline_recurrent",
            "test_torch_rllib_pixel", "test_torch_rllib_policy_server",
            "test_torch_gym_compat", "test_torch_rllib_new_algos",
            "test_torch_rllib_dqn_impala", "test_torch_rllib_gpu_resources",
            "test_torch_rllib_gpu", "test_torch_rllib_exploration",
            "test_torch_rllib_multiagent_sac", "test_torch_rllib_qmix",
            "test_torch_rllib_apex", "test_torch_job_cli",
            "test_torch_autoscaler", "test_torch_gpu_vm_provider",
            "test_torch_ray_client", "test_torch_client_proxy",
            "test_torch_scale_bench", "test_torch_rpdb",
            "test_torch_util_mp_serialize", "test_torch_dask_shim",
            "test_torch_cluster_gpu_resources", "test_torch_cluster_gpu")]
    assert len(files) > 10
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args and
              isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p) & FORBIDDEN)
           for p in _port_files()}
    assert not {k: v for k, v in bad.items() if v}, bad


def _docstrings(tree):
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


_JAX_PACKAGE_MODULE = re.compile(r"(?<![\w/.])ray_tpu\.[A-Za-z_]")


def test_port_names_no_jax_package_module_in_a_string():
    """A string naming a ``ray_tpu.`` module (``-m ray_tpu._private.x``,
    ``importlib.import_module("ray_tpu.x")``, a pickled path) reaches the
    JAX package past the import check.  Docstrings may cite it."""
    bad = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), str(path))
        docs = _docstrings(tree)
        bad += [f"{path.relative_to(ROOT)}:{node.lineno}: {node.value!r}"
                for node in ast.walk(tree)
                if isinstance(node, ast.Constant)
                and isinstance(node.value, str) and id(node) not in docs
                and _JAX_PACKAGE_MODULE.search(node.value)]
    assert not bad, bad


def test_string_check_sees_a_launch_string():
    tree = ast.parse('"""cites ray_tpu.util.metrics"""\n'
                     'cmd = [exe, "-m", "ray_tpu._private.daemon_main"]\n')
    docs = _docstrings(tree)
    hits = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant)
            and isinstance(n.value, str) and id(n) not in docs
            and _JAX_PACKAGE_MODULE.search(n.value)]
    assert hits == ["ray_tpu._private.daemon_main"]


# The runtime's layers above the core: workers run them (serve replicas,
# the controller, the ingress, train workers, rollout workers), so they
# keep the core's rules.
LAYERS = ("dag", "runtime_env", "workflow", "dashboard", "serve", "air",
          "train", "data", "tune", "rllib", "job", "autoscaler", "scripts")


def test_port_runtime_is_rtlint_clean():
    from ray_tpu.tools.rtlint import lint_paths
    paths = [PORT / "_private"] + [PORT / sub for sub in LAYERS]
    result = lint_paths([str(p) for p in paths])
    assert not result.errors, result.errors
    assert result.findings == [], [
        f"{f.path}:{f.line} {f.rule}: {f.message}" for f in result.findings]
    assert result.files_checked >= 25 + 15


def test_runtime_layers_are_held_to_the_import_and_string_rules():
    """Every module of dag, runtime_env, workflow, dashboard, serve, air,
    train, data, tune, rllib, job, autoscaler and scripts is among the
    files the two checks above read, and none
    imports JAX or ``ray_tpu`` or names a ``ray_tpu.`` module in a
    string."""
    checked = set(_port_files())
    for sub in LAYERS:
        mods = sorted((PORT / sub).rglob("*.py"))
        assert mods, sub
        assert set(mods) <= checked, sub
        for path in mods:
            assert not _imported_roots(path) & FORBIDDEN, path
            tree = ast.parse(path.read_text(), str(path))
            docs = _docstrings(tree)
            assert not [n.value for n in ast.walk(tree)
                        if isinstance(n, ast.Constant)
                        and isinstance(n.value, str) and id(n) not in docs
                        and _JAX_PACKAGE_MODULE.search(n.value)], path


def _handlers(path):
    """(line, the source of the caught type or None for a bare except) of
    each except handler in a file."""
    tree = ast.parse(path.read_text(), str(path))
    return [(n.lineno, ast.unparse(n.type) if n.type is not None else None)
            for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]


# The handlers autotune/ may hold: the sweep skips a candidate that runs
# out of device memory (recorded in its record's meta), and the cache
# reads an unreadable file or a torn line as missing.  None of them is
# around a kernel launch.
AUTOTUNE_HANDLERS = {"search.py": ["torch.cuda.OutOfMemoryError"],
                     "cache.py": ["OSError", "ValueError"]}


def test_kernel_and_model_modules_catch_nothing():
    """A try/except around a launch or a collective is how a quiet
    fallback would look."""
    offenders = []
    for sub in ("ops", "models", "parallel"):
        for path in sorted((PORT / sub).rglob("*.py")):
            offenders += [f"{path.name}:{line}"
                          for line, _ in _handlers(path)]
    offenders += [f"dryrun.py:{line}"
                  for line, _ in _handlers(PORT / "dryrun.py")]
    assert not offenders, offenders


def test_autotune_catches_only_oom_and_unreadable_cache_lines():
    """No quiet fallback in the dispatcher or the sweep: the only handlers
    are the sweep's one out-of-memory skip and the cache's file reads."""
    found = {}
    for path in sorted((PORT / "autotune").rglob("*.py")):
        caught = [t for _, t in _handlers(path)]
        if caught:
            found[path.name] = sorted(caught)
    assert found == AUTOTUNE_HANDLERS, found


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_a_card(no_card):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.dryrun import dryrun_multichip
    from ray_tpu_torch.parallel import MeshSpec, make_mesh
    from ray_tpu_torch.parallel.pipeline import dryrun_pipeline
    from ray_tpu_torch.models import (GPTConfig, LlamaConfig, gpt_init,
                                      init_paged_cache, llama_init,
                                      llama_init_paged_cache, mlp_init,
                                      params_from_jax)
    from ray_tpu_torch.rllib import PPOConfig, PPOPolicy, Space
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    cfg = GPTConfig.tiny(vocab=32, seq=16)
    part_two = _part_two_configs()
    lcfg = LlamaConfig.tiny(vocab=32, seq=16)
    ppo = (PPOConfig().environment("CartPole-v1")
           .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                     rollout_fragment_length=8))
    tree = {"wte": np.zeros((32, 64), np.float32)}
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: gpt_init(0, cfg),
                 lambda: llama_init(0, lcfg),
                 lambda: mlp_init(0, [4, 8, 2]),
                 lambda: params_from_jax(tree, cfg),
                 lambda: init_paged_cache(cfg, 4, 8),
                 lambda: llama_init_paged_cache(lcfg, 4, 8),
                 lambda: InferenceEngine(EngineConfig(model_config=cfg,
                                                      max_prompt_len=8,
                                                      max_new_tokens=8)),
                 lambda: InferenceEngine(EngineConfig(model="llama",
                                                      max_prompt_len=8,
                                                      max_new_tokens=8)),
                 lambda: MeshSpec().build(),
                 lambda: MeshSpec(dp=2, tp=2).build(),
                 lambda: make_mesh({"x": 2}),
                 lambda: gpt_init(0, dataclasses.replace(cfg,
                                                         num_experts=4)),
                 lambda: dryrun_multichip(2),
                 lambda: dryrun_pipeline(2),
                 lambda: PPOPolicy(4, Space("discrete", n=2), {}),
                 lambda: ppo.build(),
                 *[c.build for c in part_two.values()]):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _part_two_configs():
    """RLlib part 2's entry points at a tiny size, device unset."""
    from ray_tpu_torch.rllib import (ApexDQNConfig, DQNConfig,
                                     MultiAgentPPOConfig, QMIXConfig,
                                     SACConfig)
    small = dict(learning_starts=16, train_batch_size=16, num_train_iters=2)
    return {
        "dqn": DQNConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=0, num_envs_per_worker=2,
            rollout_fragment_length=8).training(**small),
        "sac": SACConfig().environment("Pendulum-v1").rollouts(
            num_rollout_workers=0, num_envs_per_worker=2,
            rollout_fragment_length=8).training(**small),
        "apex": ApexDQNConfig().environment("CartPole-v1").rollouts(
            num_rollout_workers=1, num_envs_per_worker=2,
            rollout_fragment_length=8).training(num_replay_shards=1,
                                                **small),
        "multi_agent_ppo": MultiAgentPPOConfig().environment(
            "CoordinationGame-v0").rollouts(num_envs_per_worker=2,
                                            rollout_fragment_length=8),
        "qmix": QMIXConfig().environment("TwoStepGame-v0").training(
            learning_starts=16, train_batch_size=16),
    }


def test_entry_points_run_on_the_cpu_when_asked(no_card):
    from ray_tpu_torch import resolve_device
    from ray_tpu_torch.models import GPTConfig, gpt_forward, gpt_init
    from ray_tpu_torch.serve.engine import EngineConfig, InferenceEngine

    assert resolve_device("cpu") == torch.device("cpu")
    cfg = GPTConfig.tiny(vocab=32, seq=16)
    params = gpt_init(0, cfg, device="cpu")
    logits = gpt_forward(params, torch.zeros((1, 4), dtype=torch.long), cfg)
    assert logits.shape == (1, 4, 32) and torch.isfinite(logits).all()
    moe = dataclasses.replace(cfg, num_experts=4)
    logits = gpt_forward(gpt_init(0, moe, device="cpu"),
                         torch.zeros((1, 4), dtype=torch.long), moe)
    assert logits.shape == (1, 4, 32) and torch.isfinite(logits).all()

    async def run():
        eng = InferenceEngine(EngineConfig(model_config=cfg, max_prompt_len=8,
                                           max_new_tokens=4, device="cpu"))
        toks = [t async for t in eng.generate([1, 2, 3], 4)]
        eng.close()
        return toks

    assert len(asyncio.run(run())) == 4

    from ray_tpu_torch.rllib import PPOConfig, PPOPolicy, Space
    pol = PPOPolicy(4, Space("discrete", n=2), {"device": "cpu"})
    assert pol.params["pi"]["w"].device == torch.device("cpu")
    algo = (PPOConfig().environment("CartPole-v1")
            .rollouts(num_rollout_workers=0, num_envs_per_worker=2,
                      rollout_fragment_length=8)
            .resources(device="cpu").build())
    assert np.isfinite(algo.train()["learner_total_loss"])
    algo.stop()

    import ray_tpu_torch
    loss = {"dqn": lambda r: r["info"]["learner"]["loss"],
            "sac": lambda r: r["critic_loss"],
            "apex": lambda r: r["learner_loss"],
            "multi_agent_ppo": lambda r: r["info"]["learner"]["default"][
                "total_loss"],
            "qmix": lambda r: r["loss"]}
    ray_tpu_torch.init(num_cpus=4)     # Ape-X's workers and shards
    try:
        for name, c in _part_two_configs().items():
            algo = c.resources(device="cpu").build()
            assert np.isfinite(loss[name](algo.train())), name
            algo.stop()
    finally:
        ray_tpu_torch.shutdown()


def test_options_of_unported_modules_raise():
    """runtime_env and the DAG (.bind), stubs that raised until their
    modules were ported, now do what the reference does: the scheduling
    options carry the normalized runtime env and its pool key, and
    ``.bind()`` returns a FunctionNode of the remote function."""
    import ray_tpu_torch
    from ray_tpu_torch.dag import FunctionNode
    from ray_tpu_torch.remote_function import _build_scheduling
    from ray_tpu_torch.runtime_env import env_hash

    out = _build_scheduling({"runtime_env": {"env_vars": {"A": "1"}}})
    assert out["runtime_env"] == {"env_vars": {"A": "1"}}
    assert out["env_key"] == env_hash({"env_vars": {"A": "1"}})
    fn = ray_tpu_torch.remote(lambda x: x)
    node = fn.bind(3)
    assert isinstance(node, FunctionNode)
    assert node._fn is fn and node._bound_args == (3,)

"""Per-task/actor runtime environments: env_vars, working_dir, py_modules.

Reference analogs: python/ray/tests/test_runtime_env_env_vars.py and
test_runtime_env_working_dir*.py (packages shipped via GCS, extracted into
a per-node cache; workers pooled per runtime env).

The port's runtime under ``test_runtime_env.py``'s cases, one for one.
"""

import os

import pytest

import ray_tpu_torch


@pytest.fixture(scope="module")
def renv_cluster():
    # One fake card for the GPU cases at the end; the reference's cases
    # ask for none.
    ray_tpu_torch.init(num_cpus=4, resources={"GPU": 1})
    yield
    ray_tpu_torch.shutdown()


def test_env_vars_isolated_per_task(renv_cluster):
    @ray_tpu_torch.remote
    def read_flag():
        return os.environ.get("RT_TEST_FLAG")

    with_env = read_flag.options(
        runtime_env={"env_vars": {"RT_TEST_FLAG": "42"}})
    assert ray_tpu_torch.get(with_env.remote(), timeout=120) == "42"
    # A plain task must NOT run in the env-var worker pool.
    assert ray_tpu_torch.get(read_flag.remote(), timeout=120) is None


def test_working_dir_ships_files(renv_cluster, tmp_path):
    proj = tmp_path / "proj"
    proj.mkdir()
    (proj / "data.txt").write_text("payload-7")
    (proj / "helper.py").write_text("VALUE = 123\n")

    @ray_tpu_torch.remote(runtime_env={"working_dir": str(proj)})
    def use_working_dir():
        import helper  # working_dir joins sys.path
        with open("data.txt") as f:  # and becomes the cwd
            return f.read(), helper.VALUE

    data, value = ray_tpu_torch.get(use_working_dir.remote(), timeout=120)
    assert data == "payload-7" and value == 123


def test_py_modules_importable(renv_cluster, tmp_path):
    mod = tmp_path / "mymod"
    mod.mkdir()
    (mod / "__init__.py").write_text("def answer():\n    return 21 * 2\n")

    @ray_tpu_torch.remote(runtime_env={"py_modules": [str(mod)]})
    def use_module():
        import mymod
        return mymod.answer()

    assert ray_tpu_torch.get(use_module.remote(), timeout=120) == 42


def test_actor_runtime_env(renv_cluster):
    @ray_tpu_torch.remote(runtime_env={"env_vars": {"ACTOR_ENV": "yes"}})
    class EnvActor:
        def read(self):
            return os.environ.get("ACTOR_ENV")

    a = EnvActor.remote()
    assert ray_tpu_torch.get(a.read.remote(), timeout=120) == "yes"


def test_unsupported_keys_rejected(renv_cluster):
    @ray_tpu_torch.remote(runtime_env={"conda": {"dependencies": ["requests"]}})
    def f():
        return 1

    with pytest.raises(ValueError, match="conda"):
        f.remote()


def _write_demo_pkg(root, name: str, version: str) -> str:
    """A minimal installable package exposing __version__."""
    pkg = root / f"{name}-{version}"
    (pkg / name).mkdir(parents=True)
    (pkg / name / "__init__.py").write_text(
        f"__version__ = {version!r}\n")
    (pkg / "pyproject.toml").write_text(
        '[build-system]\n'
        'requires = ["setuptools"]\n'
        'build-backend = "setuptools.build_meta"\n'
        '[project]\n'
        f'name = "{name}"\n'
        f'version = "{version}"\n'
        '[tool.setuptools]\n'
        f'packages = ["{name}"]\n')
    return str(pkg)


def test_pip_env_installs_package_base_env_lacks(renv_cluster, tmp_path):
    """A task runs with a package version the base env
    doesn't have, via a content-addressed per-env site dir."""
    pkg = _write_demo_pkg(tmp_path, "rt_pip_demo", "2.5.0")

    @ray_tpu_torch.remote(runtime_env={"pip": [pkg]})
    def probe():
        import rt_pip_demo
        return rt_pip_demo.__version__

    with pytest.raises(ImportError):
        import rt_pip_demo  # noqa: F401 - must NOT exist in the base env
    assert ray_tpu_torch.get(probe.remote(), timeout=180) == "2.5.0"


def test_concurrent_pip_envs_do_not_collide(renv_cluster, tmp_path):
    """Two envs with different versions of the same package run
    concurrently and each sees its own version."""
    p1 = _write_demo_pkg(tmp_path, "rt_pip_demo2", "1.0.0")
    p2 = _write_demo_pkg(tmp_path, "rt_pip_demo2", "2.0.0")

    @ray_tpu_torch.remote(runtime_env={"pip": [p1]})
    def v1():
        import rt_pip_demo2
        return rt_pip_demo2.__version__

    @ray_tpu_torch.remote(runtime_env={"pip": [p2]})
    def v2():
        import rt_pip_demo2
        return rt_pip_demo2.__version__

    refs = [v1.remote(), v2.remote(), v1.remote(), v2.remote()]
    assert ray_tpu_torch.get(refs, timeout=240) == \
        ["1.0.0", "2.0.0", "1.0.0", "2.0.0"]


# ------------------------------------------------------------ card cases


def test_runtime_env_cannot_take_a_leased_card(renv_cluster):
    """The raylet applies env_vars before it names the leased card ids, so
    a runtime env cannot empty a GPU task's CUDA_VISIBLE_DEVICES."""
    @ray_tpu_torch.remote(num_gpus=1, runtime_env={
        "env_vars": {"CUDA_VISIBLE_DEVICES": "", "RT_TEST_CARD_ENV": "1"}})
    def visible():
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                os.environ.get("RT_TEST_CARD_ENV"))

    assert ray_tpu_torch.get(visible.remote(), timeout=120) == ("0", "1")


def test_runtime_env_cannot_give_a_card(renv_cluster):
    """...nor give a card-less task one: it still sees none."""
    @ray_tpu_torch.remote(runtime_env={
        "env_vars": {"CUDA_VISIBLE_DEVICES": "0", "RT_TEST_CARD_ENV": "2"}})
    def visible():
        return (os.environ.get("CUDA_VISIBLE_DEVICES"),
                os.environ.get("RT_TEST_CARD_ENV"))

    assert ray_tpu_torch.get(visible.remote(), timeout=120) == ("", "2")


def test_pip_env_reaches_a_forked_worker_not_the_template(renv_cluster,
                                                          tmp_path):
    """Card-less workers fork from a warm template: the env's vars and its
    pip target reach the forked child, and a later default-env worker
    forked from the same template has neither."""
    pkg = _write_demo_pkg(tmp_path, "rt_pip_demo3", "3.1.0")

    @ray_tpu_torch.remote(runtime_env={"pip": [pkg],
                                       "env_vars": {"RT_TEST_FORKED": "y"}})
    def probe():
        import rt_pip_demo3
        return rt_pip_demo3.__version__, os.environ.get("RT_TEST_FORKED")

    @ray_tpu_torch.remote
    def plain():
        try:
            import rt_pip_demo3  # noqa: F401
            found = True
        except ImportError:
            found = False
        return found, os.environ.get("RT_TEST_FORKED")

    assert ray_tpu_torch.get(probe.remote(), timeout=180) == ("3.1.0", "y")
    assert ray_tpu_torch.get([plain.remote() for _ in range(4)],
                             timeout=120) == [(False, None)] * 4

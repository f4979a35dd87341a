"""Job submission + CLI lifecycle of the port, case for case those of
``test_job_cli.py``.

Reference analogs: python/ray/tests/test_job_manager.py (JobManager
submit/status/logs/stop) and the `ray start/status/stop` CLI smoke path
(scripts.py:529).  The CLI is ``python -m ray_tpu_torch``; its session
directory (``RT_SESSION_DIR``) is private to each test.  This module
imports nothing of JAX: the cluster's workers import it.
"""

import json
import os
import subprocess
import sys
import tempfile
import uuid

import pytest

import ray_tpu_torch
from ray_tpu_torch.job import JobStatus, JobSubmissionClient


@pytest.fixture(scope="module")
def job_cluster():
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()


def test_job_submit_succeeds_and_streams_logs(job_cluster):
    client = JobSubmissionClient()
    sid = client.submit_job(
        entrypoint=f"{sys.executable} -c \"print('hello from job')\"")
    status = client.wait_until_finished(sid, timeout=120)
    assert status == JobStatus.SUCCEEDED
    assert "hello from job" in client.get_job_logs(sid)
    info = client.get_job_info(sid)
    assert info.end_time >= info.start_time > 0


def test_job_entrypoint_can_join_cluster(job_cluster):
    """The submitted driver sees RT_ADDRESS and runs tasks on this cluster."""
    script = (
        "import ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"           # picks up RT_ADDRESS
        "@ray_tpu_torch.remote\n"
        "def f(): return 21 * 2\n"
        "print('answer=', ray_tpu_torch.get(f.remote()))\n")
    path = os.path.join(tempfile.gettempdir(),
                        f"rtt_job_script_{uuid.uuid4().hex[:6]}.py")
    with open(path, "w") as f:
        f.write(script)
    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} {path}")
    assert client.wait_until_finished(sid, timeout=180) == \
        JobStatus.SUCCEEDED
    assert "answer= 42" in client.get_job_logs(sid)


def test_job_failure_and_stop(job_cluster):
    client = JobSubmissionClient()
    sid = client.submit_job(entrypoint=f"{sys.executable} -c 'exit(3)'")
    assert client.wait_until_finished(sid, timeout=120) == JobStatus.FAILED
    assert "exit code 3" in client.get_job_info(sid).message

    sid2 = client.submit_job(
        entrypoint=f"{sys.executable} -c 'import time; time.sleep(600)'")
    assert client.get_job_status(sid2) in (JobStatus.RUNNING,
                                           JobStatus.PENDING)
    assert client.stop_job(sid2)
    assert client.wait_until_finished(sid2, timeout=60) == JobStatus.STOPPED

    ids = {j.submission_id for j in client.list_jobs()}
    assert {sid, sid2} <= ids


def test_cli_start_status_stop():
    """`ray_tpu_torch start --head` -> `status` -> job submit --wait ->
    `stop`, all through the console entrypoint in a private session dir."""
    sess_dir = os.path.join(tempfile.gettempdir(),
                            f"rtt_cli_{uuid.uuid4().hex[:6]}")
    env = dict(os.environ, RT_SESSION_DIR=sess_dir)

    def cli(*argv, timeout=180):
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch"] + list(argv),
            env=env, capture_output=True, text=True, timeout=timeout)

    r = cli("start", "--head", "--num-cpus", "2", "--port", "0")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "GCS address:" in r.stdout
    try:
        r = cli("status")
        assert r.returncode == 0, r.stdout + r.stderr
        summary = json.loads(r.stdout)
        assert summary["nodes"]["alive"] >= 1

        r = cli("job", "submit", "--wait", "--",
                sys.executable, "-c", "print('cli job ran')")
        assert r.returncode == 0, r.stdout + r.stderr
        assert "cli job ran" in r.stdout

        r = cli("list", "nodes")
        assert r.returncode == 0 and json.loads(r.stdout)
    finally:
        r = cli("stop")
    assert r.returncode == 0, r.stdout + r.stderr
    assert "stopped" in r.stdout


def test_job_runtime_env_working_dir_and_py_modules(tmp_path):
    """Job-level runtime_env (reference: ray job submit --runtime-env):
    the entrypoint runs inside the shipped working_dir with py_modules
    importable and env_vars set."""
    import ray_tpu_torch
    from ray_tpu_torch.job import JobSubmissionClient

    wd = tmp_path / "wd"
    wd.mkdir()
    (wd / "data.txt").write_text("payload42")
    mod = tmp_path / "mymod"
    mod.mkdir()
    (mod / "__init__.py").write_text("MAGIC = 123\n")

    ray_tpu_torch.init(num_cpus=2)
    try:
        client = JobSubmissionClient()
        sid = client.submit_job(
            entrypoint=(
                "python -c \"import os, mymod; "
                "print('WD', open('data.txt').read(), mymod.MAGIC, "
                "os.environ['JOB_FLAVOR'])\""),
            runtime_env={"working_dir": str(wd),
                         "py_modules": [str(mod)],
                         "env_vars": {"JOB_FLAVOR": "vanilla"}})
        status = client.wait_until_finished(sid, timeout=120)
        logs = client.get_job_logs(sid)
        assert status == "SUCCEEDED", logs
        assert "WD payload42 123 vanilla" in logs
    finally:
        ray_tpu_torch.shutdown()

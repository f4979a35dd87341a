"""JobManager + JobSupervisor: cluster-side job execution.

Port of ``ray_tpu/job/job_manager.py``.

Design analog: reference ``dashboard/modules/job/job_manager.py`` --
JobManager:490 (submit_job -> supervisor actor, status in GCS KV) and
JobSupervisor:136 (detached actor running the entrypoint as a subprocess,
polling it to a terminal status).

The entrypoint subprocess gets ``RT_ADDRESS`` pointing at the cluster, so a
driver script that calls ``ray_tpu_torch.init()`` joins the same cluster it
was submitted to.

The entrypoint holds no card.  The supervisor is a ``num_cpus=0`` actor, so
its worker runs with ``CUDA_VISIBLE_DEVICES=""``, and the entrypoint's
environment is a copy of the supervisor's (neither ``env_vars`` nor the
job's runtime env can move it).  A job that wants the card asks for it as
every other card holder does, through a lease: a ``num_gpus`` task or actor
that the entrypoint creates.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._private import kv

JOB_NS = "job_submission"


class JobStatus:
    PENDING = "PENDING"
    RUNNING = "RUNNING"
    SUCCEEDED = "SUCCEEDED"
    FAILED = "FAILED"
    STOPPED = "STOPPED"

    TERMINAL = (SUCCEEDED, FAILED, STOPPED)


@dataclass
class JobInfo:
    submission_id: str
    entrypoint: str
    status: str = JobStatus.PENDING
    message: str = ""
    start_time: float = 0.0
    end_time: float = 0.0
    metadata: Dict[str, str] = field(default_factory=dict)

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "JobInfo":
        return cls(**json.loads(raw))


def _put_info(info: JobInfo):
    kv.kv_put(info.submission_id.encode(), info.to_json(), ns=JOB_NS)


def _get_info(submission_id: str) -> Optional[JobInfo]:
    raw = kv.kv_get(submission_id.encode(), ns=JOB_NS)
    return JobInfo.from_json(raw) if raw else None


@ray_tpu_torch.remote(num_cpus=0)
class _JobSupervisor:
    """Detached actor supervising one entrypoint subprocess.

    Reference job_manager.py:136: the supervisor lives on the cluster so the
    job outlives the submitting client; logs stream to a file the client can
    poll."""

    def __init__(self, submission_id: str, entrypoint: str,
                 env: Optional[Dict[str, str]], log_path: str,
                 runtime_env: Optional[dict] = None):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        penv = dict(os.environ)
        penv.update(env or {})
        penv["RT_ADDRESS"] = os.environ["RT_GCS_ADDRESS"]
        penv["RT_JOB_SUBMISSION_ID"] = submission_id
        # The supervisor worker imports ray_tpu_torch via its runtime sys.path
        # (RT_DRIVER_SYS_PATH); a child python only sees PYTHONPATH, so
        # materialize the import path for the entrypoint driver.
        extra = [p for p in sys.path if p]
        if penv.get("PYTHONPATH"):
            extra.append(penv["PYTHONPATH"])
        penv["PYTHONPATH"] = os.pathsep.join(extra)
        cwd = None
        if runtime_env:
            # Job-level runtime env (reference: ray job submit
            # --runtime-env): working_dir becomes the entrypoint's cwd,
            # py_modules/pip site dirs prepend its PYTHONPATH, env_vars
            # merge — the same normalized/content-addressed layout the
            # worker path uses (runtime_env/runtime_env.py).
            import tempfile

            from ray_tpu_torch._private.worker import get_core
            from ray_tpu_torch.runtime_env.runtime_env import (PKG_NS,
                                                               materialize)

            def _kv_get(key):
                return get_core().gcs_request(
                    {"type": "kv_get", "ns": PKG_NS, "key": key})

            mat = materialize(runtime_env, _kv_get, os.path.join(
                tempfile.gettempdir(), "rtt_runtime_env"))
            if mat["paths"]:
                penv["PYTHONPATH"] = os.pathsep.join(
                    list(mat["paths"]) + [penv["PYTHONPATH"]])
            cwd = mat["workdir"] or None
            penv.update(runtime_env.get("env_vars", {}))
        # The card belongs to leases only: the entrypoint sees what this
        # card-less worker sees, whatever the job's env_vars say.
        penv["CUDA_VISIBLE_DEVICES"] = os.environ.get(
            "CUDA_VISIBLE_DEVICES", "")
        self._cwd = cwd
        self._log_f = open(log_path, "wb")
        info = _get_info(submission_id) or JobInfo(submission_id, entrypoint)
        info.status = JobStatus.RUNNING
        info.start_time = time.time()
        _put_info(info)
        self.proc = subprocess.Popen(
            entrypoint, shell=True, env=penv, cwd=self._cwd,
            stdout=self._log_f, stderr=subprocess.STDOUT,
            start_new_session=True)

    def poll(self) -> str:
        """Advance state; returns current status."""
        info = _get_info(self.submission_id)
        if info.status in JobStatus.TERMINAL:
            return info.status
        rc = self.proc.poll()
        if rc is None:
            return JobStatus.RUNNING
        info.status = JobStatus.SUCCEEDED if rc == 0 else JobStatus.FAILED
        info.message = f"exit code {rc}"
        info.end_time = time.time()
        _put_info(info)
        self._log_f.flush()
        return info.status

    def stop(self) -> bool:
        if self.proc.poll() is None:
            # Kill the whole process group (entrypoint may spawn children).
            try:
                os.killpg(os.getpgid(self.proc.pid), 15)
            except Exception:
                self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                try:
                    os.killpg(os.getpgid(self.proc.pid), 9)
                except Exception:
                    self.proc.kill()
        info = _get_info(self.submission_id)
        if info.status not in JobStatus.TERMINAL:
            info.status = JobStatus.STOPPED
            info.end_time = time.time()
            _put_info(info)
        return True

    def logs(self) -> bytes:
        self._log_f.flush()
        try:
            with open(self.log_path, "rb") as f:
                return f.read()
        except FileNotFoundError:
            return b""


class JobManager:
    """Client-side orchestration of supervisor actors (runs in any process
    connected to the cluster)."""

    def submit_job(self, entrypoint: str, *,
                   submission_id: Optional[str] = None,
                   env: Optional[Dict[str, str]] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[dict] = None) -> str:
        submission_id = submission_id or f"rtjob_{uuid.uuid4().hex[:10]}"
        if _get_info(submission_id) is not None:
            raise ValueError(f"job {submission_id} already exists")
        log_path = os.path.join(tempfile.gettempdir(),
                                f"rtt_job_{submission_id}.log")
        _put_info(JobInfo(submission_id, entrypoint,
                          metadata=dict(metadata or {})))
        sup = _JobSupervisor.options(
            name=f"_rt_job_supervisor_{submission_id}",
            lifetime="detached",
        ).remote(submission_id, entrypoint, env, log_path,
                 runtime_env=runtime_env)
        # Surface immediate spawn failures synchronously.
        ray_tpu_torch.get(sup.poll.remote(), timeout=60)
        return submission_id

    def _supervisor(self, submission_id: str):
        try:
            return ray_tpu_torch.get_actor(
                f"_rt_job_supervisor_{submission_id}")
        except Exception:
            return None

    def get_job_status(self, submission_id: str) -> str:
        sup = self._supervisor(submission_id)
        if sup is not None:
            try:
                return ray_tpu_torch.get(sup.poll.remote(), timeout=30)
            except Exception:
                pass
        info = _get_info(submission_id)
        if info is None:
            raise ValueError(f"no such job {submission_id}")
        # Supervisor gone without a terminal status = it died under us.
        if info.status not in JobStatus.TERMINAL:
            info.status = JobStatus.FAILED
            info.message = "supervisor died"
            _put_info(info)
        return info.status

    def get_job_info(self, submission_id: str) -> JobInfo:
        self.get_job_status(submission_id)
        return _get_info(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        sup = self._supervisor(submission_id)
        if sup is None:
            return ""
        return ray_tpu_torch.get(sup.logs.remote(), timeout=30).decode(
            "utf-8", "replace")

    def stop_job(self, submission_id: str) -> bool:
        sup = self._supervisor(submission_id)
        if sup is None:
            return False
        return ray_tpu_torch.get(sup.stop.remote(), timeout=30)

    def list_jobs(self) -> List[JobInfo]:
        out = []
        for key in kv.kv_keys(ns=JOB_NS):
            raw = kv.kv_get(key, ns=JOB_NS)
            if raw:
                out.append(JobInfo.from_json(raw))
        return sorted(out, key=lambda j: j.start_time)

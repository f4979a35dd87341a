"""JobSubmissionClient: the user-facing job API.

Port of ``ray_tpu/job/sdk.py``.

Design analog: reference ``dashboard/modules/job/sdk.py:40`` -- but instead
of REST against the dashboard, it connects to the cluster directly (the
control plane is the GCS; no separate HTTP tier is required for parity of
capability).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.job.job_manager import JobInfo, JobManager


class JobSubmissionClient:
    def __init__(self, address: Optional[str] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init(address=address)
        self._manager = JobManager()

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   runtime_env: Optional[dict] = None,
                   metadata: Optional[Dict[str, str]] = None) -> str:
        env = dict((runtime_env or {}).get("env_vars", {}))
        norm = None
        if runtime_env:
            # Normalize driver-side: local working_dir/py_modules upload
            # to the GCS KV by content here so the (possibly remote)
            # supervisor can materialize them anywhere.
            from ray_tpu_torch.runtime_env import normalize_runtime_env
            norm = normalize_runtime_env(runtime_env)
        return self._manager.submit_job(
            entrypoint, submission_id=submission_id, env=env,
            metadata=metadata, runtime_env=norm)

    def get_job_status(self, submission_id: str) -> str:
        return self._manager.get_job_status(submission_id)

    def get_job_info(self, submission_id: str) -> JobInfo:
        return self._manager.get_job_info(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        return self._manager.get_job_logs(submission_id)

    def stop_job(self, submission_id: str) -> bool:
        return self._manager.stop_job(submission_id)

    def list_jobs(self) -> List[JobInfo]:
        return self._manager.list_jobs()

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        import time
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in ("SUCCEEDED", "FAILED", "STOPPED"):
                return status
            time.sleep(1.0)
        raise TimeoutError(
            f"job {submission_id} not finished after {timeout}s")

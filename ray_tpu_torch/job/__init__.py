"""Job submission: run driver scripts as supervised subprocesses on the
cluster.

Port of ``ray_tpu/job/__init__.py``.

Design analog: reference ``dashboard/modules/job/`` -- JobManager
(job_manager.py:490), JobSupervisor actor (job_manager.py:136),
JobSubmissionClient (sdk.py:40).
"""

from ray_tpu_torch.job.job_manager import (JobManager, JobStatus, JobInfo)
from ray_tpu_torch.job.sdk import JobSubmissionClient

__all__ = ["JobManager", "JobStatus", "JobInfo", "JobSubmissionClient"]

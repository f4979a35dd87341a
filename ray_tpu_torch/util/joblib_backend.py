"""joblib backend: scikit-learn-style Parallel() over cluster actors.

Port of ``ray_tpu/util/joblib_backend.py``.

Design analog: reference ``python/ray/util/joblib/`` —
``register_ray()`` + a joblib ParallelBackendBase so
``with joblib.parallel_backend("ray_tpu_torch"):
Parallel()(delayed(f)(x) ...)`` fans the batches out as cluster tasks with
zero changes to sklearn code.
"""

from __future__ import annotations

from typing import Any, List

from joblib._parallel_backends import ParallelBackendBase


def register_ray_tpu() -> None:
    """Register the 'ray_tpu_torch' joblib backend (idempotent)."""
    from joblib.parallel import register_parallel_backend
    register_parallel_backend("ray_tpu_torch", _RayTpuBackend)


class _FutureResult:
    def __init__(self, ref, callback):
        self._ref = ref
        self._callback = callback
        self._result = None
        self._done = False

    def get(self, timeout=None) -> List[Any]:
        if not self._done:
            import ray_tpu_torch
            self._result = ray_tpu_torch.get(self._ref, timeout=timeout)
            self._done = True
            if self._callback is not None:
                self._callback(self._result)
        return self._result


def _run_batch(batch):
    # Call the BatchedCalls object itself: its __call__ applies the nested
    # parallel_config, so user fns that spin up their own joblib.Parallel
    # get the sequential nested backend instead of forking a loky pool on
    # every cluster worker.
    return batch()


class _RayTpuBackend(ParallelBackendBase):
    """joblib ParallelBackendBase over ray_tpu_torch tasks."""

    supports_inner_max_num_threads = False
    supports_retrieve_callback = False
    supports_timeout = True          # _FutureResult.get honors timeout
    default_n_jobs = -1

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.parallel = None
        self._task = None
        self._inflight: List[Any] = []

    # -- contract ---------------------------------------------------------

    @staticmethod
    def _resolve_n_jobs(n_jobs) -> int:
        """Map joblib's n_jobs conventions onto cluster CPUs: None/-1 =
        all, other negatives = cpus + 1 + n_jobs (sklearn's -2 = all but
        one), positives pass through."""
        import ray_tpu_torch
        cpus = max(1, int(ray_tpu_torch.cluster_resources().get("CPU", 1))) \
            if ray_tpu_torch.is_initialized() else 1
        if n_jobs in (None, -1):
            return cpus
        n_jobs = int(n_jobs)
        if n_jobs < 0:
            return max(1, cpus + 1 + n_jobs)
        return n_jobs

    def configure(self, n_jobs=1, parallel=None, **_):
        import ray_tpu_torch
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self.parallel = parallel
        self._n_jobs = self._resolve_n_jobs(n_jobs)
        self._task = ray_tpu_torch.remote(_run_batch)
        self._inflight = []
        return self._n_jobs

    def effective_n_jobs(self, n_jobs):
        return self._resolve_n_jobs(n_jobs)

    def submit(self, func, callback=None):
        # func is a joblib BatchedCalls; ship it whole as one task.
        ref = self._task.remote(func)
        self._inflight.append(ref)
        return _FutureResult(ref, callback)

    # older joblib versions call apply_async
    def apply_async(self, func, callback=None):
        return self.submit(func, callback)

    def retrieve_result_callback(self, out):
        return out

    def abort_everything(self, ensure_ready=True):
        # Best-effort cancel of still-running batches: one raised batch
        # must not leave the other pre-dispatched tasks pinning CPUs.
        import ray_tpu_torch
        for ref in self._inflight:
            try:
                ray_tpu_torch.cancel(ref)
            except Exception:
                pass
        self._inflight = []
        if ensure_ready:
            self.configure(n_jobs=self._n_jobs, parallel=self.parallel)

    # joblib calls these around Parallel.__call__
    def start_call(self):
        pass

    def stop_call(self):
        pass

    def terminate(self):
        pass

    def get_nested_backend(self):
        from joblib._parallel_backends import SequentialBackend
        return SequentialBackend(), None

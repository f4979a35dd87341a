"""The Trainable contract and its function-API adapter.

Port of ``ray_tpu/tune/trainable.py``.  Design analog: reference
``python/ray/tune/trainable/trainable.py:66``
(setup/step/save_checkpoint/load_checkpoint/stop driven by the trial
executor) and ``trainable/function_trainable.py`` (user fn in a thread,
results pulled through a queue -- same mechanism our train worker uses).
A trainer's trial (``wrap_trainer_as_trainable``) also shuts its
trainer's gang down when it stops: the trial actor's process creates the
gang, but the GCS records no owner for an actor, so the gang would
outlive the killed trial actor and keep its cards.
"""

from __future__ import annotations

import copy
import queue
import threading
import traceback
from typing import Any, Callable, Dict, Optional, Type

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint


class Trainable:
    """Subclass API: override setup/step/save_checkpoint/load_checkpoint."""

    def __init__(self, config: Optional[Dict[str, Any]] = None,
                 trial_id: str = "", trial_name: str = ""):
        self.config = config or {}
        self.trial_id = trial_id
        self.trial_name = trial_name
        self.iteration = 0
        self.setup(self.config)

    # -- subclass hooks ---------------------------------------------------
    def setup(self, config: Dict[str, Any]) -> None:
        pass

    def step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def save_checkpoint(self) -> Optional[Dict[str, Any]]:
        return None

    def load_checkpoint(self, checkpoint: Optional[Dict[str, Any]]) -> None:
        pass

    def reset_config(self, new_config: Dict[str, Any]) -> bool:
        """Reuse this instance for a new config (PBT exploit without actor
        restart).  Return False to force a fresh actor."""
        return False

    def cleanup(self) -> None:
        pass

    # -- driver-side driver ----------------------------------------------
    def train(self) -> Dict[str, Any]:
        result = self.step()
        self.iteration += 1
        result = dict(result or {})
        result.setdefault("training_iteration", self.iteration)
        result.setdefault("done", False)
        return result

    def save(self) -> Checkpoint:
        state = self.save_checkpoint() or {}
        return Checkpoint.from_dict(
            {"trainable_state": state, "iteration": self.iteration})

    def restore(self, checkpoint: Checkpoint) -> None:
        data = checkpoint.to_dict()
        self.iteration = data.get("iteration", 0)
        self.load_checkpoint(data.get("trainable_state"))

    def stop(self) -> None:
        self.cleanup()

    @classmethod
    def default_resource_request(cls, config: Dict[str, Any]
                                 ) -> Dict[str, float]:
        return {"CPU": 1.0}


class FunctionTrainable(Trainable):
    """Wraps ``fn(config)`` (which calls tune.report) into step() pulls."""

    _fn: Callable = None  # set by subclass factory

    def setup(self, config):
        # maxsize=1: session.report blocks until the driver consumes the
        # result (the reference's report handshake).  Besides backpressure,
        # this is what makes reset_config safe: an orphaned fn thread parks
        # on a discarded queue's put() instead of free-running.
        self._queue: "queue.Queue" = queue.Queue(maxsize=1)
        self._started = False
        self._restore_checkpoint: Optional[Checkpoint] = None
        self._error: Optional[str] = None

    def reset_config(self, new_config):
        """In-place PBT exploit: orphan the running fn thread (daemonic; it
        parks on its now-discarded bounded queue) and arm a fresh start.
        Avoids a full actor restart per exploit — on the reference this is
        the reuse_actors fast path."""
        self._queue = queue.Queue(maxsize=1)
        self._started = False
        self._restore_checkpoint = None
        self._latest_fn_checkpoint = None
        return True

    def _start(self):
        fn = self._fn
        q = self._queue
        restore_ckpt = self._restore_checkpoint
        config = dict(self.config)
        trial_id, trial_name = self.trial_id, self.trial_name

        class _FnSession(air_session._SessionBase):
            def __init__(self):
                self.trial_id = trial_id
                self.trial_name = trial_name

            def report(self, metrics, checkpoint=None):
                q.put(("report", metrics, checkpoint))

            def get_checkpoint(self):
                return restore_ckpt

        def _run():
            air_session._set_session(_FnSession())
            try:
                import inspect
                if inspect.signature(fn).parameters:
                    fn(config)
                else:
                    fn()
                q.put(("done", None, None))
            except BaseException as e:  # noqa: BLE001
                q.put(("error", repr(e), traceback.format_exc()))
            finally:
                air_session._set_session(None)

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()
        self._started = True

    def step(self):
        if not self._started:
            self._start()
        kind, payload, extra = self._queue.get()
        if kind == "error":
            raise RuntimeError(
                f"tune function failed: {payload}\n{extra}")
        if kind == "done":
            return {"done": True}
        metrics, ckpt = payload, extra
        if ckpt is not None:
            self._latest_fn_checkpoint = ckpt
        return dict(metrics)

    def save_checkpoint(self):
        ckpt = getattr(self, "_latest_fn_checkpoint", None)
        return {"fn_checkpoint": ckpt.to_dict()} if ckpt else None

    def load_checkpoint(self, state):
        if state and state.get("fn_checkpoint") is not None:
            self._restore_checkpoint = Checkpoint.from_dict(
                state["fn_checkpoint"])


def wrap_function(fn: Callable) -> Type[FunctionTrainable]:
    return type(f"fn_{getattr(fn, '__name__', 'trainable')}",
                (FunctionTrainable,), {"_fn": staticmethod(fn)})


class _TrainerTrainable(FunctionTrainable):
    """A trainer's trial: the fn thread runs a copy of ``_trainer``.

    The copy's gang (its workers and their placement group) is created by
    this trial actor's process, and the GCS records no owner for an
    actor: killing the trial actor leaves the gang alive, holding its
    cards.  So stop() shuts down the gang of every copy this trial ran
    before the runner kills the trial actor."""

    _trainer = None  # the train.BaseTrainer being tuned

    def setup(self, config):
        super().setup(config)
        self._copies = []

    def _fn(self, config):
        t = copy.deepcopy(self._trainer)
        if config:
            # Tune param_space keys override train_loop_config entries
            # (reference: train_loop_config nested under param_space).
            loop_cfg = dict(getattr(t, "_train_loop_config", None) or {})
            loop_cfg.update(config.get("train_loop_config", config))
            if hasattr(t, "_train_loop_config"):
                t._train_loop_config = loop_cfg
        self._copies.append(t)
        t.setup()
        t.training_loop()

    def cleanup(self):
        for t in self._copies:
            executor = getattr(t, "_executor", None)
            if executor is not None:
                executor.shutdown()

    @classmethod
    def default_resource_request(cls, config):
        # The trial actor itself is lightweight; the nested trainer
        # gang-reserves num_workers x bundle() via its own placement group
        # when training starts (reference: Tune allocates the whole PG up
        # front; deferring to the trainer keeps trial startup cheap and
        # lets the PG wait queue do admission control).
        return {"CPU": 0.1}


def wrap_trainer_as_trainable(trainer) -> Type[Trainable]:
    """Adapt a train.BaseTrainer into a Trainable (reference
    base_trainer.py:500 as_trainable).  Each step() drains one report from
    the trainer's training loop, run on a background thread."""
    return type(f"trainer_{type(trainer).__name__}", (_TrainerTrainable,),
                {"_trainer": trainer})


def with_parameters(trainable, **kwargs):
    """Bind large constant objects into a trainable (reference
    tune/trainable/util.py with_parameters) -- values ship by object ref."""
    import ray_tpu_torch
    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        base = trainable

        class _WithParams(base):  # type: ignore[valid-type]
            def setup(self, config):
                import ray_tpu_torch as _rt
                bound = {k: _rt.get(r) for k, r in refs.items()}
                merged = dict(config)
                merged.update(bound)
                super().setup(merged)

        _WithParams.__name__ = base.__name__
        return _WithParams

    fn = trainable

    def _wrapped(config):
        import ray_tpu_torch as _rt
        bound = {k: _rt.get(r) for k, r in refs.items()}
        return fn(config, **bound)

    _wrapped.__name__ = getattr(fn, "__name__", "with_parameters")
    return _wrapped


def with_resources(trainable, resources: Dict[str, float]):
    """Attach a resource request (reference tune/trainable/util.py)."""
    if isinstance(trainable, type) and issubclass(trainable, Trainable):
        cls = trainable
    else:
        cls = wrap_function(trainable)

    res = dict(resources)

    class _WithResources(cls):  # type: ignore[valid-type]
        @classmethod
        def default_resource_request(cls_, config):
            return dict(res)

    _WithResources.__name__ = cls.__name__
    return _WithResources

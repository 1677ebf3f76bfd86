"""Jobs: units of work with progress and cooperative cancel, resident in
the DKV (counterpart of h2o3_tpu/core/job.py: `JobCancelled` :30, `Job`
:34, `start` :102, `update` :158, `fail` :166, `begin`/`complete`/
`fail_local` :184-214, `restart` :215, `cancel`/`join` :233-243,
`to_dict` :247).

Lifecycle: CREATED -> RUNNING -> DONE / FAILED / CANCELLED, with a
progress fraction and message. `start` runs the work on a host thread
(the device work inside is asynchronous anyway); a synchronous caller
(`ModelBuilder.train`) uses the locked transitions `begin`, `complete`,
`fail_local` and `cancelled_local` instead. `update` is the cooperative
cancel point: it raises JobCancelled once `cancel` was asked for.

A job failed from outside keeps that verdict even if its worker later
finishes: a search member past its deadline, or every running job when
the cloud supervisor FAILs the cloud (`parallel/supervisor.fail`, with
the follower's traceback). Work that raises
:class:`~h2o3_tpu_torch.core.failure.CloudUnhealthyError` (a follower
lost mid-op) fails its job externally too: the cloud failed it, not the
work. A builder saves durable progress against a job's `resume_spec`
(models/model_builder.py); the recovery watchdog
(`parallel/watchdog.resume_failed_jobs`) re-dispatches an externally
failed job with progress through RESUMING (`restart`: FAILED ->
RESUMING -> RUNNING -> DONE, `attempt` counting the dispatches and
`resumed_from_iteration` naming where training went on). Pickling drops
the thread and the lock, so a job's metadata survives a control-plane
checkpoint.
"""

from __future__ import annotations

import threading
import time
import traceback
from typing import Any, Callable, Optional

from h2o3_tpu_torch.core.dkv import DKV, Key, Keyed


_PROGRESS_PREFIX = "jobs/progress/"


class JobCancelled(Exception):
    pass


class Job(Keyed):
    CREATED, RUNNING, DONE, FAILED, CANCELLED = (
        "CREATED", "RUNNING", "DONE", "FAILED", "CANCELLED")
    # an externally failed job being re-dispatched by the watchdog
    RESUMING = "RESUMING"

    def __init__(self, description: str = "", dest: Optional[str] = None):
        super().__init__(Key.make("Job"))
        self.description = description
        self.dest = dest                  # key of the result object
        self.status = Job.CREATED
        self.progress = 0.0
        self.progress_msg = ""
        self.exception: Optional[str] = None
        # True when the job was failed from outside its worker
        self.failed_externally = False
        self.attempt = 1
        self.resumed_from_iteration: Optional[int] = None
        self.resume_spec: Optional[dict] = None
        self.start_time = 0.0
        self.end_time = 0.0
        self._cancel_requested = False
        self._thread: Optional[threading.Thread] = None
        # serializes terminal-status writes: a worker's DONE and an
        # external FAILED must not interleave
        self._status_lock = threading.Lock()
        self.result: Any = None
        self.install()

    def __getstate__(self):
        d = dict(self.__dict__)
        d["_thread"] = None
        d.pop("_status_lock", None)
        d["result"] = None          # results live under their own key
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._thread = None
        self._status_lock = threading.Lock()
        if self.status in (Job.CREATED, Job.RUNNING, Job.RESUMING):
            # an unpickled job has no worker: its work died with the
            # process that pickled it
            self.status = Job.FAILED
            self.failed_externally = True
            self.end_time = self.end_time or time.time()
            self.exception = self.exception or (
                "job was in flight when it was pickled; its worker is gone")

    # -- the running side ------------------------------------------------
    def start(self, fn: Callable[["Job"], Any],
              background: bool = True) -> "Job":
        """Run fn(job), on a new thread unless `background` is False."""
        gen = self.attempt

        def run():
            with self._status_lock:
                if self.status == Job.FAILED or self.attempt != gen:
                    return
                self.status = Job.RUNNING
            self.start_time = time.time()
            try:
                result = fn(self)
                with self._status_lock:
                    if self.status == Job.FAILED or self.attempt != gen:
                        # failed from outside while in flight: keep that
                        # verdict and do not install the result
                        return
                    self.result = result
                    if self.dest and result is not None:
                        DKV.put(self.dest, result)
                    self.status = Job.DONE
                    self.progress = 1.0
                    self.failed_externally = False
            except JobCancelled:
                with self._status_lock:
                    if self.status != Job.FAILED and self.attempt == gen:
                        self.status = Job.CANCELLED
            except Exception as e:
                from h2o3_tpu_torch.core.failure import CloudUnhealthyError

                with self._status_lock:
                    if self.status != Job.FAILED and self.attempt == gen:
                        self.exception = traceback.format_exc()
                        self.status = Job.FAILED
                        # the cloud, not the work, failed (a follower
                        # lost mid-op): the watchdog may resume it
                        self.failed_externally = isinstance(
                            e, CloudUnhealthyError)
            finally:
                if self.attempt == gen:
                    self.end_time = time.time()

        if background:
            self._thread = threading.Thread(target=run, daemon=True)
            self._thread.start()
        else:
            run()
        return self

    def update(self, progress: float, msg: str = "") -> None:
        """Progress tick; raises JobCancelled if a cancel was asked for."""
        if self._cancel_requested:
            raise JobCancelled()
        self.progress = float(progress)
        if msg:
            self.progress_msg = msg

    def publish_progress(self) -> None:
        """On a multi-process cloud, write this job's progress to the
        cloud's KV (``jobs/progress/{process}``)."""
        from h2o3_tpu_torch.parallel import distributed as D

        if D.process_count() > 1:
            import json

            D.kv_put(f"{_PROGRESS_PREFIX}{D.process_index()}",
                     json.dumps({"proc": D.process_index(),
                                 "job": str(self.key), "dest": self.dest,
                                 "description": self.description,
                                 "progress": self.progress,
                                 "msg": self.progress_msg,
                                 "ts": time.time()}))

    def fail(self, exception_text: str) -> None:
        """Mark FAILED from outside the worker thread (the worker may never
        unwind). No-op once terminal."""
        with self._status_lock:
            if not self.is_running:
                return
            self.exception = exception_text
            self.failed_externally = True
            self.status = Job.FAILED
            self.end_time = time.time()

    # -- locked terminal transitions for synchronous callers --------------
    def begin(self) -> bool:
        """CREATED/RESUMING -> RUNNING; False when the job was already
        failed from outside."""
        with self._status_lock:
            if self.status == Job.FAILED:
                return False
            self.status = Job.RUNNING
            self.start_time = time.time()
            return True

    def complete(self) -> bool:
        """RUNNING -> DONE; False (verdict kept) when an external FAILED
        landed first."""
        with self._status_lock:
            if self.status == Job.FAILED:
                return False
            self.status = Job.DONE
            self.progress = 1.0
            self.failed_externally = False
            self.end_time = time.time()
            return True

    def fail_local(self, exception_text: str) -> None:
        """Worker-side failure; an earlier external verdict is kept."""
        with self._status_lock:
            if self.status != Job.FAILED:
                self.exception = exception_text
                self.status = Job.FAILED
            self.end_time = time.time()

    def cancelled_local(self) -> None:
        """Worker-side end after JobCancelled (what `start` records for
        its own work); an external FAILED is kept."""
        with self._status_lock:
            if self.status != Job.FAILED:
                self.status = Job.CANCELLED
            self.end_time = time.time()

    def restart(self, resumed_from_iteration: Optional[int] = None) -> bool:
        """FAILED (externally) -> RESUMING for a re-dispatch; False when
        the job is not such a candidate."""
        with self._status_lock:
            if self.status != Job.FAILED or not self.failed_externally:
                return False
            self.status = Job.RESUMING
            self.attempt += 1
            self.failed_externally = False
            self.exception = None
            self.end_time = 0.0
            if resumed_from_iteration is not None:
                self.resumed_from_iteration = int(resumed_from_iteration)
            return True

    # -- client side ------------------------------------------------------
    def cancel(self) -> None:
        self._cancel_requested = True

    def join(self, timeout: Optional[float] = None) -> "Job":
        if self._thread is not None:
            self._thread.join(timeout)
        if self.status == Job.FAILED:
            raise RuntimeError(f"Job {self.key} failed:\n{self.exception}")
        return self

    @property
    def is_running(self) -> bool:
        return self.status in (Job.CREATED, Job.RUNNING, Job.RESUMING)

    def to_dict(self) -> dict:
        return {
            "key": str(self.key),
            "description": self.description,
            "status": self.status,
            "progress": self.progress,
            "progress_msg": self.progress_msg,
            "dest": self.dest,
            "exception": self.exception,
            "failed_externally": self.failed_externally,
            "attempt": self.attempt,
            "resumed_from_iteration": self.resumed_from_iteration,
            "start_time": self.start_time,
            "end_time": self.end_time,
        }

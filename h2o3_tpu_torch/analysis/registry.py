"""The analyzer's audited inputs for the port (the port's copy of
h2o3_tpu/analysis/registry.py, naming the port's own roots, locks and
chokepoints). Adding an entry here is a review event.

- the **mirrored roots**: entry points whose decisions every process of
  a multi-process cloud must make alike, because the control plane
  replays them; the mirrored pass closes over the call graph from here;
- the **knob helpers**: the sanctioned ``os.environ`` accessors;
- the **guarded functions**: audited call sites that look divergent but
  are safe, each with its reason;
- the **host-side modules**: code that never decides device work, where
  mirrored findings are suppressed (the call graph still flows through);
- the lock scope and declared order, the serialization homes, the
  compat-routed APIs and their homes, the compile-ledger recorders and
  exemptions, and the scan settings of the registry passes.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# mirrored-program pass
# ---------------------------------------------------------------------------

MIRRORED_ROOTS = (
    "h2o3_tpu_torch.parallel.oplog._apply",      # every op's replay
    "h2o3_tpu_torch.models.model_builder.ModelBuilder.train",
    "h2o3_tpu_torch.scoring.execute_batch",
    "h2o3_tpu_torch.rapids.eval.exec_rapids",
    "h2o3_tpu_torch.automl.search.SearchEngine.run",
    # the row mesh's collective sites: every rank runs them in step
    "h2o3_tpu_torch.core.mrtask.map_reduce",
    "h2o3_tpu_torch.parallel.mesh.RowMesh.all_reduce",
    "h2o3_tpu_torch.parallel.mesh.RowMesh.all_gather",
)

# sanctioned env accessors: the multi-process contract pins the env
# alike on every process, so a knob read through one decides alike
KNOB_HELPERS = frozenset({
    # the row mesh's collective timeout and the metrics publish
    # interval: the multi-process contract sets them alike everywhere
    "h2o3_tpu_torch.parallel.mesh.mesh_timeout_s",
    "h2o3_tpu_torch.obs.metrics._publish_interval_s",
    # H2O_TPU_PROFILE only adds a TimeLine record (and a sync) around a
    # map_reduce: it changes no result and no collective
    "h2o3_tpu_torch.core.mrtask.profiling",
    "h2o3_tpu_torch.utils.retry.env_int",
    "h2o3_tpu_torch.utils.retry.env_float",
    "h2o3_tpu_torch.core.runtime.OptArgs.from_env",
    "h2o3_tpu_torch.parallel.ckpt.job_ckpt_iters",
    "h2o3_tpu_torch.parallel.ckpt.ckpt_dir",         # host I/O path
    "h2o3_tpu_torch.rapids.fusion.enabled",
    "h2o3_tpu_torch.rapids.planner.enabled",
    "h2o3_tpu_torch.pipeline.enabled",
    "h2o3_tpu_torch.scoring._env_buckets",
    # H2O_TPU_SCORE_FAST: the fused leaf routing of a replayed
    # leaf_assignment/staged_proba op reads it; the multi-process
    # contract sets it alike on every process (README)
    "h2o3_tpu_torch.scoring.enabled",
    "h2o3_tpu_torch.automl.search._env_float",
    "h2o3_tpu_torch.automl.search.search_concurrency",
    # chunked ingest: read inside a replayed import_file/parse_stream;
    # the chunk layout is a pure function of (bytes, knobs), and the
    # multi-process contract sets the knobs alike
    "h2o3_tpu_torch.ingest.chunked.enabled",
    "h2o3_tpu_torch.ingest.chunked.ingest_workers",
    "h2o3_tpu_torch.kernels.nvcc",                   # toolchain path
    "h2o3_tpu_torch.native.cxx",                     # toolchain path
})

# audited divergent-looking call sites, each with its reason; the
# multi-process replay (ROADMAP A14.4) must keep each reason true
GUARDED = {
    "h2o3_tpu_torch.parallel.mesh.RowMesh._group_now":
        "the wall clock only spaces out reads of the recorded mesh "
        "generation; the group a collective runs on is that recorded "
        "generation's, the same on every rank, and a rank whose group "
        "lost a peer rebuilds at its next collective whatever the clock",
    "h2o3_tpu_torch.parallel.mesh.RowMesh._run":
        "the host clock times a collective for the mesh's counters "
        "(`stats`); no decision reads it",
    "h2o3_tpu_torch.models.model_builder.random_seed":
        "the one seed-derivation policy for seed=-1/0: a replayed train "
        "must carry the seed its coordinator drew (the reference's REST "
        "layer pins wildcard seeds before any broadcast)",
    "h2o3_tpu_torch.models.model_builder.ModelBuilder._out_of_time":
        "the max_runtime_secs budget gate: replayed trains clear "
        "max_runtime_secs before the op ships, as the reference's "
        "broadcast handlers do, so no deadline runs mirrored",
    "h2o3_tpu_torch.models.model.Model.__init__":
        "the random suffix of a model key is a process-local DKV name; "
        "keys that cross processes ride op payloads",
    "h2o3_tpu_torch.grid.H2OGridSearch.train":
        "the wall-clock budget loop: a replayed grid has its "
        "max_runtime_secs zeroed before broadcast, so the time-based "
        "break never fires mirrored",
    "h2o3_tpu_torch.automl.automl.H2OAutoML.__init__":
        "the timestamp default of project_name fires only when the "
        "caller passed none; a replayed spec pins project_name",
    "h2o3_tpu_torch.automl.automl.H2OAutoML.train":
        "the wall-clock budget and explore window: a replayed AutoML has "
        "max_runtime_secs zeroed before broadcast, so budget branches "
        "never fire mirrored",
}

HOST_SIDE_MODULES = {
    "h2o3_tpu_torch/obs/": "observability plane: span ids and timestamps "
                           "are process-local by design",
    "h2o3_tpu_torch/utils/": "logging, timeline and table utilities",
    "h2o3_tpu_torch/api/": "the REST layer runs on the coordinator only",
    "h2o3_tpu_torch/core/job.py": "job lifecycle metadata (timestamps, "
                                  "status); the device work lives in the "
                                  "builders",
    "h2o3_tpu_torch/core/failure.py": "heartbeat and health evidence",
    "h2o3_tpu_torch/parallel/oplog.py": "turnstile, ack and barrier "
                                        "deadlines are the hosts' waiting; "
                                        "the replay handlers' callees are "
                                        "the mirrored surface",
    "h2o3_tpu_torch/parallel/distributed.py": "store transport and "
                                              "leadership",
    "h2o3_tpu_torch/parallel/supervisor.py": "the health state machine",
    "h2o3_tpu_torch/parallel/watchdog.py": "the recovery daemon",
    "h2o3_tpu_torch/parallel/ckpt.py": "checkpoint and progress I/O; a "
                                       "restored state is shared through "
                                       "one file",
    "h2o3_tpu_torch/persist/": "storage backends (host I/O)",
    "h2o3_tpu_torch/admission.py": "serving admission happens before a "
                                   "request is published",
}

# ---------------------------------------------------------------------------
# lock-order pass
# ---------------------------------------------------------------------------

# every port module that takes a lock
LOCK_SCOPE = ("h2o3_tpu_torch/",)

# declared (outer, inner) acquisition pairs; the reverse edge is a
# finding. Lock ids are "<module-tail>.<name>" /
# "<module-tail>.<Class>.<attr>".
LOCK_ORDER = (
    # a scoring session's lock is held around its bucket program's run,
    # whose first run captures the CUDA graph under the process-wide
    # capture lock (ROADMAP C27)
    ("scoring.ScoringSession._lock", "runtime.CAPTURE_LOCK"),
    # the control plane. oplog.publish holds its sequence lock across the
    # op's put and its span, which closes into the trace store
    ("oplog._PUB_LOCK", "tracing._LOCK"),
    # a transition is recorded (timeline, the transitions counter) under
    # the supervisor's state lock
    ("supervisor._LOCK", "timeline._LOCK"),
    ("supervisor._LOCK", "metrics.Metric._lock"),
    # a completed train deletes its progress (and its KV record) under
    # the job's status lock, so an external FAILED cannot slip between
    ("job.Job._status_lock", "distributed._INDEX_LOCK"),
    # oplog._EXEC_COND (the turnstile) and ckpt._LOCK (the checkpoint
    # counters) are leaves: nothing is acquired while either is held
)

# ---------------------------------------------------------------------------
# serialization pass
# ---------------------------------------------------------------------------

# the only homes of restricted-Unpickler subclasses; raw loads are
# findings everywhere
PICKLE_ALLOWED = ("h2o3_tpu_torch/utils/unpickle.py",)

# ---------------------------------------------------------------------------
# compat-routing pass
# ---------------------------------------------------------------------------

DEVICE_ONLY_APIS = {
    "triton": "absent on a CPU box; kernels build only on the card",
    "torch.utils.cpp_extension": "needs a compiler toolchain at import",
    "torch._dynamo": "private and version-mobile",
    "torch.export": "version-mobile (its save/load format and passes "
                    "moved across releases)",
}
COMPAT_MODULES = ("h2o3_tpu_torch/compat.py", "h2o3_tpu_torch/kernels.py")

# ---------------------------------------------------------------------------
# compile-ledger pass
# ---------------------------------------------------------------------------

# capture/export function -> the function that records its ledger row
COMPILE_RECORDED_BY = {
    "h2o3_tpu_torch.rapids.fusion.capture":
        "h2o3_tpu_torch.rapids.fusion.GraphProgram._first_run",
    "h2o3_tpu_torch.scoring.BucketProgram._capture":
        "h2o3_tpu_torch.scoring.ScoringSession._program",
    "h2o3_tpu_torch.artifact.aot.export_forest_bucket":
        "h2o3_tpu_torch.artifact.export._programs",
    "h2o3_tpu_torch.artifact.aot.export_glm_bucket":
        "h2o3_tpu_torch.artifact.export._programs",
    "h2o3_tpu_torch.artifact.pipeline.export_pipeline_bucket":
        "h2o3_tpu_torch.artifact.export._programs",
}

# modules whose captures record no row, with the reason
COMPILE_EXEMPT = {
    "h2o3_tpu_torch/artifact/runner.py":
        "the standalone runner, run as a file without the package: it "
        "has no ledger to write to",
}

# ---------------------------------------------------------------------------
# sync-hygiene pass
# ---------------------------------------------------------------------------

# modules whose except-pass handlers are findings
SWALLOW_SCOPE = (
    "h2o3_tpu_torch/parallel/watchdog.py",
    "h2o3_tpu_torch/parallel/supervisor.py",
)

# ---------------------------------------------------------------------------
# registry passes
# ---------------------------------------------------------------------------

# the tests that drive the port (fault points, by inject)
TEST_FILES = ("test_torch_*.py", "torch_*_support.py")

# declared names nothing in the port emits or enters yet, each kept with
# its reason (the registry passes flag every other one)
METRICS_RESERVED = {
    "h2o3_phase_cpu_fallbacks_total":
        "the port never falls back to the CPU when a phase's deadline "
        "expires (it records and, on request, exits); kept for the "
        "reference's series set",
}
PHASES_RESERVED = {
    "mesh_init": "one card has no device mesh to build",
    "compile_cache_load": "nothing loads a persistent compile cache at "
                          "boot; the export cache loads per artifact",
}

# test files whose strings quote faultpoints on purpose
FAULTPOINT_SCAN_EXCLUDE = ("tests/test_torch_analysis.py",)

# README.md's port section starts at this heading and runs to the end
README_SECTION = "## PyTorch/CUDA port"

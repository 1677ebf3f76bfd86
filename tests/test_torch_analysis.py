"""The port's invariant analyzer (h2o3_tpu_torch/analysis/) on the CPU:
the whole-port run is clean and fast and imports no JAX, each of the ten
passes finds its violation in a small synthetic project (a positive and
a near-miss negative, the applicable cases of tests/test_analysis.py
read for the port), the baseline mechanics hold, and for the passes
whose rule is the same in both packages (serialization, lock-order,
knob-docs, faultpoints) the JAX package's analyzer finds the same
(pass, line, symbol) in the same fixture."""

import json
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

from h2o3_tpu_torch import analysis
from h2o3_tpu_torch.analysis import core as acore

ROOT = Path(__file__).resolve().parents[1]
# fixture tests arm fault points through this name, spelled so that no
# analyzer's scan of this file reads them as armed
ARM = "inj" + "ect"

_DEFAULTS = dict(
    MIRRORED_ROOTS=(), KNOB_HELPERS=frozenset(), GUARDED={},
    HOST_SIDE_MODULES={}, LOCK_SCOPE=("h2o3_tpu_torch/",), LOCK_ORDER=(),
    PICKLE_ALLOWED=(), COMPAT_MODULES=("h2o3_tpu_torch/compat.py",),
    DEVICE_ONLY_APIS={"triton": "no triton on a CPU box",
                      "torch.export": "version-mobile"},
    COMPILE_RECORDED_BY={}, COMPILE_EXEMPT={}, SWALLOW_SCOPE=(),
    TEST_FILES=("test_torch_*.py",), FAULTPOINT_SCAN_EXCLUDE=(),
    METRICS_RESERVED={}, PHASES_RESERVED={})


def write(root, files, pkg):
    (root / pkg).mkdir(parents=True, exist_ok=True)
    (root / pkg / "__init__.py").write_text("")
    for rel, src in files.items():
        p = root / rel.format(pkg=pkg)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src).replace("{pkg}", pkg))


def mini_ctx(tmp_path, files, **reg):
    """Context over a synthetic port tree with a stand-in registry."""
    write(tmp_path, files, "h2o3_tpu_torch")
    r = dict(_DEFAULTS)
    r.update(reg)
    return acore.make_context(tmp_path, registry=types.SimpleNamespace(**r))


def run_pass(ctx, name):
    return analysis.run(ctx, [name])


def msgs(got):
    return " ".join(f.message for f in got)


# ---------------------------------------------------------------------------
# the whole port
# ---------------------------------------------------------------------------

_WHOLE_RUN = r'''
import json, sys, time
from h2o3_tpu_torch.analysis.__main__ import main
t0 = time.perf_counter()
rc = main(["--json"])
dt = time.perf_counter() - t0
from h2o3_tpu_torch.analysis import core
ctx = core.make_context()
bad = [k for k in sys.modules if k == "jax" or k.startswith("jax.")
       or k.split(".")[0] in ("h2o3_tpu", "h2o3_genmodel")]
rels = sorted({m.rel.split("/")[0] for m in ctx.project.modules.values()})
print(json.dumps({"rc": rc, "seconds": dt, "imported": bad,
                  "roots": rels}))
'''


def test_whole_port_run_is_clean_fast_and_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _WHOLE_RUN], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    tail = json.loads(lines[-1])
    report = json.loads("\n".join(lines[:-1]))
    assert tail["rc"] == 0, report["findings"]
    assert report["findings"] == []
    assert report["baseline_problems"] == []
    assert tail["seconds"] < 10.0, tail      # the reference's budget
    assert tail["imported"] == []
    assert tail["roots"] == ["h2o3_tpu_torch"]


def test_baseline_holds_only_noted_baselineable_entries():
    entries = analysis.load_baseline(ROOT / analysis.BASELINE_NAME)
    for e in entries:
        assert e["pass"] in analysis.BASELINEABLE, e
        assert e["note"] and not e["note"].startswith("TODO"), e


def test_analyzer_sources_import_only_the_stdlib_and_itself():
    import ast

    for p in sorted((ROOT / "h2o3_tpu_torch" / "analysis").glob("*.py")):
        for node in ast.walk(ast.parse(p.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                root = n.split(".")[0]
                assert n.startswith("h2o3_tpu_torch.analysis") or \
                    n == "h2o3_tpu_torch" or \
                    root in sys.stdlib_module_names or \
                    root == "__future__", (p.name, n)


# ---------------------------------------------------------------------------
# one synthetic violation per pass (and its near miss)
# ---------------------------------------------------------------------------

def _mirrored_wallclock(tmp_path):
    ctx = mini_ctx(tmp_path, {"{pkg}/work.py": """
        import time

        def handler(p):
            helper()
            meta()

        def helper():
            deadline = time.time() + 5
            while time.time() < deadline:
                pass

        def meta():
            t0 = time.time()
            return time.time() - t0

        def unreachable():
            if time.time() > 0:
                pass
    """}, MIRRORED_ROOTS=("h2o3_tpu_torch.work.handler",))
    syms = {f.symbol for f in run_pass(ctx, "mirrored")}
    assert any("helper" in s for s in syms), syms
    assert not any("meta" in s or "unreachable" in s for s in syms)


def _mirrored_prng(tmp_path):
    ctx = mini_ctx(tmp_path, {"{pkg}/work.py": """
        import numpy as np
        import torch

        def handler(p, gen):
            bad = np.random.default_rng()
            ok = np.random.default_rng(42)
            noise = torch.randn(3)
            seeded = torch.randn(3, generator=gen)
            return bad, ok, noise, seeded
    """}, MIRRORED_ROOTS=("h2o3_tpu_torch.work.handler",))
    got = run_pass(ctx, "mirrored")
    assert len(got) == 2, got
    assert "default_rng" in msgs(got) and "torch.randn" in msgs(got)


def _mirrored_env(tmp_path):
    files = {"{pkg}/work.py": """
        import os

        def handler(p):
            if os.environ.get("H2O_TPU_X"):
                return 1
            if knob():
                return 2

        def knob():
            v = os.environ.get("H2O_TPU_X")
            if v is None:
                return 0
            return int(v)
    """}
    got = run_pass(mini_ctx(tmp_path, files, MIRRORED_ROOTS=(
        "h2o3_tpu_torch.work.handler",)), "mirrored")
    assert {f.symbol for f in got} == {"work.handler", "work.knob"}, got
    got = run_pass(mini_ctx(tmp_path, files, MIRRORED_ROOTS=(
        "h2o3_tpu_torch.work.handler",), KNOB_HELPERS=frozenset(
        {"h2o3_tpu_torch.work.knob"})), "mirrored")
    assert {f.symbol for f in got} == {"work.handler"}, got


def _mirrored_guarded(tmp_path):
    files = {"{pkg}/work.py": """
        import time

        from h2o3_tpu_torch.obs import spans

        def handler(p):
            if time.time() > 1:
                pass
            spans.tick()
    """, "{pkg}/obs/spans.py": """
        import time

        def tick():
            if time.monotonic() > 0:
                pass
    """}
    ctx = mini_ctx(tmp_path, files,
                   MIRRORED_ROOTS=("h2o3_tpu_torch.work.handler",),
                   GUARDED={"h2o3_tpu_torch.work.handler": "audited"},
                   HOST_SIDE_MODULES={"h2o3_tpu_torch/obs/": "host"})
    assert run_pass(ctx, "mirrored") == []
    ctx = mini_ctx(tmp_path, files,
                   MIRRORED_ROOTS=("h2o3_tpu_torch.work.gone",))
    got = run_pass(ctx, "mirrored")
    assert len(got) == 1 and "resolves to no project function" in \
        got[0].message


_AB_BA = """
    import threading
    A = threading.Lock()
    B = threading.Lock()

    def ab():
        with A:
            with B:
                pass

    def ba():
        with B:
            with A:
                pass
"""

_INTERPROC = """
    import threading
    A = threading.Lock()
    B = threading.Lock()

    def outer():
        with A:
            inner()

    def inner():
        with B:
            pass

    def reversed_path():
        with B:
            with A:
                pass
"""

_SELF_NEST = """
    import threading
    A = threading.Lock()
    R = threading.RLock()

    def bad():
        with A:
            with A:
                pass

    def fine():
        with R:
            with R:
                pass
"""


def _locks_cycle(tmp_path):
    got = run_pass(mini_ctx(tmp_path, {"{pkg}/locks.py": _AB_BA}),
                   "lock-order")
    assert any("cycle" in f.message for f in got), got
    got = run_pass(mini_ctx(tmp_path, {"{pkg}/locks.py": _INTERPROC}),
                   "lock-order")
    assert any("cycle" in f.message for f in got), got


def _locks_consistent_and_declared(tmp_path):
    ctx = mini_ctx(tmp_path, {"{pkg}/locks.py": """
        import threading
        A = threading.Lock()
        B = threading.Lock()

        def ab():
            with A:
                with B:
                    pass

        def ab2():
            with A:
                with B:
                    pass
    """}, LOCK_ORDER=(("locks.A", "locks.B"),))
    assert run_pass(ctx, "lock-order") == []
    ctx = mini_ctx(tmp_path, {"{pkg}/locks.py": """
        import threading
        A = threading.Lock()
        B = threading.Lock()

        def ba():
            with B:
                with A:
                    pass
    """}, LOCK_ORDER=(("locks.A", "locks.B"),))
    assert "reversed" in msgs(run_pass(ctx, "lock-order"))


def _locks_self_nesting(tmp_path):
    got = run_pass(mini_ctx(tmp_path, {"{pkg}/locks.py": _SELF_NEST}),
                   "lock-order")
    assert len(got) == 1 and "self-deadlock" in got[0].message, got


_SER = """
    import pickle
    import numpy as np
    import torch

    def bad(f):
        return pickle.load(f)

    def bad2(path):
        return np.load(path, allow_pickle=True)

    def bad3(path):
        return torch.load(path, weights_only=False)

    def fine(path):
        return np.load(path, allow_pickle=False), torch.load(
            path, weights_only=True)

    def restore(blob, loads=None):
        loads = loads or pickle.loads
        return loads(blob)

    class MyUnpickler(pickle.Unpickler):
        pass
"""


def _serialization(tmp_path):
    got = run_pass(mini_ctx(tmp_path, {"{pkg}/io2.py": _SER}),
                   "serialization")
    m = msgs(got)
    assert len(got) == 5, got
    for word in ("pickle.load", "allow_pickle", "weights_only=False",
                 "pickle.loads", "Unpickler subclass"):
        assert word in m, word
    # the homes bound Unpickler definitions; raw loads stay findings
    got = run_pass(mini_ctx(tmp_path, {"{pkg}/io2.py": _SER},
                            PICKLE_ALLOWED=("h2o3_tpu_torch/io2.py",)),
                   "serialization")
    assert len(got) == 4 and "Unpickler" not in msgs(got), got


def _compat(tmp_path):
    files = {"{pkg}/use.py": """
        import triton

        def export(mod, args):
            import torch
            return torch.export.export(mod, args)
    """, "{pkg}/compat.py": """
        import triton.language

        def torch_export():
            import torch.export
            return torch.export
    """, "{pkg}/fine.py": """
        from h2o3_tpu_torch import compat

        def export(mod, args):
            return compat.torch_export().export(mod, args)
    """}
    got = run_pass(mini_ctx(tmp_path, files), "compat-routing")
    by_file = sorted((f.file, f.line) for f in got)
    assert by_file == [("h2o3_tpu_torch/compat.py", 2),
                       ("h2o3_tpu_torch/use.py", 2),
                       ("h2o3_tpu_torch/use.py", 6)], got
    assert "module-level import" in msgs(
        [f for f in got if f.file.endswith("compat.py")])


def _compile_ledger(tmp_path):
    files = {"{pkg}/cap.py": """
        import torch

        from h2o3_tpu_torch.obs import compiles

        def bare(fn):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                fn()
            return g

        def recorded(fn):
            g = torch.cuda.CUDAGraph()
            g.capture_begin()
            fn()
            g.capture_end()
            compiles.record_compile("rapids", "sig", 1.0)

        def timed_export(mod, args):
            with compiles.timed("artifact", "sig"):
                return torch.export.export(mod, args)

        def capture_only(fn):
            g = torch.cuda.CUDAGraph()
            g.capture_begin()
            fn()
            g.capture_end()
            return g

        def caller(fn):
            g = capture_only(fn)
            compiles.record_compile("scoring", "sig", 1.0)
            return g
    """}
    got = run_pass(mini_ctx(tmp_path, files), "compile-ledger")
    assert {f.symbol for f in got} == {"cap.bare", "cap.capture_only"}, got
    got = run_pass(mini_ctx(tmp_path, files, COMPILE_RECORDED_BY={
        "h2o3_tpu_torch.cap.capture_only": "h2o3_tpu_torch.cap.caller",
        "h2o3_tpu_torch.cap.bare": "h2o3_tpu_torch.cap.gone"}),
        "compile-ledger")
    assert {f.symbol for f in got} == {"cap.bare",
                                       "h2o3_tpu_torch.cap.gone"}, got
    got = run_pass(mini_ctx(tmp_path, files, COMPILE_EXEMPT={
        "h2o3_tpu_torch/cap.py": "standalone"}), "compile-ledger")
    assert got == []


def _sync_hygiene(tmp_path):
    ctx = mini_ctx(tmp_path, {"{pkg}/hot.py": """
        import torch

        from h2o3_tpu_torch.obs import tracing

        def instrumented(out):
            with tracing.span("fetch"):
                n = out.sum().item()
                torch.cuda.synchronize()
            return n, out.cpu()
    """})
    got = run_pass(ctx, "sync-hygiene")
    assert sorted(f.line for f in got) == [8, 9], got
    ctx = mini_ctx(tmp_path, {"{pkg}/parallel/watchdog.py": """
        def tick():
            try:
                work()
            except Exception:
                pass
    """}, SWALLOW_SCOPE=("h2o3_tpu_torch/parallel/watchdog.py",))
    assert "swallowed" in msgs(run_pass(ctx, "sync-hygiene"))


def _faultpoints(tmp_path):
    files = {
        "{pkg}/faults.py": 'def f():\n    faultpoint("real.point")\n',
        "tests/test_torch_x.py": f'def test_a():\n    {ARM}("gone.point")\n',
    }
    got = run_pass(mini_ctx(tmp_path, files), "faultpoints")
    assert {f.symbol for f in got} == {"gone.point", "real.point"}, got
    assert "armed by no port test" in msgs(
        [f for f in got if f.symbol == "real.point"])
    files["tests/test_torch_x.py"] = \
        f'def test_a():\n    {ARM}("real.point")\n'
    # a test outside TEST_FILES arms nothing of the port
    files["tests/test_other.py"] = f'def test_b():\n    {ARM}("jax.only")\n'
    assert run_pass(mini_ctx(tmp_path, files), "faultpoints") == []


def _metric_registry(tmp_path):
    files = {"{pkg}/obs/metrics.py": """
        def reg(r):
            r.counter("h2o3_good_total", "x")
            r.counter("h2o3_good_total", "x")
            r.gauge("BadName", "x")
            r.counter("h2o3_dead_total", "x")
            r.gauge_fn("h2o3_collected", "x", lambda: 0.0)
    """, "{pkg}/use.py": """
        from h2o3_tpu_torch.obs import metrics

        def f():
            metrics.inc("h2o3_good_total")
            metrics.inc("BadName")
            metrics.observe("h2o3_unregistered_seconds", 1.0)
    """}
    got = run_pass(mini_ctx(tmp_path, files), "metric-registry")
    m = msgs(got)
    assert "registered 2 times" in m and "BadName" in m
    assert "h2o3_unregistered_seconds" in m and "emitted but never" in m
    assert "h2o3_dead_total" in m and "nothing emits it" in m
    assert "h2o3_collected" not in m
    got = run_pass(mini_ctx(tmp_path, files, METRICS_RESERVED={
        "h2o3_dead_total": "why"}), "metric-registry")
    assert "h2o3_dead_total" not in msgs(got)


def _timeline_kinds(tmp_path):
    files = {
        "{pkg}/utils/timeline.py": 'KINDS = frozenset({"alpha"})\n',
        "{pkg}/user.py": 'from h2o3_tpu_torch.utils import timeline\n'
                         'def f():\n    timeline.record("beta", "x")\n',
        "{pkg}/obs/phases.py":
            'PHASES = frozenset({"backend_init", "mesh_init", '
            '"first_compile"})\n',
        "{pkg}/boot.py": 'from h2o3_tpu_torch.obs import phases\n'
                         'def f():\n'
                         '    with phases.enter("warp_init"):\n'
                         '        pass\n'
                         '    with phases.first("first_compile"):\n'
                         '        pass\n',
    }
    got = run_pass(mini_ctx(tmp_path, files), "timeline-kinds")
    assert {f.symbol for f in got} == {"alpha", "beta", "warp_init",
                                       "backend_init", "mesh_init"}, got
    files["{pkg}/user.py"] = ('from h2o3_tpu_torch.utils import timeline\n'
                              'def f():\n    timeline.record("alpha", "x")\n')
    files["{pkg}/boot.py"] = ('from h2o3_tpu_torch.obs import phases\n'
                              'def f():\n'
                              '    with phases.enter("backend_init"):\n'
                              '        pass\n'
                              '    with phases.first("first_compile"):\n'
                              '        pass\n')
    got = run_pass(mini_ctx(tmp_path, files, PHASES_RESERVED={
        "mesh_init": "no mesh"}), "timeline-kinds")
    assert got == []


def _knob_docs(tmp_path):
    files = {"{pkg}/k.py": 'import os\ndef f():\n'
                           '    return os.environ.get("H2O_TPU_SECRET")\n'}
    got = run_pass(mini_ctx(tmp_path, files), "knob-docs")
    assert len(got) == 1 and "H2O_TPU_SECRET" in got[0].message
    (tmp_path / "README.md").write_text(
        "reference index: H2O_TPU_SECRET\n\n## PyTorch/CUDA port\nnone\n")
    got = run_pass(mini_ctx(tmp_path, files), "knob-docs")
    assert len(got) == 1, "documented only above the port section"
    (tmp_path / "README.md").write_text(
        "## PyTorch/CUDA port\n- `H2O_TPU_SECRET`: a knob\n")
    assert run_pass(mini_ctx(tmp_path, files), "knob-docs") == []


_CASES = {
    "mirrored-wallclock": _mirrored_wallclock,
    "mirrored-prng": _mirrored_prng,
    "mirrored-raw-env": _mirrored_env,
    "mirrored-guarded-host-side": _mirrored_guarded,
    "lock-order-cycle": _locks_cycle,
    "lock-order-declared": _locks_consistent_and_declared,
    "lock-order-self-nesting": _locks_self_nesting,
    "serialization": _serialization,
    "compat-routing": _compat,
    "compile-ledger": _compile_ledger,
    "sync-hygiene": _sync_hygiene,
    "faultpoints": _faultpoints,
    "metric-registry": _metric_registry,
    "timeline-kinds": _timeline_kinds,
    "knob-docs": _knob_docs,
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_pass_finds_its_violation(tmp_path, case):
    _CASES[case](tmp_path)


def test_every_pass_has_a_case():
    assert {next(p for p in analysis.PASSES if c.startswith(p))
            for c in _CASES} == set(analysis.PASSES)


# ---------------------------------------------------------------------------
# the same rule in both packages: the same findings
# ---------------------------------------------------------------------------

_PARITY = {
    "serialization": {"{pkg}/io2.py": _SER.replace(
        "import torch\n", "").replace(
        "\n    def bad3(path):\n        return torch.load(path, "
        "weights_only=False)\n", "").replace(
        ", torch.load(\n            path, weights_only=True)", "")},
    "lock-order": {"{pkg}/locks.py": _AB_BA,
                   "{pkg}/more.py": _SELF_NEST},
    "knob-docs": {"{pkg}/k.py": 'import os\ndef f():\n'
                                '    return os.environ.get("H2O_TPU_A")\n'
                                'B = "H2O_TPU_B"\n'},
    "faultpoints": {"{pkg}/faults.py": 'def f():\n'
                                       '    faultpoint("kept.point")\n',
                    "tests/test_torch_x.py":
                        f'def test_a():\n    {ARM}("kept.point")\n'
                        f'    {ARM}("gone.point")\n'},
}


def _keyed(findings, pkg):
    return sorted((f.pass_id, f.line, f.symbol.replace(pkg + "/", "PKG/"))
                  for f in findings)


@pytest.mark.parametrize("pass_id", sorted(_PARITY))
def test_same_findings_as_the_reference_analyzer(tmp_path, pass_id):
    from h2o3_tpu import analysis as janalysis
    from h2o3_tpu.analysis import core as jcore

    files = _PARITY[pass_id]
    port_root, ref_root = tmp_path / "port", tmp_path / "ref"
    write(port_root, files, "h2o3_tpu_torch")
    write(ref_root, files, "h2o3_tpu")
    reg = dict(LOCK_SCOPE=None, PICKLE_ALLOWED=(), LOCK_ORDER=(),
               FAULTPOINT_SCAN_EXCLUDE=(), TEST_FILES=("test_torch_*.py",))
    preg = types.SimpleNamespace(**dict(_DEFAULTS, **dict(
        reg, LOCK_SCOPE=("h2o3_tpu_torch/",))))
    jreg = types.SimpleNamespace(**dict(reg, LOCK_SCOPE=("h2o3_tpu/",)))
    port = analysis.run(acore.make_context(port_root, registry=preg),
                        [pass_id])
    ref = janalysis.run(jcore.make_context(ref_root, registry=jreg),
                        [pass_id])
    assert port, "the fixture must violate the rule"
    assert _keyed(port, "h2o3_tpu_torch") == _keyed(ref, "h2o3_tpu")


# ---------------------------------------------------------------------------
# baseline mechanics and the CLI
# ---------------------------------------------------------------------------

def _one_finding(tmp_path):
    ctx = mini_ctx(tmp_path, {"{pkg}/hot.py": """
        from h2o3_tpu_torch.obs import tracing

        def instrumented(out):
            with tracing.span("d"):
                return out.cpu()
    """})
    got = run_pass(ctx, "sync-hygiene")
    assert len(got) == 1
    return got


def _baseline_roundtrip(tmp_path):
    got = _one_finding(tmp_path)
    bl = tmp_path / "BL.json"
    analysis.save_baseline(bl, got, notes={got[0].fingerprint: "audited"})
    new, problems = analysis.apply_baseline(got,
                                            analysis.load_baseline(bl))
    assert new == [] and problems == [] and got[0].note == "audited"


def _baseline_stale(tmp_path):
    got = _one_finding(tmp_path)
    new, problems = analysis.apply_baseline(got, [
        {"fingerprint": "deadbeef0000", "pass": "sync-hygiene",
         "file": "gone.py", "note": "was ok"}])
    assert len(new) == 1
    assert len(problems) == 1 and "stale" in problems[0].message


def _baseline_refuses_other_passes(tmp_path):
    f = acore.Finding("lock-order", "x.py", 1, "m", snippet="s")
    with pytest.raises(ValueError, match="not\\s+baselineable"):
        analysis.save_baseline(tmp_path / "b.json", [f])
    _new, problems = analysis.apply_baseline(
        [], [{"fingerprint": "abc", "pass": "mirrored", "note": "n"}])
    assert len(problems) == 1 and "mirrored" in problems[0].message
    _new, problems = analysis.apply_baseline(
        [], [{"fingerprint": "abc", "pass": "sync-hygiene",
              "note": "TODO: one-line justification"}])
    assert any("no justification" in p.message for p in problems)


def _cli(tmp_path, capsys=None):
    from h2o3_tpu_torch.analysis.__main__ import main

    write(tmp_path, {"{pkg}/hot.py": """
        from h2o3_tpu_torch.obs import tracing

        def instrumented(out):
            with tracing.span("d"):
                return out.cpu()
    """}, "h2o3_tpu_torch")
    bl = tmp_path / acore.BASELINE_NAME
    assert main([str(tmp_path), "--select", "sync-hygiene"]) == 1
    assert main([str(tmp_path), "--select", "sync-hygiene",
                 "--update-baseline"]) == 0
    assert bl.is_file()
    data = json.loads(bl.read_text())
    # (the real registry's paths are stale in this tree: their
    # sync-hygiene self-check findings are baselined too)
    for e in data["entries"]:
        assert e["note"].startswith("TODO")
        e["note"] = "audited in this fixture"
    bl.write_text(json.dumps(data))
    assert main([str(tmp_path), "--select", "sync-hygiene", "--json"]) == 0
    assert main([str(tmp_path), "--select", "no-such-pass"]) == 2


_BASELINE_CASES = {"roundtrip": _baseline_roundtrip,
                   "stale-entry": _baseline_stale,
                   "other-passes-refused": _baseline_refuses_other_passes,
                   "cli": _cli}


@pytest.mark.parametrize("case", sorted(_BASELINE_CASES))
def test_baseline_and_cli(tmp_path, case):
    _BASELINE_CASES[case](tmp_path)

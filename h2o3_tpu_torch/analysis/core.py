"""Finding/baseline plumbing shared by every analysis pass (the port's
copy of h2o3_tpu/analysis/core.py; it scans ``h2o3_tpu_torch/`` only).

A finding's **fingerprint** is content-addressed — sha1 over (pass id,
repo-relative file, enclosing symbol, the stripped source line text) — so
baseline entries survive unrelated line drift but go STALE the moment the
offending line changes or disappears. Stale entries are themselves
findings: a baseline that references nothing keeps nobody honest.

Baselines are deliberately narrow: only the ``sync-hygiene`` and
``compat-routing`` passes may be baselined (benign, audited leftovers).
A baseline entry against any other pass is an error finding — mirrored-
program, lock-order and serialization violations get FIXED, not filed.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from h2o3_tpu_torch.analysis.callgraph import Project

PKG = "h2o3_tpu_torch"
REGISTRY_FILE = f"{PKG}/analysis/registry.py"
# the baseline lives beside the analyzer, apart from the JAX package's
BASELINE_NAME = f"{PKG}/analysis/baseline.json"
# passes whose findings may be accepted into the baseline (with a note)
BASELINEABLE = frozenset({"sync-hygiene", "compat-routing"})


@dataclass
class Finding:
    pass_id: str
    file: str              # repo-relative posix path
    line: int
    message: str
    symbol: str = ""       # enclosing function/class qualname (tail)
    snippet: str = ""      # stripped source line (fingerprint input)
    note: str = ""         # set when matched by a baseline entry

    @property
    def fingerprint(self) -> str:
        h = hashlib.sha1()
        h.update("|".join((self.pass_id, self.file, self.symbol,
                           self.snippet)).encode("utf-8"))
        return h.hexdigest()[:12]

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.file}:{self.line}: [{self.pass_id}]{sym} "
                f"{self.message}  (fp={self.fingerprint})")

    def to_dict(self) -> dict:
        return {"pass": self.pass_id, "file": self.file, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "fingerprint": self.fingerprint, "snippet": self.snippet}


@dataclass
class Context:
    """Everything a pass needs: parsed project + registry + roots."""

    root: Path
    project: Project
    registry: object            # registry module (or a test stand-in)
    tests_dir: Optional[Path] = None
    _cache: dict = field(default_factory=dict)

    def reg(self, name: str, default=None):
        return getattr(self.registry, name, default)

    def finding(self, pass_id: str, module, node, message: str,
                symbol: str = "") -> Finding:
        line = getattr(node, "lineno", 0) if node is not None else 0
        return Finding(pass_id=pass_id, file=module.rel, line=line,
                       message=message, symbol=symbol,
                       snippet=module.line(line))


def make_context(root: Optional[Path] = None, registry=None) -> Context:
    from h2o3_tpu_torch.analysis import registry as default_registry

    if root is None:
        root = Path(__file__).resolve().parents[2]
    root = Path(root)
    project = Project(root, pkg_dirs=(PKG,))
    tests = root / "tests"
    return Context(root=root, project=project,
                   registry=registry or default_registry,
                   tests_dir=tests if tests.is_dir() else None)


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def load_baseline(path: Path) -> List[dict]:
    if not Path(path).is_file():
        return []
    data = json.loads(Path(path).read_text(encoding="utf-8"))
    entries = data.get("entries", []) if isinstance(data, dict) else data
    return [e for e in entries if isinstance(e, dict)]


def save_baseline(path: Path, findings: List[Finding],
                  notes: Optional[Dict[str, str]] = None,
                  keep_entries: Optional[List[dict]] = None) -> None:
    """Write accepted findings as a baseline, preserving notes by
    fingerprint. Refuses non-baselineable passes. `keep_entries` are
    existing entries carried over verbatim (a partial ``--select``
    update must not delete entries belonging to unselected passes)."""
    notes = notes or {}
    entries = []
    for f in sorted(findings, key=lambda f: (f.file, f.line)):
        if f.pass_id not in BASELINEABLE:
            raise ValueError(
                f"finding {f.fingerprint} ({f.pass_id}) is not "
                f"baselineable — fix it ({', '.join(sorted(BASELINEABLE))} "
                f"only)")
        entries.append({
            "fingerprint": f.fingerprint, "pass": f.pass_id,
            "file": f.file, "symbol": f.symbol,
            "note": notes.get(f.fingerprint, f.note
                              or "TODO: one-line justification"),
        })
    have = {e["fingerprint"] for e in entries}
    for e in keep_entries or []:
        if e.get("fingerprint") not in have:
            entries.append(e)
    payload = {"version": 1, "entries": entries}
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(json.dumps(payload, indent=2) + "\n",
                          encoding="utf-8")


def apply_baseline(findings: List[Finding], entries: List[dict]) \
        -> Tuple[List[Finding], List[Finding]]:
    """Split (new, problems): `new` are findings not covered by the
    baseline; `problems` are baseline-hygiene findings (stale entries,
    entries against non-baselineable passes, missing notes)."""
    by_fp: Dict[str, List[Finding]] = {}
    for f in findings:
        by_fp.setdefault(f.fingerprint, []).append(f)
    new = list(findings)
    problems: List[Finding] = []
    for e in entries:
        fp = str(e.get("fingerprint", ""))
        pid = str(e.get("pass", ""))
        note = str(e.get("note", "")).strip()
        if pid not in BASELINEABLE:
            problems.append(Finding(
                "baseline", BASELINE_NAME, 0,
                f"entry {fp} accepts a {pid!r} finding — only "
                f"{sorted(BASELINEABLE)} may be baselined; fix the code",
                symbol=fp, snippet=fp))
            continue
        if not note or note.startswith("TODO"):
            problems.append(Finding(
                "baseline", BASELINE_NAME, 0,
                f"entry {fp} has no justification note", symbol=fp,
                snippet=fp))
        hits = by_fp.get(fp)
        if not hits:
            problems.append(Finding(
                "baseline", BASELINE_NAME, 0,
                f"stale entry {fp} ({e.get('file')}): the finding it "
                f"accepts no longer exists — remove it", symbol=fp,
                snippet=fp))
            continue
        # one entry covers EVERY finding sharing the fingerprint (the
        # same line repeated at several call sites hashes identically)
        for hit in hits:
            hit.note = note
            if hit in new:
                new.remove(hit)
    return new, problems

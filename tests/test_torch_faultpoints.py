"""The port's fault points that no other port test arms, driven on the
CPU (the invariant analyzer's faultpoints pass requires every
``failure.faultpoint`` in the port to be armed by a port test):

- ``phases.deadline``: a lifecycle phase that wedges past its hard
  deadline is marked ``deadline``, counted, and leaves a flight record;
- ``search.state_save``: a failed search-state save is counted, never
  raises, and the previous snapshot stands."""

import h2o3_tpu_torch as th
from h2o3_tpu_torch.core import failure
from h2o3_tpu_torch.obs import metrics, phases


def test_phase_past_its_deadline_is_marked_and_recorded(monkeypatch,
                                                         tmp_path):
    th.init(device="cpu")
    monkeypatch.setenv("H2O_TPU_PHASE_DEADLINE_S", "server_start=0.05")
    monkeypatch.setenv("H2O_TPU_OBS_FLIGHT_DIR", str(tmp_path))
    m = metrics.REGISTRY.get("h2o3_phase_deadline_exceeded_total")
    before = m.snapshot()
    with failure.inject("phases.deadline"):
        with phases.enter("server_start") as rec:
            pass
    assert rec["status"] == "deadline"
    assert rec.get("flight_record")
    assert any(p.name.startswith("phase_deadline_server_start")
               or "phase_deadline_server_start" in p.read_text()
               for p in tmp_path.iterdir())
    assert m.snapshot() != before
    # unarmed, the same phase completes inside its deadline
    with phases.enter("server_start") as rec2:
        pass
    assert rec2["status"] == "ok"


def test_failed_search_state_save_keeps_the_previous_snapshot(tmp_path):
    from h2o3_tpu_torch.automl import search
    from h2o3_tpu_torch.parallel import ckpt

    th.init(device="cpu")
    eng = search.SearchEngine("fp_search", "grid", {"dest": "g1"},
                              sdir=str(tmp_path))
    eng.save()
    first = ckpt.load_search_state("fp_search", sdir=str(tmp_path))
    s0 = search.stats()
    with failure.inject("search.state_save"):
        eng.save()                       # never raises
    s1 = search.stats()
    assert s1["state_save_errors"] == s0["state_save_errors"] + 1
    assert s1["state_saves"] == s0["state_saves"]
    assert ckpt.load_search_state("fp_search",
                                  sdir=str(tmp_path)) == first
    eng.save()
    assert search.stats()["state_saves"] == s0["state_saves"] + 1

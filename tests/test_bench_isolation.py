"""bench.py metric failure isolation: ``bench._emit`` converts any failure
into an {"metric", "error"} JSON line and keeps going, so one failing
metric cannot hide the others, and every line names the device it ran
on; ``bench.main`` then exits non-zero.  Pure-Python test (no jax)."""

import json
import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import bench

DEVICE = {
    "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
    "name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W",
}


def test_emit_isolates_failures(capsys):
    def boom():
        raise AssertionError("cell cap exhausted: max occupancy 33 > cap 32")

    ok = bench._emit("broken secondary", boom, "steps/s", 10.0, DEVICE)
    assert ok is False
    ok2 = bench._emit("surviving metric", lambda: 42.0, "steps/s", 10.0, DEVICE)
    assert ok2 is True
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert recs[0]["metric"] == "broken secondary"
    assert "cell cap exhausted" in recs[0]["error"]
    assert "value" not in recs[0]
    assert recs[0]["device"] == DEVICE
    assert recs[1] == {
        "metric": "surviving metric",
        "value": 42.0,
        "unit": "steps/s",
        "vs_baseline": 4.2,
        "device": DEVICE,
    }


def test_emit_isolates_system_exit(capsys):
    """Even SystemExit/KeyboardInterrupt-class failures in a metric fn are
    isolated (BaseException): the remaining metrics still run."""

    def quit_():
        raise SystemExit(3)

    assert bench._emit("exiting metric", quit_, "hills/s", 100.0, DEVICE) is False
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert rec["metric"] == "exiting metric" and "error" in rec


def test_main_exits_nonzero_when_a_metric_fails(monkeypatch, capsys):
    """All metrics print, and a failed one turns the exit code non-zero."""
    import types

    monkeypatch.setattr(sys, "argv", ["bench.py"])
    monkeypatch.setattr(bench, "device_identity", lambda: DEVICE)
    monkeypatch.setitem(
        sys.modules, "edm_tpu.utils.compile_cache",
        types.SimpleNamespace(enable_compile_cache=lambda: None),
    )
    monkeypatch.setattr(bench, "bench_deposition", lambda: 1e6)
    monkeypatch.setattr(bench, "bench_coord2d", lambda **kw: 1e3)

    def pairwise(n_atoms=10000, **kw):
        if n_atoms == 100000:
            raise AssertionError("cell cap exhausted")
        return 1e3

    monkeypatch.setattr(bench, "bench_pairwise", pairwise)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 1
    recs = [json.loads(l) for l in capsys.readouterr().out.strip().splitlines()]
    assert len(recs) == 6
    assert sum("error" in r for r in recs) == 1
    assert all(r["device"] == DEVICE for r in recs)

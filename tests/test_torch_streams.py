"""The port's fleet events and traces against the reference's.

Event validation raises the same errors; `apply_events` and
`forecast_cone` fold the same fleets; `synthetic_timed_trace` (with and
without ``calibration=`` on ``CALIBRATION_ec2.json``, with the hazard and
price-drift overlays) and `storm_trace` give the reference's traces event
for event from the same seed.  Both packages' objects meet in
`interop`'s plain form.
"""
import dataclasses
import pathlib

import numpy as np
import pytest

from repro.core import calibration as ref_cal
from repro.core import streams as rs

from repro_torch.core import calibration as cal
from repro_torch.core import streams as ps
from repro_torch.interop import (
    event_from_plain,
    event_to_plain,
    stream_from_plain,
    stream_to_plain,
    trace_from_plain,
    trace_to_plain,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _kinds(mod):
    vgg, zf = mod.AnalysisProgram("VGG-16", "vgg16"), mod.AnalysisProgram("ZF", "zf")
    return [(vgg, 0.25), (vgg, 0.2), (zf, 0.5), (zf, 2.0), (zf, 5.0)]


def _fleet(mod, n, prefix="s"):
    kinds = _kinds(mod)
    return [mod.StreamSpec(f"{prefix}{i}", *kinds[i % 5]) for i in range(n)]


def _plain_fleet(fleet):
    return tuple(stream_to_plain(s) for s in fleet)


# ------------------------------------------------------------------ events

BAD_EVENTS = [
    ("StreamAdded", (), {"at": -1.0}),
    ("StreamAdded", (), {"at": float("nan")}),
    ("StreamRateChanged", ("s0", 0.0), {}),
    ("PriceChanged", ("c4.2xlarge", -0.1), {}),
    ("InstancePreempted", (-2,), {}),
    ("InstancePreempted", (), {"draw": 1.0}),
    ("InstancePreempted", (), {"pool": 0}),
    ("InstancePreempted", (), {"hazard_ref": -1.0}),
    ("InstancePreempted", (), {"notice_id": -2}),
    ("InstancePreemptionNotice", (), {"at": 2.0, "deadline": 1.0}),
    ("InstancePreemptionNotice", (-3,), {"deadline": 1.0}),
    ("InstancePreemptionNotice", (), {"draw": -0.5}),
    ("InstancePreemptionNotice", (), {"pool": 0}),
    ("InstancePreemptionNotice", (), {"hazard_ref": float("nan")}),
    ("InstancePreemptionNotice", (), {"notice_id": -4}),
]


@pytest.mark.parametrize("kind,args,kwargs", BAD_EVENTS,
                         ids=[f"{k}-{i}" for i, (k, _a, _kw) in enumerate(BAD_EVENTS)])
def test_event_validation_raises_as_the_reference(kind, args, kwargs):
    def build(mod):
        if kind == "StreamAdded":
            return mod.StreamAdded(_fleet(mod, 1)[0], **kwargs)
        return getattr(mod, kind)(*args, **kwargs)

    with pytest.raises(ValueError) as ref_exc:
        build(rs)
    with pytest.raises(ValueError) as exc:
        build(ps)
    assert str(exc.value) == str(ref_exc.value)


def test_events_round_trip_through_plain():
    stream = ps.StreamSpec("g", ps.AnalysisProgram("ZF", "zf"), 2.0, tier=ps.BRONZE)
    events = [
        ps.StreamAdded(stream, at=0.5),
        ps.StreamRemoved("s1", at=0.6),
        ps.StreamRateChanged("s2", 0.5, at=0.7),
        ps.PriceChanged("c4.2xlarge", 0.4, at=0.8),
        ps.InstancePreempted(3, at=0.9, notice_id=2),
        ps.InstancePreemptionNotice(at=1.0, deadline=1.1, draw=0.3, pool=8,
                                    hazard_ref=0.2, notice_id=2),
    ]
    for ev in events:
        assert event_from_plain(event_to_plain(ev)) == ev
    assert stream_from_plain(stream_to_plain(stream)) == stream
    trace = ps.TimedTrace(events=tuple(events), horizon=2.0)
    assert trace_from_plain(trace_to_plain(trace)) == trace
    ref_ev = rs.InstancePreemptionNotice(at=1.0, deadline=1.1, draw=0.3, pool=8,
                                         hazard_ref=0.2, notice_id=2)
    assert event_to_plain(ref_ev) == event_to_plain(events[-1])


def test_apply_events_folds_as_the_reference():
    def fold(mod):
        fleet = _fleet(mod, 6)
        extra = mod.StreamSpec("x", mod.AnalysisProgram("ZF", "zf"), 5.0)
        evs = [mod.StreamAdded(extra), mod.StreamRemoved("s2"),
               mod.StreamRateChanged("s0", 2.0), mod.PriceChanged("g2.2xlarge", 0.7),
               mod.InstancePreempted(1), mod.InstancePreemptionNotice(deadline=0.1)]
        out = mod.apply_events(fleet, evs)
        errors = []
        for bad in ([mod.StreamAdded(fleet[1])], [mod.StreamRemoved("nope")],
                    [mod.StreamRateChanged("nope", 1.0)], ["not an event"]):
            try:
                mod.apply_events(fleet, bad)
            except (ValueError, KeyError, TypeError) as exc:
                errors.append((type(exc).__name__, str(exc)))
        return _plain_fleet(out), errors, mod.fleet_key(out) == mod.fleet_key(out[::-1])

    assert fold(ps) == fold(rs)


def test_forecast_cone_matches_the_reference():
    def cone(mod):
        fleet = _fleet(mod, 5)
        joins = tuple(_fleet(mod, 3, prefix="f"))
        fc = mod.StreamForecast(joins=joins, leaves=("s1", "s3"))
        fleets = mod.forecast_cone(fleet, fc)
        errors = []
        for bad in (lambda: mod.forecast_cone(fleet, mod.StreamForecast(joins=(fleet[0],))),
                    lambda: mod.forecast_cone(fleet, mod.StreamForecast(leaves=("zz",))),
                    lambda: mod.StreamForecast(joins=(joins[0], joins[0])),
                    lambda: mod.StreamForecast(leaves=("s1", "s1"))):
            try:
                bad()
            except (ValueError, KeyError) as exc:
                errors.append((type(exc).__name__, str(exc)))
        return [_plain_fleet(f) for f in fleets], errors

    got, want = cone(ps), cone(rs)
    assert got == want
    assert len(got[0]) == 4 * 3 and len(got[1]) == 4
    # Joins-major: entry j * (L + 1) + l has j joins added and l leaves removed.
    assert len(got[0][1 * 3 + 2]) == 5 + 1 - 2


def test_timed_trace_validation_and_coerce_match():
    for mod in (ps, rs):
        s = _fleet(mod, 1)[0]
        with pytest.raises(ValueError, match="non-decreasing"):
            mod.TimedTrace(events=(mod.StreamAdded(s, at=1.0), mod.StreamRemoved("a", at=0.5)))
        trace = mod.TimedTrace(events=[mod.StreamAdded(s, at=1.0)], horizon=0.2)
        assert trace.horizon == 1.0 and len(trace) == 1 and trace.times() == (1.0,)
        assert mod.TimedTrace.coerce(trace) is trace
        assert mod.TimedTrace.coerce([mod.StreamRemoved("a")]).horizon == 0.0


def _rerate(kinds):
    return lambda s: [f for p, f in kinds if p.program_id == s.program.program_id]


def _synthetic(mod, calibration=None, **overlay):
    kinds = _kinds(mod)
    rng = np.random.RandomState(2618)
    return mod.synthetic_timed_trace(
        _fleet(mod, 30), rng, n_events=60, mean_gap_hours=0.03, p_join=0.5,
        p_leave=0.2, make_join=lambda i: mod.StreamSpec(f"g{i}", *kinds[i % 5]),
        rerate_fps=_rerate(kinds), burst=2, calibration=calibration, **overlay)


OVERLAYS = {
    "churn": {},
    "hazard": {"preemption_hazard": 0.4, "hazard_pool": 8},
    "drift": {"preemption_hazard": 0.2, "price_drift": 0.3,
              "price_drift_types": [("c4.2xlarge-spot", 0.126), ("g2.2xlarge-spot", 0.195)]},
}


@pytest.mark.parametrize("overlay", sorted(OVERLAYS))
def test_synthetic_timed_trace_matches_the_reference(overlay):
    got = trace_to_plain(_synthetic(ps, **OVERLAYS[overlay]))
    want = trace_to_plain(_synthetic(rs, **OVERLAYS[overlay]))
    assert got == want
    assert len(got["events"]) >= 60


def test_synthetic_timed_trace_with_calibration_matches_the_reference():
    path = ROOT / "CALIBRATION_ec2.json"
    got = trace_to_plain(_synthetic(ps, calibration=cal.CalibrationArtifact.load(path)))
    want = trace_to_plain(_synthetic(rs, calibration=ref_cal.CalibrationArtifact.load(path)))
    assert got == want
    # A join the artifact cannot serve raises in both.
    for mod, art in ((ps, cal.CalibrationArtifact.load(path)),
                     (rs, ref_cal.CalibrationArtifact.load(path))):
        bad = mod.StreamSpec("x", mod.AnalysisProgram("ZF", "zf"), 1e6)
        with pytest.raises(ValueError):
            mod.synthetic_timed_trace(
                [bad], np.random.RandomState(0), n_events=1, calibration=art)


def _storm(mod):
    kinds = _kinds(mod)
    phases = [
        mod.StormPhase("reclaim", at=0.1, count=3),
        mod.StormPhase("notice", at=0.2, count=2),
        mod.StormPhase("false_alarm", at=0.25),
        mod.StormPhase("flash_crowd", at=0.3, count=4),
        mod.StormPhase("price", at=0.35, instance_type="g2.2xlarge", cost=0.9),
    ]
    return mod.storm_trace(
        _fleet(mod, 20), np.random.RandomState(7), phases=phases, n_background=25,
        make_join=lambda i: mod.StreamSpec(f"b{i}", *kinds[i % 5]),
        rerate_fps=_rerate(kinds), hazard_pool=16, hazard_ref=0.5)


def test_storm_trace_matches_the_reference():
    got, want = trace_to_plain(_storm(ps)), trace_to_plain(_storm(rs))
    assert got == want
    kinds = {k for k, _ in got["events"]}
    assert kinds >= {"InstancePreempted", "InstancePreemptionNotice", "StreamAdded",
                     "PriceChanged"}
    for mod in (ps, rs):
        with pytest.raises(ValueError, match="unknown storm phase kind"):
            mod.StormPhase("hail", at=0.0)
        with pytest.raises(ValueError, match="instance_type"):
            mod.StormPhase("price", at=0.0)


def test_event_classes_have_the_references_fields():
    for name in ("FleetEvent", "StreamAdded", "StreamRemoved", "StreamRateChanged",
                 "PriceChanged", "InstancePreempted", "InstancePreemptionNotice",
                 "StreamForecast", "TimedTrace", "StormPhase"):
        got = [(f.name, f.default) for f in dataclasses.fields(getattr(ps, name))]
        want = [(f.name, f.default) for f in dataclasses.fields(getattr(rs, name))]
        assert got == want, name

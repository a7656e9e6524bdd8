"""The port's lifecycle and billing ledger against the reference's.

The same billing contracts (through `interop`'s plain form) and the same
sequences of provision, adopt, notice, preempt, reprice and decommission
calls drive both packages' `LifecycleEngine`; every record, every state
and every billed figure (`billed_cost`, `billed_instance`,
`instantaneous_integral`, `termination_saving`, `estimate_hazards`) must be
equal, floats with ``==``.  Inputs follow the reference's own
``tests/test_lifecycle.py`` and ``tests/test_hazard_estimation.py``.
"""
import dataclasses

import pytest

from repro.core import lifecycle as rl

from repro_torch.core import lifecycle as pl
from repro_torch.interop import billing_from_plain, billing_to_plain

MODELS = {
    "continuous": (0.0, 0.0, 0.0),
    "hourly": (2.0 / 60.0, 1.0, 0.0),
    "per-second": (2.0 / 60.0, 0.0, 0.0),
    "quarter-min": (0.05, 0.25, 0.5),
}


def _models(plain):
    return billing_from_plain(plain), rl.BillingModel(*plain)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_billing_model_matches_the_reference(model):
    port, ref = _models(MODELS[model])
    assert billing_to_plain(port) == billing_to_plain(ref) == MODELS[model]
    for d in (0.0, -1.0, 1e-9, 0.2, 0.25, 0.999999999, 1.0, 1.0 + 1e-12, 2.5, 7.3):
        assert port.billed_hours(d) == ref.billed_hours(d), d
        assert port.billed_hours(d) >= d
    for prov, at in ((0.0, 0.0), (0.0, 0.5), (1.25, 0.3), (0.1, 3.7), (2.0, 2.0)):
        assert port.next_boundary(prov, at) == ref.next_boundary(prov, at)


def test_billing_model_validation_matches():
    for kw in ({"boot_hours": -1.0}, {"quantum_hours": float("nan")},
               {"min_billed_hours": -0.1}):
        with pytest.raises(ValueError) as ref_exc:
            rl.BillingModel(**kw)
        with pytest.raises(ValueError) as exc:
            pl.BillingModel(**kw)
        assert str(exc.value) == str(ref_exc.value)


#: Ledger scripts: (method, args) calls in time order.
SCRIPTS = {
    "lifecycle": [
        ("provision", (1, "c4.2xlarge", 0.419, 0.0)),
        ("provision", (2, "g2.2xlarge", 0.65, 0.1)),
        ("adopt_running", (3, "c4.8xlarge", 1.675, 0.2)),
        ("decommission", (1, 0.7), {"drain_until": 0.9}),
        ("reprice", (2, 0.8, 0.7)),
        ("decommission", (3, 1.4)),
    ],
    "notice-kill": [
        ("provision", (1, "x-spot", 0.1, 0.0)),
        ("provision", (2, "x-spot", 0.1, 0.0)),
        ("provision", (3, "x", 0.3, 0.0)),
        ("notice", (1, 0.5, 0.55)),
        ("preempt", (1, 0.55)),
        ("notice", (2, 1.2, 1.25)),  # a false alarm: keeps billing
        ("decommission", (3, 1.0), {"drain_until": 1.3}),
        ("preempt", (3, 1.1)),  # an early kill inside the drain window
    ],
    "reprice-drain": [
        ("provision", (5, "g2.2xlarge", 0.65, 0.0)),
        ("provision", (6, "g2.2xlarge", 0.65, 0.0)),
        ("decommission", (5, 0.4), {"drain_until": 0.6}),
        ("reprice", (5, 0.5, 0.9)),
        ("reprice", (6, 0.5, 0.9)),
        ("reprice", (6, 1.5, 0.2)),
        ("notice", (5, 0.55, 0.7)),  # notice on a draining record
    ],
}
QUERY_TIMES = (0.0, 0.05, 0.3, 0.55, 0.9, 1.0, 1.25, 2.0, 3.5)


def _run(mod, model_plain, script):
    billing = mod.BillingModel(*model_plain)
    by_type = {"x-spot": mod.BillingModel(0.0, 0.25, 0.0)}
    eng = mod.LifecycleEngine(billing, billing_by_type=by_type)
    errors = []
    for call in script:
        name, args = call[0], call[1]
        kwargs = call[2] if len(call) > 2 else {}
        try:
            getattr(eng, name)(*args, **kwargs)
        except (ValueError, KeyError) as exc:
            errors.append((name, type(exc).__name__, str(exc)))
    uids = [r.uid for r in eng.records()]
    out = {
        "errors": errors,
        "records": [
            {f.name: (getattr(r, f.name) if f.name != "rate_history"
                      else [tuple(x) for x in r.rate_history])
             for f in dataclasses.fields(r)} for r in eng.records()],
        "states": [[eng.state(u, t).value for u in uids] for t in QUERY_TIMES],
        "accepting": [[eng.accepting(u, t) for u in uids] for t in QUERY_TIMES],
        "alive": [eng.alive(t) for t in QUERY_TIMES],
        "billed": [eng.billed_cost(t) for t in QUERY_TIMES],
        "billed_instance": [[eng.billed_instance(u, t) for u in uids] for t in QUERY_TIMES],
        "integral": [eng.instantaneous_integral(t) for t in QUERY_TIMES],
        "saving": [[eng.termination_saving(u, a, b) for u in uids]
                   for a, b in ((0.2, 0.9), (0.5, 1.5), (1.1, 3.0))],
        "hazards": [mod.estimate_hazards(eng, **kw) for kw in (
            {}, {"until": 1.0}, {"min_exposure_hours": 0.5})],
        "billing_for": [billing_to_plain(eng.billing_for(n)) for n in ("x-spot", "c4.2xlarge")],
    }
    return out


@pytest.mark.parametrize("model", sorted(MODELS))
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_ledger_sequences_match_the_reference(script, model):
    got = _run(pl, MODELS[model], SCRIPTS[script])
    want = _run(rl, MODELS[model], SCRIPTS[script])
    assert got == want
    for t, b, i in zip(QUERY_TIMES, got["billed"], got["integral"]):
        assert b >= i - 1e-12, t  # billed never below the snapshot integral


def test_ledger_errors_match_the_reference():
    script = [
        ("provision", (1, "a", 0.1, 0.0)),
        ("provision", (1, "a", 0.1, 0.5)),  # double provision
        ("decommission", (1, 1.0)),
        ("decommission", (1, 2.0)),  # double terminate
        ("reprice", (1, 3.0, 0.5)),  # terminated
        ("notice", (7, 0.1, 0.2)),  # unknown uid
    ]
    got = _run(pl, MODELS["hourly"], script)
    assert got == _run(rl, MODELS["hourly"], script)
    assert len(got["errors"]) >= 3


def test_estimate_hazards_is_the_references_mle():
    """The reference's hand-built ledger (tests/test_hazard_estimation.py)."""
    def build(mod):
        eng = mod.LifecycleEngine(mod.BillingModel())
        for uid in (1, 2, 3):
            eng.provision(uid, "x-spot", 0.1, at=0.0)
        eng.preempt(1, at=10.0)
        eng.decommission(2, at=20.0)
        eng.decommission(3, at=20.0)
        eng.provision(4, "x", 0.3, at=0.0)
        eng.decommission(4, at=20.0)
        eng.provision(5, "b-spot", 0.1, at=0.0)
        eng.preempt(5, at=0.2)
        return [mod.estimate_hazards(eng), mod.estimate_hazards(eng, until=5.0),
                mod.estimate_hazards(eng, min_exposure_hours=1.0)]

    got = build(pl)
    assert got == build(rl)
    assert got[0]["x-spot"] == pytest.approx(1.0 / 50.0)
    assert "b-spot" not in got[2]

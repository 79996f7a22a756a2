"""The port's SLO engine and alert evaluator against the JAX package's.

Each case is one seeded script of record calls on a test clock (the
engines' ``evaluate_once(now=...)``, as the reference's own tests drive
them): at every tick the same traffic, gauge and counter changes go into
both packages' registries, then both evaluate. The transcripts (each
objective's SLI, budget, burn rates and firing pairs; each rule's state)
and the edge events (``slo.burn``, ``alert.firing``, ``alert.resolved``)
must be equal, tick for tick.
"""

from __future__ import annotations

import random

import pytest

from spacedrive_tpu import telemetry as jax_telemetry
from spacedrive_tpu.telemetry import alerts as jax_alerts
from spacedrive_tpu.telemetry import slo as jax_slo
from spacedrive_tpu_torch import telemetry
from spacedrive_tpu_torch.telemetry import alerts, slo
from spacedrive_tpu_torch.telemetry.registry import REQUEST_BUCKETS

PKGS = {"port": (telemetry, slo, alerts), "jax": (jax_telemetry, jax_slo, jax_alerts)}


@pytest.fixture(autouse=True)
def _fresh_registries():
    for tel, slo_mod, _alerts in PKGS.values():
        tel.reset()
        tel.set_enabled(True)
        slo_mod.reset_tenant_labels()
    yield
    for tel, slo_mod, _alerts in PKGS.values():
        tel.reset()
        slo_mod.reset_tenant_labels()
        tel.reload_enabled()


def _objective(mod, **over):
    kw = dict(name="reads", threshold_s=0.25, target=0.9, window_s=60.0,
              fast_windows=(5.0, 60.0), slow_windows=(10.0, 120.0),
              fast_burn=2.0, slow_burn=50.0, severity="page")
    kw.update(over)
    return mod.SloObjective(**kw)


def _traffic(tel, rng: random.Random, *, proc="search.paths", tenant=None) -> None:
    """One tick of dispatches, recorded as the router records them."""
    req = tel.counter("sd_rspc_requests_total", labels=("proc", "kind", "outcome"))
    sec = tel.histogram("sd_rspc_request_seconds", labels=("proc",), buckets=REQUEST_BUCKETS)
    t_req = tel.counter("sd_rspc_tenant_requests_total", labels=("tenant", "outcome"))
    t_sec = tel.histogram("sd_rspc_tenant_request_seconds", labels=("tenant",),
                          buckets=REQUEST_BUCKETS)
    for count, latency, outcome in ((rng.randrange(0, 120), 0.01, "ok"),
                                    (rng.randrange(0, 90), 0.6, "ok"),
                                    (rng.randrange(0, 30), 0.001, "shed"),
                                    (rng.randrange(0, 10), 0.001, "error")):
        for _ in range(count):
            sec.observe(latency, proc=proc)
            req.inc(proc=proc, kind="query", outcome=outcome)
            if tenant is not None:
                t_sec.observe(latency, tenant=tenant)
                t_req.inc(tenant=tenant, outcome=outcome)


def _slo_case(variant: str):
    def run(pkg: str, rng: random.Random) -> list:
        tel, slo_mod, _alerts = PKGS[pkg]
        if variant == "tenants":
            objs = [_objective(slo_mod, name="all-tenants", tenant="*"),
                    _objective(slo_mod, name="hot", tenant="aaaa1111")]
        elif variant == "default":
            objs = slo_mod.default_objectives()
        else:
            objs = [_objective(slo_mod), _objective(slo_mod, name="slow-pair", slow_burn=1.5)]
        eng = slo_mod.SloEngine(objs, interval_s=999.0)
        out = []
        for tick in range(60):
            if variant == "tenants":
                _traffic(tel, rng, tenant=rng.choice(["aaaa1111", "bbbb2222"]))
            else:
                # a clean hour, a burst, a sustained burn, a recovery
                phase = tick // 15
                if phase in (1, 2):
                    _traffic(tel, rng)
                else:
                    tel.histogram("sd_rspc_request_seconds", labels=("proc",),
                                  buckets=REQUEST_BUCKETS).observe(0.01, proc="search.paths")
                    tel.counter("sd_rspc_requests_total",
                                labels=("proc", "kind", "outcome")).inc(
                        proc="search.paths", kind="query", outcome="ok")
            if variant == "reset" and tick == 35:
                tel.reset()
            out.append([_slo_row(s) for s in eng.evaluate_once(now=5.0 * tick)])
        return out
    return run


def _slo_row(s: dict) -> dict:
    return {k: (round(v, 9) if isinstance(v, float) else
                {kk: round(vv, 9) for kk, vv in v.items()} if k == "burn" else v)
            for k, v in s.items()}


def _alert_case(variant: str):
    def run(pkg: str, rng: random.Random) -> list:
        tel, _slo, alerts_mod = PKGS[pkg]
        rule = alerts_mod.AlertRule
        if variant == "default":
            rules = [r for r in alerts_mod.default_rules() if r.name != "device-numbers-missing"]
        else:
            rules = [
                rule(name="lag", kind="threshold", series="sd_sync_peer_lag_ops",
                     op="gt", value=100.0, for_s=10.0),
                rule(name="floor", kind="threshold", series="sd_scan_files_per_sec",
                     op="lt", value=100.0, for_s=0.0),
                rule(name="spike", kind="rate", series="sd_quarantined_files_total",
                     op="gt", value=5.0, window_s=10.0, for_s=0.0),
                rule(name="missing", kind="absence", series="sd_search_index_rows",
                     labels={"library": "abcd1234"}, for_s=15.0),
                rule(name="errors", kind="rate", series="sd_rspc_requests_total",
                     labels={"outcome": "error"}, op="gt", value=1.0, window_s=20.0),
            ]
        ev = alerts_mod.AlertEvaluator(rules, interval_s=999.0)
        lag = tel.gauge("sd_sync_peer_lag_ops", labels=("peer",))
        rate = tel.gauge("sd_scan_files_per_sec")
        quarantined = tel.counter("sd_quarantined_files_total")
        rows = tel.gauge("sd_search_index_rows", labels=("library",))
        boots = tel.counter("sd_boot_integrity_checks_total", labels=("outcome",))
        disk = tel.counter("sd_recovery_disk_full_total", labels=("site",))
        p99 = tel.gauge("sd_rspc_request_p99_seconds", labels=("proc",))
        out = []
        for tick in range(50):
            lag.set(rng.choice([0, 50, 600, 700]), peer=rng.choice(["p1", "p2"]))
            rate.set(rng.choice([0.0, 40.0, 400.0]))
            if rng.random() < 0.3:
                quarantined.inc(rng.randrange(0, 200))
            if tick == 30:
                rows.set(12.0, library="abcd1234")
            if rng.random() < 0.1:
                boots.inc(outcome=rng.choice(["ok", "corrupt"]))
            if rng.random() < 0.1:
                disk.inc(site="thumbnail")
            p99.set(rng.choice([0.1, 3.0]), proc="search.paths")
            _traffic(tel, rng)
            if variant == "reset" and tick == 25:
                tel.reset()
            out.append([{k: v for k, v in s.items() if k != "since"}
                        for s in ev.evaluate_once(now=2.0 * tick)])
        return out
    return run


CASES = {
    "slo-burn": _slo_case("burn"),
    "slo-tenants": _slo_case("tenants"),
    "slo-reset": _slo_case("reset"),
    "slo-default-objectives": _slo_case("default"),
    "alerts": _alert_case("rules"),
    "alerts-reset": _alert_case("reset"),
    "alerts-default-rules": _alert_case("default"),
}


def _edges(tel) -> list:
    return [{k: v for k, v in e.items() if k not in ("seq", "unix")}
            for e in tel.recent_events(limit=256)
            if e["name"] in ("slo.burn", "alert.firing", "alert.resolved")]


@pytest.mark.parametrize("case", list(CASES))
def test_edges_and_states_equal_the_reference(case):
    got = {}
    for pkg, (tel, _slo, _alerts) in PKGS.items():
        transcript = CASES[case](pkg, random.Random(7))
        got[pkg] = (transcript, _edges(tel))
    assert got["port"] == got["jax"]
    transcript, edges = got["port"]
    if case in ("slo-burn", "alerts", "alerts-default-rules"):
        assert edges, "the case fires no edge"
    assert len(transcript) >= 50


def test_the_default_rules_are_the_reference_minus_the_router_rule():
    ours = [r.to_dict() for r in alerts.default_rules()]
    theirs = [r.to_dict() for r in jax_alerts.default_rules()
              if r.name != "device-numbers-missing"]
    assert ours == theirs
    assert [o.to_dict() for o in slo.default_objectives()] == \
        [o.to_dict() for o in jax_slo.default_objectives()]

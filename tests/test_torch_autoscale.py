"""The port's autoscaler (`crdt_tpu_torch.autoscale`) against the JAX
package's (`crdt_tpu.autoscale`), on the CPU, every comparison exact:

- `decide` on the same seeded evidence script (rates, primaryless
  groups, measured, unmeasured and failing SLO checks, a missing
  table, cooldown clocks) gives the same decision and the same
  hysteresis streaks at every step, under several controller settings;
- `_apply`'s fences over a scripted federation stand-in give the same
  calls and the same decision records (less their clock stamps);
- one closed loop over a real two-tier swing (a burst of writes, then
  quiet) on each package: one split and one merge, each fenced by the
  epoch it was decided under, the degraded freeze between them while
  the rate is unmeasured, and the decision counter equal to the
  decisions taken.

Clocks only feed rates here; a rate above or below a threshold by
orders of magnitude decides, and no elapsed time is asserted.
"""

import time

import numpy as np
import pytest

import crdt_tpu
import crdt_tpu_torch as port
from crdt_tpu import autoscale as jauto
from crdt_tpu.obs import default_registry as jax_registry
from crdt_tpu_torch import autoscale as pauto
from crdt_tpu_torch.obs import default_registry as port_registry

from torch_threads import cap_torch_threads

cap_torch_threads()

MODS = {"jax": jauto, "port": pauto}
PKGS = {"jax": crdt_tpu, "port": port}
REGISTRIES = {"jax": jax_registry, "port": port_registry}


def evidence(seed, steps=120):
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for _ in range(steps):
        n = int(rng.integers(1, 5))
        kind = rng.integers(0, 10)
        rates = (None if kind == 0 else
                 [float(x) for x in rng.choice(
                     [0.5, 3.0, 20.0, 150.0, 900.0], n)])
        ack = {0: None, 1: False}.get(int(rng.integers(0, 8)), True)
        t += float(rng.choice([0.1, 0.5, 3.0]))
        out.append({
            "epoch": None if kind == 1 else int(rng.integers(0, 3)),
            "partitions": n, "rows": [0] * n, "rates": rates,
            "queue_depth": 0, "shed": 0,
            "primaryless": [0] if kind == 2 else [],
            "slo": {"checks": {"ack_p99_s": {"ok": ack}}}, "t": t})
    return out


SETTINGS = [
    dict(hysteresis_ticks=3, cooldown_s=2.0, split_rows_per_s=100.0,
         merge_rows_per_s=10.0, max_partitions=8),
    dict(hysteresis_ticks=1, cooldown_s=0.0, split_rows_per_s=10.0,
         merge_rows_per_s=5.0, min_partitions=2, max_partitions=3),
    dict(hysteresis_ticks=2, cooldown_s=1.0),
]


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("setting", range(len(SETTINGS)))
def test_decisions_match_jax_on_scripted_evidence(seed, setting):
    scalers = {p: m.Autoscaler(fed=None, **SETTINGS[setting])
               for p, m in MODS.items()}
    for p in scalers:
        scalers[p]._last_change_t = 0.5
    for obs in evidence(seed):
        got = {p: (a.decide(dict(obs)), dict(a._streak))
               for p, a in scalers.items()}
        assert got["port"] == got["jax"], obs
        assert scalers["port"].degraded_reason(obs) == \
            scalers["jax"].degraded_reason(obs)


class _Table:
    def __init__(self, epoch):
        self.epoch = epoch


class _Fed:
    def __init__(self, epoch=0, fail=None):
        self.table = _Table(epoch)
        self.calls = []
        self.fail = fail

    def _go(self, action, src):
        self.calls.append((action, src))
        if self.fail is not None:
            raise self.fail
        self.table = _Table(self.table.epoch + 1)
        return {}

    def split_hot(self, src=None):
        return self._go("split", src)

    def merge_cold(self, src=None):
        return self._go("merge", src)


def apply_script(mod):
    out = []
    for fed_epoch, dec_epoch, inflight, fail, action in [
            (0, 0, None, None, "split"), (5, 4, None, None, "merge"),
            (2, 2, "split", None, "merge"), (3, 3, None,
                                             ValueError("x"), "merge"),
            (1, 1, None, None, "merge")]:
        fed = _Fed(fed_epoch, fail)
        a = mod.Autoscaler(fed=fed)
        a._inflight = inflight
        a._streak["split"] = 4
        a._prev_rows = [1, 2]
        ok = a._apply({"action": action, "reason": "test", "src": 1,
                       "epoch": dec_epoch})
        out.append((ok, fed.calls, a._inflight, dict(a._streak),
                    a._prev_rows,
                    [{k: v for k, v in d.items() if k != "t"}
                     for d in a.decisions]))
    return out


def test_apply_fences_match_jax():
    got = apply_script(pauto)
    assert got == apply_script(jauto)
    assert [g[0] for g in got] == [True, False, False, False, True]


def _measured_slo():
    return {"checks": {"ack_p99_s": {"ok": True, "value": 0.001,
                                     "budget": 0.00425}}}


def _decisions_total(pkg):
    snap = REGISTRIES[pkg]().snapshot()
    return sum(s["value"] for s in snap["counters"].get(
        "crdt_tpu_autoscale_decisions_total", []))


def swing(pkg):
    mod = PKGS[pkg]
    kw = {} if pkg == "jax" else {"device": "cpu"}
    before = _decisions_total(pkg)
    with mod.FederatedTier(256, partitions=1, flush_interval=0.002,
                           **kw) as fed:
        a = mod.Autoscaler(fed, min_partitions=1, max_partitions=2,
                           split_rows_per_s=5.0, merge_rows_per_s=1.0,
                           hysteresis_ticks=1, cooldown_s=0.0,
                           slo_probe=_measured_slo)
        decs = [a.tick()]                 # no baseline: degraded
        cli = mod.FederatedClient(fed.addrs(), timeout=30.0)
        try:
            for slot in range(0, 256, 2):
                cli.put(slot, slot)
        finally:
            cli.close()
        time.sleep(0.05)
        epochs = [fed.table.epoch]
        decs.append(a.tick())             # hot: split
        epochs.append(fed.table.epoch)
        decs.append(a.tick())             # re-seeded baseline: degraded
        time.sleep(0.05)
        decs.append(a.tick())             # quiet: merge
        epochs.append(fed.table.epoch)
        partitions = len(fed.tiers)
        cli = mod.FederatedClient(fed.addrs(), timeout=30.0)
        try:
            reads = [cli.get(s) for s in range(0, 256, 2)]
        finally:
            cli.close()
        taken = len(a.decisions)
        records = [(d["action"], d["reason"], d["epoch"])
                   for d in a.decisions]
    return dict(decs=decs, epochs=epochs, partitions=partitions,
                reads=reads, records=records, taken=taken,
                counted=_decisions_total(pkg) - before)


def test_closed_loop_swing_matches_jax():
    got, want = swing("port"), swing("jax")
    assert got == want
    acts = [(d["action"], d["reason"], d.get("applied"))
            for d in got["decs"]]
    assert acts == [("hold", "degraded:unmeasured-rate", None),
                    ("split", "hot-rate", True),
                    ("hold", "degraded:unmeasured-rate", None),
                    ("merge", "all-cold", True)]
    # Each change was fenced by the epoch it was decided under.
    assert [d["epoch"] for d in got["decs"]] == [0, 0, 1, 1]
    assert got["epochs"] == [0, 1, 2] and got["partitions"] == 1
    assert got["reads"] == list(range(0, 256, 2))
    assert got["counted"] == got["taken"] == 4

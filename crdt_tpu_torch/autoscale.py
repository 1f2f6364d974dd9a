"""SLO-driven elastic repartitioning: the loop around `split_hot` and
`merge_cold`.

Port of ``crdt_tpu/autoscale.py``: the same decisions on the same
evidence, with `obs.fleet.evaluate_slo` as the default SLO input.

`split_hot` grows the federation and `merge_cold` shrinks it; this
module is the controller that decides WHEN, from evidence the system
already collects — per-partition committed-row rates (the serve ack
pipeline's volume signal), queue depth and shed counters, replica
health, and `evaluate_slo` verdicts (obs/fleet.py). A fleet tracking
diurnal traffic must shrink as safely as it grows, and "safely" is a
list of disciplines, each of which this controller enforces:

- **Hysteresis**: pressure must persist for ``hysteresis_ticks``
  consecutive observations before a decision fires — one hot tick is
  a burst, not a trend.
- **Cooldown**: after a completed change the controller holds for
  ``cooldown_s`` so the fleet (and the rate estimator, which resets
  across topology changes) can settle before the next decision.
- **One change in flight**: `_apply` refuses while a prior change is
  still running; topology changes are serialized end to end.
- **Epoch fencing**: every decision carries the table epoch its
  evidence was read under, and `_apply` re-checks it immediately
  before acting — a stale observation must never retire an arc a
  concurrent change just made hot.
- **Floor/ceiling**: hard partition-count bounds; the controller
  never merges below ``min_partitions`` or splits above
  ``max_partitions``.
- **Degraded mode**: when any SLO input is unmeasured (no rate
  baseline yet, no ack samples) or a group has no live primary, ALL
  scaling freezes — in particular the controller never merges, since
  unmeasured ≠ safe to shrink and a primaryless group's load is
  invisible.

Decisions are counted in
``crdt_tpu_autoscale_decisions_total{action,reason}`` and executed
inside trace spans, so a scale action is auditable after the fact
(docs/FEDERATION.md).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

__all__ = ["Autoscaler"]

# The controller's default ack target: the JAX package's 14.6 ms
# envelope (obs/fleet.py SERVE_ACK_ENVELOPE_S — kept literal here so
# importing the controller never drags the fleet module in). This
# budget is only gateable because evaluate_slo reads the ack p99 from
# the mergeable quantile sketch (obs/sketch.py): the log2 histogram's
# nearest stable boundary is 31.3 ms, more than 2x the envelope, and
# a bucket ceiling between the two is unmeasured — not a verdict.
_ACK_P99_BUDGET_S = 0.0146


def _metrics():
    from .obs.registry import default_registry
    reg = default_registry()
    return {
        "decisions": reg.counter(
            "crdt_tpu_autoscale_decisions_total",
            "autoscaler decisions by action and reason"),
        "degraded": reg.gauge(
            "crdt_tpu_autoscale_degraded",
            "1 while scaling is frozen (unmeasured SLO inputs or a "
            "primaryless group)"),
    }


class Autoscaler:
    """Closed-loop controller driving `FederatedTier.split_hot` /
    `merge_cold` against an SLO target.

    ``split_rows_per_s`` is the per-partition committed-row rate above
    which the hottest partition is split; ``merge_rows_per_s`` the
    rate below which — when EVERY partition is that cold — the coldest
    is merged away (all-cold is deliberately conservative: a fleet
    with one busy partition and three idle ones keeps its headroom).

    The controller owns NO locks of its own (the empty
    `_CRDTLINT_LOCK_ORDER` below is the checked statement of that):
    split/merge serialization lives entirely in the federation's
    ``_control``, so a wedged scale action can never also wedge the
    poller.

    An ack-p99 SLO breach (`evaluate_slo`) counts as split pressure
    even below the rate threshold. ``slo_probe`` injects the verdict
    source (tests; the default evaluates the in-process registry).

    Run as a daemon (``start``/``stop`` or context manager) ticking
    every ``interval`` seconds, or drive ``tick()`` by hand.
    """

    _CRDTLINT_LOCK_ORDER: tuple = ()

    def __init__(self, fed, *, interval: float = 0.25,
                 min_partitions: int = 1, max_partitions: int = 8,
                 split_rows_per_s: float = 400.0,
                 merge_rows_per_s: float = 50.0,
                 hysteresis_ticks: int = 3, cooldown_s: float = 2.0,
                 ack_p99_budget_s: float = _ACK_P99_BUDGET_S,
                 slo_probe: Optional[Callable[[], dict]] = None):
        if min_partitions < 1:
            raise ValueError(
                f"min_partitions must be >= 1; got {min_partitions}")
        if max_partitions < min_partitions:
            raise ValueError(
                f"max_partitions {max_partitions} < min_partitions "
                f"{min_partitions}")
        self.fed = fed
        self.interval = float(interval)
        self.min_partitions = int(min_partitions)
        self.max_partitions = int(max_partitions)
        self.split_rows_per_s = float(split_rows_per_s)
        self.merge_rows_per_s = float(merge_rows_per_s)
        self.hysteresis_ticks = int(hysteresis_ticks)
        self.cooldown_s = float(cooldown_s)
        self.ack_p99_budget_s = float(ack_p99_budget_s)
        self._slo_probe = slo_probe
        # In-flight fence: the action currently executing, or None.
        # Written only by the thread driving tick(); read by _apply's
        # fence check.
        self._inflight: Optional[str] = None
        self._last_change_t: Optional[float] = None
        self._streak = {"split": 0, "merge": 0}
        # Rate baseline: previous (rows list, monotonic time); reset
        # to None across topology changes so rates are never computed
        # across a partition-list reshape.
        self._prev_rows: Optional[List[int]] = None
        self._prev_t: Optional[float] = None
        self.last_action: Optional[dict] = None
        self.decisions: List[dict] = []   # bounded audit log
        # Flight-recorder edge detector: a bundle is dumped when the
        # SLO verdict FLIPS to failing, not on every failing tick.
        self._last_slo_ok: Optional[bool] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- lifecycle ---

    def start(self) -> "Autoscaler":
        if self._thread is not None:
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30.0)

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.tick()
            except Exception:
                # A failed tick must never kill the control loop; the
                # decision counter records failures and the next tick
                # re-observes from scratch.
                pass
            self._stop.wait(self.interval)

    # --- observe ---

    def _default_slo(self) -> dict:
        from .obs.fleet import evaluate_slo
        from .obs.registry import default_registry
        return evaluate_slo({"local": default_registry().snapshot()},
                            ack_p99_budget_s=self.ack_p99_budget_s)

    def observe(self) -> dict:
        """One evidence snapshot, stamped with the table epoch it was
        read under (the fence `_apply` later re-checks). Rates are
        None — unmeasured — on the first tick and on the first tick
        after any topology change, which is exactly when the degraded
        freeze must hold scaling still."""
        fed = self.fed
        table = fed.table
        epoch = None if table is None else table.epoch
        tiers = list(fed.tiers)
        groups = list(fed.groups)
        rows: List[int] = []
        depth = 0
        shed = 0
        for t in tiers:
            wc = t._wc
            rows.append(0 if wc is None else int(wc.rows_committed))
            depth += len(t._q)
            shed += int(t.shed_count)
        primaryless: List[int] = []
        for i, g in enumerate(groups):
            if g is None:
                if i < len(tiers) and tiers[i].killed:
                    primaryless.append(i)
                continue
            m = g.primary
            if m is None or m.tier is None or m.tier.killed:
                primaryless.append(i)
        now = time.monotonic()
        rates: Optional[List[float]] = None
        if self._prev_rows is not None \
                and len(self._prev_rows) == len(rows) \
                and self._prev_t is not None and now > self._prev_t:
            dt = now - self._prev_t
            rates = [max(0.0, (b - a) / dt)
                     for a, b in zip(self._prev_rows, rows)]
        self._prev_rows = rows
        self._prev_t = now
        slo = (self._slo_probe() if self._slo_probe is not None
               else self._default_slo())
        slo_ok = slo.get("ok") if isinstance(slo, dict) else None
        if slo_ok is False and self._last_slo_ok is not False:
            # SLO just flipped to failing: capture forensics NOW,
            # while the trace ring and sketches still hold the bad
            # window (obs/recorder.py; never let it wedge the tick).
            try:
                from .obs.recorder import default_recorder
                default_recorder().trigger(
                    "slo_failing",
                    {"slo": slo, "epoch": epoch,
                     "partitions": len(tiers)})
            except Exception:
                pass
        self._last_slo_ok = slo_ok
        return {"epoch": epoch, "partitions": len(tiers),
                "rows": rows, "rates": rates, "queue_depth": depth,
                "shed": shed, "primaryless": primaryless,
                "slo": slo, "t": now}

    # --- decide ---

    def degraded_reason(self, obs: dict) -> Optional[str]:
        """Why scaling is frozen, or None when every input is
        measured and every group has a live primary. Unmeasured ≠
        safe to shrink: a controller that merges on a rate it never
        observed is guessing with someone's arc."""
        if obs["epoch"] is None:
            return "no-table"
        if obs["primaryless"]:
            return "primaryless-group"
        if obs["rates"] is None:
            return "unmeasured-rate"
        slo = obs.get("slo")
        checks = slo.get("checks", {}) if isinstance(slo, dict) else {}
        ack = checks.get("ack_p99_s", {})
        if ack.get("ok") is None:
            return "unmeasured-slo"
        return None

    def decide(self, obs: dict) -> dict:
        """Pure decision from one observation: ``{"action":
        "split"|"merge"|"hold", "reason", "src", "epoch"}``. Carries
        the observation's epoch so `_apply` can fence it. Mutates the
        hysteresis streaks (consecutive pressured observations)."""
        dec: Dict[str, Any] = {"action": "hold", "reason": "steady",
                               "src": None, "epoch": obs["epoch"]}
        frozen = self.degraded_reason(obs)
        if frozen is not None:
            self._streak["split"] = self._streak["merge"] = 0
            dec["reason"] = f"degraded:{frozen}"
            return dec
        rates = obs["rates"]
        hot = max(range(len(rates)), key=lambda i: rates[i])
        cold = min(range(len(rates)), key=lambda i: rates[i])
        slo = obs["slo"]
        ack = slo.get("checks", {}).get("ack_p99_s", {}) \
            if isinstance(slo, dict) else {}
        up = (rates[hot] >= self.split_rows_per_s
              or ack.get("ok") is False)
        # All-cold, not just coldest-cold: one busy partition keeps
        # the whole fleet's headroom.
        down = (not up) and max(rates) < self.merge_rows_per_s
        self._streak["split"] = self._streak["split"] + 1 if up else 0
        self._streak["merge"] = self._streak["merge"] + 1 if down \
            else 0
        if self._last_change_t is not None and \
                obs["t"] - self._last_change_t < self.cooldown_s:
            dec["reason"] = "cooldown"
            return dec
        if up:
            if obs["partitions"] >= self.max_partitions:
                dec["reason"] = "ceiling"
            elif self._streak["split"] < self.hysteresis_ticks:
                dec["reason"] = "hysteresis"
            else:
                dec.update(action="split", src=hot,
                           reason=("slo-breach"
                                   if ack.get("ok") is False
                                   else "hot-rate"))
            return dec
        if down:
            if obs["partitions"] <= self.min_partitions:
                dec["reason"] = "floor"
            elif self._streak["merge"] < self.hysteresis_ticks:
                dec["reason"] = "hysteresis"
            else:
                dec.update(action="merge", src=cold,
                           reason="all-cold")
        return dec

    # --- act ---

    def _note(self, action: str, reason: str,
              epoch: Optional[int]) -> dict:
        rec = {"action": action, "reason": reason, "epoch": epoch,
               "t": time.monotonic()}
        self.decisions.append(rec)
        del self.decisions[:-256]
        _metrics()["decisions"].inc(action=action, reason=reason)
        return rec

    def _apply(self, dec: dict) -> bool:
        """Execute one split/merge decision behind both fences: no
        other change in flight, and the table epoch still the one the
        evidence was read under. Returns True when the change
        completed."""
        fed = self.fed
        if self._inflight is not None:
            self._note(dec["action"], "fence:inflight", dec["epoch"])
            return False
        table = fed.table
        if table is None or table.epoch != dec["epoch"]:
            # The topology moved between observe and act: the
            # evidence (per-partition rates, the src index itself) is
            # stale. Drop the decision; the next tick re-observes.
            self._note(dec["action"], "fence:stale-epoch",
                       dec["epoch"])
            return False
        from .obs.trace import span
        self._inflight = dec["action"]
        try:
            with span(f"autoscale.{dec['action']}", kind="autoscale",
                      reason=dec["reason"], epoch=dec["epoch"],
                      src=dec["src"]):
                if dec["action"] == "split":
                    fed.split_hot(src=dec["src"])
                else:
                    fed.merge_cold(src=dec["src"])
        except (ConnectionError, OSError, ValueError, RuntimeError,
                IndexError):
            self._note(dec["action"], "failed", dec["epoch"])
            return False
        finally:
            self._inflight = None
        self._last_change_t = time.monotonic()
        self._streak["split"] = self._streak["merge"] = 0
        # Partition list reshaped: the rate baseline is meaningless
        # until two post-change observations exist.
        self._prev_rows = None
        self._prev_t = None
        self.last_action = self._note(dec["action"], dec["reason"],
                                      dec["epoch"])
        return True

    def tick(self) -> dict:
        """One observe → decide → (maybe) act cycle. Returns the
        decision record."""
        obs = self.observe()
        dec = self.decide(obs)
        m = _metrics()
        m["degraded"].set(
            1.0 if dec["reason"].startswith("degraded:") else 0.0)
        if dec["action"] == "hold":
            self._note("hold", dec["reason"], dec["epoch"])
            return dec
        dec["applied"] = self._apply(dec)
        return dec

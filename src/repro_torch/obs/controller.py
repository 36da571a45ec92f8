"""Observed-load elastic controller: autoscaling decisions from metrics.

The chaos runtime (``core.chaos``) lets the block runtime survive faults
and the flight recorder (``core.trace``) makes it observable; this module
makes the observations actionable — the elastic driver decides when to
grow/shrink/rebalance from observed load instead of taking the resize point
as a parameter.

The controller samples cheap signals during the pipelined drain (via
``Executor.drain_hook``) and full ``MetricsRegistry`` snapshots at
iteration boundaries, then applies a threshold policy:

* **grow** — dead nodes have shrunk effective capacity, or memory
  backpressure/pressure counters are climbing;
* **shrink** — the simulated worker-utilization of the pipelined clock
  track is below the floor (the cluster is mostly idle);
* **rebalance** — per-node memory imbalance exceeds the bound with
  utilization healthy (same node count, fresh hierarchical layout).

Every decision input is a *deterministic simulated/counter quantity*
(clock-track utilization, the Eq. 2 load matrix, chaos/memory counters) —
never wall time — so the chaos determinism contract holds: same seed +
same plan ⇒ the same actions at the same iterations, and the controller
composes with the ``identical``/``deterministic`` chaos gates.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ControllerPolicy:
    """Thresholds for the observed-load policy (see module docstring)."""

    sample_every: int = 16        # retirements between drain samples
    util_floor: float = 0.35      # shrink below this worker utilization
    util_ceiling: float = 0.85    # grow above this (queue pressure)
    mem_imbalance_max: float = 1.8
    backpressure_grow: int = 1    # backpressure events that trigger grow
    grow_factor: float = 2.0
    shrink_factor: float = 0.5
    min_nodes: int = 2
    max_nodes: int = 64
    cooldown_iters: int = 1       # iterations to hold after an action
    warmup_iters: int = 1         # skip decisions during warm-up (creation
                                  # ops depress utilization at iteration 0)


@dataclass
class ControllerAction:
    iteration: int
    kind: str                     # "grow" | "shrink" | "rebalance"
    from_nodes: int
    to_nodes: int
    reason: str
    signals: Dict[str, float] = field(default_factory=dict)

    def as_dict(self) -> Dict[str, Any]:
        return {"iteration": self.iteration, "kind": self.kind,
                "from_nodes": self.from_nodes, "to_nodes": self.to_nodes,
                "reason": self.reason, "signals": dict(self.signals)}


class ObservedLoadController:
    """Samples a context's metrics and decides elastic actions.

    Attach with :meth:`attach` (installs the drain hook), read signals with
    :meth:`signals`, and call :meth:`decide` at each iteration boundary —
    the driver (``repro_torch.launch.chaos.run_scenario``) performs the actual
    ``elastic_relayout`` so array handles stay owned by the workload loop.
    """

    def __init__(self, policy: Optional[ControllerPolicy] = None):
        self.policy = policy or ControllerPolicy()
        self.actions: List[ControllerAction] = []
        self.samples: List[Dict[str, float]] = []
        self._ctx = None
        self._retired = 0
        self._cooldown = 0
        self._pressure_seen = 0.0
        self._dead_handled = 0.0

    # -- wiring -----------------------------------------------------------
    def attach(self, ctx) -> "ObservedLoadController":
        """Install the drain-hook sampler on ``ctx``'s executor.  Re-attach
        after every ``elastic_relayout`` (the new context shares the
        executor, so this is cheap but keeps ``self._ctx`` honest)."""
        self._ctx = ctx
        ctx.executor.drain_hook = self._on_retire
        return self

    def detach(self) -> None:
        if self._ctx is not None:
            self._ctx.executor.drain_hook = None
        self._ctx = None

    def _on_retire(self, out_id: int) -> None:
        self._retired += 1
        if self._retired % self.policy.sample_every == 0:
            self.samples.append(self.signals())

    # -- signals ----------------------------------------------------------
    def signals(self) -> Dict[str, float]:
        """Deterministic load signals from the attached context: simulated
        clock utilization, Eq. 2 memory imbalance, queue depth and
        memory/chaos pressure counters.  No wall-clock inputs."""
        ctx = self._ctx
        state = ctx.state
        busy = state.clocks_pipe.busy
        mk = float(busy.max()) if busy.size else 0.0
        util = float(busy.mean() / mk) if mk > 0.0 else 0.0
        mem = state.S[:, 0]
        imbalance = float(mem.max() / max(mem.mean(), 1e-12))
        mstats = ctx.executor.memory.stats
        pressure = float(mstats.backpressure_events + mstats.spills
                         + mstats.oom_events)
        dead = len(ctx.chaos_engine.dead) if ctx.chaos_engine is not None \
            else 0
        return {
            "utilization": util,
            "makespan_pipelined": mk,
            "mem_imbalance": imbalance,
            "pending_ops": float(ctx.executor.pending_count()),
            "mem_pressure": pressure,
            "dead_nodes": float(dead),
            "nodes": float(ctx.cluster.num_nodes),
        }

    def snapshot(self) -> Dict[str, float]:
        """Full registry snapshot (the heavyweight view, iteration-boundary
        only); the drain-hook samples stick to :meth:`signals`."""
        return self._ctx.loads()

    # -- policy -----------------------------------------------------------
    def decide(self, iteration: int) -> Optional[ControllerAction]:
        """Evaluate the policy at an iteration boundary.  Returns the action
        the driver should apply (or ``None``), recording it either way."""
        p = self.policy
        if iteration < p.warmup_iters:
            return None
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        sig = self.signals()
        k = int(sig["nodes"])
        alive = k - int(sig["dead_nodes"])
        action: Optional[ControllerAction] = None

        grow_to = min(p.max_nodes, max(int(round(k * p.grow_factor)),
                                       k + 1))
        shrink_to = max(p.min_nodes, min(int(round(k * p.shrink_factor)),
                                         k - 1))
        new_pressure = sig["mem_pressure"] - self._pressure_seen
        new_dead = sig["dead_nodes"] - self._dead_handled
        if new_dead > 0 and grow_to > alive:
            action = ControllerAction(
                iteration, "grow", k, grow_to,
                f"{int(new_dead)} new dead node(s) shrank capacity", sig)
        elif new_pressure >= p.backpressure_grow and grow_to > k:
            action = ControllerAction(
                iteration, "grow", k, grow_to,
                f"memory pressure (+{new_pressure:.0f} events)", sig)
        elif sig["utilization"] > p.util_ceiling and grow_to > k:
            action = ControllerAction(
                iteration, "grow", k, grow_to,
                f"utilization {sig['utilization']:.2f} > "
                f"{p.util_ceiling:.2f}", sig)
        elif (sig["utilization"] > 0.0
              and sig["utilization"] < p.util_floor
              and sig["dead_nodes"] == 0 and shrink_to < k):
            action = ControllerAction(
                iteration, "shrink", k, shrink_to,
                f"utilization {sig['utilization']:.2f} < "
                f"{p.util_floor:.2f}", sig)
        elif sig["mem_imbalance"] > p.mem_imbalance_max:
            action = ControllerAction(
                iteration, "rebalance", k, k,
                f"mem imbalance {sig['mem_imbalance']:.2f} > "
                f"{p.mem_imbalance_max:.2f}", sig)
        if action is not None:
            self.actions.append(action)
            self._cooldown = p.cooldown_iters
            # a fired action absorbs the pressure/death deltas that (or any
            # lower-priority rule) would otherwise re-trigger every round
            self._pressure_seen = sig["mem_pressure"]
            self._dead_handled = sig["dead_nodes"]
        return action

    # -- reporting --------------------------------------------------------
    def report(self) -> Dict[str, Any]:
        return {
            "actions": [a.as_dict() for a in self.actions],
            "n_actions": len(self.actions),
            "n_samples": len(self.samples),
            "retired_seen": self._retired,
        }

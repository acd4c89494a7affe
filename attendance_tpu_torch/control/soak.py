"""The control soak: the controller must save a run that static flags
lose.

Counterpart of the JAX package's ``tools/control_soak.py``. Three runs
over one frame script (an overload burst, then a trickle) and one fault
script (``persist_fail=1.0`` plus a transport partition for the first
``heal_s`` seconds, then healed):

1. the **no-fault run**: no faults, no controller; its state is the
   ground truth;
2. the **static baseline**: the same faults, flags frozen, no spill
   buffer, no controller. Inserts fail through the retry bound and
   dead-letter, so acked events are lost and the state differs from the
   no-fault run's. The soak *requires* this breach: if static flags
   survive the script, the comparison proves nothing;
3. the **controlled run**: the same faults, plus the persist spill
   buffer and the control plane (``control_log``, ``control_spill_dir``).
   Gates: the ladder escalated at least once and settled back to rung 0;
   at most :data:`MAX_ACTUATIONS` records; the circuit closed; both spill
   directories drained; nothing dead-lettered; the state equal to the
   no-fault run's; ``doctor --actuations`` and ``doctor
   --recompile-ceiling 0`` both exit 0.

``python -m attendance_tpu_torch.control.soak [--device cpu]`` runs it
at the JAX tool's sizes and seed and exits 0 on a pass.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import sys
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional

from attendance_tpu_torch import chaos, obs
from attendance_tpu_torch.chaos.soak import (
    launches_since, sketch_state, state_diff, summary)
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.control.actuation import read_actuations
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport.memory_broker import (
    MemoryBroker, MemoryClient)

# The JAX tool's script, faults and ceilings.
NUM_EVENTS = 1 << 15
FRAME_SIZE = 512
LECTURES = 4
BURST_FRAMES = 16       # the overload: sent before the pipeline starts
TRICKLE_S = 0.08        # the live tail's spacing, a frame at a time
HEAL_S = 2.5            # the fault window, the same in both faulted runs
FAULT_SPEC = "persist_fail=1.0,partition=300ms:0.01"
MAX_ACTUATIONS = 200    # the bounded-flapping ceiling
CAPACITY = 50_000
SEED = 20
SETTLE_S = 20.0         # the controlled run's walk back to rung 0


@dataclasses.dataclass(frozen=True)
class Script:
    """The frame script: the stream's size, the burst, the trickle's
    spacing and the fault window."""
    num_events: int = NUM_EVENTS
    frame_size: int = FRAME_SIZE
    lectures: int = LECTURES
    burst_frames: int = BURST_FRAMES
    trickle_s: float = TRICKLE_S
    heal_s: float = HEAL_S


def control_frames(seed: int, script: Script = Script()):
    """(roster, frames): the JAX tool's stream for ``seed``."""
    roster, frames = generate_frames(
        script.num_events, script.frame_size,
        roster_size=min(50_000, script.num_events),
        num_lectures=script.lectures, seed=1_700 + seed)
    return roster, list(frames)


def _client() -> MemoryClient:
    """A broker of the run's own, behind the chaos proxies when an
    injector is installed (``make_client``'s chokepoint)."""
    return chaos.maybe_wrap(MemoryClient(MemoryBroker()))


def _drive(pipe, frames, script: Script, heal, max_seconds: float):
    """The burst, then the trickle against the running pipeline, ``heal``
    called at ``script.heal_s``. -> (finished, errors)."""
    producer = pipe.client.create_producer(pipe.config.pulsar_topic)
    for f in frames[:script.burst_frames]:
        producer.send(f)
    done = threading.Event()
    errors: list = []

    def body():
        try:
            pipe.run(idle_timeout_s=2.0)
        except BaseException as exc:  # noqa: BLE001 — reported, not hung
            errors.append(exc)
        finally:
            done.set()

    threading.Thread(target=body, name="control-soak-run",
                     daemon=True).start()
    t0 = time.monotonic()
    healed = False
    for f in frames[script.burst_frames:]:
        if not healed and time.monotonic() - t0 >= script.heal_s:
            heal()
            healed = True
        producer.send(f)
        time.sleep(script.trickle_s)
        if done.is_set():
            break
    if not healed:  # a short trickle: the fault window still ends
        time.sleep(max(0.0, script.heal_s - (time.monotonic() - t0)))
        heal()
    return done.wait(timeout=max_seconds), errors


def _healer(inj):
    def heal():
        # The injector reads ``spec`` on every roll: swapping it heals
        # the sink and the transport mid-run.
        inj.spec = dataclasses.replace(inj.spec, persist_fail=0.0,
                                       partition=0.0)
    return heal


def _injected(inj) -> Dict[str, int]:
    return {f"{site}/{fault}": n for (site, fault), n
            in sorted(inj.injected.items())}


def no_fault_state(seed: int, *, device, script: Script = Script(),
                   capacity: int = CAPACITY) -> Dict:
    """The ground truth: the stream once, no faults, no controller."""
    chaos.disable()
    obs.disable()
    pipe = FusedPipeline(Config(bloom_filter_capacity=capacity),
                         client=_client(), num_banks=script.lectures,
                         device=device)
    try:
        roster, frames = control_frames(seed, script)
        pipe.preload(roster)
        producer = pipe.client.create_producer(pipe.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(idle_timeout_s=1.0)
        return sketch_state(pipe)
    finally:
        pipe.cleanup()


def baseline_run(seed: int, work: Path, *, device, script: Script,
                 capacity: int, max_seconds: float) -> Dict:
    """Static flags under the fault script: no spill buffer, no
    controller. -> {"state", "dead_lettered", "injected"}, or
    {"error"}."""
    cfg = Config(bloom_filter_capacity=capacity, chaos=FAULT_SPEC,
                 chaos_seed=seed, quarantine_dir=str(work / "baseline-dlq"),
                 max_redeliveries=2, retry_budget_s=1.0)
    inj = chaos.ensure(cfg)
    pipe = FusedPipeline(cfg, client=_client(), num_banks=script.lectures,
                         device=device)
    try:
        roster, frames = control_frames(seed, script)
        pipe.preload(roster)
        finished, errors = _drive(pipe, frames, script, _healer(inj),
                                  max_seconds)
        if not finished or errors:
            return {"error": f"baseline run wedged or raised: {errors!r}"}
        return {"state": sketch_state(pipe),
                "dead_lettered": pipe.metrics.dead_lettered,
                "injected": _injected(inj)}
    finally:
        pipe.cleanup()
        chaos.disable()
        obs.disable()


def controlled_run(seed: int, work: Path, failures: List[str], *, device,
                   script: Script, capacity: int,
                   max_seconds: float) -> Dict:
    """The same faults with the spill buffer and the control plane; its
    gates append to ``failures``. -> the run's report (``state`` once it
    finished)."""
    act_log, prom = work / "actuations.jsonl", work / "metrics.prom"
    ingress = work / "ingress-spill"
    cfg = Config(bloom_filter_capacity=capacity, chaos=FAULT_SPEC,
                 chaos_seed=seed, quarantine_dir=str(work / "controlled-dlq"),
                 max_redeliveries=2, retry_budget_s=1.0,
                 persist_spill_dir=str(work / "persist-spill"),
                 persist_breaker_failures=2, persist_breaker_cooldown_s=0.25,
                 snapshot_dir=str(work / "snaps"), snapshot_mode="delta",
                 snapshot_every_batches=8, control_log=str(act_log),
                 control_spill_dir=str(ingress),
                 # Each half-open probe under a still-failing sink costs
                 # two ladder moves (shed -> probe -> shed); at a 0.25 s
                 # cooldown the default 8 a minute would freeze the
                 # ladder at shed before the heal: budget ~8 cycles.
                 control_dwell_s=0.3, control_clear_ticks=2,
                 control_flap_limit=24, metrics_prom=str(prom),
                 metrics_interval_s=0.1)
    telemetry = obs.enable(cfg)
    inj = chaos.ensure(cfg)
    pipe = FusedPipeline(cfg, client=_client(), num_banks=script.lectures,
                         device=device)
    report: Dict = {}
    try:
        roster, frames = control_frames(seed, script)
        pipe.preload(roster)
        finished, errors = _drive(pipe, frames, script, _healer(inj),
                                  max_seconds)
        if not finished or errors:
            failures.append(f"controlled run wedged or raised: {errors!r}")
            return report
        # The pressure is gone: the ladder must walk back to rung 0 on
        # its own, paced by the dwell.
        eng = telemetry.control
        deadline = time.monotonic() + SETTLE_S
        while time.monotonic() < deadline and eng.ladder.rung != 0:
            time.sleep(0.2)
        if eng.ladder.rung != 0:
            failures.append(f"controller never de-escalated (rung "
                            f"{eng.ladder.rung} after the settle window)")
        store = pipe.store
        if store.breaker.opened_total == 0:
            failures.append("persist_fail never opened the circuit")
        if store.breaker.state != "closed":
            failures.append(f"circuit ended {store.breaker.state!r}, not "
                            f"closed")
        if store.spill_pending != 0:
            failures.append(f"{store.spill_pending} persist spill "
                            f"batch(es) stranded")
        stranded = (sorted(p.name for p in ingress.glob("ingress-*.bin"))
                    if ingress.is_dir() else [])
        if stranded:
            failures.append(f"{len(stranded)} ingress spill file(s) "
                            f"stranded: {stranded}")
        if pipe.metrics.dead_lettered:
            failures.append(f"controlled run dead-lettered "
                            f"{pipe.metrics.dead_lettered} frame(s) (acked "
                            f"loss)")
        report.update(
            state=sketch_state(pipe), spilled=store.spilled_total,
            drained=store.drained_total,
            circuit_opened=store.breaker.opened_total,
            ingress_spilled=eng.admission.spilled_total,
            ingress_drained=eng.admission.drained_total,
            shed=eng.admission.shed_total, injected=_injected(inj))
        return report
    finally:
        pipe.cleanup()
        chaos.disable()
        obs.disable()  # the last prom block, the actuation log closed
        records, problems = read_actuations(str(act_log))
        report["actuations"] = len(records)
        failures.extend(f"actuation log: {p}" for p in problems)
        if not any(r["knob"] == "ladder.rung"
                   and r["direction"] == "escalate" for r in records):
            failures.append("controller never escalated the ladder under "
                            "the fault script")
        if len(records) > MAX_ACTUATIONS:
            failures.append(f"{len(records)} actuations recorded: flapping "
                            f"(cap {MAX_ACTUATIONS})")
        report["peak_rung"] = max((r["rung"] for r in records), default=0)


def doctor(argv: List[str]) -> int:
    """``python -m attendance_tpu_torch doctor argv`` in this process; its
    exit code."""
    from attendance_tpu_torch import cli
    with contextlib.redirect_stdout(io.StringIO()):
        try:
            cli.main(["doctor", *argv])
        except SystemExit as exc:
            return int(exc.code or 0)
    return 0


def run_control_soak(seed: int = SEED, *, workdir, device,
                     script: Script = Script(), capacity: int = CAPACITY,
                     max_seconds: float = 120.0) -> Dict:
    """The three runs and their gates on ``device``; returns the report
    (``report["ok"]`` is the verdict, ``report["failures"]`` its
    reasons, ``report["launches"]`` each run's kernel launches)."""
    failures: List[str] = []
    t_start = time.monotonic()
    work = Path(workdir)
    work.mkdir(parents=True, exist_ok=True)
    report: Dict = {"seed": seed, "spec": FAULT_SPEC,
                    "events": script.num_events, "launches": {}}
    try:
        before = dict(kernels.launches)
        want = no_fault_state(seed, device=device, script=script,
                              capacity=capacity)
        report["launches"]["no_fault"] = launches_since(before)
        report["no_fault"] = summary(want)

        before = dict(kernels.launches)
        base = baseline_run(seed, work, device=device, script=script,
                            capacity=capacity, max_seconds=max_seconds)
        report["launches"]["baseline"] = launches_since(before)
        if "error" in base:
            failures.append(base["error"])
        else:
            # The baseline must breach: acked loss under static flags is
            # what the controller exists to prevent.
            report["baseline"] = dict(
                summary(base["state"]), dead_lettered=base["dead_lettered"],
                injected=base["injected"],
                differs_in=state_diff(base["state"], want))
            if base["dead_lettered"] == 0:
                failures.append("baseline dead-lettered nothing: the fault "
                                "script is too soft to prove anything")
            if not state_diff(base["state"], want):
                failures.append("baseline state equals the no-fault run's: "
                                "static flags survived, the comparison is "
                                "vacuous")

        before = dict(kernels.launches)
        ctl = controlled_run(seed, work, failures, device=device,
                             script=script, capacity=capacity,
                             max_seconds=max_seconds)
        report["launches"]["controlled"] = launches_since(before)
        got = ctl.pop("state", None)
        report["controlled"] = ctl
        if got is not None:
            diff = state_diff(got, want)
            if diff:
                failures.append(f"controlled state differs from the "
                                f"no-fault run in {diff}: {summary(got)} "
                                f"!= {summary(want)}")

        # The offline replay verbs, as an operator runs them.
        act_log, prom = work / "actuations.jsonl", work / "metrics.prom"
        if act_log.is_file():
            code = doctor(["--actuations", str(act_log)])
            report["doctor_actuations_rc"] = code
            if code != 0:
                failures.append(f"doctor --actuations exited {code}")
        else:
            failures.append("no actuation log written")
        if prom.is_file():
            code = doctor([str(prom), "--recompile-ceiling", "0"])
            report["doctor_recompile_rc"] = code
            if code != 0:
                failures.append(f"doctor --recompile-ceiling 0 exited "
                                f"{code}: a shape-changing actuation "
                                f"escaped the ladder")
        else:
            failures.append("no prom artifact written")
        return report
    finally:
        chaos.disable()
        obs.disable()
        report["wall_s"] = time.monotonic() - t_start
        report["failures"] = failures
        report["ok"] = not failures


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m attendance_tpu_torch.control.soak",
        description="The control soak (counterpart of the JAX package's "
                    "tools/control_soak.py).")
    ap.add_argument("--workdir", default="control-soak-work")
    ap.add_argument("--seed", type=int, default=SEED)
    ap.add_argument("--device", default="cuda:0",
                    help="the pipelines' device (cpu only for tests)")
    args = ap.parse_args(argv)
    report = run_control_soak(args.seed, workdir=args.workdir,
                              device=args.device)
    print(json.dumps({k: v for k, v in report.items() if k != "failures"},
                     default=str))
    for line in report["failures"]:
        print(f"FAIL: {line}")
    print(f"{'PASS' if report['ok'] else 'FAIL'}: control soak seed "
          f"{args.seed} ({report['wall_s']} s)")
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())

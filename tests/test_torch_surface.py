"""The port's whole surface against the JAX package's: every flag of every
entry point, and every ``Config`` field each module reads.

(a) Flags. The JAX CLI builds its parser inside ``main``; it is captured
by making ``argparse.ArgumentParser.parse_args`` record the parser and
raise, the JAX package untouched. For every verb (and the broker's and
the federation worker's own entry points) the JAX flags the port lacks
must equal ``MISSING``, a table of flag families, each with the
recorded departure or the JAX code that shows which verbs read it. The
port's own extra flags must equal ``PORT_EXTRAS``. Aliases count as one
flag. Every flag both packages have takes JAX's default, type, action
and choices.

(b) Config reads. An AST scan collects, for every module of the JAX
package, the ``Config`` fields it reads (``config.X``, ``self.config.X``,
``getattr(config, "X", ...)``) and the fields it sets in a
``Config(...)`` it builds. The port's module of the same path must give
the same set. The CLI modules (``cli.py``, ``config.py``) build their
``Config`` from the flags, which (a) holds flag by flag, so there only
the reads are compared. Modules with no port file and fields the port's
``Config`` lacks are named, each with its reason.

(c) The repo's CI gates. Every script in ``tools/`` maps to its port
counterpart (a module function, or the ``chip_smoke.py`` phase function
that runs it on the card) or to a recorded reason it has none; every
``--spec`` word and ``--wire`` choice of ``tools/chaos_soak.py`` maps to
the port's soak function that runs it, with the tool's spec strings.

Nothing here runs a pipeline but the one check that the ring departure
rests on; the rest is parsing and reading source.
"""

import argparse
import ast
import dataclasses
import threading
import time
from pathlib import Path

import pytest

from attendance_tpu import cli as jax_cli
from attendance_tpu.config import Config as JaxConfig
from attendance_tpu.federation import worker as jax_worker
from attendance_tpu.transport import socket_broker as jax_broker
from attendance_tpu_torch import cli as port_cli
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.federation import worker as port_worker
from attendance_tpu_torch.transport import socket_broker as port_broker

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "attendance_tpu"
PORT_PKG = REPO / "attendance_tpu_torch"


class _Parsed(Exception):
    """Raised in place of parsing, once the parser is recorded."""


def _capture_parser(main, argv):
    """The parser ``main(argv)`` builds, captured at its ``parse_args``."""
    got = {}
    real = argparse.ArgumentParser.parse_args

    def record(self, args=None, namespace=None):
        got["parser"] = self
        raise _Parsed

    argparse.ArgumentParser.parse_args = record
    try:
        with pytest.raises(_Parsed):
            main(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return got["parser"]


def _verbs(parser):
    for action in parser._actions:
        if isinstance(action, argparse._SubParsersAction):
            return dict(action.choices)
    raise AssertionError("the parser has no verbs")


def _options(parser):
    """Each optional argument's option strings, ``-h`` left out."""
    return [a for a in parser._actions
            if a.option_strings and not isinstance(a, argparse._HelpAction)]


def _missing_and_extra(jax_parser, port_parser):
    """(JAX flags the port lacks, by their first option string; the
    port's option strings JAX lacks). A JAX flag is present when the
    port has any of its aliases."""
    port_strings = {s for a in _options(port_parser) for s in a.option_strings}
    jax_strings = {s for a in _options(jax_parser) for s in a.option_strings}
    missing = {a.option_strings[0] for a in _options(jax_parser)
               if not set(a.option_strings) & port_strings}
    return missing, port_strings - jax_strings


# -- (a) the flag table -------------------------------------------------------

# The verbs JAX builds with ``config.add_flags`` (every Config flag).
CONFIG_VERBS = frozenset({"analyze", "bridge", "doctor", "federate", "fused",
                          "generate", "parity", "pipeline", "process",
                          "serve", "stats"})
NOT_FUSED = CONFIG_VERBS - {"fused"}
# The verbs whose runs start no telemetry bundle: JAX calls
# ``obs.ensure`` from the processor, the fused pipeline and the bridge
# (``pipeline/processor.py:166``, ``fast_path.py:384``, ``bridge.py:60``)
# and from ``serve`` and ``federate`` (``cli.py:345``, ``:420``) only.
NO_TELEMETRY = frozenset({"analyze", "doctor", "generate", "parity",
                          "stats"})


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    flags: frozenset
    verbs: frozenset  # the port verbs that lack these flags
    why: str


def _f(*flags):
    return frozenset(flags)


MISSING = [
    Family("recorded departures",
           _f("--no-json-chunk-decode"), CONFIG_VERBS,
           "ROADMAP departure 'No json_chunk_decode switch'."),
    Family("store key", _f("--bloom-filter-key"),
           CONFIG_VERBS - {"generate", "process", "pipeline"},
           "ROADMAP Queue C, the --bloom-filter-key repair: read by the "
           "generator and the processor (attendance_tpu/cli.py:56, :304, "
           "pipeline/processor.py) only."),
    Family("temporal",
           _f("--temporal-period-s", "--allowed-lateness",
              "--watermark-idle-s", "--temporal-ring-banks", "--cms-depth",
              "--cms-width", "--cms-topk"), NOT_FUSED,
           "read by temporal/plane.py, which only the fused pipeline "
           "builds (fast_path.py reads temporal_period_s); only cmd_fused "
           "builds a FusedPipeline (attendance_tpu/cli.py:235-244)."),
    Family("mesh, wire and integrity",
           _f("--num-shards", "--num-replicas", "--replica-sync",
              "--wire-format", "--no-integrity"), NOT_FUSED,
           "read by pipeline/fast_path.py alone (the scan in (b)); only "
           "cmd_fused builds a FusedPipeline (attendance_tpu/cli.py:244)."),
    Family("control",
           _f("--control-log", "--control-spill-dir", "--control-dwell-s",
              "--control-clear-ticks", "--control-flap-limit"), NOT_FUSED,
           "ROADMAP departure 'The control flags only on fused'."),
    Family("ingress and shm",
           _f("--ingress-lanes", "--lane-queue-depth", "--lane-decode",
              "--ingress-wire", "--shm-dir", "--shm-slots",
              "--shm-slot-bytes"), NOT_FUSED,
           "ROADMAP departure 'The ring, lane and serving flags only where "
           "they act': the lanes feed only the fused pipeline "
           "(pipeline/lanes.py, fast_path.py:466); the ring reaches any "
           "verb's make_client (transport/__init__.py:234-242), but JAX's "
           "processor dead-letters every ring message "
           "(test_jax_processor_over_the_ring_dead_letters_every_event)."),
    Family("serving",
           _f("--serve-port", "--query-batch-max",
              "--read-staleness-ceiling-s"),
           NOT_FUSED - {"serve", "federate"},
           "read by serve and federate (attendance_tpu/cli.py:354-356, "
           ":432-435) and a serving fused pipeline; obs._slo_specs_from "
           "(obs/__init__.py:441-453) turns the ceiling into a "
           "read_staleness objective whose gauge only a read mirror "
           "registers: ROADMAP departure 'The ring, lane and serving flags "
           "only where they act'."),
    Family("federation",
           _f("--fed-worker", "--fed-shard", "--fed-shards",
              "--fed-gossip-topic", "--fed-gossip-broker",
              "--fed-heartbeat-s", "--fed-dead-after-s"),
           NOT_FUSED - {"federate"},
           "read by federation/gossip.py: FenceGossip (built by the fused "
           "pipeline, fast_path.py reads fed_worker) and the Aggregator "
           "(built by cmd_federate, attendance_tpu/cli.py:430)."),
    Family("chaos", _f("--chaos", "--chaos-seed"),
           _f("analyze", "doctor", "parity", "serve", "stats"),
           "ROADMAP departure 'The fault flags only where something reads "
           "them': the verbs that open a broker client."),
    Family("persist",
           _f("--persist-spill-dir", "--persist-breaker-failures",
              "--persist-breaker-cooldown-s"),
           CONFIG_VERBS - {"fused", "process", "pipeline"},
           "ROADMAP departure 'The fault flags only where something reads "
           "them': the verbs with a persist sink."),
    Family("profile dir", _f("--profile-dir"),
           CONFIG_VERBS - {"fused", "process", "pipeline"},
           "ROADMAP departure '--profile-dir only where a run reads "
           "it'."),
    Family("telemetry",
           _f("--metrics-port", "--metrics-prom", "--metrics-interval-s",
              "--metric-series-max", "--flight-recorder", "--flight-path",
              "--trace-out", "--audit-sample", "--alert-log", "--slo",
              "--slo-fast-s", "--slo-slow-s", "--profile-hz",
              "--profile-out"), NO_TELEMETRY,
           "read by obs/__init__.py alone, whose bundle these verbs never "
           "start (NO_TELEMETRY)."),
    Family("fleet and incident",
           _f("--fleet-push", "--fleet-role", "--fleet-instance",
              "--fleet-push-interval-s", "--incident-dir",
              "--incident-clear-ticks"), NO_TELEMETRY,
           "ROADMAP departure 'The fleet and incident flags only where "
           "read'."),
    Family("fleet collector", _f("--fleet-port", "--fleet-dir"),
           CONFIG_VERBS - {"federate"},
           "ROADMAP departure 'The fleet and incident flags only where "
           "read': read by cmd_federate alone "
           "(attendance_tpu/cli.py:402-419)."),
    Family("generic store and backends",
           _f("--sketch-backend", "--storage-backend", "--bloom-layout",
              "--hll-key-prefix", "--invalid-topic", "--redis-host",
              "--redis-port", "--cassandra-hosts", "--cassandra-keyspace"),
           _f("fused", "bridge", "serve", "federate", "doctor"),
           "read by sketch/, storage/, parity.py and pipeline/processor.py "
           "(and cmd_stats, attendance_tpu/cli.py:195): the generic store "
           "that generate, process, pipeline, stats, analyze and parity "
           "open; the fused pipeline keeps its own blocked filter and "
           "columnar store."),
    Family("sketch geometry and snapshots",
           _f("--bloom-capacity", "--bloom-error-rate",
              "--snapshot-every-batches", "--snapshot-mode",
              "--snapshot-compact-every"),
           _f("bridge", "serve", "federate", "doctor"),
           "read by the fused pipeline and the processor (fast_path.py, "
           "processor.py; bloom_filter_error_rate also parity.py); the "
           "bridge only repacks frames, serve and federate read chains "
           "and gossip, doctor reads artifacts."),
    Family("register width", _f("--hll-precision"),
           _f("bridge", "serve", "doctor"),
           "read by the fused pipeline, the stores, obs/health.py and the "
           "Aggregator (federation/gossip.py, so federate takes it); "
           "serve reads the width from the chain files."),
    Family("snapshot dir", _f("--snapshot-dir"),
           _f("bridge", "federate", "doctor"),
           "read by the fused pipeline, the processor and serve "
           "(attendance_tpu/cli.py:340); FenceGossip reads it on the "
           "pipeline's side."),
    Family("batching and dead letters",
           _f("--batch-size", "--batch-timeout-s", "--max-redeliveries",
              "--metrics-json"), _f("serve", "federate", "doctor"),
           "read by the processor, the bridge, the fused pipeline and its "
           "lanes (handle_poison's callers: pipeline/processor.py:480, "
           "bridge.py:143, fast_path.py:3148, lanes.py:461)."),
    Family("transport", _f("--transport-backend", "--socket-broker",
                            "--pulsar-host", "--pulsar-topic",
                            "--retry-budget-s", "--quarantine-dir"),
           _f("serve"),
           "cmd_serve opens no broker client "
           "(attendance_tpu/cli.py:323-376)."),
]

# The port's own flags: the torch device on the verbs that build a
# store or a pipeline, and the seconds-suffixed alias of
# --allowed-lateness.
_DEVICE = _f("--device")
PORT_EXTRAS = {
    "analyze": _DEVICE, "generate": _DEVICE, "parity": _DEVICE,
    "pipeline": _DEVICE, "process": _DEVICE, "stats": _DEVICE,
    "fused": _DEVICE | {"--allowed-lateness-s"},
}
# JAX's choices the port refuses (none since the Pulsar transport was
# ported).
CHOICE_DEPARTURES = {}


def _jax_cli_parser():
    return _capture_parser(jax_cli.main, ["fused"])


def _expected_missing(verb):
    return set().union(*[f.flags for f in MISSING if verb in f.verbs])


def test_family_table_is_well_formed():
    flags = [s for f in MISSING for s in f.flags]
    assert len(MISSING) == len({f.name for f in MISSING})
    # A flag may sit in one family only, and every family says why.
    assert len(flags) == len(set(flags))
    assert all(f.why and f.verbs <= CONFIG_VERBS for f in MISSING)


def test_every_jax_verb_has_a_port_verb():
    assert set(_verbs(port_cli.build_parser())) == set(
        _verbs(_jax_cli_parser()))


@pytest.mark.parametrize("verb", sorted(CONFIG_VERBS | {
    "telemetry", "fleet", "scrub"}))
def test_verb_flags_equal_jax_but_the_table(verb):
    jax_verb = _verbs(_jax_cli_parser())[verb]
    port_verb = _verbs(port_cli.build_parser())[verb]
    missing, extra = _missing_and_extra(jax_verb, port_verb)
    assert missing == _expected_missing(verb)
    assert extra == set(PORT_EXTRAS.get(verb, ()))


@pytest.mark.parametrize("verb", sorted(CONFIG_VERBS | {
    "telemetry", "fleet", "scrub"}))
def test_shared_flags_take_jax_defaults_types_and_choices(verb):
    jax_actions = {s: a for a in _options(_verbs(_jax_cli_parser())[verb])
                   for s in a.option_strings}
    port_actions = {s: a for a in _options(
        _verbs(port_cli.build_parser())[verb]) for s in a.option_strings}
    for s in sorted(set(jax_actions) & set(port_actions)):
        j, p = jax_actions[s], port_actions[s]
        assert type(p) is type(j), s
        assert (p.default, p.type, p.nargs) == (j.default, j.type,
                                                 j.nargs), s
        if j.choices is not None:
            assert set(p.choices) == set(j.choices) - CHOICE_DEPARTURES.get(
                s, set()), s


def test_fused_takes_metrics_json_and_max_redeliveries_as_jax():
    args = port_cli.build_parser().parse_args(
        ["fused", "--metrics-json", "m.jsonl", "--max-redeliveries", "1"])
    config = port_cli._fused_config(args)
    assert (config.metrics_json, config.max_redeliveries) == ("m.jsonl", 1)
    d = port_cli._fused_config(port_cli.build_parser().parse_args(["fused"]))
    assert (d.metrics_json, d.max_redeliveries) == (
        JaxConfig().metrics_json, JaxConfig().max_redeliveries)


@pytest.mark.parametrize("entry", ["socket_broker", "worker"])
def test_entry_point_flags_equal_jax(entry):
    """The broker's and the federation worker's own parsers. The worker
    adds --device and --trace-out (ROADMAP departure 'The federation
    worker's flags')."""
    if entry == "socket_broker":
        jax_p = _capture_parser(jax_broker.main, [])
        port_p = _capture_parser(port_broker.main, [])
        extras = set()
    else:
        jax_p = _capture_parser(jax_worker.main, [])
        port_p = port_worker.build_parser()
        extras = {"--device", "--trace-out"}
    missing, extra = _missing_and_extra(jax_p, port_p)
    assert missing == set()
    assert extra == extras
    jax_actions = {a.dest: a for a in _options(jax_p)}
    for a in _options(port_p):
        if a.dest in jax_actions:
            j = jax_actions[a.dest]
            assert (a.default, a.type) == (j.default, j.type), a.dest


def test_repaired_flags_carry_jax_help():
    """The flags this surface test first found missing read as JAX's."""
    def helps(parser):
        return {s: a.help for a in _options(parser) for s in a.option_strings}

    jax_fused = helps(_verbs(_jax_cli_parser())["fused"])
    port_fused = helps(_verbs(port_cli.build_parser())["fused"])
    for flag in ("--metrics-json", "--max-redeliveries"):
        assert port_fused[flag] == jax_fused[flag], flag
    assert helps(_capture_parser(port_broker.main, []))["--fleet-push"] == \
        helps(_capture_parser(jax_broker.main, []))["--fleet-push"]


# -- (b) Config reads ---------------------------------------------------------

# Modules of the JAX package with no port file, each with its reason.
NO_PORT_FILE = {
    "utils/cache.py": "the XLA compile cache, with no PyTorch meaning",
    "ops/pallas_kernels.py": "the Pallas kernels, ported as K1 and K4 "
                             "(ops/kernels.py and csrc/)",
}
# JAX Config fields the port's Config lacks, each a recorded departure,
# and the JAX module that reads it.
FIELD_DEPARTURES = {
    "json_chunk_decode": ("pipeline/fast_path.py",
                          "ROADMAP departure 'No json_chunk_decode switch'"),
}
# Where the Config is built from the flag namespace: (a) holds those.
FLAG_BUILDERS = {"cli.py", "config.py"}
_CONFIG_NAMES = {"config", "cfg"}
_CONFIG_ATTRS = {"config", "_config"}


def _is_config(node) -> bool:
    return ((isinstance(node, ast.Name) and node.id in _CONFIG_NAMES)
            or (isinstance(node, ast.Attribute)
                and node.attr in _CONFIG_ATTRS))


def _call_name(node) -> str:
    f = node.func
    return (f.id if isinstance(f, ast.Name)
            else f.attr if isinstance(f, ast.Attribute) else "")


def config_fields_used(path: Path, fields, *, builds: bool = True) -> set:
    """The Config fields the module at ``path`` reads (``config.X``,
    ``self.config.X``, ``getattr(config, "X", ...)``) and, with
    ``builds``, sets in a ``Config(...)`` or ``dataclasses.replace(...)``
    it makes."""
    used = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Attribute) and node.attr in fields \
                and _is_config(node.value):
            used.add(node.attr)
        elif isinstance(node, ast.Call):
            name = _call_name(node)
            if name in ("getattr", "hasattr") and len(node.args) >= 2 \
                    and _is_config(node.args[0]) \
                    and isinstance(node.args[1], ast.Constant) \
                    and node.args[1].value in fields:
                used.add(node.args[1].value)
            elif builds and name in ("Config", "replace"):
                used.update(k.arg for k in node.keywords if k.arg in fields)
    return used


JAX_FIELDS = {f.name for f in dataclasses.fields(JaxConfig)}
PORT_FIELDS = {f.name for f in dataclasses.fields(Config)}
SHARED_FIELDS = JAX_FIELDS & PORT_FIELDS
JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


def test_config_fields_equal_jax_but_the_departures():
    assert JAX_FIELDS - PORT_FIELDS == set(FIELD_DEPARTURES)
    assert PORT_FIELDS <= JAX_FIELDS
    jax_d, port_d = JaxConfig(), Config()
    for name in sorted(SHARED_FIELDS):
        assert getattr(port_d, name) == getattr(jax_d, name), name
    for name, (module, _) in FIELD_DEPARTURES.items():
        assert name in config_fields_used(JAX_PKG / module, {name})


def test_modules_without_a_port_file_are_named():
    absent = {m for m in JAX_MODULES if not (PORT_PKG / m).exists()}
    assert absent == set(NO_PORT_FILE)
    for module in absent:
        assert config_fields_used(JAX_PKG / module, JAX_FIELDS) == set(), \
            module


@pytest.mark.parametrize("module", [m for m in JAX_MODULES
                                    if m not in NO_PORT_FILE])
def test_port_module_reads_the_config_fields_jax_does(module):
    builds = module not in FLAG_BUILDERS
    jax_used = config_fields_used(JAX_PKG / module, SHARED_FIELDS,
                                  builds=builds)
    port_used = config_fields_used(PORT_PKG / module, SHARED_FIELDS,
                                   builds=builds)
    assert port_used == jax_used, (sorted(jax_used - port_used),
                                   sorted(port_used - jax_used))


def test_the_scan_sees_each_kind_of_read(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "def f(config, cfg, self):\n"
        "    a = config.batch_size + cfg.shm_slots\n"
        "    b = self.config.wire_format, self._config.serve_port\n"
        "    c = getattr(config, 'metrics_json', '')\n"
        "    d = Config(fleet_push='h:1', bogus=1)\n"
        "    e = other.batch_timeout_s\n")
    assert config_fields_used(src, JAX_FIELDS) == {
        "batch_size", "shm_slots", "wire_format", "serve_port",
        "metrics_json", "fleet_push"}
    assert "fleet_push" not in config_fields_used(src, JAX_FIELDS,
                                                  builds=False)


# -- the evidence of the ring departure ---------------------------------------

def test_jax_processor_over_the_ring_dead_letters_every_event(tmp_path):
    """JAX's ``make_client`` hands the processor a ring client under
    ``--ingress-wire shm``, and the processor dead-letters every message
    it reads from the ring: the ring is the fused pipeline's ingress
    only, which is why the port gives the ring's flags to ``fused``
    alone."""
    from attendance_tpu.pipeline.generator import generate_student_data
    from attendance_tpu.pipeline.processor import AttendanceProcessor
    from attendance_tpu.transport import make_client

    cfg = JaxConfig(ingress_wire="shm", shm_dir=str(tmp_path),
                    sketch_backend="memory", max_redeliveries=0).validate()
    proc = AttendanceProcessor(cfg)
    try:
        proc.setup_bloom_filter()
        run = threading.Thread(target=proc.process_attendance,
                               kwargs=dict(idle_timeout_s=1.0))
        run.start()
        time.sleep(0.2)
        producer = make_client(cfg).create_producer(cfg.pulsar_topic)
        report = generate_student_data(
            producer=producer, sketch_store=proc.sketch,
            bloom_key=cfg.bloom_filter_key, num_students=20, num_invalid=2,
            seed=0, keep_events=False)
        run.join(timeout=60)
        assert not run.is_alive()
        assert report.message_count > 0
        assert proc.metrics.events == 0
        assert proc.metrics.dead_lettered == report.message_count
    finally:
        proc.cleanup()


# -- (c) the repo's CI gates in tools/ -----------------------------------------

TOOLS = REPO / "tools"
# Every JAX tool's counterpart: (a port module, its function), or
# ("chip_smoke", the phase function that runs it on the card).
TOOL_COUNTERPARTS = {
    "chaos_soak.py": ("attendance_tpu_torch.chaos.soak", "run_soak"),
    "delta_crash_smoke.py": ("attendance_tpu_torch.chaos.delta_crash",
                             "run_delta_crash"),
    "control_soak.py": ("attendance_tpu_torch.control.soak",
                        "run_control_soak"),
    "federation_soak.py": ("chip_smoke", "federation_phase"),  # 9(b)
    "incident_smoke.py": ("chip_smoke", "fleet_incident_phase"),  # 15
    "profile_smoke.py": ("chip_smoke", "slo_profiler_phase"),  # 14
    # Serving from a live ingest run (8(d)) and the read audit (12).
    "query_smoke.py": ("chip_smoke", "lanes_serve_phase"),
}
# The tools with no counterpart, each with its reason.
TOOLS_NOT_PORTED = {
    "collapse_probe.py": "forensics of the TPU's SPMD executables (the "
                         "mesh dispatch collapse), with nothing to run on "
                         "the card",
    "bench_trend.py": "the trend gate over the BENCH_*.json files; it goes "
                      "with the port's benchmark (ROADMAP item 3)",
}
# tools/chaos_soak.py's --spec words (and its default spec) and --wire
# choices: each the port's soak function that runs it.
SPEC_COUNTERPARTS = {"default": "run_soak", "rot": "run_soak",
                     "shm": "run_shm_soak", "temporal": "run_temporal_soak"}
WIRE_COUNTERPARTS = {"binary": "run_soak", "columnar": "run_soak"}


def _tool_module(name: str):
    import importlib
    import sys
    if str(TOOLS) not in sys.path:
        sys.path.insert(0, str(TOOLS))
    return importlib.import_module(name)


def _chip_smoke_phases() -> set:
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}


def test_every_tool_maps_to_a_counterpart_or_a_reason():
    import importlib
    tools = {p.name for p in TOOLS.glob("*.py")}
    assert not set(TOOL_COUNTERPARTS) & set(TOOLS_NOT_PORTED)
    assert tools == set(TOOL_COUNTERPARTS) | set(TOOLS_NOT_PORTED)
    phases = _chip_smoke_phases()
    for tool, (module, fn) in TOOL_COUNTERPARTS.items():
        if module == "chip_smoke":
            assert fn in phases, (tool, fn)
        else:
            assert callable(getattr(importlib.import_module(module), fn)), \
                (tool, module, fn)
    assert all(reason for reason in TOOLS_NOT_PORTED.values())


def _spec_words(tool_main) -> set:
    """The strings the tool's ``main`` compares ``args.spec`` with."""
    import inspect
    words = set()
    for node in ast.walk(ast.parse(inspect.getsource(tool_main))):
        if (isinstance(node, ast.Compare)
                and ast.unparse(node.left) == "args.spec"):
            words |= {c.value for c in node.comparators
                      if isinstance(c, ast.Constant)}
    return words


def test_every_chaos_soak_spec_and_wire_maps_to_the_port():
    from attendance_tpu_torch.chaos import soak
    cs = _tool_module("chaos_soak")
    parser = _capture_parser(lambda _argv: cs.main(), [])
    actions = {a.dest: a for a in _options(parser)}
    assert actions["spec"].default == cs.DEFAULT_SPEC
    words = _spec_words(cs.main) | {"default"}
    assert words == set(SPEC_COUNTERPARTS) == set(soak.SPEC_WORDS)
    tool_specs = {"default": cs.DEFAULT_SPEC, "rot": cs.ROT_SPEC,
                  "shm": cs.SHM_SPEC, "temporal": cs.TEMPORAL_SPEC}
    assert soak.SPEC_WORDS == tool_specs
    assert set(actions["wire"].choices) == set(WIRE_COUNTERPARTS) \
        == set(soak.WIRES)
    port_parser = _capture_parser(soak.main, [])
    port_actions = {a.dest: a for a in _options(port_parser)}
    assert set(port_actions["wire"].choices) == set(actions["wire"].choices)
    for fn in {*SPEC_COUNTERPARTS.values(), *WIRE_COUNTERPARTS.values()}:
        assert callable(getattr(soak, fn)), fn
    # The wire reaches each function that builds the stream.
    import inspect
    for fn in (soak.run_soak, soak.soak_frames, soak.poison_frames,
               soak.no_fault_state):
        assert "wire" in inspect.signature(fn).parameters, fn.__name__

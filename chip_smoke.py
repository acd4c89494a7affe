#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and build: the card's name and power limit, then the kernels
     built from ``attendance_tpu_torch/csrc`` with nvcc (time and the
     compiler's per-kernel resource report) and the native host pack;
  2. the launch floor (a ``fill_`` of one int32, timed as the kernels
     are), then each kernel against its plain PyTorch version on the
     card, at the main path's shapes, with exact equality (integer
     sketches), plus CUDA-event timings of the kernel (also printed above
     the floor), the plain version and, where one exists, a single
     PyTorch library call computing the same function (2a, 2c: K3 and K2
     of the fused path, K2 on the word wire and the three bytes widths,
     K2-seg and K2-delta at 131,072 lanes with 256-, 512- and 1,024-bank
     headers and at 1,048,576 lanes (256 banks, and every lane in one
     bank), each beside K2-word's time, its own bound and the decode
     half's yardstick (torch.searchsorted, torch.cumsum), the state the
     CUDA-graph replays left held after each timing; then both on an edge
     frame (empty banks, ragged, seg width 32, a delta prefix that
     wraps), on segment heads at a tile's first and last lane and on a
     frame with no real lane; 2a: K3 at the 100k and
     10M rosters by both of its paths, one thread per key and binned,
     each also onto a filter already holding
     half the roster, timed into a zeroed filter (zero_ timed alone and
     subtracted), with the 10M time's distance from its bound; 2d: K4-K6
     of the temporal plane, K5 at a uniform shape and at the temporal
     path's first window add (48 bucket rows, 8 hot keys), each timed
     replayed and from its starting registers, K6 at both sizes on the
     frames' roster ids and on the temporal traffic's hot-key mix);
  3. the main path: the ``fused`` verb's flow at its defaults (1,048,576
     events in 131,072-event frames, a 100k roster, 16 lectures, seed 0)
     once per wire setting (the default auto wire with the native host
     pack, the word wire with ``ATP_NATIVE=0``, bytes, seg, delta), each
     twice (a first and a second run, each its own pipeline), launch
     counters reset just before and read just after each run, every run
     checked against the frames' ground truth and equal to the default
     run in counters, PFCOUNTs, registers and stored validity; on the
     default run the PFCOUNT path is timed (``count(day)`` per lecture
     and ``count_all()``: host wall per call, and apart the K1 launch,
     the D2H copy and the host estimator);
  3c. (after 3's timed runs) one more default run with ``metrics_json``
     set: the one JSON metrics line it appends is printed and held
     (the JAX package's keys in order, 1,048,576 events in 8 frames,
     ``wire_dwell`` the run's own, ``fpr_is_lower_bound`` true,
     ``estimated_fpr`` null, a positive rate), its state equal to phase
     3's default run, and its launches those of one default run: a step
     launch a frame, one K3, the PFCOUNT's K1;
  2b. (after 3, whose registers it takes) K1 at 1, 16, 256, 512 and 1024
     banks on two fills, 2^20 uniform keys over the banks and the main
     path's 16 live rows repeated to the bank count, held equal to its
     plain version and ``torch.bincount``;
  3b. the temporal path: the same scale with the temporal plane on (60 s
     buckets, a 256-bucket ring that evicts, Count-Min + top-K) over an
     ordered, disordered stream with 8 hot keys, through
     ``FusedPipeline`` / ``preload`` / ``client`` / ``run`` /
     ``window_counts`` / ``temporal_stats``, counters reset just before
     and read just after, held against exact per-bucket uniques, the
     plain Count-Min update and the hot keys; ``window_counts()`` timed
     as the PFCOUNT path is; then the same frames with
     the plane off, and with it on but without the exact shadow;
  5. checkpoint and restore (after 3b): (a) the ``fused`` default run in
     delta mode (a barrier every frame, a compaction every 2 deltas) and
     (b) in barrier mode, each restored by a fresh pipeline and held
     equal to the finished run (counters, PFCOUNTs, registers, bank map,
     deduped store) and to phase 3's run; (c) a crash: a delta-mode run
     of 60% of the stream whose disk dies after the first base (a power
     cut at the second manifest rename), ``consumer.close()``, and a
     successor on the same broker and directory whose restored counters
     are the acked prefix's and whose drained state equals the
     uninterrupted run; (d) the temporal path with delta snapshots,
     restored equal in ``window_counts()``, ring and state; (e) events/s
     with checkpointing off, delta and barrier, first and second run,
     with ``snapshot_stalls`` and ``snapshot_blocked_s``, and B9 on the
     card: the delta capture of 16 rows and the 256-bank base copy
     (graph replays) beside their bound in bytes, and one capture's D2H;
  6. the generic sketch store and the processor loop (after 5): (a) K7
     (1 to 90,000 keys into the 100k-roster filter, flat and blocked,
     onto a filter already holding other ids, with and without a mask)
     and K8 (1 to 1,048,576 keys), each on both of its paths, with the
     plan's crossovers, and K8's pack pass alone, K1-rows (1, 16 and
     1,024 rows, sorted,
     unsorted and repeated) and K1-union (2, 7, 32 and 1,024 rows, also
     on rows repeated and outside the bank range, and replayed in a
     CUDA graph) on a
     1,024-key store filled by ``pfadd_many`` (BASELINE.md config 3),
     each held against its plain version and timed beside its bound,
     the launch floor and the library call (``index_fill_``,
     ``torch.bincount``, ``torch.amax`` + ``torch.bincount``); the fill
     fraction, K5 at a PFADD's shape and the bank growth timed; (b) the
     ``pipeline`` flow with the card store at 90,000 students (the
     generator's whole id range, about 0.97M events, batch 8,192),
     counters reset just before and read just after the run and its
     reads (PFCOUNT per lecture, ``pfcount_many``, the week's union,
     the insights), gated against the generator's ground truth (no
     false negatives, measured FPR <= 1.5% on 1,048,576 non-roster ids,
     PFCOUNTs within 3%) and equal to the same flow with the memory
     store in validity, PFCOUNTs and BF.INFO; (c) ``parity --oracle
     sim`` at 1,048,576 events, 100k roster, 16 lectures; (d) the
     processor's delta and barrier checkpoints restored equal; (e) the
     store's PFCOUNT latency (one key, 1,024 keys batched, a 7-key
     union);
  7. the reference's JSON wire into the fused path (after 6), at
     BASELINE.md config 1's scale (the generator at 90,000 students, 50
     invalid ids, seed 0: about 969,500 per-event JSON messages): (a)
     ``FusedPipeline`` on a memory broker through the chunk
     consumer and the native scan, counters reset just before and read
     just after the run and ``count_all()``, held to the stream (every
     event stored in order, no false negatives, measured FPR <= 1.5% on
     1,048,576 non-roster ids, PFCOUNTs within 3%) and equal to the same
     events as ATB2 frames in counters, PFCOUNTs, registers, bank map and
     stored validity; (b) ``JsonBinaryBridge`` -> ``<topic>-binary`` ->
     ``FusedPipeline``, equal to (a); (c) a port ``BrokerServer`` in this
     process, two ``python -m attendance_tpu_torch bridge
     --transport-backend socket`` processes (one intra-op thread each)
     competing on one subscription, each stopping after half the
     events, and the card's ``FusedPipeline`` reading the binary topic
     through a ``SocketClient``, cut to 9,000 students: every message
     converted once, none dead-lettered, backlog 0, state equal to (b) on
     the cut stream; (d) events/s of (a), (b) (the bridge's own too) and
     (c) with the decode and pack stage seconds, and (a)'s K2, K3 and K1
     launches;
  8. striped ingress, the shared-memory ring and the query plane (after
     7): (a) phase 7(a)'s 969,500 JSON messages through
     ``ingress_lanes=4`` on a memory broker, equal to 7(a) in counters,
     PFCOUNTs, registers and bank map day by day (banks are numbered in
     dispatch order) and stored validity (rows sorted),
     ``lane_event_totals()`` summing to every message with every lane
     working, none dead-lettered, backlog 0, events/s and stage seconds
     beside 7(a)'s; (b) phase 7(c)'s cut stream (97,220 messages) through
     2 socket lanes (``subscribe_lane``, one connection each) on a
     ``BrokerServer``, equal to 7(b) on that stream; (c) the ``fused``
     default over ``--ingress-wire shm`` (16 slots of 4 MiB under a
     temporary ``shm_dir``) with one consumer and with two lanes fed by a
     producer process, both equal to phase 3's default run, then a
     checkpointing consumer closed with frames unacked and a fresh
     pipeline resumed at the ring's ``ack_cursor``, equal to phase 3;
     (d) the ``fused`` default with ``serve_port=-1``, delta snapshots at
     every frame, a ``QueryClient`` thread issuing stats and PFCOUNT
     batches during the run (epochs never decrease, no call fails); then
     BF.EXISTS of the roster all true, of 1,048,576 non-roster ids at
     FPR <= 1.5% and equal to K4 on the card's filter, PFCOUNT =
     ``count(day)``, occupancy = ``count_all()``, stats =
     ``validity_counts()``, queries/s of 65,536-key BF.EXISTS and 16-day
     PFCOUNT batches over RPC and in process; ``python -m
     attendance_tpu_torch serve`` on the run's chain answering as the
     in-process engine's final epoch; and phase 3b's temporal
     configuration served, its window verbs equal to what
     ``window_counts()`` implies;
  9. federation (after 8), the JAX package's bench and failover soak
     on the one card, a 100k roster, 8,192-event frames, 6 lectures,
     gossip through a port broker subprocess: (a) scaling rounds of K =
     1, 2 and 4 workers (``run_worker`` in this process for K = 1,
     ``python -m attendance_tpu_torch.federation.worker`` processes
     behind a go-file otherwise), 524,288 events each on the memory data
     plane with delta snapshots every 4 frames, an aggregator folding
     live here; each round held against the no-crash federated oracle
     (one pipeline per shard on the card, merged; the whole roster
     preloaded once by K3, which must equal the OR of the shard
     filters): events, Bloom words, registers by day, valid and invalid,
     served PFCOUNT = the oracle's K1 count, BF.EXISTS true over the
     roster and equal to K4 over 1,048,576 non-roster ids, no stale
     frame; per worker events/s and wall, the aggregate rate, merge lag,
     frames folded, served query rates; (b) failover over the socket
     data plane: 3 workers, 24 frames a shard, snapshots every 2 frames,
     a 3 s death budget; w1 SIGKILLed once its chain holds a delta, its
     newest delta rotted, a ``--takeover`` worker restoring through the
     peer re-assert; gates: declared dead, map bumped, chain recovered,
     re-claimed at a higher incarnation, the delta quarantined, the view
     equal to the oracle (counters at least once, within two group
     commits); (c) ``python -m attendance_tpu_torch federate`` as the
     aggregator of a K = 2 round, queried over the RPC and equal to
     (a)'s oracle; (d) B15, ``bloom_or_words`` on the card equal to its
     numpy twin and timed; no worker compiles (the build directories are
     unchanged);
  10. the mesh engine (``parallel/``, after 9) on virtual meshes whose
     cells repeat the one card: (a) K11 at the shapes the engine sends,
     a replica's whole share of the 10M roster into each slice
     (5,000,000 keys into 4 slices at dp = 2, 10,000,000 into 8 at dp =
     1), binned and one thread per key, each equal to its plain version
     on every slice and the replicas' OR to K3's filter, the preload's
     device time (8 launches), on (4, 2) beside the route of one launch
     a 2^14-key chunk and cell (4,888), and both paths at 2^20 and 2^22
     keys into slices of 4 and 8, either side of the cut-over; K10
     (both wires, with and without the counters, replayed and from the
     starting registers, each held against the plain version) at
     65,536, 131,072 and 1,048,576 lanes on the slices of the 10M
     roster's filter cut for a (4, 2) mesh; K9 on keys and on the word
     wire at the same lanes on every slice of sp = 2, 4 and 8, by both
     paths and the wrapper's pick (the AND across slices equal to K4),
     both paths timed on slice 0; K12 (seg and delta; the delta wire's
     look-back and two-pass designs) at the same lanes and either side of
     its plans' cut-overs, one kernel event a K12-delta call in a
     profiler trace; K1 on register slices [256, 2^14 / sp] for sp =
     2, 4, 8; each equal to its plain version (and K10's register half
     to ``scatter_reduce_`` amax, K1 to ``torch.bincount``) and timed;
     (b) ``ShardedSketchEngine`` on the 1 x 1 mesh through
     ``step_words``, then ``step_narrow`` on the seg and on the delta
     wire, over phase 3's default stream, each equal to phase 3's
     default run, launching only K3 (once), K2 (or K2-seg, K2-delta) and
     K1; (c) BASELINE config #4's 10,000,000-student roster and a stream
     of phase 3's shape drawn from it (1,048,576 events in 131,072-event
     frames, 16 lectures, seed 0) through ``FusedPipeline`` on one card
     and with ``mesh=make_mesh(4, 2, [cuda:0] * 8)`` (query and step
     replica sync, 16 banks: the word wire; query sync on the seg and on
     the delta wire, each also equal to the query word run and
     launching K12 once a frame and replica) and ``make_mesh(8, 1,
     ...)`` (256 banks: the arrays step), counters reset just before
     and read just after each run, each equal to the one-card run in
     counters,
     PFCOUNTs, merged registers, stored validity and bank map, no false
     negatives of 100,000 members, FPR <= 1.3% on 100,000 outsiders, the
     fill equal to the host popcount, K11 launched once a cell (8
     times), the wall of ``pipe.preload(roster)`` and events/s beside
     the one card's (a virtual mesh's rate, never a multi-card one); (d)
     delta snapshots every frame on (4, 2), a crash after 5 of 8
     frames, resumed on (2, 4) equal to the uninterrupted run, the chain
     restored on one card equal; (e) two
     ``tests/torch_multihost_worker.py`` processes sharing the card (one
     cell each, dp = 2 over gloo) on tests/multihost_worker.py's
     workload, each equal to one process's (2, 1) mesh;
  11. the telemetry core on the card (after 10): (a) the ``fused``
     default on the word wire three times with telemetry off and three
     times with ``metrics_port=-1``, ``metrics_prom``, ``flight_recorder``
     and ``trace_out`` on, interleaved (each rate and the on/off ratio of
     the medians), then once more on with a scrape started mid-run from
     inside its receive; per on run, the scrape after it: events,
     frames, wire frames, the dispatch and ``device_wait`` counts, the
     frame wire's bytes, the dispatch-gap quantiles and busy fractions,
     the run equal to phase 3's, the trace (a batch span a frame with
     dequeue_wait, decode, dispatch and device_wait children) and the
     flight dump; (b) the processor on the card store over phase 6b's
     generator cut to 9,000 students (97,220 JSON events) with
     ``metrics_prom``: its stage counts equal its batches; (c) a virtual
     (4, 2) mesh of the card (query sync, word wire) over phase 3's
     stream with telemetry on: shard events per replica, replica
     dispatch spans under the batch spans, equal to one card; (d) a
     K = 2 federation round, the workers with ``--metrics-prom`` and
     ``--trace-out``, the aggregator with telemetry: the merge-lag count
     equals the frames folded, both peers up, every folded
     ``traceparent`` parses, the view equal to its oracle; (e) ``python
     -m attendance_tpu_torch telemetry`` on (a)'s three artifacts;
  12. live accuracy on the card (after 11): (a) the ``fused`` default
     with ``metrics_port=-1``, three runs with ``audit_sample`` 0.01 and
     three without, interleaved (each rate, the medians' ratio), and
     ``observe_fused_frame`` timed alone on the stream's frames; (b)
     audited runs at the 100k roster (sample 0.01 and 1.0) and at
     BASELINE config #4's 10M roster, each with a scrape started from
     inside its receive after the first frame and one after it (the
     render's wall, the K4 and K1 calls the mid-run scrape made off the
     run loop's thread, exactly two K4 and two K1 launches a scrape
     after), gated: no false negative, the measured FPR <= 1.5% and
     equal to a host recount over the shadow's probe sets, the HLL
     estimate equal to ``sum(count_all())``, the fill equal to the host
     popcount and raised to k equal to ``estimated_fpr()``, at sample
     1.0 the measured HLL error <= 3%; (c) a virtual (4, 2) query mesh
     over the 100k stream: the same gates, its measured FPR, fill and
     counters equal to one card's; (d) the processor on the card store
     with the audit on: its audit counters, PFCOUNTs and HLL-error
     gauges equal to the same run's on the CPU, its health gauges equal
     after a snapshot restore into a fresh store; (e) a checkpointed
     ``fused`` default that serves with the audit on: every ``/query/*``
     route equal to the RPC on the same epoch, no read-path false
     negative over the sampled roster, a finite staleness; then the
     ``serve`` verb over its chain with ``--metrics-port``: the same;
  13. the chaos soak on the card (after 12; ``chaos.soak.run_soak``):
     the ``fused`` default's roster and lectures (100,000 students, 16
     lectures), 524,288 events in 4,096-event frames with 2 poison
     frames mid-backlog, through an in-process socket broker into a
     checkpointing (a delta every 4 frames), fully audited pipeline with
     a spill and a quarantine directory on the card, under (a) the JAX
     soak's ``DEFAULT_SPEC`` and (b) its ``ROT_SPEC``, then (b2)
     ``soak.SCRUB_SPEC`` (every chain write rotted, so rot always
     survives the run), each at its seed of ``chaos.soak.SEEDS`` (101,
     389, 389), failing if a fault its gates read (``soak.GATED``:
     persist_fail and conn_reset in (a), enospc, a torn manifest and
     partition in (b), the rot in (b2)) did not fire; each gated: inside
     its deadline,
     per-day PFCOUNTs, deduped
     and valid rows, filter words and register rows equal to the same
     frames' no-fault run, no Bloom false negative (the scrape's counter
     and K4 over the audit's roster), reconnects where ``conn_reset``
     fired, the circuit opened and closed with no spill left where
     ``persist_fail`` fired, exactly the poison frames quarantined; in
     (b) and (b2) scrub flags every surviving disk fault (in (b2) at
     least one survives), the disk-full counter fired where ``enospc``
     did, a partition window opened in (b), and a fresh pipeline
     restored onto the card from the chain through the repair ladder
     (the peer rung: the run gossips as federated worker ``w0``; in (b2)
     the ladder quarantines rotted chain files) equals the no-fault
     state after draining the unacked frames; the
     faults injected per site and each soak's wall printed; K3 and K2
     launched in each fault run (counted from 0 just before it, read just
     after it), K1 and K4 by its gates' reads and the restore; (c) the
     ``fused`` default with
     ``--chaos off`` (the injector installed, never firing) and with no
     injector, three runs a side interleaved (reported, not gated); each
     soak's step 4, ``doctor`` over its prom file and alert log, must
     pass;
  14. SLOs, the profilers and ``doctor`` on the card (after 13): (a) the
     ``fused`` default with telemetry off and with ``--metrics-prom``,
     ``--alert-log``, ``--profile-hz 97``, ``--profile-out``,
     ``--audit-sample 0.01`` and ``--slo throughput>=1e6 --slo
     dispatch_p99<=0.05 --slo fpr<=0.015``, three sessions a side
     interleaved, each one pipeline run twice on the same seed's frames
     (rates, the on/off ratio of the medians): launch shapes counted in
     run 1 and none new in run 2, an attribution with a ``dispatch``
     stage, no firing line, ``doctor --recompile-ceiling 0 --fpr-ceiling
     0.015`` exit 0, the state phase 3's; the SLO ticks a session and the
     K4/K1 launches one tick adds; (b) ``--slo fpr<=0.0001`` at 0.4/1.6 s
     windows fires from the engine's thread (its K4 counted) before a
     10 s deadline, then ``doctor`` exits 1 naming
     ``bloom_measured_fpr``; (c) ``--profile-dir`` on the ``fused``
     default (a cold and a warm trace) and on the processor over the
     card store (about 20,000 events): a ``fused_step_dispatch`` range a
     frame, ``bf_exists_batch`` and ``pfadd_batch``, and for every
     launch inside a trace at least one CUDA kernel event of the
     functions it launches (keys that share a function counted as one
     group); the kernel share and the busy share (kernels, copies and
     memsets as a union of intervals) of the traced window, the rate
     over off and the trace's size. No "SLO tick failed" record, and no engine or
     sampler thread left after it;
  15. the fleet plane and incidents (``fleet_incident_phase``, after 14);
  16. the control plane and the list scan (``control_phase``, after 15):
     (a) the ``fused`` default (delta checkpoints every 2 frames,
     ``--audit-sample 0.01``, ``--control-log``, ``--control-spill-dir``,
     an incident directory) under a controller ticked on an injected
     clock, after a warm-up run of the same configuration: the sink's
     circuit, opened by ``persist_fail`` through the chaos plane, walks
     the ladder to ``shed`` (knobs at rung 4: ``audit_every`` 8, the
     snapshot cadence 4x, admission ``spill``), 2 frames are spilled and
     acked with no K2, the fault window closes, the cooldown passes and
     the clear drains them with one K2 each; the final state equals phase
     3's (counters, PFCOUNTs, registers day by day, stored rows), the
     spill directory is empty, no steady launch shape, ``doctor
     --actuations`` exits 0 (1 on a copy with a repeated ``seq``) and
     ``doctor --incident ... --actuations`` prints its cross-reference;
     (a2) phase 3b's configuration (with ``watermark_idle_s`` 0) paused at
     rung 3 over 3 frames and back: K5 and K6 launch exactly 3 fewer times
     than in 3b, the core state equals 3b's; (b) the engine's own thread
     at a 50 ms tick and a 0.1 s dwell over a paced producer (the default
     stream 4 times, a frame every 75 ms) with a fault window: every rung
     and ``normal`` again, the seconds to rung 4 and back, the spilled
     and drained frames and the drain's wall, the state equal to an
     uncontrolled run over the same frames; (c) reported, not gated: the
     audit at ``audit_every`` 1 and 8, three runs a side interleaved, and
     phase 7(a)'s JSON wire through 4 lanes per ``--lane-decode``
     engine, with whether this interpreter has ``Python.h``. No "control
     tick failed" or "incident tick failed" record, and no engine thread
     left after it;
  17. the repo's crash soaks (``crash_soak_phase``, after 16), the JAX
     ``tools/`` gates at each tool's constants: (a) the fault soak on the
     COLW wire, the rotted frame dead-lettered; (b) the shm ring's
     consumer process SIGKILLed and resumed from the ring's cursor; (c)
     the temporal worker process SIGKILLed and restored, its windows
     equal to the no-crash run's; (d) the delta-crash worker process
     SIGKILLed and restored, ``doctor --snapshot-stall-ceiling`` over its
     artifacts; (e) the control soak, whose static baseline must breach
     and whose controlled run must not; then (b2), (c2), (d2) at phase 3's
     1,048,576 events in 64 frames. Each SIGKILL must leave an unacked
     tail, and each restored run a step launch for every frame it drained;
     one line a soak with its wall, the events folded at the kill, the
     backlog, the faults by site and the restored and oracle runs'
     launches;
  18. the Pulsar transport (``pulsar_phase``, after 17), through
     ``PulsarClient`` over ``tests/torch_fake_pulsar.py`` installed as the
     ``pulsar`` module (pulsar-client's per-message surface; the card's
     machine has no pulsar-client): (a) phase 3's ``fused`` default and
     (b) the same stream through ``--ingress-lanes 2`` (the lanes'
     Message path), each equal to phase 3's default run in counters,
     PFCOUNTs, registers by day and stored rows, with its K3, K2 and K1
     launches; (c) ``process`` with the card store (BASELINE.md config
     1's 100k roster filter at 1%) over 65,738 generator events, equal
     to the same stream over the memory broker in rows, PFCOUNTs,
     BF.INFO, filters and registers, K7/K8/K5/K1-rows launched; (d) a
     stream that goes quiet ends by ``idle_timeout_s``, and a poison
     frame is dead-lettered after exactly 2 nacks, both equal to the
     memory broker's run of the good frames;
  4. a ``kernels`` JSON line and, last, the ``{"ok": true, ...}`` line.
     A kernel's ``launches`` there sums phase 3's first runs (one per
     wire setting), phase 3b's temporal run, phase 6's pipeline run,
     phase 7(a), phase 8's runs, phase 9(a)'s K = 1 round (the worker's
     run and the oracle's reads), phase 10(c)'s five mesh runs and
     phases 11's to 18's runs (each also printed on a line of its own;
     12's count the scrapes' K4, K9 and K1 launches, 13's its fault runs
     and the restore, 14's its SLO ticks, 16's its warm-up and
     controlled runs, 17's its soaks' parent processes: the killed
     workers' launches are not counted); phase 5 prints its own runs' counts on a line of
     its own.

Needs one CUDA card; exits non-zero without one, and without the rest
of the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT_OPS_PER_S = 67e12      # H100 SXM rate outside the tensor cores
CARD_QUERY = ["nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader"]
SOURCE = "attendance_tpu_torch/csrc/sketch_kernels.cu"
# Phase 3's runs: (label, wire_format, native host pack).
WIRE_RUNS = (("default", "auto", True), ("word-numpy", "word", False),
             ("bytes", "bytes", True), ("seg", "seg", True),
             ("delta", "delta", True))
# The step kernel that carries each wire.
STEP_OF_WIRE = {"word": "fused_step", "bytes": "fused_step",
                "seg": "fused_step_seg", "delta": "fused_step_delta"}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def bound_ms(nbytes: float, ops: float):
    """(least time in ms, what bounds it) for this much work."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / INT_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def eager_ms(fn, iters: int = 5) -> float:
    """Mean ms per call of ``fn`` run eagerly (host overhead included)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


REPS, REPLAYS = 20, 5  # launches captured in one graph, timed replays


def kernel_ms(fn, reps: int = REPS, replays: int = REPLAYS) -> float:
    """Mean device ms per launch: ``reps`` launches captured in one CUDA
    graph and replayed, so the wrapper's host overhead is not timed.
    ``fn`` runs 1 + reps * (1 + replays) times (``graph_runs``): once to
    warm up, then each replay of the graph, the first untimed; the
    capture itself runs nothing."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def graph_runs(reps: int = REPS, replays: int = REPLAYS) -> int:
    """How many times ``kernel_ms`` runs its function."""
    return 1 + reps * (1 + replays)


def temporal_frames(num_events: int, batch: int, num_lectures: int,
                    seed: int = 0):
    """(roster, hot keys, frames): an ordered stream clock (mean gap 1
    ms) with 25% of the events displaced back by up to 0.8 s, 10%
    invalid ids, and 8 roster keys written over 15% of the lanes."""
    from attendance_tpu_torch.pipeline.events import encode_planar_batch
    from attendance_tpu_torch.pipeline.loadgen import (
        apply_disorder, stream_micros, synth_columns)

    rng = np.random.default_rng(seed)
    roster = rng.choice(np.arange(10_000, 410_000, dtype=np.uint32),
                        size=100_000, replace=False)
    hot = rng.choice(roster, 8, replace=False)
    frames, cursor = [], 1_753_000_000_000_000
    for i in range(0, num_events, batch):
        n = min(batch, num_events - i)
        cols = synth_columns(rng, n, roster, num_lectures,
                             invalid_fraction=0.1)
        micros = stream_micros(rng, n, cursor)
        cursor = int(micros[-1])
        cols["micros"] = apply_disorder(micros, rng, 0.25, 0.8)
        lanes = rng.random(n) < 0.15
        cols["student_id"] = np.where(
            lanes, hot[rng.integers(0, len(hot), n)],
            cols["student_id"]).astype(np.uint32)
        frames.append(encode_planar_batch(cols))
    return roster, hot, frames


def temporal_window_add(dev, num_lectures: int = 16):
    """(bank, keys, valid) of the temporal path's first window add: the
    131,072 keys of ``temporal_frames``' first frame (8 hot keys on 15%
    of the lanes), their bank rows as a fresh 60 s ring assigns them
    after the day rows, and K4's answer against the frames' roster."""
    from attendance_tpu_torch.models import bloom
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.events import decode_planar_batch
    from attendance_tpu_torch.temporal.buckets import period_micros
    from attendance_tpu_torch.temporal.windows import BucketRing

    roster, _, frames = temporal_frames(131_072, 131_072, num_lectures)
    cols = decode_planar_batch(frames[0])
    rows = iter(range(num_lectures, 1 << 20))
    ring = BucketRing(period_micros(60), 256, lambda key: next(rows),
                      lambda keys, banks: None)
    banks, dropped, _ = ring.assign(cols["lecture_day"], cols["micros"])
    check(dropped == 0, "temporal window add: a dropped lane")
    params = bloom.derive_bloom_params(100_000, 0.01, "blocked")
    words = bloom.bloom_packed_init(params, dev)
    kernels.bloom_add(words, torch.from_numpy(roster.view(np.int32)).to(dev),
                      params)
    keys = torch.from_numpy(
        np.array(cols["student_id"], np.uint32).view(np.int32)).to(dev)
    valid = kernels.bloom_contains(words, keys, params)
    return (torch.from_numpy(np.ascontiguousarray(banks, np.int32)).to(dev),
            keys, valid)


def wire_of(cols, bank_bytes: int, lanes: int, dev):
    """(wire tensor, key bits) of a decoded frame on ``dev``: the word
    wire for bank_bytes 0, else the bytes wire with bank_bytes-wide
    banks; padded to ``lanes``."""
    from attendance_tpu_torch.models import fused

    sid = cols["student_id"]
    banks = (cols["lecture_day"] - 20_260_701).astype(np.int32)
    kw = int(sid.max()).bit_length()
    if bank_bytes == 0:
        return torch.from_numpy(fused.pack_words(
            sid, banks, kw, lanes).view(np.int32)).to(dev), kw
    dtype = {1: np.uint8, 2: np.uint16, 4: np.uint32}[bank_bytes]
    return torch.from_numpy(fused.pack_bytes(
        sid, banks, dtype, lanes)).to(dev), kw


def narrow_wire_of(cols, mode: str, lanes: int, num_banks: int, dev):
    """(wire tensor, width, whether the deltas' frame-wide sum wraps past
    2^32) of a decoded frame on the seg or delta wire (numpy pack, banks
    = day - 20260701), padded to ``lanes``, with a ``num_banks`` header;
    the width is the frame's own, as the pipeline picks it."""
    from attendance_tpu_torch.models import fused

    sid = np.asarray(cols["student_id"], np.uint32)
    banks = (np.asarray(cols["lecture_day"]) - 20_260_701).astype(np.int32)
    if mode == "seg":
        width = max(int(sid.max()).bit_length() if len(sid) else 0, 1)
        buf, _ = fused.pack_seg(sid, banks, width, lanes, num_banks)
        wraps = False
    else:
        scan = fused.delta_scan(sid, banks, num_banks)
        width = fused.pick_delta_width(1, scan[4])
        buf, _ = fused.pack_delta(sid, banks, width, lanes, num_banks,
                                  scan=scan)
        wraps = int(scan[3].astype(np.int64).sum()) >= 1 << 32
    return torch.from_numpy(buf.view(np.int32)).to(dev), width, wraps


def narrow_step_check(start, wire, params, mode: str, width: int,
                      lanes: int, num_banks: int, what: str,
                      timed: bool = True):
    """K2-seg or K2-delta from the state ``start`` (left as it is) against
    its plain version on the same inputs: equal valid on every lane
    (padding included), registers and counters; when ``timed``, then
    timed by graph replays and the end state held again: the registers
    equal one plain step (a register max is idempotent) and the counters
    took one frame's counts per launch that ran. Returns (kernel ms,
    plain ms, register max abs err); the times are None when not
    ``timed``."""
    from attendance_tpu_torch.models import fused
    from attendance_tpu_torch.ops import kernels

    step = kernels.fused_step_seg if mode == "seg" else \
        kernels.fused_step_delta
    plain = kernels.fused_step_seg_plain if mode == "seg" else \
        kernels.fused_step_delta_plain
    width_name = "kb" if mode == "seg" else "db"
    a = fused.SketchState(*(t.clone() for t in start))
    b = fused.SketchState(*(t.clone() for t in start))
    valid = step(*a, wire, params, padded=lanes, num_banks=num_banks,
                 **{width_name: width})
    want = plain(*b, wire, params, width, lanes, num_banks, 14)
    torch.cuda.synchronize()
    check(torch.equal(valid, want), f"K2-{mode} {what}: valid")
    err = int((a.hll_regs.to(torch.int32)
               - b.hll_regs.to(torch.int32)).abs().max())
    check(err == 0, f"K2-{mode} {what}: register max abs err {err}")
    check(torch.equal(a.counts, b.counts), f"K2-{mode} {what}: counts")
    if not timed:
        return None, None, err
    ms = kernel_ms(lambda: step(*a, wire, params, padded=lanes,
                                num_banks=num_banks, **{width_name: width}))
    torch.cuda.synchronize()
    check(torch.equal(a.hll_regs, b.hll_regs),
          f"K2-{mode} {what}: registers after the graph replays")
    runs = 1 + graph_runs()
    s_v, s_i = fused.decode_counts(start.counts)
    p_v, p_i = fused.decode_counts(b.counts)
    check(fused.decode_counts(a.counts)
          == (s_v + runs * (p_v - s_v), s_i + runs * (p_i - s_i)),
          f"K2-{mode} {what}: counters after {runs} launches")
    plain_ms = eager_ms(lambda: plain(*b, wire, params, width, lanes,
                                      num_banks, 14))
    return ms, plain_ms, err


def decode_yardstick(wire, mode: str, width: int, lanes: int,
                     num_banks: int) -> str:
    """The decode half's library yardstick (not K2's function, so not its
    library time; the port never calls these): ``torch.searchsorted`` of
    the lanes in the counts' cumsum and, on the delta wire,
    ``torch.cumsum`` of the frame's decoded deltas (int64, as the plain
    version takes them), each timed by graph replays."""
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.ops.murmur3 import as_u32

    u = as_u32(wire)
    base = num_banks if mode == "seg" else 2 * num_banks
    deltas, lane = kernels._stream_lanes(u, base, width, lanes)
    ends = torch.cumsum(u[:num_banks], 0)
    out = {"searchsorted_ms": kernel_ms(
        lambda: torch.searchsorted(ends, lane, right=True))}
    if mode == "delta":
        out["cumsum_ms"] = kernel_ms(lambda: torch.cumsum(deltas, 0))
    return " ".join(f"{k}={v}" for k, v in out.items())


def run_with_native(native: bool, config, num_events: int, frame_size: int,
                    num_lectures: int, client=None):
    """``run_fused`` on the card at seed 0, with the native host pack or,
    with ``native`` False, the numpy pack (``ATP_NATIVE=0`` while the
    pipeline is built, as a user would set it), on ``client`` or a fresh
    broker's."""
    import os

    from attendance_tpu_torch.cli import run_fused
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    before = os.environ.get("ATP_NATIVE")
    if not native:
        os.environ["ATP_NATIVE"] = "0"
    try:
        return run_fused(config, num_events, frame_size, num_lectures,
                         seed=0, client=client or MemoryClient(MemoryBroker()))
    finally:
        if before is None:
            os.environ.pop("ATP_NATIVE", None)
        else:
            os.environ["ATP_NATIVE"] = before


def drive(config, roster, frames, num_events: int):
    """One run through the entry points a user calls, on the card."""
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()))
    pipe.preload(roster)
    producer = pipe.client.create_producer(config.pulsar_topic)
    for f in frames:
        producer.send(f)
    pipe.run(max_events=num_events, idle_timeout_s=1.0)
    return pipe


# The JSON metrics line's keys, in order: the JAX package's
# ``ProcessorMetrics.to_dict``.
METRICS_LINE_KEYS = (
    "events", "batches", "events_per_second", "mean_batch",
    "device_seconds", "wall_seconds", "valid_events", "invalid_events",
    "nacked_batches", "dead_lettered", "estimated_fpr", "fpr_is_lower_bound",
    "wire_dwell", "snapshots", "snapshot_write_s", "snapshot_blocked_s")


def metrics_line_phase(card: str, num_events: int, frame_size: int,
                       num_lectures: int, ref) -> dict:
    """Phase 3c: a default run with ``metrics_json`` set in a fresh
    directory; the line it appends is printed and held, the run's state
    is held equal to ``ref`` (phase 3's default run). Returns the run's
    launch counts."""
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels

    with tempfile.TemporaryDirectory(prefix="chip_smoke_metrics_") as work:
        path = Path(work) / "metrics.jsonl"
        kernels.reset_launches()
        pipe, summary = run_with_native(
            True, Config(metrics_json=str(path)), num_events, frame_size,
            num_lectures)
        run_launches = dict(kernels.launches)
        try:
            regs = pipe.state.hll_regs.clone()
            stored = pipe.store.to_columns(deduplicate=False)["is_valid"]
            wire_dwell = dict(pipe.metrics.wire_dwell)
        finally:
            pipe.cleanup()
        lines = path.read_text().splitlines()
    check(len(lines) == 1, f"3c: {len(lines)} metrics lines, not 1")
    line = json.loads(lines[0]) if lines else {}
    print(f"metrics line (3c): {json.dumps(line)}")
    frames = num_events // frame_size
    check(tuple(line) == METRICS_LINE_KEYS,
          f"3c: keys {list(line)} are not the JAX package's")
    check(line.get("events") == num_events and line.get("batches") == frames,
          f"3c: events {line.get('events')} batches {line.get('batches')}")
    check(line.get("wire_dwell") == wire_dwell
          and sum(wire_dwell.values()) == frames,
          f"3c: wire_dwell {line.get('wire_dwell')} vs the run's "
          f"{wire_dwell}")
    check(line.get("fpr_is_lower_bound") is True
          and line.get("estimated_fpr") is None,
          "3c: the FPR fields are not JAX's deferred pair")
    rate = line.get("events_per_second")
    check(isinstance(rate, float) and rate > 0, f"3c: rate {rate}")
    check(line.get("mean_batch") == round(num_events / frames, 1),
          f"3c: mean_batch {line.get('mean_batch')}")
    got = ((summary["valid"], summary["invalid"]),
           summary["unique_attendees"], regs, stored)
    check(got[:2] == ref[:2] and torch.equal(got[2], ref[2])
          and np.array_equal(got[3], ref[3]),
          "3c: the run differs from phase 3's default run")
    step_kernels = {STEP_OF_WIRE[w] for w in wire_dwell}
    steps = sum(run_launches[k] for k in step_kernels)
    check(steps == frames, f"3c: {steps} step launches for {frames} frames")
    check(run_launches["bloom_add"] == 1
          and run_launches["hll_histogram"] == 1,
          f"3c: K3 {run_launches['bloom_add']} K1 "
          f"{run_launches['hll_histogram']}, not one each")
    others = {k: n for k, n in run_launches.items() if n and k not in
              step_kernels | {"bloom_add", "hll_histogram"}}
    check(not others, f"3c: launches beyond one default run's: {others}")
    print(f"metrics line (3c) run: {summary['events_per_second']} events/s "
          f"(wall {summary['wall_seconds']} s) on {card}; equal to phase "
          f"3's default run; launches {run_launches}")
    return run_launches


def pfcount_timing(card: str, what: str, cases, reps: int) -> None:
    """Host wall per call of a PFCOUNT entry point, and apart its three
    steps on the same registers: the K1 launch (host enqueue; and
    ``k1_events``, CUDA events recorded around it, a span that holds the
    enqueue too, as the card is idle: K1's device time is phase 2b's),
    the D2H copy (``.cpu()``, which waits for K1) and the host Ertl
    estimator over the call's banks. ``cases`` holds (call, registers it
    histograms, rows it estimates); each runs ``reps`` times from an idle
    card. Prints median and max in ms."""
    from attendance_tpu_torch.models.hll import estimate_from_histogram
    from attendance_tpu_torch.ops import kernels

    samples = {k: [] for k in ("wall", "launch", "k1_events", "d2h",
                               "estimator")}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for call, regs, banks in cases:
        call()  # warm
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            samples["wall"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            start.record()
            hist = kernels.hll_histogram(regs, 14)
            end.record()
            t1 = time.perf_counter()
            host = hist.cpu().numpy()
            t2 = time.perf_counter()
            for b in banks:
                estimate_from_histogram(host[b], 14)
            t3 = time.perf_counter()
            samples["launch"].append(t1 - t0)
            samples["d2h"].append(t2 - t1)
            samples["estimator"].append(t3 - t2)
            samples["k1_events"].append(start.elapsed_time(end) / 1e3)
    stats = " ".join(f"{k}_ms median {float(np.median(v)) * 1e3} max "
                     f"{max(v) * 1e3};" for k, v in samples.items())
    print(f"PFCOUNT {what}: {len(cases)} case(s) x {reps} calls, "
          f"{len(cases[0][2])} estimate(s) from {cases[0][1].shape[0]} "
          f"bank(s) per call: {stats} on {card}")


K1_BANKS = (1, 16, 256, 512, 1024)


def histogram_phase(dev, floor_ms: float, live: torch.Tensor,
                    rows: dict) -> None:
    """Phase 2b: K1 at every bank count the PFCOUNT path launches it at,
    on two register fills: "uniform" (2^20 uniform keys over the banks)
    and "main" (the main path's live rows after phase 3, repeated to the
    bank count), held equal to the plain version and to
    ``torch.bincount``, and timed beside its bound."""
    from attendance_tpu_torch.models import hll
    from attendance_tpu_torch.ops import kernels

    rng = np.random.default_rng(5)
    for fill in ("uniform", "main"):
        for num_banks in K1_BANKS:
            if fill == "main":
                regs = live[torch.arange(num_banks, device=dev)
                            % live.shape[0]].contiguous()
            else:
                regs = hll.hll_init(num_banks, 14, dev)
                n = 1 << 20
                hll.hll_add(regs, torch.from_numpy(rng.integers(
                    0, num_banks, n, dtype=np.int32)).to(dev),
                    torch.from_numpy(rng.integers(0, 1 << 32, n,
                                                  dtype=np.uint64)
                                     .astype(np.uint32).view(np.int32))
                    .to(dev), precision=14)
            got = kernels.hll_histogram(regs, 14)
            want = hll.hll_histogram(regs, 14)
            torch.cuda.synchronize()
            err = int((got - want).abs().max())
            check(err == 0, f"K1 fill={fill} banks={num_banks}: max abs err "
                  f"{err}")
            check(bool(got.sum(dim=1).eq(16384).all()), "K1 rows != 2^14")
            bins = got.shape[1]
            offsets = (regs.to(torch.int64)
                       + torch.arange(num_banks, device=dev)[:, None] * bins
                       ).view(-1)
            lib = torch.bincount(offsets, minlength=num_banks * bins)
            check(torch.equal(lib.view(num_banks, bins).to(torch.int32), got),
                  f"K1 fill={fill} banks={num_banks} disagrees with "
                  "torch.bincount")
            ms = kernel_ms(lambda: kernels.hll_histogram(regs, 14))
            plain_ms = eager_ms(lambda: hll.hll_histogram(regs, 14))
            library_ms = eager_ms(lambda: torch.bincount(
                offsets, minlength=num_banks * bins), 20)
            b_ms, b_by = bound_ms(regs.numel() + got.numel() * 4,
                                  regs.numel())
            share = got.sum(dim=0).double() / regs.numel()
            top = torch.topk(share, 3)
            print(f"K1 hll_histogram fill={fill} banks={num_banks} ms={ms} "
                  f"above_floor_ms={ms - floor_ms} plain_ms={plain_ms} "
                  f"bincount_ms={library_ms} bound_ms={b_ms} ({b_by}) "
                  f"times_bound={ms / b_ms} max_abs_err={err} top values "
                  f"{top.indices.tolist()} shares {top.values.tolist()}")
            if fill == "main" and num_banks == 16:
                rows["hll_histogram"] = dict(
                    replaces="attendance_tpu/ops/pallas_kernels.py:398",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=library_ms)


def temporal_path(card: str, num_events: int, frame_size: int,
                  num_lectures: int, rows: dict) -> dict:
    """Phase 3b; returns the run's launch counts and its core state
    (counters, registers, bank map, stored rows: phase 16(a2)'s
    reference)."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models import cms
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.events import decode_planar_batch
    from attendance_tpu_torch.temporal.buckets import (
        bucket_keys, is_bucket_key)

    roster, hot, frames = temporal_frames(num_events, frame_size,
                                          num_lectures)
    config = Config(temporal_period_s=60, allowed_lateness_s=5.0,
                    temporal_ring_banks=256, cms_depth=4, cms_width=16384,
                    cms_topk=16, audit_sample=1.0)
    kernels.reset_launches()
    pipe = drive(config, roster, frames, num_events)
    windows = pipe.window_counts()
    days = pipe.count_all()
    stats = pipe.temporal_stats()
    launches = dict(kernels.launches)
    for name in ("hll_histogram", "bloom_contains", "hll_add", "cms_step",
                 "fused_step", "bloom_add"):
        check(launches[name] > 0, f"kernel {name} not launched on the "
              "temporal path")
    try:
        m = pipe.metrics
        valid_n, invalid_n = pipe.validity_counts()
        stored_cols = pipe.store.to_columns(deduplicate=False)
        stored = stored_cols["is_valid"]
        # The core state phase 16(a2) is held to: counters, the day
        # banks' registers, stored rows.
        core = dict(counts=(valid_n, invalid_n),
                    regs=pipe.state.hll_regs.clone(),
                    bank_of=dict(pipe._bank_of),
                    rows=_sorted_rows(stored_cols))
        shadow = pipe._temporal.shadow_truth()
        cms_counts = pipe._temporal.cms_counts.clone()
        num_banks = pipe.state.hll_regs.shape[0]
        pfcount_timing(card, "window_counts()", [
            (pipe.window_counts, pipe._live_regs(),
             [b for k, b in pipe._bank_of.items() if is_bucket_key(k)])],
            reps=10)
    finally:
        pipe.cleanup()
        # audit_sample 1.0 (the window oracle) turned the process's
        # telemetry and its auditor on: the runs below are bare.
        obs.disable()

    cols = [decode_planar_batch(f) for f in frames]
    sid = np.concatenate([c["student_id"] for c in cols])
    day = np.concatenate([c["lecture_day"] for c in cols])
    micros = np.concatenate([c["micros"] for c in cols])
    truth = np.isin(sid, roster)
    check(valid_n + invalid_n == num_events, "temporal: valid + invalid")
    check(int((truth & ~stored).sum()) == 0, "temporal: false negatives")
    fpr = float((stored & ~truth).sum() / (~truth).sum())
    check(fpr <= 0.015, f"temporal: measured FPR {fpr}")
    worst_day = max(abs(est - len(np.unique(sid[(day == d) & truth])))
                    / len(np.unique(sid[(day == d) & truth]))
                    for d, est in days.items())
    check(len(days) == num_lectures and worst_day <= 0.03,
          f"temporal: day PFCOUNT error {worst_day}")
    # Exact unique valid students per (day, 60 s period) bucket.
    keys = bucket_keys(day[truth].astype(np.int64),
                       micros[truth] // np.int64(60_000_000))
    pairs = np.unique(np.stack([keys, sid[truth].astype(np.int64)]), axis=1)
    uk, n_exact = np.unique(pairs[0], return_counts=True)
    exact = dict(zip(uk.tolist(), n_exact.tolist()))
    check(shadow == exact, "temporal: the exact shadow disagrees with the "
          "frames")
    check(stats["late_dropped"] == 0, f"late_dropped {stats['late_dropped']}")
    check(stats["evictions"] > 0, "temporal: no ring eviction")
    check(stats["events"] == num_events and stats["reorder_buffered"] == 0,
          "temporal: events not all released")
    check(num_banks == 512, f"temporal: {num_banks} register banks")
    check(bool(windows) and set(windows) <= set(exact),
          "temporal: a window with no events")
    worst_window = max(abs(est - exact[k]) / exact[k]
                       for k, est in windows.items())
    check(worst_window <= 0.03, f"temporal: window error {worst_window}")

    def rank(key):
        return ((key >> 28) & ((1 << 34) - 1), key & ((1 << 28) - 1))

    evicted = set(exact) - set(windows)
    check(not evicted or max(map(rank, evicted))
          < min(map(rank, windows)),
          "temporal: a window false negative (a bucket newer than a "
          "retained one is missing)")
    plain = cms.cms_init(4, 16384, cms_counts.device)
    cms.cms_update(plain, torch.from_numpy(sid.view(np.int32)).to(
        cms_counts.device))
    check(torch.equal(cms_counts, plain),
          "temporal: CMS counts differ from the plain update")
    top = {k for k, _ in stats["topk"]}
    check(set(hot.tolist()) <= top, "temporal: a hot key is not in the "
          "top-K")
    print(f"temporal path: {m.events_per_second} events/s with the plane "
          f"on ({m.events} events, {m.batches} frames, wall "
          f"{m.wall_seconds} s) on {card}; buckets {stats['buckets']} "
          f"evictions {stats['evictions']} rotations {stats['rotations']} "
          f"late_folded {stats['late_folded']} late_dropped "
          f"{stats['late_dropped']} windows {len(windows)} of "
          f"{len(exact)} exact, worst window err {worst_window}, worst "
          f"day err {worst_day}, fpr {fpr}, banks {num_banks}, launches "
          f"{launches}")
    print(f"temporal path host stages (s): {m.stage_seconds}")
    device_ms = sum(launches[k] * rows[k]["ms"] for k in launches
                    if launches[k])
    print(f"temporal path device share: {device_ms} ms of kernel time "
          f"(launches x the phase-2 times) in {m.wall_seconds * 1e3} ms "
          f"of run() wall")
    off = drive(Config(), roster, frames, num_events)
    print(f"temporal path frames with the plane off, same process: "
          f"{off.metrics.events_per_second} events/s (wall "
          f"{off.metrics.wall_seconds} s) on {card}; host stages (s): "
          f"{off.metrics.stage_seconds}")
    off.cleanup()
    # The plane on without the exact shadow (audit_sample=0): what the
    # plane's host passes cost apart from the audit oracle.
    lean = drive(dataclasses.replace(config, audit_sample=0.0), roster,
                 frames, num_events)
    check(lean.window_counts() == windows,
          "temporal: the windows depend on the shadow")
    print(f"temporal path without the exact shadow, same process: "
          f"{lean.metrics.events_per_second} events/s (wall "
          f"{lean.metrics.wall_seconds} s) on {card}; host stages (s): "
          f"{lean.metrics.stage_seconds}")
    lean.cleanup()
    return launches, core


def _pipe_state(pipe):
    """(counters, PFCOUNTs, registers, bank map, deduped store) of a
    pipeline, for exact comparison."""
    return (pipe.validity_counts(),
            {str(d): n for d, n in sorted(pipe.count_all().items())},
            pipe.state.hll_regs.clone(), dict(pipe._bank_of),
            pipe.store.to_columns())


def _sorted_rows(cols) -> dict:
    """A store's rows (student, day, micros, validity) in one canonical
    order: stored validity compared as rows, not as block order."""
    cols = {k: np.asarray(cols[k]) for k in
            ("student_id", "lecture_day", "micros", "is_valid")}
    order = np.lexsort((cols["student_id"], cols["micros"],
                        cols["lecture_day"]))
    return {k: v[order] for k, v in cols.items()}


def _check_same(what: str, got, want, store: bool = True) -> None:
    check(got[0] == want[0], f"{what}: counters {got[0]} != {want[0]}")
    check(got[1] == want[1], f"{what}: PFCOUNTs differ")
    check(torch.equal(got[2], want[2]), f"{what}: registers differ")
    check(got[3] == want[3], f"{what}: bank map differs")
    if store:
        for name in ("student_id", "lecture_day", "micros", "is_valid"):
            check(np.array_equal(got[4][name], want[4][name]),
                  f"{what}: deduped store column {name} differs")


def _capture_d2h_ms(side, regs, counts, reps: int = 20) -> float:
    """Median device ms of one capture's D2H as the writer makes it: a
    non-blocking copy into a pinned staging buffer on a side stream,
    waited for by its event."""
    n = regs.numel()
    slot = torch.empty(n + 16, dtype=torch.uint8, pin_memory=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        for _ in range(reps + 1):
            start.record(side)
            slot[:n].view(regs.shape).copy_(regs, non_blocking=True)
            slot[n:n + 16].view(torch.int32).copy_(counts.view(-1),
                                                   non_blocking=True)
            end.record(side)
            end.synchronize()
            times.append(start.elapsed_time(end))
    check(np.array_equal(slot[:n].numpy().reshape(tuple(regs.shape)),
                         regs.cpu().numpy()), "capture D2H: bytes differ")
    return float(np.median(times[1:]))


def checkpoint_phase(card: str, num_events: int, frame_size: int,
                     num_lectures: int, ref) -> None:
    """Phase 5: checkpoint and restore on the card. Prints the launch
    counts of its runs (first runs, the crash pair and the temporal run,
    summed) on a line of its own; the ``kernels`` line leaves them out."""
    import json as _json
    import shutil
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch.cli import run_fused
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models import fused
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import (
        CHAIN_MANIFEST, SKETCH_SNAPSHOT, FusedPipeline)
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    launches = dict.fromkeys(kernels.launches, 0)

    def counted(what, names, fn):
        kernels.reset_launches()
        out = fn()
        got = dict(kernels.launches)
        for name in names:
            check(got[name] > 0, f"{what}: kernel {name} not launched")
        for name, count in got.items():
            launches[name] += count
        return out, got

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_snap_"))
    try:
        # (a), (b), (e): the fused default run with checkpointing off, in
        # delta mode and in barrier mode, first and second run each. A
        # barrier every frame and a compaction every 2 deltas: a busy
        # writer coalesces deferred barriers, but every run makes a base
        # (frame 1), a delta (frame 2) and at least one more delta.
        uninterrupted = None
        captures = {}
        for label in ("off", "delta", "barrier"):
            for run in ("first", "second"):
                snap = work / f"{label}-{run}"
                config = Config() if label == "off" else Config(
                    snapshot_dir=str(snap), snapshot_mode=label,
                    snapshot_every_batches=1, snapshot_compact_every=2)
                what = f"checkpoint {label} run={run}"
                (pipe, summary), got = counted(
                    what, ("bloom_add", "fused_step", "hll_histogram"),
                    lambda: run_fused(config, num_events, frame_size,
                                      num_lectures, seed=0))
                if run == "second":
                    for name, count in got.items():
                        launches[name] -= count
                try:
                    m = pipe.metrics
                    state = _pipe_state(pipe)
                    check(pipe.consumer.backlog() == 0,
                          f"{what}: frames left unacked")
                    check(state[0] == ref[0] and state[1] == ref[1]
                          and torch.equal(state[2], ref[2]),
                          f"{what}: differs from the main path's run")
                    check(np.array_equal(pipe.store.to_columns(
                        deduplicate=False)["is_valid"], ref[3]),
                        f"{what}: stored validity differs")
                    if uninterrupted is None:
                        uninterrupted = state
                    if label != "off" and run == "first":
                        chain = _json.loads((snap / CHAIN_MANIFEST)
                                            .read_text())
                        if label == "delta":
                            check(pipe._delta_seq >= 2
                                  and len(chain["deltas"]) < 2,
                                  f"{what}: no compaction ({chain})")
                        captures[label] = len(m.snapshot_stalls)
                        back = FusedPipeline(config)
                        try:
                            _check_same(f"{what}: restore", _pipe_state(back),
                                        state)
                            check(back._events_restored == num_events,
                                  f"{what}: restored events")
                        finally:
                            back.cleanup()
                finally:
                    pipe.cleanup()
                stalls = m.snapshot_stalls
                print(f"{what}: {m.events_per_second} events/s (wall "
                      f"{m.wall_seconds} s) on {card}; snapshots "
                      f"{len(stalls)} snapshot_write_s {sum(stalls)} max "
                      f"{max(stalls, default=0.0)} snapshot_blocked_s "
                      f"{m.snapshot_blocked_s}; host stages (s): "
                      f"{m.stage_seconds}")

        # (c) crash resume: a delta-mode run of 60% of the stream whose
        # disk dies after the first base (a power cut at the second
        # manifest rename: that write and every later one fail), then
        # consumer.close() and a successor on the same broker and
        # directory drains the rest.
        roster, frames = generate_frames(
            num_events, frame_size,
            roster_size=min(Config().bloom_filter_capacity, num_events),
            num_lectures=num_lectures, seed=0)
        snap = work / "crash"
        config = Config(snapshot_dir=str(snap), snapshot_mode="delta",
                        snapshot_every_batches=1)
        broker = MemoryBroker()
        a = FusedPipeline(config, client=MemoryClient(broker))
        cut = {"n": 0}
        manifest = a._write_chain_manifest

        def cut_manifest():
            cut["n"] += 1
            if cut["n"] >= 2:
                raise OSError("simulated power cut before manifest rename")
            manifest()

        def dead_after_cut(fn):
            def wrapper(*args, **kwargs):
                if cut["n"] >= 2:
                    raise OSError("simulated power cut")
                return fn(*args, **kwargs)
            return wrapper

        a._write_chain_manifest = cut_manifest
        a._write_snapshot_files = dead_after_cut(a._write_snapshot_files)
        a._write_delta_files = dead_after_cut(a._write_delta_files)

        def crash_run():
            a.preload(roster)
            producer = a.client.create_producer(config.pulsar_topic)
            for f in frames:
                producer.send(f)
            a.run(max_events=int(num_events * 0.6), idle_timeout_s=1.0)

        counted("crash run", ("bloom_add", "fused_step"), crash_run)
        processed = a.metrics.events
        a.consumer.close()
        a.cleanup()
        with np.load(snap / SKETCH_SNAPSHOT) as d:
            events_at = _json.loads(bytes(d["manifest"]).decode())["events"]
        check(events_at < processed, f"crash: nothing left unacked "
              f"({events_at} of {processed})")

        def resume():
            b = FusedPipeline(config, client=MemoryClient(broker))
            check(sum(b.validity_counts()) == b._events_restored
                  == events_at, "crash: restored counters are not the "
                  "acked prefix's")
            b.run(idle_timeout_s=1.0)
            return b

        b, _ = counted("crash resume", ("fused_step",), resume)
        try:
            check(b.consumer.backlog() == 0, "crash: frames left unacked")
            _check_same("crash resume", _pipe_state(b), uninterrupted)
        finally:
            b.cleanup()
        print(f"checkpoint crash resume: {processed} events processed, "
              f"{events_at} acked before the power cut, "
              f"{num_events - events_at} replayed or new after restore; "
              f"counters, PFCOUNTs, registers, bank map and deduped store "
              f"equal the uninterrupted run on {card}")

        # (d) the temporal path with delta snapshots: a restore gives the
        # same windows and ring.
        t_roster, _, t_frames = temporal_frames(num_events, frame_size,
                                                num_lectures)
        snap = work / "temporal"
        config = Config(temporal_period_s=60, allowed_lateness_s=5.0,
                        temporal_ring_banks=256, cms_depth=4,
                        cms_width=16384, cms_topk=16,
                        snapshot_dir=str(snap), snapshot_mode="delta",
                        snapshot_every_batches=1)
        pipe, _ = counted(
            "checkpoint temporal",
            ("fused_step", "bloom_contains", "hll_add", "cms_step"),
            lambda: drive(config, t_roster, t_frames, num_events))
        try:
            windows = pipe.window_counts()
            state = _pipe_state(pipe)
            buckets = dict(pipe._temporal.ring.buckets)
            evictions = pipe.temporal_stats()["evictions"]
            back = FusedPipeline(config)
            try:
                _check_same("checkpoint temporal: restore",
                            _pipe_state(back), state)
                check(back.window_counts() == windows and windows,
                      "checkpoint temporal: window_counts differ")
                check(back._temporal.ring.buckets == buckets,
                      "checkpoint temporal: ring buckets differ")
                check(back._free_banks == pipe._free_banks,
                      "checkpoint temporal: free list differs")
            finally:
                back.cleanup()
        finally:
            pipe.cleanup()
        check(evictions > 0, "checkpoint temporal: no eviction")
        print(f"checkpoint temporal: {len(windows)} windows, {len(buckets)} "
              f"live buckets, {evictions} evictions; restore equal in "
              f"windows, ring, registers, counters and store on {card}")

        # (e) B9 on the card: the delta capture of the default run's 16
        # dirty banks (padded to 16) and the barrier-mode base copy of
        # 256 banks, timed by graph replays beside their bound in bytes,
        # and the D2H of one capture.
        regs = ref[2].clone()
        counts = torch.zeros((2, 2), dtype=torch.int32, device=regs.device)
        idx = torch.arange(16, dtype=torch.int64, device=regs.device)
        host = regs.cpu()
        got_rows, _ = fused.snapshot_capture_rows(regs, idx, counts)
        got_base, _ = fused.snapshot_capture_base(regs, counts)
        check(torch.equal(got_rows.cpu(), host[:16]) and torch.equal(
            got_base.cpu(), host), "B9: capture differs from a host copy")
        side = torch.cuda.Stream()
        row_bytes = regs.shape[1]
        for what, fn, nbytes, tensors in (
                ("capture rows=16", lambda: fused.snapshot_capture_rows(
                    regs, idx, counts), 2 * 16 * row_bytes + 16 * 8 + 32,
                 (got_rows,)),
                ("base copy banks=256", lambda: fused.snapshot_capture_base(
                    regs, counts), 2 * regs.numel() + 32, (got_base,))):
            ms = kernel_ms(fn)
            b_ms, b_by = bound_ms(nbytes, 0)
            d2h_ms = _capture_d2h_ms(side, tensors[0], counts)
            label = "delta" if what.startswith("capture") else "barrier"
            if label == "delta":
                # The same capture by index_select, timed beside the kept
                # advanced indexing.
                sel_ms = kernel_ms(lambda: (regs.index_select(0, idx),
                                            counts.clone()))
                print(f"B9 capture rows=16 by index_select: ms={sel_ms} "
                      f"on {card}")
            print(f"B9 {what}: ms={ms} bound_ms={b_ms} ({b_by}, {nbytes} "
                  f"bytes) times_bound={ms / b_ms} d2h_ms={d2h_ms} "
                  f"({tensors[0].numel() + 16} bytes into pinned memory "
                  f"on a side stream) captures_per_default_run="
                  f"{captures[label]} ({label} mode, a barrier every "
                  f"frame) on {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(f"checkpoint phase launches (first runs off/delta/barrier, the "
          f"crash run and its resume, the temporal run; not in the "
          f"kernels line): {launches}")


# Phase 6: the generic sketch store and the processor loop.
STORE_KERNELS = ("bloom_add_bytes", "bloom_contains_bytes",
                 "hll_histogram_rows", "hll_union_histogram", "hll_add")
PIPELINE_STUDENTS = 90_000  # the generator's whole id range [10000, 99999]


def sectors(pos: torch.Tensor) -> int:
    """Distinct 32-byte sectors of the byte positions ``pos``."""
    return int(torch.unique(pos.reshape(-1) >> 5).numel())


# K8's sizes in phase 6a: one key (a scalar BF.EXISTS), the processor's
# batch, and up to the 1M-id FPR probe of phase 6b.
K8_SIZES = (1, 8192, 32_768, 65_536, 131_072, 262_144, 1 << 20)
# K7's: one key (a scalar BF.ADD) up to the roster preload.
K7_SIZES = (1, 8192, 32_768, 65_536, 90_000)


def bytes_bloom_kernels(dev, floor_ms: float, rows: dict) -> None:
    """Phase 6a, K7 and K8 on the 100k-roster filter, flat and blocked:
    each path (direct, image) at every size of ``K7_SIZES`` /
    ``K8_SIZES``, held against its plain version (zero differing bytes
    or answers) and timed beside its bound, the launch floor and, for
    K7, ``index_fill_``; and K8's pack pass alone."""
    from attendance_tpu_torch.models import bloom
    from attendance_tpu_torch.ops import kernels

    print(f"K7/K8 plan: K8 image path from {kernels.K8_IMAGE_MIN_KEYS} "
          f"keys, K7 image path from {kernels.K7_IMAGE_MIN_KEYS} keys (at "
          f"most {kernels.K7_IMAGE_PARTS} partial images); images up to "
          f"{kernels.BYTES_IMAGE_MAX_BYTES} bytes")
    rng = np.random.default_rng(6)
    roster = torch.from_numpy(rng.permutation(np.arange(
        10_000, 100_000, dtype=np.int32))).to(dev)  # 90,000 keys
    n = roster.shape[0]
    # Ids already enrolled before the preload: an add keeps them.
    enrolled = torch.arange(201_000, 221_000, dtype=torch.int32, device=dev)
    for layout in ("flat", "blocked"):
        params = bloom.derive_bloom_params(100_000, 0.01, layout)
        hashes = 2 if layout == "flat" else 3
        start = bloom.bloom_init(params, dev)
        bloom.bloom_add_plain(start, enrolled, params)
        full = start.clone()
        bloom.bloom_add_plain(full, roster, params)
        for n7 in K7_SIZES:
            keys = roster[:n7]
            want = start.clone()
            bloom.bloom_add_plain(want, keys, params)
            mask = torch.rand(n7, device=dev) < 0.7
            masked = start.clone()
            bloom.bloom_add_plain(masked, keys, params, mask)
            pos = bloom.bloom_positions(keys, params)
            b_ms, b_by = bound_ms(4 * n7 + 32 * sectors(pos),
                                  n7 * (20 * hashes + 8 * params.k))
            picked = kernels.bloom_bytes_plan(
                n7, params.m_bits, layout, add=True).image
            for image in (False, True):
                got = start.clone()
                kernels.bloom_add_bytes(got, keys, params, image=image)
                got_m = start.clone()
                kernels.bloom_add_bytes(got_m, keys, params, mask,
                                        image=image)
                torch.cuda.synchronize()
                err = int((got != want).sum()) + int((got_m != masked).sum())
                check(err == 0, f"K7 {layout} keys={n7} image={image}: "
                      f"{err} bytes differ")
                # Replays store the same bytes again: the same work.
                ms = kernel_ms(lambda: kernels.bloom_add_bytes(
                    got, keys, params, image=image))
                check(torch.equal(got, want),
                      f"K7 {layout} keys={n7} image={image}: replays")
                line = (f"K7 bloom_add_bytes {layout} keys={n7} "
                        f"path={'image' if image else 'direct'} "
                        f"picked_by_plan={image == picked} ms={ms} "
                        f"above_floor_ms={ms - floor_ms} bound_ms={b_ms} "
                        f"({b_by}) times_bound={ms / b_ms} max_abs_err={err}")
                if n7 == n and image == picked:
                    plain_ms = eager_ms(lambda: bloom.bloom_add_plain(
                        want, keys, params), 3)
                    flat_pos = pos.reshape(-1)
                    lib = want.clone()
                    lib_ms = eager_ms(lambda: lib.index_fill_(0, flat_pos, 1),
                                      20)
                    check(torch.equal(lib, want),
                          f"K7 {layout} != index_fill_")
                    line += (f" plain_ms={plain_ms} index_fill_ms={lib_ms} "
                             f"(positions given)")
                    if layout == "flat":
                        rows["bloom_add_bytes"] = dict(
                            replaces="attendance_tpu/models/bloom.py:143",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
                print(line)
        if layout == "flat":
            # B13c: the fill behind estimated_fpr, one count_nonzero.
            fill = float(bloom.bloom_fill_fraction(full))
            check(fill == float((full != 0).double().mean()),
                  f"fill fraction {fill}")
            fill_ms = kernel_ms(lambda: bloom.bloom_fill_fraction(full))
            f_ms, f_by = bound_ms(params.m_bits + 8, params.m_bits)
            print(f"B13c bloom_fill_fraction (count_nonzero) bytes="
                  f"{params.m_bits} ms={fill_ms} above_floor_ms="
                  f"{fill_ms - floor_ms} bound_ms={f_ms} ({f_by}) fill={fill}")

        bits = full
        for n8 in K8_SIZES:
            # A processor batch's mix: 93% roster ids, 7% invalid ids.
            members = roster[torch.randint(0, n, (n8,), device=dev)]
            others = torch.randint(100_000, 1_000_000, (n8,), device=dev,
                                   dtype=torch.int32)
            probe = torch.where(torch.rand(n8, device=dev) < 0.93, members,
                                others)
            want = bloom.bloom_contains_plain(bits, probe, params)
            # The probes the answer needs: up to a key's first unset byte.
            pos8 = bloom.bloom_positions(probe, params)
            hit = bits[pos8] == 1
            needed = torch.ones_like(hit)
            needed[:, 1:] = torch.cumprod(hit[:, :-1].int(), dim=1).bool()
            b_ms, b_by = bound_ms(5 * n8 + 32 * sectors(pos8[needed]),
                                  n8 * (20 * hashes + 8 * params.k))
            picked = kernels.bloom_bytes_plan(n8, params.m_bits,
                                              layout).image
            for image in (False, True):
                got = kernels.bloom_contains_bytes(bits, probe, params,
                                                   image=image)
                torch.cuda.synchronize()
                err = int((got != want).sum())
                check(err == 0, f"K8 {layout} keys={n8} image={image}: "
                      f"{err} answers differ")
                ms = kernel_ms(lambda: kernels.bloom_contains_bytes(
                    bits, probe, params, image=image))
                line = (f"K8 bloom_contains_bytes {layout} keys={n8} "
                        f"path={'image' if image else 'direct'} "
                        f"picked_by_plan={image == picked} ms={ms} "
                        f"above_floor_ms={ms - floor_ms} bound_ms={b_ms} "
                        f"({b_by}) times_bound={ms / b_ms} "
                        f"hits={int(got.sum())} max_abs_err={err}")
                if n8 in (8192, 1 << 20) and image == picked:
                    plain_ms = eager_ms(lambda: bloom.bloom_contains_plain(
                        bits, probe, params), 5)
                    line += f" plain_ms={plain_ms}"
                    if layout == "flat" and n8 == 8192:
                        rows["bloom_contains_bytes"] = dict(
                            replaces="attendance_tpu/models/bloom.py:158",
                            max_abs_err=err, ms=ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by, library_ms=None)
                print(line)
        # The pack pass alone, against its plain version.
        words = kernels.bloom_pack_bytes(bits)
        torch.cuda.synchronize()
        check(torch.equal(words, bloom.pack_bloom_bits(bits)),
              f"K8 {layout}: the pack pass differs from pack_bloom_bits")
        p_ms = kernel_ms(lambda: kernels.bloom_pack_bytes(bits))
        pb_ms, pb_by = bound_ms(params.m_bits * 33 // 32, params.m_bits)
        print(f"K8 pack pass alone {layout} bytes={params.m_bits} ms={p_ms} "
              f"bound_ms={pb_ms} ({pb_by})")


def store_kernels(dev, floor_ms: float, rows: dict, regs: torch.Tensor
                  ) -> None:
    """Phase 6a: K7 and K8 (``bytes_bloom_kernels``), then K1-rows and
    K1-union on ``regs`` (the 1024-key store), each held against its
    plain version and timed beside its bound, the launch floor and, where
    one exists, the PyTorch library call's time."""
    from attendance_tpu_torch.models import hll
    from attendance_tpu_torch.ops import kernels

    bytes_bloom_kernels(dev, floor_ms, rows)
    rng = np.random.default_rng(6)
    num_banks, m = regs.shape
    bins = 64 - 14 + 2
    # B14a: K5 at a processor PFADD's shape, the valid share of an
    # 8,192-event batch for one of its 7 lectures, into one bank.
    n5 = 1088
    keys5 = torch.from_numpy(rng.integers(10_000, 100_000, n5).astype(
        np.int32)).to(dev)
    bank5 = torch.full((n5,), 5, dtype=torch.int32, device=dev)
    a, b = regs.clone(), regs.clone()
    kernels.hll_add(a, bank5, keys5, None, 14)
    hll.hll_add_plain(b, bank5, keys5, None, 14)
    torch.cuda.synchronize()
    err = int((a.int() - b.int()).abs().max())
    check(err == 0, f"K5 PFADD shape: max abs err {err}")
    ms = kernel_ms(lambda: kernels.hll_add(a, bank5, keys5, None, 14))
    plain_ms = eager_ms(lambda: hll.hll_add_plain(b, bank5, keys5, None, 14))
    bucket, rank = hll.hll_bucket_rank(keys5, 14)
    flat_idx = 5 * m + bucket
    lib_regs = regs.clone().view(-1)
    lib_ms = eager_ms(lambda: lib_regs.scatter_reduce_(
        0, flat_idx, rank.to(torch.uint8), reduce="amax"), 20)
    check(torch.equal(lib_regs.view(num_banks, m), a),
          "K5 PFADD shape disagrees with scatter_reduce_(amax)")
    distinct = int(torch.unique(flat_idx).numel())
    b_ms, b_by = bound_ms(8 * n5 + 2 * distinct, n5 * (2 * 20 + 10))
    print(f"B14a K5 hll_add PFADD keys={n5} banks={num_banks} replayed "
          f"ms={ms} above_floor_ms={ms - floor_ms} plain_ms={plain_ms} "
          f"scatter_reduce_amax_uint8_ms={lib_ms} bound_ms={b_ms} ({b_by}) "
          f"max_abs_err={err}")
    # B14d: the bank array's growth by doubling, 512 -> 1,024 banks.
    half = regs[:512]
    grow_ms = kernel_ms(lambda: hll.hll_init(1024, 14, dev).__setitem__(
        slice(0, 512), half))
    g_ms, g_by = bound_ms(3 * 512 * m, 0)
    print(f"B14d bank growth 512 -> 1024 banks (zeros + slice copy) "
          f"ms={grow_ms} bound_ms={g_ms} ({g_by})")
    cases = {"1": [5], "16": list(range(16)),
             "16 unsorted repeated": rng.integers(0, 16, 16).tolist(),
             "1024": rng.permutation(num_banks).tolist(),
             "1024 repeated": rng.integers(0, num_banks, 1024).tolist()}
    for what, sel in cases.items():
        idx = torch.tensor(sel, dtype=torch.int32, device=dev)
        r = len(sel)
        got = kernels.hll_histogram_rows(regs, idx, 14)
        want = hll.hll_histogram_rows_plain(regs, idx, 14)
        offsets = (regs[idx.long()].to(torch.int64)
                   + torch.arange(r, device=dev)[:, None] * bins).view(-1)
        lib = torch.bincount(offsets, minlength=r * bins)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"K1-rows rows={what}: max abs err {err}")
        check(torch.equal(lib.view(r, bins).to(torch.int32), got),
              f"K1-rows rows={what} disagrees with torch.bincount")
        ms = kernel_ms(lambda: kernels.hll_histogram_rows(regs, idx, 14))
        plain_ms = eager_ms(lambda: hll.hll_histogram_rows_plain(
            regs, idx, 14))
        lib_ms = eager_ms(lambda: torch.bincount(
            offsets, minlength=r * bins), 20)
        b_ms, b_by = bound_ms(r * m + 4 * r + 4 * r * bins, r * m)
        print(f"K1-rows hll_histogram_rows rows={what} ms={ms} above_floor_"
              f"ms={ms - floor_ms} plain_ms={plain_ms} bincount_ms={lib_ms} "
              f"(offset rows given) bound_ms={b_ms} ({b_by}) times_bound="
              f"{ms / b_ms} max_abs_err={err}")
        if what == "1":  # count(key), the main path's PFCOUNT
            rows["hll_histogram_rows"] = dict(
                replaces="attendance_tpu/sketch/tpu_store.py:102",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)
    union_kernel(dev, floor_ms, rows, regs, rng)


def union_kernel(dev, floor_ms: float, rows: dict, regs: torch.Tensor,
                 rng) -> None:
    """K1-union at 2, 7, 32 and 1,024 rows of ``regs``: each held equal
    to its plain version (distinct rows; rows repeated and outside the
    bank range; a replayed CUDA graph) and to gather + amax + bincount,
    and timed beside its bound, the launch floor and that library call."""
    from attendance_tpu_torch.models import hll
    from attendance_tpu_torch.ops import kernels

    num_banks, m = regs.shape
    bins = 64 - 14 + 2
    for r in (2, 7, 32, 1024):
        idx = torch.from_numpy(rng.permutation(num_banks)[:r].astype(
            np.int32)).to(dev)
        odd = idx.clone()
        odd[: r // 2] = idx[r - r // 2:]
        odd[0], odd[-1] = -5, num_banks + 9
        want = hll.hll_union_histogram_plain(regs, idx, 14)
        want_odd = hll.hll_union_histogram_plain(regs, odd, 14)
        lib = torch.bincount(torch.amax(regs[idx.long()], 0).long(),
                             minlength=bins)
        plain_ms = eager_ms(lambda: hll.hll_union_histogram_plain(
            regs, idx, 14))
        lib_ms = eager_ms(lambda: torch.bincount(torch.amax(
            regs[idx.long()], 0).long(), minlength=bins), 20)
        b_ms, b_by = bound_ms(r * m + 4 * r + 4 * bins, r * m)
        got = kernels.hll_union_histogram(regs, idx, 14)
        got_odd = kernels.hll_union_histogram(regs, odd, 14)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"K1-union rows={r}: max abs err {err}")
        check(torch.equal(got_odd, want_odd),
              f"K1-union rows={r}: repeated and out-of-range rows disagree "
              "with the plain version")
        check(torch.equal(lib.to(torch.int32), got),
              f"K1-union rows={r} disagrees with amax + bincount")
        ms = kernel_ms(lambda: kernels.hll_union_histogram(regs, idx, 14))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            replayed = kernels.hll_union_histogram(regs, odd, 14)
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(replayed, want_odd),
              f"K1-union rows={r}: a graph replay disagrees")
        print(f"K1-union hll_union_histogram rows={r} ms={ms} above_floor_ms="
              f"{ms - floor_ms} plain_ms={plain_ms} gather_amax_bincount_ms="
              f"{lib_ms} bound_ms={b_ms} ({b_by}) times_bound={ms / b_ms} "
              f"max_abs_err={err}")
        if r == 7:  # the pipeline's week of lectures
            rows["hll_union_histogram"] = dict(
                replaces="attendance_tpu/models/hll.py:363",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib_ms)


def _pipeline_result(proc, report):
    """(validity vector, lecture ids, student ids, {lecture: PFCOUNT},
    BF.INFO) of a finished processor, in scan order."""
    rows = proc.store.scan_all()
    sid = np.fromiter((r.student_id for r in rows), np.int64, len(rows))
    valid = np.fromiter((r.is_valid for r in rows), bool, len(rows))
    lecture = np.array([r.lecture_id for r in rows])
    lids = proc.store.distinct_lecture_ids()
    counts = {lid: proc.get_attendance_stats(lid)["unique_attendees"]
              for lid in lids}
    info = proc.sketch.execute_command("BF.INFO",
                                       proc.config.bloom_filter_key)
    return valid, lecture, sid, counts, info


def store_phase(card: str, floor_ms: float, rows: dict) -> dict:
    """Phase 6: the generic sketch store and the processor loop on the
    card. Returns the launch counts of (b)'s run and its reads."""
    import shutil
    import tempfile
    from datetime import datetime
    from pathlib import Path

    from attendance_tpu_torch.cli import run_pipeline
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.parity import run_sim_parity
    from attendance_tpu_torch.pipeline.analyzer import AttendanceAnalyzer
    from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
    from attendance_tpu_torch.sketch import TpuSketchStore
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    dev = torch.device("cuda", 0)
    # The store's HLL at 1024 keys x 2^14 registers (BASELINE config 3),
    # filled by pfadd_many batches of the processor's size.
    t0 = time.perf_counter()
    store = TpuSketchStore(Config(), device=dev)
    keys = [f"hll:unique:LECTURE_{i:04d}" for i in range(1024)]
    rng = np.random.default_rng(7)
    for key in keys:
        store.pfadd_many(key, rng.integers(10_000, 10_000_000, 8192))
    torch.cuda.synchronize()
    check(store.hll.regs.shape == (1024, 1 << 14),
          f"1024 keys grew the banks to {tuple(store.hll.regs.shape)}")
    print(f"store: 1024 keys x 8192 members by pfadd_many in "
          f"{time.perf_counter() - t0} s")

    # -- 6a. the new kernels against their plain versions -----------------
    store_kernels(dev, floor_ms, rows, store.hll.regs)

    # -- 6b. the pipeline flow, --sketch-backend tpu ----------------------
    now = datetime.now()
    MemoryBroker.reset_shared()
    kernels.reset_launches()  # counts set to 0 just before the run
    t0 = time.perf_counter()
    proc, report = run_pipeline(Config(), PIPELINE_STUDENTS, 50, seed=0,
                                device=dev, now=now)
    valid, lecture, sid, counts, info = _pipeline_result(proc, report)
    hll_keys = [f"{proc.config.hll_key_prefix}{lid}" for lid in counts]
    many = proc.sketch.pfcount_many(hll_keys)
    week = proc.sketch.pfcount(*hll_keys)
    insights = AttendanceAnalyzer(proc.store).generate_insights()
    fpr_est = proc.estimated_fpr()
    wall = time.perf_counter() - t0
    p6 = dict(kernels.launches)  # read just after the run and its reads
    for name in STORE_KERNELS:
        check(p6[name] > 0, f"pipeline: kernel {name} not launched")
    m = proc.metrics
    print(f"pipeline --sketch-backend tpu: {m.events} events in "
          f"{m.batches} batches, {m.events_per_second} events/s on {card}; "
          f"processor wall {m.wall_seconds} s, device_seconds "
          f"{m.device_seconds} s (share {m.device_seconds / m.wall_seconds}"
          f"); generate + process + reads {wall} s; launches {p6}")
    check(m.valid_events + m.invalid_events == m.events
          == report.message_count,
          f"pipeline: {m.valid_events} + {m.invalid_events} != {m.events}")
    # Rows are upserted by (lecture, timestamp, student): a repeated
    # invalid swipe in one minute is one row.
    check(0 < len(valid) <= m.events, f"pipeline: {len(valid)} rows")
    is_roster = np.isin(sid, np.fromiter(report.valid_student_ids,
                                         np.int64))
    fn = int((is_roster & ~valid).sum())
    check(fn == 0, f"pipeline: {fn} false negatives")
    fp_events = int((~is_roster & valid).sum())
    probe = np.random.default_rng(8).integers(100_000, 1_000_000, 1 << 20)
    probe_fpr = float(np.mean(proc.sketch.bf_exists_many(
        proc.config.bloom_filter_key, probe)))
    check(fpr_est is not None and 0 < fpr_est < 0.015,
          f"pipeline: estimated FPR {fpr_est}")
    check(probe_fpr <= 0.015, f"pipeline: measured FPR {probe_fpr}")
    worst = 0.0
    for i, lid in enumerate(counts):
        exact = len(np.unique(sid[(lecture == lid) & valid]))
        err = abs(counts[lid] - exact) / exact
        worst = max(worst, err)
        check(err <= 0.03, f"pipeline: {lid} PFCOUNT {counts[lid]} vs "
              f"exact {exact}")
        check(many[i] == counts[lid], f"pfcount_many {lid}")
    exact_week = len(np.unique(sid[valid]))
    check(abs(week - exact_week) / exact_week <= 0.03,
          f"pipeline: week union {week} vs exact {exact_week}")
    check(len(insights) == 5, "pipeline: analyzer insights")
    print(f"pipeline checks: {len(valid)} stored rows, "
          f"{len(counts)} lectures, worst PFCOUNT err "
          f"{worst}, week union {week} vs exact {exact_week}; false "
          f"negatives {fn}; {fp_events} invalid events read valid of "
          f"{m.invalid_events}; measured FPR {probe_fpr} on {len(probe)} "
          f"non-roster ids; estimated FPR {fpr_est}; BF.INFO {info}")
    proc.cleanup()
    del proc

    MemoryBroker.reset_shared()
    t0 = time.perf_counter()
    mproc, _ = run_pipeline(Config(sketch_backend="memory"),
                            PIPELINE_STUDENTS, 50, seed=0, now=now)
    mvalid, mlecture, msid, mcounts, minfo = _pipeline_result(mproc, report)
    check(np.array_equal(mvalid, valid) and np.array_equal(msid, sid),
          "pipeline: the memory backend's validity vector differs")
    check(mcounts == counts, f"pipeline: memory PFCOUNTs {mcounts} != "
          f"{counts}")
    check(minfo == info, f"pipeline: memory BF.INFO {minfo} != {info}")
    print(f"pipeline --sketch-backend memory, same process: "
          f"{mproc.metrics.events_per_second} events/s, equal validity, "
          f"PFCOUNTs and BF.INFO ({time.perf_counter() - t0} s)")
    mproc.cleanup()
    del mproc
    MemoryBroker.reset_shared()

    # -- 6c. parity --oracle sim ------------------------------------------
    t0 = time.perf_counter()
    kernels.reset_launches()
    parity = run_sim_parity(Config(), dev, num_events=1 << 20,
                            roster_size=100_000, num_lectures=16, seed=0)
    print(parity.summary())
    check(parity.ok, "parity --oracle sim failed")
    print(f"parity: {time.perf_counter() - t0} s; launches (not in the "
          f"kernels line) {dict(kernels.launches)}")

    # -- 6d. processor checkpoint and restore -----------------------------
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_store_"))
    try:
        for mode in ("delta", "barrier"):
            config = Config(snapshot_dir=str(work / mode),
                            snapshot_mode=mode, snapshot_every_batches=4,
                            snapshot_compact_every=3)
            MemoryBroker.reset_shared()
            proc, _ = run_pipeline(config, 20_000, 20, seed=1, device=dev,
                                   now=now)
            back = AttendanceProcessor(config, device=dev,
                                       client=MemoryClient(MemoryBroker()))
            a, b = proc.sketch, back.sketch
            check(a._blooms.keys() == b._blooms.keys(), f"{mode}: keys")
            for key in a._blooms:
                fa, fb = a._blooms[key].filters, b._blooms[key].filters
                check(len(fa) == len(fb) and all(
                    torch.equal(x, y) for x, y in zip(fa, fb)),
                    f"{mode}: sub-filter bytes of {key}")
            check(a.hll._bank_of == b.hll._bank_of, f"{mode}: bank_of")
            check(torch.equal(a.hll.regs, b.hll.regs), f"{mode}: registers")
            check(back.store.count() == proc.store.count(), f"{mode}: rows")
            print(f"processor {mode} checkpoint: {proc.metrics.batches} "
                  f"batches, restored equal (filters, {len(a.hll._bank_of)} "
                  f"banks, {back.store.count()} rows)")
            proc.cleanup()
            back.cleanup()
    finally:
        shutil.rmtree(work, ignore_errors=True)
        MemoryBroker.reset_shared()

    # -- 6e. store PFCOUNT latency ----------------------------------------
    for what, fn, reps in (
            ("pfcount(key)", lambda: store.pfcount(keys[5]), 200),
            ("pfcount_many(1024 keys)", lambda: store.pfcount_many(keys), 5),
            ("pfcount(7-key union)", lambda: store.pfcount(*keys[:7]), 200)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        print(f"store PFCOUNT {what}: {(time.perf_counter() - t0) / reps * 1e3}"
              f" ms a call (host wall, {reps} calls, answers read on the "
              f"host)")
    print(f"store phase launches (the pipeline run and its reads; in the "
          f"kernels line): {p6}")
    return p6


INGRESS_SOCKET_STUDENTS = 9_000  # phase 7(c): the socket run's cut
INGRESS_NOW = (2026, 3, 2, 9, 0)  # the generator's clock, fixed


class _Collect:
    """A producer that keeps what the generator sends (its JSON wire)."""

    def __init__(self):
        self.payloads = []

    def send(self, data, properties=None):
        self.payloads.append(bytes(data))


def reference_stream(num_students: int, seed: int = 0):
    """(roster, JSON payloads, their columns): the reference generator's
    per-event JSON at ``num_students`` students and 50 invalid ids, the
    columns decoded by the vectorized numpy scan (not the native scan
    the pipeline uses)."""
    from datetime import datetime

    from attendance_tpu_torch.pipeline.codec import scan_json_batch_columns
    from attendance_tpu_torch.pipeline.generator import generate_student_data

    sink = _Collect()
    report = generate_student_data(
        producer=sink, num_students=num_students, num_invalid=50,
        seed=seed, now=datetime(*INGRESS_NOW), keep_events=False)
    roster = np.array(sorted(report.valid_student_ids), np.uint32)
    check(len(sink.payloads) == report.message_count,
          "reference stream: payload count")
    return roster, sink.payloads, scan_json_batch_columns(sink.payloads)


def _ingress_state(pipe):
    """Counters, PFCOUNTs, registers by day and the deduped store (rows
    sorted by day, micros, student), comparable across bank orders."""
    regs = pipe.state.hll_regs
    by_day = {d: regs[b].clone() for d, b in pipe._bank_of.items()}
    cols = pipe.store.to_columns()
    order = np.lexsort((cols["student_id"], cols["micros"],
                        cols["lecture_day"]))
    return (pipe.validity_counts(), pipe.count_all(), by_day,
            {k: np.asarray(cols[k])[order] for k in
             ("student_id", "lecture_day", "micros", "is_valid")})


def _check_ingress_same(what: str, got, want) -> None:
    check(got[0] == want[0], f"{what}: counters {got[0]} != {want[0]}")
    check(got[1] == want[1], f"{what}: PFCOUNTs differ")
    check(got[2].keys() == want[2].keys() and all(
        torch.equal(got[2][d], want[2][d]) for d in want[2]),
        f"{what}: registers differ")
    for name in want[3]:
        check(np.array_equal(got[3][name], want[3][name]),
              f"{what}: store column {name} differs")


def _bridge_then_fused(dev, roster, payloads):
    """(b): JsonBinaryBridge over ``payloads`` on a memory broker of its
    own, then a FusedPipeline on ``<topic>-binary``."""
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.pipeline.bridge import (
        BINARY_TOPIC_SUFFIX, JsonBinaryBridge)
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    client = MemoryClient(MemoryBroker())
    topic = Config().pulsar_topic
    pipe = FusedPipeline(Config(pulsar_topic=topic + BINARY_TOPIC_SUFFIX),
                         client=client, device=dev)
    bridge = JsonBinaryBridge(Config(), client=client)
    bridge.client.create_producer(topic).send_many(payloads)
    bridge.run(max_events=len(payloads), idle_timeout_s=1.0)
    pipe.preload(roster)
    pipe.run(max_events=len(payloads), idle_timeout_s=1.0)
    check(bridge.metrics.events == pipe.metrics.events == len(payloads),
          f"bridge path: {bridge.metrics.events} bridged, "
          f"{pipe.metrics.events} dispatched of {len(payloads)}")
    check(bridge.consumer.backlog() == 0 and pipe.consumer.backlog() == 0,
          "bridge path: backlog left")
    return bridge, pipe


def ingress_phase(card: str, dev) -> dict:
    """Phase 7: the reference's per-event JSON wire into the fused path
    on the card. Returns (a)'s launch counts and, for phase 8, the
    streams, (a)'s state and rate and (b)'s state on the cut stream."""
    import json as _json
    import os
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models import bloom
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.bridge import BINARY_TOPIC_SUFFIX
    from attendance_tpu_torch.pipeline.events import encode_planar_batch
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.lanes import JsonChunkConsumer
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)
    from attendance_tpu_torch.transport.socket_broker import (
        BrokerServer, SocketClient)

    t0 = time.perf_counter()
    roster, payloads, truth_cols = reference_stream(PIPELINE_STUDENTS)
    n = len(payloads)
    truth = truth_cols["is_valid"]
    print(f"ingress: the reference generator's JSON at {PIPELINE_STUDENTS} "
          f"students, 50 invalid ids, seed 0: {n} messages, "
          f"{sum(map(len, payloads))} bytes, {len(roster)} roster ids "
          f"({time.perf_counter() - t0} s)")

    # -- 7a. the fused pipeline fed the JSON wire --------------------------
    config = Config()
    pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                         device=dev)
    check(isinstance(pipe.consumer, JsonChunkConsumer)
          and pipe._native is not None,
          "ingress (a): not the chunk consumer with the native scan")
    producer = pipe.client.create_producer(config.pulsar_topic)
    t0 = time.perf_counter()
    producer.send_many(payloads)
    publish_s = time.perf_counter() - t0
    kernels.reset_launches()  # counts set to 0 just before the run
    pipe.preload(roster)
    pipe.run(max_events=n, idle_timeout_s=1.0)
    counts = pipe.count_all()
    p7 = dict(kernels.launches)  # read just after the run and its reads
    m = pipe.metrics
    step = sum(p7[k] for k in set(STEP_OF_WIRE.values()))
    check(step > 0 and p7["bloom_add"] > 0 and p7["hll_histogram"] > 0,
          f"ingress (a): K2/K3/K1 launches {p7}")
    valid_n, invalid_n = pipe.validity_counts()
    check(valid_n + invalid_n == m.events == n,
          f"ingress (a): {valid_n} + {invalid_n} != {n}")
    stored = pipe.store.to_columns(deduplicate=False)
    check(np.array_equal(stored["student_id"], truth_cols["student_id"])
          and np.array_equal(stored["micros"], truth_cols["micros"]),
          "ingress (a): stored rows differ from the stream")
    valid = np.asarray(stored["is_valid"])
    fn = int((truth & ~valid).sum())
    check(fn == 0, f"ingress (a): {fn} false negatives")
    probe = np.random.default_rng(8).integers(100_000, 1_000_000, 1 << 20)
    hits = bloom.bloom_contains_packed(
        pipe.state.bloom_bits,
        torch.from_numpy(probe.astype(np.uint32).view(np.int32)).to(dev),
        pipe.params)
    probe_fpr = float(hits.float().mean())
    check(probe_fpr <= 0.015, f"ingress (a): measured FPR {probe_fpr}")
    day, sid = truth_cols["lecture_day"], truth_cols["student_id"]
    worst = 0.0
    for d, est in counts.items():
        exact = len(np.unique(sid[(day == d) & valid]))
        worst = max(worst, abs(est - exact) / exact)
    check(worst <= 0.03, f"ingress (a): PFCOUNT relative error {worst}")
    state_a = _pipe_state(pipe)
    stored_a = valid.copy()
    sorted_a = _ingress_state(pipe)
    print(f"ingress (a) JSON -> chunk consumer -> fused: {n} events in "
          f"{m.batches} dispatches, {m.events_per_second} events/s (wall "
          f"{m.wall_seconds} s; publish {publish_s} s) on {card}; decode "
          f"{m.stage_seconds['decode']} s, pack {m.stage_seconds['pack']} s "
          f"(decode share {m.stage_seconds['decode'] / m.wall_seconds}); "
          f"wires {dict(m.wire_dwell)}; valid {valid_n} invalid {invalid_n}; "
          f"false negatives {fn}; {int((~truth & valid).sum())} of "
          f"{int((~truth).sum())} invalid events read valid; measured FPR "
          f"{probe_fpr} on {len(probe)} non-roster ids; worst PFCOUNT err "
          f"{worst}; launches K2 {step} K3 {p7['bloom_add']} K1 "
          f"{p7['hll_histogram']}")
    print(f"ingress (a) host stages (s): {dict(m.stage_seconds)}")
    rate_a, stages_a = m.events_per_second, dict(m.stage_seconds)
    pipe.cleanup()
    del pipe

    # The same events as ATB2 frames of the fused default size.
    frames = [encode_planar_batch({k: v[i:i + (1 << 17)]
                                   for k, v in truth_cols.items()})
              for i in range(0, n, 1 << 17)]
    pipe = drive(Config(), roster, frames, n)
    _check_same("ingress (a) vs the same events as ATB2 frames",
                _pipe_state(pipe), state_a, store=False)
    check(np.array_equal(pipe.store.to_columns(deduplicate=False)
                         ["is_valid"], stored_a),
          "ingress (a) vs ATB2: stored validity differs")
    print(f"ingress ATB2 frames: {pipe.metrics.events_per_second} events/s "
          f"({len(frames)} frames); equal to (a) in counters, PFCOUNTs, "
          f"registers, bank map and stored validity")
    pipe.cleanup()
    del pipe

    # -- 7b. JsonBinaryBridge -> <topic>-binary -> fused -------------------
    bridge, pipe = _bridge_then_fused(dev, roster, payloads)
    _check_same("ingress (b) bridge path vs (a)", _pipe_state(pipe),
                state_a, store=False)
    check(np.array_equal(pipe.store.to_columns(deduplicate=False)
                         ["is_valid"], stored_a),
          "ingress (b): stored validity differs from (a)")
    bm, m = bridge.metrics, pipe.metrics
    print(f"ingress (b) JSON -> bridge -> {Config().pulsar_topic}"
          f"{BINARY_TOPIC_SUFFIX} -> fused: bridge {bm.events} events in "
          f"{bm.batches} frames, {bm.events_per_second} events/s (wall "
          f"{bm.wall_seconds} s); fused {m.events_per_second} events/s "
          f"(wall {m.wall_seconds} s) on {card}; decode "
          f"{m.stage_seconds['decode']} s, pack {m.stage_seconds['pack']} s;"
          f" end to end {n / (bm.wall_seconds + m.wall_seconds)} events/s; "
          f"equal to (a)")
    bridge.cleanup()
    pipe.cleanup()
    del pipe

    # -- 7c. two bridge processes on a socket broker -----------------------
    cut = INGRESS_SOCKET_STUDENTS
    roster_c, payloads_c, _ = reference_stream(cut)
    n_c = len(payloads_c)
    bridge, pipe = _bridge_then_fused(dev, roster_c, payloads_c)
    want = _ingress_state(pipe)
    bridge.cleanup()
    pipe.cleanup()
    del pipe
    topic = Config().pulsar_topic
    server = BrokerServer().start()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_ingress_"))
    outs = [work / f"bridge{i}.jsonl" for i in range(2)]
    # One intra-op thread a process; the port from this checkout.
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [repo] + [x for x in [os.environ.get("PYTHONPATH")]
                             if x]))
    procs = []
    client = None
    pipe = None
    try:
        procs = [subprocess.Popen(
            [sys.executable, "-m", "attendance_tpu_torch", "bridge",
             "--transport-backend", "socket", "--socket-broker",
             server.address, "--max-events", str(n_c // 2),
             "--batch-size", str(min(8192, n_c // 8)),
             "--idle-timeout-s", "3", "--metrics-json", str(out)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for out in outs]
        deadline = time.monotonic() + 180
        while server.consumer_count(topic, "attendance_bridge") < 2:
            for p in procs:
                if p.poll() is not None:
                    check(False, "ingress (c): a bridge process died:\n"
                          f"{p.communicate()[0][-3000:]}")
            check(time.monotonic() < deadline,
                  "ingress (c): bridge processes did not subscribe")
            time.sleep(0.05)
        pipe = FusedPipeline(Config(transport_backend="socket",
                                    socket_broker=server.address,
                                    pulsar_topic=topic + BINARY_TOPIC_SUFFIX),
                             device=dev)
        pipe.preload(roster_c)
        client = SocketClient(server.address)
        producer = client.create_producer(topic)
        for i in range(0, n_c, 8192):
            producer.send_many(payloads_c[i:i + 8192])
        pipe.run(max_events=n_c, idle_timeout_s=10.0)
        logs = [p.communicate(timeout=300)[0] for p in procs]
        for p, log in zip(procs, logs):
            check(p.returncode == 0, f"ingress (c): a bridge process "
                  f"exited {p.returncode}:\n{log[-3000:]}")
        shares = [_json.loads(o.read_text()) for o in outs]
        check(sum(a["events"] for a in shares) == n_c == pipe.metrics.events,
              f"ingress (c): {[a['events'] for a in shares]} bridged, "
              f"{pipe.metrics.events} dispatched of {n_c}")
        check(all(a["events"] > 0 for a in shares),
              f"ingress (c): a bridge did no work {shares}")
        check(all(a["dead_lettered"] == 0 for a in shares),
              "ingress (c): dead-lettered messages")
        backlog = server.broker.topic(topic).subscription(
            "attendance_bridge").backlog()
        check(backlog == 0 and pipe.consumer.backlog() == 0,
              f"ingress (c): backlog {backlog}")
        _check_ingress_same("ingress (c) socket vs (b) on the cut stream",
                            _ingress_state(pipe), want)
        m = pipe.metrics
        print(f"ingress (c) 2 bridge processes on a socket broker -> fused "
              f"through a SocketClient, cut to {cut} students ({n_c} "
              f"events): {m.events_per_second} events/s (wall "
              f"{m.wall_seconds} s, the bridges' startup excluded) on "
              f"{card}; bridge shares {[a['events'] for a in shares]} at "
              f"{[a['events_per_second'] for a in shares]} events/s; "
              f"decode {m.stage_seconds['decode']} s, pack "
              f"{m.stage_seconds['pack']} s; converted once, none "
              f"dead-lettered, backlog 0, equal to (b) on the cut stream")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if pipe is not None:
            pipe.cleanup()
        if client is not None:
            client.close()
        server.stop()
        import shutil
        shutil.rmtree(work, ignore_errors=True)
    print(f"ingress phase launches (a's run and reads; in the kernels "
          f"line): {p7}")
    return dict(launches=p7, roster=roster, payloads=payloads,
                state_a=state_a, sorted_a=sorted_a, rate_a=rate_a,
                stages_a=stages_a, roster_c=roster_c, payloads_c=payloads_c,
                want_c=want)


SHM_SLOT_BYTES = 4 << 20  # phase 8(c): a 131,072-event frame is 2,621,448 B
SHM_SLOTS = 16
_SHM_PRODUCER = """
import sys
from attendance_tpu_torch.config import Config
from attendance_tpu_torch.pipeline.loadgen import generate_frames
from attendance_tpu_torch.transport import make_client
num_events, frame_size, num_lectures, lanes = map(int, sys.argv[2:6])
config = Config(ingress_wire="shm", shm_dir=sys.argv[1], ingress_lanes=lanes,
                shm_slots=%d, shm_slot_bytes=%d)
_, frames = generate_frames(num_events, frame_size,
                            roster_size=min(config.bloom_filter_capacity,
                                            num_events),
                            num_lectures=num_lectures, seed=0)
client = make_client(config)
producer = client.create_producer(config.pulsar_topic)
for frame in frames:
    producer.send(frame)
client.close()
""" % (SHM_SLOTS, SHM_SLOT_BYTES)


class _Counted:
    """Phase 8's launch counts: each run's counts are set to 0 just
    before it and read just after it and its reads, then summed."""

    def __init__(self):
        from attendance_tpu_torch.ops import kernels
        self.kernels = kernels
        self.total = dict.fromkeys(kernels.launches, 0)

    def start(self) -> None:
        self.kernels.reset_launches()

    def stop(self, what: str, need=("bloom_add", "hll_histogram")) -> dict:
        got = dict(self.kernels.launches)
        step = sum(got[k] for k in set(STEP_OF_WIRE.values()))
        check(step > 0, f"{what}: no fused step launched {got}")
        for name in need:
            check(got[name] > 0, f"{what}: kernel {name} not launched")
        for name, count in got.items():
            self.total[name] += count
        return got


def _ref_equal(what: str, pipe, ref, stored: bool = True) -> None:
    """A run of the default stream equal to phase 3's default run:
    counters, PFCOUNTs, registers and stored validity (in stream
    order)."""
    got_pf = {str(d): n for d, n in sorted(pipe.count_all().items())}
    check(pipe.validity_counts() == ref[0], f"{what}: counters differ")
    check(got_pf == ref[1], f"{what}: PFCOUNTs differ")
    check(torch.equal(pipe.state.hll_regs, ref[2]),
          f"{what}: registers differ")
    if stored:
        check(np.array_equal(pipe.store.to_columns(deduplicate=False)
                             ["is_valid"], ref[3]),
              f"{what}: stored validity differs")


def lanes_serve_phase(card: str, dev, ingress: dict, ref, rates_p3: dict,
                      shape) -> dict:
    """Phase 8: striped ingress lanes, the shared-memory ring and the
    query plane on the card. Returns its runs' summed launch counts."""
    import os
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.cli import run_fused
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models import bloom
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.lanes import StripedConsumer
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.serve.rpc import QueryClient
    from attendance_tpu_torch.temporal.buckets import decode_bucket_key
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)
    from attendance_tpu_torch.transport.shm_ring import _Ring, ring_path
    from attendance_tpu_torch.transport.socket_broker import (
        BrokerServer, SocketClient)

    t_phase = time.perf_counter()
    num_events, frame_size, num_lectures = shape
    counted = _Counted()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_lanes_"))
    repo = str(Path(__file__).resolve().parent)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo] + [x for x in [os.environ.get("PYTHONPATH")] if x]))
    procs = []
    try:
        # -- 8a. the JSON wire through 4 lanes ----------------------------
        payloads, roster = ingress["payloads"], ingress["roster"]
        n = len(payloads)
        broker = MemoryBroker()
        config = Config(ingress_lanes=4)
        pipe = FusedPipeline(config, client=MemoryClient(broker), device=dev)
        check(isinstance(pipe.consumer, StripedConsumer)
              and len(pipe.consumer.lanes) == 4 and pipe._native is not None,
              "lanes (a): not 4 lanes with the native scan")
        pipe.client.create_producer(config.pulsar_topic).send_many(payloads)
        counted.start()
        pipe.preload(roster)
        pipe.run(max_events=n, idle_timeout_s=1.0)
        got = _ingress_state(pipe)
        p8a = counted.stop("lanes (a)")
        # Banks are numbered in dispatch order, which the lanes change:
        # registers are held day by day, and stored rows sorted.
        check(set(pipe._bank_of) == set(ingress["state_a"][3]),
              "lanes (a): the bank map's days differ from ingress (a)'s")
        _check_ingress_same("lanes (a) vs ingress (a)", got,
                            ingress["sorted_a"])
        m = pipe.metrics
        totals = pipe.consumer.lane_event_totals()
        lane_decode_s = [lane.decode_seconds for lane in pipe.consumer.lanes]
        check(sum(totals) == n == m.events and all(totals),
              f"lanes (a): lane totals {totals} of {n}")
        check(m.dead_lettered == 0, "lanes (a): dead-lettered messages")
        pipe.cleanup()
        backlog = broker.topic(config.pulsar_topic).subscription(
            pipe.SUBSCRIPTION).backlog()
        check(backlog == 0, f"lanes (a): backlog {backlog}")
        print(f"lanes (a) JSON -> 4 lanes -> fused: {n} events in "
              f"{m.batches} dispatches, {m.events_per_second} events/s (wall "
              f"{m.wall_seconds} s) on {card}, beside ingress (a)'s "
              f"{ingress['rate_a']} events/s in this call; lane totals "
              f"{totals}; lane decode seconds {lane_decode_s} (off the "
              f"dispatch thread); equal to ingress (a) in counters, "
              f"PFCOUNTs, registers and bank map day by day and stored "
              f"validity (rows sorted); none dead-lettered, backlog 0; "
              f"launches {p8a}")
        print(f"lanes (a) host stages (s): {dict(m.stage_seconds)}; "
              f"ingress (a): {ingress['stages_a']}")
        del pipe

        # -- 8b. the cut stream through 2 socket lanes ---------------------
        payloads_c, roster_c = ingress["payloads_c"], ingress["roster_c"]
        n_c = len(payloads_c)
        server = BrokerServer().start()
        client = pipe = None
        try:
            pipe = FusedPipeline(Config(transport_backend="socket",
                                        socket_broker=server.address,
                                        ingress_lanes=2), device=dev)
            check(server.consumer_count(pipe.config.pulsar_topic,
                                        pipe.SUBSCRIPTION) == 2,
                  "lanes (b): not two lane sessions")
            check(len({lane.consumer._rpc._sock.getsockname()
                       for lane in pipe.consumer.lanes}) == 2,
                  "lanes (b): the lanes share a connection")
            client = SocketClient(server.address)
            producer = client.create_producer(pipe.config.pulsar_topic)
            for i in range(0, n_c, 8192):
                producer.send_many(payloads_c[i:i + 8192])
            counted.start()
            pipe.preload(roster_c)
            pipe.run(max_events=n_c, idle_timeout_s=5.0)
            got = _ingress_state(pipe)
            p8b = counted.stop("lanes (b)")
            _check_ingress_same("lanes (b) socket lanes vs ingress (b) on "
                                "the cut stream", got, ingress["want_c"])
            m = pipe.metrics
            totals = pipe.consumer.lane_event_totals()
            check(sum(totals) == n_c and all(totals),
                  f"lanes (b): lane totals {totals} of {n_c}")
            print(f"lanes (b) {n_c} JSON messages -> 2 socket lanes "
                  f"(subscribe_lane, one connection each) -> fused: "
                  f"{m.events_per_second} events/s (wall {m.wall_seconds} "
                  f"s) on {card}; lane totals {totals}; equal to ingress (b) "
                  f"on the cut stream; launches {p8b}")
        finally:
            if pipe is not None:
                pipe.cleanup()
            if client is not None:
                client.close()
            server.stop()
        del pipe

        # -- 8c. the fused default over the shm ring ----------------------
        shm = dict(ingress_wire="shm", shm_slots=SHM_SLOTS,
                   shm_slot_bytes=SHM_SLOT_BYTES)
        counted.start()
        pipe, summary = run_fused(
            Config(shm_dir=str(work / "ring1"), **shm), num_events,
            frame_size, num_lectures, seed=0)
        try:
            p8c1 = counted.stop("shm (c) one consumer")
            _ref_equal("shm (c) one consumer vs phase 3", pipe, ref)
            single = _ingress_state(pipe)
            print(f"shm (c) fused default over one ring (16 slots of "
                  f"{SHM_SLOT_BYTES} B): {summary['events_per_second']} "
                  f"events/s (wall {summary['wall_seconds']} s) on {card}, "
                  f"beside phase 3's default {rates_p3[('default', 'first')]}"
                  f" / {rates_p3[('default', 'second')]} (first / second "
                  f"run); equal to phase 3; stages "
                  f"{summary['stage_seconds']}; launches {p8c1}")
        finally:
            pipe.cleanup()
        del pipe
        config = Config(shm_dir=str(work / "ring2"), ingress_lanes=2, **shm)
        pipe = FusedPipeline(config, device=dev)
        try:
            roster_d, _ = generate_frames(
                num_events, frame_size,
                roster_size=min(config.bloom_filter_capacity, num_events),
                num_lectures=num_lectures, seed=0)
            counted.start()
            pipe.preload(roster_d)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _SHM_PRODUCER, config.shm_dir,
                 str(num_events), str(frame_size), str(num_lectures), "2"],
                env=env))
            pipe.run(max_events=num_events, idle_timeout_s=120.0)
            got = _ingress_state(pipe)
            p8c2 = counted.stop("shm (c) two lanes")
            check(procs[-1].wait(timeout=120) == 0,
                  "shm (c): the producer process failed")
            _ref_equal("shm (c) two lanes vs phase 3", pipe, ref,
                       stored=False)
            _check_ingress_same("shm (c) two lanes vs one consumer", got,
                                single)
            totals = pipe.consumer.lane_event_totals()
            check(sum(totals) == num_events and all(totals),
                  f"shm (c): lane totals {totals}")
            m = pipe.metrics
            print(f"shm (c) two lanes, one ring each, frames from a "
                  f"producer process: {m.events_per_second} events/s (wall "
                  f"{m.wall_seconds} s, the producer's startup included) on "
                  f"{card}; lane totals {totals}; equal to phase 3 and to "
                  f"the one-consumer run; launches {p8c2}")
        finally:
            pipe.cleanup()
        del pipe
        # Resume: a checkpointing consumer closed before its last acks.
        config = Config(shm_dir=str(work / "ring3"),
                        snapshot_dir=str(work / "snap3"),
                        snapshot_every_batches=3, **shm)
        roster_d, frames = generate_frames(
            num_events, frame_size,
            roster_size=min(config.bloom_filter_capacity, num_events),
            num_lectures=num_lectures, seed=0)
        frames = list(frames)
        first = FusedPipeline(config, device=dev)

        def disk_died(*args, **kwargs):
            raise OSError("phase 8(c): the delta writes fail")

        first._write_delta_files = disk_died
        counted.start()
        first.preload(roster_d)
        producer = first.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        first.run(max_events=5 * frame_size, idle_timeout_s=1.0)
        first.consumer.close()  # the crash, frames 3-4 delivered, unacked
        acked = _Ring(ring_path(config.shm_dir, config.pulsar_topic, 0),
                      SHM_SLOTS, SHM_SLOT_BYTES).ack_cursor()
        check(acked == 3, f"shm (c) resume: ack_cursor {acked}, not 3")
        second = FusedPipeline(config, device=dev)
        try:
            check(second._events_restored == 3 * frame_size,
                  f"shm (c) resume: restored {second._events_restored}")
            second.run(max_events=num_events - 3 * frame_size,
                       idle_timeout_s=1.0)
            second.count_all()
            p8c3 = counted.stop("shm (c) resume")
            _ref_equal("shm (c) resumed vs phase 3", second, ref)
            print(f"shm (c) resume: the first consumer closed with frames "
                  f"3-4 unacked (ack_cursor 3); a fresh pipeline restored "
                  f"{3 * frame_size} events, drained the rest and equals "
                  f"phase 3's run; launches {p8c3}")
        finally:
            second.cleanup()
            first.cleanup()
        del first, second

        # -- 8d. serving --------------------------------------------------
        roster_d, frames = generate_frames(
            num_events, frame_size, roster_size=min(
                Config().bloom_filter_capacity, num_events),
            num_lectures=num_lectures, seed=0)
        snap = work / "snap4"
        config = Config(serve_port=-1, snapshot_dir=str(snap),
                        snapshot_every_batches=1, snapshot_mode="delta")
        pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                             device=dev)
        try:
            producer = pipe.client.create_producer(config.pulsar_topic)
            for f in frames:
                producer.send(f)
            counted.start()
            pipe.preload(roster_d)
            seqs, errors, stop = [], [], threading.Event()
            qc_live = QueryClient(pipe.query_server.address)

            def query_loop():
                try:
                    while not stop.is_set():
                        seqs.append(qc_live.stats()["epoch"])
                        qc_live.pfcount(np.arange(20_260_701,
                                                  20_260_701 + num_lectures))
                except Exception as exc:  # every call must succeed
                    errors.append(repr(exc))

            thread = threading.Thread(target=query_loop, daemon=True)
            thread.start()
            pipe.run(max_events=num_events, idle_timeout_s=1.0)
            stop.set()
            thread.join(timeout=30)
            qc_live.close()
            exact = pipe.count_all()
            days = np.array(sorted(exact), np.int64)
            p8d = counted.stop("serve (d)")
            check(not errors, f"serve (d): query errors {errors[:3]}")
            check(len(seqs) > 1 and all(a <= b for a, b in
                                        zip(seqs, seqs[1:])),
                  f"serve (d): epochs {seqs[:20]}")
            _ref_equal("serve (d) run vs phase 3", pipe, ref)
            engine = pipe.query_engine
            qc = QueryClient(pipe.query_server.address, batch_max=1 << 16)
            check(bool(qc.bf_exists(roster_d).all()),
                  "serve (d): a roster id reads absent")
            probe = np.arange(500_000, 500_000 + (1 << 20), dtype=np.uint32)
            served = qc.bf_exists(probe)
            fpr = float(served.mean())
            check(fpr <= 0.015, f"serve (d): measured FPR {fpr}")
            k4 = bloom.bloom_contains_packed(
                pipe.state.bloom_bits,
                torch.from_numpy(probe.view(np.int32)).to(dev), pipe.params)
            check(np.array_equal(served, k4.cpu().numpy()),
                  "serve (d): BF.EXISTS answers differ from K4 on the "
                  "card's filter")
            check(qc.pfcount(days).tolist() == [pipe.count(int(d))
                                               for d in days],
                  "serve (d): pfcount differs from count(day)")
            check(qc.occupancy() == exact == engine.occupancy(),
                  "serve (d): occupancy differs from count_all()")
            st = qc.stats()
            check((st["valid"], st["invalid"]) == pipe.validity_counts()
                  and st["events"] == num_events,
                  f"serve (d): stats {st}")
            qps = {}
            batch = probe[:1 << 16]
            for label, fn, reps in (
                    ("BF.EXISTS 65,536 keys over RPC",
                     lambda: qc.bf_exists(batch), 20),
                    ("BF.EXISTS 65,536 keys in process",
                     lambda: engine.bf_exists(batch), 20),
                    ("PFCOUNT 16 days over RPC",
                     lambda: qc.pfcount(days), 300),
                    ("PFCOUNT 16 days in process",
                     lambda: engine.pfcount(days), 300)):
                fn()
                t0 = time.perf_counter()
                for _ in range(reps):
                    fn()
                qps[label] = reps / (time.perf_counter() - t0)
            qc.close()
            m = pipe.metrics
            print(f"serve (d) fused default, delta barrier every frame, "
                  f"serve_port -1: {m.events_per_second} events/s (wall "
                  f"{m.wall_seconds} s) on {card}; {len(seqs)} live stats + "
                  f"pfcount rounds saw epochs {seqs[0]}..{seqs[-1]} (of "
                  f"{engine.pin().seq} published), never decreasing, no "
                  f"failed call; roster all present; FPR "
                  f"{fpr} on {len(probe)} non-roster ids, equal to K4; "
                  f"pfcount = count(day), occupancy = count_all(), stats = "
                  f"validity_counts(); launches {p8d}")
            print(f"serve (d) queries/s (batches/s) on {card}: " + "; ".join(
                f"{k} {v} ({v * (65536 if 'BF' in k else 16)} answers/s)"
                for k, v in qps.items()))
            final = engine.stats()
            want = dict(pf=engine.pfcount(days).tolist(),
                        occ=engine.occupancy(),
                        rate=engine.attendance_rate(100_000),
                        exists=engine.bf_exists(probe[:4096]).tolist(),
                        stats=[final[k] for k in ("events", "valid",
                                                  "invalid")])
        finally:
            pipe.cleanup()
        del pipe
        proc = subprocess.Popen(
            [sys.executable, "-m", "attendance_tpu_torch", "serve",
             "--snapshot-dir", str(snap), "--serve-port", "-1",
             "--serve-seconds", "120"], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)
        procs.append(proc)
        line = ""
        deadline = time.monotonic() + 120
        while "serving" not in line:
            check(time.monotonic() < deadline and proc.poll() is None,
                  "serve (d): the serve verb did not start")
            line = proc.stdout.readline()
        qc = QueryClient(line.split(" on ")[1].split()[0], batch_max=1 << 16)
        st = qc.stats()
        got = dict(pf=qc.pfcount(days).tolist(), occ=qc.occupancy(),
                   rate=qc.attendance_rate(100_000),
                   exists=qc.bf_exists(probe[:4096]).tolist(),
                   stats=[st[k] for k in ("events", "valid", "invalid")])
        qc.close()
        check(got == want, "serve (d): the serve verb's answers differ "
              f"from the in-process engine's final epoch: {got['stats']} "
              f"{want['stats']}")
        print(f"serve (d) `python -m attendance_tpu_torch serve` over the "
              f"run's chain ({line.strip()}): pfcount, occupancy, rate, "
              f"BF.EXISTS and counters equal to the in-process engine's "
              f"final epoch")
        proc.kill()
        proc.wait(timeout=30)
        # The window verbs on phase 3b's temporal configuration.
        roster_t, _hot, frames_t = temporal_frames(num_events, frame_size,
                                                   num_lectures)
        config = Config(temporal_period_s=60, allowed_lateness_s=5.0,
                        temporal_ring_banks=256, cms_depth=4,
                        cms_width=16384, cms_topk=16, audit_sample=1.0,
                        serve_port=-1)
        counted.start()
        pipe = drive(config, roster_t, frames_t, num_events)
        try:
            windows = pipe.window_counts()
            p8t = counted.stop("serve (d) temporal", need=(
                "bloom_add", "hll_histogram", "bloom_contains", "hll_add",
                "cms_step"))
            pipe.publish_epoch()
            engine = pipe.query_engine
            qc = QueryClient(pipe.query_server.address)
            wocc = qc.window_occupancy()
            check(wocc == {decode_bucket_key(k): v
                           for k, v in windows.items()}
                  == engine.window_occupancy() and len(wocc) > 1,
                  "serve (d) temporal: window_occupancy differs from "
                  "window_counts()")
            by_day = {}
            for (d, p), v in wocc.items():
                by_day.setdefault(d, {})[p] = v
                check(qc.window_pfcount(d, p, p) == v,
                      f"serve (d) temporal: window_pfcount({d}, {p}, {p})")
            for d, series in by_day.items():
                rates = qc.rate_series(d, len(roster_t))
                check(sorted(rates) == sorted(series) and all(
                    abs(rates[p] * len(roster_t) - v) <= 0.5 + 1e-6
                    for p, v in series.items()),
                    f"serve (d) temporal: rate_series({d})")
                whole = qc.window_pfcount(d)
                check(max(series.values()) <= whole
                      <= sum(series.values()),
                      f"serve (d) temporal: window_pfcount({d}) {whole}")
            qc.close()
            print(f"serve (d) temporal (phase 3b's configuration, "
                  f"publish_epoch() after the run): {len(wocc)} buckets; "
                  f"window_occupancy = window_counts(), window_pfcount of "
                  f"each bucket = its count, rate_series x roster = the "
                  f"counts, each day's window between its largest bucket "
                  f"and their sum; {pipe.metrics.events_per_second} events/s "
                  f"on {card}; launches {p8t}")
        finally:
            pipe.cleanup()
            obs.disable()  # audit_sample 1.0 turned telemetry on
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(f"lanes/shm/serve phase: {time.perf_counter() - t_phase} s")
    print(f"lanes/shm/serve phase launches (its runs and reads, summed; in "
          f"the kernels line): {counted.total}")
    return counted.total


# -- 9. federation on the card ------------------------------------------------
FED_ROSTER = 100_000  # the `fused` default's roster, as in phase 3
FED_EVENTS = 524_288  # a scaling round's per-worker events: 64 frames
FED_BATCH = 8_192     # the worker's frame (6 lectures, 10% invalid)
FED_FAIL_FRAMES = 24  # the failover round's frames a shard
FED_SEED = 0
FED_DEVICE = "cuda"   # every worker's --device


def _fed_env(repo: str) -> dict:
    import os
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [repo] + [x for x in [os.environ.get("PYTHONPATH")] if x]))


def _spawn_fed_worker(repo: str, env: dict, log, addr: str, work, shard: int,
                      num_shards: int, topic: str, gossip_topic: str,
                      events: int, *, data_plane: str, extra=()):
    """One ``python -m attendance_tpu_torch.federation.worker`` on the card,
    its output appended to ``log`` (a file, never an undrained pipe)."""
    cmd = [sys.executable, "-m", "attendance_tpu_torch.federation.worker",
           "--worker", f"w{shard}", "--shard", str(shard), "--num-shards",
           str(num_shards), "--broker", addr, "--topic", topic,
           "--gossip-topic", gossip_topic, "--workdir", str(work),
           "--data-plane", data_plane, "--num-events", str(events),
           "--roster-size", str(FED_ROSTER), "--seed", str(FED_SEED),
           "--device", FED_DEVICE, *extra]
    with open(log, "a") as fh:
        return subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT,
                                cwd=repo, env=env)


def _fed_report(log) -> dict:
    """The last JSON report line a worker wrote to its log."""
    lines = [ln for ln in open(log).read().splitlines()
             if ln.startswith("{")]
    check(bool(lines), f"no worker report in {log}")
    return json.loads(lines[-1])


def _fed_wait(procs, logs, what: str, timeout_s: float) -> None:
    deadline = time.time() + timeout_s
    for p, log in zip(procs, logs):
        while p.poll() is None:
            if time.time() > deadline:
                raise SystemExit(f"chip_smoke: FAILED: {what}: a worker "
                                 "never finished")
            time.sleep(0.05)
        check(p.returncode == 0, f"{what}: worker exited {p.returncode}:\n"
              + open(log).read()[-3000:])


def _fed_drain(agg) -> None:
    """Fold the gossip tail synchronously (the fold loop paused)."""
    agg.pause()
    quiet = 0
    while quiet < 3:
        quiet = quiet + 1 if agg.poll(timeout_ms=100) == 0 else 0


def _fed_oracle(dev, num_shards: int, events: int, run_shards=None) -> dict:
    """The no-crash federated oracle: one FusedPipeline on the card per
    shard (its roster slice preloaded, its frames run; with
    ``run_shards``, only those shards' frames run and the others are
    preloaded alone), merged with the CRDT twins. A single pipeline over
    the whole roster is not register-equivalent: its denser filter admits
    other false-positive invalid ids into the day registers."""
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.federation.worker import build_workload
    from attendance_tpu_torch.models.bloom import bloom_or_words_np
    from attendance_tpu_torch.models.fused import decode_counts
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    words, regs_by_day, valid, invalid, shard_words = None, {}, 0, 0, []
    for s in range(num_shards):
        roster, mine, frames = build_workload(FED_SEED, s, num_shards, events,
                                              roster_size=FED_ROSTER)
        pipe = FusedPipeline(Config(), client=MemoryClient(MemoryBroker()),
                             num_banks=16, device=dev)
        try:
            pipe.preload(mine)
            if run_shards is None or s in run_shards:
                producer = pipe.client.create_producer(
                    pipe.config.pulsar_topic)
                for f in frames:
                    producer.send(f)
                pipe.run(max_events=events, idle_timeout_s=2.0)
                check(pipe.metrics.events == events,
                      f"oracle shard {s}/{num_shards}: "
                      f"{pipe.metrics.events} events")
            w = pipe.state.bloom_bits.cpu().numpy().view(np.uint32).copy()
            shard_words.append(w)
            words = w if words is None else bloom_or_words_np(words, w)
            regs = pipe.state.hll_regs.cpu().numpy()
            for day, b in pipe._bank_of.items():
                cur = regs_by_day.get(day)
                regs_by_day[day] = (regs[b].copy() if cur is None
                                    else np.maximum(cur, regs[b]))
            v, i = decode_counts(pipe.state.counts)
            valid, invalid = valid + v, invalid + i
            params = pipe.params
        finally:
            pipe.cleanup()
    return dict(roster=roster, words=words, regs_by_day=regs_by_day,
                valid=valid, invalid=invalid, params=params,
                shard_words=shard_words)


def _fed_oracle_reads(dev, oracle: dict, probe: np.ndarray) -> None:
    """The oracle's reads on the card: the whole roster preloaded into one
    filter (K3; it must equal the OR of the shard filters), PFCOUNT of
    every day through K1, BF.EXISTS of the non-roster probe through K4."""
    from attendance_tpu_torch.models import bloom, hll

    params = oracle["params"]
    full = bloom.bloom_packed_init(params, dev)
    bloom.bloom_add_packed(full, torch.from_numpy(
        oracle["roster"].view(np.int32)).to(dev), params)
    check(np.array_equal(full.cpu().numpy().view(np.uint32),
                         oracle["words"]),
          "federation oracle: the whole roster's filter differs from the OR "
          "of the shard filters")
    days = sorted(oracle["regs_by_day"])
    regs = torch.from_numpy(np.stack(
        [oracle["regs_by_day"][d] for d in days])).to(dev)
    hists = hll.best_histogram(regs, 14).cpu().numpy()
    oracle["pfcount"] = {d: int(round(hll.estimate_from_histogram(h, 14)))
                         for d, h in zip(days, hists)}
    oracle["k4"] = bloom.bloom_contains_packed(
        full, torch.from_numpy(probe.view(np.int32)).to(dev),
        params).cpu().numpy()


def _fed_gates(what: str, view, engine, oracle: dict, probe: np.ndarray,
               events: int, *, exact_counters: bool = True) -> int:
    """Phase 9's gates on a merged view against the oracle; returns the
    events overcount (0 unless ``exact_counters`` is off)."""
    from attendance_tpu_torch.models.fused import decode_counts

    check(np.array_equal(view.bloom_words, oracle["words"]),
          f"{what}: merged Bloom words differ from the oracle's")
    got = view.regs_by_day()
    check(set(got) == set(oracle["regs_by_day"]),
          f"{what}: days {sorted(got)} vs {sorted(oracle['regs_by_day'])}")
    for day, row in oracle["regs_by_day"].items():
        check(np.array_equal(got[day], row),
              f"{what}: registers of day {day} differ from the oracle's")
    valid, invalid = decode_counts(view.counts_array())
    over = view.events - events
    if exact_counters:
        check(over == 0, f"{what}: merged events {view.events} != {events}")
        check((valid, invalid) == (oracle["valid"], oracle["invalid"]),
              f"{what}: valid/invalid ({valid}, {invalid}) vs oracle "
              f"({oracle['valid']}, {oracle['invalid']})")
    else:
        # At least once across a SIGKILL: never below the truth, above
        # it by at most two group commits, and reconciled.
        check(0 <= over <= 2 * 2 * FED_BATCH,
              f"{what}: events overcount {over}")
        check(valid >= oracle["valid"] and invalid >= oracle["invalid"]
              and (valid - oracle["valid"]) + (invalid - oracle["invalid"])
              == over, f"{what}: counters ({valid}, {invalid}) vs oracle "
              f"({oracle['valid']}, {oracle['invalid']}), overcount {over}")
    check(bool(engine.bf_exists(oracle["roster"]).all()),
          f"{what}: a roster id reads absent (a false negative)")
    if "pfcount" in oracle:
        days = np.array(sorted(oracle["pfcount"]), np.int64)
        check(engine.pfcount(days).tolist()
              == [oracle["pfcount"][int(d)] for d in days],
              f"{what}: served PFCOUNT differs from the oracle's K1 count")
        check(np.array_equal(engine.bf_exists(probe), oracle["k4"]),
              f"{what}: served BF.EXISTS of non-roster ids differs from K4 "
              "on the oracle's filter")
    check(view.stale_frames == 0 or not exact_counters,
          f"{what}: {view.stale_frames} stale frames")
    return over


def _fed_query_rates(engine, roster: np.ndarray) -> tuple:
    """(point answers/s over 64-key BF.EXISTS batches, occupancy tables/s)
    against the merged view (the JAX bench's ``_fed_query_rates``, shorter
    windows)."""
    rng = np.random.default_rng(1)
    bufs = [np.where(rng.random(64) < 0.5, rng.choice(roster, 64),
                     rng.integers(1 << 31, 1 << 32, 64).astype(np.uint32)
                     ).astype(np.uint32) for _ in range(16)]
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        engine.bf_exists(bufs[n % len(bufs)])
        n += 1
    qps = n * 64 / (time.perf_counter() - t0)
    n, t0 = 0, time.perf_counter()
    while time.perf_counter() - t0 < 0.5:
        engine.occupancy()
        n += 1
    return qps, n / (time.perf_counter() - t0)


def _build_files(repo: str) -> list:
    """(name, size, mtime) of every built library: a worker that compiled
    would change the list."""
    from pathlib import Path
    return sorted((str(p.relative_to(repo)), p.stat().st_size,
                   p.stat().st_mtime_ns)
                  for d in ("build/kernels", "build/native")
                  for p in (Path(repo) / d).glob("*") if p.is_file())


def federation_phase(card: str, dev) -> dict:
    """Phase 9: (a) scaling rounds at K = 1, 2, 4 workers, (b) failover
    with the peer re-assert, (c) the ``federate`` verb, (d) B15. Returns
    the launches of (a)'s in-process K = 1 round: its worker's run and
    the oracle's reads."""
    import argparse
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch.federation import worker as fed_worker
    from attendance_tpu_torch.federation.gossip import Aggregator
    from attendance_tpu_torch.federation.shard import shard_topic
    from attendance_tpu_torch.models import bloom
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.serve.engine import QueryEngine
    from attendance_tpu_torch.serve.rpc import QueryClient
    from attendance_tpu_torch.transport.socket_broker import (
        SocketClient, spawn_broker)

    t_phase = time.perf_counter()
    repo = str(Path(__file__).resolve().parent)
    env = _fed_env(repo)
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fed_"))
    built = _build_files(repo)
    probe = np.random.default_rng(9).integers(
        1 << 21, 1 << 31, 1 << 20).astype(np.uint32)
    launches = dict.fromkeys(kernels.launches, 0)
    oracles = {}
    procs = []
    broker, addr = spawn_broker(cwd=repo)
    try:
        # -- 9a. scaling rounds, memory data plane ---------------------------
        for K in (1, 2, 4):
            t_round = time.perf_counter()
            rdir = work / f"k{K}"
            topic, gossip_topic = f"chip-fed-k{K}", f"chip-fed-gossip-k{K}"
            agg_client = SocketClient(addr)
            agg = Aggregator(client=agg_client, topic=gossip_topic,
                             num_shards=K, dead_after_s=1e9, precision=14)
            lags = []
            fold = agg.fold_frame

            def fold_noting_lag(frame, now=None, fold=fold, lags=lags):
                info = fold(frame, now)
                if info["lag_s"] is not None:
                    lags.append(info["lag_s"])
                return info

            agg.fold_frame = fold_noting_lag
            agg.start()
            try:
                args = ["--broker", addr, "--num-shards", str(K), "--topic",
                        topic, "--gossip-topic", gossip_topic, "--workdir",
                        str(rdir), "--data-plane", "memory", "--num-events",
                        str(FED_EVENTS), "--max-events", str(FED_EVENTS),
                        "--roster-size", str(FED_ROSTER), "--seed",
                        str(FED_SEED), "--idle-timeout-s", "10",
                        "--device", FED_DEVICE]
                if K == 1:
                    # In this process: its launches are the phase's.
                    kernels.reset_launches()
                    reports = [fed_worker.run_worker(
                        fed_worker.build_parser().parse_args(
                            ["--worker", "w0", "--shard", "0", *args]))]
                    run_launches = dict(kernels.launches)
                else:
                    go = rdir / "go"
                    rdir.mkdir(parents=True)
                    logs = [rdir / f"worker-{s}.log" for s in range(K)]
                    round_procs = [
                        _spawn_fed_worker(
                            repo, env, logs[s], addr, rdir, s, K, topic,
                            gossip_topic, FED_EVENTS, data_plane="memory",
                            extra=("--max-events", str(FED_EVENTS),
                                   "--idle-timeout-s", "10", "--ready-file",
                                   str(rdir / f"ready-{s}"), "--go-file",
                                   str(go)))
                        for s in range(K)]
                    procs += round_procs
                    deadline = time.time() + 300
                    for s, p in enumerate(round_procs):
                        while not (rdir / f"ready-{s}").exists():
                            check(p.poll() is None, f"9a K={K}: worker w{s} "
                                  "died before ready:\n"
                                  + open(logs[s]).read()[-3000:])
                            check(time.time() < deadline,
                                  f"9a K={K}: worker w{s} never ready")
                            time.sleep(0.02)
                    go.touch()
                    _fed_wait(round_procs, logs, f"9a K={K}", 300)
                    reports = [_fed_report(log) for log in logs]
                _fed_drain(agg)
                if K not in oracles:
                    oracles[K] = _fed_oracle(dev, K, FED_EVENTS)
                if K == 1:
                    kernels.reset_launches()
                _fed_oracle_reads(dev, oracles[K], probe)
                if K == 1:
                    reads = dict(kernels.launches)
                    for name in launches:
                        launches[name] = run_launches[name] + reads[name]
                    step = sum(run_launches[k]
                               for k in set(STEP_OF_WIRE.values()))
                    check(step > 0 and run_launches["bloom_add"] > 0,
                          f"9a K=1: the worker's run launched {run_launches}")
                    check(reads["hll_histogram"] > 0
                          and reads["bloom_contains"] > 0,
                          f"9a K=1: the oracle's reads launched {reads}")
                engine = QueryEngine(agg.mirror, batch_max=1 << 20)
                what = f"federation (a) K={K}"
                check(sum(r["events"] for r in reports) == K * FED_EVENTS,
                      f"{what}: worker events {reports}")
                check(all(r["device"].startswith(FED_DEVICE)
                          for r in reports),
                      f"{what}: a worker ran off the card {reports}")
                _fed_gates(what, agg.view, engine, oracles[K], probe,
                           K * FED_EVENTS)
                point_qps, table_qps = _fed_query_rates(
                    engine, oracles[K]["roster"])
                lag = np.sort(np.asarray(lags)) if lags else np.zeros(1)
                measured = sum(r["measured_events"] for r in reports)
                wall = max(r["wall_s"] for r in reports)
                print(f"{what}: {K} x {FED_EVENTS} events, workers' events/s "
                      f"{[r['events_per_sec'] for r in reports]} walls "
                      f"{[r['wall_s'] for r in reports]} s, aggregate "
                      f"{measured / wall} events/s (sum of measured / max "
                      f"wall) on {card}; merge lag p50 "
                      f"{float(np.percentile(lag, 50))} p99 "
                      f"{float(np.percentile(lag, 99))} max {float(lag[-1])} "
                      f"s over {len(lags)} folds; frames folded "
                      f"{agg.view.folded_deltas + agg.view.folded_fulls} "
                      f"({agg.view.folded_deltas} deltas), stale "
                      f"{agg.view.stale_frames}; served {point_qps} "
                      f"BF.EXISTS answers/s (64-key batches), {table_qps} "
                      f"occupancy tables/s; round wall "
                      f"{time.perf_counter() - t_round} s")
            finally:
                agg.stop()
                agg_client.close()
        print(f"federation (a) K=1 launches (the worker's run, then the "
              f"oracle's reads; in the kernels line): {launches}")

        # -- 9b. failover with the peer re-assert, socket data plane ---------
        t_b = time.perf_counter()
        K, killed = 3, 1
        bdir = work / "failover"
        bdir.mkdir()
        topic, gossip_topic = "chip-fed-soak", "chip-fed-soak-gossip"
        n_events = FED_FAIL_FRAMES * FED_BATCH
        agg_client = SocketClient(addr)
        agg = Aggregator(client=agg_client, topic=gossip_topic,
                         num_shards=K, dead_after_s=3.0).start()
        try:
            logs = [bdir / f"worker-{s}.log" for s in range(K)]
            go = bdir / "go"
            extra = ("--snapshot-every", "2", "--idle-timeout-s", "4")
            workers = [_spawn_fed_worker(
                repo, env, logs[s], addr, bdir, s, K, topic, gossip_topic,
                n_events, data_plane="socket",
                extra=extra + ("--ready-file", str(bdir / f"ready-{s}"),
                               "--go-file", str(go)))
                for s in range(K)]
            procs += workers
            deadline = time.time() + 300
            for s, p in enumerate(workers):
                while not (bdir / f"ready-{s}").exists():
                    check(p.poll() is None, f"9b: w{s} died before ready:\n"
                          + open(logs[s]).read()[-3000:])
                    check(time.time() < deadline, f"9b: w{s} never ready")
                    time.sleep(0.02)
            client = SocketClient(addr)
            for s in range(K):
                _, _, frames = fed_worker.build_workload(
                    FED_SEED, s, K, n_events, roster_size=FED_ROSTER)
                producer = client.create_producer(shard_topic(topic, s))
                for f in frames:
                    producer.send(f)
                producer.close()
            client.close()
            go.touch()
            chain = bdir / f"chain-{killed}" / "CHAIN.json"
            deadline = time.time() + 120
            while not (chain.exists()
                       and json.loads(chain.read_text()).get("deltas")):
                check(workers[killed].poll() is None,
                      "9b: w1 exited before its chain held a delta")
                check(time.time() < deadline, "9b: w1 never wrote a delta")
                time.sleep(0.005)
            workers[killed].send_signal(signal.SIGKILL)
            workers[killed].wait()
            t_kill = time.time()
            # Gate A: declared dead, shard orphaned, chain recovered.
            deadline = t_kill + 3.0 + 30
            while True:
                stats = agg.stats()
                w1 = stats["workers"].get(f"w{killed}")
                if (w1 is not None and not w1["up"]
                        and f"w{killed}" in stats["recovered_chains"]):
                    break
                check(time.time() < deadline, f"9b gate A: w1 never "
                      f"declared dead and recovered: {stats}")
                time.sleep(0.02)
            t_dead = time.time() - t_kill
            check(stats["shard_map"]["owners"][killed] is None
                  and stats["shard_map"]["version"] >= 2,
                  f"9b gate A: shard map {stats['shard_map']}")
            dead_inc = w1["incarnation"]
            # Rot on the dead peer's chain: one byte in the middle of its
            # newest delta, after the aggregator folded the chain.
            corrupted = json.loads(chain.read_text())["deltas"][-1]
            victim = chain.parent / corrupted
            raw = bytearray(victim.read_bytes())
            raw[len(raw) // 2] ^= 0xFF
            victim.write_bytes(bytes(raw))
            takeover = _spawn_fed_worker(
                repo, env, logs[killed], addr, bdir, killed, K, topic,
                gossip_topic, n_events, data_plane="socket",
                extra=extra + ("--takeover",))
            procs.append(takeover)
            # Gate B: the takeover re-claims the shard, newer.
            deadline = time.time() + 120
            while True:
                stats = agg.stats()
                w1 = stats["workers"][f"w{killed}"]
                if (w1["up"] and w1["incarnation"] > dead_inc
                        and stats["shard_map"]["owners"][killed]
                        == f"w{killed}"):
                    break
                check(takeover.poll() in (None, 0), "9b: the takeover "
                      "failed:\n" + open(logs[killed]).read()[-3000:])
                check(time.time() < deadline,
                      f"9b gate B: the takeover never re-claimed: {stats}")
                time.sleep(0.02)
            _fed_wait([workers[0], workers[2], takeover],
                      [logs[0], logs[2], logs[killed]], "9b", 300)
            rep = _fed_report(logs[killed])
            check(rep["takeover"], f"9b: the takeover's report {rep}")
            qdir = chain.parent / "integrity-quarantine"
            check((qdir / corrupted).exists(),
                  f"9b gate B: {corrupted} was not quarantined")
            check(corrupted not in json.loads(chain.read_text())["deltas"],
                  "9b gate B: the manifest still names the corrupt delta")
            check("folded peer re-assert" in open(logs[killed]).read(),
                  "9b gate B: the takeover folded no peer re-assert")
            _fed_drain(agg)
            oracle_b = _fed_oracle(dev, K, n_events)
            over = _fed_gates("federation (b) failover", agg.view,
                              QueryEngine(agg.mirror, batch_max=1 << 20), oracle_b, probe,
                              K * n_events, exact_counters=False)
            print(f"federation (b) failover: {K} workers x {n_events} events "
                  f"over the socket data plane, w1 SIGKILLed once its chain "
                  f"held a delta, declared dead {t_dead} s after the kill "
                  f"(budget 3.0 s), map version {stats['shard_map']['version']}"
                  f", recovered chains {stats['recovered_chains']}; "
                  f"{corrupted} rotted, quarantined and repaired from the "
                  f"peer re-assert; takeover restore {rep['restore_s']} s, "
                  f"incarnation {w1['incarnation']} > {dead_inc}; events "
                  f"{agg.view.events} (true {K * n_events}, overcount "
                  f"{over}); Bloom words, registers and zero false "
                  f"negatives equal to the no-crash oracle; stale frames "
                  f"{agg.view.stale_frames}; wall {time.perf_counter() - t_b}"
                  f" s on {card}")
        finally:
            agg.stop()
            agg_client.close()

        # -- 9c. the federate verb as the aggregator of a K = 2 round --------
        t_c = time.perf_counter()
        cdir = work / "verb"
        cdir.mkdir()
        topic, gossip_topic = "chip-fed-verb", "chip-fed-verb-gossip"
        stats_file = cdir / "fed.json"
        verb_log = cdir / "federate.log"
        with open(verb_log, "w") as fh:
            verb = subprocess.Popen(
                [sys.executable, "-m", "attendance_tpu_torch", "federate",
                 "--transport-backend", "socket", "--socket-broker", addr,
                 "--fed-shards", "2", "--fed-gossip-topic", gossip_topic,
                 "--serve-port", "-1", "--serve-seconds", "600",
                 "--stats-json", str(stats_file), "--stats-every-s", "0.2"],
                stdout=fh, stderr=subprocess.STDOUT, cwd=repo, env=env)
        procs.append(verb)
        deadline = time.time() + 120
        while "serving on" not in open(verb_log).read():
            check(verb.poll() is None, "9c: federate exited:\n"
                  + open(verb_log).read()[-3000:])
            check(time.time() < deadline, "9c: federate never served")
            time.sleep(0.05)
        address = [ln for ln in open(verb_log).read().splitlines()
                   if "serving on" in ln][0].rsplit(" ", 1)[-1]
        go = cdir / "go"
        logs = [cdir / f"worker-{s}.log" for s in range(2)]
        round_procs = [_spawn_fed_worker(
            repo, env, logs[s], addr, cdir, s, 2, topic, gossip_topic,
            FED_EVENTS, data_plane="memory",
            extra=("--max-events", str(FED_EVENTS), "--idle-timeout-s", "10",
                   "--go-file", str(go))) for s in range(2)]
        procs += round_procs
        go.touch()
        _fed_wait(round_procs, logs, "9c", 300)
        deadline = time.time() + 60
        while True:
            doc = (json.loads(stats_file.read_text())
                   if stats_file.exists() else {})
            if (doc.get("events") == 2 * FED_EVENTS
                    and sorted(doc.get("workers", {})) == ["w0", "w1"]):
                break
            check(time.time() < deadline, f"9c: stats {doc}")
            time.sleep(0.1)
        time.sleep(0.5)  # the final full frames' fold and epoch
        oracle = oracles[2]
        qc = QueryClient(address, batch_max=1 << 16)
        try:
            check(bool(qc.bf_exists(oracle["roster"]).all()),
                  "9c: a roster id reads absent over the RPC")
            check(np.array_equal(qc.bf_exists(probe), oracle["k4"]),
                  "9c: BF.EXISTS of non-roster ids differs from K4 on the "
                  "K=2 oracle's filter")
            days = np.array(sorted(oracle["pfcount"]), np.int64)
            check(qc.pfcount(days).tolist()
                  == [oracle["pfcount"][int(d)] for d in days],
                  "9c: PFCOUNT over the RPC differs from the K=2 oracle")
            st = qc.stats()
        finally:
            qc.close()
        verb.send_signal(signal.SIGINT)
        check(verb.wait(timeout=60) == 0, "9c: federate exited "
              f"{verb.returncode}:\n" + open(verb_log).read()[-3000:])
        doc = json.loads(stats_file.read_text())
        check(doc["events"] == 2 * FED_EVENTS
              and sorted(doc["workers"]) == ["w0", "w1"]
              and doc["shard_map"]["owners"] == ["w0", "w1"],
              f"9c: final stats {doc}")
        print(f"federation (c) federate verb: served {address}; stats "
              f"{doc['events']} events from {sorted(doc['workers'])}, "
              f"{doc['folded_deltas']} deltas and {doc['folded_fulls']} fulls "
              f"folded; BF.EXISTS and PFCOUNT over the RPC equal to the K=2 "
              f"oracle; served stats epoch {st['epoch']}; wall "
              f"{time.perf_counter() - t_c} s")
        check(_build_files(repo) == built,
              "phase 9: a worker rebuilt a library")
        print(f"federation: no worker compiled ({len(built)} built files "
              "unchanged)")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        broker.kill()
        broker.wait()
        shutil.rmtree(work, ignore_errors=True)

    # -- 9d. B15: bloom_or_words on the card ---------------------------------
    a_np, b_np = oracles[2]["shard_words"]
    a = torch.from_numpy(a_np.view(np.int32)).to(dev)
    b = torch.from_numpy(b_np.view(np.int32)).to(dev)
    got = bloom.bloom_or_words(a, b).cpu().numpy().view(np.uint32)
    check(np.array_equal(got, bloom.bloom_or_words_np(a_np, b_np)),
          "B15: bloom_or_words on the card differs from the numpy twin")
    ms = kernel_ms(lambda: bloom.bloom_or_words(a, b))
    b_ms, b_by = bound_ms(3 * a.numel() * 4, a.numel())
    print(f"B15 bloom_or_words (PyTorch torch.bitwise_or, off the path) of "
          f"two {a.numel()}-word 100k-roster shard filters ms={ms} "
          f"bound_ms={b_ms} ({b_by}) times_bound={ms / b_ms} plain_ms={ms} "
          f"library_ms={ms} (the call is the library call) max_abs_err=0 on "
          f"{card}")
    print(f"federation phase: {time.perf_counter() - t_phase} s")
    return launches


# Phase 10: the mesh engine (parallel/) on virtual meshes of the one card.
MESH_ROSTER = 10_000_000  # BASELINE config #4
MESH_EVENTS, MESH_FRAME = 1 << 20, 1 << 17  # phase 3's stream shape
MESH_BANKS = 16  # word wire: 26 key bits + 5 bank bits; 256 banks: arrays
# 10(a)'s lanes a replica: (4, 2)'s share of a frame, a frame, 8 frames.
MESH_LANES = (65_536, 131_072, 1_048_576)
# 10(a)'s K11 preloads, (sp, dp); the JAX package's preload chunk, whose
# route (one launch a chunk and cell) 10(a) times beside the engine's on
# (4, 2); and the batch sizes, one either side of
# ``kernels.K11_BINNED_MIN_KEYS``, at which both K11 paths are timed.
MESH_PRELOADS = ((4, 2), (8, 1))
JAX_PRELOAD_CHUNK = 1 << 14
K11_CUTOVER_KEYS = (1 << 20, 1 << 22)
# (sp, dp, replica_sync, register banks, wire_format) of phase 10(c)'s
# pipeline runs: the default wire (auto, which stays on the word wire or
# the arrays step over 8 frames), then the (4, 2) query mesh on the seg
# and delta wires, each held against the (4, 2) query run on the word
# wire.
MESH_RUNS = ((4, 2, "query", MESH_BANKS, "auto"),
             (4, 2, "step", MESH_BANKS, "auto"),
             (8, 1, "query", 256, "auto"),
             (4, 2, "query", MESH_BANKS, "seg"),
             (4, 2, "query", MESH_BANKS, "delta"))
MESH_KERNELS = ("bloom_contains_slice", "hll_add_slice", "bloom_add_slice",
                "hll_histogram")


def mesh_slices(words: torch.Tensor, params, sp: int):
    """The mesh engine's cut of a filter: sp contiguous slices of whole
    blocks, the allocation padded to sp x 512 bits with zeros; returns
    (slices, words a slice)."""
    chunk = sp * 512
    m_words = -(-params.m_bits // chunk) * chunk // 32
    padded = torch.zeros(m_words, dtype=torch.int32, device=words.device)
    padded[:words.shape[0]] = words
    wl = m_words // sp
    return [padded[s * wl:(s + 1) * wl].clone() for s in range(sp)], wl


def _k11_bound(params, keys: torch.Tensor, first_word: int, wl: int):
    """(bound ms, by) of K11 for ``keys`` into the slice of ``wl`` words
    at ``first_word``: 4 bytes a key and a read and a write of every word
    its keys touch; the block hash of every key, the probes of its
    own."""
    from attendance_tpu_torch.models import bloom
    rel = bloom.bloom_positions(keys, params) - first_word * 32
    mine = (rel[:, 0] >= 0) & (rel[:, 0] < wl * 32)
    touched = int(torch.unique(rel[mine] >> 5).numel())
    return bound_ms(4 * keys.numel() + 8 * touched,
                    keys.numel() * 25 + int(mine.sum()) * (40 + 5 * params.k))


def mesh_k11(floor_ms: float, rows: dict, params, roster: torch.Tensor,
             words: torch.Tensor) -> None:
    """10(a)'s K11: replica g's whole share ``roster[g * n // dp:(g + 1) *
    n // dp]`` into each slice, as the engine sends it, at (4, 2) and
    (8, 1): both paths equal to the plain version on every slice, the
    replicas' OR equal to K3's filter cut; then the preload's device time
    (every cell) by the engine's route, one launch a cell, on (4, 2)
    beside the route of one per-key launch a 2^14-key chunk and cell,
    and one cell's time by each path beside its bound; then both paths
    on slice 0 of 4 and of 8 either side of the cut-over."""
    from attendance_tpu_torch.ops import kernels

    n = roster.numel()
    for sp, dp in MESH_PRELOADS:
        cut, wl = mesh_slices(words, params, sp)
        shares = [roster[g * n // dp:(g + 1) * n // dp] for g in range(dp)]
        cells = [(g, s) for g in range(dp) for s in range(sp)]
        for s in range(sp):
            union = {True: torch.zeros_like(cut[s]),
                     False: torch.zeros_like(cut[s])}
            for g in range(dp):
                want = torch.zeros_like(cut[s])
                kernels.bloom_add_slice_plain(want, shares[g], params, s * wl)
                for binned in (True, False):
                    got = torch.zeros_like(cut[s])
                    kernels.bloom_add_slice(got, shares[g], params,
                                            first_word=s * wl, binned=binned)
                    torch.cuda.synchronize()
                    err = int((got != want).sum())
                    check(err == 0, f"K11 binned={binned} ({sp}, {dp}) "
                          f"replica {g}'s share, slice {s}: {err} words "
                          "differ")
                    union[binned] |= got
            for binned, got in union.items():
                check(torch.equal(got, cut[s]), f"K11 binned={binned} "
                      f"({sp}, {dp}) slice {s}: the OR across dp is not "
                      "K3's filter")
        # The whole preload's device time: the engine's route (one launch
        # a cell), and on (4, 2) the chunk route (the roster padded with
        # its first key to whole chunks rounded up to dp; replica g adds
        # the g-th dp-th of each chunk, one per-key launch a chunk and
        # cell).
        chunk = -(-JAX_PRELOAD_CHUNK // dp) * dp
        local = chunk // dp
        pieces = torch.cat([roster, roster[:1].expand((-n) % chunk)]
                           ).view(-1, chunk)
        chunk_launches = pieces.shape[0] * len(cells)
        bufs = [torch.zeros_like(cut[0]) for _ in cells]

        def zero():
            for b in bufs:
                b.zero_()

        def engine_route(binned=None):
            zero()
            for (g, s), b in zip(cells, bufs):
                kernels.bloom_add_slice(b, shares[g], params,
                                        first_word=s * wl, binned=binned)

        def chunk_route():
            zero()
            for c in range(pieces.shape[0]):
                for (g, s), b in zip(cells, bufs):
                    kernels.bloom_add_slice(
                        b, pieces[c, g * local:(g + 1) * local], params,
                        first_word=s * wl, binned=False)

        def held(what):
            torch.cuda.synchronize()
            for s in range(sp):
                got = bufs[s].clone()
                for g in range(1, dp):
                    got |= bufs[g * sp + s]
                check(torch.equal(got, cut[s]), f"K11 ({sp}, {dp}) {what}: "
                      f"slice {s}'s OR across dp is not K3's filter")

        zero_ms = kernel_ms(zero, reps=1)
        engine_ms = kernel_ms(engine_route, reps=1) - zero_ms
        held("engine")
        kernels.reset_launches()
        engine_route()
        one_launches = kernels.launches["bloom_add_slice"]
        held("engine")
        b_ms = sum(_k11_bound(params, shares[g], s * wl, wl)[0]
                   for g, s in cells)
        print(f"K11 bloom_add_slice ({sp}, {dp}) preload of the "
              f"{MESH_ROSTER}-key roster, device time of every cell: one "
              f"launch a cell over its replica's share ({one_launches} "
              f"launches) ms={engine_ms}; bound_ms={b_ms} (bytes, the "
              f"cells' sum); launch floor x launches "
              f"{floor_ms * one_launches}; equal to K3's filter cut")
        if (sp, dp) == (4, 2):
            chunks_ms = kernel_ms(chunk_route, reps=1) - zero_ms
            held("chunks")
            print(f"K11 bloom_add_slice ({sp}, {dp}) the chunk route "
                  f"({chunk_launches} launches of {local} keys) ms="
                  f"{chunks_ms}; launch floor x launches "
                  f"{floor_ms * chunk_launches}; equal to K3's filter cut")
        # One cell, (0, 0), by each path, into a zeroed slice.
        a = torch.zeros_like(cut[0])
        want = torch.zeros_like(cut[0])
        kernels.bloom_add_slice_plain(want, shares[0], params, 0)
        one_zero_ms = kernel_ms(lambda: a.zero_())
        b_ms, b_by = _k11_bound(params, shares[0], 0, wl)
        picked = shares[0].numel() >= kernels.K11_BINNED_MIN_KEYS
        for binned in (True, False):
            ms = kernel_ms(lambda: (a.zero_(), kernels.bloom_add_slice(
                a, shares[0], params, first_word=0, binned=binned))
            ) - one_zero_ms
            torch.cuda.synchronize()
            check(torch.equal(a, want), f"K11 binned={binned} ({sp}, {dp}): "
                  "the timed adds differ")
            plain_ms = eager_ms(lambda: kernels.bloom_add_slice_plain(
                a, shares[0], params, 0), 3)
            print(f"K11 bloom_add_slice binned={binned} (picked: "
                  f"{binned == picked}) ({sp}, {dp}) keys="
                  f"{shares[0].numel()} (replica 0's share) slice 0 of {sp} "
                  f"({wl // 16} blocks) into a zeroed slice ms={ms} "
                  f"above_floor_ms={ms - floor_ms} plain_ms={plain_ms} "
                  f"bound_ms={b_ms} ({b_by}) times_bound={ms / b_ms} "
                  "max_abs_err=0")
            if (sp, dp) == (4, 2) and binned == picked:
                rows["bloom_add_slice"] = dict(
                    replaces="attendance_tpu/parallel/sharded.py:323",
                    max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    # Both paths on slice 0 of 4 and of 8, either side of the cut-over.
    for sp in (4, 8):
        cut, wl = mesh_slices(words, params, sp)
        a = torch.zeros_like(cut[0])
        one_zero_ms = kernel_ms(lambda: a.zero_())
        line = []
        for keys_n in K11_CUTOVER_KEYS:
            keys = roster[:keys_n]
            want = torch.zeros_like(a)
            kernels.bloom_add_slice_plain(want, keys, params, 0)
            ms = {}
            for binned in (True, False):
                ms[binned] = kernel_ms(lambda: (
                    a.zero_(), kernels.bloom_add_slice(
                        a, keys, params, first_word=0, binned=binned))
                ) - one_zero_ms
                torch.cuda.synchronize()
                check(torch.equal(a, want), f"K11 binned={binned} at "
                      f"{keys_n} keys into slice 0 of {sp} differs from the "
                      "plain version")
            line.append(f"{keys_n} ({keys_n // sp} in the slice): binned "
                        f"{ms[True]} per-key {ms[False]}")
        print(f"K11 cut-over, slice 0 of {sp} of the {MESH_ROSTER}-key "
              f"filter, into a zeroed slice, ms by keys: {'; '.join(line)}; "
              f"the wrapper bins from {kernels.K11_BINNED_MIN_KEYS} keys")


def mesh_k10(floor_ms: float, rows: dict, keys, banks, wire, kw: int,
             valid, regs_slices, lanes: int) -> None:
    """10(a)'s K10 at ``lanes`` lanes: K10 on every slice and both
    wires, equal to its plain version (the counters on slice 0, started
    just under the 2^32 wrap of their low lane); then K10 timed on both
    wires, with the counters (slice 0) and without (slice 1), replayed
    (the registers already hold the ranks) and from the starting
    registers, each held after its replays (registers equal to one plain
    add, counters to the start plus one add's counts per run)."""
    from attendance_tpu_torch.models import fused, hll
    from attendance_tpu_torch.ops import kernels

    sp = len(regs_slices)
    rl = regs_slices[0].shape[1]
    dev = keys.device
    start = torch.tensor([[0xFFFFFF00 - (1 << 32), 1], [5, 0]],
                         dtype=torch.int32, device=dev)
    for s in range(sp):
        for what, lane_t, bits in (("words", wire, kw), ("arrays", keys, 0)):
            a, b = regs_slices[s].clone(), regs_slices[s].clone()
            ca, cb = ((start.clone(), start.clone()) if s == 0
                      else (None, None))
            kernels.hll_add_slice(a, lane_t, valid, lo=s * rl, bank=banks,
                                  key_bits=bits, n_real=lanes, counts=ca)
            kernels.hll_add_slice_plain(b, lane_t, valid, s * rl, 14, banks,
                                        bits, lanes, cb)
            torch.cuda.synchronize()
            err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
            check(err == 0 and (ca is None or torch.equal(ca, cb)),
                  f"K10 {what} lanes={lanes} slice {s}: register max abs "
                  f"err {err} or counters differ")
    bucket, rank = hll.hll_bucket_rank(keys, 14)
    base = fused.decode_counts(start)
    for s in (0, 1):
        lo = s * rl
        kept = valid.to(torch.bool) & (bucket >= lo) & (bucket < lo + rl)
        flat = (banks.to(torch.int64) * rl + bucket - lo)[kept]
        distinct = int(torch.unique(flat).numel())
        for what, lane_t, bits, lane_bytes in (("words", wire, kw, 5),
                                               ("arrays", keys, 0, 9)):
            b_ms, b_by = bound_ms(lane_bytes * lanes + 2 * distinct
                                  + (32 if s == 0 else 0),
                                  lanes * 50 + int(kept.sum()) * 10)
            want = regs_slices[s].clone()
            cw = start.clone() if s == 0 else None
            kernels.hll_add_slice_plain(want, lane_t, valid, lo, 14, banks,
                                        bits, lanes, cw)
            one = (None if cw is None else [w - b0 for w, b0 in zip(
                fused.decode_counts(cw), base)])
            a = regs_slices[s].clone()
            ca = None if cw is None else start.clone()

            def add():
                kernels.hll_add_slice(a, lane_t, valid, lo=lo, bank=banks,
                                      key_bits=bits, n_real=lanes, counts=ca)

            replayed = kernel_ms(add)
            restore_ms = kernel_ms(lambda: a.copy_(regs_slices[s]))
            fresh = kernel_ms(lambda: (
                a.copy_(regs_slices[s]), add())) - restore_ms
            torch.cuda.synchronize()
            runs = 2 * graph_runs()
            check(torch.equal(a, want) and (ca is None or list(
                fused.decode_counts(ca)) == [b0 + runs * d for b0, d
                                             in zip(base, one)]),
                  f"K10 {what} lanes={lanes} slice {s}: the timed adds "
                  "differ from the plain version")
            if s == 0 and what == "words" and lanes == 131_072:
                plain_ms = eager_ms(lambda: kernels.hll_add_slice_plain(
                    want.clone(), lane_t, valid, 0, 14, None, bits, lanes,
                    start.clone()))
                lib = regs_slices[0].clone().view(-1)
                library_ms = eager_ms(lambda: lib.scatter_reduce_(
                    0, flat, rank[kept].to(torch.uint8), reduce="amax"), 20)
                check(torch.equal(lib.view_as(a), a), f"K10 lanes={lanes} "
                      "disagrees with scatter_reduce_(amax)")
                rows["hll_add_slice"] = dict(
                    replaces="attendance_tpu/parallel/sharded.py:342",
                    max_abs_err=0, ms=replayed, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
                print(f"K10 lanes={lanes} plain_ms={plain_ms} "
                      f"scatter_reduce_amax_uint8_ms={library_ms} (the "
                      "register half)")
            print(f"K10 hll_add_slice {what} lanes={lanes} slice {s} of {sp} "
                  f"[{regs_slices[s].shape[0]}, {rl}] "
                  f"{'with' if s == 0 else 'without'} the counters "
                  f"kept={int(kept.sum())} distinct_registers={distinct} "
                  f"ms replayed={replayed} from_the_start={fresh} "
                  f"bound_ms={b_ms} ({b_by}) floor_ms={floor_ms} "
                  "max_abs_err=0")


# 10(a)'s K9 shapes: slice 0 of sp = 2 (the direct path), 4 and 8 (the
# compact path).
K9_SPS = (2, 4, 8)


def mesh_k9(floor_ms: float, rows: dict, params, words, lanes_np) -> None:
    """10(a)'s K9 on sp = 2, 4 and 8 slices of the 10M filter, at 65,536,
    131,072 and 1,048,576 lanes, on keys and on the word wire: both paths
    (direct, compact) and the wrapper's pick equal to the plain version on
    every slice, the AND across the slices equal to K4 on the whole
    filter; then on slice 0 both paths timed (replayed, the picked path
    twice: the in-call spread) beside the bound, the floor and the plain
    version."""
    from attendance_tpu_torch.models import bloom, fused
    from attendance_tpu_torch.ops import kernels

    dev = words.device
    for sp in K9_SPS:
        slices, wl = mesh_slices(words, params, sp)
        for lanes in MESH_LANES:
            keys_np = lanes_np["keys"][:lanes]
            keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
            kw = int(keys_np.max()).bit_length()
            wire = torch.from_numpy(fused.pack_words(
                keys_np, lanes_np["banks"][:lanes], kw, lanes).view(
                    np.int32)).to(dev)
            blocks = bloom.bloom_positions(keys, params)[:, 0] >> 9
            mine = blocks < wl // 16
            n_mine = int(mine.sum())
            b_ms, b_by = bound_ms(
                5 * lanes + 64 * int(torch.unique(blocks[mine]).numel()),
                lanes * 25 + n_mine * (40 + 5 * params.k))
            whole = bloom.bloom_contains_words(words, keys, params)
            for what, lane_t, bits in (("keys", keys, 0),
                                       ("words", wire, kw)):
                every = None
                for s in range(sp):
                    want = kernels.bloom_contains_slice_plain(
                        slices[s], lane_t, params, s * wl, bits)
                    for compact in (None, False, True):
                        got = kernels.bloom_contains_slice(
                            slices[s], lane_t, params, first_word=s * wl,
                            key_bits=bits, compact=compact)
                        torch.cuda.synchronize()
                        err = int((got != want).sum())
                        check(err == 0, f"K9 {what} lanes={lanes} sp={sp} "
                              f"slice {s} compact={compact}: {err} answers "
                              "differ")
                        if compact is None:
                            every = got if every is None else every & got
                check(torch.equal(every.to(torch.bool), whole),
                      f"K9 {what} lanes={lanes} sp={sp}: the AND across "
                      "slices is not K4's answer")
                picked = 2 * (wl // 16) < params.m_bits // 512
                times = {}
                for compact in (picked, not picked, picked):
                    times.setdefault(compact, []).append(kernel_ms(
                        lambda c=compact: kernels.bloom_contains_slice(
                            slices[0], lane_t, params, first_word=0,
                            key_bits=bits, compact=c)))
                ms = times[picked][0]
                plain_ms = eager_ms(
                    lambda: kernels.bloom_contains_slice_plain(
                        slices[0], lane_t, params, 0, bits))
                direct, compact_ms = times[False][0], times[True][0]
                print(f"K9 bloom_contains_slice {what} lanes={lanes} slice 0 "
                      f"of {sp} (roster {MESH_ROSTER}) keys in slice "
                      f"{n_mine} picked={'compact' if picked else 'direct'} "
                      f"ms={ms} again_ms={times[picked][1]} direct_ms="
                      f"{direct} compact_ms={compact_ms} compact_vs_direct="
                      f"{compact_ms / direct} above_floor_ms={ms - floor_ms} "
                      f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) "
                      f"times_bound={ms / b_ms} floor_ms={floor_ms} "
                      f"library_ms=None max_abs_err=0")
                if sp == 4 and lanes == 131_072 and what == "words":
                    rows["bloom_contains_slice"] = dict(
                        replaces="attendance_tpu/parallel/sharded.py:304",
                        max_abs_err=0, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)


def k12_shapes():
    """10(a)'s K12 shapes, (lanes, header banks, real lanes): the mesh's
    lanes a replica under its 16-bank header, all real; either side of
    K12-seg's cut-over (``kernels.K12_SEG_WIDE_MIN_LANES``); and either
    side of K12-delta's (``kernels.K12_LOOKBACK_MIN_LANES``) under the
    headers where the plan keeps the two-pass design below it (256 banks:
    the (8, 1) run's register rows; one bank), a seventh of the lanes
    padding, the frames for which it keeps it."""
    from attendance_tpu_torch.ops import kernels

    seg_cut = kernels.K12_SEG_WIDE_MIN_LANES
    cut = kernels.K12_LOOKBACK_MIN_LANES
    out = [(lanes, MESH_BANKS, lanes)
           for lanes in (*MESH_LANES, seg_cut - 1, seg_cut)]
    for nb in (256, 1):
        out += [(lanes, nb, lanes - lanes // 7)
                for lanes in (MESH_LANES[0], cut - 1, cut)]
    return out


def k12_variants(mode: str):
    """The K12 designs built for ``mode``, as the keyword arguments that
    force each: K12-seg has one (its lanes a thread follow the frame's
    lanes), K12-delta the look-back and the two-pass."""
    from attendance_tpu_torch.ops import kernels

    if mode == "seg":
        return [{}]
    return [dict(design=d) for d in kernels.K12_DELTA_DESIGNS]


# 10(a): K12-delta's calls traced in a process of their own (a profiler
# started here would be this process's first, which phase 14(c) expects
# to start itself). argv: the wire's int32 file, db, lanes,
# header banks, calls; prints {kernel function: device kernel events}.
_K12_TRACE = """
import json, sys, tempfile
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
from attendance_tpu_torch.ops import kernels
from attendance_tpu_torch.utils.profiling import kernel_events, kernel_function
db, lanes, nb, calls = map(int, sys.argv[2:6])
wire = torch.from_numpy(np.fromfile(sys.argv[1], np.int32)).cuda()
run = lambda: kernels.decode_delta(wire, db=db, padded=lanes, num_banks=nb)
run()
torch.cuda.synchronize()
with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
    for _ in range(calls):
        run()
    torch.cuda.synchronize()
with tempfile.TemporaryDirectory() as tmp:
    p.export_chrome_trace(tmp + "/trace.json")
    doc = json.load(open(tmp + "/trace.json"))
seen = {}
for e in kernel_events(doc):
    fn = kernel_function(e.get("name", ""))
    seen[fn] = seen.get(fn, 0) + 1
print(json.dumps(seen))
"""


def k12_trace_events(wire, db: int, lanes: int, nb: int,
                     calls: int = 8) -> dict:
    """{kernel function: device kernel events} of ``calls`` K12-delta calls
    on ``wire`` in a torch.profiler trace, taken in a child process."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wire.i32")
        wire.cpu().numpy().tofile(path)
        out = subprocess.run(
            [sys.executable, "-c", _K12_TRACE, path, str(db), str(lanes),
             str(nb), str(calls)], capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=os.getcwd()))
    check(out.returncode == 0, f"K12 trace: the child failed: "
          f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def mesh_k12(floor_ms: float, rows: dict, lanes_np, dev) -> None:
    """10(a)'s K12: a replica's lanes of the mesh stream on the seg and on
    the delta wire at the shapes of ``k12_shapes`` (65,536 lanes is what a
    (4, 2) replica takes of a 131,072-event frame, phase 10(c)): each
    design built (K12-delta's look-back and two-pass; the plan's pick
    marked) equal to the plain decode and to the frame's lanes, timed
    beside the bound (the wire read once, 8 bytes a lane written), the
    floor, the plain version and phase 2c's decode yardsticks
    (``torch.searchsorted``, ``torch.cumsum``: not K12's function, so no
    library time); then K12-delta's kernel events a call in a
    torch.profiler trace at 65,536 lanes (one: a single launch)."""
    from attendance_tpu_torch.models import fused
    from attendance_tpu_torch.ops import kernels

    for lanes, nb, real in k12_shapes():
        keys_np = np.asarray(lanes_np["keys"][:real], np.uint32)
        banks_np = (lanes_np["banks"][:real] if nb > 1
                    else np.zeros(real, np.int32))  # one bank: every day
        for mode in ("seg", "delta"):
            if mode == "seg":
                width = int(keys_np.max()).bit_length()
                buf, perm = fused.pack_seg(keys_np, banks_np, width, lanes,
                                           nb)
            else:
                scan = fused.delta_scan(keys_np, banks_np, nb)
                width = fused.pick_delta_width(1, scan[4])
                buf, perm = fused.pack_delta(keys_np, banks_np, width, lanes,
                                             nb, scan=scan)
            wire = torch.from_numpy(buf.view(np.int32)).to(dev)
            decode = kernels.decode_seg if mode == "seg" else \
                kernels.decode_delta
            plain = kernels.decode_seg_lanes_plain if mode == "seg" else \
                kernels.decode_delta_lanes_plain
            kw = {"kb" if mode == "seg" else "db": width}
            want_k, want_b = plain(wire, width, lanes, nb)
            if mode == "seg":
                pick = dict(lanes_per_thread=kernels.
                            k12_seg_lanes_per_thread(lanes))
            else:
                pick = dict(design=kernels.decode_delta_plan(
                    lanes, nb).design)
            print(f"K12 decode_{mode} lanes={lanes} banks={nb} real={real}: "
                  f"the plan picks {pick}")
            plain_ms = eager_ms(lambda: plain(wire, width, lanes, nb))
            yard = decode_yardstick(wire, mode, width, lanes, nb)
            # About 10 integer operations a lane (a field's funnel shift
            # and mask, the bank, the stores): the bytes bind.
            b_ms, b_by = bound_ms(4 * wire.numel() + 8 * lanes, lanes * 10)
            for shape in k12_variants(mode):
                got_k, got_b = decode(wire, padded=lanes, num_banks=nb,
                                      **kw, **shape)
                torch.cuda.synchronize()
                what = " ".join(f"{k}={v}" for k, v in {**pick, **shape}
                                .items())
                check(torch.equal(got_k.to(torch.int64) & 0xFFFFFFFF, want_k)
                      and torch.equal(got_b.to(torch.int64), want_b),
                      f"K12-{mode} {what} lanes={lanes}: differs from the "
                      "plain decode")
                check(np.array_equal(got_k[:real].cpu().numpy().view(
                          np.uint32), keys_np[perm])
                      and np.array_equal(got_b[:real].cpu().numpy(),
                                         banks_np[perm])
                      and bool((got_b[real:] == -1).all()),
                      f"K12-{mode} {what} lanes={lanes}: lanes are not the "
                      "frame's")
                ms = kernel_ms(lambda: decode(wire, padded=lanes,
                                              num_banks=nb, **kw, **shape))
                picked = mode == "seg" or shape == pick
                print(f"K12 decode_{mode} {what}{' (plan)' if picked else ''}"
                      f" lanes={lanes} banks={nb} real={real} width={width} "
                      f"ms={ms} "
                      f"above_floor_ms={ms - floor_ms} plain_ms={plain_ms} "
                      f"bound_ms={b_ms} ({b_by}) times_bound={ms / b_ms} "
                      f"floor_ms={floor_ms} yardsticks: {yard} "
                      f"library_ms=None max_abs_err=0")
                if lanes == MESH_LANES[0] and nb == MESH_BANKS and picked:
                    rows[f"decode_{mode}"] = dict(
                        replaces=("attendance_tpu/models/fused.py:292"
                                  if mode == "seg" else
                                  "attendance_tpu/models/fused.py:416")
                        + " (in attendance_tpu/parallel/sharded.py:446)",
                        max_abs_err=0, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
            if mode == "delta" and lanes == MESH_LANES[0] and \
                    nb == MESH_BANKS:
                calls = 8
                seen = k12_trace_events(wire, width, lanes, nb, calls)
                mine = {fn: n for fn, n in seen.items()
                        if fn in kernels.KERNEL_FUNCTIONS["decode_delta"]}
                print(f"K12 decode_delta lanes={lanes} plan={pick}: kernel "
                      f"events in a torch.profiler trace of {calls} calls: "
                      f"{mine}")
                if seen:
                    check(sum(mine.values()) == calls,
                          f"K12-delta at {lanes} lanes: {mine} kernel events "
                          f"for {calls} calls, not one a call")
    for mode in ("seg", "delta"):
        check(f"decode_{mode}" in rows,
              f"K12-{mode}: the plan's pick was not timed at "
              f"{MESH_LANES[0]} lanes")


def mesh_kernels(dev, floor_ms: float, rows: dict, roster_np, lanes_np):
    """Phase 10(a): K11 at the shapes the engine sends (a replica's whole
    share of the 10M roster into each slice, (4, 2) and (8, 1)), binned
    and one thread per key, on (4, 2) beside the route of one launch per
    2^14-key chunk, and both paths either side of the cut-over; K10
    (both wires, with and without the counters, replayed and from the
    starting registers), K9 (both paths, on slices of sp = 2, 4 and 8,
    keys and the word wire) at 65,536, 131,072 and 1,048,576 lanes a
    replica and K12 (seg and delta) there and either side of its plans'
    cut-overs; K1 on register slices [256, 2^14 /
    sp] (sp = 2, 4, 8); each equal to its plain version, timed beside
    its bound, the floor, the plain version and (K10's register half,
    K1) a library call or (K12) the decode's yardsticks."""
    from attendance_tpu_torch.models import bloom, fused, hll
    from attendance_tpu_torch.ops import kernels

    sp, dp = 4, 2  # the phase's (4, 2) mesh
    params = bloom.derive_bloom_params(MESH_ROSTER, 0.01, "blocked")
    roster = torch.from_numpy(roster_np.view(np.int32)).to(dev)
    words = bloom.bloom_packed_init(params, dev)
    kernels.bloom_add(words, roster, params)
    slices, wl = mesh_slices(words, params, sp)
    rl = (1 << 14) // sp
    rng = np.random.default_rng(10)
    mesh_k11(floor_ms, rows, params, roster, words)

    # K9 (plain keys and the word wire) and K10 on both wires.
    regs = hll.hll_init(MESH_BANKS, 14, dev)
    hll.hll_add(regs, torch.from_numpy(rng.integers(
        0, MESH_BANKS, 1 << 20, dtype=np.int32)).to(dev), torch.from_numpy(
        rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev), precision=14)
    regs_slices = [regs[:, s * rl:(s + 1) * rl].contiguous()
                   for s in range(sp)]
    for lanes in MESH_LANES:
        keys_np = lanes_np["keys"][:lanes]
        banks_np = lanes_np["banks"][:lanes]
        keys = torch.from_numpy(keys_np.view(np.int32)).to(dev)
        banks = torch.from_numpy(banks_np).to(dev)
        kw = int(keys_np.max()).bit_length()
        wire = torch.from_numpy(fused.pack_words(
            keys_np, banks_np, kw, lanes).view(np.int32)).to(dev)
        valid = None
        for s in range(sp):
            for what, lane_t, bits in (("keys", keys, 0),
                                       ("words", wire, kw)):
                got = kernels.bloom_contains_slice(
                    slices[s], lane_t, params, first_word=s * wl,
                    key_bits=bits)
                want = kernels.bloom_contains_slice_plain(
                    slices[s], lane_t, params, s * wl, bits)
                torch.cuda.synchronize()
                err = int((got != want).sum())
                check(err == 0, f"K9 {what} lanes={lanes} slice {s}: {err} "
                      "answers differ")
            valid = got if valid is None else valid & got
        whole = bloom.bloom_contains_words(words, keys, params)
        check(torch.equal(valid.to(torch.bool), whole),
              f"K9 lanes={lanes}: the AND across slices is not K4's answer")
        mesh_k10(floor_ms, rows, keys, banks, wire, kw, valid, regs_slices,
                 lanes)
    mesh_k9(floor_ms, rows, params, words, lanes_np)
    mesh_k12(floor_ms, rows, lanes_np, dev)

    # K1 on register slices of 256 filled banks.
    big = hll.hll_init(256, 14, dev)
    hll.hll_add(big, torch.from_numpy(rng.integers(
        0, 256, 1 << 22, dtype=np.int32)).to(dev), torch.from_numpy(
        rng.integers(0, 1 << 32, 1 << 22, dtype=np.uint64).astype(
            np.uint32).view(np.int32)).to(dev), precision=14)
    for sps in (2, 4, 8):
        w = (1 << 14) // sps
        part = big[:, :w].contiguous()
        got = kernels.hll_histogram(part, 14)
        want = hll.hll_histogram(part, 14)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        check(err == 0, f"K1 on a [256, {w}] slice: max abs err {err}")
        total = sum(kernels.hll_histogram(
            big[:, s * w:(s + 1) * w].contiguous(), 14) for s in range(sps))
        check(torch.equal(total, kernels.hll_histogram(big, 14)),
              f"K1: the {sps} slices' histograms do not sum to the banks'")
        bins = got.shape[1]
        offsets = (part.to(torch.int64) + torch.arange(
            256, device=dev)[:, None] * bins).view(-1)
        check(torch.equal(torch.bincount(offsets, minlength=256 * bins)
                          .view(256, bins).to(torch.int32), got),
              f"K1 slice sp={sps} disagrees with torch.bincount")
        ms = kernel_ms(lambda: kernels.hll_histogram(part, 14))
        plain_ms = eager_ms(lambda: hll.hll_histogram(part, 14))
        library_ms = eager_ms(lambda: torch.bincount(
            offsets, minlength=256 * bins), 20)
        b_ms, b_by = bound_ms(part.numel() + got.numel() * 4, part.numel())
        print(f"K1 hll_histogram on a slice [256, {w}] (sp={sps}) ms={ms} "
              f"above_floor_ms={ms - floor_ms} plain_ms={plain_ms} "
              f"bincount_ms={library_ms} bound_ms={b_ms} ({b_by}) "
              f"times_bound={ms / b_ms} max_abs_err={err}")


def _mesh_ref_state(pipe, banks: int):
    """(counters, PFCOUNTs, live registers, stored validity, bank map) of
    a pipeline on one card or a mesh."""
    if pipe.engine is not None:
        regs = pipe.engine.get_state()[1]
    else:
        regs = pipe.state.hll_regs.cpu().numpy()
    return (pipe.validity_counts(),
            {str(d): n for d, n in sorted(pipe.count_all().items())},
            regs[:banks], pipe.store.to_columns(deduplicate=False)[
                "is_valid"], dict(pipe._bank_of))


def _mesh_check_same(what: str, got, want) -> None:
    check(got[0] == want[0], f"{what}: counters {got[0]} != {want[0]}")
    check(got[1] == want[1], f"{what}: PFCOUNTs differ")
    check(np.array_equal(got[2], want[2]), f"{what}: registers differ")
    check(np.array_equal(got[3], want[3]), f"{what}: stored validity "
          "differs")
    check(got[4] == want[4], f"{what}: bank map differs")


def mesh_phase(card: str, dev, floor_ms: float, rows: dict, ref,
               default_stream) -> dict:
    """Phase 10: (a) the mesh kernels; (b) the 1 x 1 mesh equal to phase
    3's default run; (c) the 10M roster on virtual meshes of the card,
    equal to one card; (d) a crash on one mesh shape resumed on another
    and restored on one card; (e) two processes sharing the card over
    gloo. Returns (c)'s mesh runs' launches."""
    import os
    import socket
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models.bloom import bloom_packed_set_bits
    from attendance_tpu_torch.models.fused import (
        delta_scan, pack_delta, pack_seg, pack_words, pick_delta_width)
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.parallel import ShardedSketchEngine, make_mesh
    from attendance_tpu_torch.pipeline.events import decode_planar_batch
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    roster, frames = generate_frames(MESH_EVENTS, MESH_FRAME,
                                     roster_size=MESH_ROSTER,
                                     num_lectures=16, seed=0)
    frames = list(frames)
    cols = [decode_planar_batch(f) for f in frames]
    truth = np.concatenate([c["is_valid"] for c in cols])
    sid = np.concatenate([c["student_id"] for c in cols])
    day = np.concatenate([c["lecture_day"] for c in cols])
    exact = {d: len(np.unique(sid[(day == d) & truth]))
             for d in np.unique(day).tolist()}
    print(f"mesh phase: the 10M stream made in {time.perf_counter() - t0} s")

    # -- 10a. the kernels ----------------------------------------------------
    day_bank = {d: i for i, d in enumerate(sorted(exact))}
    mesh_kernels(dev, floor_ms, rows, roster, dict(
        keys=sid, banks=np.array([day_bank[d] for d in day.tolist()],
                                 np.int32)))

    # -- 10b. the 1 x 1 mesh on phase 3's default stream ---------------------
    d_roster, d_frames = default_stream
    d_frames = list(d_frames)
    kernels.reset_launches()
    eng = ShardedSketchEngine(make_mesh(1, 1, [dev]), capacity=100_000,
                              error_rate=0.01, num_banks=256)
    eng.preload(d_roster)
    bank_of, valid = {}, []
    for f in d_frames:
        c = decode_planar_batch(f)
        for d in np.unique(c["lecture_day"]).tolist():
            bank_of.setdefault(d, len(bank_of))
        banks = np.array([bank_of[d] for d in c["lecture_day"].tolist()],
                         np.int32)
        n = len(c["student_id"])
        kw = int(c["student_id"].max()).bit_length()
        valid.append(eng.step_words(pack_words(
            c["student_id"], banks, kw, eng.padded_size(n)), n, kw))
    got = (eng.validity_counts(),
           {str(d): eng.count(b) for d, b in sorted(bank_of.items())},
           eng.get_state()[1], torch.cat(valid).cpu().numpy())
    b_launches = {k: v for k, v in kernels.launches.items() if v}
    check(got[0] == ref[0], f"10b: counters {got[0]} != phase 3's {ref[0]}")
    check(got[1] == ref[1], "10b: PFCOUNTs differ from phase 3's")
    check(np.array_equal(got[2], ref[2].cpu().numpy()),
          "10b: registers differ from phase 3's")
    check(np.array_equal(got[3], ref[3]), "10b: validity differs")
    check(set(b_launches) == {"bloom_add", "fused_step", "hll_histogram"}
          and b_launches["bloom_add"] == 1,
          f"10b: the 1 x 1 mesh launched {b_launches} (K3 once: one call "
          "over the whole roster)")
    print(f"mesh (b) 1 x 1 mesh, phase 3's default stream through "
          f"ShardedSketchEngine.step_words: counters {got[0]}, PFCOUNTs, "
          f"registers and validity equal to phase 3's default run; "
          f"launches {b_launches}")
    # The same through step_narrow on the seg and delta wires (K2-seg,
    # K2-delta on the 1 x 1 mesh), validity scattered back to original
    # order by each frame's pack permutation.
    for mode in ("seg", "delta"):
        kernels.reset_launches()
        eng = ShardedSketchEngine(make_mesh(1, 1, [dev]), capacity=100_000,
                                  error_rate=0.01, num_banks=256)
        eng.preload(d_roster)
        valid = []
        for f in d_frames:
            c = decode_planar_batch(f)
            sid_f = np.asarray(c["student_id"], np.uint32)
            banks = np.array([bank_of[d] for d in c["lecture_day"].tolist()],
                             np.int32)
            n = len(sid_f)
            padded = eng.padded_size(n)
            if mode == "seg":
                width = int(sid_f.max()).bit_length()
                buf, perm = pack_seg(sid_f, banks, width, padded, 256)
            else:
                scan = delta_scan(sid_f, banks, 256)
                width = pick_delta_width(1, scan[4])
                buf, perm = pack_delta(sid_f, banks, width, padded, 256,
                                       scan=scan)
            v = eng.step_narrow(buf[None], mode, width, padded).cpu().numpy()
            out = np.empty(n, bool)
            out[perm] = v[:n]
            valid.append(out)
        got_n = (eng.validity_counts(),
                 {str(d): eng.count(b) for d, b in sorted(bank_of.items())},
                 eng.get_state()[1], np.concatenate(valid))
        n_launches = {k: v for k, v in kernels.launches.items() if v}
        check(got_n[0] == ref[0] and got_n[1] == ref[1]
              and np.array_equal(got_n[2], ref[2].cpu().numpy())
              and np.array_equal(got_n[3], ref[3]),
              f"10b {mode}: the 1 x 1 mesh's step_narrow differs from phase "
              "3's default run")
        check(set(n_launches) == {"bloom_add", f"fused_step_{mode}",
                                  "hll_histogram"}
              and n_launches[f"fused_step_{mode}"] == len(d_frames),
              f"10b {mode}: the 1 x 1 mesh launched {n_launches}")
        print(f"mesh (b) 1 x 1 mesh, phase 3's default stream through "
              f"ShardedSketchEngine.step_narrow on the {mode} wire: "
              f"counters {got_n[0]}, PFCOUNTs, registers and validity equal "
              f"to phase 3's default run; launches {n_launches}")

    # -- 10c. the 10M roster on virtual meshes of the card -------------------
    preload_s = {}  # (sp, dp, sync, wire) -> wall of pipe.preload, s

    def run(sp, dp, sync, banks, **cfg):
        config = Config(bloom_filter_capacity=MESH_ROSTER, num_shards=sp,
                        num_replicas=dp, replica_sync=sync, **cfg)
        mesh = (make_mesh(sp, dp, [dev] * (sp * dp)) if sp * dp > 1
                else None)
        kernels.reset_launches()
        pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                             num_banks=banks, mesh=mesh)
        torch.cuda.synchronize()
        t_pre = time.perf_counter()
        pipe.preload(roster)
        torch.cuda.synchronize()
        preload_s[(sp, dp, sync, config.wire_format)] = (
            time.perf_counter() - t_pre)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=MESH_EVENTS, idle_timeout_s=1.0)
        # The run and its reads (counters, PFCOUNTs, state): the counts
        # are read just after.
        state = _mesh_ref_state(pipe, MESH_BANKS)
        torch.cuda.synchronize()
        return pipe, state, dict(kernels.launches)

    single, want, s_launches = run(1, 1, "query", MESH_BANKS)
    single_rate = single.metrics.events_per_second
    single.cleanup()
    check(not (truth & ~want[3]).any(), "10c one card: false negatives")
    check(s_launches["bloom_add"] == 1, "10c one card: the preload "
          f"launched K3 {s_launches['bloom_add']} times")
    print(f"mesh (c) one card (the reference), 10M roster: {single_rate} "
          f"events/s on {card}; preload wall "
          f"{preload_s[(1, 1, 'query', 'auto')]} s; wires "
          f"{single.metrics.wire_dwell}; launches "
          f"{ {k: v for k, v in s_launches.items() if v} }")
    launches = dict.fromkeys(kernels.launches, 0)
    members = roster[np.random.default_rng(1).choice(
        MESH_ROSTER, 100_000, replace=False)]
    outsiders = np.random.default_rng(2).integers(
        1 << 27, 1 << 28, 100_000).astype(np.uint32)
    word_state = {}  # (sp, dp, sync) -> the word wire run's state
    for sp, dp, sync, banks, wire in MESH_RUNS:
        what = (f"mesh (c) {dp} x {sp} ({sync} sync, {banks} banks, "
                f"--wire-format {wire})")
        pipe, state, run_launches = run(sp, dp, sync, banks,
                                        wire_format=wire)
        try:
            eng = pipe.engine
            fn = int((~eng.contains(members)).sum())
            fpr = float(eng.contains(outsiders).mean())
            words, _ = eng.get_state()
            host = int(bloom_packed_set_bits(torch.from_numpy(
                words.view(np.int32).copy()))) / eng.params.m_bits
            fill = eng.fill_fraction()
            rate = pipe.metrics.events_per_second
            dwell = dict(pipe.metrics.wire_dwell)
            stages = dict(pipe.metrics.stage_seconds)
        finally:
            pipe.cleanup()
        check(fn == 0, f"{what}: {fn} false negatives of 100,000 members")
        check(fpr <= 0.013, f"{what}: FPR {fpr} on 100,000 outsiders")
        check(abs(fill - host) <= 1e-5 * host, f"{what}: fill {fill} vs the "
              f"host popcount {host}")
        word = (int(sid.max()).bit_length() + banks.bit_length()) <= 32
        carried = (wire if wire in ("seg", "delta")
                   else "word" if word else "arrays")
        check(dwell == {carried: len(frames)}, f"{what}: wires {dwell}")
        _mesh_check_same(f"{what} vs one card", state, want)
        if wire in ("seg", "delta"):
            _mesh_check_same(f"{what} vs the word wire run",
                             state, word_state[(sp, dp, sync)])
        else:
            word_state[(sp, dp, sync)] = state
        worst = max(abs(n - exact[int(d)]) / exact[int(d)]
                    for d, n in state[1].items())
        check(worst <= 0.03, f"{what}: PFCOUNT relative error {worst}")
        check(state[0][0] + state[0][1] == MESH_EVENTS, f"{what}: counters")
        for name in MESH_KERNELS:
            check(run_launches[name] > 0, f"{what}: kernel {name} not "
                  "launched")
        check(run_launches["bloom_add_slice"] == sp * dp, f"{what}: the "
              f"preload launched K11 {run_launches['bloom_add_slice']} "
              f"times, not once a cell ({sp * dp})")
        for name in ("bloom_add", "fused_step", "bloom_contains",
                     "fused_step_seg", "fused_step_delta"):
            check(run_launches[name] == 0, f"{what}: launched {name}")
        for mode in ("seg", "delta"):
            # K12 once a frame and replica: a replica's cells share cuda:0.
            n_dec = dp * len(frames) if carried == mode else 0
            check(run_launches[f"decode_{mode}"] == n_dec, f"{what}: "
                  f"K12-{mode} launched {run_launches[f'decode_{mode}']} "
                  f"times, not {n_dec}")
        for name, count in run_launches.items():
            launches[name] += count
        print(f"{what}: {rate} events/s as {dp} x {sp} virtual slices of one "
              f"{card} (one card in the same call: {single_rate} events/s; "
              f"not a multi-card rate); preload wall "
              f"{preload_s[(sp, dp, sync, wire)]} s (one card "
              f"{preload_s[(1, 1, 'query', 'auto')]} s); equal to one card"
              f"{' and to its word wire run' if wire != 'auto' else ''} "
              f"in counters "
              f"{state[0]}, PFCOUNTs, merged registers, stored validity and "
              f"bank map; no false negatives of 100,000 members, FPR {fpr} "
              f"on 100,000 outsiders, fill {fill} (host popcount {host}); "
              f"worst PFCOUNT error {worst}; wires {dwell}; launches "
              f"{ {k: v for k, v in run_launches.items() if v} }; host "
              f"stages (s) {stages}")

    # -- 10d. a crash on (4, 2), resumed on (2, 4), restored on one card -----
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_mesh_"))
    try:
        snap = dict(snapshot_dir=str(work / "snaps"),
                    snapshot_every_batches=1, snapshot_mode="delta")
        broker = MemoryBroker()

        def pipe_on(sp, dp, **cfg):
            return FusedPipeline(
                Config(bloom_filter_capacity=MESH_ROSTER, num_shards=sp,
                       num_replicas=dp, **cfg),
                client=MemoryClient(broker), num_banks=MESH_BANKS,
                mesh=make_mesh(sp, dp, [dev] * (sp * dp)) if sp * dp > 1
                else None)

        t_d = time.perf_counter()
        a = pipe_on(4, 2, **snap)
        a.preload(roster)
        producer = a.client.create_producer(a.config.pulsar_topic)
        for f in frames:
            producer.send(f)
        a.run(max_events=5 * MESH_FRAME, idle_timeout_s=1.0)
        a.consumer.close()  # the crash: unacked frames redeliver
        acked = a.validity_counts()
        chain = sorted(p.name for p in (work / "snaps").glob("*.npz"))
        b = pipe_on(2, 4, **snap)
        try:
            check(sum(b.validity_counts()) == sum(acked),
                  f"10d: restored counters {b.validity_counts()} != the "
                  f"acked prefix's {acked}")
            b.run(idle_timeout_s=1.0)
            check(b.consumer.backlog() == 0, "10d: frames left unacked")
            resumed = _mesh_ref_state(b, MESH_BANKS)
            b.snapshot()
        finally:
            b.cleanup()
        check(resumed[0] == want[0] and resumed[1] == want[1]
              and np.array_equal(resumed[2], want[2])
              and resumed[4] == want[4],
              "10d: the resumed run differs from the uninterrupted one")
        c = pipe_on(1, 1, snapshot_dir=str(work / "snaps"))
        try:
            restored = _mesh_ref_state(c, MESH_BANKS)
        finally:
            c.cleanup()
        check(restored[0] == want[0] and restored[1] == want[1]
              and np.array_equal(restored[2], want[2])
              and restored[4] == want[4],
              "10d: the chain restored on one card differs")
        print(f"mesh (d) delta snapshots every frame on (4, 2), crash after "
              f"5 of 8 frames (acked {acked}, chain {chain}), resumed on "
              f"(2, 4): equal to the uninterrupted run; restored on one "
              f"card: equal; wall {time.perf_counter() - t_d} s")
    finally:
        import shutil
        shutil.rmtree(work, ignore_errors=True)

    # -- 10e. two processes sharing the card, dp over gloo -------------------
    t_e = time.perf_counter()
    repo = str(Path(__file__).resolve().parent)
    sys.path.insert(0, str(Path(repo) / "tests"))
    from torch_multihost_worker import run_pipeline_workload, run_workload
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_gloo_"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=repo, OMP_NUM_THREADS="1")
    outs = [work / f"r{i}.json" for i in range(2)]
    logs = [open(work / f"w{i}.log", "w") for i in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, str(Path(repo) / "tests" / "torch_multihost_worker.py"),
         str(i), "2", str(port), str(outs[i]), "--device", dev.type,
         "--cells", "1"], env=env, stdout=logs[i], stderr=subprocess.STDOUT)
        for i in range(2)]
    try:
        for i, p in enumerate(procs):
            rc = p.wait(timeout=300)
            check(rc == 0, f"10e: worker {i} exited {rc}:\n"
                  + (work / f"w{i}.log").read_text()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    results = [json.loads(o.read_text()) for o in outs]
    one = make_mesh(1, 2, [dev] * 2)
    want_e = run_workload(one)
    want_e.update(run_pipeline_workload(one))
    for r in results:
        check(r["process_count"] == 2, "10e: not a 2-process group")
        for key, value in want_e.items():
            check(r[key] == value, f"10e: process {r['process_id']} {key} "
                  f"{r[key]} != one process's {value}")
    import shutil
    shutil.rmtree(work, ignore_errors=True)
    print(f"mesh (e) two processes sharing {card}, dp = 2 over gloo (one "
          f"cuda:0 cell each): both processes' facts (PFCOUNTs "
          f"{want_e['counts']}, validity, bloom and register digests, the "
          f"pipeline's {want_e['pipe_events']} events) equal one process's "
          f"(2, 1) virtual mesh; worker workload seconds "
          f"{[r['seconds'] for r in results]}; wall {time.perf_counter() - t_e} s")
    print(f"mesh phase: {time.perf_counter() - t_phase} s")
    print(f"mesh phase launches ((c)'s mesh runs; in the kernels line): "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


TEL_RUNS = 3  # telemetry-off and -on runs of 11(a), interleaved
TEL_PROC_STUDENTS = 9_000  # 11(b): phase 6b's generator cut to ~97k events
TEL_FED_EVENTS = 65_536  # 11(d): a worker's events, 8 of its frames


def _prom_samples(text: str) -> dict:
    from attendance_tpu_torch.obs.exposition import parse_prom
    return {(n, l): float(v) for n, l, v in parse_prom(text)}


def _scrape(port: int) -> str:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        check(r.status == 200, f"scrape answered {r.status}")
        return r.read().decode()


def _scraping_client(t, out: dict):
    """A fresh memory broker's client whose consumers start one scrape of
    ``/metrics`` from inside the run loop's receive, as soon as a frame
    was dispatched: a scrape that starts mid-run by construction. It runs
    on a thread of its own (``out["thread"]``), as a scraper in another
    process would, so the run loop never waits for it."""
    import threading

    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    def scrape() -> None:
        out["text"] = _scrape(t.http_port)

    client = MemoryClient(MemoryBroker())
    subscribe = client.subscribe

    def subscribe_scraping(topic, subscription):
        consumer = subscribe(topic, subscription)
        raw = consumer.receive_many_raw

        def receive_many_raw(max_n, timeout_millis=None):
            got = raw(max_n, timeout_millis=timeout_millis)
            if "thread" not in out and t.frames.value >= 1:
                out["frames"] = t.frames.value
                out["thread"] = threading.Thread(target=scrape, daemon=True)
                out["thread"].start()
            return got

        consumer.receive_many_raw = receive_many_raw
        return consumer

    client.subscribe = subscribe_scraping
    return client


def _span_children(doc) -> dict:
    """{batch span id: [child names]} of a trace export."""
    evs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    batches = {e["args"]["span_id"] for e in evs if e["name"] == "batch"}
    kids = {b: [] for b in batches}
    for e in evs:
        parent = e["args"].get("parent_span_id")
        if parent in kids:
            kids[parent].append(e["name"])
    return kids


def _telemetry_fused(card: str, ref, stream, work) -> dict:
    """11(a): the ``fused`` default at full width on the word wire, with
    telemetry off and on, interleaved; returns the on runs' launches."""
    import urllib.request  # noqa: F401 (imported before the timed runs)

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.obs.registry import quantile_from_buckets
    from attendance_tpu_torch.ops import kernels

    num_events, frame_size, num_lectures = stream
    n_frames = num_events // frame_size
    launches = dict.fromkeys(kernels.launches, 0)
    rates = {"off": [], "on": []}
    artifacts = {}
    # Three off and three on runs, interleaved and timed; then one more on
    # run that a scrape hits mid-run, its rate reported apart (a scrape's
    # render takes the run loop's interpreter lock for a while).
    order = [(i, mode) for i in range(TEL_RUNS) for mode in ("off", "on")]
    for i, mode in order + [(TEL_RUNS, "scrape")]:
        tel = {}
        if mode != "off":
            tel = dict(metrics_port=-1,
                       metrics_prom=str(work / f"a{i}.prom"),
                       flight_recorder=64,
                       flight_path=str(work / f"a{i}-flight.json"),
                       trace_out=str(work / f"a{i}-trace.json"))
        config = Config(wire_format="word", **tel)
        t = obs.enable(config) if mode != "off" else None
        mid = {}
        # The scrape run: a scrape starts from inside its receive,
        # once a frame was dispatched.
        client = _scraping_client(t, mid) if mode == "scrape" else None
        kernels.reset_launches()
        pipe, summary = run_with_native(True, config, num_events,
                                        frame_size, num_lectures,
                                        client=client)
        run_launches = dict(kernels.launches)
        try:
            stored = pipe.store.to_columns(deduplicate=False)["is_valid"]
            regs = pipe.state.hll_regs.clone()
        finally:
            pipe.cleanup()
        what = f"telemetry (a) run {i} telemetry {mode}"
        got = ((summary["valid"], summary["invalid"]),
               summary["unique_attendees"], regs, stored)
        check(got[:2] == ref[:2], f"{what}: counters or PFCOUNTs differ "
              "from phase 3's default run")
        check(torch.equal(got[2], ref[2]), f"{what}: registers differ")
        check(np.array_equal(got[3], ref[3]),
              f"{what}: stored validity differs")
        check(summary["wire_dwell"] == {"word": n_frames},
              f"{what}: wires {summary['wire_dwell']}")
        for name in ("bloom_add", "fused_step", "hll_histogram"):
            check(run_launches[name] > 0, f"{what}: {name} not launched")
        if mode != "scrape":
            rates[mode].append(summary["events_per_second"])
        if t is None:
            continue
        for name, count in run_launches.items():
            launches[name] += count
        after = _scrape(t.http_port)
        s = _prom_samples(after)
        wire_bytes = {k: v for k, v in s.items()
                      if k[0] == "attendance_device_transfer_bytes_total"
                      and 'site="frame"' in k[1]}
        stage = {k[1]: v for k, v in s.items()
                 if k[0] == "attendance_stage_latency_seconds_count"}
        check(s[("attendance_events_total", "")] == num_events,
              f"{what}: events_total {s[('attendance_events_total', '')]}")
        check(s[("attendance_frames_total", "")] == n_frames,
              f"{what}: frames_total")
        check(sum(v for k, v in s.items()
                  if k[0] == "attendance_wire_frames_total") == n_frames,
              f"{what}: wire frames")
        for name in ("dispatch", "device_wait", "decode", "dequeue_wait"):
            count = stage['stage="%s"' % name]
            check(count == n_frames, f"{what}: {name} count {count}")
        # The word wire carries 4 bytes a lane of each padded frame.
        check(wire_bytes == {
            ("attendance_device_transfer_bytes_total",
             'direction="h2d",site="frame",wire="word"'):
                4 * frame_size * n_frames},
              f"{what}: frame bytes {wire_bytes}")
        h_gap = t.registry.histogram("attendance_dispatch_gap_seconds")
        h_wait = t.stage("device_wait")
        busy = {k[1].split('"')[1]: v for k, v in s.items()
                if k[0] == "attendance_dispatch_thread_busy_fraction"}
        gap_b, _, gap_n = h_gap.snapshot()
        wait_b, wait_sum, wait_n = h_wait.snapshot()
        gap_q = [quantile_from_buckets(gap_b, gap_n, q)
                 for q in (0.5, 0.99)]
        wait_q = [quantile_from_buckets(wait_b, wait_n, q)
                  for q in (0.5, 0.99)]
        if mode == "scrape":
            check("thread" in mid and 1 <= mid["frames"] < n_frames,
                  f"{what}: no scrape started during the run")
            mid["thread"].join(timeout=30)
            check("text" in mid, f"{what}: the mid-run scrape failed")
            seen = _prom_samples(mid["text"])[
                ("attendance_frames_total", "")]
            print(f"{what}: a scrape started after {mid['frames']} of "
                  f"{n_frames} frames and rendered {seen} frames, "
                  f"{len(mid['text'])} bytes")
        t.dump_flight("chip_smoke")
        obs.disable()  # writes the final prom block and the trace
        flight = json.loads(open(config.flight_path).read())
        check(flight["reason"] == "chip_smoke"
              and flight["total_records"] == n_frames
              and flight["records"][-1]["events"] == frame_size
              and set(flight["records"][-1]["stages"]) == {
                  "dequeue_wait", "decode", "dispatch", "device_wait"},
              f"{what}: flight dump {flight['records'][-1:]}")
        trace = json.loads(open(config.trace_out).read())
        kids = _span_children(trace)
        check(len(kids) == n_frames, f"{what}: {len(kids)} batch spans")
        for names in kids.values():
            check({"dequeue_wait", "decode", "dispatch",
                   "device_wait"} <= set(names),
                  f"{what}: batch span children {names}")
        prom_text = open(config.metrics_prom).read()
        check(_prom_samples(prom_text)[("attendance_events_total", "")]
              == num_events, f"{what}: the prom file's last block")
        artifacts = dict(prom=config.metrics_prom,
                         trace=config.trace_out,
                         flight=config.flight_path)
        print(f"{what}: {summary['events_per_second']} events/s on "
              f"{card}; dispatch gap p50 {gap_q[0]} s p99 {gap_q[1]} s "
              f"over {gap_n} gaps; device_wait p50 {wait_q[0]} s p99 "
              f"{wait_q[1]} s sum {wait_sum} s over {wait_n} frames; "
              f"dispatch-thread busy fractions {busy}; "
              f"{len(trace['traceEvents'])} trace events, "
              f"{len(prom_text)} prom bytes; scrape after the run "
              f"{len(after)} bytes")
    off = float(np.median(rates["off"]))
    on = float(np.median(rates["on"]))
    print(f"telemetry (a) fused default, word wire, on {card}: events/s "
          f"off {rates['off']} on {rates['on']}; medians off {off} on {on}; "
          f"on/off {on / off}")
    print(f"telemetry (a) launches (the telemetry-on runs; in the kernels "
          f"line): { {k: v for k, v in launches.items() if v} }")
    return launches, artifacts


def _telemetry_processor(card: str, dev, work) -> dict:
    """11(b): the processor on the card store over ~97k JSON events with
    ``--metrics-prom``; its stage counts equal its batches."""
    from datetime import datetime

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.cli import run_pipeline
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.transport.memory_broker import MemoryBroker

    MemoryBroker.reset_shared()
    prom = work / "b.prom"
    config = Config(metrics_prom=str(prom))
    kernels.reset_launches()
    proc, report = run_pipeline(config, TEL_PROC_STUDENTS, 50, seed=0,
                                device=dev, now=datetime(*INGRESS_NOW))
    run_launches = dict(kernels.launches)
    m = proc.metrics
    proc.cleanup()
    obs.disable()
    s = _prom_samples(prom.read_text())
    stage = {k[1]: v for k, v in s.items()
             if k[0] == "attendance_stage_latency_seconds_count"}
    what = "telemetry (b) processor"
    check(m.events == report.message_count, f"{what}: {m.events} events")
    check(s[("attendance_events_total", "")] == m.events,
          f"{what}: events_total")
    check(s[("attendance_frames_total", "")] == m.batches,
          f"{what}: frames_total")
    for name in ("batch_assembly", "sketch", "persist"):
        count = stage['stage="%s"' % name]
        check(count == m.batches,
              f"{what}: {name} count {count} != {m.batches} batches")
    # The run's kernels (the roster add, BF.EXISTS, PFADD); the store's
    # PFCOUNT kernels run only on reads, which phase 6b times.
    for name in ("bloom_add_bytes", "bloom_contains_bytes", "hll_add"):
        check(run_launches[name] > 0, f"{what}: {name} not launched")
    print(f"{what}: {m.events} JSON events in {m.batches} batches, "
          f"{m.events_per_second} events/s on {card}; stage counts "
          f"{ {k: v for k, v in stage.items()} }; launches "
          f"{ {k: v for k, v in run_launches.items() if v} }")
    return run_launches


def _telemetry_mesh(card: str, dev, ref, stream, work) -> dict:
    """11(c): a virtual (4, 2) mesh of the card, query sync, word wire,
    over phase 3's stream with telemetry on."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.parallel import make_mesh
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    num_events, frame_size, num_lectures = stream
    n_frames = num_events // frame_size
    trace_path = work / "c-trace.json"
    config = Config(num_shards=4, num_replicas=2, replica_sync="query",
                    wire_format="word", metrics_port=-1,
                    trace_out=str(trace_path))
    t = obs.enable(config)
    roster, frames = generate_frames(
        num_events, frame_size,
        roster_size=min(config.bloom_filter_capacity, num_events),
        num_lectures=num_lectures, seed=0)
    kernels.reset_launches()
    pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                         mesh=make_mesh(4, 2, [dev] * 8))
    try:
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=num_events, idle_timeout_s=1.0)
        counts = pipe.validity_counts()
        pfc = {str(d): n for d, n in sorted(pipe.count_all().items())}
        regs = pipe.engine.get_state()[1]
        stored = pipe.store.to_columns(deduplicate=False)["is_valid"]
        engine_events = pipe.engine.shard_events.tolist()
        rate = pipe.metrics.events_per_second
        dwell = dict(pipe.metrics.wire_dwell)
        run_launches = dict(kernels.launches)
        s = _prom_samples(_scrape(t.http_port))
    finally:
        pipe.cleanup()
    obs.disable()
    what = "telemetry (c) (4, 2) mesh"
    check(counts == ref[0], f"{what}: counters {counts} != {ref[0]}")
    check(pfc == ref[1], f"{what}: PFCOUNTs differ from one card's")
    check(np.array_equal(regs, ref[2].cpu().numpy()),
          f"{what}: merged registers differ from one card's")
    check(np.array_equal(stored, ref[3]), f"{what}: stored validity")
    check(dwell == {"word": n_frames}, f"{what}: wires {dwell}")
    shard = [s[("attendance_shard_events", f'replica="{r}"')]
             for r in range(2)]
    check(shard == engine_events and sum(shard) == num_events,
          f"{what}: shard events {shard} vs the engine's {engine_events}")
    for name in MESH_KERNELS:
        check(run_launches[name] > 0, f"{what}: {name} not launched")
    trace = json.loads(trace_path.read_text())
    kids = _span_children(trace)
    check(len(kids) == n_frames, f"{what}: {len(kids)} batch spans")
    for names in kids.values():
        check(names.count("replica_dispatch") == 2,
              f"{what}: batch span children {names}")
    print(f"{what} of {card}, query sync, word wire: {rate} events/s "
          f"(virtual slices of one card); equal to one card in counters, "
          f"PFCOUNTs, merged registers and stored validity; shard events "
          f"{shard}; two replica_dispatch spans under each of the "
          f"{n_frames} batch spans; launches "
          f"{ {k: v for k, v in run_launches.items() if v} }")
    return run_launches


def _telemetry_federation(card: str, dev, work) -> dict:
    """11(d): one K = 2 round: workers with ``--metrics-prom`` and
    ``--trace-out``, an aggregator with telemetry."""
    from pathlib import Path

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.federation.gossip import Aggregator
    from attendance_tpu_torch.obs.tracing import parse_ctx
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.serve.engine import QueryEngine
    from attendance_tpu_torch.transport.socket_broker import (
        SocketClient, spawn_broker)

    K = 2
    repo = str(Path(__file__).resolve().parent)
    env = _fed_env(repo)
    rdir = work / "fed"
    rdir.mkdir()
    topic, gossip_topic = "chip-tel-fed", "chip-tel-fed-gossip"
    t = obs.enable(Config(metrics_port=-1,
                          trace_out=str(work / "d-agg-trace.json")))
    broker, addr = spawn_broker(cwd=repo)
    procs = []
    what = "telemetry (d) federation K=2"
    try:
        agg_client = SocketClient(addr)
        agg = Aggregator(client=agg_client, topic=gossip_topic,
                         num_shards=K, dead_after_s=1e9, precision=14,
                         obs=t)
        folded = []
        fold = agg.fold_frame

        def fold_noting(frame, now=None):
            info = fold(frame, now)
            if info["lag_s"] is not None:
                folded.append(frame.traceparent)
            return info

        agg.fold_frame = fold_noting
        agg.start()
        try:
            logs = [rdir / f"worker-{s}.log" for s in range(K)]
            procs = [_spawn_fed_worker(
                repo, env, logs[s], addr, rdir, s, K, topic, gossip_topic,
                TEL_FED_EVENTS, data_plane="memory",
                extra=("--max-events", str(TEL_FED_EVENTS),
                       "--idle-timeout-s", "10",
                       "--metrics-prom", str(rdir / f"w{s}.prom"),
                       "--trace-out", str(rdir / f"w{s}-trace.json")))
                for s in range(K)]
            _fed_wait(procs, logs, what, 300)
            reports = [_fed_report(log) for log in logs]
            _fed_drain(agg)
            kernels.reset_launches()
            oracle = _fed_oracle(dev, K, TEL_FED_EVENTS)
            oracle_launches = dict(kernels.launches)
            engine = QueryEngine(agg.mirror, batch_max=1 << 20)
            probe = np.random.default_rng(9).integers(
                1 << 21, 1 << 31, 1 << 16).astype(np.uint32)
            _fed_gates(what, agg.view, engine, oracle, probe,
                       K * TEL_FED_EVENTS)
            s = _prom_samples(t.render())
        finally:
            agg.stop()
            agg_client.close()
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        broker.kill()
        broker.wait()
        obs.disable()
    check(s[("attendance_fed_merge_lag_seconds_count", "")] == len(folded),
          f"{what}: merge-lag count vs {len(folded)} frames folded")
    check(all(s[("attendance_fed_peer_up", f'peer="w{w}"')] == 1
              for w in range(K)), f"{what}: peer-up gauges")
    ctxs = [parse_ctx(tp) for tp in folded]
    check(folded and all(c is not None for c in ctxs),
          f"{what}: folded frames' traceparents {folded[:4]}")
    for w in range(K):
        ws = _prom_samples((rdir / f"w{w}.prom").read_text())
        check(ws[("attendance_events_total", "")] == TEL_FED_EVENTS,
              f"{what}: worker w{w}'s prom file")
    merges = [e for e in json.loads(
        (work / "d-agg-trace.json").read_text())["traceEvents"]
        if e.get("name") == "fed_merge"]
    check(len(merges) == len(folded), f"{what}: {len(merges)} fed_merge "
          f"spans for {len(folded)} folds")
    print(f"{what} on {card}: workers' events/s "
          f"{[r['events_per_sec'] for r in reports]}; {len(folded)} state "
          f"frames folded, merge-lag count "
          f"{s[('attendance_fed_merge_lag_seconds_count', '')]}, every "
          f"traceparent parsed; both peers up; merged view equal to the "
          f"oracle; oracle launches "
          f"{ {k: v for k, v in oracle_launches.items() if v} }")
    return oracle_launches


def telemetry_phase(card: str, dev, ref, stream) -> dict:
    """Phase 11: the telemetry core on the card. (a) the ``fused`` default
    with telemetry off and on, (b) the processor, (c) a (4, 2) mesh,
    (d) a federation round, (e) the ``telemetry`` verb on (a)'s
    artifacts. Returns the launches of its runs."""
    import shutil
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_tel_"))
    launches = dict.fromkeys(kernels.launches, 0)
    procs = {}
    try:
        t0 = time.perf_counter()
        a_launches, artifacts = _telemetry_fused(card, ref, stream, work)
        print(f"telemetry (a): {time.perf_counter() - t0} s")
        # (e) the verb on (a)'s artifacts: the three processes start now
        # and run beside (b)-(d); their output files are read at the end.
        repo = str(Path(__file__).resolve().parent)
        for kind, path in artifacts.items():
            procs[kind] = subprocess.Popen(
                [sys.executable, "-m", "attendance_tpu_torch", "telemetry",
                 path], cwd=repo, env=_fed_env(repo),
                stdout=open(work / f"e-{kind}.out", "w"),
                stderr=subprocess.STDOUT)
        parts = [a_launches]
        for sub, run in (
                ("b", lambda: _telemetry_processor(card, dev, work)),
                ("c", lambda: _telemetry_mesh(card, dev, ref, stream, work)),
                ("d", lambda: _telemetry_federation(card, dev, work))):
            t0 = time.perf_counter()
            parts.append(run())
            print(f"telemetry ({sub}): {time.perf_counter() - t0} s")
        for part in parts:
            for name, count in part.items():
                launches[name] += count
        for kind, p in procs.items():
            p.wait(timeout=120)
            out = (work / f"e-{kind}.out").read_text()
            check(p.returncode == 0, f"telemetry (e) verb on the {kind} "
                  f"artifact exited {p.returncode}:\n{out[-2000:]}")
            first = out.splitlines()[0] if out else ""
            print(f"telemetry (e) verb on the {kind} artifact: exit 0, "
                  f"{len(out.splitlines())} lines; first: {first[:160]}")
    finally:
        obs.disable()  # a failed gate leaves no reporter on a removed path
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    print(f"telemetry phase: {time.perf_counter() - t_phase} s")
    print(f"telemetry phase launches (its runs; in the kernels line): "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


ACC_SAMPLE = 0.01     # 12: the --audit-sample of its runs (the JAX default)
ACC_RUNS = 3          # 12(a): audit-off and -on runs, interleaved
ACC_BIG_ROSTER = 10_000_000  # 12(b): BASELINE config #4's roster
ACC_PROC_STUDENTS = 3_000    # 12(d): the processor's generator, cut
ACC_SERVE_SECONDS = 6.0      # 12(e): the serve verb's lifetime


class _KernelCallers:
    """Which threads called the K4 and K1 wrappers while installed:
    {wrapper name: [thread name per call]}. The wrappers still count
    their launches themselves; this only attributes them (a scrape's
    callbacks run on the metrics server's request thread)."""

    NAMES = ("bloom_contains", "hll_histogram")

    def __init__(self):
        from attendance_tpu_torch.ops import kernels
        self._kernels = kernels
        self.calls = {name: [] for name in self.NAMES}
        self._real = {}

    def __enter__(self):
        import threading
        for name in self.NAMES:
            real = self._real[name] = getattr(self._kernels, name)

            def spy(*args, _real=real, _seen=self.calls[name], **kwargs):
                _seen.append(threading.current_thread().name)
                return _real(*args, **kwargs)

            setattr(self._kernels, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self._kernels, name, real)

    def off(self, thread_name: str) -> dict:
        """Calls made by threads other than ``thread_name``."""
        return {name: sum(c != thread_name for c in calls)
                for name, calls in self.calls.items()}


def _timed_scrape(port: int):
    """(text, wall seconds) of one scrape of /metrics."""
    t0 = time.perf_counter()
    text = _scrape(port)
    return text, time.perf_counter() - t0


def _accuracy_gates(what: str, t, pipe, s: dict):
    """12(b)'s gates on one scrape ``s`` of a finished run: no false
    negative, the measured FPR within 1.5% and equal to a host recount
    over the shadow's probe sets, the estimate equal to the pipeline's
    PFCOUNTs, the fill gauge the one ``estimated_fpr`` raises to k.
    Returns (measured FPR, fill, sampled roster keys, sampled
    outsiders)."""
    from attendance_tpu_torch.models.bloom import (
        bloom_contains_words_np, bloom_packed_fill_fraction_np)

    check(s[("attendance_bloom_false_negatives_total", "")] == 0,
          f"{what}: false negatives "
          f"{s[('attendance_bloom_false_negatives_total', '')]}")
    fpr = s[("attendance_bloom_measured_fpr", 'surface="fused"')]
    if pipe.engine is not None:
        words, _ = pipe.engine.get_state()
    else:
        words = pipe.state.bloom_bits.cpu().numpy().view(np.uint32)
    roster, negatives = t.auditor.fused_probe_sets()
    host = bloom_contains_words_np(words, negatives, pipe.params)
    check(len(negatives) > 0 and fpr == host.sum() / len(negatives),
          f"{what}: measured FPR {fpr} != host recount "
          f"{host.sum()} / {len(negatives)}")
    check(bool(bloom_contains_words_np(words, roster, pipe.params).all()),
          f"{what}: a sampled roster key reads absent on the host")
    check(fpr <= 0.015, f"{what}: measured FPR {fpr}")
    est = s[("attendance_hll_estimate", "")]
    check(est == sum(pipe.count_all().values()),
          f"{what}: hll estimate {est} != sum(count_all())")
    fill = s[("attendance_bloom_fill_fraction", "")]
    check(fill == bloom_packed_fill_fraction_np(words),
          f"{what}: fill {fill} != the host popcount")
    check(fill ** pipe.params.k == pipe.estimated_fpr()
          == s[("attendance_bloom_estimated_fpr", "")],
          f"{what}: fill ** k {fill ** pipe.params.k} != estimated_fpr() "
          f"{pipe.estimated_fpr()}")
    return fpr, fill, len(roster), len(negatives)


def _accuracy_run(card: str, what: str, config, roster, frames,
                  num_events: int, launches: dict, mesh=None):
    """One audited run with a scrape started from inside its receive
    after the first frame and one after it; the gates on the scrape
    after, the K4 and K1 calls of each scrape, the render walls. Returns
    (pipe, samples after, the auditor's bundle)."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline

    import threading

    t = obs.enable(config)
    mid = {}
    kernels.reset_launches()
    with _KernelCallers() as callers:
        pipe = FusedPipeline(config, client=_scraping_client(t, mid),
                             mesh=mesh)
        t0 = time.perf_counter()
        pipe.preload(roster)
        preload_s = time.perf_counter() - t0
        producer = pipe.client.create_producer(config.pulsar_topic)
        for f in frames:
            producer.send(f)
        pipe.run(max_events=num_events, idle_timeout_s=1.0)
        check("thread" in mid, f"{what}: no scrape started during the run")
        mid["thread"].join(timeout=120)
        check("text" in mid, f"{what}: the mid-run scrape failed")
        # Every call off the run loop's thread before the run ended came
        # from the mid-run scrape.
        mid_calls = callers.off(threading.current_thread().name)
        before = dict(kernels.launches)
        after, wall = _timed_scrape(t.http_port)
        one = {k: kernels.launches[k] - before[k] for k in before
               if kernels.launches[k] != before[k]}
    for name, count in kernels.launches.items():
        launches[name] += count
    s = _prom_samples(after)
    m = _prom_samples(mid["text"])
    check(m[("attendance_bloom_false_negatives_total", "")] == 0,
          f"{what}: false negatives in the mid-run scrape")
    print(f"{what} on {card}: {pipe.metrics.events_per_second} events/s, "
          f"preload {preload_s} s; the mid-run scrape (after "
          f"{mid['frames']} frames, render of "
          f"{m[('attendance_frames_total', '')]} frames) called "
          f"{mid_calls} off the run loop's thread; the scrape after the "
          f"run took "
          f"{wall} s and launched {one}")
    return pipe, s, t, mid_calls, one


def _accuracy_fused(card: str, ref, stream, launches: dict) -> dict:
    """12(a): the ``fused`` default with telemetry on, audit off and on
    (``--audit-sample`` 0.01), interleaved; the auditor's own per-frame
    cost on one frame. Returns {mode: [events/s]}."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.obs.audit import ShadowAuditor
    from attendance_tpu_torch.obs.registry import Registry
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.events import decode_planar_batch
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    num_events, frame_size, num_lectures = stream
    rates = {"off": [], "on": []}
    for i in range(ACC_RUNS):
        for mode in ("off", "on"):
            config = Config(metrics_port=-1, audit_sample=(
                ACC_SAMPLE if mode == "on" else 0.0))
            t = obs.enable(config)
            kernels.reset_launches()
            pipe, summary = run_with_native(True, config, num_events,
                                            frame_size, num_lectures)
            for name, count in kernels.launches.items():
                launches[name] += count
            try:
                what = f"accuracy (a) run {i} audit {mode}"
                check(((summary["valid"], summary["invalid"]),
                       summary["unique_attendees"]) == ref[:2],
                      f"{what}: counters or PFCOUNTs differ from phase 3's")
                check((t.auditor is None) == (mode == "off")
                      and (pipe._auditor is t.auditor),
                      f"{what}: auditor {t.auditor}")
                if mode == "on":
                    members = t.auditor._shadow_size()
                    check(members > 0, f"{what}: an empty shadow")
                rates[mode].append(summary["events_per_second"])
            finally:
                pipe.cleanup()
                obs.disable()
            print(f"{what}: {summary['events_per_second']} events/s "
                  f"on {card}; wires {summary['wire_dwell']}")
    off = float(np.median(rates["off"]))
    on = float(np.median(rates["on"]))
    print(f"accuracy (a) fused default, telemetry on, on {card}: events/s "
          f"audit off {rates['off']} on {rates['on']}; medians off {off} "
          f"on {on}; on/off {on / off}")
    # The shadow's per-frame host cost alone, on one decoded frame.
    roster, frames = generate_frames(num_events, frame_size,
                                     roster_size=100_000,
                                     num_lectures=num_lectures, seed=0)
    aud = ShadowAuditor(Registry(), ACC_SAMPLE)
    aud.record_roster(roster)
    cols = [decode_planar_batch(f) for f in frames]
    t0 = time.perf_counter()
    for c in cols:
        aud.observe_fused_frame(c["student_id"], c["lecture_day"])
    per_frame = (time.perf_counter() - t0) / len(cols)
    print(f"accuracy (a) observe_fused_frame at sample {ACC_SAMPLE}: "
          f"{per_frame * 1e3} ms a {frame_size}-event frame (host, the "
          f"dispatch thread's cost), {aud._shadow_size()} shadow members")
    return rates


def _accuracy_processor(card: str, dev, launches: dict) -> None:
    """12(d): the processor on the card store with the audit on: its
    audit counters equal the CPU reference's on the same stream, and its
    health gauges report after a snapshot restore."""
    import tempfile
    from datetime import datetime
    from pathlib import Path

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.cli import run_pipeline
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.sketch import make_sketch_store
    from attendance_tpu_torch.transport.memory_broker import MemoryBroker
    from attendance_tpu_torch.utils.snapshot import (
        restore_sketch_store, snapshot_sketch_store)

    what = "accuracy (d) processor, card store"
    got = {}
    for device in (dev, "cpu"):
        MemoryBroker.reset_shared()
        config = Config(metrics_port=-1, audit_sample=ACC_SAMPLE)
        t = obs.enable(config)
        kernels.reset_launches()
        try:
            proc, report = run_pipeline(config, ACC_PROC_STUDENTS, 50,
                                        seed=0, device=device,
                                        now=datetime(*INGRESS_NOW))
            counts = _pipeline_result(proc, report)[3]
            aud = t.auditor
            got[str(device)] = dict(
                checks=aud._checks.value, fp=aud._fp.value,
                fn=aud._fn.value, negatives=aud._negatives.value,
                members=aud._shadow_size(), counts=counts,
                errors={k: v for k, v in _prom_samples(t.render()).items()
                        if k[0] == "attendance_hll_measured_rel_error"})
            if device == dev:
                for name, count in kernels.launches.items():
                    launches[name] += count
                run_launches = {k: v for k, v in kernels.launches.items()
                                if v}
                before = _prom_samples(t.render())
                with tempfile.TemporaryDirectory() as d:
                    path = Path(d) / "sketch.npz"
                    snapshot_sketch_store(proc.sketch, path)
                    fresh = make_sketch_store(config, device=dev)
                    restore_sketch_store(fresh, path)
                    proc.cleanup()
                    del proc
                    after = _prom_samples(t.render())
                    health = [k for k in before
                              if k[0] in ("attendance_hll_estimate",
                                          "attendance_bloom_fill_fraction",
                                          "attendance_bloom_estimated_fpr")]
                    check(health and all(after.get(k) == before[k]
                                         for k in health),
                          f"{what}: health gauges after the restore "
                          f"{ {k: after.get(k) for k in health} } != "
                          f"{ {k: before[k] for k in health} }")
            else:
                proc.cleanup()
        finally:
            obs.disable()
    card_side, cpu_side = got[str(dev)], got["cpu"]
    check(card_side == cpu_side, f"{what}: audit counters {card_side} != "
          f"the CPU reference's {cpu_side}")
    check(card_side["fn"] == 0 and card_side["checks"] > 0,
          f"{what}: {card_side}")
    print(f"{what} on {card}: audit counters equal to the CPU reference's "
          f"(checks {card_side['checks']}, negatives "
          f"{card_side['negatives']}, false positives {card_side['fp']}, "
          f"false negatives 0, {card_side['members']} shadow members, "
          f"{len(card_side['errors'])} HLL error gauges); the health "
          f"gauges equal after a snapshot restore; launches {run_launches}")


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _route_answers(base: str, roster, days) -> dict:
    """The /query/* routes' JSON, keyed like ``_rpc_route_answers``."""
    import urllib.request

    def get(path, data=None):
        req = urllib.request.Request(base + path, data=data,
                                     method="POST" if data else "GET")
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    keys = ",".join(str(int(k)) for k in roster)
    stats = get("/query/stats")
    return dict(
        occupancy={int(k): v for k, v in get("/query/occupancy").items()},
        exists=get(f"/query/exists?keys={keys}"),
        pfcount=get("/query/pfcount?days="
                    + ",".join(str(d) for d in days)),
        post_pfcount=get("/query", json.dumps(
            {"verb": "pfcount", "days": list(days)}).encode())["result"],
        rate={int(k): v for k, v in get("/query/rate").items()},
        stats={k: stats[k] for k in ("epoch", "events", "valid",
                                     "invalid", "roster_size")})


def _rpc_route_answers(client, roster, days) -> dict:
    stats = client.stats()
    return dict(
        occupancy={int(k): int(v) for k, v in client.occupancy().items()},
        exists=[bool(v) for v in client.bf_exists(roster)],
        pfcount=[int(v) for v in client.pfcount(days)],
        post_pfcount=[int(v) for v in client.pfcount(days)],
        rate={int(k): v for k, v in client.attendance_rate().items()},
        stats={k: stats[k] for k in ("epoch", "events", "valid",
                                     "invalid", "roster_size")})


def _accuracy_serve(card: str, stream, launches: dict) -> None:
    """12(e): a checkpointed ``fused`` default that serves, with the
    audit and a metrics port on: every route answers what the RPC does
    for the same epoch, the read audit counts no false negative over the
    sampled roster; then the ``serve`` verb over its chain with
    ``--metrics-port``: the same, and a finite staleness gauge."""
    import shutil
    import tempfile
    import threading

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.cli import main as cli_main
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.serve.rpc import QueryClient

    num_events, frame_size, num_lectures = stream
    work = tempfile.mkdtemp(prefix="chip_smoke_acc_")
    try:
        config = Config(snapshot_dir=work, snapshot_every_batches=2,
                        serve_port=-1, metrics_port=-1,
                        audit_sample=ACC_SAMPLE)
        t = obs.enable(config)
        kernels.reset_launches()
        pipe, summary = run_with_native(True, config, num_events,
                                        frame_size, num_lectures)
        for name, count in kernels.launches.items():
            launches[name] += count
        what = "accuracy (e) fused, checkpointed, serving"
        try:
            roster = t.auditor.fused_probe_sets()[0]
            days = [int(d) for d in pipe.lecture_days()] + [123]
            base = f"http://127.0.0.1:{t.http_port}"
            client = QueryClient(pipe.query_server.address)
            want = _rpc_route_answers(client, roster, days)
            got = _route_answers(base, roster, days)
            client.close()
            check(got == want, f"{what}: the routes' answers differ from "
                  "the RPC's")
            check(all(got["exists"]), f"{what}: a sampled roster key reads "
                  "absent")
            s = _prom_samples(_scrape(t.http_port))
            fn = s[("attendance_query_false_negatives_total", "")]
            audited = s[("attendance_query_audited_total", "")]
            check(fn == 0 and audited >= len(roster),
                  f"{what}: read audit false negatives {fn}, audited "
                  f"{audited}")
            stale = s[("attendance_read_staleness_seconds", "")]
            check(np.isfinite(stale) and stale >= 0,
                  f"{what}: staleness {stale}")
            print(f"{what} on {card}: {summary['events_per_second']} "
                  f"events/s; {len(got)} route answers equal to the RPC's "
                  f"on epoch {got['stats']['epoch']}; read audit "
                  f"{audited} answers, 0 false negatives, measured read "
                  f"FPR {s[('attendance_query_measured_fpr', '')]}; "
                  f"staleness {stale} s")
        finally:
            pipe.cleanup()
            obs.disable()
        serve_port, metrics_port = _free_port(), _free_port()
        thread = threading.Thread(target=cli_main, args=([
            "serve", "--snapshot-dir", work, "--serve-port",
            str(serve_port), "--metrics-port", str(metrics_port),
            "--serve-seconds", str(ACC_SERVE_SECONDS)],), daemon=True)
        thread.start()
        what = "accuracy (e) the serve verb over the chain"
        deadline = time.monotonic() + 30
        while True:
            t = obs.get()
            if (t is not None and t._server is not None
                    and "/query/stats" in t._server.routes):
                break
            check(time.monotonic() < deadline and thread.is_alive(),
                  f"{what}: its routes never mounted")
            time.sleep(0.01)
        client = QueryClient(f"127.0.0.1:{serve_port}")
        want = _rpc_route_answers(client, roster, days)
        client.close()
        got = _route_answers(f"http://127.0.0.1:{metrics_port}", roster,
                             days)
        check(got == want, f"{what}: the routes' answers differ from the "
              "RPC's")
        s = _prom_samples(_scrape(metrics_port))
        stale = s[("attendance_read_staleness_seconds", "")]
        check(np.isfinite(stale) and stale >= 0,
              f"{what}: staleness {stale}")
        check(s[("attendance_read_epoch_seq", "")] >= 1,
              f"{what}: epoch seq")
        thread.join(timeout=ACC_SERVE_SECONDS + 30)
        check(not thread.is_alive(), f"{what}: the verb did not end")
        print(f"{what}: {len(got)} route answers equal to the RPC's on "
              f"epoch {got['stats']['epoch']} ({got['stats']['events']} "
              f"events); staleness {stale} s")
    finally:
        obs.disable()
        shutil.rmtree(work, ignore_errors=True)


def accuracy_phase(card: str, dev, ref, stream) -> dict:
    """Phase 12: live accuracy on the card. (a) the audit's cost on the
    ``fused`` default, (b) scrapes during and after audited runs at the
    100k and 10M rosters and at sample 1.0, (c) a (4, 2) virtual mesh
    equal to one card, (d) the processor on the card store, (e) the
    query routes and the ``serve`` verb. Returns the launches of its
    runs."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.parallel import make_mesh
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    t_phase = time.perf_counter()
    num_events, frame_size, num_lectures = stream
    launches = dict.fromkeys(kernels.launches, 0)
    try:
        t0 = time.perf_counter()
        _accuracy_fused(card, ref, stream, launches)
        print(f"accuracy (a): {time.perf_counter() - t0} s")

        # (b) at the default 100k roster (phase 3's stream), at sample
        # 1.0 for the measured HLL error, and at the 10M roster.
        t0 = time.perf_counter()
        one = {}
        for label, capacity, sample in (("100k", 100_000, ACC_SAMPLE),
                                        ("100k", 100_000, 1.0),
                                        ("10M", ACC_BIG_ROSTER, ACC_SAMPLE)):
            what = f"accuracy (b) roster {label} sample {sample}"
            roster, frames = generate_frames(
                num_events, frame_size, roster_size=capacity,
                num_lectures=num_lectures, seed=0)
            config = Config(bloom_filter_capacity=capacity,
                            metrics_port=-1, audit_sample=sample)
            pipe, s, t, mid_calls, scrape_launches = _accuracy_run(
                card, what, config, roster, frames, num_events, launches)
            try:
                check(mid_calls["bloom_contains"] >= 2
                      and mid_calls["hll_histogram"] >= 1,
                      f"{what}: the mid-run scrape made {mid_calls}")
                check(scrape_launches.get("bloom_contains") == 2
                      and scrape_launches.get("hll_histogram") == 2,
                      f"{what}: one scrape launched {scrape_launches}")
                fpr, fill, n_roster, n_neg = _accuracy_gates(what, t, pipe,
                                                             s)
                err = s[("attendance_hll_measured_rel_error",
                         'key="fused"')]
                if sample >= 1.0:
                    check(err <= 0.03, f"{what}: HLL error {err}")
                if capacity == 100_000 and sample == ACC_SAMPLE:
                    one = dict(fpr=fpr, fill=fill,
                               counts=pipe.validity_counts())
                print(f"{what}: measured FPR {fpr} over {n_neg} sampled "
                      f"outsiders (equal to the host recount), 0 false "
                      f"negatives over {n_roster} sampled roster keys, fill "
                      f"{fill}, estimated FPR {pipe.estimated_fpr()}, HLL "
                      f"estimate {s[('attendance_hll_estimate', '')]}, "
                      f"measured HLL error {err}, saturated registers "
                      f"{s[('attendance_hll_saturated_registers', '')]}")
            finally:
                pipe.cleanup()
                obs.disable()
        print(f"accuracy (b): {time.perf_counter() - t0} s")

        # (c) the (4, 2) query mesh over (b)'s first stream.
        t0 = time.perf_counter()
        what = "accuracy (c) (4, 2) mesh"
        roster, frames = generate_frames(num_events, frame_size,
                                         roster_size=100_000,
                                         num_lectures=num_lectures, seed=0)
        config = Config(num_shards=4, num_replicas=2, replica_sync="query",
                        wire_format="word", metrics_port=-1,
                        audit_sample=ACC_SAMPLE)
        pipe, s, t, _, scrape_launches = _accuracy_run(
            card, what, config, roster, frames, num_events, launches,
            mesh=make_mesh(4, 2, [dev] * 8))
        try:
            check(scrape_launches.get("bloom_contains_slice", 0) > 0,
                  f"{what}: one scrape launched {scrape_launches}")
            fpr, fill, _, _ = _accuracy_gates(what, t, pipe, s)
            check(fpr == one["fpr"] and fill == one["fill"]
                  and pipe.validity_counts() == one["counts"],
                  f"{what}: FPR {fpr} fill {fill} != one card's {one}")
            print(f"{what}: measured FPR {fpr} and fill {fill} equal to "
                  f"one card's")
        finally:
            pipe.cleanup()
            obs.disable()
        print(f"accuracy (c): {time.perf_counter() - t0} s")

        t0 = time.perf_counter()
        _accuracy_processor(card, dev, launches)
        print(f"accuracy (d): {time.perf_counter() - t0} s")
        t0 = time.perf_counter()
        _accuracy_serve(card, stream, launches)
        print(f"accuracy (e): {time.perf_counter() - t0} s")
    finally:
        obs.disable()
    print(f"accuracy phase: {time.perf_counter() - t_phase} s")
    print(f"accuracy phase launches (its runs; in the kernels line): "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# -- 13. the chaos soak on the card -------------------------------------------
SOAK_EVENTS = 524_288   # 128 frames: at least 128, as the soak is sized
SOAK_FRAME = 4_096
SOAK_ROSTER = 100_000   # the `fused` default's roster and lectures
SOAK_LECTURES = 16
SOAK_DEADLINE_S = 300.0  # each soak's bounded-termination gate
# (label, spec name, restore check): the JAX soak's two specs, then
# soak.SCRUB_SPEC (every chain write rotted, so rot always survives for
# scrub and the repair ladder), each at its fixed seed of soak.SEEDS.
SOAK_RUNS = (("a", "DEFAULT_SPEC", False), ("b", "ROT_SPEC", True),
             ("b2", "SCRUB_SPEC", True))
SOAK_OFF_RUNS = 3  # 13(c): --chaos off and no injector, interleaved
# The kernels a soak's fault run drives: K3 (the preload) and K2 (the
# step on the default auto wire). The gates' reads and the restore then
# launch K1 (each day's PFCOUNT) and K4 (the false-negative probe).
SOAK_RUN_KERNELS = ("bloom_add", "fused_step")
SOAK_READ_KERNELS = ("hll_histogram", "bloom_contains")


def chaos_phase(card: str, dev, stream) -> dict:
    """Phase 13: the chaos soak on the card. (a) the JAX soak's
    ``DEFAULT_SPEC`` and (b) its ``ROT_SPEC`` through an in-process
    socket broker into the fused pipeline on ``dev``
    (``chaos.soak.run_soak``: state equal to the no-fault run's, zero
    false negatives, reconnects, the circuit, the quarantine, scrub, the
    disk-full counter, partitions; (b) also restored onto the card
    through the repair ladder), (b2) ``soak.SCRUB_SPEC``, whose rot
    always survives the run, so that scrub and the repair ladder always
    have rot to find (under ``ROT_SPEC`` a later base may heal it all),
    each at its seed of ``soak.SEEDS``, and failing if a fault of
    ``soak.GATED`` did not fire, so that no gate passes with nothing to
    check; (c) the ``fused`` default with
    ``--chaos off`` over no injector. The fault run launches K3 and K2
    (counted from 0 just before it and read just after); the gates'
    reads and the restore launch K1 and K4. Returns the soak runs'
    launches, all of them."""
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch import chaos, obs
    from attendance_tpu_torch.chaos import soak
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_chaos_"))
    launches = dict.fromkeys(kernels.launches, 0)
    shape = dict(num_events=SOAK_EVENTS, batch=SOAK_FRAME,
                 roster_size=SOAK_ROSTER, lectures=SOAK_LECTURES)
    wants = {}  # the no-fault state of each seed, run once
    try:
        for label, spec_name, restore in SOAK_RUNS:
            seed = soak.SEEDS[spec_name]
            what = f"chaos ({label}) {spec_name} seed {seed}"
            if seed not in wants:
                wants[seed] = soak.no_fault_state(seed, device=dev, **shape)
            want = wants[seed]
            # Counts set to 0 just before the fault run (and the restore)
            # and read just after.
            kernels.reset_launches()
            report = soak.run_soak(
                seed, spec=getattr(soak, spec_name), workdir=work / label,
                device=dev, max_seconds=SOAK_DEADLINE_S,
                restore_check=restore, want=want, **shape)
            all_launches = dict(kernels.launches)
            run_launches = report.get("run_launches", {})
            reads = {k: all_launches[k] - run_launches.get(k, 0)
                     for k in all_launches}
            print(f"{what}: wall {report['wall_s']} s (the fault run "
                  f"{report.get('run_s')} s, the restore "
                  f"{report.get('restore_s')} s) on {card}")
            print(f"{what}: faults injected per site "
                  f"{json.dumps(report.get('injected'))}")
            print(f"{what}: " + json.dumps(
                {k: v for k, v in report.items()
                 if k not in ("injected", "failures", "seed", "spec")},
                default=str))
            print(f"{what} launches (in the kernels line): the fault "
                  f"run { {k: v for k, v in run_launches.items() if v} }, "
                  f"the gates' reads and the restore "
                  f"{ {k: v for k, v in reads.items() if v} }")
            check(report["ok"], f"{what}: {report['failures']}")
            # Step 4: doctor over the fault run's prom file and alert log.
            check(report.get("doctor_ok") is True,
                  f"{what}: doctor verdict {report.get('doctor_ok')}")
            for name in SOAK_RUN_KERNELS:
                check(run_launches.get(name, 0) > 0,
                      f"{what}: kernel {name} not launched in the fault run")
            for name in SOAK_READ_KERNELS:
                check(reads[name] > 0, f"{what}: kernel {name} not "
                      "launched by the gates' reads")
            injected = report.get("injected") or {}
            for site, fault, _run, _draws in soak.GATED[spec_name]:
                fired = sum(n for key, n in injected.items()
                            if key.endswith(f"/{fault}"))
                check(fired > 0, f"{what}: {fault} never fired, so its "
                      "gate checked nothing")
            if spec_name == "SCRUB_SPEC":
                check(report.get("disk_rot_surviving", 0) > 0,
                      f"{what}: no disk rot survived for scrub to find")
                check(report.get("chain_files_quarantined", 0) > 0,
                      f"{what}: the repair ladder quarantined nothing")
            for name, count in all_launches.items():
                launches[name] += count

        # (c) the injector installed and never firing, against none.
        rates = {"none": [], "off": []}
        for _ in range(SOAK_OFF_RUNS):
            for mode in ("none", "off"):
                chaos.disable()
                pipe, summary = run_with_native(
                    True, Config(chaos="" if mode == "none" else mode),
                    *stream)
                try:
                    inj = chaos.get()
                    check((inj is None) == (mode == "none"),
                          f"chaos (c) {mode}: injector {inj}")
                    check(inj is None or inj.injected_total() == 0,
                          f"chaos (c) {mode}: a fault fired")
                    check(summary["valid"] + summary["invalid"]
                          == stream[0], f"chaos (c) {mode}: event count")
                    rates[mode].append(summary["events_per_second"])
                finally:
                    pipe.cleanup()
                    chaos.disable()
        ratio = np.median(rates["off"]) / np.median(rates["none"])
        print(f"chaos (c) fused default, events/s, no injector "
              f"{rates['none']}, --chaos off {rates['off']}; off/none of "
              f"the medians {ratio} on {card}")
    finally:
        chaos.disable()
        obs.disable()
    print(f"chaos phase: {time.perf_counter() - t_phase} s")
    print(f"chaos phase launches (its fault runs and restore; in the "
          f"kernels line): { {k: v for k, v in launches.items() if v} }")
    return launches


# -- 14. SLOs, the sampling profiler and --profile-dir on the card ----------
SLO_RUNS = 3  # 14(a): telemetry-off and -on sessions, interleaved
# 14(a)'s objectives: the 1.5% FPR ceiling of PERF.md section 2 (the 1%
# default sits 6% above the measured 0.94%), a throughput floor and a
# dispatch-stage p99 ceiling.
SLO_SPECS = ("throughput>=1e6", "dispatch_p99<=0.05", "fpr<=0.015")
SLO_ALERT_DEADLINE_S = 10.0  # 14(b): the wait for a firing line
PROFILE_HZ = 97
PROFILE_PROC_STUDENTS = 1_850  # 14(c): about 20,000 generator events


class _ErrorRecords(logging.Handler):
    """The ERROR records of one logger, kept."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records = []

    def emit(self, record):
        self.records.append(record)


class _LaunchThreads:
    """The thread names that called the K4 and K1 wrappers, by wrapper,
    while installed (the callers reach them through the module)."""

    NAMES = ("bloom_contains", "hll_histogram")

    def __init__(self):
        from attendance_tpu_torch.ops import kernels
        self._kernels = kernels
        self.callers = {name: [] for name in self.NAMES}
        self._real = {}

    def __enter__(self):
        import threading
        for name in self.NAMES:
            real = self._real[name] = getattr(self._kernels, name)

            def spy(*args, _real=real, _seen=self.callers[name], **kw):
                _seen.append(threading.current_thread().name)
                return _real(*args, **kw)

            setattr(self._kernels, name, spy)
        return self

    def __exit__(self, *exc):
        for name, real in self._real.items():
            setattr(self._kernels, name, real)

    def on(self, thread: str, name: str) -> int:
        return sum(c == thread for c in self.callers[name])


def _two_runs(config, stream, checks, after=None):
    """One pipeline on the card, the default stream twice through it (the
    same seed's frames; the second run is on a warm pipeline); returns
    the two runs' events/s and the launches of both, counted from 0 just
    before the first and read just after the second. ``checks(pipe,
    run)`` runs after each run, ``after(pipe)`` after both, before the
    pipeline's cleanup."""
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    num_events, frame_size, num_lectures = stream
    pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()))
    rates = []
    try:
        producer = pipe.client.create_producer(config.pulsar_topic)
        kernels.reset_launches()
        for run in (1, 2):
            roster, frames = generate_frames(
                num_events, frame_size,
                roster_size=min(config.bloom_filter_capacity, num_events),
                num_lectures=num_lectures, seed=0)
            if run == 1:
                pipe.preload(roster)
            for f in frames:
                producer.send(f)
            pipe.run(max_events=num_events * run, idle_timeout_s=1.0)
            rates.append(num_events / pipe.metrics.wall_seconds)
            checks(pipe, run)
        run_launches = dict(kernels.launches)
        if after is not None:
            after(pipe)
        return rates, run_launches
    finally:
        pipe.cleanup()


def _doctor_cli(argv) -> tuple:
    """``python -m attendance_tpu_torch doctor`` in this process: (exit
    code, its printed verdict)."""
    import contextlib
    import io

    from attendance_tpu_torch import cli
    out = io.StringIO()
    code = 0
    with contextlib.redirect_stdout(out):
        try:
            cli.main(["doctor"] + argv)
        except SystemExit as e:
            code = e.code
    return code, out.getvalue()


def _slo_sessions(card: str, ref, stream, work, launches: dict) -> list:
    """14(a): the ``fused`` default with telemetry off and with the SLO
    engine, the sampler, the audit and a prom file on, SLO_RUNS sessions
    a side interleaved, each one pipeline run twice on the same seed's
    frames; the gates on every on session. Returns the off rates (first
    runs), for 14(c)."""
    import threading

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.obs.profiler import ATTRIBUTION_FILE
    from attendance_tpu_torch.ops import kernels

    num_events, frame_size, num_lectures = stream
    rates = {"off": ([], []), "on": ([], [])}
    for i in range(SLO_RUNS):
        for mode in ("off", "on"):
            what = f"slo (a) session {i} telemetry {mode}"
            tel = {}
            if mode == "on":
                tel = dict(metrics_prom=str(work / f"a{i}.prom"),
                           alert_log=str(work / f"a{i}-alerts.jsonl"),
                           profile_hz=PROFILE_HZ,
                           profile_out=str(work / f"a{i}-profile"),
                           audit_sample=0.01, slo=list(SLO_SPECS))
            config = Config(**tel)
            t = obs.enable(config) if mode == "on" else None
            seen = {}

            def checks(pipe, run, t=t, seen=seen, what=what):
                check(pipe.validity_counts() == tuple(
                    run * x for x in ref[0]),
                      f"{what} run {run}: counters differ from phase 3's "
                      "default run (times the runs)")
                check({str(d): n for d, n in sorted(
                    pipe.count_all().items())} == ref[1],
                      f"{what} run {run}: PFCOUNTs differ")
                check(torch.equal(pipe.state.hll_regs, ref[2]),
                      f"{what} run {run}: registers differ")
                if run == 1:
                    check(np.array_equal(pipe.store.to_columns(
                        deduplicate=False)["is_valid"], ref[3]),
                          f"{what}: stored validity differs")
                if t is None:
                    return
                seen[run] = (t.recompiles.total, t.recompiles.steady,
                             len(t.slo._state["throughput"].samples))

            def after(pipe, t=t, seen=seen):
                if t is None:
                    return
                # The engine's thread stopped, then one tick on this
                # thread with nothing in flight: the launches a tick adds.
                t.slo._stop.set()
                t.slo._thread.join(timeout=10.0)
                t.slo._thread = None
                kernels.reset_launches()
                t.slo.tick()
                seen["tick"] = dict(kernels.launches)
                # Telemetry stopped while the pipeline is alive: the last
                # prom block carries the health and audit gauges.
                obs.disable()

            try:
                (r1, r2), run_launches = _two_runs(config, stream, checks,
                                                   after)
                rates[mode][0].append(r1)
                rates[mode][1].append(r2)
                if t is None:
                    continue
                per_tick = {k: v for k, v in seen["tick"].items() if v}
                for name, count in run_launches.items():
                    launches[name] += count + seen["tick"][name]
                check(seen[1][0] > 0, f"{what}: no launch shape counted "
                      "in run 1")
                check(seen[2][1] == 0, f"{what}: {seen[2][1]} steady "
                      f"launch shapes after run 2 "
                      f"{t.recompiles.snapshot()['fingerprints']}")
                check(seen[2][0] == seen[1][0],
                      f"{what}: run 2 counted new shapes")
            finally:
                obs.disable()
            if t is None:
                continue
            for name in ("bloom_contains", "hll_histogram"):
                check(per_tick.get(name, 0) > 0,
                      f"{what}: a tick launched no {name} ({per_tick})")
            doc = json.loads((work / f"a{i}-profile"
                              / ATTRIBUTION_FILE).read_text())
            check(doc["samples_total"] > 0 and "dispatch" in doc["stages"],
                  f"{what}: attribution {doc['stages']}")
            alerts = (work / f"a{i}-alerts.jsonl").read_text()
            check('"firing"' not in alerts, f"{what}: alert log {alerts}")
            code, verdict = _doctor_cli(
                [config.metrics_prom, config.alert_log,
                 "--recompile-ceiling", "0", "--fpr-ceiling", "0.015"])
            print(f"{what}: doctor exit {code}\n{verdict.rstrip()}")
            check(code == 0, f"{what}: doctor exit {code}")
            print(f"{what}: events/s run 1 {rates['on'][0][-1]} run 2 "
                  f"{rates['on'][1][-1]} on {card}; launch shapes "
                  f"{seen[1][0]} after run 1, steady {seen[2][1]} after "
                  f"run 2; SLO ticks {seen[2][2]} in the session; a "
                  f"tick's launches {per_tick}; profile "
                  f"{doc['samples_total']} samples, top {doc['top']}")
    for k, label in ((0, "first"), (1, "second")):
        off = float(np.median(rates["off"][k]))
        on = float(np.median(rates["on"][k]))
        print(f"slo (a) fused default {label} runs, events/s off "
              f"{rates['off'][k]} on {rates['on'][k]}; medians off {off} "
              f"on {on}; on/off {on / off} on {card}")
    check(not [th for th in threading.enumerate()
               if th.name in ("slo-engine", "attendance-profiler")],
          "slo (a): an engine or sampler thread outlived its telemetry")
    return rates["off"][0]


def _firing(alerts, slo_name: str):
    """The alert log's first ``firing`` line of ``slo_name``, or None."""
    for line in alerts.read_text().splitlines():
        event = json.loads(line)
        if event["slo"] == slo_name and event["state"] == "firing":
            return event
    return None


def _slo_alert(card: str, stream, work, launches: dict) -> None:
    """14(b): the FPR objective at 0.0001 over the default run's filter:
    the engine, at a 0.1 s tick, fires from its own thread (K4 each
    tick); doctor over the prom file and alert log exits 1 and names the
    objective."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels

    what = "slo (b) alert"
    alerts = work / "b-alerts.jsonl"
    config = Config(metrics_prom=str(work / "b.prom"),
                    alert_log=str(alerts), audit_sample=0.01,
                    slo=["fpr<=0.0001"], slo_fast_s=0.4, slo_slow_s=1.6)
    t = obs.enable(config)
    try:
        check(t.slo.interval_s == 0.1, f"{what}: tick {t.slo.interval_s}")
        pipe, _summary = run_with_native(True, config, *stream)
        try:
            kernels.reset_launches()
            ticks0 = len(t.slo._state["bloom_measured_fpr"].samples)
            t0 = time.perf_counter()
            with _LaunchThreads() as spy:
                while (not _firing(alerts, "bloom_measured_fpr")
                       and time.perf_counter() - t0 < SLO_ALERT_DEADLINE_S):
                    time.sleep(0.02)
            waited = time.perf_counter() - t0
            check(_firing(alerts, "bloom_measured_fpr") is not None,
                  f"{what}: no firing line in {SLO_ALERT_DEADLINE_S} s")
            ticks = len(t.slo._state["bloom_measured_fpr"].samples) - ticks0
            wait_launches = {k: v for k, v in kernels.launches.items() if v}
            for name, count in kernels.launches.items():
                launches[name] += count
            k4 = spy.on("slo-engine", "bloom_contains")
            check(k4 > 0, f"{what}: no K4 launched from the SLO thread "
                  f"({spy.callers})")
            obs.disable()  # the final tick and prom block
        finally:
            pipe.cleanup()
    finally:
        obs.disable()
    line = _firing(alerts, "bloom_measured_fpr")
    code, verdict = _doctor_cli([config.metrics_prom, str(alerts)])
    print(f"{what}: doctor exit {code}\n{verdict.rstrip()}")
    check(code == 1, f"{what}: doctor exit {code}, not 1")
    check("bloom_measured_fpr" in verdict, f"{what}: verdict names no "
          "bloom_measured_fpr")
    print(f"{what}: firing after {waited} s, {ticks} ticks, K4 from the "
          f"SLO thread {k4} times, launches in the wait {wait_launches}; "
          f"the line {line} on {card}")


def _trace_reading(doc: dict, what: str) -> tuple:
    """Check one card trace against the launches made inside it (the
    trace JSON's ``utils.profiling.LAUNCHES_KEY``); returns (those
    launches, its kernel events by function, the union of its kernel
    intervals and that of its kernel, copy and memset intervals, in
    seconds, and the traced window in seconds: the first host range's
    start to the last device event's end)."""
    from attendance_tpu_torch.utils.profiling import (
        busy_seconds, device_events, kernel_events, kernel_function,
        kernel_launch_shortfall, trace_launches)

    launched = trace_launches(doc)
    kev = kernel_events(doc)
    dev = device_events(doc)
    by_fn = {}
    for e in kev:
        fn = kernel_function(e.get("name", ""))
        by_fn[fn] = by_fn.get(fn, 0) + 1
    short = kernel_launch_shortfall(doc, launched)
    check(not short, f"profile (c) {what}: launches the trace lacks "
          f"(launches, kernel events) {short}")
    starts = [e["ts"] for e in doc["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    ends = [e["ts"] + e.get("dur", 0.0) for e in dev]
    check(starts and kev, f"profile (c) {what}: no range or no kernel "
          "event in the trace")
    return (launched, by_fn, busy_seconds(kev), busy_seconds(dev),
            (max(ends) - min(starts)) / 1e6)


def _busy_line(by_fn: dict, kernel_s: float, busy: float, window: float,
               wall: float) -> str:
    return (f"kernel events {by_fn}; {kernel_s} s of kernel time, "
            f"{busy} s busy with copies and memsets; kernel share "
            f"{kernel_s / window}, busy share {busy / window} (idle "
            f"{1 - busy / window}) of the traced window {window} s; busy "
            f"over the run's wall {wall} s {busy / wall}")


def _profile_dir(card: str, dev, stream, work, off_rates: list,
                 launches: dict) -> None:
    """14(c): ``--profile-dir`` on the ``fused`` default (two traced runs
    of one pipeline: the first starts the profiler's CUDA tracing in
    this process, the second finds it warm) and on the processor over the
    card store; each trace held against the launches made inside it
    (``utils.profiling.trace_launches``)."""
    from datetime import datetime

    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.generator import (
        generate_student_data)
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)
    from attendance_tpu_torch.utils.profiling import TRACE_FILE, range_count

    num_events, frame_size, num_lectures = stream
    frames_n = num_events // frame_size
    pdir = work / "c-fused"
    config = Config(profile_dir=str(pdir))
    pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()))
    try:
        producer = pipe.client.create_producer(config.pulsar_topic)
        kernels.reset_launches()
        for run in (1, 2):
            roster, frames = generate_frames(
                num_events, frame_size,
                roster_size=min(config.bloom_filter_capacity, num_events),
                num_lectures=num_lectures, seed=0)
            if run == 1:
                pipe.preload(roster)
            for f in frames:
                producer.send(f)
            pipe.run(max_events=num_events * run, idle_timeout_s=1.0)
            wall = pipe.metrics.wall_seconds
            doc = json.loads((pdir / TRACE_FILE).read_text())
            what = f"fused run {run}"
            ranges = range_count(doc, "fused_step_dispatch")
            check(ranges == frames_n, f"profile (c) {what}: {ranges} "
                  f"fused_step_dispatch ranges for {frames_n} frames")
            traced, by_fn, kernel_s, busy, window = _trace_reading(doc, what)
            check(traced.get("fused_step", 0) == frames_n,
                  f"profile (c) {what}: launches in the trace {traced}")
            rate = num_events / wall
            print(f"profile (c) {what}: "
                  f"{_busy_line(by_fn, kernel_s, busy, window, wall)} (the "
                  f"profiler's start and export included); events/s {rate}, "
                  f"on/off {rate / float(np.median(off_rates))} (off: 14(a)'s "
                  f"first runs); trace {(pdir / TRACE_FILE).stat().st_size} "
                  f"bytes on {card}")
        for name, count in kernels.launches.items():
            launches[name] += count
    finally:
        pipe.cleanup()

    MemoryBroker.reset_shared()
    pdir = work / "c-processor"
    config = Config(sketch_backend="tpu", profile_dir=str(pdir))
    proc = AttendanceProcessor(config, device=dev)
    try:
        proc.setup_bloom_filter()
        report = generate_student_data(
            producer=proc.client.create_producer(config.pulsar_topic),
            sketch_store=proc.sketch, bloom_key=config.bloom_filter_key,
            num_students=PROFILE_PROC_STUDENTS, num_invalid=50,
            now=datetime(*INGRESS_NOW), seed=0, keep_events=False)
        kernels.reset_launches()
        proc.process_attendance(max_events=report.message_count,
                                idle_timeout_s=1.0)
        for name, count in kernels.launches.items():
            launches[name] += count
        wall, events = proc.metrics.wall_seconds, proc.metrics.events
    finally:
        proc.cleanup()
    check(events == report.message_count, f"profile (c) processor: "
          f"{events} events of {report.message_count}")
    doc = json.loads((pdir / TRACE_FILE).read_text())
    for name in ("bf_exists_batch", "pfadd_batch"):
        check(range_count(doc, name) > 0, f"profile (c) processor: no {name}")
    traced, by_fn, kernel_s, busy, window = _trace_reading(doc, "processor")
    print(f"profile (c) processor: {events} events; launches in the trace "
          f"{ {k: v for k, v in traced.items() if v} }, "
          f"{_busy_line(by_fn, kernel_s, busy, window, wall)}; trace "
          f"{(pdir / TRACE_FILE).stat().st_size} bytes on {card}")


def slo_profiler_phase(card: str, dev, ref, stream) -> dict:
    """Phase 14: the SLO engine, the sampling profiler, the launch-shape
    tracker and ``--profile-dir`` on the card. (a) the ``fused`` default
    with telemetry off and with ``--metrics-prom``, ``--alert-log``,
    ``--profile-hz 97``, ``--profile-out``, ``--audit-sample 0.01`` and
    SLO_SPECS, each session one pipeline run twice on the same frames:
    launch shapes counted in run 1 and none new in run 2, an attribution
    with a ``dispatch`` stage, no firing line, doctor with
    ``--recompile-ceiling 0 --fpr-ceiling 0.015`` exits 0, the state
    phase 3's; (b) an alert fired by the engine's own thread, doctor
    exits 1; (c) ``--profile-dir`` traces holding every launch. Fails on
    an "SLO tick failed" record and on an engine or sampler thread that
    outlives the phase. Returns the launches of its runs and ticks."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.obs import slo
    from attendance_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_slo_"))
    launches = dict.fromkeys(kernels.launches, 0)
    failed_ticks = _ErrorRecords()
    slo.logger.addHandler(failed_ticks)
    try:
        off_rates = _slo_sessions(card, ref, stream, work, launches)
        _slo_alert(card, stream, work, launches)
        _profile_dir(card, dev, stream, work, off_rates, launches)
    finally:
        obs.disable()
        slo.logger.removeHandler(failed_ticks)
        shutil.rmtree(work, ignore_errors=True)
    check(not failed_ticks.records, "slo: " + "; ".join(
        r.getMessage() for r in failed_ticks.records))
    check(not [th for th in threading.enumerate()
               if th.name in ("slo-engine", "attendance-profiler")],
          "slo: an engine or sampler thread outlived the phase")
    print(f"slo phase: {time.perf_counter() - t_phase} s")
    print(f"slo phase launches (its runs and ticks; in the kernels line): "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# Phase 15: the fleet plane and incidents on the card.
INCIDENT_DEADLINE_S = 10.0  # 15(a): the wait for the incident and its reads
FLEET_W0_EVENTS = 65_536    # 15(b): w0's events, 8 of its frames
FLEET_DEAD_AFTER_S = 2.0    # 15(b): the aggregator's silence budget
FLEET_RUNS = 3              # 15(c): push-on and telemetry-off sessions


def _bundle_digests_hold(what: str, bundle) -> dict:
    """Every evidence part is present and its sha256 is the one
    ``incident.json`` records; returns the record."""
    import hashlib

    from attendance_tpu_torch.obs.incident import (
        DIAGNOSIS_FILE, EVIDENCE_PARTS, INCIDENT_FILE)

    rec = json.loads((bundle / INCIDENT_FILE).read_text())
    for name in EVIDENCE_PARTS + (DIAGNOSIS_FILE,):
        part = bundle / name
        check(part.is_file(), f"{what}: bundle part {name} missing")
        check(hashlib.sha256(part.read_bytes()).hexdigest()
              == rec["evidence"].get(name),
              f"{what}: {name}'s digest differs from incident.json's")
    return rec


def _incident_fused(card: str, ref, stream, work, launches: dict) -> None:
    """15(a): the ``fused`` default with the 1% audit, ``fpr<=0.0001`` at
    0.4 / 1.6 s windows, the flight ring, the tracer, the 97 Hz sampler,
    a prom file and ``--incident-dir``: the incident engine opens an
    ``slo_burn`` incident from its own thread, whose bundle's render
    launches K4 and K1 there; ``doctor --incident`` exits 0, 1 on a
    flipped byte, 2 on a missing directory."""
    import shutil

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.obs.incident import find_bundles
    from attendance_tpu_torch.ops import kernels

    what = "incident (a) fused default"
    inc_dir = work / "a-incidents"
    config = Config(metrics_prom=str(work / "a.prom"), flight_recorder=256,
                    trace_out=str(work / "a-trace.json"),
                    profile_hz=PROFILE_HZ, audit_sample=0.01,
                    slo=["fpr<=0.0001"], slo_fast_s=0.4, slo_slow_s=1.6,
                    incident_dir=str(inc_dir))
    t = obs.enable(config)
    try:
        check(t.incidents is not None
              and t.incidents._thread.name == "incident-engine",
              f"{what}: no incident engine thread")
        kernels.reset_launches()
        with _LaunchThreads() as spy:
            pipe, _summary = run_with_native(True, config, *stream)
            run_end = time.time()
            t0 = time.perf_counter()
            try:
                while not (t.incidents.total_opened
                           and spy.on("incident-engine", "bloom_contains")
                           and spy.on("incident-engine", "hll_histogram")):
                    check(time.perf_counter() - t0 < INCIDENT_DEADLINE_S,
                          f"{what}: no incident with K4 and K1 from the "
                          f"incident-engine thread in {INCIDENT_DEADLINE_S}"
                          f" s ({t.incidents.total_opened} opened, "
                          f"callers {spy.callers})")
                    time.sleep(0.02)
                waited = time.perf_counter() - t0
                wait_launches = {k: v for k, v in kernels.launches.items()
                                 if v}
                for name, count in kernels.launches.items():
                    launches[name] += count
                on_thread = {name: spy.on("incident-engine", name)
                             for name in spy.NAMES}
                check(pipe.validity_counts() == ref[0],
                      f"{what}: counters differ from phase 3's")
                check({str(d): n for d, n in sorted(
                    pipe.count_all().items())} == ref[1],
                      f"{what}: PFCOUNTs differ from phase 3's")
                check(torch.equal(pipe.state.hll_regs, ref[2]),
                      f"{what}: registers differ from phase 3's")
                # Telemetry stops while the pipeline is alive: the
                # incident's finalize and the last prom block read it.
                obs.disable()
            finally:
                pipe.cleanup()
    finally:
        obs.disable()
    bundles = find_bundles(inc_dir)
    check(len(bundles) == 1, f"{what}: bundles {bundles}")
    bundle = bundles[0]
    rec = _bundle_digests_hold(what, bundle)
    check(rec["diagnosis_top"] == "slo_burn",
          f"{what}: top rule {rec['diagnosis_top']} {rec['conditions']}")
    check(rec["detail"].get("finalized") == "telemetry-stop",
          f"{what}: incident.json lacks the finalize: {rec['detail']}")
    code, verdict = _doctor_cli(["--incident", str(inc_dir)])
    print(f"{what}: doctor --incident exit {code}\n{verdict.rstrip()}")
    check(code == 0, f"{what}: doctor --incident exit {code} on the bundle")
    bad = work / "a-corrupt"
    shutil.copytree(bundle, bad / bundle.name)
    part = bad / bundle.name / "flight.json"
    raw = bytearray(part.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    part.write_bytes(bytes(raw))
    code_bad, _ = _doctor_cli(["--incident", str(bad)])
    code_gone, _ = _doctor_cli(["--incident", str(work / "no-such-dir")])
    check((code_bad, code_gone) == (1, 2),
          f"{what}: doctor --incident exits {code_bad} on a flipped byte "
          f"and {code_gone} on a missing directory, not 1 and 2")
    print(f"{what}: incident {rec['id']} top rule {rec['diagnosis_top']} "
          f"conditions {rec['conditions']}, opened "
          f"{rec['opened_unix'] - run_end} s after the run's end; K4 and K1 "
          f"from incident-engine {on_thread} within {waited} s; launches "
          f"in the run and the wait {wait_launches}; bundle parts "
          f"{sorted(rec['evidence'])} verified; doctor exits 0 / "
          f"{code_bad} / {code_gone} (bundle / flipped byte / missing) on "
          f"{card}")


def _http_json(port: int, path: str):
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return json.loads(resp.read())


def _fence_spans(trace_doc: dict) -> dict:
    """{process name: fence_publish spans} of a stitched fleet trace."""
    names = {e["pid"]: e["args"]["name"] for e in trace_doc["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    out: dict = {}
    for e in trace_doc["traceEvents"]:
        if e.get("ph") == "X" and e["name"] == "fence_publish":
            out.setdefault(names[e["pid"]], []).append(e)
    return out


def _fleet_federation(card: str, dev, work, launches: dict) -> None:
    """15(b): ``federate`` with a collector (``--fleet-port -1``), its
    own pusher and the incident engine, two workers on the card pushing
    to it; w1 SIGKILLed once its fence span reached the collector: the
    aggregator opens a ``dead_worker`` incident whose bundle holds the
    fleet status; the fleet artifacts hold every role; the merged view
    equals the oracle of w0's run beside w1's preload."""
    import re
    import signal
    from pathlib import Path

    from attendance_tpu_torch import cli
    from attendance_tpu_torch.obs.fleet import STATUS_FILE, TRACE_FILE
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.serve.rpc import QueryClient
    from attendance_tpu_torch.transport.socket_broker import spawn_broker

    what = "fleet (b) federation"
    t_b = time.perf_counter()
    repo = str(Path(__file__).resolve().parent)
    env = _fed_env(repo)
    bdir = work / "b"
    bdir.mkdir()
    fdir, inc_dir = bdir / "fleet", bdir / "incidents"
    stats_file, verb_log = bdir / "fed.json", bdir / "federate.log"
    topic, gossip_topic = "chip-fleet", "chip-fleet-gossip"
    probe = np.random.default_rng(9).integers(
        1 << 21, 1 << 31, 1 << 20).astype(np.uint32)
    procs = []
    broker, addr = spawn_broker(cwd=repo)
    try:
        with open(verb_log, "w") as fh:
            verb = subprocess.Popen(
                [sys.executable, "-m", "attendance_tpu_torch", "federate",
                 "--transport-backend", "socket", "--socket-broker", addr,
                 "--fed-shards", "2", "--fed-gossip-topic", gossip_topic,
                 "--fed-dead-after-s", str(FLEET_DEAD_AFTER_S),
                 "--serve-port", "-1", "--serve-seconds", "600",
                 "--stats-json", str(stats_file), "--stats-every-s", "0.2",
                 "--metrics-port", "-1", "--metrics-interval-s", "0.25",
                 "--fleet-port", "-1", "--fleet-dir", str(fdir),
                 "--fleet-push-interval-s", "0.25",
                 "--incident-dir", str(inc_dir)],
                stdout=fh, stderr=subprocess.STDOUT, cwd=repo, env=env)
        procs.append(verb)
        deadline = time.time() + 120
        while "serving on" not in open(verb_log).read():
            check(verb.poll() is None, f"{what}: federate exited:\n"
                  + open(verb_log).read()[-3000:])
            check(time.time() < deadline, f"{what}: federate never served")
            time.sleep(0.05)
        log = open(verb_log).read()
        collector = re.search(r"fleet collector on (\S+)", log).group(1)
        mport = int(re.search(r"Serving Prometheus metrics on :(\d+)",
                              log).group(1))
        address = [ln for ln in log.splitlines()
                   if "serving on" in ln][0].rsplit(" ", 1)[-1]
        logs = [bdir / f"worker-{s}.log" for s in range(2)]
        gos = [bdir / f"go-{s}" for s in range(2)]
        workers = [_spawn_fed_worker(
            repo, env, logs[s], addr, bdir, s, 2, topic, gossip_topic,
            (FLEET_W0_EVENTS, FED_BATCH)[s], data_plane="memory",
            extra=("--max-events", str((FLEET_W0_EVENTS, FED_BATCH)[s]),
                   "--idle-timeout-s", "10", "--fleet-push", collector,
                   "--ready-file", str(bdir / f"ready-{s}"),
                   "--go-file", str(gos[s])))
            for s in range(2)]
        procs += workers
        # Both workers ready, and each one's preload fence span in the
        # collector's stitched trace.
        deadline = time.time() + 120
        while True:
            for s, p in enumerate(workers):
                check(p.poll() is None, f"{what}: w{s} died:\n"
                      + open(logs[s]).read()[-3000:])
            fences = _fence_spans(_http_json(mport, "/fleet/trace"))
            if (all((bdir / f"ready-{s}").exists() for s in range(2))
                    and "worker:w0" in fences and "worker:w1" in fences):
                break
            check(time.time() < deadline, f"{what}: workers never ready "
                  f"with their fence spans pushed ({sorted(fences)})")
            time.sleep(0.05)
        gos[0].touch()
        workers[1].send_signal(signal.SIGKILL)
        workers[1].wait()
        t_kill = time.time()
        deadline = t_kill + FLEET_DEAD_AFTER_S + 30
        dead = None
        while dead is None:
            for bundle in (sorted(inc_dir.iterdir())
                           if inc_dir.is_dir() else []):
                try:
                    rec = json.loads((bundle / "incident.json").read_text())
                except (FileNotFoundError, json.JSONDecodeError):
                    continue
                if (rec["diagnosis_top"] == "dead_worker"
                        and "peer_down" in rec["conditions"]):
                    dead = (bundle, rec, time.time() - t_kill)
            check(dead is not None or time.time() < deadline,
                  f"{what}: no dead_worker incident at the aggregator")
            time.sleep(0.02)
        _fed_wait([workers[0]], [logs[0]], what, 120)
        deadline = time.time() + 60
        while True:
            doc = (json.loads(stats_file.read_text())
                   if stats_file.exists() else {})
            if doc.get("events") == FLEET_W0_EVENTS:
                break
            check(time.time() < deadline, f"{what}: stats {doc}")
            time.sleep(0.1)
        time.sleep(0.5)  # w0's final full frame folded and published
        kernels.reset_launches()
        oracle = _fed_oracle(dev, 2, FLEET_W0_EVENTS, run_shards=(0,))
        _fed_oracle_reads(dev, oracle, probe)
        for name, count in kernels.launches.items():
            launches[name] += count
        qc = QueryClient(address, batch_max=1 << 16)
        try:
            check(bool(qc.bf_exists(oracle["roster"]).all()),
                  f"{what}: a roster id reads absent from the merged view")
            check(np.array_equal(qc.bf_exists(probe), oracle["k4"]),
                  f"{what}: BF.EXISTS of non-roster ids differs from K4 on "
                  "the oracle's filter")
            days = np.array(sorted(oracle["pfcount"]), np.int64)
            check(qc.pfcount(days).tolist()
                  == [oracle["pfcount"][int(d)] for d in days],
                  f"{what}: PFCOUNT of the merged view differs from the "
                  "oracle's")
            st = qc.stats()
        finally:
            qc.close()
        check((st["valid"], st["invalid"]) == (oracle["valid"],
                                                oracle["invalid"]),
              f"{what}: merged counters ({st['valid']}, {st['invalid']}) vs "
              f"the oracle's ({oracle['valid']}, {oracle['invalid']})")
        verb.send_signal(signal.SIGINT)
        check(verb.wait(timeout=60) == 0, f"{what}: federate exited "
              f"{verb.returncode}:\n" + open(verb_log).read()[-3000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        broker.kill()
        broker.wait()
    log = open(verb_log).read()
    check("tick failed" not in log, f"{what}: a failed tick at the "
          "aggregator:\n" + log[-3000:])
    status = json.loads((fdir / STATUS_FILE).read_text())
    keys = sorted(status["instances"])
    check("worker@w0" in keys and "worker@w1" in keys
          and any(k.startswith("aggregator@") for k in keys),
          f"{what}: FLEET.json holds {keys}")
    for w in ("w0", "w1"):
        check((fdir / f"worker@{w}.prom").is_file(),
              f"{what}: no worker@{w}.prom")
    fences = _fence_spans(json.loads((fdir / TRACE_FILE).read_text()))
    check("worker:w0" in fences and "worker:w1" in fences,
          f"{what}: fleet_trace.json's fence spans {sorted(fences)}")
    bundle, rec, detected = dead
    fleet_doc = json.loads((bundle / "fleet_status.json").read_text())
    check(fleet_doc.get("collected") is True,
          f"{what}: the bundle's fleet_status.json {fleet_doc}")
    _bundle_digests_hold(what, bundle)
    code_inc, verdict = _doctor_cli(["--incident", str(bundle)])
    check(code_inc == 0, f"{what}: doctor --incident exit {code_inc}:\n"
          + verdict)
    snap = bdir / "fleet-snapshot.json"
    code = 0
    try:
        cli.main(["fleet", "--dir", str(fdir), "--once", "--snapshot-json",
                  str(snap)])
    except SystemExit as e:
        code = e.code
    check(code == 0 and json.loads(snap.read_text())["instances"],
          f"{what}: fleet --dir --once --snapshot-json exit {code}")
    code_fleet, verdict = _doctor_cli(["--fleet", str(fdir)])
    check(code_fleet in (0, 1) and "worker@w0:" in verdict
          and "worker@w1:" in verdict,
          f"{what}: doctor --fleet exit {code_fleet}:\n{verdict}")
    print(f"{what}: doctor --fleet exit {code_fleet}\n{verdict.rstrip()}")
    incidents = [json.loads((b / "incident.json").read_text())
                 for b in sorted(inc_dir.iterdir())
                 if (b / "incident.json").is_file()]
    print(f"{what}: FLEET.json roles {keys}; pushes "
          f"{ {k: v['pushes'] for k, v in status['instances'].items()} }; "
          f"fence spans in fleet_trace.json "
          f"{ {k: len(v) for k, v in fences.items()} }; w1 SIGKILLed after "
          f"its fence reached the collector, dead_worker incident "
          f"{rec['id']} seen {detected} s after the kill (opened "
          f"{rec['opened_unix'] - t_kill} s after, silence budget "
          f"{FLEET_DEAD_AFTER_S} s), conditions {rec['conditions']}, its "
          f"fleet_status.json collected with "
          f"{sorted(fleet_doc.get('instances', {}))}; incidents at the "
          f"aggregator {[(i['diagnosis_top'], i['conditions']) for i in incidents]}"
          f"; doctor --incident exit {code_inc}; merged view equal to the "
          f"oracle of w0's {FLEET_W0_EVENTS} events beside w1's preload "
          f"({st['valid']} valid, {st['invalid']} invalid); wall "
          f"{time.perf_counter() - t_b} s on {card}")


def _fleet_overhead(card: str, ref, stream, work, launches: dict) -> None:
    """15(c): the ``fused`` default with a 0.5 s pusher into an
    in-process collector and ``--incident-dir``, against telemetry off,
    FLEET_RUNS sessions a side interleaved, each one pipeline run twice;
    reported, not gated: the on/off ratio of the medians, the pushes and
    the K4/K1 launched from ``fleet-pusher``."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.obs.fleet import FleetCollector

    collector = FleetCollector().start()
    rates = {"off": ([], []), "on": ([], [])}
    pushes, on_pusher = [], []
    try:
        for i in range(FLEET_RUNS):
            for mode in ("off", "on"):
                what = f"fleet (c) session {i} {mode}"
                tel = {}
                if mode == "on":
                    tel = dict(fleet_push=collector.address,
                               fleet_push_interval_s=0.5,
                               incident_dir=str(work / f"c{i}-incidents"))
                config = Config(**tel)
                t = obs.enable(config) if mode == "on" else None

                def checks(pipe, run, what=what):
                    check(pipe.validity_counts() == tuple(
                        run * x for x in ref[0]),
                          f"{what} run {run}: counters differ from phase 3's")
                    check(torch.equal(pipe.state.hll_regs, ref[2]),
                          f"{what} run {run}: registers differ")

                before = sum(v["pushes"] for v in
                             collector.status()["instances"].values())
                with _LaunchThreads() as spy:
                    try:
                        (r1, r2), run_launches = _two_runs(
                            config, stream, checks,
                            after=lambda pipe: obs.disable())
                    finally:
                        obs.disable()
                rates[mode][0].append(r1)
                rates[mode][1].append(r2)
                if t is None:
                    continue
                for name, count in run_launches.items():
                    launches[name] += count
                pushes.append(sum(v["pushes"] for v in collector.status()[
                    "instances"].values()) - before)
                on_pusher.append({name: spy.on("fleet-pusher", name)
                                  for name in spy.NAMES})
                check(pushes[-1] > 0, f"{what}: no push reached the "
                      "collector (the final push at stop)")
    finally:
        obs.disable()
        collector.stop()
    for k, label in ((0, "first"), (1, "second")):
        off = float(np.median(rates["off"][k]))
        on = float(np.median(rates["on"][k]))
        print(f"fleet (c) fused default {label} runs, events/s off "
              f"{rates['off'][k]} on {rates['on'][k]}; medians off {off} "
              f"on {on}; on/off {on / off} on {card}")
    print(f"fleet (c): push frames a session {pushes}; K4/K1 launched "
          f"from fleet-pusher a session {on_pusher} on {card}")


def fleet_incident_phase(card: str, dev, ref, stream) -> dict:
    """Phase 15: the fleet plane and incidents on the card. (a) an
    ``slo_burn`` incident opened by the engine's thread on the ``fused``
    default, its bundle's K4 and K1 launched there, ``doctor
    --incident`` 0 / 1 / 2; (b) ``federate`` with a collector and two
    card workers pushing to it, a ``dead_worker`` incident when w1 is
    SIGKILLed, the fleet artifacts and the merged view against its
    oracle; (c) the pusher's and the incident engine's cost. Fails on a
    failed incident or SLO tick and on an engine, pusher or collector
    thread left after the phase. Returns the launches of its runs,
    waits and oracle."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from attendance_tpu_torch import obs
    from attendance_tpu_torch.obs import fleet, incident, slo
    from attendance_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_fleet_"))
    launches = dict.fromkeys(kernels.launches, 0)
    failed = _ErrorRecords()
    for mod in (incident, slo, fleet):
        mod.logger.addHandler(failed)
    try:
        _incident_fused(card, ref, stream, work, launches)
        # (c) before (b): a CPU rehearsal ran the plain PyTorch versions
        # of telemetry-off runs several times slower after (b)'s
        # processes, which would skew the on/off ratio.
        _fleet_overhead(card, ref, stream, work, launches)
        _fleet_federation(card, dev, work, launches)
    finally:
        obs.disable()
        for mod in (incident, slo, fleet):
            mod.logger.removeHandler(failed)
        shutil.rmtree(work, ignore_errors=True)
    check(not failed.records, "fleet: " + "; ".join(
        r.getMessage() for r in failed.records))
    deadline = time.perf_counter() + 5.0
    while True:
        left = [th.name for th in threading.enumerate()
                if th.name in ("incident-engine", "fleet-pusher",
                               "fleet-collector", "slo-engine")
                or th.name.startswith("fleet-conn")]
        if not left:
            break
        check(time.perf_counter() < deadline,
              f"fleet: threads left after the phase {left}")
        time.sleep(0.02)
    print(f"fleet phase: {time.perf_counter() - t_phase} s")
    print(f"fleet phase launches (its runs, waits and oracle; in the "
          f"kernels line): { {k: v for k, v in launches.items() if v} }")
    return launches


CONTROL_DWELL_S = 2.0       # 16(a), (a2): the engine's dwell (its default)
CONTROL_COOLDOWN_S = 3.0    # 16(a), (a2): the breaker's cooldown, which
# outlasts the driven walk up the ladder (ticks on an injected clock)
CONTROL_PACE_S = 0.075      # 16(b): one frame every 75 ms
CONTROL_REPEATS = 4         # 16(b): the default stream sent 4 times
CONTROL_WINDOW = (4, 10)    # 16(b): the frames sent while inserts fail
CONTROL_B_COOLDOWN_S = 1.0  # 16(b): the breaker's cooldown
CONTROL_DEADLINE_S = 20.0   # 16(b): normal must come back by then
CONTROL_AUDIT_RUNS = 3      # 16(c): audit_every 1 and 8, interleaved
CONTROL_RUNGS = ["audit_wide", "snap_stretch", "temporal_pause", "shed",
                 "temporal_pause", "snap_stretch", "audit_wide", "normal"]


class _Clock:
    """The control engine's injected clock (16(a), (a2))."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


def _wait_for(cond, what: str, timeout_s: float = 60.0) -> None:
    deadline = time.perf_counter() + timeout_s
    while not cond():
        check(time.perf_counter() < deadline, f"control: no {what} within "
              f"{timeout_s} s")
        time.sleep(0.002)


def _clocked_control(config, clk):
    """The telemetry bundle of ``config`` with its controller replaced by
    one on ``clk`` (its thread never started: the phase ticks it, as
    JAX's tests do) and its incident engine's thread stopped (ticked with
    the controller)."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.control import ControlEngine

    t = obs.enable(config)
    t.control.stop()
    t.control = ControlEngine(
        t, config.control_log, spill_dir=config.control_spill_dir,
        dwell_s=config.control_dwell_s,
        clear_ticks=config.control_clear_ticks,
        flap_limit=config.control_flap_limit, _clock=clk)
    if t.incidents is not None:
        t.incidents.stop()
    return t, t.control


def _tick_to(t, eng, clk, rung: int, what: str) -> int:
    """Tick (the incident engine, then the controller) one dwell apart on
    the injected clock until the ladder is at ``rung``; returns the
    ticks."""
    for n in range(1, 64):
        clk.t += CONTROL_DWELL_S + 0.1
        if t.incidents is not None:
            t.incidents.tick()
        eng.tick(clk.t)
        if eng.ladder.rung == rung:
            return n
    check(False, f"{what}: ladder stuck at rung {eng.ladder.rung}, want "
          f"{rung}")
    return 0


def _run_thread(pipe, dev, **run_kw):
    """``pipe.run(**run_kw)`` on a thread of its own (the producer and
    the ticks stay on this one); returns (thread, its error box)."""
    import threading

    box = {}

    def target():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        try:
            pipe.run(**run_kw)
        except BaseException as exc:  # re-raised by the phase's check
            box["error"] = exc

    th = threading.Thread(target=target, name="control-phase-run",
                          daemon=True)
    th.start()
    return th, box


def _join_run(th, box, what: str) -> None:
    th.join(timeout=120.0)
    check(not th.is_alive(), f"{what}: run() did not end")
    check("error" not in box, f"{what}: run() raised {box.get('error')!r}")


def _step_launches(launches: dict) -> int:
    return sum(launches[k] for k in set(STEP_OF_WIRE.values()))


def _ladder_moves(log_path) -> list:
    from attendance_tpu_torch.control import read_actuations

    records, problems = read_actuations(str(log_path))
    check(not problems, f"control: actuation log problems {problems}")
    return [r["to"] for r in records if r["knob"] == "ladder.rung"], records


def _day_regs_equal(what: str, regs, bank_of, ref_regs, ref_bank_of) -> None:
    """Registers held day by day through each run's bank map (a frame
    replayed later may give a day another bank index)."""
    from attendance_tpu_torch.temporal.buckets import is_bucket_key

    days = {d for d in ref_bank_of if not is_bucket_key(d)}
    check(days == {d for d in bank_of if not is_bucket_key(d)},
          f"{what}: lecture days differ")
    for d in days:
        check(torch.equal(regs[bank_of[d]].cpu(),
                          ref_regs[ref_bank_of[d]].cpu()),
              f"{what}: registers of day {d} differ")


def _rows_equal(what: str, rows, ref_rows) -> None:
    for k in ("student_id", "lecture_day", "micros", "is_valid"):
        check(np.array_equal(rows[k], ref_rows[k]),
              f"{what}: stored rows differ in {k}")


def _control_driven(card: str, dev, ref, stream, work, launches,
                    failed) -> None:
    """16(a): the ``fused`` default at full width under a controller
    ticked on an injected clock, pressure from the real sink circuit
    opened by ``persist_fail`` through the chaos plane; the ladder walked
    to ``shed`` and back; frames spilled at rung 4 and drained on the
    clear; the final state equal to phase 3's default run."""
    from attendance_tpu_torch import chaos
    from attendance_tpu_torch.chaos import ChaosSpec
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    num_events, frame_size, num_lectures = stream
    roster, frames = generate_frames(
        num_events, frame_size,
        roster_size=min(Config().bloom_filter_capacity, num_events),
        num_lectures=num_lectures, seed=0)
    frames = list(frames)
    log = work / "a-act.jsonl"
    spill = work / "a-spill"
    kw = dict(snapshot_dir=str(work / "a-warm"), snapshot_mode="delta",
              snapshot_every_batches=2, audit_sample=0.01,
              control_log=str(log), control_spill_dir=str(spill),
              incident_dir=str(work / "a-inc"),
              persist_spill_dir=str(work / "a-persist"),
              persist_breaker_failures=2,
              persist_breaker_cooldown_s=CONTROL_COOLDOWN_S)
    clk = _Clock()
    t, eng = _clocked_control(Config(**kw), clk)
    # Warm-up: the same configuration with no fault on a chain of its
    # own, whose end marks the launch shapes warm.
    kernels.reset_launches()
    warm = FusedPipeline(Config(**kw), client=MemoryClient(MemoryBroker()),
                         device=dev)
    warm.preload(roster)
    producer = warm.client.create_producer(warm.config.pulsar_topic)
    for f in frames:
        producer.send(f)
    warm.run(max_events=num_events, idle_timeout_s=1.0)
    warm.cleanup()
    _add_launches(launches, kernels.launches)
    check(_ladder_moves(log)[0] == [], "16(a): the warm-up actuated")

    cfg = Config(**dict(kw, snapshot_dir=str(work / "a-snap"),
                        chaos="persist_fail=1.0"))
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         device=dev)
    try:
        check(pipe._control is eng and pipe._admission is eng.admission,
              "16(a): the controller is not attached")
        inj, breaker = chaos.get(), pipe.store.breaker
        kernels.reset_launches()  # counts to 0 just before the main path
        pipe.preload(roster)
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        th, box = _run_thread(pipe, dev, max_events=num_events,
                              idle_timeout_s=60.0)
        for f in frames[:2]:
            producer.send(f)
        _wait_for(lambda: pipe.metrics.batches == 2
                  and breaker.state == "open", "open circuit after 2 frames")
        t_open = time.perf_counter()
        knobs = {}
        for rung in (1, 2, 3, 4):
            _tick_to(t, eng, clk, rung, "16(a) escalation")
            knobs[rung] = (pipe._audit_every, pipe._snap_every,
                           eng.admission.mode)
        walk_s = time.perf_counter() - t_open
        check(walk_s < CONTROL_COOLDOWN_S, f"16(a): the walk took {walk_s}"
              " s, past the breaker's cooldown")
        check(knobs[4] == (8, 4 * 2, "spill"), f"16(a): knobs at rung 4 "
              f"{knobs[4]} (audit_every 8, snap_every 4x2, spill)")
        k2 = _step_launches(kernels.launches)
        for f in frames[2:4]:
            producer.send(f)
        _wait_for(lambda: eng.admission.spilled_total == 2,
                  "2 spilled frames")
        spilled_files = sorted(p.name for p in spill.iterdir())
        check(len(spilled_files) == 2 and pipe.metrics.batches == 2
              and _step_launches(kernels.launches) == k2,
              f"16(a): rung 4 dispatched a frame (files {spilled_files}, "
              f"frames {pipe.metrics.batches})")
        # The clear: the fault window closes, the cooldown passes, the
        # controller's nudge half-opens the breaker.
        inj.spec = ChaosSpec.parse("off")
        time.sleep(max(0.0, CONTROL_COOLDOWN_S + 0.05
                       - (time.perf_counter() - t_open)))
        _tick_to(t, eng, clk, 3, "16(a) clear")
        t_drain = time.perf_counter()
        _wait_for(lambda: eng.admission.drained_total == 2
                  and pipe.metrics.batches == 4, "the drain of 2 frames")
        drain_s = time.perf_counter() - t_drain
        drained_k2 = _step_launches(kernels.launches) - k2
        check(drained_k2 == 2, f"16(a): the drain made {drained_k2} K2 "
              "launches for 2 frames")
        _tick_to(t, eng, clk, 0, "16(a) de-escalation")
        for f in frames[4:]:
            producer.send(f)
        _join_run(th, box, "16(a)")
        m = pipe.metrics
        check(m.events == num_events and m.batches == len(frames),
              f"16(a): {m.events} events in {m.batches} frames")
        check(not list(spill.iterdir()), "16(a): the spill directory is "
              "not empty after the final barrier")
        valid_n, invalid_n = pipe.validity_counts()
        check((valid_n, invalid_n) == ref[0] and valid_n + invalid_n
              == num_events, f"16(a): counters {(valid_n, invalid_n)} != "
              f"phase 3's {ref[0]}")
        pf = {str(d): n for d, n in sorted(pipe.count_all().items())}
        check(pf == ref[1], "16(a): PFCOUNTs differ from phase 3's")
        _day_regs_equal("16(a)", pipe.state.hll_regs, pipe._bank_of,
                        ref[2], ref[4])
        rows = _sorted_rows(pipe.store.to_columns(deduplicate=False))
        _rows_equal("16(a)", rows, ref[5])
        truth = np.isin(rows["student_id"], roster)
        check(int((truth & ~rows["is_valid"]).sum()) == 0,
              "16(a): false negatives")
        # Read after the run and its PFCOUNTs: K3, K2 and K1 each ran.
        run_launches = dict(kernels.launches)
        _add_launches(launches, run_launches)
        check(_step_launches(run_launches) == len(frames)
              and run_launches["bloom_add"] > 0
              and run_launches["hll_histogram"] > 0,
              f"16(a): launches {run_launches}")
    finally:
        pipe.cleanup()
    moves, records = _ladder_moves(log)
    check(moves == CONTROL_RUNGS, f"16(a): ladder moves {moves}")
    steady = [line for line in t.render().splitlines()
              if line.startswith("attendance_recompiles_steady_total")]
    check(steady and all(line.endswith(" 0") for line in steady),
          f"16(a): steady launch shapes after warm-up {steady}")
    rc, out = _doctor_cli(["--actuations", str(log)])
    check(rc == 0 and "actuation replay: ok" in out,
          f"16(a): doctor --actuations exit {rc}")
    lines = log.read_text().splitlines()
    tampered = work / "a-tampered.jsonl"
    tampered.write_text("\n".join(lines + [lines[1]]) + "\n")
    rc_t, _ = _doctor_cli(["--actuations", str(tampered)])
    check(rc_t == 1, f"16(a): doctor on a repeated seq exit {rc_t}")
    rc_i, out_i = _doctor_cli(["--incident", str(work / "a-inc"),
                               "--actuations", str(log)])
    xref = [line.strip() for line in out_i.splitlines()
            if " actuation " in line]
    check(xref, f"16(a): doctor --incident --actuations printed no "
          f"cross-reference row (exit {rc_i})")
    print(f"control (a) driven ticks on {card}: rungs {moves}; knobs by "
          f"rung {knobs}; walk {walk_s} s of wall for 8 ticks; 2 frames "
          f"spilled at rung 4 with no K2, drained in {drain_s} s with "
          f"{drained_k2} K2; {len(records)} actuation records, "
          f"{eng.actuations_total} actuations; final state equal to phase "
          f"3 (counters, PFCOUNTs, registers day by day, stored rows); "
          f"spill dir empty; steady shapes {steady}; doctor --actuations "
          f"0, tampered {rc_t}; incident cross-reference {xref}; "
          f"launches {run_launches}")


def _control_temporal(card: str, dev, t_ref, stream, work, launches) -> None:
    """16(a2): phase 3b's temporal configuration driven to rung 3 and back:
    the paused frames launch no K4/K5 window add and no K6 step, exactly
    that many fewer than phase 3b's run, and the core state equals 3b's."""
    from attendance_tpu_torch import chaos
    from attendance_tpu_torch.chaos import ChaosSpec
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    ref_launches, core = t_ref
    num_events, frame_size, num_lectures = stream
    roster, _hot, frames = temporal_frames(num_events, frame_size,
                                           num_lectures)
    paused = (2, 5)  # frames sent at rung 3
    log = work / "a2-act.jsonl"
    # Phase 3b's configuration but for watermark_idle_s 0: the phase
    # waits out the breaker's cooldown with frames buffered, and an idle
    # flush there would add a K6 release no pause predicts.
    cfg = Config(temporal_period_s=60, allowed_lateness_s=5.0,
                 temporal_ring_banks=256, cms_depth=4, cms_width=16384,
                 cms_topk=16, audit_sample=1.0, watermark_idle_s=0.0,
                 control_log=str(log),
                 persist_spill_dir=str(work / "a2-persist"),
                 persist_breaker_failures=2,
                 persist_breaker_cooldown_s=CONTROL_COOLDOWN_S,
                 chaos="persist_fail=1.0")
    clk = _Clock()
    t, eng = _clocked_control(cfg, clk)
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         device=dev)
    try:
        inj, breaker = chaos.get(), pipe.store.breaker
        plane = pipe._temporal
        calls = {"add": 0, "step": 0}
        add, consume = plane._dispatch_add, plane._consume_released

        def counted_add(*a, **k):
            calls["add"] += 1
            return add(*a, **k)

        def counted_consume(rel):
            calls["step"] += int(len(rel["student_id"]) > 0)
            return consume(rel)

        plane._dispatch_add, plane._consume_released = (counted_add,
                                                        counted_consume)
        kernels.reset_launches()
        pipe.preload(roster)
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        th, box = _run_thread(pipe, dev, max_events=num_events,
                              idle_timeout_s=60.0)
        for f in frames[:paused[0]]:
            producer.send(f)
        _wait_for(lambda: pipe.metrics.batches == paused[0]
                  and breaker.state == "open", "open circuit")
        t_open = time.perf_counter()
        _tick_to(t, eng, clk, 3, "16(a2) escalation")
        check(pipe._temporal_paused and eng.admission.mode == "pass",
              "16(a2): rung 3 did not pause the sidecar")
        before = dict(calls)
        for f in frames[paused[0]:paused[1]]:
            producer.send(f)
        _wait_for(lambda: pipe.metrics.batches == paused[1],
                  "the paused frames")
        check(calls == before, f"16(a2): the sidecar ran while paused "
              f"{before} -> {calls}")
        inj.spec = ChaosSpec.parse("off")
        time.sleep(max(0.0, CONTROL_COOLDOWN_S + 0.05
                       - (time.perf_counter() - t_open)))
        _tick_to(t, eng, clk, 0, "16(a2) clear")
        check(not pipe._temporal_paused, "16(a2): still paused at rung 0")
        for f in frames[paused[1]:]:
            producer.send(f)
        _join_run(th, box, "16(a2)")
        run_launches = dict(kernels.launches)
        _add_launches(launches, run_launches)
        n_paused = paused[1] - paused[0]
        deficit = {k: ref_launches[k] - run_launches[k]
                   for k in ("hll_add", "cms_step")}
        check(deficit == {"hll_add": n_paused, "cms_step": n_paused},
              f"16(a2): K5/K6 launches {run_launches['hll_add']}/"
              f"{run_launches['cms_step']} against phase 3b's "
              f"{ref_launches['hll_add']}/{ref_launches['cms_step']}: "
              f"deficit {deficit}, predicted {n_paused} each")
        check(run_launches["hll_add"] == calls["add"]
              and run_launches["cms_step"] == calls["step"]
              and run_launches["bloom_contains"] >= calls["add"]
              and _step_launches(run_launches) == len(frames)
              and run_launches["bloom_add"] > 0,
              f"16(a2): launches {run_launches} against sidecar calls "
              f"{calls}")
        counts = pipe.validity_counts()
        check(counts == core["counts"], f"16(a2): counters {counts} != "
              f"phase 3b's {core['counts']}")
        _day_regs_equal("16(a2)", pipe.state.hll_regs, pipe._bank_of,
                        core["regs"], core["bank_of"])
        _rows_equal("16(a2)", _sorted_rows(
            pipe.store.to_columns(deduplicate=False)), core["rows"])
        stats = pipe.temporal_stats()
    finally:
        pipe.cleanup()
    moves, _records = _ladder_moves(log)
    check(moves == ["audit_wide", "snap_stretch", "temporal_pause",
                    "snap_stretch", "audit_wide", "normal"],
          f"16(a2): ladder moves {moves}")
    print(f"control (a2) temporal, rung 3 and back on {card}: {n_paused} "
          f"paused frames; K5 {run_launches['hll_add']} and K6 "
          f"{run_launches['cms_step']} launches against phase 3b's "
          f"{ref_launches['hll_add']} and {ref_launches['cms_step']} "
          f"(deficit {deficit}, predicted {n_paused} each); windows saw "
          f"{stats['events']} of {num_events} events; core state equal to "
          f"phase 3b's (counters, day registers, stored rows); rungs "
          f"{moves}")


def _control_thread(card: str, dev, stream, work, launches) -> None:
    """16(b): the engine's own thread at a 50 ms tick and a 0.1 s dwell
    over a paced producer, a fault window opening and closing the sink's
    circuit: every rung reached and normal back before a deadline, the
    state equal to an uncontrolled run over the same frames."""
    from attendance_tpu_torch import chaos, obs
    from attendance_tpu_torch.chaos import ChaosSpec
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models.fused import state_to_numpy
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    num_events, frame_size, num_lectures = stream
    roster, frames = generate_frames(
        num_events, frame_size,
        roster_size=min(Config().bloom_filter_capacity, num_events),
        num_lectures=num_lectures, seed=0)
    stream_frames = list(frames) * CONTROL_REPEATS
    total = num_events * CONTROL_REPEATS
    log = work / "b-act.jsonl"
    cfg = Config(metrics_interval_s=0.05, control_dwell_s=0.1,
                 control_log=str(log),
                 control_spill_dir=str(work / "b-spill"),
                 snapshot_dir=str(work / "b-snap"),
                 snapshot_every_batches=2,
                 persist_spill_dir=str(work / "b-persist"),
                 persist_breaker_failures=2,
                 persist_breaker_cooldown_s=CONTROL_B_COOLDOWN_S,
                 chaos="persist_fail=1.0")
    pipe = FusedPipeline(cfg, client=MemoryClient(MemoryBroker()),
                         device=dev)
    try:
        eng = obs.get().control
        check(eng._thread is not None and eng._thread.is_alive()
              and eng.interval_s == 0.05, "16(b): no control-engine thread")
        inj = chaos.get()
        inj.spec = ChaosSpec.parse("off")  # the window opens mid-stream
        timeline = []
        tick = eng.tick

        def timed_tick(now=None):
            out = tick(now)
            timeline.append((time.perf_counter(),
                             eng._g_pressure.value == 1.0, eng.ladder.rung))
            return out

        eng.tick = timed_tick
        drains = []
        drain = pipe._drain_admission

        def timed_drain(limit=16):
            t0 = time.perf_counter()
            n = drain(limit)
            if n:
                drains.append((t0, time.perf_counter(), n))
            return n

        pipe._drain_admission = timed_drain
        kernels.reset_launches()
        pipe.preload(roster)
        producer = pipe.client.create_producer(cfg.pulsar_topic)
        th, box = _run_thread(pipe, dev, max_events=total,
                              idle_timeout_s=60.0)
        t_start = time.perf_counter()
        for i, f in enumerate(stream_frames):
            if i == CONTROL_WINDOW[0]:
                inj.spec = ChaosSpec.parse("persist_fail=1.0")
            elif i == CONTROL_WINDOW[1]:
                inj.spec = ChaosSpec.parse("off")
            time.sleep(max(0.0, t_start + i * CONTROL_PACE_S
                           - time.perf_counter()))
            producer.send(f)
        t_sent = time.perf_counter()
        _join_run(th, box, "16(b)")
        _wait_for(lambda: eng.ladder.rung == 0, "normal after the stream",
                  timeout_s=CONTROL_DEADLINE_S)
        run_launches = dict(kernels.launches)
        _add_launches(launches, run_launches)
        m = pipe.metrics
        check(m.events == total and not list((work / "b-spill").iterdir()),
              f"16(b): {m.events} of {total} events, spill left")
        check(_step_launches(run_launches) == len(stream_frames)
              and run_launches["bloom_add"] > 0,
              f"16(b): launches {run_launches}")
        _, regs, counts = state_to_numpy(pipe.state)
        got = (pipe.validity_counts(), regs, dict(pipe._bank_of),
               _sorted_rows(pipe.store.to_columns(deduplicate=False)))
        adm = eng.admission
        spilled, drained, acts = (adm.spilled_total, adm.drained_total,
                                  eng.actuations_total)
    finally:
        pipe.cleanup()
        obs.disable()
        chaos.disable()
    moves, _records = _ladder_moves(log)
    check(max(r for _t, _p, r in timeline) == 4 and moves[:4]
          == CONTROL_RUNGS[:4] and moves[-1] == "normal",
          f"16(b): ladder moves {moves}")
    first_p = next(t0 for t0, p, _r in timeline if p)
    at4 = next(t0 for t0, _p, r in timeline if r == 4 and t0 >= first_p)
    clear = next(t0 for t0, p, _r in timeline if t0 > at4 and not p)
    at0 = next(t0 for t0, _p, r in timeline if t0 > clear and r == 0)
    drain_s = (drains[-1][1] - drains[0][0]) if drains else 0.0
    check(spilled > 0 and drained == spilled, f"16(b): {spilled} spilled, "
          f"{drained} drained")
    # The oracle: the same frames with no controller, no fault.
    oracle = FusedPipeline(Config(), client=MemoryClient(MemoryBroker()),
                           device=dev)
    try:
        oracle.preload(roster)
        producer = oracle.client.create_producer(oracle.config.pulsar_topic)
        for f in stream_frames:
            producer.send(f)
        oracle.run(max_events=total, idle_timeout_s=1.0)
        _, oregs, _ = state_to_numpy(oracle.state)
        check(got[0] == oracle.validity_counts(), f"16(b): counters "
              f"{got[0]} != {oracle.validity_counts()}")
        _day_regs_equal("16(b)", torch.from_numpy(got[1]), got[2],
                        torch.from_numpy(oregs), oracle._bank_of)
        _rows_equal("16(b)", got[3], _sorted_rows(
            oracle.store.to_columns(deduplicate=False)))
    finally:
        oracle.cleanup()
    print(f"control (b) engine thread (50 ms tick, 0.1 s dwell) on {card}: "
          f"{len(stream_frames)} frames one per {CONTROL_PACE_S} s, inserts "
          f"failing for frames {CONTROL_WINDOW[0]}-{CONTROL_WINDOW[1] - 1}; "
          f"first pressure tick to rung 4 {at4 - first_p} s; clear to rung "
          f"0 {at0 - clear} s; {acts} actuations; {spilled} frames spilled "
          f"and {drained} drained, the drain's wall {drain_s} s over "
          f"{len(drains)} drain calls; stream sent in {t_sent - t_start} s; "
          f"{len(timeline)} ticks; rungs {moves}; state equal to the "
          f"uncontrolled run over the same frames; launches {run_launches}")


def _control_reported(card: str, dev, ref, stream, ingress) -> None:
    """16(c), reported, not gated: the ``fused`` default with the 1% audit
    at ``audit_every`` 1 and 8 (three runs a side, interleaved), and
    phase 7(a)'s JSON wire through 4 lanes per ``--lane-decode``
    engine."""
    from attendance_tpu_torch import obs
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.native import load as load_native
    from attendance_tpu_torch.native.build import python_include
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.loadgen import generate_frames
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    num_events, frame_size, num_lectures = stream
    roster, frames = generate_frames(
        num_events, frame_size,
        roster_size=min(Config().bloom_filter_capacity, num_events),
        num_lectures=num_lectures, seed=0)
    frames = list(frames)
    rates = {1: [], 8: []}
    for _ in range(CONTROL_AUDIT_RUNS):
        for every in (1, 8):
            config = Config(audit_sample=0.01)
            pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                                 device=dev)
            try:
                pipe._audit_every = every  # the knob rung 1 sets
                pipe.preload(roster)
                producer = pipe.client.create_producer(config.pulsar_topic)
                for f in frames:
                    producer.send(f)
                pipe.run(max_events=num_events, idle_timeout_s=1.0)
                check(pipe.validity_counts() == ref[0],
                      f"16(c): audit_every {every} counters")
                rates[every].append(pipe.metrics.events_per_second)
            finally:
                pipe.cleanup()
                obs.disable()
    print(f"control (c) fused default with the 1% audit on {card}: "
          f"audit_every 1 {rates[1]} events/s, audit_every 8 {rates[8]} "
          f"events/s (interleaved, each a first run in its pipeline)")
    header = python_include()
    print(f"control (c) this interpreter's Python.h: {header is not None} "
          f"({header}); the native library has the list scan: "
          f"{load_native().has_list_scan}")
    payloads, jroster = ingress["payloads"], ingress["roster"]
    n = len(payloads)
    for engine in ("auto", "native", "vector"):
        if engine == "native" and header is None:
            print("control (c) --lane-decode native: refused here (no "
                  "Python.h, so no list scan)")
            continue
        config = Config(ingress_lanes=4, lane_decode=engine)
        pipe = FusedPipeline(config, client=MemoryClient(MemoryBroker()),
                             device=dev)
        try:
            pipe.client.create_producer(config.pulsar_topic).send_many(
                payloads)
            pipe.preload(jroster)
            pipe.run(max_events=n, idle_timeout_s=1.0)
            _check_ingress_same(f"16(c) lane decode {engine}",
                                _ingress_state(pipe), ingress["sorted_a"])
            m = pipe.metrics
            print(f"control (c) JSON -> 4 lanes --lane-decode {engine} on "
                  f"{card}: {m.events} events, {m.events_per_second} "
                  f"events/s (wall {m.wall_seconds} s); lane decode "
                  f"seconds {[lane.decode_seconds for lane in pipe.consumer.lanes]}"
                  f"; equal to ingress (a)")
        finally:
            pipe.cleanup()


def _add_launches(into: dict, more: dict) -> None:
    for k, v in more.items():
        into[k] = into.get(k, 0) + v


def control_phase(card: str, dev, ref, t_ref, stream, ingress) -> dict:
    """Phase 16: the control plane on the card. (a) the ``fused`` default
    under a controller ticked on an injected clock, walked to ``shed`` by
    the real sink circuit and back, spilled frames drained on the clear,
    the state equal to phase 3's; (a2) phase 3b's configuration paused at
    rung 3 and back, its K5/K6 deficit exactly the paused frames; (b) the
    engine's own thread over a paced producer with a fault window; (c)
    the audit at ``audit_every`` 1 and 8, and the JSON wire per lane
    decode engine, reported. Fails on a failed control tick and on a
    ``control-engine`` thread left after the phase. Returns the launches
    of its runs."""
    import shutil
    import tempfile
    import threading
    from pathlib import Path

    from attendance_tpu_torch import chaos, obs
    from attendance_tpu_torch.control import engine as control_engine
    from attendance_tpu_torch.obs import incident
    from attendance_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_control_"))
    launches = dict.fromkeys(kernels.launches, 0)
    failed = _ErrorRecords()
    for mod in (control_engine, incident):
        mod.logger.addHandler(failed)
    try:
        for part in (
                lambda: _control_driven(card, dev, ref, stream, work,
                                        launches, failed),
                lambda: _control_temporal(card, dev, t_ref, stream, work,
                                          launches),
                lambda: _control_thread(card, dev, stream, work, launches),
                lambda: _control_reported(card, dev, ref, stream, ingress)):
            t0 = time.perf_counter()
            try:
                part()
            finally:
                obs.disable()
                chaos.disable()
            print(f"control part: {time.perf_counter() - t0} s")
    finally:
        for mod in (control_engine, incident):
            mod.logger.removeHandler(failed)
        shutil.rmtree(work, ignore_errors=True)
    check(not failed.records, "control: " + "; ".join(
        r.getMessage() for r in failed.records))
    left = [th.name for th in threading.enumerate()
            if th.name in ("control-engine", "incident-engine",
                           "control-phase-run")]
    check(not left, f"control: threads left after the phase {left}")
    print(f"control phase: {time.perf_counter() - t_phase} s")
    print(f"control phase launches (its runs; in the kernels line): "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


# -- 17. the repo's crash soaks on the card ------------------------------------
# Phase 3's stream cut into 64 frames of 16,384 events (327,688 bytes a
# planar frame, inside the default ring's 64 slots of 2 MiB): the shm,
# temporal and delta-crash soaks run once more at this size.
CRASH_BIG = dict(num_events=1 << 20, batch=1 << 14, roster_size=100_000,
                 lectures=16)
# The temporal soak's ring at that size: the stream's 4,208 buckets (16
# lectures x 263 periods of 4 s) and room. A restore re-opens every bucket
# of the chain, so a ring the stream fills over-commits after it and keeps
# buckets the no-crash run evicted; with no eviction the windows compare,
# as in the tool's run (8 lectures x 9 periods in 128 buckets).
CRASH_TEMPORAL_RING = 4_352
CRASH_DEADLINE_S = 240.0  # each soak's deadline (process starts included)
STEP_KERNELS = ("fused_step", "fused_step_seg", "fused_step_delta")
TEMPORAL_KERNELS = ("bloom_contains", "hll_add", "cms_step")


def _crash_line(card: str, what: str, report: dict, extra: str = "") -> None:
    print(f"crash {what} on {card}: wall {report.get('wall_s')} s; the "
          f"worker had folded {report.get('killed_at_events')} events at the "
          f"kill ({report.get('kill_after_s')} s after it was fed); resume "
          f"backlog {report.get('resume_backlog')} frames, "
          f"{report.get('restored_frames')} frames drained in "
          f"{report.get('resume_s')} s; faults injected per site "
          f"{json.dumps(report.get('injected'))}; launches: restored run "
          f"{report.get('restored_launches')}, oracle "
          f"{report.get('oracle_launches')}{extra}; ok {report.get('ok')}")


def _crash_gates(what: str, report: dict, temporal: bool = False) -> None:
    """A killed-worker soak: ``ok``, an unacked tail at the kill, and the
    restored run's launches: a step launch for every frame it drained,
    K1 at its counts, and with the temporal plane K4-K6 too."""
    check(report["ok"], f"{what}: {report['failures']}")
    check(report.get("resume_backlog", 0) > 0,
          f"{what}: the kill left no unacked tail")
    got = report.get("restored_launches", {})
    steps = sum(got.get(k, 0) for k in STEP_KERNELS)
    check(steps >= report.get("restored_frames", 1) > 0,
          f"{what}: {steps} step launches for "
          f"{report.get('restored_frames')} frames drained")
    need = ("hll_histogram",) + (TEMPORAL_KERNELS if temporal else ())
    for name in need:
        check(got.get(name, 0) > 0, f"{what}: kernel {name} not launched "
              "by the restored run")
    check(report.get("oracle_launches", {}).get("bloom_add", 0) > 0,
          f"{what}: the oracle's preload launched no K3")


def crash_soak_phase(card: str, dev) -> dict:
    """Phase 17: the repo's crash soaks on the card, each at its JAX
    tool's constants (``tools/chaos_soak.py``'s 32,768 events in 512-event
    frames, 10,000 keys, 8 lectures, capacity 50,000, seed 1;
    ``tools/delta_crash_smoke.py``'s 65,536 in 2,048-event frames;
    ``tools/control_soak.py``'s 32,768 in 512-event frames, 4 lectures,
    seed 20), then the shm, temporal and delta-crash soaks again at
    phase 3's 1,048,576 events (100,000 keys at the default capacity, 16
    lectures, 64 frames): (a) the fault soak on the COLW wire, the rotted
    frame dead-lettered; (b) the shm ring's consumer process SIGKILLed and
    resumed from the ring's cursor; (c) the temporal worker process
    SIGKILLed and restored; (d) the delta-crash worker process SIGKILLed,
    restored, and ``doctor --snapshot-stall-ceiling`` over its artifacts;
    (e) the control soak: the static baseline must breach and the
    controlled run not. The worker processes run on ``cuda:0``. Counts are
    set to 0 before each soak and read after it; each soak reports its
    restored and oracle runs' launches apart. Returns the phase's
    launches, all of them."""
    import shutil
    import tempfile
    from pathlib import Path

    from attendance_tpu_torch import chaos, obs
    from attendance_tpu_torch.chaos import delta_crash, soak
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.control import soak as control_soak
    from attendance_tpu_torch.ops import kernels

    t_phase = time.perf_counter()
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_crash_"))
    launches = dict.fromkeys(kernels.launches, 0)
    tool = dict(capacity=soak.TOOL_CAPACITY, **soak.TOOL_SHAPE)
    seed = soak.TOOL_SEED

    def counted(fn):
        kernels.reset_launches()
        try:
            return fn()
        finally:
            _add_launches(launches, kernels.launches)
            chaos.disable()
            obs.disable()

    try:
        # (a) the COLW wire.
        what = "(a) columnar wire, DEFAULT_SPEC seed 1, 32,768 events"
        r = counted(lambda: soak.run_soak(
            seed, wire="columnar", workdir=work / "a", device=dev,
            max_seconds=CRASH_DEADLINE_S, **tool))
        print(f"crash {what} on {card}: wall {r['wall_s']} s (the fault run "
              f"{r.get('run_s')} s); faults injected per site "
              f"{json.dumps(r.get('injected'))}; quarantined "
              f"{r.get('quarantined')}, dead-lettered "
              f"{r.get('dead_lettered')} of "
              f"{len(soak.poison_frames(seed, 'columnar'))} poison frames; "
              f"launches: the fault run "
              f"{ {k: v for k, v in r.get('run_launches', {}).items() if v} }"
              f"; ok {r['ok']}")
        check(r["ok"], f"crash {what}: {r['failures']}")
        check(r.get("doctor_ok") is True, f"crash {what}: doctor")
        for _site, fault, _run, _draws in soak.GATED["DEFAULT_SPEC"]:
            check(any(k.endswith(f"/{fault}") for k in r.get("injected", {})),
                  f"crash {what}: {fault} never fired")
        steps = sum(r.get("run_launches", {}).get(k, 0) for k in STEP_KERNELS)
        frames = soak.TOOL_SHAPE["num_events"] // soak.TOOL_SHAPE["batch"]
        check(steps >= frames, f"crash {what}: {steps} step launches for "
              f"{frames} frames")

        for label, shape, rest in (
                ("(b)", tool, dict(shm_slots=soak.SHM_SLOTS,
                                   shm_slot_bytes=soak.SHM_SLOT_BYTES)),
                ("(b2)", CRASH_BIG, dict(
                    shm_slots=Config().shm_slots,
                    shm_slot_bytes=Config().shm_slot_bytes))):
            what = (f"{label} shm ring, SHM_SPEC seed 1, "
                    f"{shape['num_events']} events")
            r = counted(lambda: soak.run_shm_soak(
                seed, workdir=work / label, device=dev,
                max_seconds=CRASH_DEADLINE_S, **shape, **rest))
            _crash_line(card, what, r)
            _crash_gates(f"crash {what}", r)
            for fault in ("torn_slot", "writer_stall"):
                check(r.get("injected", {}).get(f"shm.slot/{fault}", 0) > 0,
                      f"crash {what}: {fault} never fired")

        for label, shape, ring in (
                ("(c)", tool, soak.TEMPORAL_RING_BANKS),
                ("(c2)", CRASH_BIG, CRASH_TEMPORAL_RING)):
            what = (f"{label} temporal, TEMPORAL_SPEC seed 1, "
                    f"{shape['num_events']} events, a ring of {ring}")
            r = counted(lambda: soak.run_temporal_soak(
                seed, workdir=work / label, device=dev, ring_banks=ring,
                max_seconds=CRASH_DEADLINE_S, **shape))
            _crash_line(card, what, r, extra=(
                f"; windows {r.get('windows')}; late dropped "
                f"{r.get('stats', {}).get('late_dropped')} (oracle "
                f"{r.get('oracle_stats', {}).get('late_dropped')}), "
                f"rotations {r.get('stats', {}).get('rotations')}, "
                f"evictions {r.get('stats', {}).get('evictions')}"))
            _crash_gates(f"crash {what}", r, temporal=True)
            check(r.get("doctor_ok") is True, f"crash {what}: doctor")
            check(r.get("stats", {}).get("evictions") == 0
                  == r.get("oracle_stats", {}).get("evictions"),
                  f"crash {what}: the ring evicted")

        for label, shape in (
                ("(d)", {}),
                ("(d2)", dict(num_events=CRASH_BIG["num_events"],
                              batch=CRASH_BIG["batch"],
                              roster_size=CRASH_BIG["roster_size"],
                              lectures=CRASH_BIG["lectures"],
                              capacity=100_000))):
            what = (f"{label} delta crash, "
                    f"{shape.get('num_events', delta_crash.NUM_EVENTS)} "
                    f"events")
            r = counted(lambda: delta_crash.run_delta_crash(
                workdir=work / label, device=dev,
                max_seconds=CRASH_DEADLINE_S, **shape))
            _crash_line(card, what, r, extra=(
                f"; doctor --snapshot-stall-ceiling "
                f"{delta_crash.STALL_CEILING_S} exit {r.get('doctor_rc')}"))
            _crash_gates(f"crash {what}", r)

        what = "(e) control soak, seed 20, 32,768 events"
        r = counted(lambda: control_soak.run_control_soak(
            control_soak.SEED, workdir=work / "e", device=dev,
            max_seconds=CRASH_DEADLINE_S))
        base, ctl = r.get("baseline", {}), r.get("controlled", {})
        print(f"crash {what} on {card}: wall {r['wall_s']} s; static "
              f"baseline: dead-lettered {base.get('dead_lettered')}, differs "
              f"from the no-fault run in {base.get('differs_in')}, faults "
              f"{json.dumps(base.get('injected'))}; controlled: "
              f"{json.dumps({k: v for k, v in ctl.items()})}; doctor "
              f"--actuations exit {r.get('doctor_actuations_rc')}, "
              f"--recompile-ceiling 0 exit {r.get('doctor_recompile_rc')}; "
              f"launches {json.dumps(r['launches'])}; ok {r['ok']}")
        check(r["ok"], f"crash {what}: {r['failures']}")
        for run in ("no_fault", "baseline", "controlled"):
            got = r["launches"].get(run, {})
            check(sum(got.get(k, 0) for k in STEP_KERNELS) > 0
                  and got.get("bloom_add", 0) > 0,
                  f"crash {what}: the {run} run launched {got}")
    finally:
        chaos.disable()
        obs.disable()
        shutil.rmtree(work, ignore_errors=True)
    print(f"crash phase: {time.perf_counter() - t_phase} s")
    print(f"crash phase launches (its soaks' runs, oracles and reads; in the "
          f"kernels line): { {k: v for k, v in launches.items() if v} }")
    return launches


# Phase 18: the Pulsar transport on the card, over tests/torch_fake_pulsar.py
# (pulsar-client is not installed on the card's machine).
PULSAR_URL = "pulsar://chip-smoke:6650"
PULSAR_PROC_STUDENTS = 6_100  # 18(c): the generator cut to 65,738 events
PULSAR_NACK_DELAY_MS = 20     # 18(d): the fake's nack redelivery delay
PULSAR_QUIET_FRAMES = 2       # 18(d): the quiet stream's frames
PULSAR_POISON = b"\x00 not a frame"
# 18(c)'s kernels: K7 (the roster preload), K8, K5, K1-rows.
PULSAR_PROC_KERNELS = ("bloom_add_bytes", "bloom_contains_bytes", "hll_add",
                       "hll_histogram_rows")


def install_fake_pulsar():
    """``tests/torch_fake_pulsar.py`` (the pulsar-client 3.x surface over
    a queue of its own) as the ``pulsar`` module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "tests" / "torch_fake_pulsar.py"
    spec = importlib.util.spec_from_file_location("torch_fake_pulsar", path)
    fake = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fake)
    sys.modules["pulsar"] = fake
    return fake


def _step_count(launches: dict) -> int:
    return sum(launches.get(k, 0) for k in STEP_KERNELS)


def _pulsar_fused(card: str, fake, what: str, config, stream, ref,
                  ref_launches, launches: dict) -> None:
    """18(a)/(b): the ``fused`` verb's flow over ``PulsarClient`` (through
    ``make_client``), held to phase 3's default run: counters, PFCOUNTs,
    registers by day, stored rows, and K3/K2/K1 launches."""
    from attendance_tpu_torch.cli import run_fused
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.pipeline.lanes import StripedConsumer
    from attendance_tpu_torch.transport.pulsar_client import PulsarConsumer

    num_events, frame_size, num_lectures = stream
    kernels.reset_launches()  # counts set to 0 just before the run
    pipe, summary = run_fused(config, num_events, frame_size, num_lectures,
                              seed=0)
    run = dict(kernels.launches)  # read just after the run
    try:
        kind = (StripedConsumer if config.ingress_lanes
                else PulsarConsumer)
        check(isinstance(pipe.consumer, kind),
              f"{what}: consumer {type(pipe.consumer).__name__}")
        counts = (summary["valid"], summary["invalid"])
        regs = pipe.state.hll_regs
        by_day = {d: regs[b] for d, b in pipe._bank_of.items()}
        rows = _sorted_rows(pipe.store.to_columns(deduplicate=False))
        lanes = (pipe.consumer.lane_event_totals() if config.ingress_lanes
                 else None)
    finally:
        pipe.cleanup()
    ref_days = {d: ref[2][b] for d, b in ref[4].items()}
    check(counts == ref[0], f"{what}: counters {counts} != {ref[0]}")
    check(summary["unique_attendees"] == ref[1], f"{what}: PFCOUNTs differ")
    check(by_day.keys() == ref_days.keys() and all(
        torch.equal(by_day[d], ref_days[d]) for d in ref_days),
        f"{what}: registers differ from phase 3's default run")
    for name in rows:
        check(np.array_equal(rows[name], ref[5][name]),
              f"{what}: stored column {name} differs")
    check(fake.pending(config.pulsar_topic, FusedPipeline.SUBSCRIPTION,
                       config.pulsar_host) == 0, f"{what}: frames unacked")
    for name in ("bloom_add", "hll_histogram"):
        check(run[name] == ref_launches[name],
              f"{what}: {name} launched {run[name]} times, phase 3 "
              f"{ref_launches[name]}")
    check(_step_count(run) == _step_count(ref_launches),
          f"{what}: step launches {_step_count(run)} != "
          f"{_step_count(ref_launches)}")
    _add_launches(launches, run)
    print(f"pulsar {what} on {card}: {summary['events_per_second']} "
          f"events/s ({summary['events']} events, {summary['batches']} "
          f"frames, wall {summary['wall_seconds']} s); wires "
          f"{summary['wire_dwell']}; lane events {lanes}; equal to phase "
          f"3's default run; launches { {k: v for k, v in run.items() if v} }")


def _pulsar_process(card: str, dev, fake, launches: dict) -> None:
    """18(c): ``process`` with the card store (BASELINE.md config 1's
    100k-student filter at 1%) over ``PulsarClient``, equal to the same
    stream over the memory broker."""
    from datetime import datetime

    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.generator import generate_student_data
    from attendance_tpu_torch.pipeline.processor import AttendanceProcessor
    from attendance_tpu_torch.transport import make_client
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    out = {}
    for label in ("pulsar", "memory"):
        config = (Config(transport_backend="pulsar", pulsar_host=PULSAR_URL)
                  if label == "pulsar" else Config())
        client = (make_client(config) if label == "pulsar"
                  else MemoryClient(MemoryBroker()))
        kernels.reset_launches()  # counts set to 0 just before the flow
        t0 = time.perf_counter()
        proc = AttendanceProcessor(config, device=dev, client=client)
        try:
            proc.setup_bloom_filter()
            report = generate_student_data(
                producer=client.create_producer(config.pulsar_topic),
                sketch_store=proc.sketch, bloom_key=config.bloom_filter_key,
                num_students=PULSAR_PROC_STUDENTS, num_invalid=50, seed=0,
                now=datetime(*INGRESS_NOW), keep_events=False)
            proc.process_attendance(max_events=report.message_count,
                                    idle_timeout_s=1.0)
            wall = time.perf_counter() - t0
            valid, lecture, sid, counts, info = _pipeline_result(proc,
                                                                 report)
            run = dict(kernels.launches)  # the flow and its PFCOUNT reads
            hll = proc.sketch.hll
            regs = {k: hll.regs[b].clone() for k, b in hll._bank_of.items()}
            blooms = {k: [f.clone() for f in c.filters]
                      for k, c in proc.sketch._blooms.items()}
            m = proc.metrics
            out[label] = ((m.events, m.valid_events, m.invalid_events),
                          valid, lecture, sid, counts, info, regs, blooms)
        finally:
            proc.cleanup()
        for name in PULSAR_PROC_KERNELS:
            check(run[name] > 0, f"pulsar process {label}: kernel {name} "
                  "not launched")
        if label == "pulsar":
            _add_launches(launches, run)
            check(fake.pending(config.pulsar_topic,
                               AttendanceProcessor.SUBSCRIPTION,
                               PULSAR_URL) == 0,
                  "pulsar process: events unacked")
        print(f"pulsar process --sketch-backend tpu ({label}) on {card}: "
              f"{m.events} events in {m.batches} batches, "
              f"{m.events_per_second} events/s; generate + process wall "
              f"{wall} s; "
              f"launches { {k: v for k, v in run.items() if v} }")
    a, b = out["pulsar"], out["memory"]
    check(a[0] == b[0] and a[0][0] == report.message_count,
          f"pulsar process: metrics {a[0]} != {b[0]}")
    for i, name in ((1, "validity"), (2, "lecture ids"), (3, "student ids")):
        check(np.array_equal(a[i], b[i]), f"pulsar process: {name} differ")
    check(a[4] == b[4], "pulsar process: PFCOUNTs differ")
    check(a[5] == b[5], f"pulsar process: BF.INFO {a[5]} != {b[5]}")
    check(a[6].keys() == b[6].keys() and all(
        torch.equal(a[6][k], b[6][k]) for k in b[6]),
        "pulsar process: registers differ")
    check(a[7].keys() == b[7].keys() and all(
        len(a[7][k]) == len(b[7][k]) and all(
            torch.equal(x, y) for x, y in zip(a[7][k], b[7][k]))
        for k in b[7]), "pulsar process: filters differ")


def _pulsar_departures(card: str, dev, fake, roster, frames,
                       launches: dict) -> None:
    """18(d): a stream that goes quiet ends by ``idle_timeout_s``, and a
    poison frame among good ones is dead-lettered after exactly
    ``max_redeliveries`` (2) nacks; both equal the memory broker's run of
    the good frames."""
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    from attendance_tpu_torch.pipeline.codec import frame_event_count

    n = sum(frame_event_count(f) for f in frames)

    def run(config, payloads, client=None, **run_kw):
        pipe = FusedPipeline(config, client=client, device=dev)
        pipe.preload(roster)
        producer = pipe.client.create_producer(config.pulsar_topic)
        for p in payloads:
            producer.send(p)
        kernels.reset_launches()  # counts set to 0 just before the run
        t0 = time.perf_counter()
        pipe.run(**run_kw)
        wall = time.perf_counter() - t0
        got = dict(kernels.launches)
        return pipe, _pipe_state(pipe), wall, got

    ref_pipe, ref, _, _ = run(Config(), frames,
                              client=MemoryClient(MemoryBroker()),
                              max_events=n, idle_timeout_s=1.0)
    ref_pipe.cleanup()
    for what, payloads in (
            ("quiet stream", frames),
            ("poison frame", frames[:1] + [PULSAR_POISON] + frames[1:])):
        config = Config(transport_backend="pulsar", pulsar_host=PULSAR_URL,
                        pulsar_topic=f"pulsar-{what.split()[0]}",
                        max_redeliveries=2)
        pipe, got, wall, run_l = run(config, payloads, idle_timeout_s=0.5)
        m = pipe.metrics
        pending = fake.pending(config.pulsar_topic,
                               FusedPipeline.SUBSCRIPTION, PULSAR_URL)
        pipe.cleanup()
        _check_same(f"pulsar {what}", got, ref)
        check(m.events == n, f"pulsar {what}: {m.events} events of {n}")
        check(pending == 0, f"pulsar {what}: {pending} left unacked")
        check(_step_count(run_l) == PULSAR_QUIET_FRAMES,
              f"pulsar {what}: step launches {run_l}")
        want = (2, 1) if what == "poison frame" else (0, 0)
        check((m.nacked_batches, m.dead_lettered) == want,
              f"pulsar {what}: nacked {m.nacked_batches}, dead-lettered "
              f"{m.dead_lettered}, want {want}")
        _add_launches(launches, run_l)
        print(f"pulsar {what} on {card}: ended by idle_timeout_s 0.5 after "
              f"{m.events} events, run wall {wall} s (idle window included), "
              f"nacked {m.nacked_batches}, dead-lettered {m.dead_lettered}; "
              f"equal to the memory broker's run of the good frames; "
              f"launches { {k: v for k, v in run_l.items() if v} }")


def pulsar_phase(card: str, dev, ref, ref_launches, stream) -> dict:
    """Phase 18: the Pulsar transport on the card through ``PulsarClient``
    over the fake: (a) phase 3's ``fused`` default and (b) the same stream
    through ``--ingress-lanes 2`` (the lanes' Message path), each equal to
    phase 3's default run with its K3/K2/K1 launches; (c) ``process`` on
    the card store over 65,738 generator events, equal to the memory
    broker's run with K7/K8/K5/K1-rows launched; (d) the quiet-stream
    idle end and the poison dead-letter. Returns the phase's launches."""
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.ops import kernels
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    t_phase = time.perf_counter()
    fake = install_fake_pulsar()
    fake.NACK_DELAY_MS = PULSAR_NACK_DELAY_MS
    launches = dict.fromkeys(kernels.launches, 0)
    try:
        for what, lanes in (("fused (a)", 0), ("fused --ingress-lanes 2 (b)",
                                                2)):
            _pulsar_fused(card, fake, what, Config(
                transport_backend="pulsar", pulsar_host=PULSAR_URL,
                ingress_lanes=lanes), stream, ref, ref_launches, launches)
        _pulsar_process(card, dev, fake, launches)
        num_events, frame_size, num_lectures = stream
        roster, frames = generate_frames(
            num_events, frame_size,
            roster_size=min(Config().bloom_filter_capacity, num_events),
            num_lectures=num_lectures, seed=0)
        quiet = [next(frames) for _ in range(PULSAR_QUIET_FRAMES)]
        _pulsar_departures(card, dev, fake, roster, quiet, launches)
    finally:
        sys.modules.pop("pulsar", None)
    print(f"pulsar phase: {time.perf_counter() - t_phase} s on {card}")
    print(f"pulsar phase launches (its runs; in the kernels line): "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from attendance_tpu_torch.config import Config
    from attendance_tpu_torch.models import bloom, cms, fused, hll
    from attendance_tpu_torch.ops import build, kernels
    from attendance_tpu_torch.pipeline.events import decode_planar_batch
    from attendance_tpu_torch.pipeline.loadgen import generate_frames

    t_main = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(CARD_QUERY, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # -- 1. build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    # The native host pack too: phase 9's worker processes load both
    # libraries from the cache and compile nothing.
    from attendance_tpu_torch.native import build as native_build
    native_path = native_build()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}, "
          f"{native_path.name}")
    log = lib_path.with_suffix(".log")
    if log.exists():
        print(log.read_text().strip())

    # The launch floor: one fill_ of a one-element int32 tensor, timed as
    # every kernel below is (CUDA-graph replays).
    one = torch.zeros(1, dtype=torch.int32, device=dev)
    floor_ms = kernel_ms(lambda: one.fill_(1))
    print(f"launch floor: fill_ of one int32 ms={floor_ms}")

    rows = {}
    filters = {}  # capacity -> (params, roster, words), for K4 below

    # -- 2a. K3: packed Bloom preload -----------------------------------------
    # Timed into a zeroed filter, as a real preload runs: each replay
    # zeroes the words and then preloads the roster; zero_() alone is
    # timed the same way and subtracted.
    rng = np.random.default_rng(0)
    for capacity in (100_000, 10_000_000):
        params = bloom.derive_bloom_params(capacity, 0.01, "blocked")
        roster_np = (rng.permutation(4 * capacity)[:capacity]
                     + 10_000).astype(np.uint32)
        roster = torch.from_numpy(roster_np.view(np.int32)).to(dev)
        words = bloom.bloom_packed_init(params, dev)
        kernels.bloom_add(words, roster, params)
        plain = bloom.bloom_packed_init(params, dev)
        bloom.bloom_add_packed_plain(plain, roster, params)
        torch.cuda.synchronize()
        err = int((words != plain).sum())
        check(err == 0, f"K3 at {capacity} keys: {err} words differ")
        # Onto a filter that already holds other keys, by either path: the
        # OR keeps them.
        half = capacity // 2
        for binned in (False, True):
            twice = bloom.bloom_packed_init(params, dev)
            kernels.bloom_add(twice, roster[:half], params, binned=binned)
            kernels.bloom_add(twice, roster[half:], params, binned=binned)
            torch.cuda.synchronize()
            check(torch.equal(twice, plain), f"K3 binned={binned} at "
                  f"{capacity} keys: a preload in two halves differs")
        members = roster[torch.randperm(capacity, device=dev)[:100_000]]
        check(bool(bloom.bloom_contains_words(words, members, params).all()),
              f"K3 at {capacity} keys: a member reads absent")
        others = torch.from_numpy(rng.integers(
            50_000_000, 60_000_000, 100_000).astype(np.int32)).to(dev)
        fpr = float(bloom.bloom_contains_words(
            words, others, params).float().mean())
        check(fpr <= 0.01, f"K3 at {capacity} keys: FPR {fpr}")
        filters[capacity] = (params, roster, words)
        touched = int(torch.unique(bloom.bloom_positions(
            roster, params) >> 5).numel())
        b_ms, b_by = bound_ms(4 * capacity + 8 * touched,
                              capacity * (3 * 20 + params.k * 5))
        zero_ms = kernel_ms(lambda: words.zero_())
        # Both paths (one thread per key, binned), each held against the
        # plain version; the wrapper's pick by batch size is the row's.
        picked = capacity >= kernels.K3_BINNED_MIN_KEYS
        for binned in (False, True):
            both_ms = kernel_ms(lambda: (
                words.zero_(),
                kernels.bloom_add(words, roster, params, binned=binned)))
            torch.cuda.synchronize()
            check(torch.equal(words, plain), f"K3 binned={binned} at "
                  f"{capacity} keys: the timed preloads differ")
            if binned == picked:
                ms = both_ms - zero_ms
            print(f"K3 bloom_add keys={capacity} m_bits={params.m_bits} "
                  f"binned={binned} picked_by_wrapper={binned == picked} "
                  f"into a zeroed filter ms={both_ms - zero_ms} (zero_ and K3 "
                  f"{both_ms}, zero_ alone {zero_ms}) above_floor_ms="
                  f"{both_ms - zero_ms - floor_ms} bound_ms={b_ms} ({b_by}) "
                  f"over_bound_ms={both_ms - zero_ms - b_ms} times_bound="
                  f"{(both_ms - zero_ms) / b_ms} max_abs_err=0")
        plain_ms = eager_ms(
            lambda: bloom.bloom_add_packed_plain(plain, roster, params), 3)
        print(f"K3 bloom_add keys={capacity} picked path ms={ms} "
              f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) "
              f"over_bound_ms={ms - b_ms} times_bound={ms / b_ms} fpr={fpr}")
        if capacity == 100_000:
            rows["bloom_add"] = dict(
                replaces="attendance_tpu/models/bloom.py:260", max_abs_err=0,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)

    # -- 2c. K2: fused step, word and bytes wires -----------------------------
    # The main path's frame (131,072 lanes) and a frame 8x as long, more
    # than one resident wave of the card: the state is preloaded with the
    # frames' roster and has taken the first frame.
    params = bloom.derive_bloom_params(100_000, 0.01, "blocked")
    for lanes in (131_072, 1_048_576):
        roster_np, frames = generate_frames(
            2 * lanes, lanes, roster_size=100_000, num_lectures=16, seed=0)
        warm, frame = (decode_planar_batch(f) for f in frames)
        start, _ = fused.init_state(100_000, 0.01, "blocked", 256, 14, dev)
        kernels.bloom_add(start.bloom_bits,
                          torch.from_numpy(roster_np.view(np.int32)).to(dev),
                          params)
        w0, kw0 = wire_of(warm, 0, lanes, dev)
        kernels.fused_step(*start, w0, params, bank_bytes=0, key_bits=kw0)
        n = len(frame["student_id"])
        keys = torch.from_numpy(
            np.array(frame["student_id"]).view(np.int32)).to(dev)
        hit = bloom.bloom_contains_words(start.bloom_bits, keys, params)
        blocks = int(torch.unique(bloom.bloom_positions(
            keys, params)[:, 0] >> 9).numel())
        bucket, _ = hll.hll_bucket_rank(keys[hit], 14)
        day = torch.from_numpy(frame["lecture_day"].astype(np.int64)).to(dev)
        regs_touched = int(torch.unique(
            (day[hit] - 20_260_701) * 16384 + bucket).numel())
        nvalid = int(hit.sum())
        for bank_bytes in (0, 1, 2, 4):
            wire, kw = wire_of(frame, bank_bytes, lanes, dev)
            a = fused.SketchState(*(t.clone() for t in start))
            b = fused.SketchState(*(t.clone() for t in start))
            valid = kernels.fused_step(*a, wire, params,
                                       bank_bytes=bank_bytes, key_bits=kw)
            want = kernels.fused_step_plain(*b, wire, params, bank_bytes, kw,
                                            14)
            torch.cuda.synchronize()
            check(torch.equal(valid[:n], want[:n]),
                  f"K2 w={bank_bytes} lanes={lanes} valid")
            err = int((a.hll_regs.to(torch.int32)
                       - b.hll_regs.to(torch.int32)).abs().max())
            check(err == 0, f"K2 w={bank_bytes} lanes={lanes}: register max "
                  f"abs err {err}")
            check(torch.equal(a.counts, b.counts),
                  f"K2 w={bank_bytes} lanes={lanes} counts")
            ms = kernel_ms(lambda: kernels.fused_step(
                *a, wire, params, bank_bytes=bank_bytes, key_bits=kw))
            plain_ms = eager_ms(lambda: kernels.fused_step_plain(
                *b, wire, params, bank_bytes, kw, 14))
            b_ms, b_by = bound_ms(
                wire.numel() * wire.element_size() + lanes + 64 * blocks
                + 2 * regs_touched + 32,
                lanes * (3 * 20 + params.k * 5 + 5) + nvalid * (2 * 20 + 10))
            print(f"K2 fused_step bank_bytes={bank_bytes} lanes={lanes} "
                  f"ms={ms} above_floor_ms={ms - floor_ms} "
                  f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) "
                  f"max_abs_err={err}")
            if bank_bytes == 0:
                word = (ms, b_ms)
            if bank_bytes == 0 and lanes == 131_072:
                rows["fused_step"] = dict(
                    replaces="attendance_tpu/models/fused.py:175",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)
                k2_inputs = (start, frame, roster_np)
        # K2-seg and K2-delta on the same frame: the header as long as the
        # register rows (256, as the pipeline packs it; 16 banks hold
        # lanes) and, at 131,072 lanes, as long as the temporal plane grows
        # them (512 and 1,024 banks); at 1,048,576 lanes also every lane in
        # one bank (a delta carry over up to 4,095 tiles).
        narrow = [(f"lanes={lanes} banks={nb}", frame, nb)
                  for nb in ((256, 512, 1024) if lanes == 131_072 else (256,))]
        if lanes == 1_048_576:
            narrow.append((f"lanes={lanes} one bank", dict(
                frame, lecture_day=np.full(n, 20_260_704, np.uint32)), 256))
        for what, cols, num_banks in narrow:
            cols_day = torch.from_numpy(
                np.asarray(cols["lecture_day"], np.int64)).to(dev)
            touched = int(torch.unique(
                (cols_day[hit] - 20_260_701) * 16384 + bucket).numel())
            for mode in ("seg", "delta"):
                wire, width, _ = narrow_wire_of(cols, mode, lanes, num_banks,
                                                dev)
                ms, plain_ms, err = narrow_step_check(
                    start, wire, params, mode, width, lanes, num_banks, what)
                nbytes = (wire.numel() * 4 + lanes + 64 * blocks
                          + 2 * touched + 32)
                b_ms, b_by = bound_ms(
                    nbytes, lanes * (3 * 20 + params.k * 5 + 5 + 8 * 3 + 10)
                    + nvalid * (2 * 20 + 10))
                print(f"K2-{mode} fused_step_{mode} {what} width={width} "
                      f"wire_bytes={wire.numel() * 4} ms={ms} above_floor_ms="
                      f"{ms - floor_ms} plain_ms={plain_ms} bound_ms={b_ms} "
                      f"({b_by}) bytes_bound_ms="
                      f"{nbytes / HBM_BYTES_PER_S * 1e3} word_ms={word[0]} "
                      f"word_bound_ms={word[1]} times_word={ms / word[0]} "
                      f"times_bound={ms / b_ms} max_abs_err={err}; decode "
                      f"half's yardstick (graph replays): "
                      + decode_yardstick(wire, mode, width, lanes, num_banks))
                if lanes == 131_072 and num_banks == 256:
                    rows[f"fused_step_{mode}"] = dict(
                        replaces="attendance_tpu/models/fused.py:"
                        + ("261" if mode == "seg" else "386"),
                        max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    start, frame, roster_np = k2_inputs
    lanes = 131_072
    rng_e = np.random.default_rng(6)
    # The edge frame: 100,003 real lanes of 131,072, lanes in 4 of the 256
    # header banks (empty banks before, between and after them), half the
    # keys drawn over all of uint32: the seg wire is 32 bits wide and the
    # delta wire's frame-wide prefix sum wraps.
    n_e = 100_003
    keys_e = np.where(rng_e.random(n_e) < 0.5, rng_e.choice(roster_np, n_e),
                      rng_e.integers(0, 1 << 32, n_e, dtype=np.uint64)
                      ).astype(np.uint32)
    edge = {"student_id": keys_e, "lecture_day": (20_260_701 + rng_e.choice(
        [0, 5, 6, 200], n_e)).astype(np.uint32)}
    # Segment heads on the first and the last lane of a tile: per-bank
    # counts that are multiples of 256 and one either side, in every other
    # bank, the total rounded up to a multiple of 256 (so the first
    # padding lane heads a tile too).
    counts_t = [255, 257, 256, 255, 1, 511, 513, 512, 767, 769, 1023, 1025,
                2047, 2049, 256, 1, 255, 4096, 4097, 4095]
    counts_t.append(-sum(counts_t) % 256 or 256)
    n_t = sum(counts_t)
    tiles_frame = {
        "student_id": np.where(
            rng_e.random(n_t) < 0.9, rng_e.choice(roster_np, n_t),
            rng_e.integers(0, 1 << 21, n_t)).astype(np.uint32),
        "lecture_day": (20_260_701 + np.repeat(
            2 * np.arange(len(counts_t)), counts_t)).astype(np.uint32)}
    # No real lane: every lane is padding.
    empty = {"student_id": np.zeros(0, np.uint32),
             "lecture_day": np.zeros(0, np.uint32)}
    for what, cols in (("edge frame", edge), ("tile-edge heads", tiles_frame),
                       ("no real lane", empty)):
        for mode in ("seg", "delta"):
            wire, width, wraps = narrow_wire_of(cols, mode, lanes, 256, dev)
            if what == "edge frame":
                check(wraps if mode == "delta" else width == 32,
                      f"edge frame: the {mode} wire is not the edge case")
            _, _, err = narrow_step_check(start, wire, params, mode, width,
                                          lanes, 256, what, timed=False)
            print(f"K2-{mode} {what} lanes={lanes} "
                  f"real={len(cols['student_id'])} banks "
                  f"{len(np.unique(cols['lecture_day']))} of 256 "
                  f"width={width} max_abs_err={err}")

    # -- 2d. K4 blocked probe, K5 window PFADD, K6 Count-Min step -------------
    # Exact equality with the plain versions at the temporal path's
    # shapes: one 131,072-event frame.
    for capacity, (f_params, f_roster, f_words) in filters.items():
        half = lanes // 2
        keys = torch.cat([
            f_roster[torch.randperm(capacity, device=dev)[:half]],
            torch.from_numpy(rng.integers(50_000_000, 60_000_000, half)
                             .astype(np.int32)).to(dev)])
        got = kernels.bloom_contains(f_words, keys, f_params)
        want = bloom.bloom_contains_words(f_words, keys, f_params)
        torch.cuda.synchronize()
        err = int((got != want).sum())
        check(err == 0, f"K4 at {capacity}: {err} answers differ")
        check(bool(got[:half].all()), f"K4 at {capacity}: false negative")
        ms = kernel_ms(
            lambda: kernels.bloom_contains(f_words, keys, f_params))
        plain_ms = eager_ms(
            lambda: bloom.bloom_contains_words(f_words, keys, f_params))
        blocks = int(torch.unique(bloom.bloom_positions(
            keys, f_params)[:, 0] >> 9).numel())
        b_ms, b_by = bound_ms(5 * lanes + 64 * blocks,
                              lanes * (3 * 20 + f_params.k * 5))
        print(f"K4 bloom_contains keys={lanes} roster={capacity} "
              f"m_bits={f_params.m_bits} ms={ms} "
              f"above_floor_ms={ms - floor_ms} plain_ms={plain_ms} "
              f"bound_ms={b_ms} ({b_by}) library_ms=None max_abs_err={err}")
        if capacity == 100_000:
            rows["bloom_contains"] = dict(
                replaces="attendance_tpu/ops/pallas_kernels.py:197",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)

    # K5 at two shapes into 512 banks at p=14 (8 MiB), each lane masked
    # by its Bloom answer. "uniform": the frame's keys (about 10% invalid)
    # on banks drawn uniformly over the 512 rows of registers already
    # holding 1M keys. "temporal": the temporal path's first window add
    # (temporal_window_add: about 48 bucket rows, 8 hot keys on 15% of
    # the lanes) into zeroed rows. Timed twice: replayed on the registers
    # the first launch left (no register rises), and
    # from the starting registers (each replay restores them first; the
    # restore alone is timed the same way and subtracted).
    keys = torch.from_numpy(
        np.array(frame["student_id"]).view(np.int32)).to(dev)
    uniform_regs = hll.hll_init(512, 14, dev)
    hll.hll_add(uniform_regs, torch.from_numpy(rng.integers(
        0, 512, 1 << 20, dtype=np.int32)).to(dev),
        torch.from_numpy(rng.integers(0, 1 << 32, 1 << 20, dtype=np.uint64)
                         .astype(np.uint32).view(np.int32)).to(dev), None, 14)
    k5_shapes = {
        "uniform": (torch.from_numpy(rng.integers(0, 512, lanes).astype(
            np.int32)).to(dev), keys,
            kernels.bloom_contains(start.bloom_bits, keys, params),
            uniform_regs),
        "temporal": (*temporal_window_add(dev), hll.hll_init(512, 14, dev))}
    for shape, (bank, keys5, valid, regs) in k5_shapes.items():
        a, b = regs.clone(), regs.clone()
        kernels.hll_add(a, bank, keys5, valid, 14)
        hll.hll_add_plain(b, bank, keys5, valid, 14)
        torch.cuda.synchronize()
        err = int((a.to(torch.int32) - b.to(torch.int32)).abs().max())
        check(err == 0, f"K5 {shape}: register max abs err {err}")
        check(not torch.equal(a, regs), f"K5 {shape} changed no register")
        ms = kernel_ms(lambda: kernels.hll_add(a, bank, keys5, valid, 14))
        restore_ms = kernel_ms(lambda: a.copy_(regs))
        fresh_ms = kernel_ms(lambda: (
            a.copy_(regs), kernels.hll_add(a, bank, keys5, valid, 14)))
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"K5 {shape}: the timed adds differ")
        plain_ms = eager_ms(
            lambda: hll.hll_add_plain(b, bank, keys5, valid, 14))
        bucket, rank = hll.hll_bucket_rank(keys5, 14)
        flat_idx = (bank.to(torch.int64) * 16384 + bucket)[valid]
        flat_rank = rank[valid].to(torch.uint8)
        lib_regs = regs.clone().view(-1)
        library_ms = eager_ms(lambda: lib_regs.scatter_reduce_(
            0, flat_idx, flat_rank, reduce="amax"), 20)
        check(torch.equal(lib_regs.view(512, 16384), a),
              f"K5 {shape} disagrees with scatter_reduce_(amax)")
        kept = int(valid.sum())
        distinct = int(torch.unique(flat_idx).numel())
        b_ms, b_by = bound_ms(9 * lanes + 2 * distinct,
                              lanes * 5 + kept * (2 * 20 + 10))
        print(f"K5 hll_add shape={shape} lanes={lanes} banks=512 "
              f"rows={int(torch.unique(bank).numel())} kept={kept} "
              f"distinct_registers={distinct} replayed ms={ms} "
              f"above_floor_ms={ms - floor_ms} from the start ms="
              f"{fresh_ms - restore_ms} (restore and K5 {fresh_ms}, restore "
              f"alone {restore_ms}) plain_ms={plain_ms} "
              f"scatter_reduce_amax_uint8_ms={library_ms} bound_ms={b_ms} "
              f"({b_by}) max_abs_err={err}")
        if shape == "uniform":
            rows["hll_add"] = dict(
                replaces="attendance_tpu/pipeline/fast_path.py:991",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)
    # The row clear of an evicted bucket stays one index_fill_ (a memset
    # of a whole 16 KiB row, as the JAX scatter-set _t_clear was).
    row = torch.tensor([7], dtype=torch.int64, device=dev)
    check(bool(uniform_regs[7].any()), "row 7 holds no register")
    clear_ms = kernel_ms(lambda: uniform_regs.index_fill_(0, row, 0))
    check(not bool(uniform_regs[7].any()), "index_fill_ left a register set")
    c_ms, c_by = bound_ms(16384 + 8, 0)
    print(f"B11b index_fill_ rows=1 banks=512 ms={clear_ms} "
          f"bound_ms={c_ms} ({c_by})")

    # K6: student ids (duplicates included) into 4 x 16384, at the frame's
    # 131,072 and at 1,048,576 lanes, as the frames give them ("roster")
    # and with the temporal traffic's 8 hot keys over 15% of the lanes.
    for n6 in (131_072, 1_048_576):
        roster6, frames6 = generate_frames(n6, n6, roster_size=100_000,
                                           num_lectures=16, seed=1)
        ids = decode_planar_batch(next(iter(frames6)))["student_id"]
        hot6 = rng.choice(roster6, 8, replace=False)
        mixes = {"roster": ids, "hot": np.where(
            rng.random(n6) < 0.15, hot6[rng.integers(0, 8, n6)],
            ids).astype(np.uint32)}
        for mix, mix_ids in mixes.items():
            keys6 = torch.from_numpy(np.array(mix_ids).view(np.int32)).to(dev)
            counts = cms.cms_init(4, 16384, dev)
            cms.cms_update(counts, keys6)  # a non-empty start
            a, b = counts.clone(), counts.clone()
            est = kernels.cms_step(a, keys6)
            want = cms.cms_step_plain(b, keys6)
            torch.cuda.synchronize()
            err = max(int((a != b).sum()), int((est != want).sum()))
            check(err == 0, f"K6 {mix} n={n6}: {err} counters or estimates "
                  "differ")
            ms = kernel_ms(lambda: kernels.cms_step(a, keys6))
            plain_ms = eager_ms(lambda: cms.cms_step_plain(b, keys6))
            flat_pos = (cms.cms_positions(keys6, 4, 16384)
                        + torch.arange(4, device=dev)[:, None] * 16384
                        ).view(-1)
            b_ms, b_by = bound_ms(
                8 * n6 + 8 * int(torch.unique(flat_pos).numel()),
                n6 * 4 * 25)
            print(f"K6 cms_step keys={n6} mix={mix} depth=4 width=16384 "
                  f"ms={ms} above_floor_ms={ms - floor_ms} "
                  f"plain_ms={plain_ms} bound_ms={b_ms} ({b_by}) "
                  f"max_abs_err={err}")
            if n6 == 131_072 and mix == "roster":
                # The update half alone as one library call: not K6's
                # function (no query), so not K6's library_ms.
                ones = torch.ones(flat_pos.numel(), dtype=torch.int32,
                                  device=dev)
                lib_counts = counts.clone().view(-1)
                update_ms = eager_ms(
                    lambda: lib_counts.index_add_(0, flat_pos, ones), 20)
                print(f"K6 update half alone: index_add_ keys={n6} "
                      f"ms={update_ms} (eager; not the same function)")
                rows["cms_step"] = dict(
                    replaces="attendance_tpu/models/cms.py:116",
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None)

    # -- 3. main path, once per wire ------------------------------------------
    num_events, frame_size, num_lectures = 1 << 20, 1 << 17, 16
    roster, frames = generate_frames(
        num_events, frame_size,
        roster_size=min(Config().bloom_filter_capacity, num_events),
        num_lectures=num_lectures, seed=0)
    cols = [decode_planar_batch(f) for f in frames]
    truth = np.concatenate([c["is_valid"] for c in cols])
    sid = np.concatenate([c["student_id"] for c in cols])
    day = np.concatenate([c["lecture_day"] for c in cols])
    exact = {d: len(np.unique(sid[(day == d) & truth]))
             for d in np.unique(day).tolist()}
    launches = dict.fromkeys(kernels.launches, 0)
    ref = None  # the default run's (counts, PFCOUNTs, registers, validity)
    ref_launches = None  # the default first run's, for phase 18
    rates_p3 = {}  # (wire setting, run) -> events/s
    for label, wire, native in WIRE_RUNS:
        for run in ("first", "second"):
            # Counts set to 0 just before the run and read just after.
            kernels.reset_launches()
            pipe, summary = run_with_native(
                native, Config(wire_format=wire), num_events, frame_size,
                num_lectures)
            run_launches = dict(kernels.launches)
            try:
                stored_cols = pipe.store.to_columns(deduplicate=False)
                stored = stored_cols["is_valid"]
                regs = pipe.state.hll_regs.clone()
                bank_of = dict(pipe._bank_of)
                loaded = pipe._native is not None
                if label == "default" and run == "first":
                    live = pipe._live_regs().clone()
                    days = pipe.lecture_days()
                    # The PFCOUNT path on this run's pipeline: one
                    # count(day) per lecture, and count_all().
                    pfcount_timing(card, "count(day)", [
                        (lambda d=d: pipe.count(d),
                         pipe.state.hll_regs[pipe._bank_of[d]:
                                             pipe._bank_of[d] + 1],
                         [0]) for d in days], reps=3)
                    pfcount_timing(card, "count_all()", [
                        (pipe.count_all, pipe._live_regs(),
                         [pipe._bank_of[d] for d in days])], reps=20)
            finally:
                pipe.cleanup()
            what = f"main path wire={label} run={run}"
            check(loaded == native, f"{what}: native pack loaded={loaded}")
            for name in ("bloom_add", "hll_histogram"):
                check(run_launches[name] > 0, f"{what}: kernel {name} not "
                      "launched")
            for w in summary["wire_dwell"]:
                name = STEP_OF_WIRE[w]
                check(run_launches[name] > 0, f"{what}: kernel {name} not "
                      f"launched for the {w} wire")
            check(wire == "auto"
                  or summary["wire_dwell"] == {wire: summary["batches"]},
                  f"{what}: wires {summary['wire_dwell']}")
            # The gates of PERF.md section 2.
            check(summary["valid"] + summary["invalid"] == num_events,
                  f"{what}: valid + invalid != events")
            false_neg = int((truth & ~stored).sum())
            check(false_neg == 0, f"{what}: {false_neg} false negatives")
            fpr = float((stored & ~truth).sum() / (~truth).sum())
            check(fpr <= 0.015, f"{what}: measured FPR {fpr}")
            check(len(summary["unique_attendees"]) == num_lectures,
                  f"{what}: lecture count")
            worst = max(abs(est - exact[int(d)]) / exact[int(d)]
                        for d, est in summary["unique_attendees"].items())
            check(worst <= 0.03, f"{what}: PFCOUNT relative error {worst}")
            got = ((summary["valid"], summary["invalid"]),
                   summary["unique_attendees"], regs, stored)
            if ref is None:
                # Phase 16 also holds the bank map and the stored rows.
                ref = got + (bank_of, _sorted_rows(stored_cols))
            # Every wire, and every run, equals the default run exactly.
            check(got[:2] == ref[:2], f"{what}: counters or PFCOUNTs differ "
                  "from the default run's")
            check(torch.equal(got[2], ref[2]), f"{what}: registers differ "
                  "from the default run's")
            check(np.array_equal(got[3], ref[3]), f"{what}: stored validity "
                  "differs from the default run's")
            if run == "first":
                for name, count in run_launches.items():
                    launches[name] += count
                if label == "default":
                    ref_launches = run_launches
            rates_p3[(label, run)] = summary["events_per_second"]
            device_ms = sum(run_launches[k] * rows[k]["ms"]
                            for k in set(STEP_OF_WIRE.values()))
            print(f"{what}: {summary['events_per_second']} events/s "
                  f"({summary['events']} events, {summary['batches']} "
                  f"frames, wall {summary['wall_seconds']} s) on {card}; "
                  f"native pack {loaded}; valid {summary['valid']} invalid "
                  f"{summary['invalid']} fpr {fpr} worst_pfcount_err {worst} "
                  f"wires {summary['wire_dwell']} launches {run_launches}; "
                  f"step kernel time {device_ms} ms (launches x phase 2c)")
            print(f"{what} host stages (s): {summary['stage_seconds']}")

    # -- 3c. the JSON metrics line of one more default run -------------------
    metrics_line_phase(card, num_events, frame_size, num_lectures, ref)

    # -- 2b. K1 at the PFCOUNT path's bank counts, on two fills (the main
    # path's registers among them, so after phase 3) --------------------------
    check(live.shape[0] == num_lectures, f"{live.shape[0]} live banks")
    histogram_phase(dev, floor_ms, live, rows)

    # -- 3b. temporal path ----------------------------------------------------
    t_launches, t_core = temporal_path(card, num_events, frame_size,
                                       num_lectures, rows)

    # -- 5. checkpoint and restore (its launches on its own line) -------------
    checkpoint_phase(card, num_events, frame_size, num_lectures, ref)

    # -- 6. the generic sketch store and the processor loop -------------------
    s_launches = store_phase(card, floor_ms, rows)

    # -- 7. the reference's JSON wire into the fused path ---------------------
    ingress = ingress_phase(card, dev)
    i_launches = ingress["launches"]

    # -- 8. striped lanes, the shm ring, and the query plane ------------------
    l_launches = lanes_serve_phase(card, dev, ingress, ref, rates_p3,
                                   (num_events, frame_size, num_lectures))

    # -- 9. federation: workers on the card, gossip, failover ----------------
    f_launches = federation_phase(card, dev)

    # -- 10. the mesh engine on virtual meshes of the card --------------------
    m_launches = mesh_phase(card, dev, floor_ms, rows, ref, generate_frames(
        num_events, frame_size,
        roster_size=min(Config().bloom_filter_capacity, num_events),
        num_lectures=num_lectures, seed=0))

    # -- 11. the telemetry core on the card -----------------------------------
    tel_launches = telemetry_phase(card, dev, ref,
                                   (num_events, frame_size, num_lectures))

    # -- 12. live accuracy on the card ----------------------------------------
    acc_launches = accuracy_phase(card, dev, ref,
                                  (num_events, frame_size, num_lectures))

    # -- 13. the chaos soak on the card ---------------------------------------
    chaos_launches = chaos_phase(card, dev,
                                 (num_events, frame_size, num_lectures))

    # -- 14. SLOs, the sampling profiler and --profile-dir ---------------------
    slo_launches = slo_profiler_phase(card, dev, ref,
                                      (num_events, frame_size, num_lectures))

    # -- 15. the fleet plane and incidents ------------------------------------
    fleet_launches = fleet_incident_phase(
        card, dev, ref, (num_events, frame_size, num_lectures))

    # -- 16. the control plane and the list scan -------------------------------
    control_launches = control_phase(
        card, dev, ref, (t_launches, t_core),
        (num_events, frame_size, num_lectures), ingress)

    # -- 17. the repo's crash soaks ---------------------------------------------
    crash_launches = crash_soak_phase(card, dev)

    # -- 18. the Pulsar transport -----------------------------------------------
    pulsar_launches = pulsar_phase(card, dev, ref, ref_launches,
                                   (num_events, frame_size, num_lectures))

    # -- 4. summary -----------------------------------------------------------
    print(f"chip_smoke: {time.perf_counter() - t_main} s in all")
    print(card)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=row["replaces"],
             launches=(launches[name] + t_launches[name]
                       + s_launches[name] + i_launches[name]
                       + l_launches[name] + f_launches[name]
                       + m_launches[name] + tel_launches[name]
                       + acc_launches[name] + chaos_launches[name]
                       + slo_launches[name] + fleet_launches[name]
                       + control_launches[name] + crash_launches[name]
                       + pulsar_launches[name]),
             max_abs_err=row["max_abs_err"], ms=row["ms"],
             plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
             bound_by=row["bound_by"], library_ms=row["library_ms"])
        for name, row in rows.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. card and build: the card's name and power limit, then the kernels
     built from ``attendance_tpu_torch/csrc`` with nvcc (time and the
     compiler's per-kernel resource report);
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
  4. a ``kernels`` JSON line and, last, the ``{"ok": true, ...}`` line.
     A kernel's ``launches`` there sums phase 3's first runs (one per
     wire setting), phase 3b's temporal run, phase 6's pipeline run,
     phase 7(a) and phase 8's runs (each also printed on a line of its
     own); phase 5 prints its own runs' counts on a line of its own.

Needs one CUDA card; exits non-zero without one, and without the rest
of the repository beside it.
"""

from __future__ import annotations

import dataclasses
import json
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
                    num_lectures: int):
    """``run_fused`` on the card at seed 0, with the native host pack or,
    with ``native`` False, the numpy pack (``ATP_NATIVE=0`` while the
    pipeline is built, as a user would set it)."""
    import os

    from attendance_tpu_torch.cli import run_fused
    from attendance_tpu_torch.transport.memory_broker import (
        MemoryBroker, MemoryClient)

    before = os.environ.get("ATP_NATIVE")
    if not native:
        os.environ["ATP_NATIVE"] = "0"
    try:
        return run_fused(config, num_events, frame_size, num_lectures,
                         seed=0, client=MemoryClient(MemoryBroker()))
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
    """Phase 3b; returns the run's launch counts."""
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
        stored = pipe.store.to_columns(deduplicate=False)["is_valid"]
        shadow = pipe._temporal.shadow_truth()
        cms_counts = pipe._temporal.cms_counts.clone()
        num_banks = pipe.state.hll_regs.shape[0]
        pfcount_timing(card, "window_counts()", [
            (pipe.window_counts, pipe._live_regs(),
             [b for k, b in pipe._bank_of.items() if is_bucket_key(k)])],
            reps=10)
    finally:
        pipe.cleanup()

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
    return launches


def _pipe_state(pipe):
    """(counters, PFCOUNTs, registers, bank map, deduped store) of a
    pipeline, for exact comparison."""
    return (pipe.validity_counts(),
            {str(d): n for d, n in sorted(pipe.count_all().items())},
            pipe.state.hll_regs.clone(), dict(pipe._bank_of),
            pipe.store.to_columns())


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
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
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
                stored = pipe.store.to_columns(deduplicate=False)["is_valid"]
                regs = pipe.state.hll_regs.clone()
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
                ref = got
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

    # -- 2b. K1 at the PFCOUNT path's bank counts, on two fills (the main
    # path's registers among them, so after phase 3) --------------------------
    check(live.shape[0] == num_lectures, f"{live.shape[0]} live banks")
    histogram_phase(dev, floor_ms, live, rows)

    # -- 3b. temporal path ----------------------------------------------------
    t_launches = temporal_path(card, num_events, frame_size, num_lectures,
                               rows)

    # -- 5. checkpoint and restore (its launches on its own line) -------------
    checkpoint_phase(card, num_events, frame_size, num_lectures, ref)

    # -- 6. the generic sketch store and the processor loop --------------------
    s_launches = store_phase(card, floor_ms, rows)

    # -- 7. the reference's JSON wire into the fused path ----------------------
    ingress = ingress_phase(card, dev)
    i_launches = ingress["launches"]

    # -- 8. striped lanes, the shm ring, and the query plane ------------------
    l_launches = lanes_serve_phase(card, dev, ingress, ref, rates_p3,
                                   (num_events, frame_size, num_lectures))

    # -- 4. summary -----------------------------------------------------------
    print(f"chip_smoke: {time.perf_counter() - t_main} s in all")
    print(card)
    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=SOURCE,
             replaces=row["replaces"],
             launches=(launches[name] + t_launches[name]
                       + s_launches[name] + i_launches[name]
                       + l_launches[name]),
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

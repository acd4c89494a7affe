"""A standing backlog of binary frames drained by ``FusedPipeline.run``.

Set-up makes a pool of distinct frames from the seed, builds the
pipeline on its own in-process memory broker, preloads the roster and
warms up on the pool until every lecture-day of the configuration has
its bank. The pool is then republished in turn (the broker shares the
frames' bytes, it copies none), one chunk of frames ahead of the
consumer, so the broker never runs dry and the consumer drains as fast
as the program allows.

The window runs ``run(max_events=...)`` a chunk at a time until its
seconds have passed; every ``run`` returns only once each frame it took
in is stepped and acknowledged, and the window closes with a
``synchronize``. Its rate is all the events of the window over all of
its seconds.

After the window the program's outputs are judged against the plain
reference (``portbench/reference.py``), which works the filter, each
frame's validity, the registers, the counters and the PFCOUNT answers
out again from the roster and the frames the program was fed (warm-up
included), in the order and as often as it was fed them.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench import reference as ref
from portbench.drivers import chunk_quartiles
from portbench.generators import planar_frames as gen
from portbench.roofline import SECTOR_BYTES, step_state_bytes

def pool_frames(traffic: dict, llc: Optional[int]) -> int:
    """Frames in the pool: at least ``pool_llc_multiple`` times the
    last-level cache and at least ``pool_min_bytes``."""
    want = traffic["pool_min_bytes"]
    if llc:
        want = max(want, traffic["pool_llc_multiple"] * llc)
    return -(-want // gen.frame_bytes(traffic["frame_events"]))


class Driver:
    layout = "blocked"  # the roster filter's layout
    e2e = "events_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 llc: Optional[int] = None):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.frames = pool_frames(traffic, llc)
        self.chunk = traffic["chunk_frames"]
        self.published: List[int] = []
        self.cursor = 0

    # -- set-up -------------------------------------------------------------
    def setup(self, trace_path: Optional[Path] = None) -> Dict[str, object]:
        from attendance_tpu_torch.config import Config
        from attendance_tpu_torch.pipeline.fast_path import FusedPipeline
        from attendance_tpu_torch.transport.memory_broker import (
            MemoryBroker, MemoryClient)

        times = {}
        t = time.perf_counter()
        self.roster, self.pool = gen.generate(self.cfg, self.traffic,
                                              self.seed, self.frames)
        times["pool_s"] = time.perf_counter() - t
        config = Config(bloom_filter_capacity=self.cfg["roster_size"],
                        bloom_filter_error_rate=self.cfg["bloom_error_rate"],
                        hll_precision=self.cfg["hll_precision"])
        self.broker = MemoryBroker()
        self.pipe = FusedPipeline(config, client=MemoryClient(self.broker),
                                  device=self.device)
        self.sub = self.broker.topic(config.pulsar_topic).subscription(
            FusedPipeline.SUBSCRIPTION)
        self.producer = self.pipe.client.create_producer(config.pulsar_topic)
        times["pipeline_s"] = time.perf_counter() - t - times["pool_s"]
        self.pipe.preload(self.roster)
        self._publish(self.chunk)
        # Warm up until every lecture-day has its bank (bounded: a
        # program that never registers them is judged, not waited for).
        done = 0
        while done < self.traffic["warmup_frames"] or (
                len(self.pipe.lecture_days()) < self.cfg["lecture_days"]
                and done < 4 * self.traffic["warmup_frames"]):
            self._run_chunk()
            done += self.chunk
        if trace_path is not None:
            # The first profiler of a process starts CUPTI, which takes
            # seconds: done here, outside the traced window.
            from portbench.trace import traced
            traced(self._run_chunk, trace_path)
        times["warmup_s"] = (time.perf_counter() - t - times["pool_s"]
                             - times["pipeline_s"])
        return {"pool_frames": self.frames,
                "pool_bytes": sum(len(f) for f in self.pool),
                "wire_dwell": dict(self.pipe.metrics.wire_dwell), **times}

    def _publish(self, k: int) -> None:
        idx = [(self.cursor + i) % self.frames for i in range(k)]
        self.cursor += k
        self.published.extend(idx)
        self.producer.send_many([self.pool[i] for i in idx])

    def _run_chunk(self) -> None:
        m = self.pipe.metrics
        self.pipe.run(max_events=m.events
                      + self.chunk * self.traffic["frame_events"],
                      idle_timeout_s=5.0)
        self._publish(self.chunk)

    # -- the window ---------------------------------------------------------
    def window(self, seconds: float,
               trace_path: Optional[Path] = None) -> Dict[str, object]:
        import torch

        m = self.pipe.metrics
        stages0, ev0, fr0 = dict(m.stage_seconds), m.events, m.batches
        nacked0 = m.nacked_batches + m.dead_lettered

        chunks: List[float] = []

        def loop() -> float:
            if self._cuda:
                torch.cuda.synchronize(self.device)
            t0 = t = time.perf_counter()
            while True:
                self._run_chunk()
                now = time.perf_counter()
                chunks.append(now - t)
                t = now
                if now - t0 >= seconds:
                    break
            if self._cuda:
                torch.cuda.synchronize(self.device)
            return time.perf_counter() - t0

        summary = None
        if trace_path is None:
            wall = loop()
        else:
            from portbench.trace import traced
            wall, summary = traced(loop, trace_path)
        events, frames = m.events - ev0, m.batches - fr0
        stages = {k: m.stage_seconds[k] - stages0.get(k, 0.0)
                  for k in m.stage_seconds}
        # The frames the window took in, by position in the feed: the
        # judgement adds their least state bytes (``state_bytes``).
        self._window_frames = (fr0, fr0 + frames)
        self._sources = sources = {
            "events": events, "frames": frames, "window_s": wall,
            "stages": stages, "trace": summary}
        return {"e2e": {self.e2e: events / wall}, "sources": sources,
                "attempted": events,
                "failed": (m.nacked_batches + m.dead_lettered - nacked0)
                * self.traffic["frame_events"],
                "window_s": wall,
                "notes": {"wire_dwell": dict(m.wire_dwell),
                          "frames": frames,
                          "chunk_s": chunk_quartiles(chunks)}}

    @property
    def _cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    # -- the judgement ------------------------------------------------------
    def _fed(self) -> np.ndarray:
        return np.asarray(self.published[:self.pipe.metrics.batches],
                          np.int64)

    def reference(self, probes: Optional[int] = None) -> Dict[str, object]:
        """What the program's outputs should be, from the roster and the
        frames fed: filter words, validity by pool frame, registers and
        PFCOUNT by day, the valid and invalid counters; and each frame's
        least state bytes (``portbench/roofline.py``). The frames are
        worked on a thread each; the registers are merged here."""
        c = self.cfg
        f = ref.filter_params(c["roster_size"], c["bloom_error_rate"])
        p = c["hll_precision"]
        words = ref.build_filter(self.roster, f, probes)
        times = np.bincount(self._fed(), minlength=self.frames)

        def frame(i):
            sid, day = gen.decode_ids(self.pool[i])
            pos = ref.probe_bits(sid, f, probes)
            v = ref.lookup(words, pos)
            d = day.astype(np.int64) - gen.FIRST_DAY
            bucket, rank = ref.bucket_rank(sid[v], p)
            cell = d[v] << p | bucket
            touched = step_state_bytes(
                len(np.unique(pos[:, 0] // ref.BLOCK_BITS)),
                len(np.unique(cell // SECTOR_BYTES)), len(sid))
            return int(i), v, cell, rank, np.unique(d), touched

        regs = np.zeros((c["lecture_days"], 1 << p), np.uint8)
        valid_by_frame: Dict[int, np.ndarray] = {}
        touched: Dict[int, int] = {}
        days_seen = np.zeros(c["lecture_days"], bool)
        nvalid = ninvalid = 0
        with ThreadPoolExecutor(os.cpu_count()) as pool:
            for i, v, cell, rank, days, nbytes in pool.map(
                    frame, np.nonzero(times)[0]):
                valid_by_frame[i], touched[i] = v, nbytes
                days_seen[days] = True
                np.maximum.at(regs.reshape(-1), cell, rank.astype(np.uint8))
                nv = int(v.sum())
                nvalid += int(times[i]) * nv
                ninvalid += int(times[i]) * (len(v) - nv)
        days = [gen.FIRST_DAY + int(d) for d in np.nonzero(days_seen)[0]]
        return {"words": words, "valid": valid_by_frame, "touched": touched,
                "regs": {day: regs[day - gen.FIRST_DAY] for day in days},
                "pfcount": {day: ref.pfcount(regs[day - gen.FIRST_DAY], p)
                            for day in days},
                "counters": (nvalid, ninvalid)}

    def program_outputs(self) -> Dict[str, object]:
        """The program's own outputs, read after the window: the
        filter, the registers by the program's day -> bank map, the
        stored blocks' validity, the counters and ``count_all``."""
        pipe = self.pipe
        regs = pipe.state.hll_regs.cpu().numpy()
        return {"words": pipe.state.bloom_bits.cpu().numpy().view(np.uint32),
                "regs": {int(d): regs[b] for d, b in pipe._bank_of.items()},
                "blocks": list(pipe.store._blocks),
                "counters": pipe.validity_counts(),
                "pfcount": {int(d): int(v)
                            for d, v in pipe.count_all().items()}}

    def unacked(self) -> int:
        """Frames the program stepped but did not acknowledge: what the
        broker still holds beyond the frames not yet taken in."""
        waiting = len(self.published) - self.pipe.metrics.batches
        return self.sub.backlog() - waiting

    def verify(self, control_probes: Optional[int] = None
               ) -> Dict[str, Dict[str, float]]:
        """Each number compared, with its limit. ``control_probes``
        judges the control (the reference at that many probes) in the
        program's place instead of the program."""
        want = self.reference()
        if hasattr(self, "_sources"):
            lo, hi = self._window_frames
            self._sources["state_bytes"] = sum(
                want["touched"][i] for i in self._fed()[lo:hi].tolist())
        if control_probes is None:
            got = self.program_outputs()
            vdiff = self._block_validity_diff(got["blocks"], want["valid"])
        else:
            got = self.reference(control_probes)
            times = np.bincount(self._fed(), minlength=self.frames)
            vdiff = sum(int(times[i]) * int((got["valid"][i] != v).sum())
                        for i, v in want["valid"].items())
        regs_diff = sum(
            (got["regs"][d] != row).sum() if d in got["regs"]
            else row.size for d, row in want["regs"].items())
        regs_diff += sum(row.size for d, row in got["regs"].items()
                         if d not in want["regs"])
        days = set(want["pfcount"]) | set(got["pfcount"])
        checks = {
            "filter_words": int((got["words"] != want["words"]).sum()),
            "validity": int(vdiff),
            "registers": int(regs_diff),
            "counters": abs(got["counters"][0] - want["counters"][0])
            + abs(got["counters"][1] - want["counters"][1]),
            "pfcount_days": sum(got["pfcount"].get(d) != want["pfcount"]
                                .get(d) for d in days),
            "unacked_frames": self.unacked(),
        }
        return {k: {"value": v, "limit": 0} for k, v in checks.items()}

    def _block_validity_diff(self, blocks, valid_by_frame) -> int:
        """Events whose stored validity differs from the reference's,
        over every block the program stored; a block that is not the
        frame fed in its place counts all its events."""
        import torch

        fed = self._fed()
        sids = {}
        on_dev: Dict[int, object] = {}
        diff = 0
        acc = None
        if len(blocks) != len(fed):
            diff += abs(len(blocks) - len(fed)) * self.traffic[
                "frame_events"]
        for j, blk in enumerate(blocks[:len(fed)]):
            i = int(fed[j])
            if i not in sids:
                sids[i] = gen.decode_ids(self.pool[i])[0]
            want = valid_by_frame[i]
            sid = np.asarray(blk["student_id"])
            if len(sid) != len(want) or not np.array_equal(sid[:64],
                                                           sids[i][:64]):
                diff += max(len(sid), len(want))
                continue
            got = blk["is_valid"]
            if isinstance(got, torch.Tensor):
                if i not in on_dev:
                    on_dev[i] = torch.from_numpy(want).to(got.device)
                d = (got.to(torch.bool) != on_dev[i]).sum()
                acc = d if acc is None else acc + d
            else:
                diff += int((np.asarray(got, bool) != want).sum())
        if acc is not None:
            diff += int(acc)
        return diff

    def close(self) -> None:
        self.pipe.cleanup()

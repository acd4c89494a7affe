"""A standing backlog of per-swipe JSON records drained by
``AttendanceProcessor.process_attendance``.

The north star's API-stable path: a micro-batch of messages, one batched
BF.EXISTS, the rows persisted with their computed validity, one PFADD a
lecture, the acks; with the card store (``sketch_backend`` ``tpu``) and
the memory event store. Set-up makes a pool of distinct records from the
seed, reserves the roster filter and adds the roster (the generator's
BF.ADD preload), and warms up until every lecture-day's HLL key exists.
The pool is republished in turn one chunk of batches ahead of the
consumer; the window runs ``process_attendance(max_events=...)`` a chunk
at a time until its seconds have passed, closing with a ``synchronize``.

Judged after the window against the plain reference, which works out
again from the roster and the records fed (in order, as often as fed):
the filter's bits, each persisted row with its computed validity (the
BF.EXISTS answers), every lecture key's registers, its PFCOUNT and the
valid and invalid counts.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from portbench import reference as ref
from portbench.drivers import chunk_quartiles
from portbench.generators import json_swipes as gen


class Driver:
    layout = "flat"  # the roster filter's layout
    e2e = "processor_events_per_s"

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 llc: Optional[int] = None):
        self.cfg, self.traffic, self.seed = config, traffic, seed
        self.device = device
        self.batch = traffic["batch_size"]
        self.chunk = traffic["chunk_batches"] * self.batch
        self.published: List[int] = []
        self.cursor = 0
        self.wall = 0.0

    @property
    def _cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def setup(self, trace_path: Optional[Path] = None) -> Dict[str, object]:
        from attendance_tpu_torch.config import Config
        from attendance_tpu_torch.pipeline.processor import (
            AttendanceProcessor)
        from attendance_tpu_torch.transport.memory_broker import (
            MemoryBroker, MemoryClient)

        self.roster, self.cols, self.pool = gen.generate(
            self.cfg, self.traffic, self.seed)
        self.config = Config(
            bloom_filter_capacity=self.cfg["roster_size"],
            bloom_filter_error_rate=self.cfg["bloom_error_rate"],
            hll_precision=self.cfg["hll_precision"], sketch_backend="tpu",
            storage_backend="memory", batch_size=self.batch)
        self.broker = MemoryBroker()
        client = MemoryClient(self.broker)
        self.proc = AttendanceProcessor(self.config, client=client,
                                        device=self.device)
        self.sub = self.broker.topic(self.config.pulsar_topic).subscription(
            AttendanceProcessor.SUBSCRIPTION)
        self.producer = client.create_producer(self.config.pulsar_topic)
        self.proc.setup_bloom_filter()
        self.proc.sketch.bf_add_many(self.config.bloom_filter_key,
                                     self.roster)
        self._publish(self.chunk)
        self.keys = [self.config.hll_key_prefix + lid
                     for lid in gen.day_ids(self.cfg["lecture_days"])[1]]
        hll = self.proc.sketch.hll
        done, warm = 0, self.traffic["warmup_batches"]
        while done < warm or (
                any(hll.bank_index(k, create=False) < 0 for k in self.keys)
                and done < 4 * warm):
            self._run_chunk()
            done += self.traffic["chunk_batches"]
        if trace_path is not None:
            from portbench.trace import traced
            traced(self._run_chunk, trace_path)
        return {"pool_messages": len(self.pool),
                "pool_bytes": sum(len(m) for m in self.pool)}

    def _publish(self, k: int) -> None:
        n = len(self.pool)
        idx = [(self.cursor + i) % n for i in range(k)]
        self.cursor += k
        self.published.extend(idx)
        self.producer.send_many([self.pool[i] for i in idx])

    def _run_chunk(self) -> None:
        m = self.proc.metrics
        self.proc.process_attendance(max_events=m.events + self.chunk,
                                     idle_timeout_s=5.0)
        self.wall += m.wall_seconds
        self._publish(self.chunk)

    def window(self, seconds: float,
               trace_path: Optional[Path] = None) -> Dict[str, object]:
        import torch

        m = self.proc.metrics
        ev0, dev0, wall0 = m.events, m.device_seconds, self.wall
        failed0 = m.nacked_batches + m.dead_lettered

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
        events = m.events - ev0
        sources = {"events": events, "window_s": wall, "trace": summary,
                   "processor_wall_s": self.wall - wall0,
                   "processor_device_s": m.device_seconds - dev0}
        return {"e2e": {self.e2e: events / wall}, "sources": sources,
                "attempted": events,
                "failed": (m.nacked_batches + m.dead_lettered - failed0)
                * self.batch,
                "window_s": wall,
                "notes": {"batches": len(m.batch_sizes),
                          "chunk_s": chunk_quartiles(chunks)}}

    # -- the judgement ------------------------------------------------------
    def reference(self, probes: Optional[int] = None) -> Dict[str, object]:
        c, p = self.cfg, self.cfg["hll_precision"]
        f = ref.filter_params(c["roster_size"], c["bloom_error_rate"],
                              self.layout)
        bits = ref.build_bits(self.roster, f, probes)
        words = np.packbits(bits, bitorder="little").view("<u4")
        fed = np.asarray(self.published[:self.proc.metrics.events],
                         np.int64)
        sid = self.cols["student_id"].astype(np.uint32)
        valid = ref.contains(words, sid, f, probes)
        times = np.bincount(fed, minlength=len(self.pool))
        regs = np.zeros((c["lecture_days"], 1 << p), np.uint8)
        seen = times > 0
        ref.pfadd(regs, self.cols["day"][seen & valid],
                  sid[seen & valid], p)
        # Rows upsert by (lecture, timestamp, student): the last record
        # fed under a key is the row kept.
        iso, lids = gen.day_ids(c["lecture_days"])
        pks = [(lids[d], f"{iso[d]}T{h:02d}:{mi:02d}:00", s)
               for d, h, mi, s in zip(
                   self.cols["day"].tolist(), self.cols["hour"].tolist(),
                   self.cols["minute"].tolist(),
                   self.cols["student_id"].tolist())]
        last = {}
        for i in fed.tolist():
            last[pks[i]] = i
        days = sorted({int(d) for d in self.cols["day"][seen]})
        nv = int((times * valid).sum())
        return {"bits": bits, "valid": valid, "last": last,
                "regs": {self.config.hll_key_prefix + lids[d]: regs[d]
                         for d in days},
                "pfcount": {self.config.hll_key_prefix + lids[d]:
                            ref.pfcount(regs[d], p) for d in days},
                "counters": (nv, int(times.sum()) - nv)}

    def verify(self, control_probes: Optional[int] = None
               ) -> Dict[str, Dict[str, float]]:
        want = self.reference()
        if control_probes is None:
            got = self.program_outputs()
        else:
            got = self.reference(control_probes)
            got["rows"] = {pk: got["valid"][i]
                           for pk, i in got["last"].items()}
        rows_diff = 0
        validity = 0
        sid, exit_ = self.cols["student_id"], self.cols["exit"]
        for pk, i in want["last"].items():
            row = got["rows"].get(pk)
            if row is None:
                rows_diff += 1
                continue
            if control_probes is not None:
                validity += int(row != want["valid"][i])
                continue
            validity += int(row.is_valid != bool(want["valid"][i]))
            rows_diff += int((row.event_type, row.student_id)
                             != ("exit" if exit_[i] else "entry",
                                 int(sid[i])))
        rows_diff += len(set(got["rows"]) - set(want["last"]))
        regs_diff = sum(
            int((got["regs"][k] != r).sum()) if k in got["regs"]
            else r.size for k, r in want["regs"].items())
        keys = set(want["pfcount"]) | set(got["pfcount"])
        checks = {
            "filter_bits": int((got["bits"] != want["bits"]).sum())
            if len(got["bits"]) == len(want["bits"]) else len(want["bits"]),
            "rows": rows_diff,
            "validity": validity,
            "registers": regs_diff,
            "pfcount_keys": sum(got["pfcount"].get(k) != want["pfcount"]
                                .get(k) for k in keys),
            "counters": abs(got["counters"][0] - want["counters"][0])
            + abs(got["counters"][1] - want["counters"][1]),
            "unacked": self.sub.backlog()
            - (len(self.published) - self.proc.metrics.events),
        }
        return {k: {"value": v, "limit": 0} for k, v in checks.items()}

    def program_outputs(self) -> Dict[str, object]:
        """The processor's outputs after the window: the roster filter's
        bits (one sub-filter), the persisted rows by primary key, the
        registers and PFCOUNT of every lecture key, the counters."""
        sketch = self.proc.sketch
        bloom = sketch._blooms[self.config.bloom_filter_key]
        bits = (bloom.filters[0].cpu().numpy() if len(bloom.filters) == 1
                else np.zeros(0, np.uint8))
        rows = {(r.lecture_id, r.timestamp, r.student_id): r
                for r in self.proc.store.scan_all()}
        hll = sketch.hll
        regs = hll.regs.cpu().numpy()
        known = [k for k in self.keys
                 if hll.bank_index(k, create=False) >= 0]
        counts = sketch.pfcount_many(known)
        m = self.proc.metrics
        return {"bits": bits, "rows": rows,
                "regs": {k: regs[hll.bank_index(k, create=False)]
                         for k in known},
                "pfcount": dict(zip(known, (int(c) for c in counts))),
                "counters": (m.valid_events, m.invalid_events)}

    def close(self) -> None:
        self.proc.cleanup()

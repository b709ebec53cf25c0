"""Data pipeline: deterministic, resumable, sharded, prefetching.

Port of `repro/data/pipeline.py`, numpy only: every batch is equal
bitwise to the reference's for the same (seed, step). The train step
stacks a batch onto its device by its batch specs
(`parallel/stages.py::TrainStep.put_batch`).

Production requirements served here:
  * deterministic per-step batches keyed by (seed, step) — a restarted or
    rescheduled job consumes the exact same token stream (resume-exact);
  * host sharding: each process loads only its data-parallel slice
    (process_index/process_count plumbing, the path a multi-host job
    takes);
  * sources: synthetic LM stream (hash-based, no files) and a memmapped
    token file (the on-disk format real corpora would use);
  * background prefetch (double buffering) so host data work overlaps
    device steps.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    source: str = "synthetic"      # 'synthetic' | 'memmap'
    memmap_path: Optional[str] = None
    prefetch: int = 2


class SyntheticLM:
    """Deterministic pseudo-corpus: batch(step) is a pure function.

    Uses Philox counter RNG keyed by (seed, step) so any step's batch can
    be regenerated in O(1) — the property the resume path relies on.
    """

    def __init__(self, cfg: DataConfig, arch: ArchConfig):
        self.cfg = cfg
        self.arch = arch

    def batch_at(self, step: int, lo: int, hi: int):
        """Rows [lo, hi) of the global batch at `step`."""
        rng = np.random.Generator(
            np.random.Philox(key=self.cfg.seed, counter=[step, 0, 0, 0]))
        v = self.arch.vocab_size
        s = self.cfg.seq_len
        tokens = rng.integers(0, v, (self.cfg.global_batch, s + 1),
                              dtype=np.int32)
        out = {"tokens": tokens[lo:hi, :-1], "labels": tokens[lo:hi, 1:]}
        if self.arch.family == "vlm":
            out["vis_embed"] = rng.standard_normal(
                (hi - lo, self.arch.n_vis_tokens, self.arch.d_model),
                dtype=np.float32)
        if self.arch.encoder_layers:
            out["frames"] = 0.1 * rng.standard_normal(
                (hi - lo, s, self.arch.d_model), dtype=np.float32)
        return out


class MemmapTokens:
    """Flat .bin int32 token file; sequence i = tokens[i*(S+1):(i+1)*(S+1)].

    Step -> sequence mapping is a fixed permutation-free stride (epoch
    wraps), so resume needs only the step counter.
    """

    def __init__(self, cfg: DataConfig, arch: ArchConfig):
        assert cfg.memmap_path, "memmap source needs a path"
        self.cfg = cfg
        self.arch = arch
        self.tokens = np.memmap(cfg.memmap_path, dtype=np.int32, mode="r")
        self.seqs = len(self.tokens) // (cfg.seq_len + 1)
        if self.seqs < cfg.global_batch:
            raise ValueError("corpus smaller than one global batch")

    def batch_at(self, step: int, lo: int, hi: int):
        s = self.cfg.seq_len
        base = (step * self.cfg.global_batch) % self.seqs
        rows = [(base + i) % self.seqs for i in range(lo, hi)]
        arr = np.stack([
            self.tokens[r * (s + 1):(r + 1) * (s + 1)] for r in rows])
        return {"tokens": arr[:, :-1].astype(np.int32),
                "labels": arr[:, 1:].astype(np.int32)}


class ShardedLoader:
    """Process-sharded, prefetching iterator with exact resume."""

    def __init__(self, source, cfg: DataConfig, start_step: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.source = source
        self.cfg = cfg
        self.step = start_step
        per = cfg.global_batch // process_count
        self.lo = process_index * per
        self.hi = self.lo + per
        self._q: queue.Queue = queue.Queue(maxsize=cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step, self.lo, self.hi)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.5)
                    step += 1
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass


def make_loader(cfg: DataConfig, arch: ArchConfig, start_step: int = 0,
                process_index: int = 0, process_count: int = 1):
    src = {"synthetic": SyntheticLM, "memmap": MemmapTokens}[cfg.source](
        cfg, arch)
    return ShardedLoader(src, cfg, start_step, process_index, process_count)

"""Per-stage latency profiler.

The port's copy of ``rtmodt_tpu/profiling/latency_profiler.py``:
``tick(stage)`` / ``tock(stage)`` / ``end_frame()`` / ``summary()`` with the
same stage names (decode, preprocess, inference, nms, tracking, events,
visualization, plus ``total`` and ``frame``), the same summary keys
(``{stage}_mean_ms/_p95_ms/_p99_ms``, ``fps_mean``, ``fps_p5``), warmup-frame
exclusion and a periodic log line.  ``total`` is the sum of the timed stages
of a frame; ``frame`` is its wall time from the first tick to ``end_frame``.

``tock(stage, sync_on=...)`` first waits for the card when ``sync_on`` holds
CUDA tensors (any nesting of tuples, lists, dicts and named tuples), so the
device work of the stage has finished when its time is taken; this is the
counterpart of the reference's ``jax.block_until_ready``.  Without
``sync_on`` the stage times host work only.
"""

from __future__ import annotations

import time
from typing import Any

import numpy as np
import torch

from rtmodt_tpu_torch.utils.logging import logger

STAGES = ("decode", "preprocess", "inference", "nms", "tracking", "events",
          "visualization")


def _holds_cuda(x: Any) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_holds_cuda(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return any(_holds_cuda(v) for v in x)
    return False


class LatencyProfiler:
    def __init__(self, enabled: bool = True, warmup_frames: int = 50,
                 log_interval: int = 100) -> None:
        self.enabled = enabled
        self.warmup_frames = warmup_frames
        self.log_interval = log_interval
        self._tick_t: dict[str, float] = {}
        self._current: dict[str, float] = {}
        self._history: list[dict[str, float]] = []
        self._frame_count = 0
        self._last_end: float | None = None
        self._frame_start: float | None = None
        self._fps_samples: list[float] = []

    # ------------------------------------------------------------------
    def tick(self, stage: str) -> None:
        if not self.enabled:
            return
        t = time.perf_counter()
        if self._frame_start is None:
            self._frame_start = t
        self._tick_t[stage] = t

    def tock(self, stage: str, sync_on: Any = None) -> float:
        """End a stage; the card is synchronised first when ``sync_on``
        holds CUDA tensors."""
        if not self.enabled:
            return 0.0
        if sync_on is not None and _holds_cuda(sync_on):
            torch.cuda.synchronize()
        dt = (time.perf_counter() - self._tick_t.get(stage, time.perf_counter())) * 1e3
        self._current[stage] = self._current.get(stage, 0.0) + dt
        return dt

    def end_frame(self) -> None:
        if not self.enabled:
            return
        now = time.perf_counter()
        self._frame_count += 1
        self._current["total"] = sum(v for k, v in self._current.items()
                                     if k not in ("total", "frame"))
        if self._frame_start is not None:
            self._current["frame"] = (now - self._frame_start) * 1e3
        if self._last_end is not None:
            dt = now - self._last_end
            if dt > 0:
                self._fps_samples.append(1.0 / dt)
        self._last_end = now
        if self._frame_count > self.warmup_frames:
            self._history.append(dict(self._current))
        self._current = {}
        self._frame_start = None
        if self.log_interval and self._frame_count % self.log_interval == 0:
            self._log_periodic()

    # ------------------------------------------------------------------
    @property
    def frame_count(self) -> int:
        """Frames ended so far, warmup frames included."""
        return self._frame_count

    @property
    def current_fps(self) -> float:
        if not self._fps_samples:
            return 0.0
        return float(np.mean(self._fps_samples[-30:]))

    def summary(self) -> dict[str, float]:
        out: dict[str, float] = {}
        if not self._history:
            return out
        for stage in list(STAGES) + ["total", "frame"]:
            vals = np.array([h[stage] for h in self._history if stage in h])
            if len(vals) == 0:
                continue
            out[f"{stage}_mean_ms"] = float(np.mean(vals))
            out[f"{stage}_p95_ms"] = float(np.percentile(vals, 95))
            out[f"{stage}_p99_ms"] = float(np.percentile(vals, 99))
        fps = np.array(self._fps_samples[self.warmup_frames:] or self._fps_samples)
        if len(fps):
            out["fps_mean"] = float(np.mean(fps))
            out["fps_p5"] = float(np.percentile(fps, 5))
        return out

    def _log_periodic(self) -> None:
        s = self.summary()
        if not s:
            return
        parts = [f"{st}={s[f'{st}_mean_ms']:.1f}ms" for st in STAGES
                 if f"{st}_mean_ms" in s]
        logger.info(f"[profile] frames={self._frame_count} fps={self.current_fps:.1f} "
                    + " ".join(parts)
                    + (f" total={s.get('total_mean_ms', 0):.1f}ms" if "total_mean_ms" in s else ""))

    def print_summary(self) -> str:
        s = self.summary()
        if not s:
            return "no profiling data (still in warmup?)"
        lines = [f"{'stage':<14}{'mean':>8}{'p95':>8}{'p99':>8}  (ms)"]
        for stage in list(STAGES) + ["total", "frame"]:
            if f"{stage}_mean_ms" in s:
                lines.append(f"{stage:<14}{s[f'{stage}_mean_ms']:>8.2f}"
                             f"{s[f'{stage}_p95_ms']:>8.2f}{s[f'{stage}_p99_ms']:>8.2f}")
        if "fps_mean" in s:
            lines.append(f"fps: mean={s['fps_mean']:.1f} p5={s['fps_p5']:.1f}")
        text = "\n".join(lines)
        logger.info("\n" + text)
        return text

"""ByteTrack's T steps of a chunk as one CUDA graph.

On the card one ByteTrack step (``tracking/bytetrack.py::bytetrack_update``)
is a few hundred small kernels: the Kalman predict, the IoU matrix, two
greedy associations (``ops/assignment.py``'s kernel), births and deaths.
Launching them from Python costs the host far more than the card spends
running them, and none of them reads the device from the host, so the T
steps of a chunk are captured once as one CUDA graph and replayed for every
later chunk of the same shapes (``Pipeline.track_chunk`` decides when):

  * key: the shapes and dtypes of the detections (T leading) and of the
    state, the device and the ``ByteTrackConfig``; a graph is captured the
    first time its key is seen, after one step on a side stream (the warm-up
    ``torch.cuda.graph`` needs), and at most ``CACHE`` keys are kept;
  * inputs: the chunk's detections are copied into the graph's static input
    tensors;
  * state: the graph reads and writes its own static state tensors in
    place.  A ``TrackState`` that is not that object (a fresh or loaded
    state, another graph's, an eager step's) is copied in first.  After the
    replay the tracker's state *is* the static state, so the next chunk
    copies nothing, and a caller that keeps it sees the next replay change
    it: keep a copy (``clone_state``) to hold an earlier state;
  * outputs: the stacked ``TrackOutputs`` are cloned after the replay, one
    device copy a field, so an earlier chunk's outputs are never
    overwritten by a later replay.

The replayed kernels are the eager step's, on the same inputs, so the
outputs and the state equal the eager loop's bit for bit.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from rtmodt_tpu_torch.config.loader import ByteTrackConfig
from rtmodt_tpu_torch.tracking.bytetrack import TrackOutputs, TrackState, bytetrack_update

CACHE = 4   # graphs kept: chunk shapes a pipeline alternates between


def clone_state(state):
    """A copy of a tracker state that no replay writes into: a NamedTuple of
    tensors, a list of them (per-stream trackers) or None (the host
    tracker)."""
    if state is None:
        return None
    if isinstance(state, list):
        return [clone_state(s) for s in state]
    return type(state)(*(t.clone() for t in state))


class _ChunkGraph:
    """One captured graph of T steps over fixed shapes."""

    def __init__(self, cfg: ByteTrackConfig, state: TrackState, dets: tuple):
        self.inputs = tuple(x.clone() for x in dets)
        self.state = clone_state(state)
        side = torch.cuda.Stream(device=self.inputs[0].device)
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bytetrack_update(clone_state(self.state), *(x[0] for x in self.inputs), cfg)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: another thread's CUDA calls (a reader, a server)
        # cannot invalidate the capture
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            st, outs = self.state, []
            for i in range(self.inputs[0].shape[0]):
                st, out = bytetrack_update(st, *(x[i] for x in self.inputs), cfg)
                outs.append(out)
            self.outputs = TrackOutputs(*(torch.stack(f) for f in zip(*outs)))
            for dst, src in zip(self.state, st):
                dst.copy_(src)

    def replay(self, state: TrackState, dets: tuple) -> TrackOutputs:
        for dst, src in zip(self.inputs, dets):
            dst.copy_(src)
        if state is not self.state:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        self.graph.replay()
        return TrackOutputs(*(t.clone() for t in self.outputs))


class ChunkGraphs:
    """The graphs of one tracker, by key, least recently used first out."""

    def __init__(self, cfg: ByteTrackConfig):
        self.cfg = cfg
        self._cfg_key = dataclasses.astuple(cfg)
        self._graphs: OrderedDict = OrderedDict()

    def run(self, state: TrackState, dets: tuple) -> tuple[TrackState, TrackOutputs, bool]:
        """The T steps of ``dets`` = (boxes (T, ..., D, 4), scores, classes,
        valid) from ``state``: (the state after them, the stacked outputs,
        whether this call captured a graph)."""
        key = (tuple((tuple(t.shape), t.dtype) for t in (*dets, *state)),
               state.active.device, self._cfg_key)
        graph = self._graphs.get(key)
        captured = graph is None
        if captured:
            graph = self._graphs[key] = _ChunkGraph(self.cfg, state, dets)
            while len(self._graphs) > CACHE:
                self._graphs.popitem(last=False)
        else:
            self._graphs.move_to_end(key)
        outputs = graph.replay(state, dets)
        return graph.state, outputs, captured

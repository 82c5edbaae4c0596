#!/usr/bin/env python
"""CLI entry point for the PyTorch/CUDA port's live pipeline.

The port's counterpart of ``tools/run_pipeline.py``, with the same flags:
``-c/--config``, ``-s/--source``, ``--display/--no-display``,
``--max-frames``, ``--save-video``, ``--mjpeg-port``, ``--resume-state`` and
``--state-interval``.  It runs ``rtmodt_tpu_torch``'s
``Pipeline.run`` on the device that ``system.device`` names (``cpu``, or
``cuda``/``tpu`` for the card) and prints the final profile and the zone
counts.  Several ``-s`` set ``parallel.num_streams`` and run
``MultiStreamPipeline.run`` over the sources, which prints the multi-camera
summary: on several visible cards whose count divides the streams, one rank
per card (``parallel/mesh.py``'s ``spawn``), each running its share of the
streams, as the reference's CLI shards them over its devices; on one card
(or the CPU) in this process.  ``RTMODT_MESH_DEVICES`` names the ranks'
devices instead (``cuda:0,cuda:0``: two ranks sharing one card; ``cpu,cpu``:
two CPU ranks).  ``--display``, ``--save-video`` and ``--mjpeg-port`` tile
every annotated stream into one mosaic: over several ranks each rank draws
its streams' tiles and rank 0 tiles them, writes the video, serves the
monitor and shows the window.  ``--mjpeg-port N`` serves the annotated frames
(the mosaic with several ``-s``) as MJPEG on port N while the run lasts
(``http://host:N/``; 0 picks a free port, which the log names).
It logs to stderr at ``system.log_level`` and to
``<system.log_dir>/pipeline.log`` at DEBUG, rotated at 50 MB with five
backups (``setup_sinks``).
``--resume-state PATH`` keeps a kill-and-resume snapshot at PATH, rewritten
every ``--state-interval`` frames (default 300) and at clean exit; started
again with the same flags after a kill, the run restores it and carries on
with the same track ids, dwell timers, cooldowns and zone counts (a video
file resumes at the frame after the snapshot's).

    python tools/run_pipeline_torch.py -c cfg.yaml -s video.mp4 --max-frames 100
    python tools/run_pipeline_torch.py -c cfg.yaml -s cam0.mp4 -s cam1.mp4
    python tools/run_pipeline_torch.py -c cfg.yaml -s video.mp4 --resume-state state.npz
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rtmodt_tpu_torch.config import default_config_path, load_config  # noqa: E402
from rtmodt_tpu_torch.utils.logging import logger  # noqa: E402


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-c", "--config", dest="config_path", default=None,
                    help="YAML config path (default: the packaged "
                         "rtmodt_tpu_torch/config/default.yaml)")
    ap.add_argument("-s", "--source", action="append", default=[],
                    help="override ingestion.source (RTSP URL / file / webcam index)")
    ap.add_argument("--display", action=argparse.BooleanOptionalAction, default=False,
                    help="show the annotated window")
    ap.add_argument("--max-frames", type=int, default=None, help="stop after N frames")
    ap.add_argument("--save-video", action="store_true", default=False,
                    help="write the annotated video to visualization.save_path")
    ap.add_argument("--mjpeg-port", type=int, default=None,
                    help="serve the annotated frames as MJPEG on this port "
                         "(http://host:PORT/; implies visualization)")
    ap.add_argument("--resume-state", dest="state_path", default=None,
                    help="pipeline snapshot path: restore track ids and zone dwell/cooldown "
                         "state from it if present, and keep it updated (periodically and "
                         "at clean exit) so a killed 24/7 run resumes where it left off")
    ap.add_argument("--state-interval", type=int, default=300,
                    help="snapshot every N consumed frames (with --resume-state)")
    return ap.parse_args(argv)


def setup_sinks(level: str, log_dir: str) -> None:
    """The CLI's log sinks, the reference CLI's: stderr at ``level`` and
    ``<log_dir>/pipeline.log`` at DEBUG, rotated at 50 MB (five backups)."""
    os.makedirs(log_dir, exist_ok=True)
    logger.remove()
    logger.add(sys.stderr, level=level)
    logger.add(os.path.join(log_dir, "pipeline.log"), level="DEBUG", rotation="50 MB")


def main(argv: list[str] | None = None) -> int:
    args = parse_args(argv)
    overrides: dict = {}
    if len(args.source) == 1:
        overrides["ingestion"] = {"source": args.source[0]}
    if len(args.source) > 1:
        overrides["parallel"] = {"num_streams": len(args.source)}
    if args.save_video:
        overrides["visualization"] = {"save_video": True}
    if args.mjpeg_port is not None:
        # the monitor streams ANNOTATED frames, so it implies visualization
        overrides.setdefault("visualization", {}).update(
            {"mjpeg_port": args.mjpeg_port, "enabled": True})
    cfg = load_config(args.config_path or default_config_path(), overrides)
    setup_sinks(cfg.system.log_level, cfg.system.log_dir)

    from rtmodt_tpu_torch.device import config_device
    from rtmodt_tpu_torch.parallel.multistream import MultiStreamPipeline, stream_devices
    from rtmodt_tpu_torch.runtime.pipeline import Pipeline

    try:
        devices = (stream_devices(len(args.source), config_device(cfg.system.device))
                   if len(args.source) > 1 else [])
        if len(devices) > 1:
            summary = _run_ranks(cfg, args, devices)
            return _print_summary(summary)
        pipe = MultiStreamPipeline(cfg) if len(args.source) > 1 else Pipeline(cfg)
    except RuntimeError as e:     # asked for the card where there is none
        raise SystemExit(f"run_pipeline_torch: {e}")
    if len(args.source) > 1:
        summary = pipe.run(list(args.source), max_frames=args.max_frames, display=args.display,
                           state_path=args.state_path, state_interval=args.state_interval)
    else:
        skip = 0
        if args.state_path and os.path.exists(args.state_path):
            skip = pipe.load_runtime_state(args.state_path)
        summary = pipe.run(display=args.display, max_frames=args.max_frames,
                           state_path=args.state_path, state_interval=args.state_interval,
                           skip_frames=skip)
        if pipe.events is not None and summary is not None:
            summary = dict(summary)
            summary["zone_counts"] = pipe.events.zone_counts()
    return _print_summary(summary)


def _run_ranks(cfg, args: argparse.Namespace, devices: list[str]) -> dict:
    """The multi-camera run over one rank per device; rank 0's summary (and
    the mosaic, where one is asked for)."""
    from rtmodt_tpu_torch.parallel.mesh import create_mesh, spawn
    from rtmodt_tpu_torch.parallel.ranks import multistream_run

    logger.info(f"{len(args.source)} streams over {len(devices)} devices "
                f"({','.join(devices)}), one rank each")
    out = spawn(multistream_run, create_mesh(devices=devices), cfg, list(args.source),
                {"max_frames": args.max_frames, "display": args.display,
                 "state_path": args.state_path, "state_interval": args.state_interval})
    logger.info(f"ranks done: NMS kernel launches by rank {[r['launches'] for r in out]}")
    return out[0]["summary"]


def _print_summary(summary: dict | None) -> int:
    if summary:
        print("\n=== final profile ===")
        for k, v in sorted(summary.items()):
            # the multi-camera summary has non-scalar fields too
            # (per_stream_frames, dead_streams, zone_counts per stream)
            print(f"  {k}: {v:.2f}" if isinstance(v, float) else f"  {k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

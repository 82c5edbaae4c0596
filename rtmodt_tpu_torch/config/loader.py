"""Config dataclasses and loader for the port's detect -> track -> events path.

The port's own copy of ``rtmodt_tpu/config/loader.py`` for the sections the
port runs: ``system``, ``ingestion``, ``detection``, ``tracking`` (all four
trackers and GMC), ``events``, ``profiling``, ``visualization`` and
``parallel``.  Defaults are built in Python (``DEFAULTS`` mirrors the
reference package's ``config/default.yaml``).  ``yaml`` is imported only
when a YAML path is given.  A YAML written with the original GPU repository's
key names (``confidence_threshold``, ``model_path``, a ``{width, height}``
resolution, a ``[w, h]`` input size, ...) is translated first
(``_REFERENCE_ALIASES``, as the reference loader does); the keys of
``_REFERENCE_ONLY`` are then skipped with a log line, so the reference
package's YAML files load unmodified.  Any other unknown key raises, and so
does a value the port cannot honour (``validate`` names the ROADMAP item
that will bring it).
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass, field
from typing import Any

from rtmodt_tpu_torch.device import config_device
from rtmodt_tpu_torch.utils.logging import logger


@dataclass
class SystemConfig:
    device: str = "tpu"                 # tpu | cuda -> the card; cpu -> the CPU
    log_level: str = "INFO"
    log_dir: str = "logs"


@dataclass
class IngestionConfig:
    source: str | int = 0               # RTSP URL, video path or webcam index
    backend: str = "opencv"             # opencv | gstreamer
    reconnect_delay_sec: float = 2.0
    max_reconnects: int = 10
    target_fps: int = 0                 # 0 = native
    resolution: list[int] | None = None  # [w, h] override


@dataclass
class DetectionConfig:
    model: str = "yolov8s"
    weights: str | None = None          # flat .npz of the reference's Flax params,
                                        # or an ultralytics .pt / .pth
    fallback_weights: str | None = None
    num_classes: int = 80
    input_size: int = 640
    conf_threshold: float = 0.35
    iou_threshold: float = 0.45
    max_detections: int = 100
    nms_candidates: int = 300           # top-k pool entering NMS (static shape)
    classes: list[int] | None = None    # keep-list, e.g. [0,1,2,3,5,7]
    agnostic_nms: bool = False
    nms_impl: str = "fixpoint"          # fixpoint | pallas | auto: all exact
                                        # greedy, all run the CUDA kernel here
    fuse_bn: bool = True                # fold BN into convs for inference
    half: bool = True                   # bf16 model compute
    quant: str = "none"                 # none | int8 (post-training quantization,
                                        # quant/ptq.py)
    calib_frames: int = 4               # synthetic calibration batches at init;
                                        # Detector.calibrate(frames) requantizes
                                        # on real frames
    quant_scales: str | None = None     # frozen activation scales from QAT
                                        # (qat_act_scales.npz); requires int8


@dataclass
class ByteTrackConfig:
    track_thresh: float = 0.5
    track_buffer: int = 30
    match_thresh: float = 0.8
    low_thresh: float = 0.1
    new_track_thresh: float = 0.5       # birth gate
    max_tracks: int = 256               # static track-slot count
    motion_model: str = "kalman"        # kalman | none
    assignment: str = "greedy"          # greedy (device) | lapjv (host C++ JV solver)
    fuse_score: bool = False            # stage-1 similarity = IoU * det conf
    gate_distance: bool = False         # Mahalanobis chi2inv95(4dof) gate
    match_metric: str = "iou_distance"  # iou | iou_distance (see reference loader)


@dataclass
class DeepSortConfig:
    """Appearance tracker (tracking/deepsort.py)."""

    max_dist: float = 0.2               # appearance cosine-distance gate
    min_confidence: float = 0.3
    max_iou_distance: float = 0.7
    max_age: int = 70
    n_init: int = 3
    nn_budget: int = 100                # realized as an EMA gallery
    embedder: str = ""                  # "" -> checkpoints/embedder.npz;
                                        # random | none -> seeded init
    embed_dim: int = 128
    crop_hw: list[int] = field(default_factory=lambda: [64, 32])  # ROI h, w
    max_tracks: int = 256               # static track-slot count
    ema_alpha: float = 0.9              # appearance EMA momentum
    gate_distance: bool = True          # Mahalanobis chi2(4dof) gate in stage 1


@dataclass
class BotSortConfig:
    """BoT-SORT (tracking/botsort.py): ByteTrack's two stages with a fused
    ``min(IoU distance, gated cosine distance)`` stage-1 cost."""

    track_thresh: float = 0.5           # high/low confidence split
    low_thresh: float = 0.1             # BYTE stage floor
    match_thresh: float = 0.8           # stage-1 accept: fused dist <= thresh
    low_match_thresh: float = 0.5       # stage-2 accept: 1 - IoU <= thresh
    new_track_thresh: float = 0.6       # birth gate
    track_buffer: int = 30              # frames a lost track survives
    proximity_thresh: float = 0.5       # appearance only when 1-IoU <= this
    appearance_thresh: float = 0.25     # cosine-distance/2 acceptance cut
    fuse_score: bool = True             # stage-1 IoU similarity *= det conf
    ema_alpha: float = 0.9              # appearance gallery EMA momentum
    embedder: str = ""                  # weights chain as deepsort's
    embed_dim: int = 128
    crop_hw: list[int] = field(default_factory=lambda: [64, 32])
    max_tracks: int = 256


@dataclass
class OCSortConfig:
    """Observation-centric SORT (tracking/ocsort.py)."""

    det_thresh: float = 0.6             # high-confidence association gate
    low_thresh: float = 0.1             # BYTE stage floor (use_byte)
    iou_threshold: float = 0.3          # raw-IoU acceptance for every stage
    max_age: int = 30                   # frames a lost track survives
    min_hits: int = 3                   # consecutive matches before emit
    delta_t: int = 3                    # OCM momentum horizon (observations)
    vdc_weight: float = 0.2             # velocity-direction consistency weight
    use_byte: bool = False              # BYTE-style low-score second stage
    max_tracks: int = 256


@dataclass
class GMCConfig:
    """Camera motion compensation (ops/gmc.py): with ``method: phase`` the
    scene translation between consecutive frames is estimated by FFT phase
    correlation of downsampled luma grids and applied to the tracker state
    before association."""

    method: str = "none"                # none | phase
    grid: int = 128                     # luma correlation raster (G x G)
    min_ratio: float = 1.5              # peak/second-peak confidence gate
    max_shift_frac: float = 0.25        # reject |shift| > grid * frac


@dataclass
class TrackingConfig:
    algorithm: str = "bytetrack"        # bytetrack | ocsort | deepsort | botsort
    trail_length: int = 30
    gmc: GMCConfig = field(default_factory=GMCConfig)
    bytetrack: ByteTrackConfig = field(default_factory=ByteTrackConfig)
    deepsort: DeepSortConfig = field(default_factory=DeepSortConfig)
    botsort: BotSortConfig = field(default_factory=BotSortConfig)
    ocsort: OCSortConfig = field(default_factory=OCSortConfig)


@dataclass
class ZoneConfig:
    name: str = "zone"
    polygon: list[list[float]] = field(default_factory=list)
    trigger: str = "intrusion"          # intrusion | crossing
    direction: str | None = None        # for crossing zones
    dwell_time_sec: float = 2.0
    cooldown_sec: float = 10.0
    classes: list[int] | None = None    # optional class keep-list


@dataclass
class AlertConfig:
    backend: str = "json_file"          # json_file | webhook | mqtt
    log_path: str = "logs/events.jsonl"
    webhook_url: str = ""
    mqtt_host: str = ""                 # broker for backend=mqtt (events/mqtt.py)
    mqtt_port: int = 1883
    mqtt_topic: str = "rtmodt/events"


@dataclass
class EventsConfig:
    enabled: bool = True
    zones: list[ZoneConfig] = field(default_factory=list)
    alert: AlertConfig = field(default_factory=AlertConfig)
    clock: str = "stream"               # stream | wall
    max_vertices: int = 16              # polygon padding of the device masks
    device_masks: bool = False          # zone containment on the device over the
                                        # chunk's slot boxes (run_chunked); the host
                                        # engine keeps only dwell/cooldown bookkeeping


@dataclass
class ProfilingConfig:
    enabled: bool = True
    warmup_frames: int = 50
    log_interval: int = 100
    per_stage: bool = True              # False = the fused packed per-frame step
    trace_dir: str | None = None        # not ported: must stay null


@dataclass
class VisualizationConfig:
    enabled: bool = True
    show_boxes: bool = True
    show_labels: bool = True
    show_trails: bool = True
    show_zones: bool = True
    show_hud: bool = True
    trail_length: int = 30
    save_video: bool = False
    save_path: str = "outputs/annotated.mp4"
    codec: str = "mp4v"                 # cv2 fourcc for save_video
    window_name: str = "RTMODT-TPU"     # --display window title
    mjpeg_port: int | None = None       # serve annotated frames as MJPEG (serving/monitor.py)


@dataclass
class ParallelConfig:
    num_streams: int = 1                # > 1: MultiStreamPipeline (one card)
    pipeline_depth: int = 2             # chunks in flight between submit and consume
    chunk_size: int = 1                 # frames per chunk (run_chunked uses >= 2; the
                                        # multi-stream run uses max(2, chunk_size))
    transport: str = "packed"           # packed | i420: planar I420 to the device;
                                        # x6 / x24: the loops ship planes too; a
                                        # chunk pre-packed in that layout
                                        # (ops/yuv.py::planes_to_x6 / planes_to_x24)
                                        # is unpacked to planes on the device;
                                        # bgr: raw frames (run_chunked's escape)


@dataclass
class PipelineConfig:
    system: SystemConfig = field(default_factory=SystemConfig)
    ingestion: IngestionConfig = field(default_factory=IngestionConfig)
    detection: DetectionConfig = field(default_factory=DetectionConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    events: EventsConfig = field(default_factory=EventsConfig)
    profiling: ProfilingConfig = field(default_factory=ProfilingConfig)
    visualization: VisualizationConfig = field(default_factory=VisualizationConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


# The reference package's config/default.yaml, for the sections ported here.
DEFAULTS: dict[str, Any] = {
    "system": {"device": "tpu", "log_level": "INFO", "log_dir": "logs"},
    "ingestion": {"source": 0, "backend": "opencv", "reconnect_delay_sec": 2.0,
                  "max_reconnects": 10, "target_fps": 0, "resolution": None},
    "detection": {
        "model": "yolov8s", "weights": None, "fallback_weights": None,
        "num_classes": 80, "input_size": 640,
        "conf_threshold": 0.35, "iou_threshold": 0.45, "max_detections": 100,
        "nms_candidates": 300,
        "classes": [0, 1, 2, 3, 5, 7], "agnostic_nms": False, "half": True,
    },
    "tracking": {
        "algorithm": "bytetrack", "trail_length": 30,
        "gmc": {"method": "none", "grid": 128, "min_ratio": 1.5, "max_shift_frac": 0.25},
        "bytetrack": {
            "track_thresh": 0.5, "track_buffer": 30, "match_thresh": 0.8,
            "low_thresh": 0.1, "new_track_thresh": 0.5, "max_tracks": 256,
            "motion_model": "kalman", "assignment": "greedy",
            "match_metric": "iou_distance",
        },
        "deepsort": {"max_dist": 0.2, "min_confidence": 0.3, "max_iou_distance": 0.7,
                     "max_age": 70, "n_init": 3, "nn_budget": 100, "embedder": "",
                     "embed_dim": 128, "crop_hw": [64, 32], "max_tracks": 256},
        "botsort": {"track_thresh": 0.5, "low_thresh": 0.1, "match_thresh": 0.8,
                    "low_match_thresh": 0.5, "new_track_thresh": 0.6, "track_buffer": 30,
                    "proximity_thresh": 0.5, "appearance_thresh": 0.25, "fuse_score": True,
                    "ema_alpha": 0.9, "embedder": "", "embed_dim": 128,
                    "crop_hw": [64, 32], "max_tracks": 256},
        "ocsort": {"det_thresh": 0.6, "low_thresh": 0.1, "iou_threshold": 0.3,
                   "max_age": 30, "min_hits": 3, "delta_t": 3, "vdc_weight": 0.2,
                   "use_byte": False, "max_tracks": 256},
    },
    "events": {
        "enabled": True,
        "zones": [
            {"name": "restricted_area_1",
             "polygon": [[100, 200], [400, 200], [400, 600], [100, 600]],
             "trigger": "intrusion", "dwell_time_sec": 2.0, "cooldown_sec": 10.0},
            {"name": "exit_gate",
             "polygon": [[800, 400], [1200, 400], [1200, 700], [800, 700]],
             "trigger": "crossing", "direction": "left_to_right",
             "cooldown_sec": 5.0},
        ],
        "alert": {"backend": "json_file", "webhook_url": "",
                  "log_path": "logs/events.jsonl"},
        "clock": "stream", "max_vertices": 16,
    },
    "profiling": {"enabled": True, "warmup_frames": 50, "log_interval": 100,
                  "per_stage": True},
    "visualization": {"enabled": True, "show_boxes": True, "show_labels": True,
                      "show_trails": True, "show_zones": True, "show_hud": True,
                      "trail_length": 30, "save_video": False,
                      "save_path": "outputs/annotated.mp4", "mjpeg_port": None},
}

_SECTIONS = {"system": SystemConfig, "ingestion": IngestionConfig,
             "detection": DetectionConfig, "tracking": TrackingConfig,
             "events": EventsConfig, "profiling": ProfilingConfig,
             "visualization": VisualizationConfig, "parallel": ParallelConfig}
_SUBSECTIONS = {"bytetrack": ByteTrackConfig, "deepsort": DeepSortConfig,
                "botsort": BotSortConfig, "ocsort": OCSortConfig, "gmc": GMCConfig,
                "alert": AlertConfig}
# Keys of the reference's YAML that mean nothing to the port, with the values
# it accepts (None: any).  load_config drops them with one log line; any other
# value raises, since the port would not do what it asks.  topk_impl approx is
# an exact top-k here, as it is in the reference on a CPU.
_REFERENCE_ONLY: dict[tuple[str, ...], dict[str, tuple | None]] = {
    ("system",): {"precision": None, "output_dir": None},
    ("ingestion",): {"buffer_size": None},
    ("profiling",): {"trace_frames": None},
    ("detection",): {"batch_size": None, "topk_impl": ("exact", "approx")},
    ("tracking", "bytetrack"): {"mot20": None},
    ("parallel",): {"mesh_axes": None, "donate_state": None},
}


# The original GPU repository's key names (its config/default.yaml), as the
# reference loader translates them: (section, its key) -> the key here, or
# None for a key with no counterpart (dropped with a log line).
_REFERENCE_ALIASES: dict[tuple[str, str], str | None] = {
    ("detection", "confidence_threshold"): "conf_threshold",
    ("detection", "nms_iou_threshold"): "iou_threshold",
    ("detection", "model_path"): "weights",
    ("detection", "fallback_model"): "fallback_weights",
    ("ingestion", "max_reconnect_attempts"): "max_reconnects",
    ("ingestion", "drop_stale_frames"): None,   # the reader keeps the newest frame
    ("profiling", "gpu_sync"): None,            # per-stage timing always syncs
    ("profiling", "log_interval_frames"): "log_interval",
    ("system", "num_workers"): None,            # ingest threading is automatic
    ("visualization", "show_fps"): "show_hud",
    ("visualization", "show_ids"): "show_labels",
}


def _apply_reference_aliases(raw: dict) -> dict:
    """Translate the original repository's key names in place: a key with a
    counterpart fills it unless the YAML sets it too, a ``{width, height}``
    resolution becomes ``[w, h]`` and a ``[w, h]`` input size the square
    letterbox side ``max(w, h)``."""
    for (section, ref_key), ours in _REFERENCE_ALIASES.items():
        sec = raw.get(section)
        if not isinstance(sec, dict) or ref_key not in sec:
            continue
        value = sec.pop(ref_key)
        if ours is None:
            logger.info(f"config: reference key {section}.{ref_key} has no "
                        "counterpart here; ignored")
        else:
            sec.setdefault(ours, value)
            logger.info(f"config: reference key {section}.{ref_key} -> {section}.{ours}")
    # sections may be present but empty ('ingestion:' alone parses as None)
    res = (raw.get("ingestion") or {}).get("resolution")
    if isinstance(res, dict):
        raw["ingestion"]["resolution"] = [res.get("width"), res.get("height")]
    size = (raw.get("detection") or {}).get("input_size")
    if isinstance(size, (list, tuple)):
        raw["detection"]["input_size"] = int(max(size))
        logger.info(f"config: reference detection.input_size {list(size)} -> "
                    f"square {raw['detection']['input_size']} (letterbox side)")
    return raw


def load_yaml(path: str) -> dict[str, Any]:
    import yaml

    with open(path, "r") as f:
        return yaml.safe_load(f) or {}


def _build(cls: type, data: Any, path: str) -> Any:
    """Construct a dataclass from a dict, erroring on unknown keys."""
    if data is None:
        return cls()
    if not isinstance(data, dict):
        raise TypeError(f"config section '{path}' must be a mapping, got "
                        f"{type(data).__name__}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise KeyError(f"unknown config key(s) {sorted(unknown)} in section "
                       f"'{path}'; valid keys: {sorted(fields)}")
    kwargs: dict[str, Any] = {}
    for name, value in data.items():
        if name == "zones":
            kwargs[name] = [_build(ZoneConfig, z, f"{path}.zones[{i}]")
                            for i, z in enumerate(value or [])]
        elif name in _SUBSECTIONS:
            kwargs[name] = _build(_SUBSECTIONS[name], value, f"{path}.{name}")
        else:
            kwargs[name] = value
    return cls(**kwargs)


def _drop_reference_only(raw: dict[str, Any]) -> None:
    dropped = []
    for path, keys in _REFERENCE_ONLY.items():
        section: Any = raw
        for name in path:
            section = section.get(name) if isinstance(section, dict) else None
        if not isinstance(section, dict):
            continue
        for key, accepted in keys.items():
            if key not in section:
                continue
            value = section.pop(key)
            name = ".".join((*path, key))
            if accepted is not None and value not in accepted:
                raise ValueError(f"{name}={value!r} is not ported (accepted: "
                                 f"{', '.join(map(repr, accepted))})")
            dropped.append(name)
    if dropped:
        logger.info(f"config: keys {dropped} do nothing in the port; ignored")


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config(path: str | None = None,
                overrides: dict[str, Any] | None = None) -> PipelineConfig:
    """Load and validate a config: the YAML at ``path`` (or ``DEFAULTS``),
    its reference key names translated, with the nested ``overrides`` dict
    merged on top."""
    raw = _apply_reference_aliases(copy.deepcopy(load_yaml(path) if path else DEFAULTS))
    raw = copy.deepcopy(_deep_merge(raw, overrides or {}))
    skipped = sorted(set(raw) - set(_SECTIONS))
    if skipped:
        logger.info(f"config: sections {skipped} are not ported; ignored")
    _drop_reference_only(raw)
    cfg = PipelineConfig(**{name: _build(cls, raw.get(name), name)
                            for name, cls in _SECTIONS.items()})
    validate(cfg)
    return cfg


def validate(cfg: PipelineConfig) -> None:
    config_device(cfg.system.device)
    i = cfg.ingestion
    if i.backend not in ("opencv", "gstreamer"):
        raise ValueError(f"ingestion.backend must be opencv|gstreamer, got {i.backend!r}")
    if i.resolution is not None and len(i.resolution) != 2:
        raise ValueError(f"ingestion.resolution must be [width, height], got {i.resolution}")
    if cfg.profiling.trace_dir:
        raise ValueError("profiling.trace_dir is not ported (ROADMAP item 12); "
                         "leave it null")
    vz = cfg.visualization
    if vz.mjpeg_port is not None and not (
            isinstance(vz.mjpeg_port, int) and 0 <= vz.mjpeg_port <= 65535):
        raise ValueError("visualization.mjpeg_port must be an int in "
                         f"[0, 65535] or null, got {vz.mjpeg_port!r}")
    d = cfg.detection
    if not (0.0 <= d.conf_threshold <= 1.0):
        raise ValueError(f"detection.conf_threshold must be in [0,1], got {d.conf_threshold}")
    if not (0.0 <= d.iou_threshold <= 1.0):
        raise ValueError(f"detection.iou_threshold must be in [0,1], got {d.iou_threshold}")
    if d.input_size % 32 != 0:
        raise ValueError(f"detection.input_size must be a multiple of 32, got {d.input_size}")
    if d.max_detections > d.nms_candidates:
        raise ValueError("detection.max_detections cannot exceed detection.nms_candidates")
    if d.classes is not None:
        bad = [c for c in d.classes
               if not isinstance(c, int) or not 0 <= c < d.num_classes]
        if bad:
            raise ValueError(f"detection.classes entries must be ints in [0, "
                             f"{d.num_classes}), got {bad}")
    if d.quant not in ("none", "int8"):
        raise ValueError(f"detection.quant must be none|int8, got {d.quant}")
    if d.quant == "int8" and not d.fuse_bn:
        raise ValueError("detection.quant=int8 requires detection.fuse_bn=true "
                         "(quantization folds conv+BN+SiLU)")
    if d.quant_scales and d.quant != "int8":
        raise ValueError("detection.quant_scales (QAT frozen scales) requires "
                         "detection.quant=int8")
    if d.nms_impl not in ("fixpoint", "pallas", "auto"):
        raise ValueError(f"detection.nms_impl must be fixpoint|pallas|auto, got {d.nms_impl!r}")
    t = cfg.tracking
    if t.algorithm not in ("bytetrack", "deepsort", "botsort", "ocsort"):
        raise ValueError(f"tracking.algorithm must be bytetrack|deepsort|botsort|ocsort, "
                         f"got {t.algorithm!r}")
    bt = t.bytetrack
    if bt.motion_model not in ("kalman", "none"):
        raise ValueError(f"tracking.bytetrack.motion_model must be kalman|none, got {bt.motion_model}")
    if bt.assignment not in ("greedy", "lapjv"):
        raise ValueError(f"tracking.bytetrack.assignment must be greedy|lapjv, got {bt.assignment!r}")
    if bt.match_metric not in ("iou", "iou_distance"):
        raise ValueError(f"tracking.bytetrack.match_metric must be iou|iou_distance, got {bt.match_metric!r}")
    g = t.gmc
    if g.method not in ("none", "phase"):
        raise ValueError(f"tracking.gmc.method must be none|phase, got {g.method!r}")
    if g.grid < 32:
        raise ValueError(f"tracking.gmc.grid must be >= 32, got {g.grid}")
    if g.min_ratio < 1.0:
        raise ValueError(f"tracking.gmc.min_ratio must be >= 1.0, got {g.min_ratio}")
    if g.method == "phase" and bt.assignment == "lapjv" and t.algorithm == "bytetrack":
        raise ValueError("tracking.gmc runs on the device tracker state and is not supported "
                         "with the host lapjv backend (assignment: lapjv)")
    tr = cfg.parallel.transport
    if tr not in ("packed", "x6", "x24", "i420", "bgr"):
        raise ValueError(f"parallel.transport must be packed|x6|x24|i420|bgr, got {tr!r}")
    if tr in ("x6", "x24") and d.quant != "none":
        raise ValueError(f"parallel.transport={tr} requires detection.quant=none (the "
                         "reference's int8 path wraps the modules its space-to-depth "
                         "front bypasses); use transport=packed for auto")
    if tr in ("x6", "x24") and t.algorithm in ("deepsort", "botsort"):
        raise ValueError(f"parallel.transport={tr} is incompatible with tracking.algorithm="
                         f"{t.algorithm!r}: appearance trackers need the Y/U/V planes back "
                         "for ROI embedding crops, which a space-to-depth layout does not "
                         "carry; use transport=packed (auto-selects planes for appearance "
                         "trackers) or i420")
    if cfg.parallel.num_streams < 1:
        raise ValueError(f"parallel.num_streams must be >= 1, got {cfg.parallel.num_streams}")
    if cfg.parallel.num_streams > 1 and bt.assignment == "lapjv" and t.algorithm == "bytetrack":
        raise ValueError("tracking.bytetrack.assignment=lapjv tracks one stream on the host; "
                         "several streams (parallel.num_streams > 1) run the device tracker "
                         "(assignment: greedy)")
    oc = t.ocsort
    if oc.min_hits < 1:
        raise ValueError(f"tracking.ocsort.min_hits must be >= 1, got {oc.min_hits}")
    if oc.delta_t < 1:
        raise ValueError(f"tracking.ocsort.delta_t must be >= 1, got {oc.delta_t}")
    if not (0.0 <= oc.iou_threshold < 1.0):
        raise ValueError(f"tracking.ocsort.iou_threshold must be in [0, 1), got {oc.iou_threshold}")
    bs = t.botsort
    if not (0.0 <= bs.proximity_thresh <= 1.0):
        raise ValueError(f"tracking.botsort.proximity_thresh must be in [0, 1], "
                         f"got {bs.proximity_thresh}")
    if not (0.0 < bs.appearance_thresh <= 1.0):
        raise ValueError(f"tracking.botsort.appearance_thresh must be in (0, 1], "
                         f"got {bs.appearance_thresh}")
    if len(bs.crop_hw) != 2 or any(v <= 0 for v in bs.crop_hw):
        raise ValueError(f"tracking.botsort.crop_hw must be [h, w] > 0, got {bs.crop_hw}")
    ds = t.deepsort
    if ds.n_init < 1:
        raise ValueError(f"tracking.deepsort.n_init must be >= 1, got {ds.n_init}")
    if not (0.0 < ds.max_dist <= 2.0):
        raise ValueError(f"tracking.deepsort.max_dist must be in (0, 2], got {ds.max_dist}")
    if len(ds.crop_hw) != 2 or any(v <= 0 for v in ds.crop_hw):
        raise ValueError(f"tracking.deepsort.crop_hw must be [h, w] > 0, got {ds.crop_hw}")
    e = cfg.events
    if e.alert.backend not in ("json_file", "webhook", "mqtt"):
        raise ValueError("events.alert.backend must be json_file|webhook|mqtt, "
                         f"got {e.alert.backend!r}")
    if e.alert.backend == "mqtt" and not e.alert.mqtt_host:
        raise ValueError("events.alert.backend=mqtt requires events.alert.mqtt_host")
    if e.alert.backend == "webhook" and not e.alert.webhook_url:
        raise ValueError("events.alert.backend=webhook requires events.alert.webhook_url")
    for z in e.zones:
        if len(z.polygon) < 3:
            raise ValueError(f"events zone '{z.name}' polygon needs >= 3 vertices")
        if len(z.polygon) > e.max_vertices:
            raise ValueError(f"events zone '{z.name}' polygon exceeds events.max_vertices "
                             f"({e.max_vertices})")

from rtmodt_tpu_torch.config.loader import (  # noqa: F401
    AlertConfig,
    ByteTrackConfig,
    DetectionConfig,
    EventsConfig,
    ParallelConfig,
    PipelineConfig,
    TrackingConfig,
    ZoneConfig,
    load_config,
)

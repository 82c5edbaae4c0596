"""Configs of the original GPU repository, and the settings this slice lifts,
through both packages' loaders.

A YAML written with the original repository's key names
(``confidence_threshold``, ``model_path``, a ``{width, height}`` resolution,
``show_fps``, a ``[w, h]`` input size, ...) loads through the JAX loader's
alias layer; the port's loader must translate it the same way: every field
the two config dataclasses share is equal.  ``detection.quant`` /
``quant_scales`` / ``calib_frames`` and the mqtt alert fields load as the
reference loads them, with its refusals.
"""

from __future__ import annotations

import dataclasses

import pytest
import yaml

from rtmodt_tpu.config.loader import load_config as jax_load_config
from rtmodt_tpu_torch.config import load_config

# tests/test_config_logging.py::test_reference_key_aliases
REFERENCE_STYLE = {
    "detection": {"confidence_threshold": 0.4,
                  "nms_iou_threshold": 0.6,
                  "model_path": "models/yolov8s.engine",
                  "fallback_model": "models/yolov8s.pt"},
    "ingestion": {"max_reconnect_attempts": 7,
                  "drop_stale_frames": True,
                  "resolution": {"width": 1280, "height": 720}},
    "profiling": {"gpu_sync": True, "log_interval_frames": 50},
    "system": {"num_workers": 4},
    "visualization": {"show_fps": False, "show_ids": False,
                      "codec": "XVID", "window_name": "ref"},
}


def shared_fields_equal(got, want, path: str = "") -> int:
    """Assert every field of ``got`` that ``want``'s dataclass also has is
    equal (recursing into sections); returns how many leaves were compared."""
    names = {f.name for f in dataclasses.fields(want)}
    n = 0
    for f in dataclasses.fields(got):
        if f.name not in names:
            continue
        g, w = getattr(got, f.name), getattr(want, f.name)
        where = f"{path}.{f.name}".lstrip(".")
        if dataclasses.is_dataclass(g):
            n += shared_fields_equal(g, w, where)
        elif isinstance(g, list) and g and dataclasses.is_dataclass(g[0]):
            assert len(g) == len(w), where
            for i, (a, b) in enumerate(zip(g, w)):
                n += shared_fields_equal(a, b, f"{where}[{i}]")
        else:
            assert g == w, (where, g, w)
            n += 1
    return n


def both(tmp_path, raw: dict, overrides: dict | None = None):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    return (load_config(str(path), overrides=overrides),
            jax_load_config(str(path), overrides=overrides))


@pytest.mark.parametrize("case", ["key_aliases", "input_size_wh", "empty_sections"])
def test_reference_style_configs_load_as_in_the_reference(tmp_path, case):
    raw = {
        "key_aliases": REFERENCE_STYLE,
        "input_size_wh": {"detection": {"input_size": [640, 384], "model_path": "w.pt"}},
        "empty_sections": {"ingestion": None, "detection": None},
    }[case]
    port, ref = both(tmp_path, raw)
    assert shared_fields_equal(port, ref) > 100
    if case == "key_aliases":
        assert port.detection.conf_threshold == 0.4
        assert port.detection.weights == "models/yolov8s.engine"
        assert port.ingestion.resolution == [1280, 720]
        assert port.visualization.show_hud is False and port.profiling.log_interval == 50
    elif case == "input_size_wh":
        assert port.detection.input_size == 640 and port.detection.weights == "w.pt"


@pytest.mark.parametrize("overrides", [
    {"detection": {"quant": "int8"}},
    {"detection": {"quant": "int8", "calib_frames": 2, "half": False,
                   "quant_scales": "checkpoints/rich640d/qat_act_scales.npz"}},
    {"events": {"alert": {"backend": "mqtt", "mqtt_host": "localhost", "mqtt_port": 1884,
                          "mqtt_topic": "cams/events"}}},
    {"parallel": {"transport": "i420"}, "detection": {"quant": "int8"}},
])
def test_lifted_settings_load_as_in_the_reference(tmp_path, overrides):
    port, ref = both(tmp_path, {}, overrides)
    assert shared_fields_equal(port, ref) > 100
    assert port.detection.quant == ref.detection.quant
    assert port.events.alert.mqtt_topic == ref.events.alert.mqtt_topic


@pytest.mark.parametrize("overrides", [
    {"detection": {"quant": "int4"}},
    {"detection": {"quant": "int8", "fuse_bn": False}},
    {"detection": {"quant_scales": "s.npz"}},
    {"parallel": {"transport": "x6"}, "detection": {"quant": "int8"}},
    {"parallel": {"transport": "x24"}, "detection": {"quant": "int8"}},
    {"events": {"alert": {"backend": "mqtt"}}},
    {"events": {"alert": {"backend": "kafka"}}},
])
def test_both_loaders_refuse_the_same_settings(tmp_path, overrides):
    with pytest.raises(ValueError):
        load_config(overrides=overrides)
    path = tmp_path / "empty.yaml"
    path.write_text("{}")
    with pytest.raises(ValueError):
        jax_load_config(str(path), overrides=overrides)

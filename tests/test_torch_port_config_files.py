"""The port's packaged config files (``rtmodt_tpu_torch/config/default.yaml``
and ``logging.yaml``) against the JAX package's.

  * Each file parses to the reference file's dict.
  * ``load_config(default_config_path())`` equals ``load_config()`` (the
    built-in ``DEFAULTS``) section by section, and the JAX loader reads the
    port's ``default.yaml`` as its own.
  * ``default_config_path`` and ``load_yaml`` are importable from
    ``rtmodt_tpu_torch.config`` and behave as the reference's.
"""

from __future__ import annotations

import dataclasses
import os

import pytest
import yaml

from rtmodt_tpu.config import default_config_path as jax_default_config_path
from rtmodt_tpu.config import load_config as jax_load_config
from rtmodt_tpu.config import load_yaml as jax_load_yaml
from rtmodt_tpu_torch.config import PipelineConfig, default_config_path, load_config, load_yaml
from tests.test_torch_port_threads import torch_threads  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = [f.name for f in dataclasses.fields(PipelineConfig)]


@pytest.mark.parametrize("name", ["default.yaml", "logging.yaml"])
def test_packaged_file_parses_to_the_reference_dict(name):
    def parsed(pkg):
        with open(os.path.join(ROOT, pkg, "config", name)) as f:
            return yaml.safe_load(f)

    port = parsed("rtmodt_tpu_torch")
    assert port == parsed("rtmodt_tpu")
    assert port


def test_default_config_path_is_the_packaged_file():
    path = default_config_path()
    assert os.path.isfile(path)
    assert path == os.path.join(ROOT, "rtmodt_tpu_torch", "config", "default.yaml")
    assert os.path.basename(path) == os.path.basename(jax_default_config_path())
    assert load_yaml(path) == jax_load_yaml(jax_default_config_path())


@pytest.mark.parametrize("section", SECTIONS)
def test_the_file_equals_the_built_in_defaults(section):
    from_file = getattr(load_config(default_config_path()), section)
    built_in = getattr(load_config(), section)
    assert dataclasses.asdict(from_file) == dataclasses.asdict(built_in)


def test_the_file_and_the_defaults_equal_as_a_whole():
    assert load_config(default_config_path()) == load_config()


def test_the_reference_loader_reads_the_port_file_as_its_own():
    assert jax_load_config(default_config_path()) == jax_load_config(jax_default_config_path())


def test_overrides_merge_over_the_packaged_file():
    over = {"detection": {"input_size": 256}, "parallel": {"chunk_size": 4}}
    cfg = load_config(default_config_path(), over)
    assert cfg == load_config(overrides=over)
    assert (cfg.detection.input_size, cfg.parallel.chunk_size) == (256, 4)
